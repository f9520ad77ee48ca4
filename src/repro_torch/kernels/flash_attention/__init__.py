from .ops import (flash_attention, flash_attention_kernel, flash_decode,
                  flash_decode_kernel, flash_decode_q8_kernel, paged_decode,
                  paged_decode_kernel, paged_decode_q8_kernel)
from .ref import (flash_attention_ref, flash_decode_q8_ref, flash_decode_ref,
                  paged_decode_q8_ref, paged_decode_ref)

__all__ = ["flash_attention", "flash_attention_kernel", "flash_attention_ref",
           "flash_decode", "flash_decode_kernel", "flash_decode_q8_kernel",
           "flash_decode_q8_ref", "flash_decode_ref", "paged_decode",
           "paged_decode_kernel", "paged_decode_q8_kernel", "paged_decode_q8_ref",
           "paged_decode_ref"]
