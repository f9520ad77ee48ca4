from .ops import (flash_attention, flash_attention_kernel, paged_decode,
                  paged_decode_kernel)
from .ref import flash_attention_ref, flash_decode_ref, paged_decode_ref

__all__ = ["flash_attention", "flash_attention_kernel", "flash_attention_ref",
           "flash_decode_ref", "paged_decode", "paged_decode_kernel",
           "paged_decode_ref"]
