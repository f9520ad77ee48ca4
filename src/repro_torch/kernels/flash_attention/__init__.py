from .ops import paged_decode, paged_decode_kernel
from .ref import flash_decode_ref, paged_decode_ref

__all__ = ["flash_decode_ref", "paged_decode", "paged_decode_kernel",
           "paged_decode_ref"]
