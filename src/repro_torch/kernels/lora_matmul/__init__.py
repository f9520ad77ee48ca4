from .ops import MAX_RANK, lora_matmul, lora_matmul_kernel
from .ref import lora_matmul_ref

__all__ = ["MAX_RANK", "lora_matmul", "lora_matmul_kernel", "lora_matmul_ref"]
