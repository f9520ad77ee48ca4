from .ops import (MAX_RANK, lora_matmul, lora_matmul_dx, lora_matmul_dx_kernel,
                  lora_matmul_gather_kernel, lora_matmul_gathered, lora_matmul_kernel,
                  lora_matmul_q8_dx, lora_matmul_q8_dx_kernel, lora_matmul_q8_kernel,
                  lora_rank_reduce, lora_rank_reduce_kernel)
from .ref import (lora_matmul_dx_ref, lora_matmul_gathered_ref, lora_matmul_q8_dx_ref,
                  lora_matmul_q8_ref, lora_matmul_ref, lora_rank_reduce_ref, take_adapters)

__all__ = ["MAX_RANK", "lora_matmul", "lora_matmul_dx", "lora_matmul_dx_kernel",
           "lora_matmul_dx_ref", "lora_matmul_gather_kernel", "lora_matmul_gathered",
           "lora_matmul_gathered_ref", "lora_matmul_kernel", "lora_matmul_q8_dx",
           "lora_matmul_q8_dx_kernel", "lora_matmul_q8_dx_ref", "lora_matmul_q8_kernel",
           "lora_matmul_q8_ref", "lora_matmul_ref", "lora_rank_reduce",
           "lora_rank_reduce_kernel", "lora_rank_reduce_ref", "take_adapters"]
