"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use) with their plain PyTorch versions:

* lora_matmul  — fused y = xW + scale·(xAᵀ)Bᵀ (the paper's adapter math)
* paged_decode — one-token GQA attention over a block-table page pool

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
(``backend.dispatch``); ``backend.LAUNCH_COUNTS`` counts kernel launches.
"""
from .backend import LAUNCH_COUNTS, reset_launch_counts
from .flash_attention import flash_decode_ref, paged_decode, paged_decode_ref
from .lora_matmul import lora_matmul, lora_matmul_ref

__all__ = ["LAUNCH_COUNTS", "reset_launch_counts", "flash_decode_ref",
           "paged_decode", "paged_decode_ref", "lora_matmul", "lora_matmul_ref"]
