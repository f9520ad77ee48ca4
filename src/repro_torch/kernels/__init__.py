"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use) with their plain PyTorch versions:

* lora_matmul      — fused y = xW + scale·(xAᵀ)Bᵀ (the paper's adapter
                     math), differentiable: its backward runs
* lora_matmul_dx   — dX = dY·Wᵀ + scale·(dY·B)·A, and
* lora_rank_reduce — uᵀ·v in f32, deterministic (dA and dBᵀ);
* lora_matmul_q8 / lora_matmul_q8_dx — the forward and dX over a weight-
                     only int8 base (``lora_matmul(..., w_scale=)``);
* lora_matmul_gathered — the multi-tenant forward: row m wears adapter
                     idx[m] of a pool (the gather entry of lora_matmul's
                     source);
* paged_decode     — one-token GQA attention over a block-table page pool,
                     and paged_decode_q8 over an int8 pool;
* flash_decode     — the same over per-slot slab caches read in the
                     model's layout (the slab engine's decode), and
                     flash_decode_q8 over an int8 slab;
* flash_attention  — causal / sliding-window GQA forward (its op's own
                     entry point; the model's training attention is
                     plain PyTorch, as in JAX);
* ssd_scan         — the chunked SSD (Mamba2) forward with its final state
                     (``ssd_scan_with_state``: Mamba2 prefill and training),
                     and its backward (``ssd_scan_bwd_kernel``, under
                     autograd: Mamba2 training).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
(``backend.dispatch``); ``backend.LAUNCH_COUNTS`` counts kernel launches.
"""
from .backend import LAUNCH_COUNTS, reset_launch_counts
from .flash_attention import (flash_attention, flash_attention_ref, flash_decode,
                              flash_decode_q8_ref, flash_decode_ref, paged_decode,
                              paged_decode_q8_ref, paged_decode_ref)
from .lora_matmul import (lora_matmul, lora_matmul_dx, lora_matmul_dx_ref,
                          lora_matmul_gathered, lora_matmul_gathered_ref,
                          lora_matmul_q8_dx, lora_matmul_q8_dx_ref, lora_matmul_q8_ref,
                          lora_matmul_ref, lora_rank_reduce, lora_rank_reduce_ref)
from .ssd_scan import (ssd_chunked, ssd_scan, ssd_scan_bwd_ref, ssd_scan_with_state,
                       ssd_sequential_ref)

__all__ = ["LAUNCH_COUNTS", "reset_launch_counts", "flash_attention",
           "flash_attention_ref", "flash_decode", "flash_decode_q8_ref", "flash_decode_ref",
           "paged_decode", "paged_decode_q8_ref", "paged_decode_ref",
           "lora_matmul", "lora_matmul_dx", "lora_matmul_dx_ref", "lora_matmul_gathered",
           "lora_matmul_gathered_ref", "lora_matmul_q8_dx",
           "lora_matmul_q8_dx_ref", "lora_matmul_q8_ref", "lora_matmul_ref",
           "lora_rank_reduce", "lora_rank_reduce_ref", "ssd_chunked", "ssd_scan",
           "ssd_scan_bwd_ref", "ssd_scan_with_state", "ssd_sequential_ref"]
