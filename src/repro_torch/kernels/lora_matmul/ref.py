"""Plain PyTorch version of the fused LoRA matmul (the CPU route, and the
reference the CUDA kernel is held against on the card)."""
from __future__ import annotations

import torch


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float) -> torch.Tensor:
    """y = x @ w + scale * (x @ a^T) @ b^T.

    x: (M, K); w: (K, N); a: (r, K); b: (N, r).  f32 accumulation, y in
    x's dtype — the twin of ``repro.kernels.lora_matmul.lora_matmul_ref``."""
    xf = x.float()
    y = xf @ w.float()
    z = xf @ a.float().T
    y = y + scale * (z @ b.float().T)
    return y.to(x.dtype)
