"""Plain PyTorch versions of the fused LoRA matmul, its two backward
kernels, the int8-base (q8) forward and dX, and the multi-tenant gather
forward (the CPU route, and the references the CUDA kernels are held
against on the card)."""
from __future__ import annotations

import torch

from ...precision import dequantize_weight


def acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The accumulation dtype: f32, or f64 when an operand is f64 (so a
    float64 ``gradcheck`` of the plain path is exact)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float) -> torch.Tensor:
    """y = x @ w + scale * (x @ a^T) @ b^T.

    x: (M, K); w: (K, N); a: (r, K); b: (N, r).  f32 accumulation, y in
    x's dtype — the twin of ``repro.kernels.lora_matmul.lora_matmul_ref``."""
    acc = acc_dtype(x, w, a, b)
    xf = x.to(acc)
    y = xf @ w.to(acc)
    z = xf @ a.to(acc).T
    y = y + scale * (z @ b.to(acc).T)
    return y.to(x.dtype)


def take_adapters(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` along axis 0 with ``jnp.take``'s default (fill) mode,
    as ``repro`` gathers adapters: an index in [-A, 0) counts from the
    end, any other index outside [0, A) gives a NaN entry."""
    A = pool.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + A, idx)
    ok = (idx >= 0) & (idx < A)
    sel = pool[torch.where(ok, idx, torch.zeros_like(idx))]
    nan = torch.full((), float("nan"), dtype=pool.dtype, device=pool.device)
    return torch.where(ok.reshape(ok.shape + (1,) * (sel.dim() - ok.dim())), sel, nan)


def lora_matmul_gathered_ref(x: torch.Tensor, w: torch.Tensor, a_pool: torch.Tensor,
                             b_pool: torch.Tensor, idx: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """y[m] = x[m] @ w + scale * (x[m] @ a_pool[idx[m]]^T) @ b_pool[idx[m]]^T.

    x: (M, K); w: (K, N); a_pool: (A, r, K); b_pool: (A, N, r); idx: (M,)
    int adapter index per row (``take_adapters``: an index outside the
    pool gives a NaN row).  f32 accumulation, y in x's dtype — the twin
    of ``repro.kernels.lora_matmul.lora_matmul_gathered_ref``."""
    acc = acc_dtype(x, w, a_pool, b_pool)
    xf = x.to(acc)
    y = xf @ w.to(acc)
    a_sel = take_adapters(a_pool, idx).to(acc)                    # (M, r, K)
    b_sel = take_adapters(b_pool, idx).to(acc)                    # (M, N, r)
    z = torch.einsum("mk,mrk->mr", xf, a_sel)
    y = y + scale * torch.einsum("mr,mnr->mn", z, b_sel)
    return y.to(x.dtype)


def lora_matmul_dx_ref(dy: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, scale: float) -> torch.Tensor:
    """dX = dY @ W^T + scale * (dY @ B) @ A, f32 inside, dX in dy's dtype.

    dy: (M, N); w: (K, N) — the forward layout; a: (r, K); b: (N, r).
    The twin of ``lora_matmul_dx_kernel`` and of the non-kernel branch of
    ``repro.kernels.lora_matmul.ops._bwd_value``."""
    acc = acc_dtype(dy, w, a, b)
    dyf = dy.to(acc)
    z2 = dyf @ b.to(acc)
    dx = dyf @ w.to(acc).T + scale * (z2 @ a.to(acc))
    return dx.to(dy.dtype)


def lora_rank_reduce_ref(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out = u^T @ v in f32: u (M, r), v (M, N) of any float dtype ->
    (r, N) f32 (f64 for f64 operands) — the adapter-gradient reduction
    (dA and dB^T)."""
    acc = acc_dtype(u, v)
    return u.to(acc).T @ v.to(acc)


def lora_matmul_q8_ref(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """y = x @ (w_q * w_scale) + scale * (x @ a^T) @ b^T over a weight-only
    int8 base: w_q int8 (K, N), w_scale f32 (N,) or (1, N).  Dequantizes
    first, then runs ``lora_matmul_ref`` — the twin of
    ``repro.kernels.lora_matmul.lora_matmul_q8_ref``."""
    wf = dequantize_weight(w_q, w_scale.reshape(-1), acc_dtype(x, a, b))
    return lora_matmul_ref(x, wf, a, b, scale)


def lora_matmul_q8_dx_ref(dy: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """dX = dY @ (w_q * w_scale)^T + scale * (dY @ B) @ A, f32 inside, dX
    in dy's dtype — the dX of the non-kernel branch of
    ``repro.kernels.lora_matmul.ops._bwd_value_q8``."""
    wf = dequantize_weight(w_q, w_scale.reshape(-1), acc_dtype(dy, a, b))
    return lora_matmul_dx_ref(dy, wf, a, b, scale)
