"""Plain PyTorch versions of the SSD scan (the CPU route, and the
references the CUDA kernel is held against on the card).

``ssd_sequential_ref`` is the per-token recurrence, the oracle of
``repro.kernels.ssd_scan.ref``:
    h_t = h_{t-1} exp(A dt_t) + dt_t B_t (x) x_t ;  y_t = C_t . h_t
``ssd_chunked`` is the chunked algorithm of ``repro.models.ssm`` — the
quadratic attention form inside chunks of Q tokens and the linear
recurrence across chunk states — and the kernel's plain twin.  Both take
the model layout and compute in f32, or in f64 when ``xh`` is f64 (the
double-precision witness of the kernel's rounding).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ssd_sequential_ref(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       dt: torch.Tensor, A: torch.Tensor):
    """xh (B, S, nh, hd); Bm/Cm (B, S, N); dt (B, S, nh); A (nh,) < 0.
    Returns (y (B, S, nh, hd), h_last (B, nh, hd, N)), f32 throughout (f64
    for an f64 ``xh``)."""
    Bsz, S, nh, hd = xh.shape
    N = Bm.shape[-1]
    ct = compute_dtype(xh)
    xh, Bm, Cm, dt, A = (t.to(ct) for t in (xh, Bm, Cm, dt, A))
    h = torch.zeros((Bsz, nh, hd, N), dtype=ct, device=xh.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])                       # (B, nh)
        upd = torch.einsum("bn,bhd,bh->bhdn", Bm[:, t], xh[:, t], dt[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhdn->bhd", Cm[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xh.new_zeros((Bsz, 0, nh, hd))
    return y, h


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for an f64 tensor."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) log-decays -> (..., Q, Q) with entry [t, s] = cum_t -
    cum_s for t >= s and -inf above the diagonal."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(tri, diff, torch.full_like(diff, float("-inf")))


def ssd_chunked(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, *, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """SSD forward in chunks of Q = min(chunk, S) tokens (S padded to a
    multiple of Q with dt = 0, which leaves the state unchanged).

    xh (B, S, nh, hd); Bm/Cm (B, S, N); dt (B, S, nh) post-softplus; A (nh,)
    negative.  Returns (y (B, S, nh, hd), h_last (B, nh, hd, N)), f32 (f64
    for an f64 ``xh``)."""
    Bsz, S, nh, hd = xh.shape
    ct = compute_dtype(xh)
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q

    xc = xh.reshape(Bsz, nc, Q, nh, hd).to(ct)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(ct)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(ct)
    dtc = dt.reshape(Bsz, nc, Q, nh).to(ct)

    a = (dtc * A.to(ct)[None, None, None, :]).permute(0, 1, 3, 2)    # (B,nc,nh,Q)
    cum = torch.cumsum(a, dim=-1)

    # intra-chunk (quadratic attention form)
    L = torch.exp(_segsum(a))                                       # (B,nc,nh,Q,Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                    # (B,nc,Q,Q)
    M = CB[:, :, None] * L
    xdt = xc * dtc[..., None]                                       # (B,nc,Q,nh,hd)
    y_intra = torch.einsum("bchqk,bckhd->bcqhd", M, xdt)

    # chunk states
    decay_to_end = torch.exp(cum[..., -1:] - cum)                   # (B,nc,nh,Q)
    states = torch.einsum("bchq,bcqn,bcqhd->bchdn", decay_to_end, Bc, xdt)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                           # (B,nc,nh)
    h = (torch.zeros((Bsz, nh, hd, N), dtype=ct, device=xh.device)
         if h0 is None else h0.to(ct))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                            # (B,nc,nh,hd,N)

    y_inter = torch.einsum("bcqn,bchdn,bchq->bcqhd", Cc, h_prev, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, nh, hd)[:, :S]
    return y, h
