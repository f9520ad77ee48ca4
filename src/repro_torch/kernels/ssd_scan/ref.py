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
    xdt = xc * dtc[..., None]                                       # (B,nc,Q,nh,hd)
    y, h = _chunked(xdt, a, Bc, Cc, h0)
    return y.reshape(Bsz, nc * Q, nh, hd)[:, :S], h


def _chunked(xdt: torch.Tensor, a: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
             h0: Optional[torch.Tensor]):
    """The chunked algorithm on chunked, pre-scaled operands: xdt (B, nc,
    Q, nh, hd), a (B, nc, nh, Q) log decays, Bc/Cc (B, nc, Q, N), all in
    the compute dtype.  Returns (y (B, nc, Q, nh, hd), h_last)."""
    Bsz, nc, Q, nh, hd = xdt.shape
    N = Bc.shape[-1]
    ct = xdt.dtype
    cum = torch.cumsum(a, dim=-1)

    # intra-chunk (quadratic attention form)
    L = torch.exp(_segsum(a))                                       # (B,nc,nh,Q,Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                    # (B,nc,Q,Q)
    M = CB[:, :, None] * L
    y_intra = torch.einsum("bchqk,bckhd->bcqhd", M, xdt)

    # chunk states
    decay_to_end = torch.exp(cum[..., -1:] - cum)                   # (B,nc,nh,Q)
    states = torch.einsum("bchq,bcqn,bcqhd->bchdn", decay_to_end, Bc, xdt)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                           # (B,nc,nh)
    h = (torch.zeros((Bsz, nh, hd, N), dtype=ct, device=xdt.device)
         if h0 is None else h0.to(ct))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                            # (B,nc,nh,hd,N)

    y_inter = torch.einsum("bcqn,bchdn,bchq->bcqhd", Cc, h_prev, torch.exp(cum))
    return y_intra + y_inter, h


def ssd_scan_ref(xdt: torch.Tensor, g: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 *, chunk: int):
    """The plain version of ``ssd_scan_kernel``, in its layout: xdt (B,
    nh, S, hd) = x dt, g (B, nh, S) = A dt, Bm/Cm (B, S, N), S a multiple of
    Q = min(chunk, S).  The chunked algorithm of ``ssd_chunked`` on these
    operands.  Returns (y (B, nh, S, hd), h_last (B, nh, hd, N)), f32 (f64
    for an f64 ``xdt``)."""
    Bsz, nh, S, hd = xdt.shape
    N = Bm.shape[-1]
    ct = compute_dtype(xdt)
    Q = min(chunk, S)
    nc = S // Q
    y, h = _chunked(xdt.to(ct).reshape(Bsz, nh, nc, Q, hd).permute(0, 2, 3, 1, 4),
                    g.to(ct).reshape(Bsz, nh, nc, Q).permute(0, 2, 1, 3),
                    Bm.to(ct).reshape(Bsz, nc, Q, N), Cm.to(ct).reshape(Bsz, nc, Q, N), None)
    return y.permute(0, 3, 1, 2, 4).reshape(Bsz, nh, S, hd), h


def ssd_scan_bwd_ref(xdt: torch.Tensor, g: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, dy: torch.Tensor,
                     dh_last: Optional[torch.Tensor] = None, *, chunk: int):
    """The gradient of ``ssd_scan_ref`` (y, h_last) at the cotangents dy (B,
    nh, S, hd) and dh_last (B, nh, hd, N) or None (zero), in closed form,
    chunk by chunk: the plain version of ``ssd_scan_bwd_kernel``.  Within a
    chunk of Q rows, cum is the prefix sum of g (in double, each difference
    rounded once to the compute dtype, as the kernel takes it), h0 the
    incoming state, dh_end the cotangent of the outgoing one (the next
    chunk's dh0; dh_last for the last chunk), E[t, s] =
    exp(cum_t - cum_s) for s <= t, else 0:

        dh0    = exp(cum_Q) dh_end + sum_t exp(cum_t) dy_t C_t^T
        dxdt_s = sum_t (C_t . B_s) E[t, s] dy_t + exp(cum_Q - cum_s) dh_end B_s
        dB_s   = sum_heads [sum_t E[t, s] (dy_t . xdt_s) C_t
                            + exp(cum_Q - cum_s) dh_end^T xdt_s]
        dC_t   = sum_heads [sum_s E[t, s] (dy_t . xdt_s) B_s + exp(cum_t) h0^T dy_t]
        dg_u   = sum_{t >= u} (sum_s P[t, s] - sum_s P[s, t] + I_t)
                 + sum_{s < u} R_s + exp(cum_Q) <dh_end, h0>

    per head, with P[t, s] = (C_t . B_s) E[t, s] (dy_t . xdt_s) the masked
    pairs (+ at t, - at s), I_t = exp(cum_t) C_t . (h0^T dy_t) the
    inter-chunk term (+ at t), R_s = exp(cum_Q - cum_s) B_s . (dh_end^T
    xdt_s) the state term (+ at Q, - at s: its reverse prefix sum is the
    prefix sum over s < u, taken in that form so the two never cancel),
    and the carried state's term at Q.  The pairs' row and column sums come
    from one matrix P, so their rounding cancels over the chunk as in
    autograd's; the sums of dg run in double.  Returns (dxdt, dg, dBm, dCm) in
    the layouts of xdt, g, Bm and Cm, f32 (f64 for an f64 ``xdt``)."""
    Bsz, nh, S, hd = xdt.shape
    N = Bm.shape[-1]
    ct = compute_dtype(xdt)
    Q = min(chunk, S)
    nc = S // Q
    x = xdt.to(ct).reshape(Bsz, nh, nc, Q, hd)
    dyc = dy.to(ct).reshape(Bsz, nh, nc, Q, hd)
    Bc = Bm.to(ct).reshape(Bsz, nc, Q, N)
    Cc = Cm.to(ct).reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(g.double().reshape(Bsz, nh, nc, Q), dim=-1)
    tot = cum[..., -1:]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    seg = (cum[..., :, None] - cum[..., None, :]).to(ct)           # [t, s]
    E = torch.where(tri, torch.exp(torch.where(tri, seg, torch.zeros_like(seg))),
                    torch.zeros_like(seg))
    w_end = torch.exp((tot - cum).to(ct))                           # exp(cum_Q - cum_s)
    w_in = torch.exp(cum.to(ct))                                    # exp(cum_t)
    decay = torch.exp(tot[..., 0].to(ct))                           # (B, nh, nc)

    states = torch.einsum("bhcs,bhcsd,bcsn->bhcdn", w_end, x, Bc)
    h = torch.zeros((Bsz, nh, hd, N), dtype=ct, device=xdt.device)
    hs = []
    for c in range(nc):
        hs.append(h)
        h = h * decay[..., c, None, None] + states[:, :, c]
    dstates = torch.einsum("bhct,bhctd,bctn->bhcdn", w_in, dyc, Cc)
    dh = (torch.zeros((Bsz, nh, hd, N), dtype=ct, device=xdt.device)
          if dh_last is None else dh_last.to(ct))
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = dh
        dh = dh * decay[..., c, None, None] + dstates[:, :, c]
    h0 = torch.stack(hs, dim=2)                                # (B, nh, nc, hd, N)
    dh_end = torch.stack(dhs, dim=2)

    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    EG = E * torch.einsum("bhctd,bhcsd->bhcts", dyc, x)
    dx = (torch.einsum("bhcts,bhctd->bhcsd", CB[:, None] * E, dyc)
          + w_end[..., None] * torch.einsum("bcsn,bhcdn->bhcsd", Bc, dh_end))
    dB_state = w_end[..., None] * torch.einsum("bhcsd,bhcdn->bhcsn", x, dh_end)
    dBh = torch.einsum("bhcts,bctn->bhcsn", EG, Cc) + dB_state
    dC_inter = w_in[..., None] * torch.einsum("bhctd,bhcdn->bhctn", dyc, h0)
    dCh = torch.einsum("bhcts,bcsn->bhctn", EG, Bc) + dC_inter
    # dcum, term by term: the masked pairs P[t, s] + at t and - at s, the
    # inter-chunk term + at t, the state terms + R_s at Q and - R_s at s,
    # the carried state + at Q; so dg_u = sum_{t >= u} (rows of P - columns
    # of P + inter)_t + sum_{s < u} R_s + carried, in double
    P = (CB[:, None] * EG).double()
    d1 = P.sum(-1) - P.sum(-2) + (Cc[:, None] * dC_inter).sum(-1).double()
    R = (Bc[:, None] * dB_state).sum(-1).double()
    carried = (decay * (dh_end * h0).sum((-2, -1))).double()
    dg = (torch.flip(torch.cumsum(torch.flip(d1, (-1,)), dim=-1), (-1,))
          + torch.cumsum(R, dim=-1) - R + carried[..., None]).to(ct)
    return (dx.reshape(Bsz, nh, S, hd), dg.reshape(Bsz, nh, S),
            dBh.sum(1).reshape(Bsz, S, N), dCh.sum(1).reshape(Bsz, S, N))
