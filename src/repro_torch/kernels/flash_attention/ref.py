"""Plain PyTorch versions of the attention kernels (the CPU route, and the
references the CUDA kernels are held against on the card)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q (B, KH, G, D) — one query token per slot, GQA folded; k/v
    (B, KH, L, D); lengths (B,) live entries per slot at [0, length); a
    window also drops entries ``k_idx <= length - 1 - window``.  Masked
    full-score softmax in f32; a slot with no live entry gives zeros."""
    D = q.shape[-1]
    L = k.shape[2]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * D ** -0.5
    k_idx = torch.arange(L, device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    mask = k_idx < lens
    if window:
        mask &= k_idx > lens - 1 - window
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.to(q.dtype)


def _dequantize_kv(kv: torch.Tensor, scale: torch.Tensor, head_axis: int) -> torch.Tensor:
    """int8 -> f32 times the (KH,) per-KV-head scale, as ``repro`` does."""
    shape = [1] * kv.dim()
    shape[head_axis] = -1
    return kv.float() * scale.to(kv.device).float().reshape(shape)


def flash_decode_q8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Int8-KV decode: k/v int8 (B, KH, L, D), k_scale/v_scale f32 (KH,);
    dequantizes (int8 -> f32 * scale) and applies ``flash_decode_ref``."""
    return flash_decode_ref(q, _dequantize_kv(k, k_scale, 1), _dequantize_kv(v, v_scale, 1),
                            lengths, window=window)


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, lengths: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """q (B, KH, G, D); k_pages/v_pages (KH, NP, PS, D) — the global pool
    (page 0 is the null page); block_tables (B, MP) int32, entry j naming
    the page of positions [j*PS, (j+1)*PS); lengths (B,).

    Gathers each slot's pages into its logical (MP*PS,) view — entry i IS
    absolute position i — and applies ``flash_decode_ref``; the twin of
    ``repro.kernels.flash_attention.paged_decode_ref``."""
    B = q.shape[0]
    KH, _, PS, D = k_pages.shape
    MP = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KH, MP * PS, D)
    v = v_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KH, MP * PS, D)
    return flash_decode_ref(q, k, v, lengths)


def paged_decode_q8_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        lengths: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Int8-KV paged decode: int8 pools (KH, NP, PS, D) with f32 (KH,)
    scales; dequantizes the pool per KV head, then ``paged_decode_ref``."""
    return paged_decode_ref(q, _dequantize_kv(k_pages, k_scale, 0),
                            _dequantize_kv(v_pages, v_scale, 0), lengths, block_tables)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention with the full score
    matrix in f32, in the model layout: q (B, Sq, H, D), k/v (B, Sk, KH, D)
    -> (B, Sq, H, D) in q's dtype.

    Query row i sits at absolute position ``max(Sk - Sq, 0) + i`` (the
    ``q_offset`` of ``repro.kernels.flash_attention.flash_attention``);
    key j is visible iff j <= q_pos and, with a window, q_pos - j < window.
    A row that sees no key gives zeros, as the kernel does.  For Sq <= Sk
    this is ``repro``'s ``flash_attention_ref`` transposed to the model
    layout."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qr = q.float().reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * D ** -0.5
    q_pos = max(Sk - Sq, 0) + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
