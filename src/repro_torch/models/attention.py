"""GQA attention for paged serving: projections, the page-pool init, the
one-token paged decode and the chunked-prefill step — the port of the
paged half of ``repro.models.attention``.

The pools are updated IN PLACE (index assignment), where JAX returns a
new array that buffer donation lets XLA write in place; each function
still returns the cache dict so callers read like their JAX twins.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import paged_decode, paged_decode_ref
from .layers import apply_rope, dense, init_dense

NEG_INF = -1e30


def init_attention(cfg, gen: torch.Generator, dtype, device) -> dict:
    d = cfg.d_model
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bias = cfg.norm == "layernorm"
    return {"wq": init_dense(gen, d, h * hd, dtype, device, bias=bias),
            "wk": init_dense(gen, d, kh * hd, dtype, device, bias=bias),
            "wv": init_dense(gen, d, kh * hd, dtype, device, bias=bias),
            "wo": init_dense(gen, h * hd, d, dtype, device, bias=bias)}


def _lora(lora, name):
    return None if lora is None or name not in lora else lora[name]


def _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl="einsum"):
    """Project and reshape to (B, S, H|KH, D), rope NOT yet applied."""
    B, S, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["wq"]["w"], p["wq"].get("b"), _lora(lora, "q"), lora_scale,
              impl=dense_impl)
    k = dense(x, p["wk"]["w"], p["wk"].get("b"), _lora(lora, "k"), lora_scale,
              impl=dense_impl)
    v = dense(x, p["wv"]["w"], p["wv"].get("b"), _lora(lora, "v"), lora_scale,
              impl=dense_impl)
    return q.reshape(B, S, h, hd), k.reshape(B, S, kh, hd), v.reshape(B, S, kh, hd)


def _out_proj(p, o, lora, lora_scale, dense_impl):
    return dense(o, p["wo"]["w"], p["wo"].get("b"), _lora(lora, "o"), lora_scale,
                 impl=dense_impl)


def init_paged_attn_cache(cfg, num_pages: int, page_size: int, dtype,
                          device) -> dict:
    """Global KV page pool: (KH, NP, PS, D) per k/v.  Page 0 is the null
    page — dead slots write there and the allocator never hands it out."""
    if cfg.attn_window:
        raise NotImplementedError(
            "paged KV assumes a length-contiguous logical view; windowed "
            "attention is not ported")
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(cfg, p, x, cache, block_table, cur_index, *,
                           lora=None, lora_scale=1.0, impl="naive",
                           dense_impl: str = "einsum"):
    """One-token decode over the paged pool: x (B, 1, d); cache {"k","v"}
    (KH, NP, PS, D); block_table (B, MP) int32; cur_index (B,) absolute
    positions.

    Writes the new KV into page ``block_table[b, pos // PS]`` at offset
    ``pos % PS`` and attends over the slot's logical view.  Dead slots
    carry an all-null row, so every one of them writes to page 0: the
    scatter's only duplicate indices land on the null page, which no live
    slot ever reads.  ``impl="flash"`` routes through
    ``kernels.flash_attention.paged_decode`` (the CUDA kernel for a CUDA
    tensor); any other impl takes the plain gather version."""
    B = x.shape[0]
    PS = cache["k"].shape[2]
    MP = block_table.shape[1]
    q, k, v = _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl)
    pos_vec = cur_index.to(torch.int32).expand(B)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, pos_vec[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_vec[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    # dead slots can sit one past the table (pos == max_len); their row is
    # all-null anyway — clamp so the gather stays in bounds
    page = block_table[bidx, torch.clamp(pos_vec // PS, max=MP - 1).long()].long()
    off = (pos_vec % PS).long()
    cache["k"][:, page, off] = k[:, 0].to(cache["k"].dtype).transpose(0, 1)
    cache["v"][:, page, off] = v[:, 0].to(cache["v"].dtype).transpose(0, 1)
    lengths = (pos_vec + 1).to(torch.int32)
    if impl == "flash":
        o = paged_decode(q, cache["k"], cache["v"], lengths, block_table)
    else:
        H, D = q.shape[2], q.shape[3]
        KH = cache["k"].shape[0]
        o = paged_decode_ref(q[:, 0].reshape(B, KH, H // KH, D), cache["k"],
                             cache["v"], lengths, block_table)
    y = _out_proj(p, o.reshape(B, 1, -1), lora, lora_scale, dense_impl)
    return y, cache


def paged_chunk_attention(cfg, p, x, cache, block_table, start: int, *,
                          lora=None, lora_scale=1.0, dense_impl: str = "einsum"):
    """One chunked-prefill step: x (1, C, d) with C == page_size — the
    chunk covering absolute positions [start, start + C); block_table
    (MP,) the slot's page row with the chunk's page already allocated.

    Writes the chunk's KV into page ``block_table[start // PS]`` (chunk ==
    page), then attends causally over the gathered logical view, where
    entry i IS absolute position i.  Padded tail queries produce values
    the caller never reads; their KV is overwritten as decode advances
    through the same page.  Plain PyTorch: the JAX side has no kernel here
    either."""
    _, C, _ = x.shape
    KH, _, PS, D = cache["k"].shape
    MP = block_table.shape[0]
    q, k, v = _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl)
    positions = start + torch.arange(C, dtype=torch.int32, device=x.device)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions[None], cfg.rope_theta)
        k = apply_rope(k, positions[None], cfg.rope_theta)
    page = block_table[start // PS].long()
    cache["k"][:, page] = k[0].to(cache["k"].dtype).transpose(0, 1)
    cache["v"][:, page] = v[0].to(cache["v"].dtype).transpose(0, 1)
    bt = block_table.long()
    kg = cache["k"][:, bt].reshape(KH, MP * PS, D)
    vg = cache["v"][:, bt].reshape(KH, MP * PS, D)
    G = q.shape[2] // KH
    qr = q[0].reshape(C, KH, G, D)
    s = torch.einsum("qhgd,hkd->hgqk", qr.float(), kg.float()) * D ** -0.5
    k_idx = torch.arange(MP * PS, device=x.device)
    mask = k_idx[None, :] <= positions[:, None]
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("hgqk,hkd->qhgd", pr, vg.float())
    o = o.reshape(1, C, -1).to(x.dtype)
    y = _out_proj(p, o, lora, lora_scale, dense_impl)
    return y, cache
