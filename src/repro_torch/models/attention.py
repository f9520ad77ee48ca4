"""GQA attention: projections, the training path (naive and chunked
online-softmax attention, causal self-attention), the slab serving path
(prefill caches, slab-cache init, one-token slab decode) and the paged
serving path (page-pool init, one-token paged decode, chunked prefill) —
the port of ``repro.models.attention``.

The training attention is plain PyTorch, as it is jnp in JAX:
``online_attention`` is the twin of ``repro``'s ``_flash_attention``
custom VJP (forward scan with the log-sum-exp saved, backward recomputing
the probabilities chunk by chunk), here a ``torch.autograd.Function``,
with ``repro``'s knobs: ``kv_chunk``, query blocking (``q_chunk``) and the
low-precision score einsum (``s_low_precision``, ``Runtime.attn_s_bf16``).

The serving caches and pools are updated IN PLACE (index assignment), where JAX
returns a new array that buffer donation lets XLA write in place; each
function still returns the cache dict so callers read like their JAX
twins.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_decode, paged_decode, paged_decode_ref
from ..sharding.collectives import gather_whole, split_along
from ..sharding.tp import (WHOLE, Entry, TensorParallel, col_lora, is_cut, lse_combine,
                           owned_slot, piece, row_lora)
from .layers import apply_rope, dense, init_dense

NEG_INF = -1e30
# the online-softmax KV chunk; a KV length up to it takes the full-score form
KV_CHUNK = 512


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


def _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl="einsum", adapter_idx=None):
    """Project and reshape to (B, S, H|KH, D), rope NOT yet applied.
    ``adapter_idx`` (B,) gathers each row's adapter out of a pooled
    ``lora`` (``layers.dense``)."""
    B, S, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(wname, lname):
        return dense(x, p[wname]["w"], p[wname].get("b"), _lora(lora, lname), lora_scale,
                     impl=dense_impl, w_scale=p[wname].get("w_scale"),
                     adapter_idx=adapter_idx)

    q, k, v = proj("wq", "q"), proj("wk", "k"), proj("wv", "v")
    return q.reshape(B, S, h, hd), k.reshape(B, S, kh, hd), v.reshape(B, S, kh, hd)


def _out_proj(p, o, lora, lora_scale, dense_impl, adapter_idx=None):
    return dense(o, p["wo"]["w"], p["wo"].get("b"), _lora(lora, "o"), lora_scale,
                 impl=dense_impl, w_scale=p["wo"].get("w_scale"), adapter_idx=adapter_idx)


# ---------------------------------------------------------------------------
# core attention math (training)
# ---------------------------------------------------------------------------

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(Sq, Sk) bool; k_pos < 0 marks padding slots."""
    m = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def naive_attention(q, k, v, q_pos, k_pos, window: int = 0) -> torch.Tensor:
    """Full-score-matrix attention: q (B, Sq, H, D), k/v (B, Sk, KH, D),
    positions (Sq,), (Sk,).  Scores and the softmax in f32, the output in
    q's dtype."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qr = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * D ** -0.5
    s = s.masked_fill(~_mask(q_pos, k_pos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _chunk_kv(k, v, k_pos, kv_chunk: int):
    """Pad the KV length to a multiple of ``kv_chunk`` (padding positions
    -1, masked) and cut it into chunks: (n, B, C, KH, D) and (n, C)."""
    B, Sk, KH, D = k.shape
    pad = (-Sk) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    n = (Sk + pad) // kv_chunk
    kc = k.reshape(B, n, kv_chunk, KH, D).transpose(0, 1)
    vc = v.reshape(B, n, kv_chunk, KH, D).transpose(0, 1)
    return kc, vc, k_pos.reshape(n, kv_chunk), pad


def _flash_fwd_scan(q, k, v, q_pos, k_pos, window: int, kv_chunk: int,
                    s_low_precision: bool = False):
    """Online-softmax forward.  Returns (out (B, Sq, KH, G, D) f32,
    lse (B, KH, G, Sq) f32).  ``s_low_precision`` keeps the scaled query
    and the score einsum in the input dtype (``repro``'s bf16 score
    einsum); the softmax and the sums stay f32."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    kc, vc, pc, _ = _chunk_kv(k, v, k_pos, kv_chunk)
    if s_low_precision:
        qs = q.reshape(B, Sq, KH, G, D) * torch.tensor(D ** -0.5, dtype=q.dtype)
    else:
        qs = q.float().reshape(B, Sq, KH, G, D) * D ** -0.5
    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KH, G, D), dtype=torch.float32, device=q.device)
    for ki, vi, pi in zip(kc, vc, pc):
        if s_low_precision:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ki.to(qs.dtype)).float()
        else:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ki.float())
        valid = _mask(q_pos, pi, window)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * valid
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        # p meets V in V's dtype (the flash-kernel convention), f32 sums
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(vi.dtype).float(), vi.float())
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = l.clamp_min(1e-30)
    out = acc / denom.permute(0, 3, 1, 2)[..., None]
    return out, m + torch.log(denom)


class _FlashAttention(torch.autograd.Function):
    """Chunked online-softmax attention that never holds the (Sq, Sk)
    score matrix, in the forward or the backward — the twin of
    ``repro.models.attention._flash_attention``.  The backward recomputes
    the scores in f32 whatever ``s_low_precision`` is, as ``repro``'s
    ``_flash_bwd`` does (the flag rides along to it unused)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window: int, kv_chunk: int,
                s_low_precision: bool = False):
        out, lse = _flash_fwd_scan(q, k, v, q_pos, k_pos, window, kv_chunk,
                                   s_low_precision)
        ctx.window, ctx.kv_chunk = window, kv_chunk
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        B, Sq, H, D = q.shape
        return out.reshape(B, Sq, H, D).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        """Recompute p per chunk from the saved lse: O(seq) residuals."""
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        B, Sq, H, D = q.shape
        Sk, KH = k.shape[1], k.shape[2]
        G = H // KH
        scale = D ** -0.5
        kc, vc, pc, _ = _chunk_kv(k, v, k_pos, ctx.kv_chunk)
        qf = q.float().reshape(B, Sq, KH, G, D)
        do = dout.float().reshape(B, Sq, KH, G, D)
        delta = (do * out).sum(-1).permute(0, 2, 3, 1)          # (B, KH, G, Sq)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        lowp = lambda t, like: t.to(like.dtype).float()         # noqa: E731
        for ki, vi, pi in zip(kc, vc, pc):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ki.float()) * scale
            valid = _mask(q_pos, pi, ctx.window)
            p = torch.exp(s - lse[..., None]) * valid
            dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", lowp(p, ki), lowp(do, ki)))
            dp = torch.einsum("bqhgd,bkhd->bhgqk", lowp(do, vi), vi.float())
            ds = lowp(p * (dp - delta[..., None]) * scale, ki)
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, ki.float())
            dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, lowp(qf, ki)))
        dk = torch.cat(dks, dim=1)[:, :Sk]
        dv = torch.cat(dvs, dim=1)[:, :Sk]
        return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def online_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                     kv_chunk: int = KV_CHUNK, q_chunk: int = 0,
                     causal_prefix: bool = False,
                     s_low_precision: bool = False) -> torch.Tensor:
    """Flash-style online-softmax attention (never materializes the
    (Sq, Sk) score matrix in forward or backward).  q: (B, Sq, H, D);
    k, v: (B, Sk, KH, D); positions (Sq,), (Sk,).

    ``q_chunk`` blocks the queries when it divides Sq into more than one
    block, in ``repro``'s two forms: with ``causal_prefix`` (q_pos ==
    k_pos == arange, plain causal self-attention) block i attends only to
    the KV prefix it can reach, from the window's start rounded down to a
    multiple of ``kv_chunk``; otherwise every block attends to the whole
    KV (``repro``'s ``lax.map``)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    fa = _FlashAttention.apply
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        nq = Sq // q_chunk
        qb = q.reshape(B, nq, q_chunk, H, D)
        pb = q_pos.reshape(nq, q_chunk)
        outs = []
        for i in range(nq):
            if causal_prefix and Sq == Sk:
                lo = max(0, (i + 1) * q_chunk - window) if window else 0
                lo = (lo // kv_chunk) * kv_chunk                # chunk-aligned
                hi = (i + 1) * q_chunk
                outs.append(fa(qb[:, i], k[:, lo:hi], v[:, lo:hi], pb[i], k_pos[lo:hi],
                               window, min(kv_chunk, hi - lo), s_low_precision))
            else:
                outs.append(fa(qb[:, i], k, v, pb[i], k_pos, window, min(kv_chunk, Sk),
                               s_low_precision))
        return torch.cat(outs, dim=1)
    return fa(q, k, v, q_pos, k_pos, window, min(kv_chunk, Sk), s_low_precision)


def run_attention(q, k, v, q_pos, k_pos, *, impl: str = "chunked", window: int = 0,
                  kv_chunk: int = KV_CHUNK, q_chunk: int = 0, causal_prefix: bool = False,
                  s_low_precision: bool = False) -> torch.Tensor:
    """``repro``'s rule: ``impl="naive"`` takes the full-score form; so
    does a KV length that fits one chunk when there is no query blocking
    and no low-precision score einsum (exact attention over the same
    mask); anything else the chunked online softmax."""
    if impl == "naive" or (k.shape[1] <= kv_chunk and q_chunk == 0
                           and not s_low_precision):
        return naive_attention(q, k, v, q_pos, k_pos, window)
    return online_attention(q, k, v, q_pos, k_pos, window=window, kv_chunk=kv_chunk,
                            q_chunk=q_chunk, causal_prefix=causal_prefix,
                            s_low_precision=s_low_precision)


def attn_knobs(rt) -> dict:
    """The ``Runtime``'s attention knobs as ``self_attention`` keywords."""
    return dict(impl=rt.attn_impl, kv_chunk=rt.kv_chunk, q_chunk=rt.q_chunk,
                s_low_precision=rt.attn_s_bf16)


def _qkv_tp(cfg, p, ent: Entry, lora, lora_scale, dense_impl: str):
    """q, k, v (B, S, h, D) of ``ent``'s input, rope not yet applied: a
    projection whose weight is cut over ``ent.tp`` runs column-parallel on
    this rank's heads, gathered whole where the cut falls within a KV
    group (KH % tp != 0); a whole weight runs whole."""
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = ent.tp
    local_heads = KH % tp.n == 0
    B, S = ent.h.shape[0], ent.h.shape[1] * (tp.n if ent.seq else 1)

    def proj(wname, lname, width):
        w = p[wname]
        if is_cut(w["w"], 1, width):
            y = dense(ent.par(), w["w"], w.get("b"), col_lora(_lora(lora, lname), tp),
                      lora_scale, impl=dense_impl)
            y = y if local_heads else gather_whole(y, tp.group, -1)
        else:
            y = dense(ent.rep(), w["w"], w.get("b"), _lora(lora, lname), lora_scale,
                      impl=dense_impl, w_scale=w.get("w_scale"))
        return y.reshape(B, S, -1, hd)

    return proj("wq", "q", H * hd), proj("wk", "k", KH * hd), proj("wv", "v", KH * hd)


def _out_tp(cfg, p, ent: Entry, o, lora, lora_scale, dense_impl: str):
    """The output projection of attention's output o (B, S, h * D) back to
    ``ent``'s layout: row-parallel where ``wo`` is cut (on this rank's
    heads, sliced out of a whole o first where KH % tp != 0), whole
    otherwise."""
    tp = ent.tp
    wo = p["wo"]
    if is_cut(wo["w"], 0, cfg.num_heads * cfg.head_dim):
        if cfg.num_kv_heads % tp.n:
            o = split_along(o, tp.group, -1)
        return ent.exit(partial=dense(o, wo["w"], None, row_lora(_lora(lora, "o"), tp),
                                      lora_scale, impl=dense_impl), bias=wo.get("b"))
    return ent.exit(whole=_out_proj(p, o, lora, lora_scale, dense_impl))


def self_attention(cfg, p, x, positions, *, lora=None, lora_scale=1.0,
                   dense_impl: str = "einsum", return_cache: bool = False,
                   cache_len: int = 0, impl: str = "chunked", kv_chunk: int = KV_CHUNK,
                   q_chunk: int = 0, s_low_precision: bool = False,
                   tp: TensorParallel = WHOLE, seq: bool = False):
    """Causal self-attention over a full sequence (training, prefill): x
    (B, S, d), positions (S,) absolute positions; ``impl``, ``kv_chunk``,
    ``q_chunk`` and ``s_low_precision`` go to ``run_attention`` (query
    blocks walk their causal prefix).  With ``return_cache``
    also returns a decode cache of length ``cache_len or S`` (a ring of
    the trailing window when ``cfg.attn_window`` is smaller): {"k", "v":
    (B, L, KH, D), "pos": (B, L) int32, -1 = empty}.

    Over a tensor-parallel axis ``tp`` (``sharding.tp``) x is whole rows,
    or with ``seq`` (mode "train") this rank's piece of the sequence (the
    output likewise), and a projection whose weight is cut runs on this
    rank's heads: column-parallel q/k/v, row-parallel ``wo``.  Where the
    cut falls within a KV group (KH % tp != 0) q/k/v are gathered and
    attention runs whole, each rank then taking its heads for ``wo``.
    The cache is this rank's piece of it (``sharding.specs.cache_spec``):
    its KV heads where KH % tp == 0, else its piece of the length L, which
    must then divide over the axis."""
    B, S = x.shape[0], positions.shape[0]
    ent = Entry(x, tp, seq)
    q, k, v = _qkv_tp(cfg, p, ent, lora, lora_scale, dense_impl)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions.expand(B, S), cfg.rope_theta)
        k = apply_rope(k, positions.expand(B, S), cfg.rope_theta)
    o = run_attention(q, k, v, positions, positions, impl=impl, window=cfg.attn_window,
                      kv_chunk=kv_chunk, q_chunk=q_chunk, causal_prefix=True,
                      s_low_precision=s_low_precision).reshape(B, S, -1)
    y = _out_tp(cfg, p, ent, o, lora, lora_scale, dense_impl)
    if not return_cache:
        return y
    L = cache_len or S
    if cfg.attn_window:
        L = min(L, cfg.attn_window)
    if L >= S:
        kc = F.pad(k, (0, 0, 0, 0, 0, L - S))
        vc = F.pad(v, (0, 0, 0, 0, 0, L - S))
        pc = F.pad(positions.to(torch.int32), (0, L - S), value=-1)
    else:
        # keep the trailing window as a ring, so that entry p % L holds
        # position p (decode_attention's write rule)
        shift = (S - L) % L
        kc = torch.roll(k[:, S - L:], shift, dims=1)
        vc = torch.roll(v[:, S - L:], shift, dims=1)
        pc = torch.roll(positions[S - L:].to(torch.int32), shift)
    # one position row per sequence: decode advances each row on its own
    pc = pc.expand(B, L)
    if tp.n > 1 and cfg.num_kv_heads % tp.n:
        _check_length_cut(L, tp)
        kc, vc, pc = piece(kc, 1, tp), piece(vc, 1, tp), piece(pc, 1, tp)
    return y, {"k": kc.contiguous(), "v": vc.contiguous(), "pos": pc.contiguous()}


def _check_length_cut(L: int, tp: TensorParallel) -> None:
    if L % tp.n:
        raise NotImplementedError(
            f"a KV cache of {L} positions over {tp.n} ranks: with KH % tp != 0 the cache "
            "is cut over its length, which must divide over the axis")


def init_attn_cache(cfg, batch: int, cache_len: int, dtype, device) -> dict:
    """Empty slab cache: {"k", "v": (B, L, KH, D) zeros, "pos": (B, L)
    int32 = -1}, L = ``cache_len`` (the window, if smaller)."""
    L = cache_len
    if cfg.attn_window:
        L = min(L, cfg.attn_window)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, L, kh, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, L, kh, hd), dtype=dtype, device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device)}


def decode_masked_attention(q, k, v, q_pos, k_pos, window: int = 0) -> torch.Tensor:
    """Whole-score decode attention with per-slot positions: q (B, 1, H,
    D); k/v (B, L, KH, D); q_pos (B,); k_pos (B, L) absolute positions
    (-1 = empty).  Correct for ring-wrapped windowed caches, where the
    length-masked ``flash_decode`` is not; the plain path of
    ``decode_attention``."""
    B, _, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qr = q.reshape(B, 1, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * D ** -0.5
    m = (k_pos <= q_pos[:, None]) & (k_pos >= 0)
    if window:
        m &= (q_pos[:, None] - k_pos) < window
    s = torch.where(m[:, None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention(cfg, p, x, cache, cur_index, *, lora=None, lora_scale=1.0,
                     impl="naive", dense_impl: str = "einsum", adapter_idx=None,
                     tp: TensorParallel = WHOLE):
    """One-token decode over the slab cache: x (B, 1, d); cache {"k", "v":
    (B, L, KH, D), "pos": (B, L)}; cur_index a scalar absolute position or
    a (B,) vector (serving slots each at their own).

    Writes the new KV and position IN PLACE at entry ``cur_index % L`` per
    sequence (a ring when windowed) and attends over the cache.
    ``impl="flash"`` on a non-windowed cache routes through
    ``kernels.flash_attention.flash_decode`` with lengths ``cur_index + 1``
    (the CUDA kernel for a CUDA tensor, reading the cache in place); any
    other case takes ``decode_masked_attention``.  ``adapter_idx`` (B,)
    gathers each slot's adapter out of a pooled ``lora``.

    Over a tensor-parallel axis ``tp`` (``sharding.tp``) the cache is this
    rank's piece (``self_attention``'s).  Cut over the KV heads, the
    rank's heads run as above (``flash_decode`` on them under "flash").
    Cut over the length (KH % tp != 0), q/k/v are whole, the new entry is
    written only on the rank whose piece holds it, each rank takes the
    plain partial softmax over its piece and ``sharding.tp.lse_combine``
    joins them; no ported kernel returns its log-sum-exp, so "flash"
    raises there."""
    if tp.n > 1:
        if adapter_idx is not None:
            raise NotImplementedError("multi-tenant adapters need the paged engine, which "
                                      "runs on one device")
        return _tp_decode_attention(cfg, p, x, cache, cur_index, lora, lora_scale, impl,
                                    dense_impl, tp)
    B = x.shape[0]
    q, k, v = _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl, adapter_idx)
    pos_vec, q, k = _decode_rope(cfg, q, k, cur_index, B, x.device)
    o = _attend_slab(cfg, q, k, v, cache, pos_vec, impl)
    y = _out_proj(p, o.reshape(B, 1, -1), lora, lora_scale, dense_impl, adapter_idx)
    return y, cache


def _decode_rope(cfg, q, k, cur_index, B: int, device):
    pos_vec = torch.as_tensor(cur_index, dtype=torch.int32, device=device).expand(B)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, pos_vec[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_vec[:, None], cfg.rope_theta)
    return pos_vec, q, k


def _attend_slab(cfg, q, k, v, cache, pos_vec, impl):
    """Write one token's k/v (B, 1, KH, D) at entry ``pos % L`` of a whole
    slab cache (or of its KV heads' piece) and attend over it."""
    B = q.shape[0]
    L = cache["k"].shape[1]
    bidx = torch.arange(B, device=q.device)
    slot = (pos_vec % L).long()
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos_vec
    if impl == "flash" and not cfg.attn_window:
        return flash_decode(q, cache["k"], cache["v"], (pos_vec + 1).to(torch.int32))
    return decode_masked_attention(q, cache["k"], cache["v"], pos_vec, cache["pos"],
                                   cfg.attn_window)


def _tp_decode_attention(cfg, p, x, cache, cur_index, lora, lora_scale, impl, dense_impl,
                         tp: TensorParallel):
    B = x.shape[0]
    ent = Entry(x, tp)
    q, k, v = _qkv_tp(cfg, p, ent, lora, lora_scale, dense_impl)
    pos_vec, q, k = _decode_rope(cfg, q, k, cur_index, B, x.device)
    if cfg.num_kv_heads % tp.n == 0:
        o = _attend_slab(cfg, q, k, v, cache, pos_vec, impl)
    else:
        if impl == "flash":
            raise NotImplementedError(
                "decode_attn_impl='flash' over a KV cache cut over its length: no ported "
                "kernel returns the log-sum-exp the ranks' pieces are joined by "
                "(ROADMAP.md); use decode_attn_impl='naive'")
        o = _length_cut_decode(cfg, q, k, v, cache, pos_vec, tp)
    return _out_tp(cfg, p, ent, o.reshape(B, 1, -1), lora, lora_scale, dense_impl), cache


def _length_cut_decode(cfg, q, k, v, cache, pos_vec, tp: TensorParallel):
    """Decode over this rank's piece of a cache cut over its length: the
    new entry written where it lies, the partial softmax over the piece
    (f32, masked by position as ``decode_masked_attention``), joined over
    the axis."""
    B, _, H, D = q.shape
    Lc, KH = cache["k"].shape[1], cache["k"].shape[2]
    G = H // KH
    idx, own = owned_slot((pos_vec % (Lc * tp.n)).long(), Lc, tp)
    bidx = torch.arange(B, device=q.device)
    for name, new in (("k", k[:, 0]), ("v", v[:, 0]), ("pos", pos_vec)):
        t = cache[name]
        keep = own.reshape((B,) + (1,) * (new.dim() - 1))
        t[bidx, idx] = torch.where(keep, new.to(t.dtype), t[bidx, idx])
    qr = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, cache["k"].float()) * D ** -0.5
    k_pos = cache["pos"]
    valid = (k_pos <= pos_vec[:, None]) & (k_pos >= 0)
    if cfg.attn_window:
        valid &= (pos_vec[:, None] - k_pos) < cfg.attn_window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None]) * valid
    o = torch.einsum("bhgk,bkhd->bhgd", pr.to(cache["v"].dtype).float(), cache["v"].float())
    out = lse_combine(m, pr.sum(-1), o, tp)
    return out.reshape(B, 1, H, D).to(q.dtype)


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
                           dense_impl: str = "einsum", adapter_idx=None):
    """One-token decode over the paged pool: x (B, 1, d); cache {"k","v"}
    (KH, NP, PS, D); block_table (B, MP) int32; cur_index (B,) absolute
    positions.

    Writes the new KV into page ``block_table[b, pos // PS]`` at offset
    ``pos % PS`` and attends over the slot's logical view.  Dead slots
    carry an all-null row, so every one of them writes to page 0: the
    scatter's only duplicate indices land on the null page, which no live
    slot ever reads.  ``impl="flash"`` routes through
    ``kernels.flash_attention.paged_decode`` (the CUDA kernel for a CUDA
    tensor); any other impl takes the plain gather version.
    ``adapter_idx`` (B,) gathers each slot's adapter out of a pooled
    ``lora`` (multi-tenant serving)."""
    B = x.shape[0]
    PS = cache["k"].shape[2]
    MP = block_table.shape[1]
    q, k, v = _proj_qkv(cfg, p, x, lora, lora_scale, dense_impl, adapter_idx)
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
    y = _out_proj(p, o.reshape(B, 1, -1), lora, lora_scale, dense_impl, adapter_idx)
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
