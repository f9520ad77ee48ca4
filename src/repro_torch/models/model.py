"""Top-level model: init, the training forward and loss, slab prefill and
one slab decode step, one paged decode step, one chunked-prefill step.

Params tree (the per-layer twin of ``repro``'s stacked one):
    {"embed": {...}, "layers": [block dict per layer], "final_norm": {...}}
LoRA tree: a list with one ``{"mixer": {"q": {"a", "b"}, ...}}`` dict per
layer (empty dicts where a layer has no adapted projection).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..kernels.backend import resolve_device
from ..sharding.collectives import all_reduce, reduce_from, split_along
from ..sharding.tp import WHOLE, TensorParallel, seq_sharded, tp_of
from . import stack as stack_mod
from .layers import apply_norm, embed, init_embeddings, init_lora, init_norm, unembed
from .stack import Runtime

IGNORE_ID = -1

_ATTN_TARGETS = ("q", "k", "v", "o")
_MLP_TARGETS = ("gate", "up", "down")
_SSM_TARGETS = ("ssm_in", "ssm_out")


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device="cuda", keep=None) -> dict:
    """Random weights from ``gen``: a CPU generator gives the same weights
    on every device; a CUDA one draws them on the card (other numbers, but
    no host time for billions of draws).  ``keep(prefix, subtree)`` takes
    each subtree (``"embed"``, ``"layers/3"``, ``"final_norm"``) as soon
    as it is drawn, before the next, and its result takes the subtree's
    place (``sharding.fsdp`` keeps a rank's pieces)."""
    return _params(cfg, gen, dtype, resolve_device(device), keep)


def _params(cfg, gen, dtype, device, keep=None) -> dict:
    keep = keep or (lambda prefix, sub: sub)
    return {"embed": keep("embed", init_embeddings(cfg, gen, dtype, device)),
            "layers": [keep(f"layers/{i}", stack_mod.init_block(cfg, pat, gen, dtype, device))
                       for i, pat in enumerate(cfg.layer_kinds)],
            "final_norm": keep("final_norm", init_norm(cfg, cfg.d_model, dtype, device))}


META = torch.device("meta")


def abstract_params(cfg, dtype=torch.float32) -> dict:
    """The params tree as ``meta`` tensors: shapes and dtypes, no memory
    (``repro``'s ``abstract_params``, in the port's per-layer layout)."""
    return _params(cfg, torch.Generator(), dtype, META)


def abstract_lora(cfg, rank: Optional[int] = None, dtype=torch.float32) -> List[dict]:
    """The adapter tree as ``meta`` tensors."""
    return _lora_stack(cfg, torch.Generator(), rank, dtype, META)


def abstract_cache(cfg, batch: int, cache_len: int, dtype=torch.float32,
                   mesh=None) -> List[dict]:
    """One slab cache per layer as ``meta`` tensors; with ``mesh``, this
    rank's pieces of them (``sharding.specs.shard_caches``)."""
    caches = stack_mod.init_stack_cache(cfg, batch, cache_len, dtype, META)
    if mesh is None:
        return caches
    from ..sharding.specs import shard_caches
    return shard_caches(caches, mesh)


def _lora_dims(cfg, pat, target: str):
    """-> (block_key, d_in, d_out) for a target name, or None if absent."""
    h, kh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    if target in _ATTN_TARGETS and pat.mixer == "attention":
        return {"q": ("mixer", d, h * hd), "k": ("mixer", d, kh * hd),
                "v": ("mixer", d, kh * hd), "o": ("mixer", h * hd, d)}[target]
    if target in _SSM_TARGETS and pat.mixer == "mamba":
        d_in = cfg.d_inner
        total = 2 * d_in + 2 * cfg.ssm_state + cfg.ssm_num_heads
        return ("mixer", d, total) if target == "ssm_in" else ("mixer", d_in, d)
    if target in _MLP_TARGETS and pat.mlp == "dense":
        ff = cfg.d_ff
        return ("mlp", ff, d) if target == "down" else ("mlp", d, ff)
    return None


def init_lora_stack(cfg, gen: torch.Generator, rank: Optional[int] = None,
                    dtype=torch.float32, device="cuda") -> List[dict]:
    """LoRA adapters for ``cfg.lora_targets``, one dict per layer."""
    return _lora_stack(cfg, gen, rank, dtype, resolve_device(device))


def _lora_stack(cfg, gen, rank, dtype, device) -> List[dict]:
    rank = rank or cfg.lora_rank
    out = []
    for pat in cfg.layer_kinds:
        block: dict = {}
        for t in cfg.lora_targets:
            dims = _lora_dims(cfg, pat, t)
            if dims is None:
                continue
            where, d_in, d_out = dims
            block.setdefault(where, {})[t] = init_lora(gen, d_in, d_out, rank,
                                                       dtype, device)
        out.append(block)
    return out


def embed_inputs(cfg, params: dict, tokens: torch.Tensor, frontend_emb,
                 positions: torch.Tensor, tp: TensorParallel = WHOLE) -> torch.Tensor:
    """Embed the text at the last ``tokens.shape[1]`` positions and put the
    front end's prefix (B, F, d), cast to the embeddings' dtype, in front:
    the prefix takes positions 0..F-1 and no learned position row.  ``tp``:
    the axis the embeddings' pieces lie over (``layers.embed``)."""
    x = embed(cfg, params["embed"], tokens, positions[-tokens.shape[1]:], tp)
    if frontend_emb is not None:
        x = torch.cat([frontend_emb.to(x.dtype), x], dim=1)
    return x


def prefix_len(frontend_emb) -> int:
    """F of a front end's prefix (B, F, d); 0 for None."""
    return 0 if frontend_emb is None else int(frontend_emb.shape[1])


def forward(cfg, params: dict, tokens: torch.Tensor, *, lora=None,
            rt: Runtime = Runtime(), frontend_emb=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (training).  tokens: (B, S_text) int;
    frontend_emb: (B, F, d) or None.  Returns (logits (B, S, V) over all
    S = F + S_text rows, aux loss) — the aux is the sum of the MoE blocks'
    load-balance losses, 0 without MoE.  Under tensor parallelism
    (``Runtime.tp_axis``, ``sharding.tp``) the logits are this rank's
    piece of the vocabulary where the rule table cuts it."""
    tp = tp_of(rt)
    S = tokens.shape[1] + prefix_len(frontend_emb)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_inputs(cfg, params, tokens, frontend_emb, positions, tp)
    seq = seq_sharded(rt, tp, S)
    if seq:
        x = split_along(x, tp.group, 1)
    x, _, aux = stack_mod.apply_stack(cfg, params["layers"], x, positions=positions,
                                      lora=lora, rt=rt, mode="train")
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x, tp, seq), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  denom: Optional[torch.Tensor] = None,
                  vocab_tp: TensorParallel = WHOLE) -> torch.Tensor:
    """Mean next-token NLL over the labels that are not ``IGNORE_ID``, in
    f32 (the twin of ``repro.core.sfl._ce_loss``).  ``denom``: the count
    to divide by in place of these labels' own (the valid labels of a
    whole pooled batch of which these are one rank's rows).
    ``vocab_tp``: the axis the vocabulary is cut over, ``logits`` holding
    this rank's equal piece of it (``sharding.tp``); the max, the sum-exp
    and the gold logit are then taken over the axis."""
    logits = logits.float()
    g = vocab_tp.group
    if g is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    else:
        m = all_reduce(logits.detach().amax(-1), g, "max")
        logz = m + torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(-1), g))
        V = logits.shape[-1]
        idx = labels.long() - vocab_tp.rank * V
        inside = (idx >= 0) & (idx < V)
        gold = torch.gather(logits, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
        gold = reduce_from(gold * inside, g)
    mask = (labels != IGNORE_ID).float()
    if denom is None:
        denom = mask.sum()
    return torch.sum((logz - gold) * mask) / denom.clamp_min(1.0)


def valid_labels(labels: torch.Tensor) -> torch.Tensor:
    """The f32 count of labels that take a loss."""
    return (labels != IGNORE_ID).float().sum()


def loss_fn(cfg, params: dict, lora, batch: dict, *, rt: Runtime = Runtime()):
    """Causal-LM cross entropy.  batch: tokens (B, S), labels (B, S) with
    ``IGNORE_ID`` masking, optional frontend_emb (B, F, d), whose F logit
    rows the loss drops.  Returns (loss + cfg.router_aux_coef * aux,
    {"loss", "aux"}).  Under ``rt.pool`` the batch is this rank's rows of
    a pooled one: the loss divides by the pool's count of valid labels and
    the aux is this rank's share, so the ranks' values sum to the pool's.
    Under tensor parallelism (``sharding.tp``) the cross entropy runs over
    the vocabulary's pieces, and every rank of the axis returns the same
    values."""
    logits, aux = forward(cfg, params, batch["tokens"], lora=lora, rt=rt,
                          frontend_emb=batch.get("frontend_emb"))
    labels = batch["labels"]
    denom = None if rt.pool is None else all_reduce(valid_labels(labels), rt.pool)
    cut = logits.shape[-1] != cfg.vocab_size
    loss = cross_entropy(logits[:, logits.shape[1] - labels.shape[1]:], labels, denom,
                         tp_of(rt) if cut else WHOLE)
    return loss + cfg.router_aux_coef * aux, {"loss": loss, "aux": aux}


def prefill(cfg, params: dict, tokens: torch.Tensor, *, lora=None,
            rt: Runtime = Runtime(), cache_len: int = 0, logit_index=None,
            frontend_emb=None):
    """Build slab decode caches for ``tokens`` (B, S) int behind the
    optional prefix ``frontend_emb`` (B, F, d).  Returns (logits (B, V) at
    text token ``logit_index`` — the last row when None; bucket-padded
    serving prompts read the true last prompt token; the prefix offset F
    is added here — and one cache per layer of length ``cache_len`` or
    F + S).  Under tensor parallelism (``Runtime.tp_axis``, ``sharding.
    tp``) ``params`` are this rank's pieces, the logits this rank's piece
    of the vocabulary where the rule table cuts it (as ``forward``'s),
    and the caches this rank's pieces (``sharding.specs.cache_spec``)."""
    F = prefix_len(frontend_emb)
    S = tokens.shape[1] + F
    tp = tp_of(rt)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_inputs(cfg, params, tokens, frontend_emb, positions, tp)
    x, caches, _ = stack_mod.apply_stack(cfg, params["layers"], x, positions=positions,
                                         lora=lora, rt=rt, mode="prefill",
                                         cache_len=cache_len)
    i = S - 1 if logit_index is None else int(logit_index) + F
    x = apply_norm(cfg, x[:, i:i + 1], params["final_norm"])
    return unembed(cfg, params["embed"], x, tp)[:, 0], caches


def decode_step(cfg, params: dict, token: torch.Tensor, caches, cur_index, *,
                lora=None, rt: Runtime = Runtime(), adapter_idx=None):
    """One decode step over the slab caches.  token: (B, 1) int;
    cur_index: a scalar absolute position (an int or a 0-d tensor) or a
    (B,) vector, each sequence at its own (continuous-batching slots).
    ``adapter_idx`` (B,): multi-tenant decode — the lora leaves are
    per-layer pools and slot b wears adapter ``adapter_idx[b]``.
    Returns (logits (B, V), caches) — the caches updated in place.  Under
    tensor parallelism, as ``prefill``: the caches are this rank's pieces
    (``init_cache(mesh=)``, or ``prefill``'s), the logits its piece of the
    vocabulary."""
    B = token.shape[0]
    tp = tp_of(rt)
    cur_index = torch.as_tensor(cur_index, dtype=torch.int32, device=token.device)
    positions = cur_index[:, None] if cur_index.dim() else cur_index.expand(B)[:, None]
    x = embed(cfg, params["embed"], token, positions, tp)
    x, caches, _ = stack_mod.apply_stack(cfg, params["layers"], x, lora=lora, rt=rt,
                                         mode="decode", caches=caches,
                                         cur_index=cur_index, adapter_idx=adapter_idx)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x, tp)[:, 0], caches


def paged_decode_step(cfg, params: dict, token: torch.Tensor, caches,
                      block_tables: torch.Tensor, cur_index: torch.Tensor, *,
                      lora=None, rt: Runtime = Runtime(), adapter_idx=None):
    """One decode step over the paged KV pool.  token: (B, 1) int;
    block_tables: (B, MP) int32; cur_index: (B,) int32 absolute positions.
    ``adapter_idx`` (B,): multi-tenant decode — the lora leaves are
    per-layer pools ((A, r, in) and (A, out, r)) and slot b wears adapter
    ``adapter_idx[b]`` (the gather kernel on the card, under the fused
    runtime).  Returns (logits (B, V), caches) — the pools updated in
    place."""
    cur_index = cur_index.to(torch.int32)
    x = embed(cfg, params["embed"], token, cur_index[:, None])
    x, caches, _ = stack_mod.apply_stack(cfg, params["layers"], x, lora=lora, rt=rt,
                                         mode="decode", caches=caches,
                                         cur_index=cur_index, block_tables=block_tables,
                                         adapter_idx=adapter_idx)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x)[:, 0], caches


def paged_prefill_chunk(cfg, params: dict, tokens: torch.Tensor, caches,
                        block_table: torch.Tensor, start: int, logit_index: int,
                        *, lora=None, rt: Runtime = Runtime()):
    """One chunked-prefill step: tokens (1, C) with C == page_size, the
    prompt chunk covering absolute positions [start, start + C);
    block_table (MP,) the slot's page row (the chunk's page allocated);
    logit_index the CHUNK-relative index to read logits at.
    Returns (logits (1, V), caches)."""
    C = tokens.shape[1]
    positions = start + torch.arange(C, dtype=torch.int32, device=tokens.device)
    x = embed(cfg, params["embed"], tokens, positions)
    x, caches, _ = stack_mod.apply_stack(cfg, params["layers"], x, lora=lora, rt=rt,
                                         mode="chunk", caches=caches,
                                         cur_index=start, block_tables=block_table)
    x = x[:, logit_index:logit_index + 1]
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x)[:, 0], caches


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.float32, device="cuda",
               mesh=None):
    """Empty slab caches for ``batch`` sequences of ``cache_len`` positions
    (a Mamba2 layer's state has no length axis); with ``mesh``, this
    rank's pieces of them (``sharding.specs.cache_piece_specs``), for
    ``decode_step`` under tensor parallelism."""
    dev = resolve_device(device)
    if mesh is None:
        return stack_mod.init_stack_cache(cfg, batch, cache_len, dtype, dev)
    from ..sharding.specs import shard_caches
    return [{k: torch.full(v.shape, -1 if k == "pos" else 0, dtype=v.dtype, device=dev)
             for k, v in layer.items()}
            for layer in shard_caches(stack_mod.init_stack_cache(cfg, batch, cache_len,
                                                                 dtype, META), mesh)]


def init_paged_cache(cfg, num_pages: int, page_size: int, dtype=torch.float32,
                     device="cuda"):
    return stack_mod.init_paged_stack_cache(cfg, num_pages, page_size, dtype,
                                            resolve_device(device))


# ---------------------------------------------------------------------------
# parameter counts, from the config alone (no weights are built: the
# full-width configs run to hundreds of GB)
# ---------------------------------------------------------------------------

def _norm_params(cfg) -> int:
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def _mlp_params(cfg) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return 3 * d * ff
    return 2 * d * ff + (ff + d if cfg.norm == "layernorm" else 0)


def _block_params(cfg, pat) -> int:
    d = cfg.d_model
    n = _norm_params(cfg)
    if pat.mixer == "attention":
        h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n += d * h * hd + 2 * d * kh * hd + h * hd * d
        if cfg.norm == "layernorm":
            n += h * hd + 2 * kh * hd + d
    else:
        di, N, nh, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_conv_width
        conv_dim = di + 2 * N
        n += (d * (2 * di + 2 * N + nh) + W * conv_dim + conv_dim + 3 * nh + di
              + di * d)
    if pat.mlp != "none":
        n += _norm_params(cfg)
        if pat.mlp == "moe":
            n += d * cfg.num_experts + cfg.num_experts * 3 * d * cfg.d_ff
            if cfg.shared_expert:
                n += _mlp_params(cfg)
        else:
            n += _mlp_params(cfg)
    return n


def num_params(cfg) -> int:
    """Parameters of ``init_params(cfg)``, counted from the config (the
    twin of ``repro.models.model.num_params``)."""
    n = cfg.vocab_size * cfg.d_model
    if cfg.pos_emb == "learned":
        n += cfg.max_seq_len * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size
    return n + sum(_block_params(cfg, pat) for pat in cfg.layer_kinds) + _norm_params(cfg)


def num_active_params(cfg) -> int:
    """Active parameters per token (MoE: only the routed experts count)."""
    total = num_params(cfg)
    if not cfg.num_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    n_moe_layers = sum(1 for p in cfg.layer_kinds if p.mlp == "moe")
    return total - (cfg.num_experts - cfg.experts_per_token) * per_expert * n_moe_layers


def lora_num_params(cfg, rank: Optional[int] = None) -> int:
    """Parameters of ``init_lora_stack(cfg, rank)``."""
    rank = rank or cfg.lora_rank
    n = 0
    for pat in cfg.layer_kinds:
        for t in cfg.lora_targets:
            dims = _lora_dims(cfg, pat, t)
            if dims is not None:
                n += rank * (dims[1] + dims[2])
    return n
