"""Step functions and abstract input specs — the port of
``repro.launch.steps``.

``input_specs(cfg, shape)`` returns ``meta`` tensors (shapes and dtypes,
no memory) for every input of the step of ``shape.kind``, with
``repro``'s shapes and dtypes (bf16 params and activations, int32 tokens):
the params, adapters and caches in the port's per-layer layout, the
batches as ``repro`` builds them.  Decode shapes describe
``decode_step`` (ONE token against a ``seq_len`` cache), never
``train_step``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import model as model_mod
from ..models.stack import Runtime
from ..optim import Optimizer, adamw, apply_updates
from ..sharding.collectives import all_reduce, all_reduce_tree
from ..tree import tree_leaves, tree_map, tree_unflatten

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16

# Sliding window applied to *pure full-attention* archs for the long_500k
# decode variant.
LONG_CONTEXT_WINDOW = 8192


def long_context_variant(cfg: ArchConfig) -> ArchConfig:
    """Sub-quadratic variant for long_500k: unchanged for SSM/hybrid
    (O(1)/windowed state already); sliding-window for full-attention archs."""
    if cfg.pure_full_attention:
        return cfg.replace(attn_window=LONG_CONTEXT_WINDOW,
                           max_seq_len=max(cfg.max_seq_len, 1 << 20))
    if cfg.family == "hybrid" and cfg.attn_window == 0:
        # Jamba's attention layers keep a window at long context
        return cfg.replace(attn_window=LONG_CONTEXT_WINDOW,
                           max_seq_len=max(cfg.max_seq_len, 1 << 20))
    return cfg.replace(max_seq_len=max(cfg.max_seq_len, 1 << 20))


def arch_for_shape(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    if shape.name == "long_500k":
        return long_context_variant(cfg)
    return cfg


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _value_and_grad(fn, tree, pool=None):
    """(value, aux, grads of ``fn`` w.r.t. every leaf of ``tree``).  Under
    ``pool`` (``Runtime.pool``: ``fn`` takes this rank's share of a pooled
    batch's loss) the aux and the grads are summed over the pool, so every
    rank returns the pool's."""
    with torch.enable_grad():
        leaves_tree = tree_map(lambda v: v.detach().requires_grad_(), tree)
        total, aux = fn(leaves_tree)
        leaves = tree_leaves(leaves_tree)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(tree, [g if g is not None else torch.zeros_like(v)
                                  for g, v in zip(grads, leaves)])
    aux = {k: v.detach() for k, v in aux.items()}
    if pool is not None:
        grads = all_reduce_tree(grads, pool)
        aux = dict(zip(aux, all_reduce(torch.stack(list(aux.values())), pool)))
    return total.detach(), aux, grads


def make_train_step(cfg: ArchConfig, rt: Runtime, optimizer: Optimizer):
    """LoRA fine-tune step — the datacenter lowering of one SflLLM local
    round's compute: grads flow ONLY to the adapters, the base stays
    frozen.  ``train_step(params, lora, opt_state, batch) -> (lora,
    opt_state, metrics)``.  Under ``rt.pool`` the batch is this rank's
    rows of a pooled one; the gradients and metrics are the pool's, so
    every rank takes the same step.  Under a tensor-parallel ``rt``
    (``tp_axis`` naming an axis of ``rt.mesh`` above one rank) ``params``
    are this rank's "model" pieces (``sharding.tp``) and the LoRA
    gradients come out whole on every rank of the axis."""

    def train_step(params, lora, opt_state, batch):
        _, metrics, grads = _value_and_grad(
            lambda lo: model_mod.loss_fn(cfg, params, lo, batch, rt=rt), lora, rt.pool)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, lora)
            lora = apply_updates(lora, updates)
        return lora, opt_state, metrics

    return train_step


def make_full_finetune_step(cfg: ArchConfig, rt: Runtime, optimizer: Optimizer):
    """Full fine-tuning baseline (what the paper's LoRA choice avoids)."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = _value_and_grad(
            lambda p: model_mod.loss_fn(cfg, p, None, batch, rt=rt), params, rt.pool)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, rt: Runtime):
    """``prefill_step(params, lora, batch) -> (logits, caches)``.  Over
    ``rt.mesh`` (``tp_axis`` naming its "model" axis) ``params`` are this
    rank's pieces (or a ``sharding.fsdp.ShardedParams`` view of them, cut
    over "data" too), ``batch`` this rank's rows, and the logits and
    caches this rank's pieces (``models.model.prefill``)."""
    def prefill_step(params, lora, batch):
        fe = batch.get("frontend_emb")
        return model_mod.prefill(
            cfg, params, batch["tokens"], lora=lora, rt=rt, frontend_emb=fe,
            cache_len=batch["tokens"].shape[1] + (0 if fe is None else fe.shape[1]))

    return prefill_step


def make_decode_step(cfg: ArchConfig, rt: Runtime):
    """``decode_step(params, lora, token, caches, cur_index) -> (logits,
    caches)``; over ``rt.mesh`` as ``make_prefill_step``'s, the caches
    this rank's pieces (``input_specs(mesh=)``)."""
    def decode_step(params, lora, token, caches, cur_index):
        return model_mod.decode_step(cfg, params, token, caches, cur_index, lora=lora, rt=rt)

    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_tokens if cfg.frontend else 0
    out = {"tokens": _meta((B, S - F), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((B, S - F), torch.int32)
    if F:
        out["frontend_emb"] = _meta((B, F, cfg.d_model), ACT_DTYPE)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                optimizer: Optional[Optimizer] = None,
                lora_rank: Optional[int] = None,
                param_dtype=PARAM_DTYPE, mesh=None) -> Tuple[tuple, dict]:
    """-> (args, {}) abstract argument tuple for the step of shape.kind.
    With ``mesh``: this rank's pieces, by the ``sharding.specs`` rules —
    the params cut over "data" and "model" (``param_spec``), the adapters
    and their optimizer state whole (replicated), the batch rows over the
    data axes (``batch_spec``), the caches by ``cache_spec``."""
    from ..sharding.specs import batch_spec, map_with_path, param_spec, shard
    cfg = arch_for_shape(cfg, shape)
    params = model_mod.abstract_params(cfg, param_dtype)
    lora = model_mod.abstract_lora(cfg, lora_rank, param_dtype)
    if mesh is not None:
        params = map_with_path(
            lambda p, v: shard(v, param_spec(p, tuple(v.shape), mesh), mesh), params)

    def rows(tree):
        return tree if mesh is None else tree_map(
            lambda v: shard(v, batch_spec(tuple(v.shape), mesh), mesh), tree)

    if shape.kind == "train":
        opt = optimizer or adamw(1e-4)
        opt_state = tree_map(lambda v: v.to("meta"), opt.init(lora))
        return (params, lora, opt_state, rows(batch_specs(cfg, shape))), {}
    if shape.kind == "prefill":
        return (params, lora, rows(batch_specs(cfg, shape))), {}
    # decode: ONE token + seq_len cache
    B = shape.global_batch
    caches = model_mod.abstract_cache(cfg, B, shape.seq_len, ACT_DTYPE, mesh=mesh)
    token = rows(_meta((B, 1), torch.int32))
    cur = _meta((), torch.int32)
    return (params, lora, token, caches, cur), {}
