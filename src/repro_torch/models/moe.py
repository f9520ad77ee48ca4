"""Mixture-of-Experts FFN — GShard-style capacity-based dispatch, the port
of ``repro.models.moe`` (``init_moe``, ``_pick_group_size``,
``apply_moe``).

Tokens are cut into groups of ``group_size`` (the largest divisor of the
sequence length not over it) so that the (G, S_g, E, C) dispatch and
combine tensors stay bounded.  Routing, softmax and top-k run in f32;
gates are renormalised over the K choices with a 1e-9 floor.  Capacity
positions come from a cumulative sum over the flattened (token, choice)
axis of a group, so earlier tokens and higher choices win a slot; a
choice past ``cap = ceil(S_g K / E * capacity_factor)`` (padded to a
multiple of 4 above 4) is dropped.  The combine tensor is built choice by
choice, the dispatch is ``combine > 0`` (it carries no gradient), and the
expert products are plain einsums, as in ``repro`` (no Pallas kernel
there either).  Gradients flow through the gates and the router's
density, never through the expert ids, the one-hots or the dispatch.

Expert parallelism with explicit all-to-alls over a mesh's "model" axis
is ``models.moe_shard_map``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import _normal, init_dense, init_mlp, swiglu_mlp


def init_moe(cfg, gen: torch.Generator, dtype, device) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": init_dense(gen, d, e, dtype, device, scale=0.02),
         "w_gate": _normal(gen, (e, d, ff), d ** -0.5, dtype, device),
         "w_up": _normal(gen, (e, d, ff), d ** -0.5, dtype, device),
         "w_down": _normal(gen, (e, ff, d), ff ** -0.5, dtype, device)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(cfg, gen, dtype, device)
    return p


def _pick_group_size(seq: int, target: int) -> int:
    """Largest divisor of ``seq`` that is <= target."""
    g = min(seq, target)
    while seq % g:
        g -= 1
    return g


def capacity(sg: int, K: int, E: int, capacity_factor: float) -> int:
    """Expert slots per group: ceil(sg K / E * capacity_factor), at least 1,
    padded to a multiple of 4 above 4."""
    cap = max(1, int(math.ceil(sg * K / E * capacity_factor)))
    return -(-cap // 4) * 4 if cap > 4 else cap


def apply_moe(cfg, p: dict, x: torch.Tensor, *, group_size: int = 128,
              capacity_factor: float = 1.25, pool=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), the Switch load-balance aux loss, an
    f32 scalar E * sum(density * density_proxy)).

    ``pool``: the process group whose ranks hold equal shares of one
    pooled batch, of which ``x`` is this rank's.  The aux is then this
    rank's share of the pool's: the (gradient-free) proxy is all-reduced
    to the pool's mean, the density is this rank's mean over the group
    size, so the ranks' shares sum to the pool's aux and each share's
    gradient is its rows' part of the pool's.  The capacity groups lie
    along each sequence, so a split of rows leaves the routing as it is."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    sg = _pick_group_size(S, group_size)
    G = B * (S // sg)
    xg = x.reshape(G, sg, d)

    # routing (f32).  jax.lax.top_k and torch.topk may order equal
    # probabilities differently; random f32 router weights give no ties,
    # and both take the K largest in descending order, so a tie is the only
    # way the two packages could route differently
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                       # (G, sg, E)
    gates, ids = torch.topk(probs, K, dim=-1, sorted=True)      # (G, sg, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # capacity positions over the flattened (token, choice) axis
    ids_f = ids.reshape(G, sg * K)
    onehot = F.one_hot(ids_f, E)                                # (G, sg*K, E)
    pos_f = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)   # (G, sg*K)
    cap = capacity(sg, K, E, capacity_factor)
    keep = pos_f < cap

    # combine (G, sg, E, C), choice by choice; a dropped choice's one-hot
    # row is multiplied by its zero keep, as JAX's out-of-range one-hot is 0
    ids_k = ids_f.reshape(G, sg, K)
    pos_k = torch.where(keep, pos_f, 0).reshape(G, sg, K)
    keep_k = keep.reshape(G, sg, K)
    combine = torch.zeros((G, sg, E, cap), dtype=torch.float32, device=x.device)
    for j in range(K):
        oh = (F.one_hot(ids_k[:, :, j], E).float()[..., None]
              * F.one_hot(pos_k[:, :, j], cap).float()[..., None, :])
        combine = combine + oh * (gates[:, :, j] * keep_k[:, :, j])[..., None, None]
    dispatch = (combine > 0).to(x.dtype)

    # experts
    xd = torch.einsum("gsd,gsec->gecd", xg, dispatch)          # (G, E, C, d)
    h_g = torch.einsum("gecd,edf->gecf", xd, p["w_gate"].to(x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", xd, p["w_up"].to(x.dtype))
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    yd = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))
    y = torch.einsum("gecd,gsec->gsd", yd, combine.to(x.dtype))

    # Switch-style load-balance aux loss
    density = probs.mean(dim=(0, 1))                            # (E,)
    density_proxy = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
    if pool is not None:
        from ..sharding.collectives import all_reduce, group_size
        n = group_size(pool)
        density_proxy = all_reduce(density_proxy, pool) / n
        density = density / n
    aux = E * torch.sum(density * density_proxy)

    out = y.reshape(B, S, d)
    if cfg.shared_expert:
        out = out + swiglu_mlp(cfg, x, p["shared"])
    return out, aux.float()
