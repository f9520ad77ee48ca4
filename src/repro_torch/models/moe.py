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

Over a tensor-parallel axis (``sharding.tp``) the experts lie over the
ranks, with or without an all-to-all exchange of the capacity buffers
(``apply_moe(constraints=)``); ``models.moe_shard_map`` is the
shard-map form of that exchange, with its own drops.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..sharding.collectives import (all_gather, all_reduce, all_to_all_grad, copy_to,
                                   gather_whole, group_size, reduce_from, split_along)
from ..sharding.tp import WHOLE, Entry, TensorParallel, is_cut
from .layers import _normal, init_dense, init_mlp, mlp_parts


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


def route(cfg, p: dict, xg: torch.Tensor):
    """Routing of grouped tokens xg (G, sg, d), in f32: (probs (G, sg, E),
    gates (G, sg, K) renormalised over the K choices, ids (G, sg, K))."""
    # jax.lax.top_k and torch.topk may order equal probabilities
    # differently; random f32 router weights give no ties, and both take
    # the K largest in descending order, so a tie is the only way the two
    # packages could route differently
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1, sorted=True)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids


def slot_positions(ids: torch.Tensor, E: int, offset=None) -> torch.Tensor:
    """0-based capacity slot of each (token, choice) of ids (G, sg, K) over
    the group's flattened (token, choice) axis: earlier tokens and higher
    choices first.  ``offset`` (G, E): slots already taken in each group
    and expert by tokens before these (a group cut over ranks)."""
    G = ids.shape[0]
    onehot = F.one_hot(ids.reshape(G, -1), E)                   # (G, sg*K, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    if offset is not None:
        pos = pos + offset[:, None, :]
    return (pos * onehot).sum(-1)                               # (G, sg*K)


def combine_tensor(gates, ids, pos_f, cap: int, E: int) -> torch.Tensor:
    """The combine tensor (G, sg, E, cap) f32, choice by choice; a choice at
    a slot past ``cap`` is dropped (its one-hot row times its zero keep,
    as JAX's out-of-range one-hot is 0)."""
    G, sg, K = ids.shape
    keep = pos_f < cap
    pos_k = torch.where(keep, pos_f, 0).reshape(G, sg, K)
    keep_k = keep.reshape(G, sg, K)
    combine = torch.zeros((G, sg, E, cap), dtype=torch.float32, device=ids.device)
    for j in range(K):
        oh = (F.one_hot(ids[:, :, j], E).float()[..., None]
              * F.one_hot(pos_k[:, :, j], cap).float()[..., None, :])
        combine = combine + oh * (gates[:, :, j] * keep_k[:, :, j])[..., None, None]
    return combine


def expert_ffn(xd: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The experts' SwiGLU on dispatched tokens xd (..., E, C, d) with the
    expert weights (E, d, ff), (E, ff, d): plain einsums, as in ``repro``."""
    h_g = torch.einsum("...ecd,edf->...ecf", xd, w_gate.to(xd.dtype))
    h_u = torch.einsum("...ecd,edf->...ecf", xd, w_up.to(xd.dtype))
    h = F.silu(h_g.float()).to(xd.dtype) * h_u
    return torch.einsum("...ecf,efd->...ecd", h, w_down.to(xd.dtype))


def load_balance_aux(probs, ids, E: int, pool=None, tokens=None) -> torch.Tensor:
    """The Switch aux E * sum(density * density_proxy) of this rank's
    tokens' probs (G, sg, E) and ids.  ``tokens``: a group whose ranks
    hold equal shares of the tokens of these rows (a sequence cut over
    them): the means are then taken over the group, the density's sum by
    an all-reduce that passes its gradient through, so every rank of it
    holds the same aux.  ``pool``: as in ``apply_moe``."""
    density = probs.mean(dim=(0, 1))                            # (E,)
    density_proxy = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
    if tokens is not None:
        n = group_size(tokens)
        density = reduce_from(density, tokens) / n
        density_proxy = all_reduce(density_proxy, tokens) / n
    if pool is not None:
        n = group_size(pool)
        density_proxy = all_reduce(density_proxy, pool) / n
        density = density / n
    return (E * torch.sum(density * density_proxy)).float()


def apply_moe(cfg, p: dict, x: torch.Tensor, *, group_size: int = 128,
              capacity_factor: float = 1.25, pool=None, tp: TensorParallel = WHOLE,
              seq: bool = False, constraints: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), the Switch load-balance aux loss, an
    f32 scalar E * sum(density * density_proxy)).

    ``pool``: the process group whose ranks hold equal shares of one
    pooled batch, of which ``x`` is this rank's.  The aux is then this
    rank's share of the pool's: the (gradient-free) proxy is all-reduced
    to the pool's mean, the density is this rank's mean over the group
    size, so the ranks' shares sum to the pool's aux and each share's
    gradient is its rows' part of the pool's.  The capacity groups lie
    along each sequence, so a split of rows leaves the routing as it is.

    Over a tensor-parallel axis ``tp`` (``sharding.tp``; training,
    prefill and decode alike) x is whole rows, or with ``seq`` this rank's
    piece of the sequence (the output likewise), and where the experts are
    cut over the axis a rank runs its E/tp of them.  Without
    ``constraints`` every rank routes every token and runs its experts on
    its slice of the dispatch; the partial combine is summed.  With
    ``constraints`` (``Runtime.moe_constraints``) a rank routes its piece
    of the sequence and its capacity buffers go to the experts' ranks by
    all-to-all (``_experts_exchange``).  Either way the Switch aux is the one over
    all the tokens."""
    E = cfg.num_experts
    ent = Entry(x, tp, seq)
    S = x.shape[1] * (tp.n if seq else 1)
    sg = _pick_group_size(S, group_size)
    cut = is_cut(p["w_gate"], 0, E)
    s_loc = S // tp.n
    exchange = (cut and constraints and S % tp.n == 0
                and (s_loc % sg == 0 or sg % s_loc == 0))
    if exchange:
        y, aux = _experts_exchange(cfg, p, ent, capacity_factor, pool, sg)
    else:
        y, aux = _experts_everywhere(cfg, p, ent.rep(), capacity_factor, pool, sg,
                                     tp if cut else WHOLE)
    part, whole, bias = (mlp_parts(cfg, ent, p["shared"], kind="swiglu")
                         if cfg.shared_expert else (None, None, None))
    if exchange and seq:                 # y is this rank's piece of the sequence
        out = ent.exit(part, whole, bias)
        return (y if out is None else out + y), aux
    if exchange:
        return ent.exit(part, _sum(gather_whole(y, tp.group, 1), whole), bias), aux
    if cut:                              # y is a partial sum over the experts' ranks
        return ent.exit(_sum(y, part), whole, bias), aux
    return ent.exit(part, _sum(y, whole), bias), aux


def _sum(a, b):
    return b if a is None else (a if b is None else a + b)


def _experts_everywhere(cfg, p: dict, x, capacity_factor: float, pool, sg: int,
                        tp: TensorParallel):
    """Every rank routes every token of x (B, S, d) and runs the experts it
    holds (all of them over ``WHOLE``, else its E/tp) on its slice of the
    dispatch -> (y (B, S, d), a partial sum where the experts are cut,
    aux)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G = B * (S // sg)
    xg = x.reshape(G, sg, d)
    probs, gates, ids = route(cfg, p, xg)
    cap = capacity(sg, K, E, capacity_factor)
    # the gates and tokens meet only this rank's experts: their gradients
    # are partial
    combine = combine_tensor(copy_to(gates, tp.group), ids, slot_positions(ids, E), cap, E)
    if tp.n > 1:
        e_loc = E // tp.n
        combine = combine[:, :, tp.rank * e_loc:(tp.rank + 1) * e_loc]
    xd = torch.einsum("gsd,gsec->gecd", copy_to(xg, tp.group),
                      (combine > 0).to(x.dtype))                # (G, E, C, d)
    yd = expert_ffn(xd, p["w_gate"], p["w_up"], p["w_down"])
    y = torch.einsum("gecd,gsec->gsd", yd, combine.to(x.dtype))
    return y.reshape(B, S, d), load_balance_aux(probs, ids, E, pool)


def _experts_exchange(cfg, p: dict, ent: Entry, capacity_factor: float, pool, sg: int):
    """This rank routes its piece of the sequence (``repro``'s groups and
    per-group capacity kept exactly: a group cut over ranks takes the
    earlier ranks' slot counts as its offset), its capacity buffers go to
    the experts' ranks by one all-to-all and come back by another -> (y
    (B, S/tp, d), aux over all the tokens)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    tp = ent.tp
    n, g = tp.n, tp.group
    x = ent.h if ent.seq else split_along(ent.h, g, 1)        # (B, S/n, d)
    B, s_loc, d = x.shape
    sg_l = min(sg, s_loc)
    G = B * s_loc // sg_l
    xg = x.reshape(G, sg_l, d)
    probs, gates, ids = route(cfg, p, xg)
    offset = None
    m = sg // sg_l                    # ranks a group is cut over
    if m > 1:
        counts = F.one_hot(ids.reshape(G, -1), E).sum(1)          # (G, E)
        every = all_gather(counts[None], g, 0)                   # (n, G, E)
        first = (tp.rank // m) * m
        offset = every[first:tp.rank].sum(0)
    cap = capacity(sg, K, E, capacity_factor)
    combine = combine_tensor(gates, ids, slot_positions(ids, E, offset), cap, E)
    e_loc = E // n
    xd = torch.einsum("gsd,gsec->gecd", xg, (combine > 0).to(x.dtype))   # (G, E, C, d)
    send = xd.reshape(G, n, e_loc, cap, d).transpose(0, 1).reshape(-1, d)
    recv = all_to_all_grad(send, g).reshape(n, G, e_loc, cap, d)
    yd = expert_ffn(recv, p["w_gate"], p["w_up"], p["w_down"])
    back = all_to_all_grad(yd.reshape(-1, d), g).reshape(n, G, e_loc, cap, d)
    yd = back.transpose(0, 1).reshape(G, E, cap, d)
    y = torch.einsum("gecd,gsec->gsd", yd, combine.to(x.dtype))
    aux = load_balance_aux(probs, ids, E, pool, tokens=g)
    return y.reshape(B, s_loc, d), aux
