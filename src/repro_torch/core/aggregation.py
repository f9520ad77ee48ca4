"""Federated-server aggregation (paper eq. 7) — the averaging half of
``repro.core.aggregation``.

DeltaW_c^t = sum_k (D_k / D) DeltaW_k^t — a weighted average of the
client-side LoRA adapters.  Client trees carry a leading K axis on every
leaf (the stacked form); the average is one weighted sum over that axis
per leaf.  Heterogeneous fleets aggregate slot-wise over each slot's
owners (``fedavg_het``, with the masks of ``core.lora.client_slot_masks``)
and re-truncate on broadcast (``broadcast_het``).  The robust
(Byzantine-tolerant) aggregators are not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from ..tree import tree_leaves, tree_map


def _norm_weights(weights, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    return w / w.sum().clamp_min(1e-12)


def fedavg(client_trees: Sequence[Any], weights: Sequence[float]) -> Any:
    """Weighted average of K trees; weights are normalized to sum to 1."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / w.sum().clamp_min(1e-12)

    def _avg(*leaves):
        acc = sum(wi.to(l.device) * l.float() for wi, l in zip(w, leaves))
        return acc.to(leaves[0].dtype)

    return tree_map(_avg, client_trees[0], *client_trees[1:])


def fedavg_stacked(stacked: Any, weights) -> Any:
    """Eq. 7 over a stacked client axis: every leaf (K, ...) -> (...)."""
    def _avg(v):
        w = _norm_weights(weights, v.device)
        return torch.tensordot(w, v.float(), dims=([0], [0])).to(v.dtype)

    return tree_map(_avg, stacked)


def fedavg_het(stacked: Any, weights, masks: Any) -> Any:
    """Rank-aware FedAvg over zero-padded heterogeneous client adapters.

    ``masks`` (``core.lora.client_slot_masks``) give each client's 0/1
    occupancy of each (layer, rank slot), broadcastable against the
    K-stacked leaves.  Each slot is the weighted sum of its live entries
    over the weight mass of its owners, so a rank-2 client never dilutes
    slots only rank-8 clients train; slots no client owns come back
    exactly zero.  With ``masks=None`` this IS ``fedavg_stacked``."""
    if masks is None:
        return fedavg_stacked(stacked, weights)
    w = torch.as_tensor(weights, dtype=torch.float32)

    def _avg(v, m):
        wk = w.to(v.device).reshape((-1,) + (1,) * (v.dim() - 1))
        wm = wk * m.to(v.device, torch.float32)          # (K, ..slot..)
        num = torch.sum(wm * v.float(), dim=0)
        den = torch.sum(wm, dim=0)
        avg = torch.where(den > 0, num / den.clamp_min(1e-12), torch.zeros_like(num))
        return avg.to(v.dtype)

    return tree_map(_avg, stacked, masks)


def fedavg_partial(stacked: Any, weights, participation, masks: Any = None) -> Any:
    """Eq. 7 under partial participation: dropped clients (participation
    0) carry no weight, so the result is the survivors' FedAvg; composes
    with the slot masks of heterogeneous fleets.  With
    ``participation=None`` this is ``fedavg_het`` (and so
    ``fedavg_stacked`` when ``masks`` is None too)."""
    if participation is None:
        return fedavg_het(stacked, weights, masks)
    w = (torch.as_tensor(weights, dtype=torch.float32)
         * torch.as_tensor(participation, dtype=torch.float32).cpu())
    return fedavg_het(stacked, w, masks)


def tree_all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool tensor: every element of every floating leaf is finite
    (integer leaves such as step counters are skipped) — the divergence
    sentinel the round gates its state commit on."""
    flags = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
             if torch.is_tensor(leaf) and leaf.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def broadcast_stacked(global_tree: Any, num_clients: int) -> Any:
    """Federated server -> clients, stacked form: the global adapter
    copied along a new leading K axis."""
    return tree_map(
        lambda v: v.unsqueeze(0).expand((num_clients,) + tuple(v.shape)).clone(),
        global_tree)


def broadcast_het(global_tree: Any, num_clients: int, masks: Any) -> Any:
    """Broadcast + per-client truncation: every client receives the global
    adapter with its dead slots (rank >= r_k, layers past its split)
    re-zeroed.  With ``masks=None`` this is ``broadcast_stacked``."""
    stacked = broadcast_stacked(global_tree, num_clients)
    if masks is None:
        return stacked
    return tree_map(lambda v, m: v * m.to(v.device, v.dtype), stacked, masks)


def broadcast(global_tree: Any, num_clients: int) -> list:
    """Federated server -> clients: every client gets the global adapter."""
    return [tree_map(lambda x: x.clone(), global_tree) for _ in range(num_clients)]
