"""Federated-server aggregation (paper eq. 7) and its Byzantine-robust
variants — the port of ``repro.core.aggregation``.

DeltaW_c^t = sum_k (D_k / D) DeltaW_k^t — a weighted average of the
client-side LoRA adapters.  Client trees carry a leading K axis on every
leaf (the stacked form); the average is one weighted sum over that axis
per leaf.  Heterogeneous fleets aggregate slot-wise over each slot's
owners (``fedavg_het``, with the masks of ``core.lora.client_slot_masks``)
and re-truncate on broadcast (``broadcast_het``).

The federated server is the trust boundary: only adapters cross it, and
one corrupted upload enters every client's next adapter through the plain
average.  :func:`robust_aggregate` defends it with per-client norm
clipping, a coordinate-wise trimmed mean or the coordinate median, and
scores every client (pre-clip update norm, cosine distance to its peers'
leave-one-out mean).  :class:`RobustAggConfig` holds plain numbers (the
port runs eagerly: there is no trace to keep), and the disarmed
configuration returns ``fedavg_partial``'s result itself, bit for bit.
Norms and cosines sum over the per-layer leaves in layer order, where
``repro`` sums over its (R, ...) stacks: they agree within f32 rounding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Byzantine-robust aggregation
# ---------------------------------------------------------------------------

@dataclass
class RobustAggConfig:
    """Defense configuration of :func:`robust_aggregate`:

      clip    per-client L2 cap on the round's adapter update; ``inf``
              disarms;
      trim    the coordinate-wise trimmed mean drops the ``trim`` lowest
              and highest surviving entries per coordinate; 0 disarms;
      median  True replaces the (trimmed) mean by the coordinate median.

    With ``clip=inf, trim=0, median=False`` :func:`robust_aggregate`
    returns ``fedavg_partial``'s aggregate bit for bit."""

    clip: float = math.inf
    trim: int = 0
    median: bool = False

    @classmethod
    def off(cls) -> "RobustAggConfig":
        """The disarmed configuration (bit-identical to fedavg_partial)."""
        return cls()

    @classmethod
    def make(cls, clip: float = math.inf, trim: int = 0,
             median: bool = False) -> "RobustAggConfig":
        return cls(clip=float(clip), trim=int(trim), median=bool(median))

    @property
    def armed(self) -> bool:
        return math.isfinite(self.clip) or self.trim > 0 or self.median


def _col(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(K,) ``x`` on ``v``'s device, shaped to broadcast over ``v``'s
    trailing axes."""
    return x.to(v.device).reshape((-1,) + (1,) * (v.dim() - 1))


def update_norms(stacked: Any, ref: Any) -> torch.Tensor:
    """(K,) f32 L2 norm of each client's round update ``stacked_k - ref_k``
    over every leaf: the first anomaly score and what :func:`clip_updates`
    caps."""
    sq = None
    for s, r in zip(tree_leaves(stacked), tree_leaves(ref)):
        d = s.float() - r.float()
        contrib = torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=-1)
        sq = contrib if sq is None else sq + contrib
    return torch.sqrt(sq)


def clip_updates(stacked: Any, ref: Any, clip: float) -> Tuple[Any, torch.Tensor]:
    """Per-client L2 clipping of the round update: ``d_k`` is rescaled by
    ``min(1, clip / ||d_k||)`` and the upload rebuilt as ``ref_k + f_k d_k``.
    ``clip=inf`` returns ``stacked`` itself (no ``ref + d`` re-rounding).
    Returns ``(clipped, norms)``, the norms taken before clipping."""
    norms = update_norms(stacked, ref)
    if not math.isfinite(clip):
        return stacked, norms
    factor = torch.clamp(clip / norms.clamp_min(1e-12), max=1.0)

    def _apply(s, r):
        d = s.float() - r.float()
        return (r.float() + _col(s, factor) * d).to(s.dtype)

    return tree_map(_apply, stacked, ref), norms


def _live_weights(weights, participation) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32).cpu()
    if participation is not None:
        w = w * torch.as_tensor(participation, dtype=torch.float32).cpu()
    return w


def _masked_weights(v: torch.Tensor, m: Optional[torch.Tensor],
                    w: torch.Tensor) -> torch.Tensor:
    """Per-entry weight mass w_k * mask, broadcast to ``v``'s shape."""
    wk = _col(v, w)
    if m is not None:
        wk = wk * m.to(v.device, torch.float32)
    return torch.broadcast_to(wk, v.shape)


def _per_leaf(fn, stacked: Any, masks: Any) -> Any:
    if masks is None:
        return tree_map(lambda v: fn(v, None), stacked)
    return tree_map(fn, stacked, masks)


def trimmed_mean(stacked: Any, weights, participation, masks: Any, trim: int) -> Any:
    """Coordinate-wise trimmed weighted mean over the surviving owners.

    Per coordinate, the ``trim`` lowest and highest *valid* entries
    (positive weight mass: participating clients that own the slot) are
    dropped and the rest averaged with ``fedavg_het``'s formula.  ``trim``
    is clamped per coordinate to ``(nv - 1) // 2`` so one entry always
    survives; at ``trim=0`` the weight mass is multiplied by exactly 1.0,
    so the result is ``fedavg_het``'s bit for bit.  The sort is stable:
    tied values are trimmed by client order, as ``jnp.argsort`` does."""
    w = _live_weights(weights, participation)

    def _leaf(v, m):
        wm = _masked_weights(v, m, w)
        valid = wm > 0
        vf = v.float()
        key = torch.where(valid, vf, torch.full_like(vf, math.inf))   # invalid last
        order = torch.argsort(key, dim=0, stable=True)
        inv = torch.argsort(order, dim=0)
        nv = valid.sum(dim=0, keepdim=True)
        t = torch.clamp((nv - 1) // 2, min=0).clamp(max=int(trim))
        idx = torch.arange(v.shape[0], device=v.device).reshape((-1,) + (1,) * (v.dim() - 1))
        sel = torch.gather((idx >= t) & (idx < nv - t), 0, inv)
        wm = wm * sel.float()
        num = torch.sum(wm * vf, dim=0)
        den = torch.sum(wm, dim=0)
        avg = torch.where(den > 0, num / den.clamp_min(1e-12), torch.zeros_like(num))
        return avg.to(v.dtype)

    return _per_leaf(_leaf, stacked, masks)


def coordinate_median(stacked: Any, weights, participation, masks: Any) -> Any:
    """Coordinate-wise median over the surviving owners (the weights only
    decide who is valid; the median itself is unweighted).  Coordinates no
    one owns come back exactly zero, as in ``fedavg_het``."""
    w = _live_weights(weights, participation)

    def _leaf(v, m):
        valid = _masked_weights(v, m, w) > 0
        vf = v.float()
        sv = torch.sort(torch.where(valid, vf, torch.full_like(vf, math.inf)), dim=0).values
        nv = valid.sum(dim=0, keepdim=True)
        lo = torch.clamp((nv - 1) // 2, min=0)
        hi = torch.clamp(nv // 2, min=0, max=v.shape[0] - 1)
        med = 0.5 * (torch.gather(sv, 0, lo) + torch.gather(sv, 0, hi))
        out = torch.where(nv > 0, med, torch.zeros_like(med))[0]
        return out.to(v.dtype)

    return _per_leaf(_leaf, stacked, masks)


def anomaly_scores(stacked: Any, ref: Any, weights, participation, masks: Any,
                   norms: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-client anomaly scores of a finished round:

      update_norm  the ``norms`` given: by convention the PRE-clip update
                   norms, so a blow-up stays visible after clipping;
      cos_dist     1 - <d_k, a_k> / (||d_k|| ||a_k||), between the
                   client's update in ``stacked`` (the clipped uploads, in
                   :func:`robust_aggregate`) and its peers' leave-one-out
                   weighted mean ``a_k = (sum_j wm_j d_j - wm_k d_k) /
                   (W - wm_k)``, with ``stacked``'s own norms in the
                   denominator.

    A client with a zero update or no scorable peers scores exactly 0.
    Scores are outputs only: they never feed back into the state."""
    K = norms.shape[0]
    w = _live_weights(weights, participation)
    leaves = tree_leaves(stacked)
    mask_leaves = tree_leaves(masks) if masks is not None else [None] * len(leaves)
    dots = asq = dsq = None
    for s, r, m in zip(leaves, tree_leaves(ref), mask_leaves):
        d = s.float() - r.float()
        wm = _masked_weights(d, m, w)
        peer_num = torch.sum(wm * d, dim=0) - wm * d          # leave-one-out
        peer_den = torch.sum(wm, dim=0) - wm
        a = torch.where(peer_den > 0, peer_num / peer_den.clamp_min(1e-12),
                        torch.zeros_like(peer_num))
        d2, a2 = d.reshape(K, -1), a.reshape(K, -1)
        dot = torch.sum(d2 * a2, dim=-1)
        sq = torch.sum(a2 * a2, dim=-1)
        dd = torch.sum(d2 * d2, dim=-1)
        dots = dot if dots is None else dots + dot
        asq = sq if asq is None else asq + sq
        dsq = dd if dsq is None else dsq + dd
    denom = (torch.sqrt(dsq) * torch.sqrt(asq)).clamp_min(1e-12)
    cos_dist = torch.where((dsq > 0) & (asq > 0), 1.0 - dots / denom, torch.zeros_like(dots))
    return {"update_norm": norms, "cos_dist": cos_dist}


def robust_aggregate(stacked: Any, ref: Any, weights, participation, masks: Any,
                     cfg: RobustAggConfig) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Byzantine-robust eq. 7: norm clip, then the trimmed mean or the
    median, composing with partial participation and slot masks.  Returns
    ``(aggregate, anomaly_scores)``.  Disarmed (``cfg.armed`` False), the
    aggregate IS ``fedavg_partial(stacked, weights, participation,
    masks)``.  ``ref`` is the round's starting (post-broadcast) stacked
    adapters the updates are measured against.  The scores run on the
    clipped uploads (with ``clip=inf``, ``stacked`` itself), so an
    amplified attacker cannot dominate its peers' leave-one-out means; the
    reported norms stay pre-clip."""
    clipped, norms = clip_updates(stacked, ref, cfg.clip)
    if not cfg.armed:
        agg = fedavg_partial(stacked, weights, participation, masks)
    elif cfg.median:
        agg = coordinate_median(clipped, weights, participation, masks)
    else:
        agg = trimmed_mean(clipped, weights, participation, masks, cfg.trim)
    return agg, anomaly_scores(clipped, ref, weights, participation, masks, norms)
