"""Trust-boundary defense of the federated aggregation step — the port of
``repro.core.defense``.

* **Attack model** (:class:`ByzantineOps`, :func:`corrupt_updates`):
  per-client corruption of the uploaded adapter updates between the local
  steps and the aggregation — sign flip, scale blow-up, additive Gaussian
  noise and stale-update replay.  A client whose operands are benign
  (sign 0, scale 1, std 0, replay 0) keeps its upload tensor untouched,
  bit for bit.  ``repro_torch.faults.TrainingFaults`` sets the operands.
* **Reputation and quarantine** (:class:`DefenseConfig`,
  :class:`ReputationTracker`): a host-side EWMA over each round's anomaly
  scores (``core.aggregation.anomaly_scores``); a client flagged again and
  again is quarantined for Q rounds by zeroing its participation, which
  multiplies with the deadline and outage masks.  The tracker is pure
  numpy, equal to ``repro``'s bit for bit, and its state rides the
  episode cursor.

The noise cannot follow ``repro``'s draws (``jax.random`` keys): each
leaf's noise comes from a CPU ``torch.Generator`` seeded from (seed,
round, leaf index), so a run draws the same noise on the CPU and on the
card, afresh each round (ROADMAP.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..tree import tree_leaves, tree_unflatten

_MASK64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """SplitMix64's finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _noise_generator(seed: int, round_idx: int, leaf: int) -> torch.Generator:
    """The CPU generator of one leaf's noise in one round."""
    z = _mix(int(seed) & _MASK64)
    z = _mix(z ^ (int(round_idx) & _MASK64))
    z = _mix(z ^ (int(leaf) & _MASK64))
    return torch.Generator().manual_seed(z & ((1 << 63) - 1))


# ---------------------------------------------------------------------------
# attack model: per-client corruption of the uploaded updates
# ---------------------------------------------------------------------------

@dataclass
class ByzantineOps:
    """Per-client corruption operands of one round, (K,) f32 each:

      sign       1 flips the sign of the client's update;
      scale      multiplies the update (1.0 = benign);
      noise_std  std of additive Gaussian noise (0.0 = benign);
      replay     1 replaces the upload by the client's pre-round adapter
                 (a zero update);

    and ``seed``/``round_idx``, which seed the noise draws (``repro``
    holds a key with the round folded in)."""

    sign: np.ndarray
    scale: np.ndarray
    noise_std: np.ndarray
    replay: np.ndarray
    seed: int = 0
    round_idx: int = 0

    def __post_init__(self):
        for f in ("sign", "scale", "noise_std", "replay"):
            v = getattr(self, f)
            if torch.is_tensor(v):
                v = v.detach().cpu().numpy()
            setattr(self, f, np.asarray(v, np.float32).reshape(-1))

    @classmethod
    def benign(cls, num_clients: int, seed: int = 0, round_idx: int = 0) -> "ByzantineOps":
        K = num_clients
        return cls(sign=np.zeros(K, np.float32), scale=np.ones(K, np.float32),
                   noise_std=np.zeros(K, np.float32), replay=np.zeros(K, np.float32),
                   seed=seed, round_idx=round_idx)

    def armed(self) -> np.ndarray:
        """(K,) bool: the clients whose upload is rebuilt."""
        return ((self.sign > 0) | (self.scale != 1.0) | (self.noise_std > 0)
                | (self.replay > 0))


def corrupt_updates(stacked: Any, ref: Any, ops: ByzantineOps) -> Any:
    """Apply the corruption operands to the round's uploads.  ``stacked``
    and ``ref`` are the post-step and pre-round K-stacked client adapters;
    an armed client's upload is rebuilt as ``ref_k + corrupt(d_k)`` with
    ``d_k = stacked_k - ref_k`` (sign, then scale, then noise, then
    replay, as ``repro`` does).  With no client armed ``stacked`` itself is
    returned; a benign client's rows are never rebuilt."""
    armed = ops.armed()
    if not armed.any():
        return stacked
    noisy = bool((ops.noise_std > 0).any())
    out = []
    for i, (s, r) in enumerate(zip(tree_leaves(stacked), tree_leaves(ref))):
        col = lambda x, s=s: torch.from_numpy(x).to(s.device).reshape(   # noqa: E731
            (-1,) + (1,) * (s.dim() - 1))
        d = s.float() - r.float()
        d = torch.where(col(ops.sign) > 0, -d, d)
        d = d * col(ops.scale)
        if noisy:
            noise = torch.randn(tuple(d.shape), generator=_noise_generator(
                ops.seed, ops.round_idx, i)).to(d.device)
            d = torch.where(col(ops.noise_std) > 0, d + col(ops.noise_std) * noise, d)
        d = torch.where(col(ops.replay) > 0, torch.zeros_like(d), d)
        corrupted = (r.float() + d).to(s.dtype)
        out.append(torch.where(col(armed.astype(np.float32)) > 0, corrupted, s))
    return tree_unflatten(stacked, out)


def byzantine_ops_arrays(host_ops: Dict[str, Any], round_idx: int) -> ByzantineOps:
    """Host dict (``sign``/``scale``/``noise_std``/``replay`` (K,) arrays
    and ``seed``) -> :class:`ByzantineOps` for round ``round_idx``."""
    return ByzantineOps(sign=np.array(host_ops["sign"], np.float32),
                        scale=np.array(host_ops["scale"], np.float32),
                        noise_std=np.array(host_ops["noise_std"], np.float32),
                        replay=np.array(host_ops["replay"], np.float32),
                        seed=int(host_ops["seed"]), round_idx=int(round_idx))


# ---------------------------------------------------------------------------
# defense: host-side EWMA reputation and quarantine (repro's logic, unchanged)
# ---------------------------------------------------------------------------

@dataclass
class DefenseConfig:
    """Robust aggregation and quarantine policy of an episode.

    Aggregator: ``clip`` (per-client L2 cap, inf = off), ``trim``
    (trimmed-mean count, 0 = off), ``median``.  Reputation: a client is
    flagged when its update norm exceeds ``norm_mult`` x the round's
    median norm, or its cosine distance to its peers exceeds
    ``cos_threshold``; reputation r <- ewma r + (1 - ewma) flag (only
    participants update); reputation above ``rep_threshold`` quarantines
    for ``quarantine_rounds`` rounds, and release resets it to 0."""

    clip: float = float("inf")
    trim: int = 0
    median: bool = False
    norm_mult: float = 4.0
    cos_threshold: float = 1.5
    ewma: float = 0.5
    rep_threshold: float = 0.6
    quarantine_rounds: int = 4

    def robust_config(self):
        from .aggregation import RobustAggConfig
        return RobustAggConfig.make(clip=self.clip, trim=self.trim, median=self.median)


class ReputationTracker:
    """Deterministic host-side EWMA reputation and quarantine ledger.

    Per round :meth:`mask` gives the (K,) 0/1 multiplier of the round's
    participation, and :meth:`observe` takes the round's scores after it.
    Pure numpy: :meth:`state`/:meth:`load_state` round-trip it through the
    JSON episode cursor exactly."""

    def __init__(self, num_clients: int, cfg: DefenseConfig):
        self.cfg = cfg
        self.reputation = np.zeros(num_clients, np.float64)
        self.remaining = np.zeros(num_clients, np.int64)   # quarantine ticks
        self.total_quarantines = 0

    def mask(self) -> np.ndarray:
        """(K,) 0/1 participation multiplier: 0 while quarantined."""
        return (self.remaining == 0).astype(np.float64)

    def observe(self, update_norm: Sequence[float], cos_dist: Sequence[float],
                participation: Sequence[float]) -> np.ndarray:
        """Update the reputations from one round's scores; returns the (K,)
        flags raised.  Non-participants are skipped (their zero update
        must not launder their reputation); a non-finite score flags."""
        cfg = self.cfg
        norm = np.asarray(update_norm, np.float64)
        cosd = np.asarray(cos_dist, np.float64)
        active = np.asarray(participation, np.float64) > 0
        flags = np.zeros(norm.shape[0], bool)
        if active.any():
            med = float(np.median(norm[active]))
            bad_norm = norm > max(cfg.norm_mult * med, 1e-12)
            bad_cos = cosd > cfg.cos_threshold
            bad_nan = ~np.isfinite(norm) | ~np.isfinite(cosd)
            flags = active & (bad_norm | bad_cos | bad_nan)
        self.reputation[active] = (cfg.ewma * self.reputation[active]
                                   + (1.0 - cfg.ewma) * flags[active])
        # tick the quarantines; a release resets the reputation
        ticking = self.remaining > 0
        self.remaining[ticking] -= 1
        released = ticking & (self.remaining == 0)
        self.reputation[released] = 0.0
        newq = (self.remaining == 0) & ~released & (self.reputation > cfg.rep_threshold)
        self.remaining[newq] = cfg.quarantine_rounds
        self.total_quarantines += int(newq.sum())
        return flags

    def state(self) -> Dict[str, Any]:
        """JSON-able snapshot (floats survive JSON through repr)."""
        return {"reputation": self.reputation.tolist(),
                "remaining": self.remaining.tolist(),
                "total_quarantines": int(self.total_quarantines)}

    def load_state(self, s: Dict[str, Any]) -> None:
        self.reputation = np.asarray(s["reputation"], np.float64)
        self.remaining = np.asarray(s["remaining"], np.int64)
        self.total_quarantines = int(s["total_quarantines"])


__all__ = ["ByzantineOps", "DefenseConfig", "ReputationTracker", "byzantine_ops_arrays",
           "corrupt_updates"]
