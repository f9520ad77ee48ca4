"""Deterministic fault injection — the port of ``repro.faults.inject``,
poking the same host-side names of the port's engines.

Every injector flips host state that the engines read each step or round
— eviction flags, NaN masks, outage probabilities, the poison flag,
corruption operands — so injecting a fault never perturbs a random stream
another component owns.  Disarmed injectors are bit-exact no-ops: a run
with a ``ServingFaults``/``TrainingFaults`` attached but never fired
reproduces the fault-free run token for token.

Kill/resume is not an injector: killing a training episode is simply not
calling ``fit`` further, and resuming is ``Trainer.fit(..., resume=True)``
against the episode checkpoint — the tests drive that API directly.
"""
from __future__ import annotations

from typing import Optional


class ServingFaults:
    """Fault injection for a paged :class:`repro_torch.serving.ServingEngine`."""

    def __init__(self, engine):
        if not getattr(engine, "paged", False):
            raise ValueError("ServingFaults drives the paged engine's "
                             "eviction/sentinel machinery (paged=True)")
        self.engine = engine
        self._held = 0

    # -- page exhaustion ------------------------------------------------
    def exhaust_pages(self, hold: Optional[int] = None) -> int:
        """Steal ``hold`` pages (default: every free page) from the host
        admission mirror, forcing backpressure / preemption on the next
        admission exactly as if the pool were that much smaller.  Returns
        the number of pages held; ``release_pages`` gives them back."""
        free = max(self.engine._free_host, 0)
        hold = free if hold is None else min(int(hold), free)
        self.engine._free_host -= hold
        self._held += hold
        return hold

    def release_pages(self) -> None:
        self.engine._free_host += self._held
        self._held = 0

    # -- slot crash / NaN poke ------------------------------------------
    def crash_slot(self, slot: int) -> None:
        """Kill the request in ``slot`` mid-decode: the next fused step
        evicts it (pages freed) and the engine requeues it for prefix
        recompute — the delivered tokens survive the crash."""
        self.engine._evict_req[int(slot)] = True

    def poke_nan(self, slot: int) -> None:
        """Overwrite ``slot``'s next logits with NaN inside the fused
        step, tripping the non-finite sentinel (quarantine, not garbage)."""
        self.engine._nan_poke[int(slot)] = True

    # -- accounting corruption (check_consistency test) ------------------
    def desync_mirror(self, pages: int = 1) -> None:
        """Corrupt the host free-page mirror by ``pages`` without any
        matching reservation — the drift ``check_consistency`` exists to
        catch and repair.  Unlike ``exhaust_pages`` this is NOT tracked
        and can only be undone by the resync."""
        self.engine._free_host -= int(pages)


class TrainingFaults:
    """Fault injection for a :class:`repro_torch.launch.engine.WirelessDynamics`
    episode.  Attaching the injector arms the poison flag (False) before
    the first round, as ``repro``'s does.

    Byzantine injectors (:meth:`arm_byzantine` + ``sign_flip`` /
    ``scale_blowup`` / ``gaussian_noise`` / ``replay_stale``) corrupt the
    per-client adapter updates between the local steps and the
    aggregation (``core.defense.corrupt_updates``); attackers can be
    switched on and off between rounds.  Benign operands (sign=0, scale=1,
    std=0, replay=0) are a bit-exact no-op per client."""

    def __init__(self, dynamics):
        self.dynamics = dynamics
        if dynamics.poison_next is None:
            dynamics.poison_next = False

    # -- outage bursts ----------------------------------------------------
    def outage_burst(self, p: float = 1.0) -> None:
        """Force every link's per-transmission outage probability to ``p``
        for the following rounds (p=1.0: all HARQ attempts fail — every
        client hard-outages and the round aggregates nobody)."""
        self.dynamics.outage_override = float(p)

    def clear_outage(self) -> None:
        self.dynamics.outage_override = None

    # -- divergence poke --------------------------------------------------
    def poison_round(self) -> None:
        """NaN the NEXT round's aggregated server adapter — the divergence
        sentinel must roll that round back to the last good state bit for
        bit.  One-shot: disarms itself after the round."""
        self.dynamics.poison_next = True

    # -- byzantine corruption of uploaded updates -------------------------
    def arm_byzantine(self, seed: int = 0) -> None:
        """Arm the per-client corruption channel with benign operands
        (before the first round, as in ``repro``); an armed-but-benign
        episode is bit-identical to an unarmed one (no client's upload is
        rebuilt)."""
        import numpy as np
        if self.dynamics.byzantine_ops is None:
            K = len(self.dynamics.prob.envs)
            self.dynamics.byzantine_ops = {
                "sign": np.zeros(K, np.float32),
                "scale": np.ones(K, np.float32),
                "noise_std": np.zeros(K, np.float32),
                "replay": np.zeros(K, np.float32),
                "seed": int(seed),
            }

    def _byz(self) -> dict:
        if self.dynamics.byzantine_ops is None:
            raise RuntimeError("call arm_byzantine() before the first round")
        return self.dynamics.byzantine_ops

    def sign_flip(self, clients) -> None:
        """Flip the sign of these clients' updates every following round
        (gradient-ascent attackers) until cleared."""
        self._byz()["sign"][list(clients)] = 1.0

    def scale_blowup(self, clients, factor: float = 100.0) -> None:
        """Scale these clients' updates by ``factor`` (norm-clip fodder)."""
        self._byz()["scale"][list(clients)] = float(factor)

    def gaussian_noise(self, clients, std: float = 1.0) -> None:
        """Add N(0, std^2) noise to these clients' updates (fresh draws
        per round from the armed seed and the round index — deterministic,
        the same on the CPU and on the card)."""
        self._byz()["noise_std"][list(clients)] = float(std)

    def replay_stale(self, clients) -> None:
        """These clients replay their stale pre-round adapter (zero
        update) instead of their trained one."""
        self._byz()["replay"][list(clients)] = 1.0

    def clear_byzantine(self) -> None:
        """Back to benign operands (stays armed)."""
        ops = self._byz()
        ops["sign"][:] = 0.0
        ops["scale"][:] = 1.0
        ops["noise_std"][:] = 0.0
        ops["replay"][:] = 0.0
