"""Deterministic fault injection for the port's serving engine (page
exhaustion, slot crashes, NaN pokes, a desynced page mirror) and its
wireless training loop (outage bursts, divergence poison, Byzantine
uploads: sign flip, scale blow-up, Gaussian noise, stale replay).  The
recovery lives with the engines (``serving.engine``: preemption, prefix
recompute, the NaN quarantine, the reservation audit; ``core.sfl``,
``core.defense``, ``launch.engine``: HARQ, rollback, robust aggregation
and the reputation quarantine, kill/resume); this package only drives it.
The port of ``repro.faults``."""
from .inject import ServingFaults, TrainingFaults

__all__ = ["ServingFaults", "TrainingFaults"]
