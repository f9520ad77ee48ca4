"""Round-based training engine — the port of ``repro.launch.engine`` for
static rounds.

Every trainer runs the same outer shape: E global rounds, each the I
local steps (plus, for SFL, FedAvg).  This module owns that loop once:
logging, the loss history, and the modeled per-round wall clock over the
wireless network (``core.latency`` eq. 16-17), accumulated beside the
measured wall clock so a run reports both "what the hardware did" and
"what the paper's network would take" (``allocation_round_latency``
turns an allocator decision into that clock).  Wireless dynamics,
episode checkpoints and checkpoint hooks are not ported yet
(``ROADMAP.md``).

Trainers plug in through adapters exposing
``run_round(state, round_batches) -> (state, metrics)`` where
``metrics["loss"]`` has shape (I,).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.pipeline import stack_rounds


class SflRound:
    """Adapter: core.sfl.SflLLM — I local steps + FedAvg per round."""

    def __init__(self, sfl, sample_counts):
        self.sfl = sfl
        self.sample_counts = list(sample_counts)

    def run_round(self, state, round_batches):
        return self.sfl.train_round(state, round_batches, self.sample_counts)


class CentralizedRound:
    """Adapter: core.sfl.CentralizedLoRA — pooled batches (I, B, S).
    state = (lora, opt_state)."""

    def __init__(self, cen):
        self.cen = cen

    def run_round(self, state, round_batches):
        return self.cen.train_round(state, round_batches)


def modeled_round_seconds(report: Dict[str, Any], local_steps: int) -> float:
    """Per-global-round modeled delay from a core.latency.latency_report:
    I local rounds (eq. 16) + the federated LoRA upload (eq. 15)."""
    return local_steps * report["t_local"] + report["t3"]


def modeled_total_seconds(prob, alloc) -> float:
    """Total modeled training delay of an allocation (eq. 17 with E(r));
    the per-client objective when the allocation carries ``ell_k``/
    ``rank_k``."""
    from ..core.resource import total_delay
    return total_delay(prob, alloc)


def allocation_round_latency(prob, alloc) -> Dict[str, Any]:
    """``latency_report`` for a resource-allocation decision — homogeneous
    or per-client — ready for ``Trainer(round_latency=...)``: the rounds
    then accumulate the wireless wall clock this allocation models."""
    from ..core.latency import latency_report, latency_report_het
    rates_m = alloc.rates_main(prob.sys_cfg, prob.envs)
    rates_f = alloc.rates_fed(prob.sys_cfg, prob.envs)
    e_rounds = prob.e_model(int(alloc.rank))
    if getattr(alloc, "ell_k", None) is not None:
        e_rounds = float(np.mean([prob.e_model(int(r)) for r in alloc.rank_k]))
        return latency_report_het(
            prob.cfg, prob.sys_cfg, prob.envs, rates_m, rates_f,
            alloc.ell_k, alloc.rank_k, prob.seq_len, prob.batch,
            prob.local_steps, e_rounds)
    return latency_report(
        prob.cfg, prob.sys_cfg, prob.envs, rates_m, rates_f,
        int(alloc.ell_c), int(alloc.rank), prob.seq_len, prob.batch,
        prob.local_steps, e_rounds)


@dataclass
class TrainHistory:
    losses: List[float] = field(default_factory=list)
    round_losses: List[float] = field(default_factory=list)   # mean per round
    wall_seconds: float = 0.0
    modeled_seconds: float = 0.0          # wireless-network wall clock
    steps_per_sec: float = 0.0
    round_seconds: List[float] = field(default_factory=list)  # measured, per round
    rolled_back_rounds: List[int] = field(default_factory=list)  # divergence


class Trainer:
    """Round-loop driver all trainers plug into.

    algo            adapter with run_round(state, round_batches)
    local_steps     I — batches stacked per round
    log_every       print every N rounds (0 = silent)
    round_latency   optional core.latency.latency_report dict; accumulates
                    the modeled wireless wall clock per round
    """

    def __init__(self, algo, *, local_steps: int, log_every: int = 0,
                 round_latency: Optional[Dict[str, Any]] = None):
        self.algo = algo
        self.local_steps = local_steps
        self.log_every = log_every
        self.round_latency = round_latency

    def fit(self, state, data_iter: Iterator[Dict], *, global_rounds: int):
        history = TrainHistory()
        per_round = (modeled_round_seconds(self.round_latency, self.local_steps)
                     if self.round_latency else 0.0)
        t0 = time.time()
        for e in range(global_rounds):
            staged = stack_rounds(data_iter, self.local_steps)
            t_round = time.time()
            state, metrics = self.algo.run_round(state, staged)
            # reading the losses waits for the device: the round is over
            losses = np.asarray(torch.as_tensor(metrics["loss"]).cpu(),
                                np.float64).reshape(-1)
            history.round_seconds.append(time.time() - t_round)
            history.losses.extend(float(x) for x in losses)
            history.round_losses.append(float(losses.mean()))
            rb = metrics.get("rolled_back") if isinstance(metrics, dict) else None
            if rb is not None and bool(rb):
                history.rolled_back_rounds.append(e)
            history.modeled_seconds += per_round
            if self.log_every and (e + 1) % self.log_every == 0:
                msg = f"round {e + 1}/{global_rounds}  loss {losses[-1]:.4f}"
                if per_round:
                    msg += f"  modeled {history.modeled_seconds:.1f}s"
                print(msg)
        history.wall_seconds = time.time() - t0
        if history.wall_seconds > 0:
            history.steps_per_sec = len(history.losses) / history.wall_seconds
        return state, history
