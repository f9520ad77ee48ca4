"""Round-based training engine — the port of ``repro.launch.engine``.

Every trainer runs the same outer shape: E global rounds, each the I
local steps (plus, for SFL, FedAvg).  This module owns that loop once:
logging, the loss history, checkpoint hooks (``checkpoint.save_pytree``
every N rounds), episode checkpoints with kill/resume
(``checkpoint.save_episode``), and the modeled per-round wall clock over
the wireless network (``core.latency`` eq. 16-17), accumulated beside the
measured wall clock so a run reports both "what the hardware did" and
"what the paper's network would take" (``allocation_round_latency``
turns an allocator decision into that clock).  ``WirelessDynamics``
makes the episode time-varying: block fading, deadline dropout, outages
with HARQ, drift-triggered re-allocation, and the trust boundary's
defense (robust aggregation with a reputation quarantine) and fault hooks
(poison, Byzantine uploads), each round's numbers entering
``SflLLM.train_round`` as a ``core.sfl.RoundDynamics``.

``PodRound`` is the datacenter lowering: one LoRA step over a ``("data",
"model")`` or ``("pod", "data", "model")`` mesh of ranks, the frozen base
FSDP-sharded over "data" (``sharding.fsdp``) and tensor-parallel over
"model" (``sharding.tp``); over a client mesh ``SflRound`` gathers the
state for its checkpoints, and rank 0 alone prints and writes files.

Trainers plug in through adapters exposing
``run_round(state, round_batches) -> (state, metrics)`` where
``metrics["loss"]`` has shape (I,), ``checkpoint_payload(state)`` (the
adapters to save, ``repro``-shaped numpy trees) and, for episode files,
``episode_tree(state)`` / ``from_episode_tree(tree)`` (the whole
state in ``repro``'s layout, so episode files cross between packages).
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.latency import client_round_seconds_host
from ..data.pipeline import stack_rounds
from ..interop import (lora_from_numpy, lora_to_numpy, sfl_state_from_numpy,
                       sfl_state_to_numpy, to_numpy, to_tensor)
from .mesh import global_rank


class SflRound:
    """Adapter: core.sfl.SflLLM — I local steps + FedAvg per round."""

    def __init__(self, sfl, sample_counts):
        self.sfl = sfl
        self.sample_counts = list(sample_counts)

    def run_round(self, state, round_batches, dynamics=None):
        return self.sfl.train_round(state, round_batches, self.sample_counts,
                                    dynamics=dynamics)

    def checkpoint_payload(self, state) -> dict:
        P = len(self.sfl.cfg.pattern)
        tree = sfl_state_to_numpy(self.sfl.gather_state(state), P)
        return {"lora_server": tree["lora_server"], "lora_client": tree["lora_client"]}

    def episode_tree(self, state):
        """The whole state (all K clients, gathered over a client axis) as
        ``repro``'s ``SflState`` layout: the port's dataclass (same fields,
        same order) holding stacked numpy trees."""
        from ..core.sfl import SflState
        return SflState(**sfl_state_to_numpy(self.sfl.gather_state(state),
                                             len(self.sfl.cfg.pattern)))

    def from_episode_tree(self, tree):
        return self.sfl.shard_state(sfl_state_from_numpy(
            {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)},
            self.sfl.device))


class CentralizedRound:
    """Adapter: core.sfl.CentralizedLoRA — pooled batches (I, B, S).
    state = (lora, opt_state)."""

    def __init__(self, cen):
        self.cen = cen

    def run_round(self, state, round_batches):
        return self.cen.train_round(state, round_batches)

    def checkpoint_payload(self, state) -> dict:
        return {"lora": lora_to_numpy(state[0], len(self.cen.cfg.pattern))}

    def episode_tree(self, state):
        P = len(self.cen.cfg.pattern)
        lora, opt = state
        return (lora_to_numpy(lora, P),
                {k: to_numpy(v) if k == "step" else lora_to_numpy(v, P) for k, v in opt.items()})

    def from_episode_tree(self, tree):
        dev = self.cen.device
        lora, opt = tree
        return (lora_from_numpy(lora, dev),
                {k: to_tensor(v, "cpu") if k == "step" else lora_from_numpy(v, dev)
                 for k, v in opt.items()})


class PodRound:
    """Adapter: the datacenter lowering (``repro``'s ``PodRound``) — one
    LoRA train step (``launch.steps.make_train_step``'s) over any mesh of
    ``repro``'s, ``("data", "model")`` of any shape or ``("pod", "data",
    "model")``, I times a round.  state = (lora, opt_state).

    The frozen base is cut by the rule table (``sharding.fsdp.
    ShardedParams``): FSDP over ``"data"``, tensor parallelism over
    ``"model"`` (``sharding.tp``, through ``Runtime.tp_axis``); the LoRA
    and its optimizer state are replicated; the pooled batch (I, B, S) is
    cut over the batch axes (``sharding.specs.stacked_batch_spec``:
    "pod" and "data") and replicated over "model"; the loss divides by
    the pool's valid-label count and the LoRA gradients are all-reduced
    over the batch axes (``Runtime.pool``), so every rank steps the same
    adapter.  Over more than one "data" rank each layer is recomputed in
    the backward (``Runtime.remat`` under the runtime's policy),
    gathering it again.  ``rt`` None takes ``default_train_runtime()``;
    its ``seq_shard`` and ``moe_constraints`` are kept.  ``params`` is a
    ``ShardedParams`` or the whole tree, on the host or on any device
    (every rank the same); only this rank's pieces go to the device."""

    def __init__(self, cfg, params, rt, optimizer, mesh):
        from ..models.stack import default_train_runtime
        from ..sharding.fsdp import ShardedParams
        from ..sharding.specs import batch_axes
        from .steps import make_train_step

        rt = default_train_runtime() if rt is None else rt
        self.cfg = cfg
        self.optimizer = optimizer
        self.mesh = mesh
        self.device = mesh.device
        self.params = params if isinstance(params, ShardedParams) else ShardedParams(params, mesh)
        if mesh.device_mesh is not None:
            dp = batch_axes(mesh)
            rt = rt.replace(pool=mesh.group_over(dp), dp_axes=dp, mesh=mesh,
                            tp_axis="model" if mesh.shape.get("model", 1) > 1 else None,
                            remat=rt.remat or self.params.n > 1)
        self.rt = rt
        self._step = make_train_step(cfg, self.rt, optimizer)

    def init_state(self, lora):
        """Fresh copies on the device: the caller's template stays intact."""
        from ..interop import tree_to
        from ..tree import tree_map
        lora = tree_map(lambda v: v.detach().clone(), tree_to(lora, self.device))
        return lora, self.optimizer.init(lora)

    def step(self, lora, opt_state, batch):
        """One train step on this rank's rows of the pooled batch."""
        return self._step(self.params.view(), lora, opt_state, batch)

    def run_round(self, state, round_batches):
        """round_batches: tokens/labels (I, B, S) of the whole pool, as every
        rank passes them; this rank cuts its rows."""
        from ..sharding.specs import shard, stacked_batch_spec
        lora, opt_state = state
        batches = {k: shard(torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v,
                            stacked_batch_spec(tuple(np.shape(v)), self.mesh), self.mesh)
                   .to(self.device) for k, v in round_batches.items() if v is not None}
        ms = []
        for i in range(batches["tokens"].shape[0]):
            lora, opt_state, m = self.step(lora, opt_state, {k: v[i] for k, v in batches.items()})
            ms.append(m)
        return (lora, opt_state), {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def checkpoint_payload(self, state) -> dict:
        return {"lora": lora_to_numpy(state[0], len(self.cfg.pattern))}

    def episode_tree(self, state):
        P = len(self.cfg.pattern)
        lora, opt = state
        return (lora_to_numpy(lora, P),
                {k: to_numpy(v) if k == "step" else lora_to_numpy(v, P) for k, v in opt.items()})

    def from_episode_tree(self, tree):
        lora, opt = tree
        return (lora_from_numpy(lora, self.device),
                {k: to_tensor(v, "cpu") if k == "step" else lora_from_numpy(v, self.device)
                 for k, v in opt.items()})


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


# ---------------------------------------------------------------------------
# dynamic wireless rounds: fading -> deadline dropout -> drift re-allocation
# ---------------------------------------------------------------------------

class WirelessDynamics:
    """Round-by-round wireless evolution of a training episode: the host
    side of ``repro.launch.engine.WirelessDynamics``, whose numbers enter
    each round as a ``core.sfl.RoundDynamics``.

    * block fading: ``core.channel.FadingProcess`` (AR(1) in dB around the
      sampled average gains; ``fade_rho=0`` = i.i.d. per-round draws);
    * per-round rates: the current allocation's subchannels and powers
      under the faded gains;
    * straggler dropout: a round deadline on the client-attributable delay
      T_k = I(T_k^F + T_k^s + T_k^B) + T_k^f (``client_round_seconds_host``);
      the round's mask is computed here once and reaches the trainer as
      its explicit ``participation``, so the history holds the applied
      mask;
    * drift-triggered re-allocation: when the current allocation's modeled
      delay under this round's channel exceeds (1 + drift_threshold) x its
      delay at (re)allocation time, ``bcd_minimize_delay_per_client``
      re-runs warm-started from it, and the clients take their new
      (ell_k, r_k, bits_k) through ``SflLLM.allocation_dynamics``;
    * outages and HARQ: with ``outage_snr_db`` set, each uplink's
      per-transmission outage probability follows Rayleigh fading around
      the round's block SNR; the expected transmission count inflates the
      delay's upload terms, and a client whose ``max_harq`` attempts all
      fail is in hard outage for the round (participation 0, drawn from
      ``outage_rng``, a generator of its own so the fading stream does not
      move).  ``outage_override`` (host-side; None, a scalar or (K,))
      replaces the channel's outage probability for as long as it is set.

    Knobs: ``fade_std_db``, ``fade_rho``, ``deadline_s`` (absolute) or
    ``deadline_factor`` (factor x the slowest client's T_k at the last
    (re)allocation, re-based on re-allocation), ``drift_threshold`` (None
    = static allocation), ``max_sweeps``, ``rng`` (fading),
    ``outage_snr_db``, ``max_harq``, ``outage_rng``.

    Byzantine robustness (``defense``, a ``core.defense.DefenseConfig``):
    every round runs ``robust_aggregate`` and returns per-client anomaly
    scores; a ``ReputationTracker`` EWMAs them (``observe_scores``, called
    by ``Trainer.fit``) and quarantines a client flagged again and again
    for Q rounds by zeroing its participation, multiplied with the
    deadline and outage masks.  Disarmed knobs (clip inf, trim 0, no
    median) give the defense-free rounds bit for bit.

    Fault hooks (``faults.TrainingFaults`` drives them): ``poison_next``
    (None, or a bool: True NaNs the next round's aggregated server adapter
    and disarms itself after that round) and ``byzantine_ops`` (None, or
    a host dict of per-client corruption operands plus a seed, which
    becomes the round's ``core.defense.ByzantineOps`` with the round
    index).  The cursor has ``repro``'s keys, the tracker's state under
    ``"defense"``, so cursors cross between the packages.
    """

    def __init__(self, prob, alloc, sfl, *, fade_std_db: float = 4.0,
                 fade_rho: float = 0.0, deadline_s: Optional[float] = None,
                 deadline_factor: Optional[float] = None,
                 drift_threshold: Optional[float] = None,
                 max_sweeps: int = 2, rng=0,
                 outage_snr_db: Optional[float] = None, max_harq: int = 4,
                 outage_rng=0, defense=None):
        from ..core.channel import FadingProcess
        from ..core.latency import workload_tables
        from ..core.resource import as_hetero, total_delay

        self.prob = prob
        self.alloc = as_hetero(prob, alloc)
        self.sfl = sfl
        self.fading = FadingProcess(prob.envs, std_db=fade_std_db, rho=fade_rho, rng=rng)
        self.deadline_factor = deadline_factor
        self.drift_threshold = drift_threshold
        self.max_sweeps = max_sweeps
        self._total_delay = total_delay
        self.outage_snr_db = outage_snr_db
        if max_harq < 1:
            raise ValueError(f"max_harq must be >= 1, got {max_harq}")
        self.max_harq = int(max_harq)
        self.outage_rng = (np.random.default_rng(outage_rng)
                           if isinstance(outage_rng, int) else outage_rng)
        self.outage_override = None     # faults: per-round p override
        self.poison_next: Optional[bool] = None   # faults: NaN poke
        self.byzantine_ops = None       # faults: corruption operands
        self._round_idx = 0             # the corruption noise's round index
        self.defense = defense
        self.tracker = None
        if defense is not None:
            from ..core.defense import ReputationTracker
            self.tracker = ReputationTracker(len(prob.envs), defense)
        if drift_threshold is not None:
            # fail fast: a re-allocation may pick any (ell, rank) of prob's
            # search space, so the trainer's envelope must hold all of it
            from ..core.split import layers_to_reps, valid_splits
            splits = valid_splits(prob.cfg)
            reps = [layers_to_reps(prob.cfg, e) for e in (min(splits), max(splits))]
            if (min(reps) < sfl.rep_min or max(reps) > sfl.rep_max
                    or max(prob.rank_candidates) > sfl.r_max):
                raise ValueError(
                    "re-allocation can leave the trainer's capacity envelope; build it "
                    "with SflLLM.from_allocation(..., dynamic=True) or a wide enough "
                    "ell_range/rank_max")
        self._tables = workload_tables(prob.cfg, prob.seq_len)
        self.ref_delay = total_delay(prob, self.alloc)
        # only a re-allocating episode sends the per-client configuration
        # each round; a static one runs on the trainer's own
        self._cfg_arrays = self._allocation_arrays()
        self.deadline_s = deadline_s
        if deadline_factor is not None:
            if deadline_s is not None:
                raise ValueError("pass deadline_s OR deadline_factor")
            self._rebase_deadline(prob.envs)

    def _allocation_arrays(self) -> dict:
        if self.drift_threshold is None:
            return {}
        return self.sfl.allocation_dynamics(self.alloc.ell_k, self.alloc.rank_k,
                                            bits_k=getattr(self.alloc, "bits_k", None))

    # -- deadline re-basing: factor x slowest client at allocation time ----
    def _client_seconds(self, envs, retx_main=None, retx_fed=None) -> np.ndarray:
        rates_m = self.alloc.rates_main(self.prob.sys_cfg, envs)
        rates_f = self.alloc.rates_fed(self.prob.sys_cfg, envs)
        t = client_round_seconds_host(
            self._tables, self.alloc.ell_k, self.alloc.rank_k,
            np.array([e.f_hz for e in envs]), np.array([e.kappa for e in envs]),
            rates_m, rates_f, self.prob.batch, self.prob.local_steps,
            retx_main=retx_main, retx_fed=retx_fed,
            act_bits=getattr(self.alloc, "bits_k", None))
        return np.asarray(t)

    def _rebase_deadline(self, envs) -> None:
        self.deadline_s = float(self.deadline_factor * self._client_seconds(envs).max())

    # ------------------------------------------------------------------
    def round_dynamics(self):
        """Advance one round; returns (RoundDynamics, info dict)."""
        from ..core.resource import bcd_minimize_delay_per_client
        from ..core.sfl import RoundDynamics

        envs_r = self.fading.step()
        # with_envs keeps the channel-independent workload caches warm
        prob_r = self.prob.with_envs(envs_r)
        delay = self._total_delay(prob_r, self.alloc)
        info = {"modeled_delay": float(delay), "realloc": False}
        if (self.drift_threshold is not None
                and delay > (1.0 + self.drift_threshold) * self.ref_delay):
            self.alloc, _ = bcd_minimize_delay_per_client(
                prob_r, warm_start=self.alloc, max_sweeps=self.max_sweeps)
            self.ref_delay = self._total_delay(prob_r, self.alloc)
            self._cfg_arrays = self._allocation_arrays()
            if self.deadline_factor is not None:
                self._rebase_deadline(envs_r)
            info["realloc"] = True
            info["modeled_delay"] = float(self.ref_delay)

        sys_cfg = self.prob.sys_cfg
        rates_m = self.alloc.rates_main(sys_cfg, envs_r)
        rates_f = self.alloc.rates_fed(sys_cfg, envs_r)

        # -- outage + HARQ: per-link E[m] and hard-outage survival ---------
        retx_m = retx_f = survival = None
        if self.outage_snr_db is not None or self.outage_override is not None:
            from ..core.channel import (expected_transmissions, outage_probability,
                                        residual_outage)
            K = len(envs_r)
            if self.outage_override is not None:
                p_m = np.broadcast_to(np.asarray(self.outage_override, float), (K,))
                p_f = p_m
            else:
                snr_th = 10.0 ** (self.outage_snr_db / 10.0)
                noise = sys_cfg.noise_psd_w_hz
                bw_m = np.maximum(self.alloc.bw_main(sys_cfg), 1e-30)
                bw_f = np.maximum(self.alloc.bw_fed(sys_cfg), 1e-30)
                snr_m = (self.alloc.power_main / bw_m / noise
                         * np.array([e.gain_main for e in envs_r]))
                snr_f = (self.alloc.power_fed / bw_f / noise
                         * np.array([e.gain_fed for e in envs_r]))
                p_m = outage_probability(snr_m, snr_th)
                p_f = outage_probability(snr_f, snr_th)
            retx_m = expected_transmissions(p_m, self.max_harq).astype(np.float32)
            retx_f = expected_transmissions(p_f, self.max_harq).astype(np.float32)
            u = self.outage_rng.uniform(size=(K, 2))
            hard = ((u[:, 0] < residual_outage(p_m, self.max_harq))
                    | (u[:, 1] < residual_outage(p_f, self.max_harq)))
            survival = (~hard).astype(np.float32)
            info["hard_outages"] = hard.astype(int).tolist()

        # the reputation tracker's quarantine mask multiplies with the other
        # dropout sources
        qmask = None
        if self.tracker is not None:
            qmask = self.tracker.mask().astype(np.float32)
            info["quarantined"] = (1 - qmask).astype(int).tolist()

        # the round's mask, computed once here and handed to the trainer as
        # its explicit participation, so the history records the mask the
        # round applied (the f32 compare of SflLLM's deadline mask)
        gated = self.deadline_s is not None or survival is not None or qmask is not None
        part = np.ones(len(envs_r), np.float32)
        if self.deadline_s is not None:
            t_k = self._client_seconds(envs_r, retx_m, retx_f)
            part = (t_k <= np.float32(self.deadline_s)).astype(np.float32)
        if survival is not None:
            part = part * survival      # straggler AND outage
        if qmask is not None:
            part = part * qmask         # AND not quarantined
        info["participation"] = part.astype(int).tolist()
        info["round_seconds"] = self._round_seconds(envs_r, rates_m, rates_f, part)

        # the poison hook fires once per arm, then disarms itself
        poison = None
        if self.poison_next is not None:
            poison = torch.tensor(1.0 if self.poison_next else 0.0)
            self.poison_next = False
        byz = None
        if self.byzantine_ops is not None:
            from ..core.defense import byzantine_ops_arrays
            byz = byzantine_ops_arrays(self.byzantine_ops, self._round_idx)
        self._round_idx += 1

        f32 = lambda v: None if v is None else torch.as_tensor(  # noqa: E731
            np.asarray(v, np.float32))
        dyn = RoundDynamics(
            rates_main=f32(rates_m), rates_fed=f32(rates_f),
            f_hz=f32([e.f_hz for e in envs_r]), kappa=f32([e.kappa for e in envs_r]),
            retx_main=f32(retx_m), retx_fed=f32(retx_f),
            participation=f32(part) if gated else None,
            poison=poison, byzantine=byz,
            robust=None if self.defense is None else self.defense.robust_config(),
            **self._cfg_arrays)
        return dyn, info

    def observe_scores(self, scores: Dict[str, Any], participation) -> None:
        """Feed one round's anomaly scores to the reputation tracker (a
        no-op without a defense).  ``participation`` is the round's applied
        (K,) mask: non-participants never update their reputation."""
        if self.tracker is None:
            return
        self.tracker.observe(scores["update_norm"], scores["cos_dist"], participation)

    def _round_seconds(self, envs, rates_m, rates_f, part) -> float:
        """Modeled wall clock of this round: the survivors' eq. 16-17 terms
        (the server proceeds at the deadline without the stragglers); an
        empty round costs the waited-out deadline."""
        from ..core.latency import het_local_round_latency, t_lora_upload

        surv = [k for k in range(len(envs)) if part[k] > 0]
        if not surv:
            return float(self.deadline_s or 0.0)
        sws = [self.prob.sw(int(self.alloc.ell_k[k]), int(self.alloc.rank_k[k]))
               for k in surv]
        t_local = het_local_round_latency(
            sws, [envs[k] for k in surv], [rates_m[k] for k in surv],
            self.prob.sys_cfg, self.prob.batch)
        t3 = max(t_lora_upload(sw, rates_f[k]) for sw, k in zip(sws, surv))
        return float(self.prob.local_steps * t_local + t3)

    # -- episode checkpoint cursor (Trainer.fit kill/resume) ---------------
    def cursor(self) -> dict:
        """JSON-able snapshot of the episode's host state: the RNG cursors,
        the current (possibly re-allocated) allocation, the drift reference
        delay, the (possibly re-based) deadline, the round index and the
        reputation tracker's ledger — ``repro``'s keys.  Restoring it makes
        the resumed rounds bit-identical to an uninterrupted run; the fault
        hooks (``outage_override``, ``poison_next``, ``byzantine_ops``) are
        transient and not kept."""
        a = self.alloc
        return {
            "fading": self.fading.get_state(),
            "outage_rng": self.outage_rng.bit_generator.state,
            "ref_delay": float(self.ref_delay),
            "deadline_s": None if self.deadline_s is None else float(self.deadline_s),
            "round_idx": int(self._round_idx),
            "defense": None if self.tracker is None else self.tracker.state(),
            "alloc": {
                "assign_main": np.asarray(a.assign_main).tolist(),
                "assign_fed": np.asarray(a.assign_fed).tolist(),
                "power_main": np.asarray(a.power_main).tolist(),
                "power_fed": np.asarray(a.power_fed).tolist(),
                "ell_c": int(a.ell_c),
                "rank": int(a.rank),
                "ell_k": np.asarray(a.ell_k).tolist(),
                "rank_k": np.asarray(a.rank_k).tolist(),
                "act_bits": int(getattr(a, "act_bits", 16)),
                "bits_k": (None if getattr(a, "bits_k", None) is None
                           else np.asarray(a.bits_k).tolist()),
            },
        }

    def restore_cursor(self, c: dict) -> None:
        from ..core.resource import HeteroAllocation
        self.fading.set_state(c["fading"])
        self.outage_rng.bit_generator.state = c["outage_rng"]
        self.ref_delay = float(c["ref_delay"])
        self.deadline_s = None if c["deadline_s"] is None else float(c["deadline_s"])
        self._round_idx = int(c.get("round_idx", 0))
        if self.tracker is not None and c.get("defense") is not None:
            self.tracker.load_state(c["defense"])
        a = c["alloc"]
        self.alloc = HeteroAllocation(
            assign_main=np.asarray(a["assign_main"], int),
            assign_fed=np.asarray(a["assign_fed"], int),
            power_main=np.asarray(a["power_main"], float),
            power_fed=np.asarray(a["power_fed"], float),
            ell_c=int(a["ell_c"]), rank=int(a["rank"]),
            act_bits=int(a.get("act_bits", 16)),
            ell_k=np.asarray(a["ell_k"], int),
            rank_k=np.asarray(a["rank_k"], int),
            bits_k=None if a.get("bits_k") is None else np.asarray(a["bits_k"], int))
        self._cfg_arrays = self._allocation_arrays()


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------

@dataclass
class TrainHistory:
    losses: List[float] = field(default_factory=list)
    round_losses: List[float] = field(default_factory=list)   # mean per round
    wall_seconds: float = 0.0
    modeled_seconds: float = 0.0          # wireless-network wall clock
    steps_per_sec: float = 0.0
    participation: List[List[int]] = field(default_factory=list)  # per round
    realloc_rounds: List[int] = field(default_factory=list)
    modeled_delays: List[float] = field(default_factory=list)  # total T per round
    rolled_back_rounds: List[int] = field(default_factory=list)  # divergence
    # robust aggregation: per-round {"update_norm", "cos_dist"} host lists
    # and the quarantine mask
    anomaly_scores: List[Dict[str, List[float]]] = field(default_factory=list)
    quarantined: List[List[int]] = field(default_factory=list)
    round_seconds: List[float] = field(default_factory=list)  # measured, per round


class Trainer:
    """Round-loop driver all trainers plug into.

    algo            adapter with run_round(state, round_batches)
    local_steps     I — batches stacked per round
    log_every       print every N rounds (0 = silent)
    round_latency   optional core.latency.latency_report dict; accumulates
                    the modeled wireless wall clock per round
    dynamics        optional WirelessDynamics (SflRound only): per-round
                    fading, deadline dropout, outages and re-allocation;
                    the modeled wall clock then follows each round's
                    channel instead of a static report
    checkpoint_path/checkpoint_every
                    save algo.checkpoint_payload(state) every N rounds
                    (every 0: once, at the end)
    episode_path/episode_every
                    episode checkpoint every N rounds: the whole state,
                    the round cursor, the history and the dynamics cursor
                    in one atomic file; ``fit(..., resume=True)`` continues
                    a killed episode bit-identically (the same data_iter
                    seed is required: the consumed rounds are drawn again
                    and discarded)
    callback        callback(round_idx, state, history) after each round
    """

    def __init__(self, algo, *, local_steps: int, log_every: int = 0,
                 round_latency: Optional[Dict[str, Any]] = None,
                 dynamics: Optional[WirelessDynamics] = None,
                 checkpoint_path: str = "", checkpoint_every: int = 0,
                 episode_path: str = "", episode_every: int = 0,
                 callback: Optional[Callable] = None):
        self.algo = algo
        self.local_steps = local_steps
        self.log_every = log_every
        self.round_latency = round_latency
        self.dynamics = dynamics
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.episode_path = episode_path
        self.episode_every = episode_every
        self.callback = callback

    def fit(self, state, data_iter: Iterator[Dict], *, global_rounds: int,
            resume: bool = False):
        history = TrainHistory()
        start_round = 0
        if resume and self.episode_path and os.path.exists(self.episode_path):
            from ..checkpoint import restore_episode
            tree, meta = restore_episode(self.episode_path, self.algo.episode_tree(state))
            state = self.algo.from_episode_tree(tree)
            start_round = int(meta["round"])
            h = meta.get("history", {})
            for f in dataclasses.fields(TrainHistory):
                if f.name in h:
                    setattr(history, f.name, h[f.name])
            if self.dynamics is not None and meta.get("dynamics") is not None:
                self.dynamics.restore_cursor(meta["dynamics"])
        per_round = (modeled_round_seconds(self.round_latency, self.local_steps)
                     if self.round_latency else 0.0)
        prev_wall = history.wall_seconds
        t0 = time.time()
        # replay the consumed data stream so round start_round sees exactly
        # the batches it would have in the uninterrupted run
        for _ in range(start_round):
            stack_rounds(data_iter, self.local_steps)
        for e in range(start_round, global_rounds):
            staged = stack_rounds(data_iter, self.local_steps)
            t_round = time.time()
            if self.dynamics is not None:
                dyn, info = self.dynamics.round_dynamics()
                state, metrics = self.algo.run_round(state, staged, dynamics=dyn)
            else:
                info = None
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
            scores = metrics.get("anomaly_scores") if isinstance(metrics, dict) else None
            if scores is not None:
                s_host = {k: np.asarray(torch.as_tensor(v).cpu(), np.float64).tolist()
                          for k, v in scores.items()}
                history.anomaly_scores.append(s_host)
                if info is not None:
                    # this round's scores shape the next round's quarantine
                    self.dynamics.observe_scores(s_host, info["participation"])
            if info is not None and "quarantined" in info:
                history.quarantined.append(info["quarantined"])
            if info is not None:
                history.modeled_seconds += info["round_seconds"]
                history.participation.append(info["participation"])
                history.modeled_delays.append(info["modeled_delay"])
                if info["realloc"]:
                    history.realloc_rounds.append(e)
            else:
                history.modeled_seconds += per_round
            if self.log_every and (e + 1) % self.log_every == 0:
                msg = f"round {e + 1}/{global_rounds}  loss {losses[-1]:.4f}"
                aux = metrics.get("aux") if isinstance(metrics, dict) else None
                if aux is not None and bool((aux != 0).any()):
                    # an MoE model: the server's load-balance aux, per step
                    msg += "  aux " + " ".join(f"{a:.4f}" for a in aux.tolist())
                if per_round or info is not None:
                    msg += f"  modeled {history.modeled_seconds:.1f}s"
                if info is not None:
                    msg += (f"  clients {sum(info['participation'])}/"
                            f"{len(info['participation'])}")
                    if info["realloc"]:
                        msg += "  [re-allocated]"
                if global_rank() == 0:
                    print(msg)
            if (self.checkpoint_path and self.checkpoint_every
                    and (e + 1) % self.checkpoint_every == 0):
                self._save(state)
            if (self.episode_path and self.episode_every
                    and (e + 1) % self.episode_every == 0):
                history.wall_seconds = prev_wall + (time.time() - t0)
                self._save_episode(state, e + 1, history)
            if self.callback is not None:
                self.callback(e, state, history)
        history.wall_seconds = prev_wall + (time.time() - t0)
        if history.wall_seconds > 0:
            history.steps_per_sec = len(history.losses) / history.wall_seconds
        if self.checkpoint_path and not self.checkpoint_every:
            self._save(state)
        return state, history

    # every rank gathers a payload (a collective over a client axis); rank
    # 0 alone writes it
    def _save(self, state) -> None:
        from ..checkpoint import save_pytree
        payload = self.algo.checkpoint_payload(state)
        if global_rank() == 0:
            save_pytree(self.checkpoint_path, payload)

    def _save_episode(self, state, round_idx: int, history) -> None:
        from ..checkpoint import save_episode
        meta = {"round": int(round_idx),
                "history": dataclasses.asdict(history),
                "dynamics": None if self.dynamics is None else self.dynamics.cursor()}
        tree = self.algo.episode_tree(state)
        if global_rank() == 0:
            save_episode(self.episode_path, tree, meta)
