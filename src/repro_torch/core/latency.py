"""Training-delay model — paper Section V-A, eqs. (8)–(17).

The port's copy of ``repro.core.latency``: the host-side (numpy) report
functions the resource allocator sweeps.  ``repro``'s traced (jnp)
``client_round_seconds`` has no copy: the port's dynamic rounds evaluate
the deadline mask on the host with ``client_round_seconds_host``, its f32
twin as XLA compiles it, which gives the same mask bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..configs.base import ArchConfig
from ..configs.system import SystemConfig
from .channel import ClientEnv
from .workload import LayerWorkload, layer_workloads, lm_head_flops


@dataclass(frozen=True)
class SplitWorkload:
    """Aggregated Phi/Gamma/Theta terms for a given (mu, r)."""

    phi_c_f: float          # client FP FLOPs / sample (frozen)
    dphi_c_f: float         # client FP FLOPs / sample (LoRA, already x r)
    phi_s_f: float          # server FP
    dphi_s_f: float
    gamma_s: float          # activation bytes / sample at the split layer
    dtheta_c: float         # client LoRA bytes (uplink to fed server)

    @property
    def phi_c_b(self):      # paper: BP = 2 x FP
        return 2.0 * self.phi_c_f

    @property
    def dphi_c_b(self):
        return 2.0 * self.dphi_c_f

    @property
    def phi_s_b(self):
        return 2.0 * self.phi_s_f

    @property
    def dphi_s_b(self):
        return 2.0 * self.dphi_s_f


def split_workload(cfg: ArchConfig, workloads: List[LayerWorkload],
                   ell_c: int, rank: int, seq_len: int) -> SplitWorkload:
    """Phi_c^F(mu), DeltaPhi_c^F(mu,r), Gamma_s(mu), DeltaTheta_c(mu,r)...

    Gamma_s(mu) = sum_j (mu_j - mu_{j+1}) psi_j picks out the split layer's
    activation size; the LM head is a server-side constant.
    """
    c = workloads[:ell_c]
    s = workloads[ell_c:]
    return SplitWorkload(
        phi_c_f=sum(w.rho for w in c),
        dphi_c_f=rank * sum(w.drho for w in c),
        phi_s_f=sum(w.rho for w in s) + lm_head_flops(cfg, seq_len),
        dphi_s_f=rank * sum(w.drho for w in s),
        gamma_s=workloads[ell_c - 1].psi if ell_c >= 1 else float(
            seq_len * cfg.d_model * 2),
        dtheta_c=rank * sum(w.dxi for w in c),
    )


# ---------------------------------------------------------------------------
# per-client round delay as a function of (ell, r) indices and channel
# state — the dropout mask of the dynamic round engine
# ---------------------------------------------------------------------------

def workload_tables(cfg: ArchConfig, seq_len: int) -> Dict[str, np.ndarray]:
    """Cumulative per-layer workload tables indexed by the split point.

    ``rho_cum[ell]`` = Phi_c^F(ell) (frozen client FP FLOPs/sample),
    ``drho_cum[ell]`` = DeltaPhi_c^F(ell, r=1) (multiply by r),
    ``gamma[ell]`` = Gamma_s(ell) (split-activation bytes/sample) and
    ``dxi_cum[ell]`` = DeltaTheta_c(ell, r=1) (multiply by r), each of
    length ``num_layers + 1`` so an ``ell`` index gathers its own
    :func:`split_workload` terms.
    """
    ws = layer_workloads(cfg, seq_len)
    rho = np.array([w.rho for w in ws], np.float64)
    drho = np.array([w.drho for w in ws], np.float64)
    dxi = np.array([w.dxi for w in ws], np.float64)
    psi = np.array([w.psi for w in ws], np.float64)
    gamma0 = float(seq_len * cfg.d_model * 2)      # pre-layer-0 fallback
    return {
        "rho_cum": np.concatenate([[0.0], np.cumsum(rho)]),
        "drho_cum": np.concatenate([[0.0], np.cumsum(drho)]),
        "dxi_cum": np.concatenate([[0.0], np.cumsum(dxi)]),
        "gamma": np.concatenate([[gamma0], psi]),
    }


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 a*b + c rounded once, as a fused multiply-add rounds it: the
    product is exact in float64, the sum is taken to float64 by round to
    odd (TwoSum's error picks the odd neighbour), which then rounds to the
    correctly rounded float32."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def client_round_seconds_host(tables: Dict[str, np.ndarray], ell_k, rank_k,
                              f_hz, kappa, rates_main, rates_fed,
                              batch: int, local_steps: int,
                              retx_main=None, retx_fed=None,
                              act_bits=None) -> np.ndarray:
    """Numpy twin of ``repro.core.latency.client_round_seconds`` as XLA's
    CPU backend compiles it, bit for bit: the same tables, formula, float32
    arithmetic and term order, with the two multiply-adds that backend
    contracts into fused multiply-adds (the FP term plus the upload's last
    factor, E[m] else act_bits / 16; I x (...) plus the federated upload)
    each rounded once.  ``repro``'s in-graph deadline mask is the compiled
    value; ``repro``'s own numpy twin rounds those sums twice and lies an
    ulp from it for some inputs.  Edit the twins together."""
    f32 = np.float32
    ell = np.asarray(ell_k, int)
    rank = np.asarray(rank_k, f32)
    phi = tables["rho_cum"].astype(f32)[ell]
    dphi = rank * tables["drho_cum"].astype(f32)[ell]
    gamma = tables["gamma"].astype(f32)[ell]
    dtheta = rank * tables["dxi_cum"].astype(f32)[ell]
    t_fp = f32(batch) * np.asarray(kappa, f32) * (phi + dphi) \
        / np.asarray(f_hz, f32)
    t_up = f32(batch) * gamma * f32(8.0) / np.maximum(
        np.asarray(rates_main, f32), f32(1e-9))
    factors = []
    if act_bits is not None:
        factors.append(np.asarray(act_bits, f32) * f32(1.0 / 16.0))
    if retx_main is not None:
        factors.append(np.asarray(retx_main, f32))
    for fac in factors[:-1]:
        t_up = t_up * fac
    t_fwd = _fma_f32(t_up, factors[-1], t_fp) if factors else t_fp + t_up
    t_bp = f32(2.0) * t_fp
    t_fed = dtheta * f32(8.0) / np.maximum(
        np.asarray(rates_fed, f32), f32(1e-9))
    if retx_fed is not None:
        t_fed = t_fed * np.asarray(retx_fed, f32)
    return _fma_f32(f32(local_steps), t_fwd + t_bp, t_fed)


# ---------------------------------------------------------------------------
# eqs. (8)-(15)
# ---------------------------------------------------------------------------

def t_client_fp(sw: SplitWorkload, env: ClientEnv, b: int) -> float:
    return b * env.kappa * (sw.phi_c_f + sw.dphi_c_f) / env.f_hz       # (8)


def t_act_upload(sw: SplitWorkload, rate_bps: float, b: int) -> float:
    return b * sw.gamma_s * 8.0 / max(rate_bps, 1e-9)                  # (10)


def t_server_fp(sw: SplitWorkload, sys_cfg: SystemConfig, K: int, b: int) -> float:
    return (K * b * sys_cfg.kappa_server * (sw.phi_s_f + sw.dphi_s_f)
            / sys_cfg.f_server_hz)                                     # (11)


def t_server_bp(sw: SplitWorkload, sys_cfg: SystemConfig, K: int, b: int) -> float:
    return (K * b * sys_cfg.kappa_server * (sw.phi_s_b + sw.dphi_s_b)
            / sys_cfg.f_server_hz)                                     # (12)


def t_client_bp(sw: SplitWorkload, env: ClientEnv, b: int) -> float:
    return b * env.kappa * (sw.phi_c_b + sw.dphi_c_b) / env.f_hz       # (13)


def t_lora_upload(sw: SplitWorkload, rate_bps: float) -> float:
    return sw.dtheta_c * 8.0 / max(rate_bps, 1e-9)                     # (15)


# ---------------------------------------------------------------------------
# heterogeneous fleets: per-client (ell_k, r_k) — each client carries its
# own SplitWorkload; the pooled server pass sums each client's remaining
# layers instead of K copies of one global split
# ---------------------------------------------------------------------------

def t_server_fp_het(sws: Sequence[SplitWorkload], sys_cfg: SystemConfig,
                    b: int) -> float:
    """(11) with per-client server-side workloads: client k's samples run
    layers [ell_k, L), so the pooled FP is a sum, not K x one term."""
    return (b * sys_cfg.kappa_server / sys_cfg.f_server_hz
            * sum(sw.phi_s_f + sw.dphi_s_f for sw in sws))


def t_server_bp_het(sws: Sequence[SplitWorkload], sys_cfg: SystemConfig,
                    b: int) -> float:
    return (b * sys_cfg.kappa_server / sys_cfg.f_server_hz
            * sum(sw.phi_s_b + sw.dphi_s_b for sw in sws))


def het_local_round_latency(sws: Sequence[SplitWorkload],
                            envs: Sequence[ClientEnv],
                            rates_main: Sequence[float],
                            sys_cfg: SystemConfig, b: int) -> float:
    """(16) with per-client splits/ranks."""
    t1 = max(t_client_fp(sw, e, b) + t_act_upload(sw, r, b)
             for sw, e, r in zip(sws, envs, rates_main))
    t2 = max(t_client_bp(sw, e, b) for sw, e in zip(sws, envs))
    return (t1 + t_server_fp_het(sws, sys_cfg, b)
            + t_server_bp_het(sws, sys_cfg, b) + t2)


def het_total_latency(sws: Sequence[SplitWorkload], envs: Sequence[ClientEnv],
                      rates_main: Sequence[float], rates_fed: Sequence[float],
                      sys_cfg: SystemConfig, b: int, local_steps: int,
                      global_rounds: float) -> float:
    """(17) with per-client workloads; ``global_rounds`` already reflects
    the fleet's convergence behaviour (the caller picks E, e.g.
    max_k E(r_k))."""
    t_local = het_local_round_latency(sws, envs, rates_main, sys_cfg, b)
    t3 = max(t_lora_upload(sw, r) for sw, r in zip(sws, rates_fed))
    return global_rounds * (local_steps * t_local + t3)


def latency_report_het(cfg: ArchConfig, sys_cfg: SystemConfig,
                       envs: Sequence[ClientEnv], rates_main, rates_fed,
                       ells: Sequence[int], ranks: Sequence[int],
                       seq_len: int, b: int, local_steps: int,
                       global_rounds: float) -> dict:
    """Per-client counterpart of :func:`latency_report` — same keys, so the
    launch.engine modeled wall clock consumes either."""
    ws = layer_workloads(cfg, seq_len)
    sws = [split_workload(cfg, ws, int(e), int(r), seq_len)
           for e, r in zip(ells, ranks)]
    per_client = [
        {"split": int(ell), "rank": int(rk),
         "t_fp": t_client_fp(sw, e, b),
         "t_up": t_act_upload(sw, r, b),
         "t_bp": t_client_bp(sw, e, b),
         "t_fed": t_lora_upload(sw, rf)}
        for sw, ell, rk, e, r, rf in zip(sws, ells, ranks, envs, rates_main,
                                         rates_fed)
    ]
    return {
        "split": [int(e) for e in ells],
        "rank": [int(r) for r in ranks],
        "t1": max(c["t_fp"] + c["t_up"] for c in per_client),
        "t2": max(c["t_bp"] for c in per_client),
        "t3": max(c["t_fed"] for c in per_client),
        "t_server_fp": t_server_fp_het(sws, sys_cfg, b),
        "t_server_bp": t_server_bp_het(sws, sys_cfg, b),
        "t_local": het_local_round_latency(sws, envs, rates_main, sys_cfg, b),
        "total": het_total_latency(sws, envs, rates_main, rates_fed, sys_cfg,
                                   b, local_steps, global_rounds),
        "per_client": per_client,
    }


# ---------------------------------------------------------------------------
# eqs. (16)-(17)
# ---------------------------------------------------------------------------

def local_round_latency(sw: SplitWorkload, envs: Sequence[ClientEnv],
                        rates_main: Sequence[float], sys_cfg: SystemConfig,
                        b: int) -> float:
    """(16): max_k(T_k^F + T_k^s) + T_s^F + T_s^B + max_k T_k^B."""
    K = len(envs)
    t1 = max(t_client_fp(sw, e, b) + t_act_upload(sw, r, b)
             for e, r in zip(envs, rates_main))
    t2 = max(t_client_bp(sw, e, b) for e in envs)
    return (t1 + t_server_fp(sw, sys_cfg, K, b)
            + t_server_bp(sw, sys_cfg, K, b) + t2)


def total_latency(sw: SplitWorkload, envs: Sequence[ClientEnv],
                  rates_main: Sequence[float], rates_fed: Sequence[float],
                  sys_cfg: SystemConfig, b: int, local_steps: int,
                  global_rounds: float) -> float:
    """(17): T = E(r) (I * T_local + max_k T_k^f)."""
    t_local = local_round_latency(sw, envs, rates_main, sys_cfg, b)
    t3 = max(t_lora_upload(sw, r) for r in rates_fed)
    return global_rounds * (local_steps * t_local + t3)


def latency_report(cfg: ArchConfig, sys_cfg: SystemConfig,
                   envs: Sequence[ClientEnv], rates_main, rates_fed,
                   ell_c: int, rank: int, seq_len: int, b: int,
                   local_steps: int, global_rounds: float) -> dict:
    ws = layer_workloads(cfg, seq_len)
    sw = split_workload(cfg, ws, ell_c, rank, seq_len)
    K = len(envs)
    per_client = [
        {"t_fp": t_client_fp(sw, e, b),
         "t_up": t_act_upload(sw, r, b),
         "t_bp": t_client_bp(sw, e, b),
         "t_fed": t_lora_upload(sw, rf)}
        for e, r, rf in zip(envs, rates_main, rates_fed)
    ]
    return {
        "split": ell_c,
        "rank": rank,
        "t1": max(c["t_fp"] + c["t_up"] for c in per_client),
        "t2": max(c["t_bp"] for c in per_client),
        "t3": max(c["t_fed"] for c in per_client),
        "t_server_fp": t_server_fp(sw, sys_cfg, K, b),
        "t_server_bp": t_server_bp(sw, sys_cfg, K, b),
        "t_local": local_round_latency(sw, envs, rates_main, sys_cfg, b),
        "total": total_latency(sw, envs, rates_main, rates_fed, sys_cfg, b,
                               local_steps, global_rounds),
        "per_client": per_client,
    }
