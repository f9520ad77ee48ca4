"""Joint resource allocation — paper Section VI (P1–P4, Algorithms 2–3).

* P1  subchannel assignment     -> greedy (Algorithm 2)
* P2  power control             -> exact convex solve: after the paper's
      log-convexification the per-client optimal PSD is uniform across its
      (equal-gain) subchannels, so the KKT system reduces to a 1-D
      bisection on T1/T3 with closed-form minimum-power-for-rate.  A scipy
      SLSQP solver of the same convex program cross-checks it in tests.
* P3  split-point selection     -> exhaustive over pattern-aligned splits
* P4  LoRA rank selection       -> exhaustive over candidate ranks, with
      E(r) from core.convergence
* Algorithm 3: block-coordinate descent over P1..P4.

The port's own copy of ``repro.core.resource`` (numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from ..configs.base import ArchConfig
from ..configs.system import SystemConfig
from .channel import ClientEnv, min_power_for_rate, rate_for_power, subchannel_bandwidths
from .convergence import ConvergenceModel, DEFAULT_E
from .latency import (SplitWorkload, split_workload, t_act_upload,
                      t_client_bp, t_client_fp, t_lora_upload, t_server_bp,
                      t_server_bp_het, t_server_fp, t_server_fp_het)
from .split import valid_splits
from .workload import layer_workloads


#: Empirical round-count inflation of a quantized split boundary: fewer
#: bits on the wire is (slightly) noisier SGD, so the search must TRADE
#: upload time against extra rounds rather than always picking min bits.
#: 16 maps to exactly 1.0 (multiplying by it is bit-exact — the disarmed
#: search reproduces the pre-precision objective float for float).
BITS_ROUND_PENALTY = {16: 1.0, 8: 1.05, 4: 1.25}


def bits_round_penalty(bits) -> float:
    return BITS_ROUND_PENALTY[int(bits)]


@dataclass
class Allocation:
    """One complete decision (r^s, r^f, p^s, p^f, mu, r) of problem (18),
    extended with the boundary-activation bit-width ``act_bits`` (the
    precision axis of the search; 16 = full precision, exactly the paper's
    problem)."""

    assign_main: np.ndarray            # (M,) client index per subchannel
    assign_fed: np.ndarray             # (N,)
    power_main: np.ndarray             # (K,) total W per client, main uplink
    power_fed: np.ndarray              # (K,)
    ell_c: int
    rank: int
    act_bits: int = 16

    def bw_main(self, sys_cfg: SystemConfig) -> np.ndarray:
        bws = subchannel_bandwidths(sys_cfg, "main")
        K = int(self.power_main.shape[0])
        return np.array([bws[self.assign_main == k].sum() for k in range(K)])

    def bw_fed(self, sys_cfg: SystemConfig) -> np.ndarray:
        bws = subchannel_bandwidths(sys_cfg, "fed")
        K = int(self.power_fed.shape[0])
        return np.array([bws[self.assign_fed == k].sum() for k in range(K)])

    def rates_main(self, sys_cfg: SystemConfig, envs) -> np.ndarray:
        bw = self.bw_main(sys_cfg)
        return np.array([
            rate_for_power(self.power_main[k], bw[k], envs[k].gain_main,
                           sys_cfg.noise_psd_w_hz) for k in range(len(envs))])

    def rates_fed(self, sys_cfg: SystemConfig, envs) -> np.ndarray:
        bw = self.bw_fed(sys_cfg)
        return np.array([
            rate_for_power(self.power_fed[k], bw[k], envs[k].gain_fed,
                           sys_cfg.noise_psd_w_hz) for k in range(len(envs))])


@dataclass(frozen=True)
class Problem:
    """Everything fixed during one resource-allocation episode.

    ``sw``/``workloads`` are memoized per instance (``memoize=False``
    disables, for benchmarking the saving): BCD evaluates the same
    (ell, rank) cells hundreds of times per run, and every ``sw`` used to
    rebuild the full per-layer workload table from scratch.
    ``cache_stats()`` reports hit rates."""

    cfg: ArchConfig
    sys_cfg: SystemConfig
    envs: Tuple[ClientEnv, ...]
    seq_len: int
    batch: int
    local_steps: int
    e_model: ConvergenceModel = DEFAULT_E
    rank_candidates: Tuple[int, ...] = (1, 2, 4, 6, 8)
    # precision axis of the search: candidate boundary-activation
    # bit-widths.  The default (16,) is exactly the paper's problem — the
    # bits loops collapse to one full-precision trial and every scale
    # multiply is by 1.0 (bit-exact).
    bits_candidates: Tuple[int, ...] = (16,)
    memoize: bool = True

    def __post_init__(self):
        object.__setattr__(self, "_ws_cache", None)
        object.__setattr__(self, "_sw_cache", {})
        object.__setattr__(self, "_pair_cache", {})
        object.__setattr__(self, "_stats", {"sw_hits": 0, "sw_misses": 0,
                                            "pair_hits": 0, "pair_misses": 0})

    def workloads(self):
        if not self.memoize:
            return layer_workloads(self.cfg, self.seq_len)
        if self._ws_cache is None:
            object.__setattr__(self, "_ws_cache",
                               layer_workloads(self.cfg, self.seq_len))
        return self._ws_cache

    def sw(self, ell_c: int, rank: int) -> SplitWorkload:
        key = (int(ell_c), int(rank))
        if self.memoize and key in self._sw_cache:
            self._stats["sw_hits"] += 1
            return self._sw_cache[key]
        out = split_workload(self.cfg, self.workloads(), key[0], key[1],
                             self.seq_len)
        if self.memoize:
            self._stats["sw_misses"] += 1
            self._sw_cache[key] = out
        return out

    def cache_stats(self) -> dict:
        return dict(self._stats)

    def with_envs(self, envs) -> "Problem":
        """A per-round view of the same episode under new channel gains
        (block fading).  The channel-independent workload caches (``_ws``/
        ``_sw`` depend only on cfg x seq_len) carry over — shared dicts, so
        later misses keep warming every round's view — while the
        channel-dependent pair cache starts empty."""
        new = replace(self, envs=tuple(envs))
        if self.memoize:
            object.__setattr__(new, "_ws_cache", self._ws_cache)
            object.__setattr__(new, "_sw_cache", self._sw_cache)
        return new


# ---------------------------------------------------------------------------
# objective (eq. 17 with explicit T1/T2/T3)
# ---------------------------------------------------------------------------

def objective(prob: Problem, alloc: Allocation) -> float:
    sw = prob.sw(alloc.ell_c, alloc.rank)
    b, K = prob.batch, len(prob.envs)
    r_main = alloc.rates_main(prob.sys_cfg, prob.envs)
    r_fed = alloc.rates_fed(prob.sys_cfg, prob.envs)
    # quantized boundary: the payload scales by act_bits/16 relative to
    # the fp16 wire format of the Gamma_s byte tables, and the round count
    # pays the precision penalty; 16 multiplies by exactly 1.0 twice
    bits_act = b * sw.gamma_s * 8.0 * (alloc.act_bits / 16.0)
    t1 = max(t_client_fp(sw, e, b) + bits_act / max(r, 1e-9)
             for e, r in zip(prob.envs, r_main))
    t2 = max(t_client_bp(sw, e, b) for e in prob.envs)
    t3 = max(sw.dtheta_c * 8.0 / max(r, 1e-9) for r in r_fed)
    t_local = (t1 + t_server_fp(sw, prob.sys_cfg, K, b)
               + t_server_bp(sw, prob.sys_cfg, K, b) + t2)
    e_rounds = prob.e_model(alloc.rank) * bits_round_penalty(alloc.act_bits)
    return e_rounds * (prob.local_steps * t_local + t3)


# ---------------------------------------------------------------------------
# P1: greedy subchannel assignment (Algorithm 2)
# ---------------------------------------------------------------------------

def _uniform_power(prob: Problem, n_assigned_bw: np.ndarray) -> np.ndarray:
    """Power policy used *inside* the greedy: each client spends min(p_max,
    fair share of p_th)."""
    K = len(prob.envs)
    return np.full(K, min(prob.sys_cfg.p_max_w, prob.sys_cfg.p_th_w / K))


def _greedy_subchannels_core(prob: Problem, sws: "List[SplitWorkload]",
                             act_scale=None):
    """Algorithm 2 on per-client workloads; returns (assign_m, assign_f,
    p_k).  Homogeneous callers pass K copies of one SplitWorkload.
    ``act_scale`` (optional (K,) of act_bits/16) shrinks each straggler's
    modeled upload payload under a quantized boundary."""
    sys_cfg, envs = prob.sys_cfg, prob.envs
    K = len(envs)
    bws_m = subchannel_bandwidths(sys_cfg, "main")
    bws_f = subchannel_bandwidths(sys_cfg, "fed")
    M, N = len(bws_m), len(bws_f)
    assign_m = np.full(M, -1)
    assign_f = np.full(N, -1)
    b = prob.batch
    p_k = np.full(K, min(sys_cfg.p_max_w, sys_cfg.p_th_w / K))

    # ---- Phase 1: everyone gets one subchannel ---------------------------
    # main: weakest compute first; fed: farthest first  (Algorithm 2 l.5-10)
    free_m = sorted(range(M), key=lambda i: -bws_m[i])
    free_f = sorted(range(N), key=lambda i: -bws_f[i])
    for j, k in enumerate(sorted(range(K), key=lambda k: envs[k].f_hz)):
        assign_m[free_m[j]] = k
    for j, k in enumerate(sorted(range(K), key=lambda k: -envs[k].d_fed_m)):
        assign_f[free_f[j]] = k
    free_m = [i for i in range(M) if assign_m[i] < 0]
    free_f = [i for i in range(N) if assign_f[i] < 0]

    def t_main(k):
        bw = bws_m[assign_m == k].sum()
        r = rate_for_power(p_k[k], bw, envs[k].gain_main, sys_cfg.noise_psd_w_hz)
        s = 1.0 if act_scale is None else act_scale[k]
        return (t_client_fp(sws[k], envs[k], b)
                + b * sws[k].gamma_s * 8.0 * s / max(r, 1e-9))

    def t_fed(k):
        bw = bws_f[assign_f == k].sum()
        r = rate_for_power(p_k[k], bw, envs[k].gain_fed, sys_cfg.noise_psd_w_hz)
        return sws[k].dtheta_c * 8.0 / max(r, 1e-9)

    # ---- Phase 2: feed the straggler ------------------------------------
    cand = set(range(K))
    for i in sorted(free_m, key=lambda i: -bws_m[i]):
        if not cand:
            break
        assign_m[i] = max(cand, key=t_main)
    cand = set(range(K))
    for i in sorted(free_f, key=lambda i: -bws_f[i]):
        if not cand:
            break
        assign_f[i] = max(cand, key=t_fed)
    return assign_m, assign_f, p_k


def greedy_subchannels(prob: Problem, ell_c: int, rank: int,
                       act_bits: int = 16) -> Allocation:
    sw = prob.sw(ell_c, rank)
    K = len(prob.envs)
    assign_m, assign_f, p_k = _greedy_subchannels_core(
        prob, [sw] * K,
        act_scale=None if act_bits == 16 else [act_bits / 16.0] * K)
    return Allocation(assign_main=assign_m, assign_fed=assign_f,
                      power_main=p_k.copy(), power_fed=p_k.copy(),
                      ell_c=ell_c, rank=rank, act_bits=int(act_bits))


# ---------------------------------------------------------------------------
# P2: power control (exact convex solve via bisection)
# ---------------------------------------------------------------------------

def _solve_minmax_rate(compute_t: np.ndarray, bits: np.ndarray,
                       bw: np.ndarray, gain: np.ndarray, noise: float,
                       p_max: float, p_th: float,
                       iters: int = 80) -> Tuple[float, np.ndarray]:
    """min T s.t. compute_t_k + bits_k / R_k <= T, with the minimum-power
    rate/power tradeoff P_k(R) = noise*bw*(2^(R/bw)-1)/gain_k, P_k <= p_max,
    sum P_k <= p_th.  Returns (T*, per-client power)."""
    K = len(bw)

    def power_needed(T):
        p = np.zeros(K)
        for k in range(K):
            if bits[k] <= 0:
                continue
            if T <= compute_t[k]:
                return None
            r_req = bits[k] / (T - compute_t[k])
            if bw[k] <= 0:
                return None
            p[k] = min_power_for_rate(r_req, bw[k], gain[k], noise)
        return p

    def feasible(T):
        p = power_needed(T)
        return p is not None and np.all(p <= p_max + 1e-15) and p.sum() <= p_th + 1e-15

    # upper bound: everyone at the fair-share power
    p0 = np.full(K, min(p_max, p_th / max(K, 1)))
    hi = 0.0
    for k in range(K):
        r = rate_for_power(p0[k], bw[k], gain[k], noise)
        hi = max(hi, compute_t[k] + (bits[k] / max(r, 1e-12) if bits[k] > 0 else 0))
    hi = max(hi * 1.001, 1e-9)
    if not feasible(hi):     # pathological: expand until feasible
        for _ in range(200):
            hi *= 2.0
            if feasible(hi):
                break
    lo = float(np.max(compute_t))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if mid <= lo:
            break
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    p = power_needed(hi)
    return float(hi), p


def solve_power_control(prob: Problem, alloc: Allocation) -> Allocation:
    """P2 for both uplinks (they are separable — C4/C5 are per-uplink)."""
    sw = prob.sw(alloc.ell_c, alloc.rank)
    envs, sys_cfg, b = prob.envs, prob.sys_cfg, prob.batch
    K = len(envs)
    noise = sys_cfg.noise_psd_w_hz

    compute = np.array([t_client_fp(sw, e, b) for e in envs])
    bits_act = np.full(K, b * sw.gamma_s * 8.0 * (alloc.act_bits / 16.0))
    _, p_main = _solve_minmax_rate(compute, bits_act, alloc.bw_main(sys_cfg),
                                   np.array([e.gain_main for e in envs]),
                                   noise, sys_cfg.p_max_w, sys_cfg.p_th_w)

    bits_lora = np.full(K, sw.dtheta_c * 8.0)
    _, p_fed = _solve_minmax_rate(np.zeros(K), bits_lora, alloc.bw_fed(sys_cfg),
                                  np.array([e.gain_fed for e in envs]),
                                  noise, sys_cfg.p_max_w, sys_cfg.p_th_w)
    return replace(alloc, power_main=p_main, power_fed=p_fed)


def solve_power_control_slsqp(prob: Problem, alloc: Allocation) -> Allocation:
    """Same convex program via scipy SLSQP over theta (cross-check path)."""
    from scipy.optimize import minimize

    sw = prob.sw(alloc.ell_c, alloc.rank)
    envs, sys_cfg, b = prob.envs, prob.sys_cfg, prob.batch
    K = len(envs)
    noise = sys_cfg.noise_psd_w_hz

    def solve_side(bw, gain, compute, bits):
        act = [k for k in range(K) if bits[k] > 0 and bw[k] > 0]
        if not act:
            return np.zeros(K), 0.0

        def power_of_rate(r, k):
            return min_power_for_rate(r, bw[k], gain[k], noise)

        # variables: rates R_k (k in act) + T
        def obj(x):
            return x[-1]

        cons = []
        for i, k in enumerate(act):
            cons.append({"type": "ineq",
                         "fun": (lambda x, i=i, k=k:
                                 x[-1] - compute[k] - bits[k] / max(x[i], 1e-9))})
            cons.append({"type": "ineq",
                         "fun": (lambda x, i=i, k=k:
                                 sys_cfg.p_max_w - power_of_rate(x[i], k))})
        cons.append({"type": "ineq",
                     "fun": lambda x: sys_cfg.p_th_w - sum(
                         power_of_rate(x[i], k) for i, k in enumerate(act))})
        p0 = min(sys_cfg.p_max_w, sys_cfg.p_th_w / K)
        r0 = np.array([rate_for_power(p0, bw[k], gain[k], noise) for k in act])
        t0 = max(compute[k] + bits[k] / max(r0[i], 1e-9)
                 for i, k in enumerate(act))
        x0 = np.concatenate([r0, [t0 * 1.1]])
        res = minimize(obj, x0, constraints=cons, method="SLSQP",
                       options={"maxiter": 400, "ftol": 1e-12})
        p = np.zeros(K)
        for i, k in enumerate(act):
            p[k] = power_of_rate(res.x[i], k)
        return p, float(res.x[-1])

    compute = np.array([t_client_fp(sw, e, b) for e in envs])
    p_main, _ = solve_side(alloc.bw_main(sys_cfg),
                           np.array([e.gain_main for e in envs]), compute,
                           np.full(K, b * sw.gamma_s * 8.0
                                   * (alloc.act_bits / 16.0)))
    p_fed, _ = solve_side(alloc.bw_fed(sys_cfg),
                          np.array([e.gain_fed for e in envs]), np.zeros(K),
                          np.full(K, sw.dtheta_c * 8.0))
    return replace(alloc, power_main=p_main, power_fed=p_fed)


# ---------------------------------------------------------------------------
# P3 / P4: exhaustive searches over the (ell, rank) objective grid
# ---------------------------------------------------------------------------

def _eval_pair(prob: Problem, alloc: Allocation, ell: int, rank: int,
               bits: Optional[int] = None) -> Tuple[Allocation, float]:
    """Power-control + objective for one (ell, rank, bits) cell, memoized
    on the current subchannel assignment: the P3/P4 sweeps of consecutive
    BCD iterations revisit the same cells (the assignment usually
    stabilises after a couple of iterations), so each cell's convex power
    solve runs once per episode instead of once per sweep."""
    if bits is None:
        bits = alloc.act_bits
    key = None
    if prob.memoize:
        key = (alloc.assign_main.tobytes(), alloc.assign_fed.tobytes(),
               int(ell), int(rank), int(bits))
        hit = prob._pair_cache.get(key)
        if hit is not None:
            prob._stats["pair_hits"] += 1
            p_main, p_fed, t = hit
            return replace(alloc, ell_c=int(ell), rank=int(rank),
                           act_bits=int(bits),
                           power_main=p_main.copy(),
                           power_fed=p_fed.copy()), t
    cand = solve_power_control(prob, replace(alloc, ell_c=int(ell),
                                             rank=int(rank),
                                             act_bits=int(bits)))
    t = objective(prob, cand)
    if key is not None:
        prob._stats["pair_misses"] += 1
        prob._pair_cache[key] = (cand.power_main.copy(),
                                 cand.power_fed.copy(), t)
    return cand, t


def objective_grid(prob: Problem, alloc: Allocation) -> dict:
    """The full (ell, rank) -> modeled-delay grid under ``alloc``'s
    subchannel assignment (each cell with its own optimal power and the
    allocation's current bit-width)."""
    return {(ell, r): _eval_pair(prob, alloc, ell, r)[1]
            for ell in valid_splits(prob.cfg)
            for r in prob.rank_candidates}


def best_global_pair(prob: Problem, alloc: Allocation
                     ) -> Tuple[Allocation, float]:
    """Exhaustive best single (ell, rank, bits) for the whole fleet; the
    bits axis runs over ``prob.bits_candidates`` ((16,) by default, which
    collapses to exactly the paper's (ell, rank) search)."""
    cells = {(ell, r, bb): _eval_pair(prob, alloc, ell, r, bb)[1]
             for ell in valid_splits(prob.cfg)
             for r in prob.rank_candidates
             for bb in prob.bits_candidates}
    (ell, r, bb), t = min(cells.items(), key=lambda kv: kv[1])
    return _eval_pair(prob, alloc, ell, r, bb)[0], t


def search_split(prob: Problem, alloc: Allocation) -> Allocation:
    best, best_t = alloc, objective(prob, alloc)
    for ell in valid_splits(prob.cfg):
        cand, t = _eval_pair(prob, alloc, ell, alloc.rank)
        if t < best_t:
            best, best_t = cand, t
    return best


def search_rank(prob: Problem, alloc: Allocation) -> Allocation:
    best, best_t = alloc, objective(prob, alloc)
    for r in prob.rank_candidates:
        cand, t = _eval_pair(prob, alloc, alloc.ell_c, r)
        if t < best_t:
            best, best_t = cand, t
    return best


def search_bits(prob: Problem, alloc: Allocation) -> Allocation:
    """P5: exhaustive over candidate boundary bit-widths (the precision
    block of the extended BCD).  A no-op when ``bits_candidates == (16,)``."""
    best, best_t = alloc, objective(prob, alloc)
    for bb in prob.bits_candidates:
        cand, t = _eval_pair(prob, alloc, alloc.ell_c, alloc.rank, bb)
        if t < best_t:
            best, best_t = cand, t
    return best


# ---------------------------------------------------------------------------
# Algorithm 3: BCD
# ---------------------------------------------------------------------------

def bcd_minimize_delay(prob: Problem, *, ell0: Optional[int] = None,
                       rank0: int = 4, eps: float = 1e-6,
                       max_iters: int = 20, verbose: bool = False
                       ) -> Tuple[Allocation, List[float]]:
    splits = valid_splits(prob.cfg)
    ell = ell0 if ell0 is not None else splits[len(splits) // 2]
    alloc = greedy_subchannels(prob, ell, rank0)
    alloc = solve_power_control(prob, alloc)
    hist = [objective(prob, alloc)]
    for it in range(max_iters):
        alloc = greedy_subchannels(prob, alloc.ell_c, alloc.rank,
                                   act_bits=alloc.act_bits)            # P1
        alloc = solve_power_control(prob, alloc)                       # P2
        alloc = search_split(prob, alloc)                              # P3
        alloc = search_rank(prob, alloc)                               # P4
        alloc = search_bits(prob, alloc)                               # P5
        hist.append(objective(prob, alloc))
        if verbose:
            print(f"BCD iter {it}: T = {hist[-1]:.3f}s "
                  f"(split={alloc.ell_c}, rank={alloc.rank}, "
                  f"bits={alloc.act_bits})")
        if abs(hist[-2] - hist[-1]) <= eps * max(hist[-2], 1e-12):
            break
    return alloc, hist


# ---------------------------------------------------------------------------
# per-client (ell_k, r_k): the heterogeneous extension of problem (18)
# ---------------------------------------------------------------------------

@dataclass
class HeteroAllocation(Allocation):
    """Allocation with per-client split points and LoRA ranks.

    ``ell_k``/``rank_k`` are (K,) int arrays; the scalar ``ell_c``/``rank``
    fields hold max() views for homogeneous consumers.  ``bits_k`` (None =
    all 16) carries each client's boundary-activation bit-width; the
    scalar ``act_bits`` holds the max() view.  Feed to
    ``SflLLM.from_allocation`` to train the mixed fleet it describes."""

    ell_k: np.ndarray = None
    rank_k: np.ndarray = None
    bits_k: np.ndarray = None


def _het_sws(prob: Problem, ells, ranks) -> List[SplitWorkload]:
    return [prob.sw(int(e), int(r)) for e, r in zip(ells, ranks)]


def objective_het(prob: Problem, alloc: HeteroAllocation) -> float:
    """(17) with per-client workloads.  The round count E models the
    global adapter's convergence under zero-pad slot-wise aggregation:
    every client contributes to the slots it owns, so the fleet behaves
    like its average capacity, E = mean_k E(r_k) (exactly E(r) when ranks
    are uniform, so the homogeneous objective embeds unchanged).

    Per-client boundary bit-widths ``bits_k`` scale each client's upload
    payload by bits/16 and inflate its round count by the precision
    penalty; all-16 (or None) multiplies by exactly 1.0 everywhere."""
    ells, ranks = alloc.ell_k, alloc.rank_k
    bits = (alloc.bits_k if getattr(alloc, "bits_k", None) is not None
            else np.full(len(ranks), 16))
    sws = _het_sws(prob, ells, ranks)
    b = prob.batch
    r_main = alloc.rates_main(prob.sys_cfg, prob.envs)
    r_fed = alloc.rates_fed(prob.sys_cfg, prob.envs)
    # (16) with per-client splits/ranks and quantized uploads
    t1 = max(t_client_fp(sw, e, b) + t_act_upload(sw, r, b) * (int(bb) / 16.0)
             for sw, e, r, bb in zip(sws, prob.envs, r_main, bits))
    t2 = max(t_client_bp(sw, e, b) for sw, e in zip(sws, prob.envs))
    t_local = (t1 + t_server_fp_het(sws, prob.sys_cfg, b)
               + t_server_bp_het(sws, prob.sys_cfg, b) + t2)
    t3 = max(t_lora_upload(sw, r) for sw, r in zip(sws, r_fed))
    e_rounds = float(np.mean([prob.e_model(int(r)) * bits_round_penalty(bb)
                              for r, bb in zip(ranks, bits)]))
    return e_rounds * (prob.local_steps * t_local + t3)


def greedy_subchannels_het(prob: Problem, ells, ranks,
                           bits=None) -> HeteroAllocation:
    """Algorithm 2 with per-client workloads: straggler times use each
    client's own (ell_k, r_k) — and its own upload bit-width when ``bits``
    is given."""
    scale = None if bits is None else [int(bb) / 16.0 for bb in bits]
    assign_m, assign_f, p_k = _greedy_subchannels_core(
        prob, _het_sws(prob, ells, ranks), act_scale=scale)
    return HeteroAllocation(
        assign_main=assign_m, assign_fed=assign_f,
        power_main=p_k.copy(), power_fed=p_k.copy(),
        ell_c=int(np.max(ells)), rank=int(np.max(ranks)),
        act_bits=16 if bits is None else int(np.max(bits)),
        ell_k=np.asarray(ells, int).copy(),
        rank_k=np.asarray(ranks, int).copy(),
        bits_k=None if bits is None else np.asarray(bits, int).copy())


def solve_power_control_het(prob: Problem, alloc: HeteroAllocation
                            ) -> HeteroAllocation:
    """P2 with per-client uplink payloads: bits follow each client's own
    split activation Gamma_s(ell_k) and adapter volume DeltaTheta(ell_k, r_k)."""
    sws = _het_sws(prob, alloc.ell_k, alloc.rank_k)
    envs, sys_cfg, b = prob.envs, prob.sys_cfg, prob.batch
    K = len(envs)
    noise = sys_cfg.noise_psd_w_hz

    compute = np.array([t_client_fp(sw, e, b) for sw, e in zip(sws, envs)])
    bscale = (np.ones(K) if getattr(alloc, "bits_k", None) is None
              else alloc.bits_k.astype(float) / 16.0)
    bits_act = np.array([b * sw.gamma_s * 8.0 for sw in sws]) * bscale
    _, p_main = _solve_minmax_rate(compute, bits_act, alloc.bw_main(sys_cfg),
                                   np.array([e.gain_main for e in envs]),
                                   noise, sys_cfg.p_max_w, sys_cfg.p_th_w)

    bits_lora = np.array([sw.dtheta_c * 8.0 for sw in sws])
    _, p_fed = _solve_minmax_rate(np.zeros(K), bits_lora, alloc.bw_fed(sys_cfg),
                                  np.array([e.gain_fed for e in envs]),
                                  noise, sys_cfg.p_max_w, sys_cfg.p_th_w)
    return replace(alloc, power_main=p_main, power_fed=p_fed)


def refine_per_client(prob: Problem, alloc: HeteroAllocation, *,
                      max_sweeps: int = 3, verbose: bool = False
                      ) -> Tuple[HeteroAllocation, List[float]]:
    """Greedy per-client coordinate descent on (ell_k, r_k, bits_k): sweep
    the clients, trying every (split, rank, bits) triple for one client
    with the rest frozen (power re-solved per trial); accept only strict
    improvements, re-greedy the subchannels between sweeps.  Monotone by
    construction, so the result is never worse than its (usually
    homogeneous) seed.  With the default ``bits_candidates == (16,)`` the
    bits loop collapses and this is exactly the pre-precision sweep."""
    best = solve_power_control_het(prob, alloc)
    best_t = objective_het(prob, best)
    hist = [best_t]
    splits = valid_splits(prob.cfg)
    K = len(prob.envs)
    for sweep in range(max_sweeps):
        improved = False
        for k in range(K):
            for ell in splits:
                for r in prob.rank_candidates:
                    for bb in prob.bits_candidates:
                        cur_bits = (16 if best.bits_k is None
                                    else int(best.bits_k[k]))
                        if (ell == best.ell_k[k] and r == best.rank_k[k]
                                and bb == cur_bits):
                            continue
                        ell_k = best.ell_k.copy()
                        rank_k = best.rank_k.copy()
                        bits_k = (np.full(K, 16) if best.bits_k is None
                                  else best.bits_k.copy())
                        ell_k[k], rank_k[k], bits_k[k] = ell, r, bb
                        cand = replace(best, ell_k=ell_k, rank_k=rank_k,
                                       bits_k=bits_k,
                                       ell_c=int(ell_k.max()),
                                       rank=int(rank_k.max()),
                                       act_bits=int(bits_k.max()))
                        cand = solve_power_control_het(prob, cand)
                        t = objective_het(prob, cand)
                        if t < best_t:
                            best, best_t, improved = cand, t, True
        # new workloads may want a new straggler-feeding assignment
        cand = greedy_subchannels_het(prob, best.ell_k, best.rank_k,
                                      bits=best.bits_k)
        cand = solve_power_control_het(prob, cand)
        t = objective_het(prob, cand)
        if t < best_t:
            best, best_t, improved = cand, t, True
        hist.append(best_t)
        if verbose:
            print(f"per-client sweep {sweep}: T = {best_t:.3f}s "
                  f"(ell_k={best.ell_k.tolist()}, r_k={best.rank_k.tolist()})")
        if not improved:
            break
    return best, hist


def as_hetero(prob: Problem, alloc: Allocation) -> HeteroAllocation:
    """View any allocation as a per-client one (scalar decisions fanned
    out to every client); HeteroAllocations pass through unchanged."""
    if getattr(alloc, "ell_k", None) is not None:
        return alloc
    K = len(prob.envs)
    return HeteroAllocation(
        assign_main=alloc.assign_main.copy(),
        assign_fed=alloc.assign_fed.copy(),
        power_main=alloc.power_main.copy(),
        power_fed=alloc.power_fed.copy(),
        ell_c=int(alloc.ell_c), rank=int(alloc.rank),
        act_bits=int(getattr(alloc, "act_bits", 16)),
        ell_k=np.full(K, int(alloc.ell_c)),
        rank_k=np.full(K, int(alloc.rank)),
        bits_k=np.full(K, int(getattr(alloc, "act_bits", 16))))


def reallocate_warm(prob: Problem, prev: Allocation, *, max_sweeps: int = 2,
                    verbose: bool = False
                    ) -> Tuple[HeteroAllocation, List[float]]:
    """Warm-started re-allocation for a drifted channel episode.

    Skips the cold global BCD: re-solves power for the previous decision
    under the new envs, tries a fresh greedy subchannel assignment of the
    same (ell_k, r_k), seeds per-client refinement from the better of the
    two.  Monotone versus the previous allocation *evaluated on the same
    (new) channel*: the power constraints (C4/C5) do not depend on the
    channel, so ``prev``'s powers stay feasible and the re-solved powers
    are optimal for its configuration; refinement accepts only strict
    improvements.  Hence ``objective_het(prob, result) <=
    objective_het(prob, prev)`` always.
    """
    prev = as_hetero(prob, prev)
    t_prev = objective_het(prob, prev)
    keep = solve_power_control_het(prob, _copy_hetero(prev))
    regreedy = solve_power_control_het(
        prob, greedy_subchannels_het(prob, prev.ell_k, prev.rank_k,
                                     bits=prev.bits_k))
    seed = min((keep, regreedy), key=lambda a: objective_het(prob, a))
    best, hist = refine_per_client(prob, seed, max_sweeps=max_sweeps,
                                   verbose=verbose)
    return best, [t_prev] + hist


def _copy_hetero(alloc: HeteroAllocation) -> HeteroAllocation:
    """Deep-ish copy so downstream ``replace`` calls never alias arrays."""
    return replace(alloc,
                   assign_main=alloc.assign_main.copy(),
                   assign_fed=alloc.assign_fed.copy(),
                   power_main=alloc.power_main.copy(),
                   power_fed=alloc.power_fed.copy(),
                   ell_k=alloc.ell_k.copy(), rank_k=alloc.rank_k.copy(),
                   bits_k=None if alloc.bits_k is None
                   else alloc.bits_k.copy())


def bcd_minimize_delay_per_client(prob: Problem, *, rank0: int = 4,
                                  eps: float = 1e-6, max_iters: int = 20,
                                  max_sweeps: int = 3, verbose: bool = False,
                                  warm_start: Optional[Allocation] = None
                                  ) -> Tuple[HeteroAllocation, List[float]]:
    """Algorithm 3 extended with per-client (ell_k, r_k): run the global
    BCD, anchor on the exhaustive best single pair, then greedy per-client
    refinement.  The seed is the best global-pair allocation, so the
    heterogeneous result is ≤ it by construction.

    ``warm_start``: a previous allocation (e.g. last round's) — skips the
    global BCD and refines from it instead (:func:`reallocate_warm`), the
    per-round path of the drift-triggered re-allocation loop."""
    if warm_start is not None:
        return reallocate_warm(prob, warm_start, max_sweeps=max_sweeps,
                               verbose=verbose)
    alloc, hist = bcd_minimize_delay(prob, rank0=rank0, eps=eps,
                                     max_iters=max_iters, verbose=verbose)
    anchor, t_anchor = best_global_pair(prob, alloc)
    if t_anchor < objective(prob, alloc):
        alloc = anchor
    K = len(prob.envs)
    seed = HeteroAllocation(
        assign_main=alloc.assign_main.copy(),
        assign_fed=alloc.assign_fed.copy(),
        power_main=alloc.power_main.copy(),
        power_fed=alloc.power_fed.copy(),
        ell_c=alloc.ell_c, rank=alloc.rank, act_bits=alloc.act_bits,
        ell_k=np.full(K, alloc.ell_c), rank_k=np.full(K, alloc.rank),
        bits_k=np.full(K, alloc.act_bits))
    best, hist2 = refine_per_client(prob, seed, max_sweeps=max_sweeps,
                                    verbose=verbose)
    return best, hist + hist2


def total_delay(prob: Problem, alloc: Allocation) -> float:
    """Objective dispatch: per-client when the allocation carries
    ``ell_k``/``rank_k``, the paper's global form otherwise."""
    if getattr(alloc, "ell_k", None) is not None:
        return objective_het(prob, alloc)
    return objective(prob, alloc)


# ---------------------------------------------------------------------------
# baselines a-d (Section VII-C)
# ---------------------------------------------------------------------------

def random_allocation(prob: Problem, rng, *, ell_c=None, rank=None) -> Allocation:
    K = len(prob.envs)
    sys_cfg = prob.sys_cfg
    M = sys_cfg.num_subchannels_main
    N = sys_cfg.num_subchannels_fed
    splits = valid_splits(prob.cfg)
    assign_m = rng.integers(0, K, M)
    assign_f = rng.integers(0, K, N)
    # every client needs >= 1 channel on each link for feasibility; with
    # more clients than subchannels that is impossible — round-robin the
    # channels over the clients instead of indexing past the permutation
    perm = rng.permutation(M)
    for k in range(K):
        assign_m[perm[k % M]] = k
    perm = rng.permutation(N)
    for k in range(K):
        assign_f[perm[k % N]] = k
    p = np.full(K, min(sys_cfg.p_max_w, sys_cfg.p_th_w / K)) * rng.uniform(0.2, 1.0, K)
    return Allocation(
        assign_main=assign_m, assign_fed=assign_f,
        power_main=p.copy(), power_fed=p.copy(),
        ell_c=int(ell_c) if ell_c is not None else int(rng.choice(splits)),
        rank=int(rank) if rank is not None else int(rng.choice(prob.rank_candidates)),
    )


def baseline(prob: Problem, which: str, rng) -> Allocation:
    """Paper baselines:
    a: random everything;
    b: random subchannel+power, optimized split+rank;
    c: random split, optimized subchannel+power+rank;
    d: optimized subchannel+power+split, random rank."""
    if which == "a":
        return random_allocation(prob, rng)
    if which == "b":
        alloc = random_allocation(prob, rng)
        best, best_t = alloc, objective(prob, alloc)
        for ell in valid_splits(prob.cfg):
            for r in prob.rank_candidates:
                cand = replace(alloc, ell_c=ell, rank=r)
                t = objective(prob, cand)
                if t < best_t:
                    best, best_t = cand, t
        return best
    if which == "c":
        splits = valid_splits(prob.cfg)
        ell = int(rng.choice(splits))
        alloc = greedy_subchannels(prob, ell, 4)
        alloc = solve_power_control(prob, alloc)
        alloc = search_rank(prob, alloc)
        return replace(alloc, ell_c=ell)
    if which == "d":
        rank = int(rng.choice(prob.rank_candidates))
        alloc = greedy_subchannels(prob, valid_splits(prob.cfg)[0], rank)
        alloc = solve_power_control(prob, alloc)
        alloc = search_split(prob, alloc)
        return replace(alloc, rank=rank)
    raise ValueError(which)
