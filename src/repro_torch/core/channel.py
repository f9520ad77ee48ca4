"""Wireless channel + client environment model (paper Section III / VII-A).

K clients uniform in a disc of radius d_max around the federated server;
the main server sits d_main from the centroid.  Average channel gain
follows the 3GPP-style path loss 128.1 + 37.6 log10(d_km) with lognormal
shadowing (sigma = 8 dB).  Uplink rates follow eqs. (9) / (14):

    R_k = sum_i r_k^i B_i log2(1 + p_i G gamma_k / sigma^2)

with p_i the transmit PSD on subchannel i (W/Hz) — note the SNR is
PSD-against-PSD, so it is bandwidth-independent.

The port's own copy of ``repro.core.channel`` (numpy only).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..configs.system import SystemConfig, channel_gain


@dataclass(frozen=True)
class ClientEnv:
    """Static per-client environment for one resource-allocation episode."""

    f_hz: float            # computing capability f_k (cycles/s)
    kappa: float           # cycles per FLOP
    d_main_m: float
    d_fed_m: float
    gain_main: float       # G_c G_s gamma(d_k^s), linear
    gain_fed: float        # G_c G_f gamma(d_k^f), linear


def sample_clients(sys_cfg: SystemConfig, rng: np.random.Generator | int = 0
                   ) -> List[ClientEnv]:
    """Draw the Section VII-A scenario."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    K = sys_cfg.num_clients
    r = sys_cfg.d_max_m * np.sqrt(rng.uniform(0, 1, K))
    ang = rng.uniform(0, 2 * math.pi, K)
    x, y = r * np.cos(ang), r * np.sin(ang)
    # fed server at origin; main server at (d_main, 0)
    d_fed = np.hypot(x, y)
    d_main = np.hypot(x - sys_cfg.d_main_m, y)
    f = rng.uniform(*sys_cfg.f_client_hz_range, K)
    shadow = rng.normal(0.0, sys_cfg.shadow_std_db, (K, 2))
    out = []
    for k in range(K):
        out.append(ClientEnv(
            f_hz=float(f[k]),
            kappa=sys_cfg.kappa_client,
            d_main_m=float(d_main[k]),
            d_fed_m=float(d_fed[k]),
            gain_main=sys_cfg.antenna_gain_main * channel_gain(d_main[k], shadow[k, 0]),
            gain_fed=sys_cfg.antenna_gain_fed * channel_gain(d_fed[k], shadow[k, 1]),
        ))
    return out


def _apply_shadow_db(envs: Sequence[ClientEnv], x_db: np.ndarray
                     ) -> List[ClientEnv]:
    """Scale each env's (gain_main, gain_fed) by 10^(x/10), x: (K, 2) dB."""
    fac = 10.0 ** (np.asarray(x_db, float) / 10.0)
    return [ClientEnv(
        f_hz=e.f_hz, kappa=e.kappa, d_main_m=e.d_main_m,
        d_fed_m=e.d_fed_m, gain_main=e.gain_main * float(f[0]),
        gain_fed=e.gain_fed * float(f[1])) for e, f in zip(envs, fac)]


def fade_clients(envs: Sequence[ClientEnv], rng, std_db: float = 4.0
                 ) -> List[ClientEnv]:
    """Per-round block fading: lognormal perturbation of the average gains
    (the paper's 'time-varying and dynamically varying communication
    resources').  Returns a new list of ClientEnv."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    return _apply_shadow_db(envs, rng.normal(0.0, std_db, (len(envs), 2)))


class FadingProcess:
    """Temporally-correlated block fading around the sampled average gains.

    AR(1) in the dB domain:  x_t = rho x_{t-1} + sqrt(1 - rho^2) n_t  with
    n_t ~ N(0, std_db^2), applied to the *base* envs each round, so every
    round's marginal distribution matches one :func:`fade_clients` draw
    (``rho=0`` degenerates to exactly i.i.d. per-round fading) while
    ``rho>0`` models channel coherence across consecutive global rounds —
    the regime where drift-triggered re-allocation pays off (a deep fade
    persists long enough for the new allocation to amortize).
    """

    def __init__(self, envs: Sequence[ClientEnv], std_db: float = 4.0,
                 rho: float = 0.0, rng: np.random.Generator | int = 0):
        if not 0.0 <= rho < 1.0:
            raise ValueError(f"rho must be in [0, 1), got {rho}")
        self.base = tuple(envs)
        self.std_db = float(std_db)
        self.rho = float(rho)
        self.rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
        self._x: np.ndarray | None = None       # current dB state (K, 2)

    def step(self) -> List[ClientEnv]:
        """Advance one round; returns the faded envs for this round."""
        n = self.rng.normal(0.0, self.std_db, (len(self.base), 2))
        if self._x is None:
            self._x = n                          # stationary start
        else:
            self._x = (self.rho * self._x
                       + math.sqrt(1.0 - self.rho ** 2) * n)
        return _apply_shadow_db(self.base, self._x)

    # -- checkpoint/resume cursor (launch.engine.WirelessDynamics) ---------
    def get_state(self) -> dict:
        """JSON-able process cursor: generator state (PCG64 carries 128-bit
        ints — JSON handles them, msgpack does not) + the AR(1) dB state.
        Restoring it makes the resumed draw sequence bit-identical."""
        return {
            "rng": self.rng.bit_generator.state,
            "x": None if self._x is None else np.asarray(self._x).tolist(),
        }

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._x = (None if state["x"] is None
                   else np.asarray(state["x"], float))


# ---------------------------------------------------------------------------
# link outages + HARQ retransmissions (beyond-paper robustness model)
# ---------------------------------------------------------------------------

def outage_probability(snr_avg, snr_th) -> np.ndarray:
    """Per-transmission outage probability under Rayleigh fast fading
    within a round: the instantaneous SNR is exponentially distributed
    around the block average ``snr_avg`` (the AR(1) shadowed gain), so

        p_out = P[snr < snr_th] = 1 - exp(-snr_th / snr_avg).

    Both arguments are linear (not dB); broadcasts elementwise."""
    snr_avg = np.maximum(np.asarray(snr_avg, float), 1e-30)
    return 1.0 - np.exp(-np.asarray(snr_th, float) / snr_avg)


def expected_transmissions(p_out, max_tx: int) -> np.ndarray:
    """Expected number of HARQ transmission attempts under truncated
    retransmission: each attempt fails i.i.d. with ``p_out`` and the link
    gives up after ``max_tx`` tries, so the attempt count is a truncated
    geometric with mean (1 - p^m) / (1 - p) — exactly 1.0 at p=0 (the
    retransmission multiplier is then bit-exact identity on the delay
    model).  The residual failure probability p^m is a *hard outage*
    (the round's payload never arrives; see ``residual_outage``)."""
    m = int(max_tx)
    if m < 1:
        raise ValueError(f"max_tx must be >= 1, got {max_tx}")
    # clip strictly below 1 so the p -> 1 limit evaluates to m (every
    # attempt is made and fails), not 0/0
    p = np.clip(np.asarray(p_out, float), 0.0, 1.0 - 1e-12)
    return (1.0 - p ** m) / (1.0 - p)


def residual_outage(p_out, max_tx: int) -> np.ndarray:
    """Probability that all ``max_tx`` HARQ attempts fail: p^m."""
    return np.clip(np.asarray(p_out, float), 0.0, 1.0) ** int(max_tx)


def subchannel_bandwidths(sys_cfg: SystemConfig, which: str) -> np.ndarray:
    """Equal split of the total bandwidth (Table II)."""
    if which == "main":
        n = sys_cfg.num_subchannels_main
    else:
        n = sys_cfg.num_subchannels_fed
    return np.full(n, sys_cfg.total_bandwidth_hz / n)


def rate_bps(bw_hz: Sequence[float], psd_w_hz: Sequence[float], gain: float,
             noise_psd: float) -> float:
    """eq. (9)/(14) for one client's set of assigned subchannels."""
    bw = np.asarray(bw_hz, float)
    p = np.asarray(psd_w_hz, float)
    snr = p * gain / noise_psd
    return float(np.sum(bw * np.log2(1.0 + snr)))


def min_power_for_rate(rate_bps_target: float, bw_total: float, gain: float,
                       noise_psd: float) -> float:
    """Minimum total transmit power (W) to reach a rate over subchannels of
    total bandwidth ``bw_total`` with a common gain.

    With equal gains, the optimal PSD is uniform (equal spectral efficiency
    per Hz), giving  P = sigma^2 * bw * (2^(R/bw) - 1) / gain.
    """
    if rate_bps_target <= 0:
        return 0.0
    return noise_psd * bw_total * (2.0 ** (rate_bps_target / bw_total) - 1.0) / gain


def rate_for_power(power_w: float, bw_total: float, gain: float,
                   noise_psd: float) -> float:
    """Inverse of min_power_for_rate."""
    if bw_total <= 0 or power_w <= 0:
        return 0.0
    psd = power_w / bw_total
    return bw_total * math.log2(1.0 + psd * gain / noise_psd)
