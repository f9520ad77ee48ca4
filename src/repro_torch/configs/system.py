"""Wireless-system parameters — paper Table II, verbatim (the port's own
copy of ``repro.configs.system``).

Units: powers in dBm (converted where needed), bandwidth in Hz, computing
capability f in cycles/s, kappa in cycles/FLOP.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) / 1000.0


def watt_to_dbm(w: float) -> float:
    import math

    return 10.0 * math.log10(w * 1000.0)


@dataclass(frozen=True)
class SystemConfig:
    num_clients: int = 5                       # K
    num_subchannels_main: int = 20             # M
    num_subchannels_fed: int = 20              # N
    total_bandwidth_hz: float = 500e3          # B_c = B_s, split equally
    noise_psd_dbm_hz: float = -174.0           # sigma^2 (PSD)
    p_max_dbm: float = 41.76                   # per-client max transmit power
    p_th_dbm: float = 46.99                    # per-server total power budget
    antenna_gain_main: float = 160.0           # G_c * G_s
    antenna_gain_fed: float = 80.0             # G_c * G_f
    shadow_std_db: float = 8.0
    d_max_m: float = 20.0                      # client disc radius (fed server at center)
    d_main_m: float = 100.0                    # main server distance from centroid
    # compute
    f_server_hz: float = 5e9                   # f_s
    f_client_hz_range: Tuple[float, float] = (1.0e9, 1.6e9)
    kappa_server: float = 1.0 / 32768.0        # cycles / FLOP
    kappa_client: float = 1.0 / 1024.0
    # training protocol
    batch_size: int = 16                       # b
    local_steps: int = 12                      # I
    bytes_per_activation: int = 2              # bf16 on the wire
    bytes_per_param: int = 4                   # fp32 LoRA upload

    @property
    def subchannel_bw_main(self) -> float:
        return self.total_bandwidth_hz / self.num_subchannels_main

    @property
    def subchannel_bw_fed(self) -> float:
        return self.total_bandwidth_hz / self.num_subchannels_fed

    @property
    def noise_psd_w_hz(self) -> float:
        return dbm_to_watt(self.noise_psd_dbm_hz)

    @property
    def p_max_w(self) -> float:
        return dbm_to_watt(self.p_max_dbm)

    @property
    def p_th_w(self) -> float:
        return dbm_to_watt(self.p_th_dbm)


def path_loss_db(d_km: float) -> float:
    """Paper: 128.1 + 37.6 log10(d), d in km."""
    import math

    return 128.1 + 37.6 * math.log10(max(d_km, 1e-6))


def channel_gain(d_m: float, shadow_db: float = 0.0) -> float:
    """Linear average channel gain gamma(d) including shadow fading (dB)."""
    loss_db = path_loss_db(d_m / 1000.0) + shadow_db
    return 10.0 ** (-loss_db / 10.0)


DEFAULT_SYSTEM = SystemConfig()
