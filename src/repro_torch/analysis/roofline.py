"""Roofline terms of one step of one device — the port of ``repro``'s
``analysis.roofline`` on the H100's rates (``kernels.limits``: NVIDIA's
H100 SXM5 80GB datasheet, 700 W):

    compute term    = FLOPs / bf16 dense peak             (per card)
    memory term     = bytes / HBM rate                    (per card)
    collective term = sum over collectives of wire bytes / link rate

``repro`` reads its counts from XLA's compiled module; the port counts a
step by abstract evaluation (``analysis.cost``).  A collective whose
group lies within one node of ``NODE_CARDS`` consecutive ranks is
charged at the NVLink rate, any other at the network rate, and the JSON
says, per kind, what was charged at which (``coll_links``).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from ..kernels.limits import (HBM_BYTES_PER_S, NETWORK_BYTES_PER_S, NODE_CARDS,
                              NVLINK_BYTES_PER_S, PEAK_FLOPS)

PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]


def link(ranks) -> str:
    """"nvlink" for a group within one node of ``NODE_CARDS`` consecutive
    ranks, else "network"."""
    return "nvlink" if len({r // NODE_CARDS for r in ranks}) <= 1 else "network"


def collective_breakdown(calls) -> Dict[str, dict]:
    """{kind: {"count", "bytes", "nvlink_bytes", "network_bytes"}} of
    (kind, wire bytes, group ranks) calls."""
    out: Dict[str, dict] = {}
    for kind, nbytes, ranks in calls:
        slot = out.setdefault(kind, {"count": 0.0, "bytes": 0.0, "nvlink_bytes": 0.0,
                                     "network_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += nbytes
        slot[f"{link(ranks)}_bytes"] += nbytes
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device
    coll_breakdown: Dict[str, dict]
    model_flops_global: float    # 6*N*D (train) / 2*N*D (inference)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / (FLOPs * chips)
    coll_links: Dict[str, str] = field(default_factory=dict)
    note: str = ""

    def finish(self) -> "Roofline":
        self.t_compute = self.flops / PEAK_FLOPS_BF16
        self.t_memory = self.bytes_accessed / HBM_BYTES_PER_S
        self.t_collective = 0.0
        for kind, v in self.coll_breakdown.items():
            nv = v.get("nvlink_bytes", 0.0)
            net = v.get("network_bytes", v["bytes"] - nv)
            self.t_collective += nv / NVLINK_BYTES_PER_S + net / NETWORK_BYTES_PER_S
            self.coll_links[kind] = "+".join(
                f"{name} {rate / 1e9:g} GB/s" for name, b, rate in
                (("nvlink", nv, NVLINK_BYTES_PER_S), ("network", net, NETWORK_BYTES_PER_S))
                if b)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        total = self.flops * self.chips
        self.useful_ratio = self.model_flops_global / total if total else 0.0
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def model_flops(cfg, shape, *, lora_rank: Optional[int] = None) -> float:
    """MODEL_FLOPS: 6*N*D train / 2*N*D prefill / 2*N*B decode, with
    N = active params (MoE counts routed experts only)."""
    from ..models.model import num_active_params

    n = num_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token per row


def build_report(*, arch: str, shape_cfg, mesh_name: str, chips: int, cost, cfg) -> Roofline:
    """The roofline of a step counted by ``analysis.cost.measure``."""
    return Roofline(arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
                    flops=cost.flops, bytes_accessed=cost.bytes, coll_bytes=cost.coll_bytes,
                    coll_breakdown=collective_breakdown(cost.coll_calls),
                    model_flops_global=model_flops(cfg, shape_cfg)).finish()
