"""Config registry: ``get_arch(name)`` and ``ARCHS`` for the architectures
the port runs so far — the paper's two models and Mamba2-2.7B (served
only) — ``TrainConfig`` and the wireless system of Table II
(``DEFAULT_SYSTEM``)."""
from __future__ import annotations

from . import gpt2_m, gpt2_s, mamba2_2_7b
from .base import ArchConfig, LayerPattern, TrainConfig
from .system import DEFAULT_SYSTEM, SystemConfig

# Paper's own models (benchmarks of Section VII).
PAPER_MODELS = (gpt2_s.CONFIG, gpt2_m.CONFIG)

ARCHS = {c.name: c for c in PAPER_MODELS + (mamba2_2_7b.CONFIG,)}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "LayerPattern", "PAPER_MODELS", "ARCHS", "get_arch",
           "TrainConfig", "DEFAULT_SYSTEM", "SystemConfig"]
