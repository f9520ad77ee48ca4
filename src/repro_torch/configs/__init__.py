"""Config registry: ``get_arch(name)`` and ``ARCHS`` for the architectures
the port runs so far — the paper's two models, the dense RoPE family
(minicpm-2b, deepseek-7b, yi-9b, mistral-large-123b), the MoE models
(olmoe-1b-7b, llama4-scout-17b-a16e), Mamba2-2.7B, the hybrid
jamba-1.5-large-398b (attention + mamba + MoE; reduced only) and the two
modality front ends (internvl2-2b, musicgen-large: a prefix of
precomputed embeddings; trained and run by ``generate``, refused by the
serving engines, as in ``repro``) — ``TrainConfig`` and the wireless
system of Table II (``DEFAULT_SYSTEM``)."""
from __future__ import annotations

from . import (deepseek_7b, gpt2_m, gpt2_s, internvl2_2b, jamba_1_5_large_398b,
               llama4_scout_17b_a16e, mamba2_2_7b, minicpm_2b, mistral_large_123b,
               musicgen_large, olmoe_1b_7b, yi_9b)
from .base import ArchConfig, LayerPattern, ShapeConfig, TrainConfig
from .system import DEFAULT_SYSTEM, SystemConfig

# Paper's own models (benchmarks of Section VII).
PAPER_MODELS = (gpt2_s.CONFIG, gpt2_m.CONFIG)

# repro's assigned architectures (repro.configs.ASSIGNED), all ported
PORTED = (olmoe_1b_7b.CONFIG, mistral_large_123b.CONFIG, deepseek_7b.CONFIG,
          yi_9b.CONFIG, mamba2_2_7b.CONFIG, minicpm_2b.CONFIG,
          llama4_scout_17b_a16e.CONFIG, jamba_1_5_large_398b.CONFIG,
          internvl2_2b.CONFIG, musicgen_large.CONFIG)

ARCHS = {c.name: c for c in PORTED + PAPER_MODELS}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "LayerPattern", "PAPER_MODELS", "PORTED", "ARCHS",
           "get_arch", "ShapeConfig", "TrainConfig", "DEFAULT_SYSTEM", "SystemConfig"]
