"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

Pattern period = 8 sub-layers: one attention layer followed by seven Mamba
layers; the MoE FFN replaces the dense FFN on every other layer.  Attention
layers use the model's sliding-window-free full attention in training; the
long-context decode variant relies on the Mamba layers' O(1) state (the
single attention layer per period keeps a window).  At 398 B parameters
the port runs it reduced only: one period at d 8192 holds four 16-expert
MoE layers, ~155 GB in f32.
"""
from .base import ArchConfig, LayerPattern

_PERIOD = tuple(
    LayerPattern(
        mixer="attention" if i == 0 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PERIOD,
    num_experts=16,
    experts_per_token=2,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=128,
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
)
