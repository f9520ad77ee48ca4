"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060].

Pure Mamba2 blocks (no separate FFN: d_ff = 0); d_inner = 2*d_model = 5120,
head_dim = 64 -> 80 SSD heads, d_state = 128.  The paper's LoRA-on-q/v
protocol is adapted to the SSD in/out projections.
"""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerPattern(mixer="mamba", mlp="none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    norm="rmsnorm",
    pos_emb="none",
    lora_targets=("ssm_in", "ssm_out"),
    max_seq_len=524_288,
)
