"""OLMoE-1B-7B — MoE, 64 experts top-8 [arXiv:2409.02060]."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                      # per-expert FFN width
    vocab_size=50304,
    pattern=(LayerPattern(mixer="attention", mlp="moe"),),
    num_experts=64,
    experts_per_token=8,
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
)
