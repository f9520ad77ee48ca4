"""Yi-9B — dense llama-arch, GQA kv=4 [arXiv:2403.04652]."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
)
