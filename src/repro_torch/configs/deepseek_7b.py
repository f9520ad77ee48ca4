"""DeepSeek-7B — dense llama-arch, MHA (kv=32) [arXiv:2401.02954]."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    source="arXiv:2401.02954",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
)
