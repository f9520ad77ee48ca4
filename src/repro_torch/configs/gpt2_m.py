"""GPT2-M (355M) — the paper's second experimental model (Section VII)."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="gpt2-m",
    family="dense",
    source="Radford et al. 2019 (paper Section VII)",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="gelu_mlp",
    norm="layernorm",
    pos_emb="learned",
    tie_embeddings=True,
    max_seq_len=1024,
    lora_rank=4,
    lora_alpha=8.0,
)
