"""GPT2-S (124M) — the paper's own experimental model (Section VII)."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="gpt2-s",
    family="dense",
    source="Radford et al. 2019 (paper Section VII)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
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
