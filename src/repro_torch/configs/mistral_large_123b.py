"""Mistral-Large-2407 (123B) — dense GQA [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=1e6,
)
