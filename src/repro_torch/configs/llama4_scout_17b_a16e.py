"""Llama-4-Scout-17B-16E — MoE 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

Early-fusion multimodality is exercised through the same embedding-prefix
path as the VLM stub; the text path is the assigned backbone.
"""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                      # per-expert FFN width
    vocab_size=202048,
    pattern=(LayerPattern(mixer="attention", mlp="moe"),),
    num_experts=16,
    experts_per_token=1,
    shared_expert=True,
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=5e5,
)
