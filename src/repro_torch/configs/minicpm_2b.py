"""MiniCPM-2B — llama-like dense arch trained with the WSD schedule
[arXiv:2404.06395].  `optim/schedules.py:wsd` implements the
warmup-stable-decay schedule the model card describes.
"""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
)
