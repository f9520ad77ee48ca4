"""InternVL2-2B — VLM: InternViT (STUB) + InternLM2-1.8B backbone
[arXiv:2404.16821].

The vision encoder + MLP projector are stubbed, as in ``repro``: the model
functions take ``frontend_emb``, ``frontend_tokens`` precomputed,
already-projected patch embeddings of shape (batch, frontend_tokens,
d_model); this config describes the language transformer that consumes
them.
"""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    frontend="vision",
    frontend_tokens=256,            # one 448x448 tile -> 256 visual tokens
)
