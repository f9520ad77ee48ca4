"""MusicGen-Large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

The EnCodec conv codec + text conditioner are stubbed, as in ``repro``: the
model functions take ``frontend_emb``, ``frontend_tokens`` precomputed
conditioning-frame embeddings of shape (batch, frontend_tokens, d_model),
which take no learned position (the text starts at position
``frontend_tokens``); the decoder
models the codec-token stream (vocab = 2048 codebook entries).  MusicGen
uses LayerNorm + GELU (standard pre-LN transformer) with learned positions.
"""
from .base import ArchConfig, LayerPattern

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(LayerPattern(mixer="attention", mlp="dense"),),
    mlp_kind="gelu_mlp",
    norm="layernorm",
    pos_emb="learned",
    max_seq_len=524_288,
    frontend="audio",
    frontend_tokens=64,             # conditioning frames
)
