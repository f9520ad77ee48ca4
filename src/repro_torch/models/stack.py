"""Decoder blocks and the layer stack for paged serving.

Where ``repro`` stacks each pattern position's parameters over the
repeat axis and ``lax.scan``s over it, the port keeps one entry per layer
(``params["layers"][i]`` is repeat ``i // P`` at pattern position
``i % P``) and runs the stack as a Python loop: PyTorch executes eagerly,
so a scan buys nothing here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from . import attention as attn_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm


@dataclass(frozen=True)
class Runtime:
    """The serving knobs of ``repro.models.stack.Runtime``."""

    dense_impl: str = "einsum"          # "einsum" | "fused" (kernels.lora_matmul)
    # "flash" routes paged decode through kernels.flash_attention.paged_decode
    # (the CUDA kernel on a CUDA tensor); "naive" takes the plain gather
    decode_attn_impl: str = "naive"

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)


def default_serve_runtime() -> Runtime:
    """The serving fast path: fused LoRA projections and the paged decode
    kernel (each routed by device: kernels on CUDA, plain code on CPU)."""
    return Runtime(dense_impl="fused", decode_attn_impl="flash")


def init_block(cfg, pat, gen: torch.Generator, dtype, device) -> dict:
    if pat.mixer != "attention" or pat.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"{cfg.name}: only attention + dense-MLP blocks are ported")
    p: dict = {"norm1": init_norm(cfg, cfg.d_model, dtype, device),
               "mixer": attn_mod.init_attention(cfg, gen, dtype, device)}
    if pat.mlp != "none":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["mlp"] = init_mlp(cfg, gen, dtype, device)
    return p


def apply_block(cfg, pat, p: dict, x, *, lora, lora_scale, rt: Runtime,
                mode: str, cache, cur_index, block_tables):
    """mode "decode": one token per slot over the paged pool
    (block_tables (B, MP), cur_index (B,)); mode "chunk": one paged
    prefill chunk (block_tables (MP,), cur_index the chunk's start).
    Returns (x, cache)."""
    mixer_lora = None if lora is None else lora.get("mixer")
    h = apply_norm(cfg, x, p["norm1"])
    if mode == "decode":
        m, cache = attn_mod.paged_decode_attention(
            cfg, p["mixer"], h, cache, block_tables, cur_index,
            lora=mixer_lora, lora_scale=lora_scale,
            impl=rt.decode_attn_impl, dense_impl=rt.dense_impl)
    elif mode == "chunk":
        m, cache = attn_mod.paged_chunk_attention(
            cfg, p["mixer"], h, cache, block_tables, cur_index,
            lora=mixer_lora, lora_scale=lora_scale, dense_impl=rt.dense_impl)
    else:
        raise ValueError(f"mode {mode!r}: the port serves 'decode' and 'chunk'")
    x = x + m
    if pat.mlp != "none":
        h = apply_norm(cfg, x, p["norm2"])
        x = x + apply_mlp(cfg, h, p["mlp"],
                          None if lora is None else lora.get("mlp"),
                          lora_scale, dense_impl=rt.dense_impl)
    return x, cache


def init_paged_stack_cache(cfg, num_pages: int, page_size: int, dtype,
                           device) -> List[dict]:
    """One (KH, NP, PS, D) k/v pool pair per layer."""
    if any(pat.mixer != "attention" for pat in cfg.pattern):
        raise NotImplementedError("paged KV cache requires an attention-only pattern")
    return [attn_mod.init_paged_attn_cache(cfg, num_pages, page_size, dtype, device)
            for _ in range(cfg.num_layers)]


def apply_stack(cfg, layers: List[dict], x, *, lora: Optional[List[dict]] = None,
                rt: Runtime, mode: str, caches: List[dict], cur_index,
                block_tables, lora_scale: Optional[float] = None):
    """Run every layer in order.  ``lora`` is a per-layer list of adapter
    dicts (or None); the scale defaults to ``cfg.lora_alpha / cfg.lora_rank``.
    Returns (x, caches)."""
    scale = (cfg.lora_alpha / cfg.lora_rank) if lora_scale is None else lora_scale
    kinds = cfg.layer_kinds
    for i, p in enumerate(layers):
        x, caches[i] = apply_block(
            cfg, kinds[i], p, x, lora=None if lora is None else lora[i],
            lora_scale=scale, rt=rt, mode=mode, cache=caches[i],
            cur_index=cur_index, block_tables=block_tables)
    return x, caches
