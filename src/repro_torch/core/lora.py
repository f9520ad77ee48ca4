"""LoRA utilities: sizing, wire-format accounting and splitting — the port
of ``repro.core.lora`` for per-layer adapter lists.

The port keeps one adapter dict per layer (layer ``r * P + p`` is repeat
r at pattern position p), so splitting at a repeat boundary is a list
slice where JAX slices the stacked repeat axis.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from ..tree import tree_leaves


def count_params(tree: Any) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))


def tree_bytes(tree: Any, bytes_per_param: int = 4) -> int:
    return count_params(tree) * bytes_per_param


def adapter_bytes_per_layer(cfg, rank: int, bytes_per_param: int = 4) -> list:
    """Delta xi_j of eq. 15 — per-layer LoRA data volume in bytes, one
    entry per layer (0 where the block carries none of cfg.lora_targets)."""
    from ..models.model import _lora_dims

    out = []
    for pat in cfg.layer_kinds:
        n = 0
        for t in cfg.lora_targets:
            dims = _lora_dims(cfg, pat, t)
            if dims is not None:
                _, d_in, d_out = dims
                n += rank * (d_in + d_out)
        out.append(n * bytes_per_param)
    return out


def split_tree(tree: List[Any], rep_split: int,
               pattern_len: int = 1) -> Tuple[List[Any], List[Any]]:
    """Split a per-layer list at repeat ``rep_split``: (client, server)."""
    cut = rep_split * pattern_len
    return list(tree[:cut]), list(tree[cut:])


def concat_tree(client: List[Any], server: List[Any]) -> List[Any]:
    return list(client) + list(server)
