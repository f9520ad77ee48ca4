"""LoRA utilities: merging, sizing, wire-format accounting and splitting —
the port of ``repro.core.lora`` for per-layer adapter lists.

The port keeps one adapter dict per layer (layer ``r * P + p`` is repeat
r at pattern position p), so splitting at a repeat boundary is a list
slice where JAX slices the stacked repeat axis.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..tree import tree_leaves


def merge_adapter(w: torch.Tensor, lora: dict, scale: float) -> torch.Tensor:
    """W' = W0 + scale * (B A)^T — the deploy-time merge of one projection,
    in ``repro``'s layout: w (d_in, d_out); lora {"a": (r, d_in), "b":
    (d_out, r)}.  The product and the sum are f32, cast back to w's dtype."""
    delta = torch.einsum("or,ri->io", lora["b"].float(), lora["a"].float()) * scale
    return (w.float() + delta).to(w.dtype)


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


def client_slot_masks(client_template: List[dict], ranks: Sequence[int],
                      rep_counts: Optional[Sequence[int]] = None, force: bool = False,
                      pattern_len: int = 1) -> Optional[List[dict]]:
    """Per-client 0/1 masks over the padded adapter slots of a K-stacked
    client tree — the rank-heterogeneity bookkeeping of the hetero fleet.

    ``client_template``: the client-side adapters of ONE client, one dict
    per layer (leaves ``a: (r_max, d_in)`` / ``b: (d_out, r_max)``; only
    shapes are read).  ``ranks``: per-client LoRA ranks r_k (len K);
    ``rep_counts``: per-client split boundary in repeat units (client k
    owns repeats [0, rep_k), layer i being repeat ``i // pattern_len``),
    or None for a uniform split.

    Slot (layer, s) of client k is live iff its repeat < rep_k and
    s < r_k.  The result matches the template's structure with float32
    leaves of shape (K, r_max, 1) for "a" and (K, 1, r_max) for "b",
    broadcastable against the K-stacked adapters, their gradients and
    their optimizer moments.  Returns None when nothing is masked (every
    client at full rank and full depth); ``force=True`` builds the
    all-ones tree anyway.  The twin of ``repro.core.lora.client_slot_masks``."""
    ranks = tuple(int(r) for r in ranks)
    K = len(ranks)
    reps = None if rep_counts is None else tuple(int(c) for c in rep_counts)
    if reps is not None and len(reps) != K:
        raise ValueError("rep_counts and ranks disagree on K")
    if not tree_leaves(client_template):
        return None
    n_reps = len(client_template) // pattern_len
    full_depth = reps is None or all(c >= n_reps for c in reps)
    r_max = max(ranks)
    if full_depth and all(r == r_max for r in ranks) and not force:
        return None
    if full_depth:
        reps = None
    rank_col = torch.tensor(ranks)[:, None]

    def _mask(name: str, leaf, rep_ok: torch.Tensor) -> torch.Tensor:
        if name not in ("a", "b"):
            raise ValueError(f"unexpected adapter leaf {name!r}")
        r = int(leaf.shape[0] if name == "a" else leaf.shape[-1])
        if r < r_max:
            raise ValueError(f"adapter template rank {r} < max client rank {r_max}; "
                             "build the template at rank max(r_k)")
        m = rep_ok[:, None] & (torch.arange(r)[None, :] < rank_col)     # (K, r)
        return (m[:, :, None] if name == "a" else m[:, None, :]).float()

    def _walk(node: dict, rep_ok: torch.Tensor) -> dict:
        return {k: (_walk(v, rep_ok) if isinstance(v, dict) else _mask(k, v, rep_ok))
                for k, v in node.items()}

    return [_walk(layer, torch.ones(K, dtype=torch.bool) if reps is None
                  else (i // pattern_len) < torch.tensor(reps))
            for i, layer in enumerate(client_template)]


def split_tree(tree: List[Any], rep_split: int,
               pattern_len: int = 1) -> Tuple[List[Any], List[Any]]:
    """Split a per-layer list at repeat ``rep_split``: (client, server)."""
    cut = rep_split * pattern_len
    return list(tree[:cut]), list(tree[cut:])


def concat_tree(client: List[Any], server: List[Any]) -> List[Any]:
    return list(client) + list(server)
