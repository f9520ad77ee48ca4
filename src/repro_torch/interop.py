"""Conversion between ``repro``'s parameter trees, given as numpy leaves,
and the port's tensors.

``repro`` stacks each pattern position's block parameters over the repeat
axis (``params["layers"]`` is a tuple of P dicts with (R, ...) leaves);
the port keeps one dict per layer, layer ``r * P + p`` being repeat r at
pattern position p.  LoRA trees have the same stacked shape.  The caller
hands over numpy leaves (``jax.tree.map(np.asarray, params)``): the port
imports no JAX.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they travel as a ``uint16`` view.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from .kernels.backend import resolve_device


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_tensor(arr, device="cuda", dtype=None) -> torch.Tensor:
    """One numpy (or ml_dtypes) array -> tensor on ``device``.  The data is
    copied: the tensor never aliases the caller's (possibly read-only)
    array."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=resolve_device(device),
                dtype=dtype if dtype is not None and t.is_floating_point() else None)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bf16 comes back as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_to(tree: Any, device, dtype=None) -> Any:
    """Move every tensor leaf to ``device``; floating leaves also to
    ``dtype`` when given."""
    def one(t):
        if dtype is not None and t.is_floating_point():
            return t.to(device=device, dtype=dtype)
        return t.to(device=device)
    return tree_map(one, tree)


def split_layers(stacked: Sequence[dict]) -> List[dict]:
    """repro layout (P dicts of (R, ...) leaves) -> one dict per layer."""
    P = len(stacked)
    R = next((np.shape(leaf)[0] for entry in stacked
              for leaf in _leaves(entry)), 0)
    return [tree_map(lambda v, r=r: v[r], stacked[p])
            for r in range(R) for p in range(P)]


def stack_layers(layers: Sequence[dict], pattern_len: int) -> tuple:
    """Inverse of ``split_layers``: per-layer dicts of numpy leaves ->
    P dicts of (R, ...) stacked leaves."""
    out = []
    for p in range(pattern_len):
        per_rep = list(layers[p::pattern_len])
        out.append(_stack(per_rep))
    return tuple(out)


def _stack(trees: List[Any]) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def params_from_numpy(params: dict, device="cuda", dtype=None) -> dict:
    """repro params tree (numpy leaves) -> the port's params."""
    conv = lambda a: to_tensor(a, device, dtype)
    return {"embed": tree_map(conv, params["embed"]),
            "layers": tree_map(conv, split_layers(params["layers"])),
            "final_norm": tree_map(conv, params["final_norm"])}


def params_to_numpy(params: dict, pattern_len: int) -> dict:
    """The port's params -> repro's stacked layout with numpy leaves."""
    layers = tree_map(to_numpy, params["layers"])
    return {"embed": tree_map(to_numpy, params["embed"]),
            "layers": stack_layers(layers, pattern_len),
            "final_norm": tree_map(to_numpy, params["final_norm"])}


def lora_from_numpy(lora: Sequence[dict], device="cuda", dtype=None) -> List[dict]:
    """repro LoRA tree (P dicts of stacked numpy leaves) -> one adapter
    dict per layer."""
    return tree_map(lambda a: to_tensor(a, device, dtype), split_layers(lora))
