"""Conversion between ``repro``'s parameter trees, given as numpy leaves,
and the port's tensors.

``repro`` stacks each pattern position's block parameters over the repeat
axis (``params["layers"]`` is a tuple of P dicts with (R, ...) leaves);
the port keeps one dict per layer, layer ``r * P + p`` being repeat r at
pattern position p.  LoRA trees have the same stacked shape.  The caller
hands over numpy leaves (``jax.tree.map(np.asarray, params)``): the port
imports no JAX.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they travel as a ``uint16`` view.
SFL states cross over too (``sfl_state_from_numpy`` /
``sfl_state_to_numpy``): client leaves keep their leading K axis, the
optimizer moments follow the adapters' layout, and the error-feedback
accumulators ``err_act``/``err_grad`` (K, b, S, d) cross as they are.
An int8 base (``quantize_params_int8``) crosses as int8 ``w`` plus its f32
``w_scale``; ``w_scale``, a Mamba2 block's ``A_log``, ``D`` and
``dt_bias`` and its ``ssm`` state stay f32 whatever ``dtype`` the other
floats are cast to (``F32_LEAVES``, as ``repro`` keeps them); rank-padded
adapters cross like any other.  Slab decode caches cross too
(``slab_cache_from_numpy`` / ``slab_cache_to_numpy``): ``repro``'s tuple
over pattern positions of dicts stacked over repeats — {"k", "v": (R, B,
L, KH, D), "pos": (R, B, L)} for attention, {"ssm": (R, B, nh, hd, N),
"conv": (R, B, W-1, conv_dim)} for Mamba2 — becomes the port's per-layer
list, the int32 positions kept as they are.
A multi-tenant adapter pool crosses with the LoRA functions: ``repro``'s
``AdapterRegistry.pool`` leaves are (R, A, ...), and ``lora_from_numpy``
splits the repeat axis into the port's per-layer (A, ...) pool (the
layout of ``serving.AdapterRegistry.pool``); ``lora_to_numpy`` stacks it
back.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from .kernels.backend import resolve_device
from .tree import tree_map


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


# leaves kept float32 when a tree's floats are cast to another dtype
F32_LEAVES = frozenset({"w_scale", "A_log", "D", "dt_bias", "ssm"})


def _cast(dtype, name: str, floating: bool):
    """The dtype a leaf named ``name`` is cast to (None: keep its own)."""
    return dtype if floating and name not in F32_LEAVES else None


def _map_named(fn, tree: Any, name: str = "") -> Any:
    """``tree_map`` that also hands ``fn`` the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return None if tree is None else fn(tree, name)


def tree_to(tree: Any, device, dtype=None) -> Any:
    """Move every tensor leaf to ``device``; floating leaves also to
    ``dtype`` when given, except the ``F32_LEAVES``."""
    return _map_named(lambda t, name: t.to(
        device=device, dtype=_cast(dtype, name, t.is_floating_point())), tree)


def split_layers(stacked: Sequence[dict], axis: int = 0) -> List[dict]:
    """repro layout (P dicts of leaves stacked over the repeat axis
    ``axis``) -> one dict per layer.  ``axis=1`` splits K-stacked client
    trees, whose leaves are (K, R, ...)."""
    P = len(stacked)
    R = next((np.shape(leaf)[axis] for entry in stacked
              for leaf in _leaves(entry)), 0)
    return [tree_map(lambda v, r=r: np.take(v, r, axis=axis), stacked[p])
            for r in range(R) for p in range(P)]


def stack_layers(layers: Sequence[dict], pattern_len: int, axis: int = 0) -> tuple:
    """Inverse of ``split_layers``: per-layer dicts of numpy leaves ->
    P dicts of leaves stacked over a new repeat axis ``axis``."""
    out = []
    for p in range(pattern_len):
        per_rep = list(layers[p::pattern_len])
        out.append(_stack(per_rep, axis))
    return tuple(out)


def _stack(trees: List[Any], axis: int = 0) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], axis) for k in first}
    return np.stack(trees, axis=axis)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _params_to(tree: Any, device, dtype) -> Any:
    """to_tensor over a params or cache tree; int8 weights and int32
    positions keep their dtype and the ``F32_LEAVES`` stay float32."""
    return _map_named(lambda a, name: to_tensor(a, device, _cast(dtype, name, True)), tree)


def params_from_numpy(params: dict, device="cuda", dtype=None) -> dict:
    """repro params tree (numpy leaves) -> the port's params.  An MoE MLP
    crosses like any other block: ``router.w`` (d, E), ``w_gate``/``w_up``
    (E, d, ff), ``w_down`` (E, ff, d) and a shared expert's ``shared``."""
    return {"embed": _params_to(params["embed"], device, dtype),
            "layers": _params_to(split_layers(params["layers"]), device, dtype),
            "final_norm": _params_to(params["final_norm"], device, dtype)}


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


def lora_to_numpy(lora: Sequence[dict], pattern_len: int) -> tuple:
    """Inverse of ``lora_from_numpy``: per-layer adapters -> repro's
    stacked LoRA tree with numpy leaves."""
    return stack_layers(tree_map(to_numpy, lora), pattern_len)


def _opt_from_numpy(opt: dict, axis: int, device, dtype) -> dict:
    """An optimizer state ({"step", "m", "v"} / {"step", "mu"}) whose moment
    trees follow the adapter layout."""
    return {k: (to_tensor(v, "cpu") if k == "step"
                else tree_map(lambda a: to_tensor(a, device, dtype),
                              split_layers(v, axis)))
            for k, v in opt.items()}


def _opt_to_numpy(opt: dict, pattern_len: int, axis: int) -> dict:
    return {k: (to_numpy(v) if k == "step"
                else stack_layers(tree_map(to_numpy, v), pattern_len, axis))
            for k, v in opt.items()}


def sfl_state_from_numpy(state: dict, device="cuda", dtype=None):
    """repro's ``SflState`` fields as numpy trees (``lora_client``,
    ``lora_server``, ``opt_client``, ``opt_server``, ``step`` and, when
    present and not None, ``err_act``/``err_grad``) -> the port's
    ``core.sfl.SflState``.  Client leaves keep their leading K axis:
    repro's (K, R, ...) becomes one (K, ...) leaf per layer."""
    from .core.sfl import SflState
    conv = lambda a: to_tensor(a, device, dtype)              # noqa: E731
    err = {k: None if state.get(k) is None else to_tensor(state[k], device)
           for k in ("err_act", "err_grad")}
    return SflState(
        lora_client=tree_map(conv, split_layers(state["lora_client"], axis=1)),
        lora_server=tree_map(conv, split_layers(state["lora_server"])),
        opt_client=_opt_from_numpy(state["opt_client"], 1, device, dtype),
        opt_server=_opt_from_numpy(state["opt_server"], 0, device, dtype),
        step=to_tensor(state["step"], "cpu"), **err)


def sfl_state_to_numpy(state, pattern_len: int) -> dict:
    """Inverse of ``sfl_state_from_numpy``: the port's ``SflState`` ->
    repro's field layout with numpy leaves."""
    return {"lora_client": stack_layers(tree_map(to_numpy, state.lora_client),
                                        pattern_len, axis=1),
            "lora_server": lora_to_numpy(state.lora_server, pattern_len),
            "opt_client": _opt_to_numpy(state.opt_client, pattern_len, 1),
            "opt_server": _opt_to_numpy(state.opt_server, pattern_len, 0),
            "step": to_numpy(state.step),
            "err_act": None if state.err_act is None else to_numpy(state.err_act),
            "err_grad": None if state.err_grad is None else to_numpy(state.err_grad)}


def slab_cache_from_numpy(caches: Sequence[dict], device="cuda", dtype=None) -> List[dict]:
    """repro's slab caches (``model.init_cache`` / ``prefill``: a tuple over
    pattern positions of dicts with leaves stacked over repeats) as numpy
    -> one cache dict per layer ({"k", "v", "pos"} or {"ssm", "conv"});
    floats cast to ``dtype`` when given, except the f32 ``ssm`` state;
    positions stay int32."""
    return _params_to(split_layers(caches), device, dtype)


def slab_cache_to_numpy(caches: Sequence[dict], pattern_len: int) -> tuple:
    """Inverse of ``slab_cache_from_numpy``."""
    return stack_layers(tree_map(to_numpy, caches), pattern_len)
