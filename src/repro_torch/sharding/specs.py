"""Partition rules: params (FSDP x TP), LoRA (replicated), caches, batches
— the port of ``repro.sharding.specs``.

Mesh axes, as in ``repro``:
  single-pod: ("data", "model") = (16, 16)
  multi-pod:  ("pod", "data", "model") = (2, 16, 16)
  SFL:        ("clients",) = (n,)

Policy (``repro``'s baseline):
  * weight matrices: FSDP-shard the d_model-ish dim over "data",
    tensor-parallel the heads/ffn/expert dim over "model"; replicated over
    "pod";
  * LoRA adapters and their optimizer state: replicated;
  * activations / batches: batch dim over ("pod", "data");
  * KV caches: batch over dp; kv-head dim over "model" when divisible, else
    the sequence dim when divisible, else replicated;
  * SFL: the K-client axis over "clients" when K is a multiple of its size.

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (``P``, the stand-in for ``jax.sharding.PartitionSpec``).
Every rule is a pure function of (path, shape, mesh axis sizes); a mesh is
anything with ``.shape`` (axis name -> size) and ``.axis_names``, so the
port's ``launch.mesh.Mesh`` and a stub of (16, 16) read alike.

``repro`` stacks each block leaf over a leading repeat axis (R, ...),
which no rule shards; the port keeps one entry per layer, so its paths
read ``layers/<i>/mixer/wq/w`` with the repeat axis gone.  Its block
leaves go through ``repro``'s regexes with a placeholder repeat axis that
is dropped again, so each port spec is ``repro``'s minus its first entry.

:func:`shard` cuts a rank's local piece of a tensor by its spec and
:func:`unshard` gathers it back, dim by dim, over each axis's group.
"""
from __future__ import annotations

import re
from typing import Any, Iterator, Tuple

import torch

from ..tree import tree_map


class P(tuple):
    """A partition spec: one axis name, tuple of names or None per dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


CLIENT_AXIS = "clients"


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _ok(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _stacked_param_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """``repro``'s rule table, as it reads a stacked tree (block leaves
    (R, ...)); kept verbatim."""
    dp, tp = "data", "model"
    dp_n = mesh.shape.get(dp, 1)
    tp_n = mesh.shape.get(tp, 1)
    ok = _ok

    # ---- embeddings ------------------------------------------------------
    if re.search(r"embed/tok$", path):                    # (V, d)
        return P(tp if ok(shape[0], tp_n) else None,
                 dp if ok(shape[1], dp_n) else None)
    if re.search(r"embed/pos$", path):                    # (S, d)
        return P(None, tp if ok(shape[1], tp_n) else None)
    if re.search(r"embed/unembed$", path):                # (d, V)
        return P(dp if ok(shape[0], dp_n) else None,
                 tp if ok(shape[1], tp_n) else None)

    # ---- attention projections (R, d, out) / (R, in, d) -------------------
    if re.search(r"(wq|wk|wv)/w$", path):
        return P(None, dp if ok(shape[1], dp_n) else None,
                 tp if ok(shape[2], tp_n) else None)
    if re.search(r"wo/w$", path):
        return P(None, tp if ok(shape[1], tp_n) else None,
                 dp if ok(shape[2], dp_n) else None)
    if re.search(r"(wq|wk|wv)/b$", path):
        return P(None, tp if ok(shape[1], tp_n) else None)
    if re.search(r"wo/b$", path):
        return P(None, None)

    # ---- MoE ---------------------------------------------------------------
    if re.search(r"mlp/router/w$", path):                 # (R, d, E)
        return P(None, dp if ok(shape[1], dp_n) else None, None)
    if re.search(r"mlp/w_(gate|up)$", path) and len(shape) == 4:   # (R,E,d,ff)
        return P(None, tp if ok(shape[1], tp_n) else None,
                 dp if ok(shape[2], dp_n) else None, None)
    if re.search(r"mlp/w_down$", path) and len(shape) == 4:        # (R,E,ff,d)
        return P(None, tp if ok(shape[1], tp_n) else None, None,
                 dp if ok(shape[3], dp_n) else None)

    # ---- dense MLP (R, d, ff) / (R, ff, d) ---------------------------------
    if re.search(r"(w_gate|w_up)(/w)?$", path) and len(shape) == 3:
        return P(None, dp if ok(shape[1], dp_n) else None,
                 tp if ok(shape[2], tp_n) else None)
    if re.search(r"w_down(/w)?$", path) and len(shape) == 3:
        return P(None, tp if ok(shape[1], tp_n) else None,
                 dp if ok(shape[2], dp_n) else None)
    if re.search(r"w_up/b$", path):
        return P(None, tp if ok(shape[1], tp_n) else None)
    if re.search(r"w_down/b$", path):
        return P(None, None)

    # ---- Mamba -------------------------------------------------------------
    if re.search(r"mixer/in_proj/w$", path):              # (R, d, total)
        return P(None, dp if ok(shape[1], dp_n) else None,
                 tp if ok(shape[2], tp_n) else None)
    if re.search(r"mixer/out_proj/w$", path):             # (R, d_in, d)
        return P(None, tp if ok(shape[1], tp_n) else None,
                 dp if ok(shape[2], dp_n) else None)
    if re.search(r"mixer/conv_w$", path):                 # (R, W, conv_dim)
        return P(None, None, tp if ok(shape[2], tp_n) else None)
    if re.search(r"mixer/conv_b$", path):
        return P(None, tp if ok(shape[1], tp_n) else None)
    if re.search(r"mixer/norm/scale$", path):             # (R, d_in)
        return P(None, tp if ok(shape[1], tp_n) else None)

    # everything else (norms, A_log, D, dt_bias, shared mlp biases): replicate
    return P(*([None] * len(shape)))


def _drop_repeat(spec_fn, path: str, shape: Tuple[int, ...], mesh) -> P:
    """A per-layer leaf through a stacked rule: placeholder repeat axis in,
    its (never sharded) entry out."""
    return P(*spec_fn(path, (1,) + tuple(shape), mesh)[1:])


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Spec of one leaf of the port's params tree: ``embed/...`` and
    ``final_norm/...`` as in ``repro``, ``layers/<i>/...`` (no repeat
    axis) as ``repro``'s stacked leaf minus its repeat entry."""
    if path.startswith("layers/"):
        return _drop_repeat(_stacked_param_spec, path, shape, mesh)
    return _stacked_param_spec(path, tuple(shape), mesh)


def _stacked_cache_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """``repro``'s cache rules over stacked (R, ...) cache leaves."""
    dp = batch_axes(mesh)
    tp = "model"
    tp_n = mesh.shape.get(tp, 1)
    dp_n = _size(mesh, dp) if dp else 1
    ok = _ok

    if re.search(r"/(k|v)$", path) and len(shape) == 5:   # (R, B, L, KH, hd)
        b_ax = dp if ok(shape[1], dp_n) else None
        if ok(shape[3], tp_n):
            return P(None, b_ax, None, tp, None)
        if ok(shape[2], tp_n):
            return P(None, b_ax, tp, None, None)
        return P(None, b_ax, None, None, None)
    if re.search(r"/pos$", path):                          # (R, L)
        return P(None, None)
    if re.search(r"/ssm$", path) and len(shape) == 5:     # (R, B, nh, hd, N)
        return P(None, dp if ok(shape[1], dp_n) else None,
                 tp if ok(shape[2], tp_n) else None, None, None)
    if re.search(r"/conv$", path) and len(shape) == 4:    # (R, B, W-1, conv)
        return P(None, dp if ok(shape[1], dp_n) else None, None,
                 tp if ok(shape[3], tp_n) else None)
    return P(*([None] * len(shape)))


def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Spec of one slab-cache leaf of the port's per-layer cache list
    (path ``<i>/k``, ``<i>/ssm``, ...; shape without the repeat axis)."""
    return _drop_repeat(_stacked_cache_spec, path, shape, mesh)


def batch_spec(shape: Tuple[int, ...], mesh) -> P:
    """A batch leaf: dim 0 over the data axes when divisible."""
    if len(shape) == 0:
        return P()
    dp = batch_axes(mesh)
    n = _size(mesh, dp) if dp else 1
    first = dp if (n > 1 and shape[0] % n == 0) else None
    return P(first, *([None] * (len(shape) - 1)))


def client_spec(shape: Tuple[int, ...], mesh, stacked_dim: int = 0,
                axis: str = CLIENT_AXIS) -> P:
    """Shard dim ``stacked_dim`` (the K-client axis) over ``axis`` when
    divisible; everything else replicated (``repro``'s ``_client_spec``)."""
    n = mesh.shape.get(axis, 1)
    if len(shape) > stacked_dim and n > 1 and shape[stacked_dim] % n == 0:
        spec = [None] * len(shape)
        spec[stacked_dim] = axis
        return P(*spec)
    return P(*([None] * len(shape)))


def stacked_batch_spec(shape: Tuple[int, ...], mesh) -> P:
    """Pod-mode round batches (I, B, S): the step axis unsharded, the batch
    dim (dim 1) over the data axes."""
    dp = batch_axes(mesh)
    n = _size(mesh, dp) if dp else 1
    if len(shape) >= 2 and n > 1 and shape[1] % n == 0:
        return P(None, dp, *([None] * (len(shape) - 2)))
    return P(*([None] * len(shape)))


def replicated_spec(shape: Tuple[int, ...]) -> P:
    return P(*([None] * len(shape)))


# ---------------------------------------------------------------------------
# tree forms (the port's trees: nested dicts and per-layer lists)
# ---------------------------------------------------------------------------

def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs; a path joins dict keys and list indices by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return None if tree is None else fn(prefix[:-1], tree)


def params_specs(tree: Any, mesh) -> Any:
    return map_with_path(lambda p, v: param_spec(p, tuple(v.shape), mesh), tree)


def cache_specs(tree: Any, mesh) -> Any:
    return map_with_path(lambda p, v: cache_spec(p, tuple(v.shape), mesh), tree)


def lora_specs(tree: Any, mesh=None) -> Any:
    """Adapters (and their optimizer moments and step) are replicated."""
    return tree_map(lambda v: replicated_spec(tuple(v.shape)), tree)


opt_state_specs = lora_specs


def batch_specs(tree: Any, mesh) -> Any:
    return tree_map(lambda v: batch_spec(tuple(v.shape), mesh), tree)


def client_stacked_specs(tree: Any, mesh, axis: str = CLIENT_AXIS) -> Any:
    """(K, ...) leaves — stacked client adapters, their optimizer moments,
    error-feedback accumulators, per-step batches (K, b, S), slot masks,
    per-client vectors and round dynamics: dim 0 over ``axis``; scalars
    replicated."""
    return tree_map(lambda v: client_spec(tuple(v.shape), mesh, 0, axis), tree)


client_batch_specs = client_stacked_specs
client_array_specs = client_stacked_specs
round_dynamics_specs = client_stacked_specs


def round_batch_specs(tree: Any, mesh, axis: str = CLIENT_AXIS) -> Any:
    """Round batches (I, K, b, S): the client axis (dim 1) over ``axis``."""
    return tree_map(lambda v: client_spec(tuple(v.shape), mesh, 1, axis), tree)


def stacked_batch_specs(tree: Any, mesh) -> Any:
    return tree_map(lambda v: stacked_batch_spec(tuple(v.shape), mesh), tree)


def sfl_state_specs(state, mesh, axis: str = CLIENT_AXIS) -> dict:
    """``repro``'s ``sfl_state_shardings`` as specs, by field: the stacked
    client adapter, its moments and the error-feedback accumulators over
    ``axis``; the server adapter, its moments and the step replicated."""
    return {"lora_client": client_stacked_specs(state.lora_client, mesh, axis),
            "lora_server": lora_specs(state.lora_server),
            "opt_client": client_stacked_specs(state.opt_client, mesh, axis),
            "opt_server": lora_specs(state.opt_server),
            "step": P(),
            "err_act": client_stacked_specs(state.err_act, mesh, axis),
            "err_grad": client_stacked_specs(state.err_grad, mesh, axis)}


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coord(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's row-major coordinate over several mesh axes."""
    c = 0
    for a in axes:
        c = c * mesh.shape.get(a, 1) + mesh.axis_rank(a)
    return c


def shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``: a copy with storage of its
    own when cut (a view would keep the whole tensor alive), ``t`` itself
    when the spec shards nothing."""
    out = t
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        n = _size(mesh, axes)
        if n == 1:
            continue
        c = t.shape[d] // n
        out = out.narrow(d, _coord(mesh, axes) * c, c)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def unshard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """Inverse of :func:`shard`: gather the pieces along each sharded dim
    over its axis's group (single-axis entries)."""
    from .collectives import all_gather
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        if len(axes) != 1:
            raise NotImplementedError(f"gathering over the axes {axes} at once")
        if mesh.shape.get(axes[0], 1) > 1:
            t = all_gather(t, mesh.group(axes[0]), d)
    return t


def path_specs(tree: Any, mesh, rule=param_spec) -> dict:
    """{path: spec} of every leaf of a full (unsharded) tree under
    ``rule(path, shape, mesh)``, made once from the whole shapes (a local
    piece's shape no longer tells whether its full dim divided)."""
    return {p: rule(p, tuple(v.shape), mesh) for p, v in tree_paths(tree)}


def cache_piece_specs(caches: Any, mesh) -> list:
    """The spec of every leaf of a whole per-layer slab-cache list (or of
    ``models.model.abstract_cache``'s) by :func:`cache_spec`: k/v cut over
    the KV heads where the "model" axis divides them, else over the cache
    length L; ``ssm`` over its heads and ``conv`` over its channels where
    they divide; the batch over the data axes.  ``pos`` (B, L), one row of
    positions per sequence in the port (``repro`` keeps one row for all),
    follows its layer's k: its rows as k's, its length as k's length."""
    out = []
    for i, layer in enumerate(caches):
        sp = {n: cache_spec(f"{i}/{n}", tuple(v.shape), mesh) for n, v in layer.items()}
        if "pos" in layer:
            sp["pos"] = P(sp["k"][0], sp["k"][1])
        out.append(sp)
    return out


def shard_caches(caches: Any, mesh) -> list:
    """This rank's piece of every leaf of a whole per-layer cache list
    (``meta`` leaves give ``meta`` pieces), by :func:`cache_piece_specs`."""
    specs = cache_piece_specs(caches, mesh)
    return [{n: shard(v, specs[i][n], mesh) for n, v in layer.items()}
            for i, layer in enumerate(caches)]
