"""FSDP of the frozen base over a mesh's ``"data"`` axis — what GSPMD does
with ``repro``'s ``params_shardings`` in the pod step, written out.

Each rank keeps only its (``"data"``, ``"model"``) piece of every leaf
that ``sharding.specs.param_spec`` shards (``wq`` over "data" on d and
over "model" on its heads, ``wo`` the other way round, the tied
``embed/tok`` over "model" on the vocabulary and "data" on d, ...) and
the whole of every other leaf.  ``ShardedParams.view()`` is a params tree
for ``models.model.loss_fn`` whose reads gather over "data":
``view["layers"][i]`` is layer i's ``"model"`` piece (one all-gather per
dtype of its pieces; layer i whole on a mesh without a "model" axis
above 1), alive while it is referenced; ``sharding.tp`` runs on those
pieces.

Backward needs the weights again (dX runs dy·Wᵀ).  With more than one
rank, each layer runs under ``torch.utils.checkpoint`` (``Runtime.remat``,
non-reentrant): the stack reads the layer inside it, so its forward keeps
no gathered weight and its backward recomputes it, gathering the layer
again.  The alternative, ``saved_tensors_hooks`` that swap each saved
gathered weight for a handle and re-gather on unpack, would save the
recompute but must recognise every saved weight, including the
transposes and casts that ``kernels.lora_matmul``'s ``_FusedLoraMatmul``
saves; recomputing the layer needs no such knowledge and keeps at most the
layer being run and the one being recomputed gathered.  It costs one more
forward of the stack per step.  The unembedding's gathered embedding is
kept from the forward to its backward.
"""
from __future__ import annotations

import time
import weakref
from collections.abc import Mapping, Sequence
from typing import Dict, List, Tuple

import torch

from .collectives import all_gather
from .specs import map_with_path, param_spec, path_specs, shard, tree_paths

DATA = "data"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardedParams:
    """A frozen params tree, FSDP-sharded over ``"data"`` (and cut over
    ``"model"`` for ``sharding.tp``).

    ``params``: the whole tree, every rank the same (drawn from one seed),
    on the host or on any device: its sharded leaves are cut to this
    rank's pieces, and the pieces and the other leaves put on
    ``mesh.device``, so the caller may drop the whole tree.
    :meth:`init` draws the tree from a generator and keeps each subtree's
    pieces as it is drawn, so that the whole tree never exists.
    ``gather(prefix)`` returns the subtree at ``prefix``, whole over "data",
    (``"layers/3"``, ``"embed"``, ``"final_norm"``) for the time it is
    referenced; ``live_bytes`` / ``peak_live_bytes`` count the gathered
    bytes alive now / at most, ``gather_seconds`` the host time spent in
    ``gather`` (the collective and the rebuild; a staged gather waits for
    its copies, an NCCL one only for its launch)."""

    def __init__(self, params: dict, mesh):
        self._setup(params, mesh)
        self.local = map_with_path(self._cut, params)

    @classmethod
    def init(cls, cfg, gen: torch.Generator, mesh, dtype=torch.float32) -> "ShardedParams":
        """``models.init_params(cfg, gen, dtype, mesh.device)``, each subtree
        (the embedding, a layer, the final norm) cut to this rank's pieces
        as soon as it is drawn: the device holds this rank's pieces and one
        whole subtree at most.  The same weights as the whole tree's."""
        from ..models.model import abstract_params, init_params
        self = cls.__new__(cls)
        self._setup(abstract_params(cfg, dtype), mesh)
        self.local = init_params(cfg, gen, dtype, mesh.device,
                                 keep=lambda prefix, sub: map_with_path(self._cut, sub,
                                                                        prefix + "/"))
        return self

    @classmethod
    def from_local(cls, whole: dict, local: dict, mesh) -> "ShardedParams":
        """This rank's pieces ``local`` of the tree ``whole`` (its shapes, as
        ``meta`` tensors), taken as they are: the dry-run's fake pieces."""
        self = cls.__new__(cls)
        self._setup(whole, mesh)
        self.local = local
        return self

    def _setup(self, params: dict, mesh) -> None:
        self.mesh = mesh
        self.group = mesh.group(DATA)
        self.n = mesh.shape.get(DATA, 1)
        self.specs = path_specs(params, mesh, param_spec)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.gather_seconds = 0.0

    def _cut(self, path: str, v: torch.Tensor) -> torch.Tensor:
        return shard(v, self.specs[path], self.mesh).to(self.mesh.device)

    def _data_dim(self, path: str):
        """The dim the rule table cuts over "data", or None."""
        return next((d for d, e in enumerate(self.specs[path])
                     if e == DATA or (isinstance(e, tuple) and DATA in e)), None)

    def _sharded(self, path: str) -> bool:
        """Whether this rank holds a "data" piece of the leaf."""
        return self.n > 1 and self._data_dim(path) is not None

    # ---- accounting ---------------------------------------------------------
    def resident_bytes(self) -> int:
        """Bytes of frozen weights this rank holds: the storages its leaves
        keep alive, each once (a view would count its whole base)."""
        storages = {}
        for _, v in tree_paths(self.local):
            st = v.untyped_storage()
            storages[(v.device, st.data_ptr())] = st.nbytes()
        return sum(storages.values())

    def rule_bytes(self) -> Tuple[int, int]:
        """(bytes of the leaves the rule table shards over "data", of the
        others), each leaf's "model" piece, whole over "data"."""
        sh = rep = 0
        for p, v in tree_paths(self.local):
            if self._sharded(p):
                sh += _nbytes(v) * self.n
            else:
                rep += _nbytes(v)
        return sh, rep

    def gathered_bytes(self, prefix: str) -> int:
        """Bytes of the subtree at ``prefix``'s "data"-sharded leaves as a
        gather gives them (their "model" pieces)."""
        return sum(_nbytes(v) * self.n for p, v in tree_paths(self._sub(prefix), prefix + "/")
                   if self._sharded(p))

    def _sub(self, prefix: str):
        t = self.local
        for k in prefix.split("/"):
            t = t[int(k)] if isinstance(t, list) else t[k]
        return t

    # ---- gathering ----------------------------------------------------------
    def view(self) -> "_View":
        """The params tree for ``models.model.loss_fn``: ``view["embed"]``,
        ``view["final_norm"]`` and ``view["layers"][i]`` gather that
        subtree each time they are read."""
        return _View(self)

    def gather(self, prefix: str):
        """The subtree at ``prefix``, whole over "data": one all-gather per
        dtype of its "data"-sharded leaves' pieces, each leaf rebuilt
        along its "data" dim (a leaf cut over "model" stays this rank's
        piece)."""
        sub = self._sub(prefix)
        paths = [(p, v) for p, v in tree_paths(sub, prefix + "/") if self._sharded(p)]
        if not paths:
            return sub
        t0 = time.perf_counter()
        whole: Dict[str, torch.Tensor] = {}
        by_dtype: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
        for p, v in paths:
            by_dtype.setdefault(v.dtype, []).append((p, v))
        for items in by_dtype.values():
            flat = torch.cat([v.reshape(-1) for _, v in items])
            parts = all_gather(flat, self.group).reshape(self.n, flat.numel())
            off = 0
            for p, v in items:
                dim = self._data_dim(p)
                pieces = [parts[r, off:off + v.numel()].reshape(v.shape) for r in range(self.n)]
                whole[p] = torch.cat(pieces, dim=dim)
                off += v.numel()
        for t in whole.values():
            self._track(t)
        self.gather_seconds += time.perf_counter() - t0
        return map_with_path(lambda p, v: whole.get(p, v), sub, prefix + "/")

    def _track(self, t: torch.Tensor) -> None:
        nb = _nbytes(t)
        self.live_bytes += nb
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(t, self._release, nb)

    def _release(self, nb: int) -> None:
        self.live_bytes -= nb


class _Layers(Sequence):
    """``view["layers"]``: indexing gathers the layer, slicing stays lazy."""

    def __init__(self, sp: ShardedParams, idx: range):
        self.sp, self.idx = sp, idx

    def __len__(self) -> int:
        return len(self.idx)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _Layers(self.sp, self.idx[i])
        return self.sp.gather(f"layers/{self.idx[i]}")


class _View(Mapping):
    def __init__(self, sp: ShardedParams):
        self.sp = sp

    def __getitem__(self, k: str):
        if k == "layers":
            return _Layers(self.sp, range(len(self.sp.local["layers"])))
        return self.sp.gather(k)

    def __iter__(self):
        return iter(self.sp.local)

    def __len__(self) -> int:
        return len(self.sp.local)
