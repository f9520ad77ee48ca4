"""The collectives GSPMD inserts in ``repro``, written out over
``torch.distributed``: all-reduce, all-gather along any dim and an
equal-split all-to-all, each over one mesh axis's process group.

A group of None (a world of one, or an axis the mesh lacks) is the
identity: nothing is exchanged.  A one-rank group still calls the backend.
CUDA tensors go over the group as they are (NCCL), CPU tensors too
(gloo).  A gloo group handed CUDA tensors — two ranks sharing one card,
where NCCL refuses — stages them through host memory: the copy to the
host, the collective, the copy back.  That route is chosen by the group's
backend alone, before the call, and never taken after an error.

Every collective these wrappers issue can be counted (:func:`counting`,
off unless a dry-run switches it on): its kind, count and wire bytes, by
the convention of ``repro``'s HLO cost model (``hlo_cost``): the larger
of its input and output bytes, doubled for an all-reduce (a ring's
reduce-scatter and all-gather), and the group's global ranks, so that a
roofline can charge each call at the rate of the links it crosses.

The all-to-all has a differentiable form, ``all_to_all_grad`` (a
``torch.autograd.Function`` over the same primitive, so the staged route
differentiates too): an equal-split all-to-all is its own transpose.
Tensor parallelism (``sharding.tp``) takes its loss through six more,
each a ``torch.autograd.Function`` whose backward is its forward's
conjugate (Megatron's f and g, and their sequence-parallel and
gather/split pairs):

* ``copy_to``: identity forward, all-reduce backward (a replicated
  tensor entering work split over the group);
* ``reduce_from``: all-reduce forward, identity backward (partial sums
  leaving it);
* ``reduce_scatter_along`` / ``gather_along``: reduce-scatter forward and
  all-gather backward along a dim, and the reverse (``seq_shard``'s
  exits and entries);
* ``split_along`` / ``gather_whole``: this rank's slice forward and
  all-gather backward, and the reverse (a replicated computation's
  entries and exits).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class CollectiveCount:
    """What the wrappers issued while counting: ``calls``, one (kind, wire
    bytes, the group's global ranks) per collective, and per kind its
    count and wire bytes (:meth:`by_kind`)."""

    def __init__(self):
        self.calls: List[Tuple[str, int, Tuple[int, ...]]] = []

    def by_kind(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for kind, nbytes, _ in self.calls:
            slot = out.setdefault(kind, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += nbytes
        return out

    @property
    def bytes(self) -> int:
        return sum(c[1] for c in self.calls)


_COUNT: Optional[CollectiveCount] = None
_RANKS: Dict[object, Tuple[int, ...]] = {}


@contextlib.contextmanager
def counting():
    """Count every collective the wrappers issue within it; yields the
    :class:`CollectiveCount`."""
    global _COUNT
    prev, _COUNT = _COUNT, CollectiveCount()
    try:
        yield _COUNT
    finally:
        _COUNT = prev


def _note(kind: str, group, in_bytes: int, out_bytes: int) -> None:
    if _COUNT is None:
        return
    if group not in _RANKS:
        _RANKS[group] = tuple(dist.get_process_group_ranks(group))
    size = max(in_bytes, out_bytes) * (2 if kind == "all-reduce" else 1)
    _COUNT.calls.append((kind, size, _RANKS[group]))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over the group (a new tensor; ``t`` is left
    as it was)."""
    if group is None:
        return t.clone()
    staged = _staged(t, group)
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    _note("all-reduce", group, _nbytes(buf), _nbytes(buf))
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device) if staged else buf


def all_reduce_tree(tree: Any, group, op: str = "sum") -> Any:
    """All-reduce every leaf of a tree in one collective: the leaves are
    flattened into one f32 buffer of the first leaf's device."""
    leaves = tree_leaves(tree)
    if group is None or not leaves:
        return tree
    flat = torch.cat([v.detach().reshape(-1).float() for v in leaves])
    flat = all_reduce(flat, group, op)
    out, i = [], 0
    for v in leaves:
        out.append(flat[i:i + v.numel()].reshape(v.shape).to(v.dtype))
        i += v.numel()
    return tree_unflatten(tree, out)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (of one shape) concatenated along ``dim`` in
    group-rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    staged = _staged(t, group)
    src = (t.detach().to("cpu") if staged else t.detach()).contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    _note("all-gather", group, _nbytes(src), n * _nbytes(src))
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def all_gather_tree(tree: Any, group, dim: int = 0) -> Any:
    """``all_gather`` of every leaf; scalar leaves stay as they are."""
    if group is None:
        return tree
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, [v if v.dim() == 0 else all_gather(v, group, dim)
                                 for v in leaves])


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all along dim 0: ``t`` (n * c, ...) sends its
    j-th block of c rows to group rank j; the result's i-th block is the
    block rank i sent here."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) is not a multiple of {n}")
    staged = _staged(t, group)
    src = (t.detach().to("cpu") if staged else t.detach()).contiguous()
    out = torch.empty_like(src)
    _note("all-to-all", group, _nbytes(src), _nbytes(out))
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def all_to_all_grad(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`all_to_all`."""
    return t if group is None else _AllToAll.apply(t, group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal piece of ``t`` along ``dim`` (a copy)."""
    n = group_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    c = t.shape[dim] // n
    return t.narrow(dim, _rank(group) * c, c).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the group, this rank's equal piece along
    ``dim``: one ``reduce_scatter_tensor`` over NCCL, an all-reduce and a
    slice over gloo (which has no reduce-scatter of tensors)."""
    if group is None:
        return t
    if dist.get_backend(group) != "nccl":
        return _slice(all_reduce(t, group), group, dim)
    n = group_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _note("reduce-scatter", group, _nbytes(src), _nbytes(out))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward."""
    return t if group is None else _CopyTo.apply(t, group)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    return t if group is None else _ReduceFrom.apply(t, group)


def reduce_scatter_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim`` forward, all-gather backward."""
    return t if group is None else _ReduceScatterAlong.apply(t, group, dim)


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward: the entry
    of split work that each rank differentiates in part."""
    return t if group is None else _GatherAlong.apply(t, group, dim)


def split_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` forward, all-gather backward."""
    return t if group is None else _SplitAlong.apply(t, group, dim)


def gather_whole(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, this rank's piece backward: the
    entry of a computation every rank runs whole and alike."""
    return t if group is None else _GatherWhole.apply(t, group, dim)
