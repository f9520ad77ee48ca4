"""The cost of one step by abstract evaluation — the port's counterpart
to ``repro``'s ``analysis.hlo_cost`` (which reads XLA's HLO text and so
stays with XLA).

:func:`measure` runs a step once on fake tensors (``torch._subclasses.
FakeTensorMode``: shapes, dtypes and a device, no data and no memory)
and counts, per device:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over every op
  dispatched; a hand-written kernel counts through its FLOP formula
  (``kernels.backend.register``), so the count is the same whichever
  route computes it;
* bytes: the operand and result bytes of every op dispatched.  This is
  the port's eager traffic: each op reads its inputs and writes its
  outputs in memory, with no fusion (XLA's count fuses elementwise chains
  and is smaller).  An op whose result is a view of an input (a reshape,
  a slice, a transpose), an allocation or a metadata query moves nothing;
  a gather reads only the rows it returns; an op that writes into an
  argument in place (a cache update) counts its other inputs read and as
  many bytes written (``_moved``);
* collectives: every collective the ``sharding.collectives`` wrappers
  issue, its kind, count and wire bytes (``hlo_cost``'s convention) and
  the ranks of its group;
* memory: the bytes of the arguments' storages, of the results' storages
  that are not the arguments', and the peak of live storage beyond the
  arguments (each storage counted once while any tensor holds it).
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import backend
from ..sharding.collectives import counting


@dataclass
class StepCost:
    flops: float
    bytes: float
    coll_calls: List[tuple]               # (kind, wire bytes, group ranks) per call
    coll: Dict[str, dict]                 # kind -> {"count", "bytes"}
    coll_bytes: float
    argument_bytes: int
    output_bytes: int
    peak_bytes: int                       # live beyond the arguments, at most
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def temp_bytes(self) -> int:
        """The peak beyond the arguments less the results: XLA's
        ``temp_size_in_bytes``."""
        return max(0, self.peak_bytes - self.output_bytes)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> Dict[int, int]:
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


# ops that move no bytes: allocations, views under another name, metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view", "lift_fresh", "detach", "alias", "_local_scalar_dense"}
# ops that read only the rows they return
_GATHERS = {"index", "index_select", "gather", "embedding"}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _moved(func, args, kwargs, out) -> int:
    """The bytes ``func`` moves, eagerly: its tensor inputs read and its
    outputs written.  Views, allocations and metadata move nothing; a
    collective is counted as one (``sharding.collectives``); a gather
    reads only the rows it returns (and its indices); an op writing into
    an argument in place counts its other inputs read and as many bytes
    written, at most the target's."""
    if func.namespace in ("prim", "c10d", "_c10d_functional"):
        return 0
    name = func.overloadpacket.__name__
    rets = func._schema.returns
    if name in _FREE or not _tensors(out) or (
            rets and all(r.alias_info is not None and not r.alias_info.is_write
                         for r in rets)):
        return 0
    if name in _GATHERS:
        return 2 * _nbytes(_tensors(out)) + _nbytes(_tensors(args[1:]))
    written = [a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write]
    if written:
        names = [a.name for a in func._schema.arguments]
        bound = dict(zip(names, args), **kwargs)
        targets = _tensors([bound.get(n) for n in written])
        read = _nbytes(_tensors([v for k, v in bound.items() if k not in written]))
        return read + min(_nbytes(targets), read)
    return _nbytes(_tensors((args, kwargs, out)))


class _Traffic(TorchDispatchMode):
    """Bytes every op moves, and the live storages it leaves."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.by_op: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(args):
            self._seen[t.untyped_storage()] = 0      # the arguments: not counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        nb = _moved(func, args, kwargs or {}, out)
        if nb:
            self.bytes += nb
            key = str(func.overloadpacket)
            self.by_op[key] = self.by_op.get(key, 0) + nb
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            nb = st.nbytes()
            self._seen[st] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, nb)
        return out

    def _free(self, nb: int) -> None:
        self.live -= nb


def measure(step: Callable[..., Any], args: tuple) -> tuple:
    """Run ``step(*args)`` once on fake tensors ``args`` (made under a
    ``FakeTensorMode`` that is active around this call) and count it ->
    (its result, :class:`StepCost`).  Kernels take their abstract route
    (``kernels.backend``); a plain version never runs."""
    from torch.utils.flop_counter import FlopCounterMode
    backend.define_ops()
    t0 = time.perf_counter()
    traffic = _Traffic(args)
    with FlopCounterMode(display=False) as fc, counting() as cc, \
            backend.abstract_evaluation(), traffic:
        out = step(*args)
    arg_st = _storage_bytes(_tensors(args))
    out_st = {k: v for k, v in _storage_bytes(_tensors(out)).items() if k not in arg_st}
    by_op = {str(k): float(v) for k, v in fc.get_flop_counts().get("Global", {}).items()}
    cost = StepCost(flops=float(fc.get_total_flops()), bytes=float(traffic.bytes),
                    coll_calls=list(cc.calls), coll=cc.by_kind(), coll_bytes=float(cc.bytes),
                    argument_bytes=sum(arg_st.values()), output_bytes=sum(out_st.values()),
                    peak_bytes=traffic.peak, flops_by_op=by_op,
                    bytes_by_op={k: float(v) for k, v in traffic.by_op.items()},
                    seconds=time.perf_counter() - t0)
    return out, cost
