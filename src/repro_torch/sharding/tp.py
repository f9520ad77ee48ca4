"""Tensor parallelism over a mesh's ``"model"`` axis — what GSPMD does with
the ``"model"`` placements of ``repro``'s rule table in the pod step,
written out (``sharding.fsdp`` is the same for ``"data"``).

A rank holds its ``"model"`` piece of every leaf ``sharding.specs.
param_spec`` cuts there, and the model functions run on those pieces
when ``Runtime.tp_axis`` names the axis: mode "train" and the serving
modes "prefill" and slab "decode".  There is one path per mode:
``models.stack.apply_block``, ``models.attention.self_attention``/
``decode_attention``, ``models.layers.apply_mlp``/``embed``/``unembed``,
``models.moe.apply_moe``, ``models.ssm.mamba_block``/``mamba_step`` and
``models.model.cross_entropy`` take the axis (``WHOLE`` when there is
none, where every collective here is the identity and every leaf whole)
and branch on whether a leaf is cut, read from its shape against the
config's whole one, as the rule table cuts a dim only where the axis
size divides it.  This module holds what they share:

* ``TensorParallel``: the axis; ``tp_of`` reads it from a ``Runtime``.
* ``Entry``: a block input (whole rows, or with ``Runtime.seq_shard`` in
  mode "train", S % 128 == 0 as in ``repro``, this rank's piece of the
  sequence) as split and whole work take it, and the way back out.
  Every entry into and exit from work split over the axis is one of the
  conjugate pairs of ``sharding.collectives``: a replicated activation
  entering split work goes through ``copy_to`` (``gather_along`` when it
  is cut on the sequence), entering work every rank runs whole and alike
  through nothing (``gather_whole``); partial sums leave through
  ``reduce_from`` (``reduce_scatter_along``), whole results through
  nothing (``split_along``).
* ``col_lora``/``row_lora``: the replicated LoRA as a column-parallel
  dense (W's output dim cut: ``wq``/``wk``/``wv``, ``w_gate``/``w_up``)
  or a row-parallel one (input dim cut: ``wo``, ``w_down``) takes it.
  The factor a piece sees whole enters through ``copy_to`` (its gradient,
  partial on each rank, is summed), the one it sees a slice of through
  ``split_along`` (the slices' gradients are gathered), so every rank
  ends the backward with the whole dA and dB, as ``repro`` replicates the
  LoRA (``specs.py`` ``lora_shardings``).  A row-parallel bias is added
  once, after the sum (``Entry.exit``).
* ``gather_cut``: a subtree's pieces gathered whole — the Mamba mixer,
  whose contiguous cut of ``in_proj``'s z|x|B|C|dt does not fall on heads
  (``ROADMAP.md``: head-parallel Mamba).

Attention runs on local heads where the cut falls on whole KV groups
(KH % tp == 0); else q/k/v are gathered and attention runs whole on every
rank, each then taking its slice of the heads for ``wo``.  MoE experts
lie over the axis (``models.moe``).  The embeddings are vocab-parallel:
a masked lookup summed over the axis; the logits of a cut vocabulary stay
in pieces and the cross entropy takes max and sum-exp over the axis, so
no rank holds (B, S, V); ``embed/pos`` is cut over d and gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .collectives import (all_gather, all_reduce, copy_to, gather_along, gather_whole,
                          reduce_from, reduce_scatter_along, split_along)


@dataclass(frozen=True)
class TensorParallel:
    """The axis a ``Runtime`` splits over: its process group (None: no
    axis), size and this rank's coordinate."""
    group: Optional[object]
    n: int
    rank: int


WHOLE = TensorParallel(None, 1, 0)


def tp_of(rt) -> TensorParallel:
    """The ``Runtime``'s tensor-parallel axis; ``WHOLE`` when it names none
    or the axis has one rank (every leaf whole)."""
    if rt.tp_axis is None:
        return WHOLE
    if rt.mesh is None:
        raise ValueError(f"Runtime(tp_axis={rt.tp_axis!r}) needs the mesh (Runtime.mesh)")
    n = rt.mesh.shape.get(rt.tp_axis, 1)
    if n == 1:
        return WHOLE
    return TensorParallel(rt.mesh.group(rt.tp_axis), n, rt.mesh.axis_rank(rt.tp_axis))


def seq_sharded(rt, tp: TensorParallel, S: int) -> bool:
    """Whether the activations between blocks are cut on the sequence."""
    return tp.n > 1 and rt.seq_shard and S % 128 == 0 and S % tp.n == 0


def is_cut(t: torch.Tensor, dim: int, whole: int) -> bool:
    """Whether ``t`` is a piece of a leaf whose dim ``dim`` is ``whole``."""
    return t.shape[dim] != whole


class Entry:
    """A block input h (whole rows, or this rank's piece of the sequence
    when ``seq``), as the two kinds of work take it: ``par()`` for work
    split over the axis (its gradient summed), ``rep()`` for work every
    rank runs whole and alike.  Each is made once, at first use.  Over
    ``WHOLE`` both are h and ``exit`` only adds."""

    def __init__(self, h, tp: TensorParallel = WHOLE, seq: bool = False):
        self.h, self.tp, self.seq = h, tp, seq
        self._par = self._rep = None

    def par(self):
        if self._par is None:
            g = self.tp.group
            self._par = gather_along(self.h, g, 1) if self.seq else copy_to(self.h, g)
        return self._par

    def rep(self):
        if self._rep is None:
            self._rep = gather_whole(self.h, self.tp.group, 1) if self.seq else self.h
        return self._rep

    def exit(self, partial=None, whole=None, bias=None):
        """The output in the input's layout from the partial sums of split
        work and the result of whole work (either may be None); ``bias``
        is added once, after the sum."""
        g = self.tp.group
        out = None
        if partial is not None:
            out = reduce_scatter_along(partial, g, 1) if self.seq else reduce_from(partial, g)
        if bias is not None:
            out = out + bias.to(out.dtype)
        if whole is not None:
            w = split_along(whole, g, 1) if self.seq else whole
            out = w if out is None else out + w
        return out


def col_lora(lora, tp: TensorParallel):
    """A replicated adapter as a column-parallel dense takes it: A whole,
    this rank's rows of B."""
    if lora is None:
        return None
    return {"a": copy_to(lora["a"], tp.group), "b": split_along(lora["b"], tp.group, 0)}


def row_lora(lora, tp: TensorParallel):
    """A replicated adapter as a row-parallel dense takes it: this rank's
    columns of A, B whole."""
    if lora is None:
        return None
    return {"a": split_along(lora["a"], tp.group, 1), "b": copy_to(lora["b"], tp.group)}


def gather_cut(p: dict, whole: dict, tp: TensorParallel) -> dict:
    """The subtree ``p`` with every leaf that is a piece of its ``whole``
    (meta) twin gathered along the cut dim (frozen weights: no
    gradient)."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = gather_cut(v, whole[k], tp)
            continue
        dims = [i for i, (a, b) in enumerate(zip(v.shape, whole[k].shape)) if a != b]
        out[k] = all_gather(v, tp.group, dims[0]) if dims else v
    return out


def piece(t: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """This rank's equal piece of ``t`` along ``dim``, a copy (no gradient:
    the serving caches)."""
    c = t.shape[dim] // tp.n
    return t.narrow(dim, tp.rank * c, c).contiguous()


def owned_slot(slot: torch.Tensor, n_local: int, tp: TensorParallel):
    """For whole-cache entries ``slot`` (B,) of a cache cut over its length
    into pieces of ``n_local`` entries: (the entry's index in this rank's
    piece, clamped into it; whether this rank's piece holds it)."""
    lo = tp.rank * n_local
    own = (slot >= lo) & (slot < lo + n_local)
    return (slot - lo).clamp(0, n_local - 1), own


def lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                tp: TensorParallel) -> torch.Tensor:
    """The softmax-weighted sum over every rank's keys from each rank's
    partial over its piece: ``m`` (...) its largest score, ``l`` (...) the
    sum of exp(s - m) and ``o`` (..., D) the unnormalised sum of exp(s - m)
    v, all f32 (a piece with no live key has l = 0 and o = 0).  One
    all-reduce max and one all-reduce sum of (l, o) rescaled to the
    common max."""
    M = all_reduce(m, tp.group, "max")
    w = torch.exp(m - M)
    tot = all_reduce(torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1), tp.group)
    return tot[..., 1:] / tot[..., :1]
