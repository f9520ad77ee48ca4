"""Launch-plan autotuner for the split-K decode kernels, memoized per
process: the port of ``repro.kernels.flash_attention.tune`` (the
``lora_matmul/tune.py`` pattern applied to decode).

``best_decode_block`` (slab caches: ``flash_decode_kernel``,
``flash_decode_q8_kernel``) and ``best_paged_block`` (page pools:
``paged_decode_kernel``, ``paged_decode_q8_kernel``) give the
``plan.DecodePlan`` a launcher hands its C entry.  On a CUDA device, at
the first call for a key, every candidate is timed on the card
(``kernels/autotune.py``) on the caller's own q, K/V and block table,
with a scratch ``lengths`` at full capacity (``repro``'s convention of
timing at full L; no window) into the caller's output before the launch
that counts.  Elsewhere (a CPU or meta device, or within
``backend.abstract_evaluation``) the heuristic ``plan.decode_plan`` is
returned and nothing is launched.  A hit is one dict lookup.

The keys are ``repro``'s: (B, KH, G, L, D) or (B, KH, G, MP, PS, D), q's
dtype and the K/V dtype (the int8-KV pair apart), with the device in
place of ``repro``'s backend string, plus the K/V alignment (the plan's
``vec``).  The paged tuner has its own memo.

The candidates are only plans that sum every output in the heuristic
plan's order, so that no bit changes whatever the timing says:

* float K/V (f32, bf16): ``splits``, ``lanes``, ``vectors`` and ``vec``
  stay the heuristic plan's (``splits`` is not recomputed from the new
  number of units: that would move the cluster ranks' shares); ``heads``
  (GT) may be any smaller power of two, with ``groups`` = ceil(G / GT),
  whose rows in flight (U, ``plan.rows_in_flight``) equal the heuristic
  plan's.  A head's dot, its online softmax and the stream, warp and
  rank merges do not depend on GT (``csrc/decode_split.cuh``), but each
  lane takes its rows in batches of U, rescaling its sums once a batch,
  and U falls as GT * vectors * entries-a-piece grows: so only GT with
  the heuristic's U keep the order.  At 8 heads a block (G 8), and at 4
  in bf16, no smaller GT has the same U, and the heuristic plan is the
  only candidate.
* int8 K/V: GT 1 by the register rule (``plan.INT8_MAX_HEADS``): one
  candidate.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import autotune
from .plan import DecodePlan, decode_plan, rows_in_flight

# key: (B, KH, G, L, D, q dtype, K/V dtype, device, aligned)
_CACHE: Dict[tuple, DecodePlan] = {}
# key: (B, KH, G, MP, PS, D, q dtype, K/V dtype, device, aligned)
_PAGED_CACHE: Dict[tuple, DecodePlan] = {}


def clear_cache() -> None:
    _CACHE.clear()


def clear_paged_cache() -> None:
    _PAGED_CACHE.clear()


def candidates(plan: DecodePlan, G: int, kv_dtype) -> list:
    """``plan`` first, then every plan with fewer heads a block that keeps
    its order of addition (the rule in this module's docstring)."""
    u = rows_in_flight(plan, kv_dtype)
    out, gt = [plan], plan.heads // 2
    while gt >= 1:
        p = DecodePlan(plan.splits, gt, -(-G // gt), plan.lanes, plan.vectors, plan.vec)
        if rows_in_flight(p, kv_dtype) == u:
            out.append(p)
        gt //= 2
    return out


def _zeros_launch(B, KH, G, D, dtype, kv_dtype, device, L=None, MP=None, PS=None):
    """A launch(plan, lengths) over zero operands (for a ``best_*`` call on
    the card without the caller's operands); pools of B * MP + 1 pages
    with slot b's table on pages b * MP + 1 .. (b + 1) * MP."""
    from . import ops
    q = torch.zeros(B, KH, G, D, dtype=dtype, device=device)
    out = torch.empty_like(q)
    s = torch.ones(KH, dtype=torch.float32, device=device)
    scales = (s, s) if kv_dtype == torch.int8 else ()
    if MP is None:
        k = torch.zeros(B, L, KH, D, dtype=kv_dtype, device=device)
        return lambda p, n: ops.launch_slab(q, k, k, n, out, 0, p, *scales)
    kp = torch.zeros(KH, B * MP + 1, PS, D, dtype=kv_dtype, device=device)
    bt = (torch.arange(B * MP, dtype=torch.int32, device=device).reshape(B, MP) + 1)
    return lambda p, n: ops.launch_paged(q, kp, kp, n, bt, out, p, *scales)


def _full(run: Callable, B: int, capacity: int, device) -> Callable:
    """launch(plan) of ``run`` at every slot's full capacity."""
    lengths = torch.full((B,), capacity, dtype=torch.int32, device=device)
    return lambda p: run(p, lengths)


def best_decode_block(B: int, KH: int, G: int, L: int, D: int, dtype=torch.float32,
                      device=None, kv_dtype=None, *, aligned: bool = True,
                      run: Optional[Callable] = None) -> DecodePlan:
    """Memoized plan of one slab decode: q (B, KH, G, D) over K/V (B, L,
    KH, D).  ``kv_dtype`` (default: ``dtype``) keys int8 K/V apart;
    ``aligned`` says K and V start on 16-byte boundaries.  ``run(plan,
    lengths)`` launches the caller's operands with ``plan`` and ``lengths``
    and counts nothing; without it a miss on the card times zeros."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    key = (B, KH, G, L, D, dtype, kv_dtype, device, aligned)
    hit = _CACHE.get(key)
    if hit is None:
        hit, key, device = autotune.normalized(_CACHE, key, 7)
    if hit is not None:
        return hit
    plan = decode_plan(L, B, KH, G, D, kv_dtype, aligned)
    return autotune.choose(
        _CACHE, key, plan, candidates(plan, G, kv_dtype), device,
        lambda: _full(run or _zeros_launch(B, KH, G, D, dtype, kv_dtype, device, L=L),
                      B, L, device),
        "flash_decode tuner")


def best_paged_block(B: int, KH: int, G: int, MP: int, PS: int, D: int,
                     dtype=torch.float32, device=None, kv_dtype=None, *,
                     aligned: bool = True, run: Optional[Callable] = None) -> DecodePlan:
    """Memoized plan of one paged decode: q (B, KH, G, D) over pools of
    ``PS``-position pages, ``MP`` pages a slot; as ``best_decode_block``
    in a memo of its own (capacity MP * PS)."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    key = (B, KH, G, MP, PS, D, dtype, kv_dtype, device, aligned)
    hit = _PAGED_CACHE.get(key)
    if hit is None:
        hit, key, device = autotune.normalized(_PAGED_CACHE, key, 8)
    if hit is not None:
        return hit
    plan = decode_plan(MP * PS, B, KH, G, D, kv_dtype, aligned)
    return autotune.choose(
        _PAGED_CACHE, key, plan, candidates(plan, G, kv_dtype), device,
        lambda: _full(run or _zeros_launch(B, KH, G, D, dtype, kv_dtype, device, MP=MP,
                                           PS=PS), B, MP * PS, device),
        "paged_decode tuner")
