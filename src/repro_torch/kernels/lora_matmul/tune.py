"""Launch-plan autotuner for the LoRA kernels, memoized per process: the
port of ``repro.kernels.lora_matmul.tune``.

``best_blocks`` and ``best_gather_blocks`` give the ``plan.Plan`` that
a launcher hands its C entry.  On a CUDA device, at the first call for
a key, every candidate plan is timed on the card (``kernels/autotune.py``:
CUDA events, the median of a few launches after a warm one, the
heuristic plan kept unless another beats it by more than its spread) on
the caller's own operands, writing into the caller's output before the
launch that counts.  Elsewhere (a CPU or meta device, or within
``backend.abstract_evaluation``) the heuristic plan of ``plan.py`` is
returned, as ``repro``'s tuner picks by a heuristic off the TPU, and
nothing is launched.  A hit is one dict lookup.

The key is ``repro``'s: shape, x dtype and W dtype (an int8 W apart),
with the device in place of ``repro``'s backend string, plus the
operands' 16-byte alignment (the plan's ``vec``), the problem ("forward"
or "dx": ``repro`` reuses the forward's blocks for dX, the port's dX has
plans of its own) and the forward's regime.  M is keyed exactly, as
``repro`` keys it.  The gather has its own memo, keyed also by the pool
size and the index dtype.  The rank reduce is not tuned: its
``rank_reduce_plan`` fixes its order of addition, so it has one
candidate.

The candidates are only plans that sum every output in the heuristic
plan's order, so that whatever the timing says no bit changes: resume,
ranks, processes and two runs stay bit-equal, and nothing needs two
processes to time alike.  Family by family:

* tile regime (the forward and the gather at M > 16; dX, the q8 forward
  and the q8 dX at every M): ``regime``, ``splits`` (from K and N alone,
  ``plan.tile_splits``) and ``vec`` stay the heuristic plan's;
  (``row_tile``, ``col_tile``) may be the other of ``plan.TILE_SHAPES``
  or, where ``vec`` holds, one of ``plan.TUNED_TILES`` (64 x 128, and
  32 x 64 but for the two dX) whose ring holds the partial tile
  (``plan.ring_holds_tile``: not the bf16 q8 forward's 64 x 128).
  ``csrc/lora_mma.cuh`` adds each element's terms in one order whatever
  the tile's shape: 32-deep chunks in order within a split, the splits in
  rank order.
* decode regime (the forward and the gather at M <= 16):
  (``col_tile``, ``splits``) = ``plan.decode_split(K, N)`` fixes the
  order; only ``row_tile`` varies, 8 or 16 where M <= 8 (16 above: a
  block of 8 rows would leave rows out).  A row's sums do not depend on
  the rows beside it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import autotune
from .plan import (DECODE, DECODE_MAX_M, DECODE_ROW_TILES, TILE, TILE_SHAPES, TUNED_TILES,
                   Plan, dx_plan, forward_plan, q8_dx_plan, q8_forward_plan,
                   ring_holds_tile)

FORWARD, DX = "forward", "dx"

# key: (problem, M, K, N, r, x dtype, W dtype, device, aligned, regime)
_CACHE: Dict[tuple, Plan] = {}
# key: (M, K, N, r, pool, x dtype, index dtype, device, aligned)
_GATHER_CACHE: Dict[tuple, Plan] = {}


def clear_cache() -> None:
    _CACHE.clear()
    _GATHER_CACHE.clear()


def heuristic_plan(problem: str, M: int, K: int, N: int, elem_bytes: int, int8_w: bool,
                   aligned: bool, regime: Optional[int] = None) -> Plan:
    """``plan.py``'s plan of one problem: the forward (x (M, K), W (K, N))
    or dX (dY (M, N), W (K, N)), over an f32/bf16 W or an int8 one."""
    if problem == FORWARD:
        if int8_w:
            return q8_forward_plan(M, K, N, elem_bytes, aligned)
        return forward_plan(M, K, N, elem_bytes, aligned, regime)
    if problem == DX:
        return (q8_dx_plan if int8_w else dx_plan)(M, K, N, elem_bytes, aligned)
    raise ValueError(f"unknown problem {problem!r}: {FORWARD!r} or {DX!r}")


def candidates(plan: Plan, M: int, elem_bytes: int, w_bytes: int, rq: bool) -> list:
    """``plan`` first, then every other plan that keeps its order of
    addition (the rule in this module's docstring) and names a kernel the
    C dispatch instantiates.  ``w_bytes``: W's element width (1 for an
    int8 W, which has no decode regime); ``rq``: R is read q-major (dX)."""
    if plan.regime == DECODE:
        rows = [bm for bm in DECODE_ROW_TILES if bm >= M]
        return [plan] + [Plan(DECODE, bm, plan.col_tile, plan.splits, plan.vec)
                         for bm in rows if bm != plan.row_tile]
    shapes = TILE_SHAPES + (TUNED_TILES[rq] if plan.vec else ())
    return [plan] + [Plan(TILE, bm, bn, plan.splits, plan.vec) for bm, bn in shapes
                     if (bm, bn) != (plan.row_tile, plan.col_tile)
                     and ring_holds_tile(elem_bytes, w_bytes, bm, bn, rq)]


def _zeros_launch(problem: str, M, K, N, r, dtype, w_dtype, device, pool=None,
                  idx_dtype=torch.int32) -> Callable:
    """A launch(plan) over zero operands of the problem's shapes (for a
    ``best_*`` call on the card without the caller's operands)."""
    from . import ops
    z = dict(dtype=dtype, device=device)
    int8 = w_dtype == torch.int8
    w = torch.zeros(K, N, dtype=w_dtype, device=device)
    ws = torch.ones(N, dtype=torch.float32, device=device)
    if pool is not None:
        x, out = torch.zeros(M, K, **z), torch.empty(M, N, **z)
        ap, bp = torch.zeros(pool, r, K, **z), torch.zeros(pool, N, r, **z)
        idx = torch.zeros(M, dtype=idx_dtype, device=device)
        return lambda p: ops.launch_gather(x, w, ap, bp, idx, out, 1.0, p)
    a, b = torch.zeros(r, K, **z), torch.zeros(N, r, **z)
    if problem == FORWARD:
        x, out = torch.zeros(M, K, **z), torch.empty(M, N, **z)
        if int8:
            return lambda p: ops.launch_q8(x, w, ws, a, b, out, 1.0, p)
        return lambda p: ops.launch_forward(x, w, a, b, out, 1.0, p)
    dy, out = torch.zeros(M, N, **z), torch.empty(M, K, **z)
    if int8:
        return lambda p: ops.launch_q8_dx(dy, w, ws, a, b, out, 1.0, p)
    return lambda p: ops.launch_dx(dy, w, a, b, out, 1.0, p)


def best_blocks(M: int, K: int, N: int, r: int, dtype=torch.float32, device=None,
                w_dtype=None, *, problem: str = FORWARD, aligned: bool = True,
                regime: Optional[int] = None, run: Optional[Callable] = None) -> Plan:
    """Memoized plan of one LoRA problem: the forward (x (M, K) over W
    (K, N)) or, with ``problem="dx"``, dX (dY (M, N) over W (K, N)), rank
    ``r``.  ``w_dtype`` (default: ``dtype``) keys an int8 W, the q8 pair,
    apart; ``aligned`` says the operands start on 16-byte boundaries;
    ``regime`` forces the forward's regime (the crossover sweep).
    ``run(plan)`` launches the caller's operands with ``plan`` and counts
    nothing; without it a miss on the card times zero operands."""
    w_dtype = dtype if w_dtype is None else w_dtype
    if regime is None and problem == FORWARD and w_dtype != torch.int8:
        regime = DECODE if M <= DECODE_MAX_M else TILE
    key = (problem, M, K, N, r, dtype, w_dtype, device, aligned, regime)
    hit = _CACHE.get(key)
    if hit is None:
        hit, key, device = autotune.normalized(_CACHE, key, 7)
    if hit is not None:
        return hit
    elem, int8 = dtype.itemsize, w_dtype == torch.int8
    plan = heuristic_plan(problem, M, K, N, elem, int8, aligned, regime)
    cands = candidates(plan, M, elem, w_dtype.itemsize, problem == DX)
    return autotune.choose(
        _CACHE, key, plan, cands, device,
        lambda: run or _zeros_launch(problem, M, K, N, r, dtype, w_dtype, device),
        f"lora_matmul {problem} tuner")


def best_gather_blocks(M: int, K: int, N: int, r: int, pool: int, dtype=torch.float32,
                       idx_dtype=torch.int32, device=None, *, aligned: bool = True,
                       run: Optional[Callable] = None) -> Plan:
    """Memoized plan of one multi-tenant forward (x (M, K) over W (K, N),
    a pool of ``pool`` rank-``r`` adapters): the single-adapter forward's
    heuristic plan and candidates, in a memo of its own."""
    key = (M, K, N, r, pool, dtype, idx_dtype, device, aligned)
    hit = _GATHER_CACHE.get(key)
    if hit is None:
        hit, key, device = autotune.normalized(_GATHER_CACHE, key, 7)
    if hit is not None:
        return hit
    plan = forward_plan(M, K, N, dtype.itemsize, aligned)
    cands = candidates(plan, M, dtype.itemsize, dtype.itemsize, False)
    return autotune.choose(
        _GATHER_CACHE, key, plan, cands, device,
        lambda: run or _zeros_launch(FORWARD, M, K, N, r, dtype, dtype, device, pool,
                                     idx_dtype),
        "lora_matmul_gather tuner")
