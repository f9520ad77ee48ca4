"""The launch plans of the forward LoRA matmul (``csrc/lora_matmul.cu``,
both entries), of its dX and rank reduce (``csrc/lora_matmul_bwd.cu``) and
of the int8-base pair (``csrc/lora_matmul_q8.cu``).

The plan is computed here, in Python, so that the CPU tests can hold its
rules; the CUDA launchers take it as it is and check only that it names
an instantiated kernel.

Two regimes, chosen by M alone (the same rule for the single-adapter and
the gather entry):

* **decode** (M <= ``DECODE_MAX_M``): bound by reading W once.  A column
  tile of ``col_tile`` columns is split along K over ``splits`` blocks of
  one thread-block cluster; each thread owns 4 neighbouring columns and a
  ``row_tile`` of 8 or 16 rows.  The order in which a row's terms are
  summed follows from (``splits``, ``col_tile``) and K alone, and those
  depend on (K, N) only.
* **tile** (M > ``DECODE_MAX_M``, every dX and the q8 pair at every
  M): TF32 ``mma.sync``
  tiles on a ``cp.async`` ring, the reduction split over ``splits``
  blocks of a cluster.  A row's terms are summed along the reduction in
  32-deep chunks in order within a split and the splits in rank order,
  whatever the tile shape: ``splits`` depends on (K, N) only, and
  (``row_tile``, ``col_tile``) are chosen for the block count alone.

So a row's arithmetic depends on the regime, K and N, never on M within a
regime or on the other rows, and a gathered row is bit-equal to the
single-adapter kernel on that row in the same regime.

The rank reduce (``rank_reduce_plan``) has one regime: the rank padded
to a power of two, the columns each thread reads, and M split over the
blocks of one cluster by M alone.

``vec`` picks 16-byte copies where every row pitch the kernel streams is
a multiple of 16 bytes and every base pointer is 16-byte aligned, and
element copies (4 bytes in f32, 1 for an int8 W) otherwise.  The copy
width never changes the arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..limits import MAX_CLUSTER as MAX_SPLITS, SMS     # MAX_SPLITS: blocks along K

DECODE_MAX_M = 16       # T: the largest M served by the decode regime
MIN_SPLIT_ROWS = 64     # each decode split keeps at least this many rows of K
MIN_TILE_SPLIT_ROWS = 128   # each tile split: 4 chunks of 32 through its ring
DECODE_COL_TILES = (128, 64, 32)
TILE_SHAPES = ((64, 64), (32, 32))      # (rows, columns) of the mma tile
DECODE, TILE = 0, 1


@dataclass(frozen=True)
class Plan:
    regime: int         # DECODE or TILE
    row_tile: int       # rows per block
    col_tile: int       # output columns per block
    splits: int         # blocks along the reduction in one cluster
    vec: bool           # 16-byte copies (else element copies)


def decode_split(K: int, N: int):
    """(col_tile, splits) of the decode regime: the widest column tile
    whose grid reaches one block per SM with at most ``MAX_SPLITS`` splits
    (a power of two, each split >= ``MIN_SPLIT_ROWS`` rows of K), with the
    fewest splits that do; else the narrowest tile with its most splits.
    One wave of wide blocks, each streaming a long run of W with 8 rows in
    flight per thread, leaves no partial second wave.  Depends on (K, N)
    only."""
    cap = 1
    while cap < MAX_SPLITS and (cap * 2) * MIN_SPLIT_ROWS <= K:
        cap *= 2
    for bn in DECODE_COL_TILES:
        tiles = -(-N // bn)
        s = 1
        while s < cap and tiles * s < SMS:
            s *= 2
        if tiles * s >= SMS:
            return bn, s
    return DECODE_COL_TILES[-1], cap


def tile_splits(Q: int, P: int) -> int:
    """Blocks along the reduction Q of the mma tile (one cluster): the
    fewest (a power of two, at most ``MAX_SPLITS``, each split at least
    ``MIN_TILE_SPLIT_ROWS`` deep) whose 64-column tiles of the P outputs
    reach two blocks per SM in one row of tiles.  Depends on (Q, P) only,
    so that a row's order of addition does not depend on M."""
    tiles = -(-P // 64)
    s = 1
    while (s < MAX_SPLITS and tiles * s < 2 * SMS
           and Q // (2 * s) >= MIN_TILE_SPLIT_ROWS):
        s *= 2
    return s


def tile_shape(M: int, P: int, splits: int):
    """(row_tile, col_tile) of the mma tile for an (M, P) output: the
    largest whose grid (with ``splits``) has one block per SM, else the
    smallest."""
    for bm, bn in TILE_SHAPES:
        if -(-M // bm) * -(-P // bn) * splits >= SMS:
            return bm, bn
    return TILE_SHAPES[-1]


def _vec(elem_bytes: int, pitches, aligned: bool) -> bool:
    per = 16 // elem_bytes
    return aligned and all(p % per == 0 for p in pitches)


def forward_plan(M: int, K: int, N: int, elem_bytes: int = 4,
                 aligned: bool = True, regime: int = None) -> Plan:
    """The plan of ``lora_matmul`` (and of its gather) for x (M, K), W
    (K, N) of ``elem_bytes``-byte elements; ``aligned`` says every operand
    starts on a 16-byte boundary.  ``regime`` forces a regime (for the
    crossover sweep); by default M picks it."""
    if regime is None:
        regime = DECODE if M <= DECODE_MAX_M else TILE
    if regime == DECODE:
        bn, s = decode_split(K, N)
        return Plan(DECODE, 8 if M <= 8 else 16, bn, s, _vec(elem_bytes, (N,), aligned))
    s = tile_splits(K, N)
    bm, bn = tile_shape(M, N, s)
    return Plan(TILE, bm, bn, s, _vec(elem_bytes, (K, N), aligned))


def dx_plan(M: int, K: int, N: int, elem_bytes: int = 4, aligned: bool = True) -> Plan:
    """The plan of ``lora_matmul_dx`` for dY (M, N), W (K, N): always the
    tile, over a (M, K) output, reducing over N, streaming rows of pitch N."""
    s = tile_splits(N, K)
    bm, bn = tile_shape(M, K, s)
    return Plan(TILE, bm, bn, s, _vec(elem_bytes, (N,), aligned))


def q8_forward_plan(M: int, K: int, N: int, elem_bytes: int = 4,
                    aligned: bool = True) -> Plan:
    """The plan of ``lora_matmul_q8`` for x (M, K) of ``elem_bytes``-byte
    elements over an int8 W_q (K, N): always the tile (no engine serves an
    int8 base, so there is no decode regime to choose), reducing over K.
    It streams rows of x (pitch K elements) and of W_q (N bytes)."""
    s = tile_splits(K, N)
    bm, bn = tile_shape(M, N, s)
    return Plan(TILE, bm, bn, s, _vec(elem_bytes, (K,), aligned) and _vec(1, (N,), aligned))


def q8_dx_plan(M: int, K: int, N: int, elem_bytes: int = 4, aligned: bool = True) -> Plan:
    """The plan of ``lora_matmul_q8_dx`` for dY (M, N) over W_q (K, N):
    the tile over a (M, K) output, reducing over N, streaming rows of dY
    (pitch N elements) and of W_q (N bytes) and the f32 scale along N."""
    s = tile_splits(N, K)
    bm, bn = tile_shape(M, K, s)
    return Plan(TILE, bm, bn, s, _vec(elem_bytes, (N,), aligned) and _vec(1, (N,), aligned))


RR_MAX_ACC = 64             # f32 accumulators a rank-reduce thread holds
RR_MIN_SPLIT_ROWS = 64      # each rank-reduce split keeps at least this many rows


@dataclass(frozen=True)
class RankReducePlan:
    rank_pad: int       # RP: the smallest power of two >= r; u is staged padded to it
    cols: int           # C: neighbouring columns of v a thread reads in one load
    splits: int         # blocks along M in one cluster
    vec: bool           # one C-element load (else C element loads)


def rank_reduce_plan(M: int, r: int, N: int, v_dtype, aligned: bool = True) -> RankReducePlan:
    """The plan of ``lora_rank_reduce`` for u (M, r) f32 and v (M, N) of
    ``v_dtype`` (float32 or bfloat16); ``aligned`` says v starts on a
    16-byte boundary.  Each thread holds ``cols * rank_pad`` f32 sums, at
    most ``RR_MAX_ACC``: 16 bytes of columns (4 f32, 8 bf16) at ranks up to
    16 (bf16: 8), fewer at larger ranks.  M goes to the most splits (a
    power of two, at most ``MAX_SPLITS``) that keep ``RR_MIN_SPLIT_ROWS``
    rows each, so the order of every addition depends on (M, r, N, dtype)
    only."""
    rp = 1
    while rp < r:
        rp *= 2
    cols = min(16 // v_dtype.itemsize, RR_MAX_ACC // rp)
    s = 1
    while s < MAX_SPLITS and M // (2 * s) >= RR_MIN_SPLIT_ROWS:
        s *= 2
    return RankReducePlan(rp, cols, s, cols > 1 and aligned and N % cols == 0)

