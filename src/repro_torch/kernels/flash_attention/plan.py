"""The launch plans of the decode kernels: ``decode_plan`` for
``csrc/flash_decode.cu`` and ``csrc/paged_decode.cu`` (f32/bf16 K/V and
int8 K/V, one body in ``csrc/decode_split.cuh``), ``partial_plan`` for
``csrc/decode_partial.cu`` (the partial softmax over a piece of a cache
cut by its length).

The plan is computed here, in Python, so that the CPU tests can hold its
rules; the CUDA launchers take it as it is and check only that it names
an instantiated kernel.

One cluster of ``splits`` blocks serves each (slot, KV head, head group)
unit; each block takes an equal share of the slot's live 32-position
tiles, which it finds from the slot's length on the card.  The host picks
the split from what it knows without reading device memory: the cache
capacity (slab L, or MP * PS), the number of units and the SM count.

A row of D entries is read by ``lanes`` lanes with 16-byte loads: its
16-byte pieces (4 f32, 8 bf16 or 16 int8 entries: the K/V dtype decides,
not q's) rounded up to a power of two, at most 32, and ``vectors`` pieces
a lane (2 only for f32 rows over 512 bytes).  ``vec`` picks the 16-byte
loads where D fills whole pieces and both K and V start on a 16-byte
boundary, and entry-by-entry loads otherwise; the load width never
changes the arithmetic.

The register rule: a lane keeps q and the output accumulator of its
``heads`` query heads in registers, ``heads * vectors * per`` floats each
(per = entries a piece).  Float K/V take up to ``MAX_HEADS`` = 8 heads
(at most 64 floats each: f32 at two pieces, bf16 at one).  Int8 K/V
take ``INT8_MAX_HEADS`` = 1, so ``heads * vectors * per <= 16``: each
16-entry piece also unpacks to 16 floats of K and 16 of V beside them,
and at 2 heads ptxas spilled.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..limits import MAX_CLUSTER as MAX_SPLITS, SMS

TILE = 32               # positions of a tile, the unit a block's share is cut in
MAX_HEADS = 8           # query heads one block serves over float K/V
INT8_MAX_HEADS = 1      # ... over int8 K/V (the register rule above)
DECODE_MAX_HEAD_DIM = 256   # f32: 32 lanes x 2 pieces x 4 entries; bf16: 32 x 1 x 8;
                            # int8: 16 lanes x 1 x 16


# rows of K and V a lane has in flight (U, ``rows_in_flight`` in
# csrc/decode_split.cuh): at most the element policy's MAX_ROWS, fewer
# where q and acc take more registers
MAX_ROWS = {4: 8, 2: 8, 1: 2}       # by K/V entry width: FloatKV f32, bf16; Int8KV


@dataclass(frozen=True)
class DecodePlan:
    splits: int         # S: blocks along the cache in one cluster
    heads: int          # GT: query heads a block serves (a power of two)
    groups: int         # blocks along the G query heads of a KV head
    lanes: int          # lanes that read one row (a power of two, <= 32)
    vectors: int        # 16-byte pieces of a row a lane holds (1 or 2)
    vec: bool           # 16-byte loads (else entry by entry)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def rows_in_flight(plan: DecodePlan, kv_dtype) -> int:
    """U of the kernel ``plan`` names over K/V entries of ``kv_dtype``:
    each lane's online softmax takes its rows in batches of U, so U, like
    the split, fixes the order of a head's sums."""
    per = 16 // kv_dtype.itemsize
    n = plan.heads * plan.vectors * per
    return min(8 if n <= 16 else 4 if n <= 32 else 2, MAX_ROWS[kv_dtype.itemsize])


def decode_plan(capacity: int, B: int, KH: int, G: int, D: int, kv_dtype,
                aligned: bool = True) -> DecodePlan:
    """The plan of ``flash_decode_kernel``/``flash_decode_q8_kernel``
    (capacity L) and ``paged_decode_kernel``/``paged_decode_q8_kernel``
    (capacity MP * PS) for q (B, KH, G, D) over K/V entries of
    ``kv_dtype`` (float32, bfloat16 or int8); ``aligned`` says K and V
    start on a 16-byte boundary.  The split is the fewest blocks (a power
    of two, at most ``MAX_SPLITS``, no more than the capacity's tiles) that
    give the grid two blocks per SM, so every block's share of a long slot
    stays a few batches of rows."""
    per = 16 // kv_dtype.itemsize           # entries of a 16-byte piece
    if not 1 <= D <= DECODE_MAX_HEAD_DIM:
        raise ValueError(f"decode_plan: head dim {D} outside [1, {DECODE_MAX_HEAD_DIM}]")
    pieces = _pow2_at_least(-(-D // per))
    lanes = min(pieces, 32)
    heads = min(INT8_MAX_HEADS if per == 16 else MAX_HEADS, _pow2_at_least(G))
    groups = -(-G // heads)
    units = B * KH * groups
    tiles = -(-capacity // TILE)
    s = 1
    while s < MAX_SPLITS and 2 * s <= tiles and units * s < 2 * SMS:
        s *= 2
    return DecodePlan(s, heads, groups, lanes, pieces // lanes,
                      aligned and D % per == 0)


PARTIAL_TILE = 16       # positions of a tile (PT in csrc/decode_partial.cu)
PARTIAL_HEADS = 8       # query heads a block serves: the N of its products (PH)
PARTIAL_MAX_WARPS = 4   # MAX_WARPS: warps of a block
PARTIAL_MAX_STAGES = 3  # MAX_STAGES: ring stages a warp
# a block's shared memory when two share an SM: 228 KB less 1 KB reserved a
# block, halved
PARTIAL_SMEM = 115712


@dataclass(frozen=True)
class PartialPlan:
    splits: int         # S: blocks of one cluster along the piece
    warps: int          # warps of a block, each walking its own tiles
    stages: int         # tiles a warp has staged or in flight
    groups: int         # blocks along the G query heads: ceil(G / 8)
    vec: bool           # 16-byte copies (else entry by entry)


def partial_padded_dim(D: int) -> int:
    """The kernel's padded head dim: 32, 64, 128 or 256 (16 x its
    instantiation's 16-dim output fragments)."""
    return next(dp for dp in (32, 64, 128, 256) if D <= dp)


def partial_smem(D: int, dtype, warps: int, stages: int) -> int:
    """Bytes of shared memory of a block (``partial_smem`` in the kernel):
    each warp's ring of K and V tiles (row pitches f32 K DP + 4, V DP + 8;
    bf16 both DP + 8), q's B fragments (16 bytes a lane a k step), the
    warps' P tiles, the block's record (m, l, acc[D] of 8 heads) and, for
    each head, the warps' max and sum and the cluster ranks' weights."""
    dp = partial_padded_dim(D)
    pk = dp + 4 if dtype.itemsize == 4 else dp + 8
    stage = dtype.itemsize * PARTIAL_TILE * (pk + dp + 8)
    return (warps * stages * stage + dp // 8 * 32 * 16 + warps * PARTIAL_TILE * PARTIAL_HEADS * 4
            + PARTIAL_HEADS * (2 + D) * 4
            + PARTIAL_HEADS * (2 * PARTIAL_MAX_WARPS + MAX_SPLITS) * 4)


def partial_plan(capacity: int, B: int, KH: int, G: int, D: int, dtype,
                 aligned: bool = True) -> PartialPlan:
    """The plan of ``flash_decode_partial_kernel`` for q (B, KH, G, D) over
    a piece of ``capacity`` positions of K/V in ``dtype`` (float32 or
    bfloat16); ``aligned`` says K and V start on a 16-byte boundary.

    A block serves 8 query heads of one (slot, KV head); the piece's
    16-position tiles go over the S blocks of a cluster (equal contiguous
    shares) and over each block's 4 warps (in turn).  The call is latency
    bound, and a tile goes faster on a block of its own than beside
    others: S (a power of two, at most ``MAX_SPLITS``) doubles while it is
    below the capacity's tiles and the doubled grid stays within the SM
    count.  Each warp stages up to 3 of its tiles; stages, then warps, go
    until two blocks fit an SM (clusters of 8 blocks one an SM found 15 of
    their 16 places at once on an H100)."""
    if not 1 <= D <= DECODE_MAX_HEAD_DIM:
        raise ValueError(f"partial_plan: head dim {D} outside [1, {DECODE_MAX_HEAD_DIM}]")
    tiles = -(-capacity // PARTIAL_TILE)
    groups = -(-G // PARTIAL_HEADS)
    units = B * KH * groups
    s = 1
    while s < MAX_SPLITS and s < tiles and units * 2 * s <= SMS:
        s *= 2
    warps = PARTIAL_MAX_WARPS
    stages = min(PARTIAL_MAX_STAGES, -(-tiles // (s * warps)))
    while partial_smem(D, dtype, warps, stages) > PARTIAL_SMEM:
        if stages > 1:
            stages -= 1
        else:
            warps -= 1
    return PartialPlan(s, warps, stages, groups,
                       aligned and D % (16 // dtype.itemsize) == 0)
