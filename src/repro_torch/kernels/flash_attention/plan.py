"""The launch plan of the decode kernels (``csrc/flash_decode.cu`` and
``csrc/paged_decode.cu``: f32/bf16 K/V and int8 K/V, one body in
``csrc/decode_split.cuh``).

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
