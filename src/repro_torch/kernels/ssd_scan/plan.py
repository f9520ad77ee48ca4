"""The launch plan of the SSD scan kernel (``csrc/ssd_scan.cu``).

The plan is computed here, in Python, so that the CPU tests can hold its
rules; the CUDA launcher takes it as it is and checks only that it names
an instantiated kernel and that its shared memory fits a block.

A block serves one unit: one head of one batch row and one tile of
``COL_TILE`` head dims (y[:, d] and h[:, d] depend on column d of xdt
alone, so the column split is exact; the kernel masks a ragged last
tile).  The chunk's causal C Bᵀ tiles (``TILE`` x ``TILE``) do not depend
on the head: ``cluster`` blocks of one thread-block cluster, all of one
batch row, split them (tile ``k`` of the row-major causal order goes to
rank ``k % cluster``), and every block reads the ones it needs from its
cluster peers.  The units of a batch row are
padded to a multiple of ``cluster``; a padding block forms its share of the
tiles and writes nothing.

* ``cluster`` is the fewest of ``MAX_CLUSTER`` and the chunk's causal tile
  count: no block of a cluster is left without a tile to form.
* ``COL_TILE`` is 32 at every shape: Mamba2-2.7B's 80 heads of 64 give
  160 blocks on 132 SMs.  64 columns (80 blocks) and 16 (320) both
  measured slower there.  ``sm_count`` is taken as the other plans take
  it; with one column tile the plan does not depend on it.
* One head per block: every unit already shares C Bᵀ through the cluster,
  and a second head would only double the block's work.

Chunks longer than ``SUBCHUNK`` rows are walked as sub-chunks of at most
``SUBCHUNK`` (the scan's result does not depend on the chunk length, only
its rounding does), so a chunk has at most ``SUBCHUNK / TILE`` row tiles.

``ssd_bwd_plan`` is the plan of the backward (``csrc/ssd_scan_bwd.cu``),
four launches over the same segments (a chunk's sub-chunks of at most
``SUBCHUNK`` rows; the gradient, like the scan, does not depend on where
the chunks end):

* prep: one block per causal C Bᵀ tile of a (batch, segment), and one per
  (batch, head, direction, 64 x 64 state tile) walking the segments in
  order (the state entering each) or in reverse (dh at each one's end);
* pairs: one block per (batch, segment, head group, 64-row key tile r)
  forms the pair tiles (i, r), i >= r, each once: dxdt of tile r, both
  sums of P for dg, and E o G (to a workspace) for the rows launch;
* rows: one block per (batch, segment, head group, 64-row tile r): the
  group's dB rows of tile r from the pair tiles (i, r), i >= r, and its
  dC rows from the pair tiles (r, j), j <= r;
* finish: dB and dC summed over the head groups in order, and dg's scans.

``heads`` heads run one after another in a pairs or rows block; the rows
block adds their dB and dC rows up in place, so the head sum reads ``groups =
ceil(nh / heads)`` partials instead of nh.  It is the largest of 8, 4, 2
and 1 that leaves at least ``BWD_MIN_WAVES`` blocks per SM in those two
launches (none of them is a cluster).  ``dtiles`` names the pairs
kernel's instantiation: head dims padded to ``16 * dtiles`` (32, 64 or
128), each warp holding ``dtiles`` 8-column tiles of dxdt.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..limits import MAX_CLUSTER

TILE = 64               # rows of a query or key tile, and of a C Bᵀ tile side
SUBCHUNK = 256          # rows of the longest sub-chunk a block holds at once
COL_TILE = 32           # head dims a block serves (SSD_DC in csrc/ssd_scan.cu)
BWD_HD_MAX = 128        # largest head dim the backward takes (HDMAX in ssd_scan_bwd.cu)
BWD_MIN_WAVES = 4       # pairs/rows blocks per SM the head grouping keeps
BWD_THREADS = 256       # threads of every backward block


@dataclass(frozen=True)
class SsdPlan:
    cluster: int        # blocks of one cluster, sharing the chunk's C Bᵀ tiles
    col_tiles: int      # blocks along the head dim: ceil(hd / COL_TILE)
    units: int          # (head, column tile) units of one batch row
    blocks: int         # the grid: B * units rounded up to a multiple of cluster


def causal_tiles(Q: int) -> int:
    """C Bᵀ tiles (i, j), j <= i, of one sub-chunk of min(Q, SUBCHUNK) rows."""
    T = -(-min(Q, SUBCHUNK) // TILE)
    return T * (T + 1) // 2


def ssd_plan(B: int, nh: int, S: int, hd: int, N: int, Q: int, sm_count: int) -> SsdPlan:
    """The plan of ``ssd_scan_kernel`` for xdt (B, nh, S, hd), a state of N
    and chunks of Q rows, on a card of ``sm_count`` SMs."""
    if min(B, nh, S, hd, N, Q, sm_count) < 1:
        raise ValueError(f"ssd_plan: B={B} nh={nh} S={S} hd={hd} N={N} Q={Q} "
                         f"sm_count={sm_count} must all be positive")
    cluster = min(MAX_CLUSTER, causal_tiles(Q))
    col_tiles = -(-hd // COL_TILE)
    units = nh * col_tiles
    return SsdPlan(cluster, col_tiles, units, B * (-(-units // cluster) * cluster))


def vec_loads(N: int, hd: int, *ptrs: int) -> bool:
    """16-byte copies where every row pitch the kernel streams (N and hd
    floats) is a multiple of 16 bytes and every base pointer is 16-byte
    aligned; element copies otherwise.  The copy width never changes the
    arithmetic."""
    return N % 4 == 0 and hd % 4 == 0 and all(p % 16 == 0 for p in ptrs)


@dataclass(frozen=True)
class SsdBwdPlan:
    seg: int            # rows of a full segment: min(Q, SUBCHUNK)
    seg_per_chunk: int  # segments of a chunk: ceil(Q / SUBCHUNK)
    segments: int       # segments of a batch row: (S / Q) * seg_per_chunk
    tiles: int          # 64-row tiles of a full segment (T <= 4)
    pairs: int          # its causal pair tiles (i, j), j <= i: T (T + 1) / 2
    heads: int          # heads a pairs or rows block runs in turn
    groups: int         # head groups: ceil(nh / heads)
    dtiles: int         # the pairs kernel's instantiation: hd <= 16 * dtiles
    prep_blocks: int    # C Bᵀ tiles, then state tiles
    chunk_blocks: int   # the pairs launch and the rows launch each
    finish_blocks: int  # head-sum blocks (one entry a thread), then dg's


def bwd_segments(S: int, Q: int):
    """(start, rows) of every segment of a batch row, in order: each chunk
    of Q rows cut into pieces of SUBCHUNK, the last one ragged."""
    return [(c + m, min(SUBCHUNK, Q - m)) for c in range(0, S, Q)
            for m in range(0, Q, SUBCHUNK)]


def ssd_bwd_plan(B: int, nh: int, S: int, hd: int, N: int, Q: int,
                 sm_count: int) -> SsdBwdPlan:
    """The plan of ``ssd_scan_bwd_kernel`` for xdt (B, nh, S, hd), a state
    of N and chunks of Q rows, on a card of ``sm_count`` SMs."""
    if min(B, nh, S, hd, N, Q, sm_count) < 1 or S % Q:
        raise ValueError(f"ssd_bwd_plan: B={B} nh={nh} S={S} hd={hd} N={N} Q={Q} "
                         f"sm_count={sm_count} must be positive and Q must divide S")
    if hd > BWD_HD_MAX:
        raise ValueError(f"ssd_bwd_plan: head dim {hd} above {BWD_HD_MAX}")
    seg = min(Q, SUBCHUNK)
    spc = -(-Q // SUBCHUNK)
    nseg = len(bwd_segments(S, Q))
    T = -(-seg // TILE)
    heads = next(h for h in (8, 4, 2, 1)
                 if h == 1 or B * nseg * -(-nh // h) * T >= BWD_MIN_WAVES * sm_count)
    groups = -(-nh // heads)
    dtiles = next(d for d in (2, 4, 8) if hd <= 16 * d)
    prep = B * nseg * T * (T + 1) // 2 + B * nh * 2 * -(-hd // TILE) * -(-N // TILE)
    chunk = B * nseg * groups * T
    finish = -(-B * S * N // BWD_THREADS) + B * nh * nseg
    return SsdBwdPlan(seg, spc, nseg, T, T * (T + 1) // 2, heads, groups, dtiles, prep,
                      chunk, finish)
