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
"""
from __future__ import annotations

from dataclasses import dataclass

from ..limits import MAX_CLUSTER

TILE = 64               # rows of a query or key tile, and of a C Bᵀ tile side
SUBCHUNK = 256          # rows of the longest sub-chunk a block holds at once
COL_TILE = 32           # head dims a block serves (SSD_DC in csrc/ssd_scan.cu)


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
