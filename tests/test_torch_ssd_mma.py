"""The SSD scan kernel's launch plan and order of work (``csrc/ssd_scan.cu``,
``kernels/ssd_scan/plan.py``), held on the CPU before the card.

* The plan: a cluster of at most 8 blocks of one batch row splits each
  chunk's causal 64 x 64 C Bᵀ tiles (tile k to rank k % cluster), every
  tile formed once; every (batch, head, column) is written by one block;
  the plan is a function of its arguments and fills the card at the
  serving shape; the wrapper hands it to the C entry unchanged.
* The arithmetic, emulated in torch: C Bᵀ formed once per (batch,
  sub-chunk) in 32-column K-chunks, each chunk's three TF32 passes summed
  into a zeroed fragment first (the helpers of ``test_torch_tf32x3``);
  each head's mask from double prefix sums, every difference rounded once
  to f32: exp(cum_t - cum_a) exp(cum_a - cum_s) for s < a <= t, at a the
  query tile's first row below the diagonal tiles and the warp's first row
  on them (both factors <= 1, so neither overflows), and exp(cum_t -
  cum_s) itself, taken only where t >= s, for a warp's own 16 keys; the
  masked product per 64-key
  tile; C h skipped while the state is zero (the first chunk); the state
  scaled by exp(cum_Q) and updated in 16-row slices.  Held within the
  scan's tolerance (atol 1e-4, rtol 1e-3) of ``repro``'s interpret-mode
  kernel and of the port's ``ssd_chunked``, and no further from an f64
  oracle than ``ssd_chunked`` at the model's decays.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_sequential_ref
from repro_torch.kernels.ssd_scan.plan import (COL_TILE, MAX_CLUSTER, SUBCHUNK, TILE,
                                               causal_tiles, ssd_plan, vec_loads)
from test_torch_tf32x3 import split3, tf32_rna

ops = importlib.import_module("repro_torch.kernels.ssd_scan.ops")

TOL = dict(atol=1e-4, rtol=1e-3)        # the scan's tolerance (tests/test_torch_ssd_scan.py)
SHAPES = [(2, 64, 4, 32, 16, 16), (1, 100, 2, 16, 8, 32), (2, 31, 3, 8, 4, 16),
          (1, 256, 2, 64, 32, 64)]      # (B, S, nh, hd, N, chunk): repro's sweep
KS = 32                                 # SSD_KS: columns of a C / B slice (C Bᵀ, C h)
RS = 16                                 # SSD_RS: rows of a state-update slice
WR = 16                                 # rows of a warp in a 64-row tile
SMS = 132


def _inputs(B, S, nh, hd, N, seed=0, model_decays=False):
    """The sweep's distributions (x ~ N(0, 1), B/C ~ N(0, 1/N), dt =
    softplus(N(0, 1)), A = -exp(linspace(0, 1.5))); ``model_decays``: A =
    -linspace(1, 16), as Mamba2's init draws it, cum in the thousands."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * N ** -0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * N ** -0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, nh) if model_decays
         else -np.exp(np.linspace(0.0, 1.5, nh))).astype(np.float32)
    return xh, Bm, Cm, dt, A


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 80, 200, 64, 128, 200), (1, 80, 512, 64, 128, 256), (1, 80, 8, 64, 128, 8),
               (2, 70, 300, 100, 256, 48), (1, 7, 65, 80, 16, 256), (1, 1, 1, 8, 4, 256),
               (3, 5, 1024, 8, 3, 512), (1, 80, 1024, 64, 128, 1024), (4, 80, 64, 64, 128, 64)]


def tile_of(k):
    """(i, j) of causal tile k in the kernel's order: (0,0), (1,0), (1,1), ..."""
    i = 0
    while (i + 1) * (i + 2) // 2 <= k:
        i += 1
    return i, k - i * (i + 1) // 2


def _cap(plan, Q):
    """The C B^T tiles a block may own (the C entry's cap)."""
    return -(-causal_tiles(Q) // plan.cluster)


@pytest.mark.parametrize("Q", [1, 8, 63, 64, 65, 128, 129, 192, 200, 255, 256, 257, 512, 1024])
def test_cluster_forms_each_causal_tile_once(Q):
    plan = ssd_plan(1, 80, Q, 64, 128, Q, SMS)
    T = -(-min(Q, SUBCHUNK) // TILE)
    tiles = [tile_of(k) for k in range(causal_tiles(Q))]
    assert sorted(tiles) == [(i, j) for i in range(T) for j in range(i + 1)]
    owners = {}
    for k, ij in enumerate(tiles):              # rank k % CL, slot k // CL
        owners.setdefault(ij, []).append((k % plan.cluster, k // plan.cluster))
    assert all(len(o) == 1 for o in owners.values())
    assert max(slot for (_, slot), in owners.values()) < _cap(plan, Q)
    # no rank of a cluster is left without a tile to form
    assert {rank for (rank, _), in owners.values()} == set(range(plan.cluster))
    assert 1 <= plan.cluster <= MAX_CLUSTER == 8


@pytest.mark.parametrize("B,nh,S,hd,N,Q", PLAN_SHAPES)
def test_every_batch_head_and_column_is_written_by_one_block(B, nh, S, hd, N, Q):
    p = ssd_plan(B, nh, S, hd, N, Q, SMS)
    assert COL_TILE == 32 and p.col_tiles == -(-hd // COL_TILE)
    assert p.blocks % p.cluster == 0 and 1 <= p.cluster <= 8
    units_pad = p.blocks // B
    assert units_pad % p.cluster == 0 and units_pad - p.units < p.cluster
    written = np.zeros((B, nh, hd), dtype=np.int64)
    for x in range(p.blocks):                  # the kernel's own indexing
        b, u = divmod(x, units_pad)
        if u >= p.units:
            continue                            # a padding block forms tiles only
        head, ct = divmod(u, p.col_tiles)
        d0 = ct * COL_TILE
        written[b, head, d0:min(d0 + COL_TILE, hd)] += 1
    assert (written == 1).all()
    # a cluster never spans two batch rows: its blocks share one C B^T
    for c in range(0, p.blocks, p.cluster):
        assert len({x // units_pad for x in range(c, c + p.cluster)}) == 1


@pytest.mark.parametrize("B,nh,S,hd,N,Q", PLAN_SHAPES)
def test_plan_depends_only_on_its_arguments(B, nh, S, hd, N, Q):
    p = ssd_plan(B, nh, S, hd, N, Q, SMS)
    ssd_plan(7, 3, 99, 16, 8, 32, 16)           # another plan in between changes nothing
    assert ssd_plan(B, nh, S, hd, N, Q, SMS) == p
    # the cluster follows the chunk's tiles; the SM count moves nothing
    assert p.cluster == min(8, causal_tiles(Q))
    assert ssd_plan(B, nh, S, hd, N, Q, 10 ** 6) == p == ssd_plan(B, nh, S, hd, N, Q, 1)


def test_plan_fills_the_card_at_the_serving_shape():
    """Mamba2-2.7B's prefill (B 1, 80 heads of 64, N 128): 80 blocks of 64
    columns would leave 52 of 132 SMs idle; 32-column tiles give 160."""
    for S in (8, 200, 512):
        p = ssd_plan(1, 80, S, 64, 128, min(256, S), SMS)
        assert p.col_tiles == 2 and p.blocks == 160 >= SMS
    assert ssd_plan(1, 80, 200, 64, 128, 200, SMS).cluster == 8
    assert ssd_plan(1, 80, 8, 64, 128, 8, SMS).cluster == 1      # one tile: no sharing


def test_vec_loads_need_aligned_16_byte_pitches():
    assert vec_loads(128, 64, 0, 16, 4096)
    assert not vec_loads(128, 64, 0, 4, 4096)                    # a base off 16 bytes
    assert not vec_loads(3, 64, 0, 16, 32) and not vec_loads(128, 10, 0, 16, 32)


@pytest.fixture
def launches(monkeypatch):
    """ssd_scan_kernel on CPU tensors with the C entry replaced by a
    recorder: returns the list of argument tuples."""
    calls = []

    def entry():
        def fn(*args):
            assert len(args) == 15
            calls.append(args)
            return 0
        return fn

    class NoDevice:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Props:
        multi_processor_count = SMS

    class Stream:
        cuda_stream = 0

    empty = torch.empty
    monkeypatch.setattr(ops, "_entry", entry)
    monkeypatch.setattr(ops.build, "check", lambda *a: None)
    monkeypatch.setattr(ops.backend, "count_launch", lambda op: None)
    monkeypatch.setattr(ops.torch.cuda, "device", NoDevice)
    monkeypatch.setattr(ops.torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(ops.torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(ops.torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    return calls


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the wrapper's checks."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(*shape):
    return torch.Tensor._make_subclass(OnCard, torch.zeros(*shape))


@pytest.mark.parametrize("B,S,nh,hd,N", [(1, 200, 80, 64, 128), (1, 512, 80, 64, 128),
                                         (2, 65, 7, 80, 3)])
def test_wrapper_passes_its_plan(launches, B, S, nh, hd, N):
    Q = min(256, S)
    xdt, g = _on_card(B, nh, S, hd), _on_card(B, nh, S)
    Bm, Cm = _on_card(B, S, N), _on_card(B, S, N)
    ops.ssd_scan_kernel(xdt, g, Bm, Cm, chunk=256)
    (args,) = launches
    p = ssd_plan(B, nh, S, hd, N, Q, SMS)
    assert args[6:12] == (B, nh, S, hd, N, Q)
    assert args[12:14] == (p.cluster,
                           int(vec_loads(N, hd, xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr())))


# ---------------------------------------------------------------------------
# the arithmetic, in the kernel's order
# ---------------------------------------------------------------------------

def product_3x(a, b):
    """a @ b in 3xTF32 (small*big + big*small + big*big) into a zeroed
    fragment: one f32 sum of the three exact products."""
    ab, as_ = split3(a)
    bb, bs = split3(b)
    return torch.cat([as_, ab, ab], -1) @ torch.cat([bb, bs, bb], -2)


def chunked_3x(a, b, k):
    """a @ b over K in chunks of k, each chunk's three passes into a zeroed
    fragment, then added to the accumulator in order."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], k):
        acc = acc + product_3x(a[..., k0:k0 + k], b[..., k0:k0 + k, :])
    return acc


def emulate(xh, Bm, Cm, dt, A, chunk, skip_first=True):
    """The kernel on the model layout: the op's pre-scaling and padding,
    then sub-chunks of at most ``SUBCHUNK`` rows.  Returns (y (B, S, nh,
    hd), h_last (B, nh, hd, N)), f32."""
    B, S, nh, hd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xdt = F.pad((xh * dt[..., None]).permute(0, 2, 1, 3), (0, 0, 0, pad))  # (B, nh, S, hd)
    g = F.pad((dt * A).permute(0, 2, 1), (0, pad))                         # (B, nh, S)
    Bk, Ck = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    y = torch.zeros_like(xdt)
    h = torch.zeros(B, nh, N, hd)                                         # rows n, as the kernel
    first = True
    for c0 in range(0, S + pad, Q):
        for q0 in range(c0, c0 + Q, SUBCHUNK):
            Qc = min(SUBCHUNK, c0 + Q - q0)
            rows = slice(q0, q0 + Qc)
            cq, bq, xq = Ck[:, rows], Bk[:, rows], xdt[:, :, rows]         # (B, Qc, N) ...
            cum = torch.cumsum(g[:, :, rows].double(), -1)                 # (B, nh, Qc)
            # C B^T once per batch and sub-chunk (shared by the heads)
            cb = chunked_3x(cq, bq.transpose(1, 2), KS)                    # (B, Qc, Qc)
            m = _masked(cb, cum)
            acc = torch.zeros(B, nh, Qc, hd)
            if not (first and skip_first):
                inter = chunked_3x(cq[:, None], h, KS)                       # C h
                acc = inter * torch.exp(cum.float())[..., None]
            for j0 in range(0, Qc, TILE):                                  # 64-key tiles
                acc = acc + product_3x(m[..., j0:j0 + TILE], xq[:, :, j0:j0 + TILE])
            y[:, :, rows] = acc
            w = torch.exp((cum[..., -1:] - cum).float())                  # decay to the end
            h = h * torch.exp(cum[..., -1].float())[..., None, None]
            xs = xq * w[..., None]
            for s0 in range(0, Qc, RS):                                    # 16-row slices
                h = h + product_3x(bq[:, None, s0:s0 + RS].transpose(-1, -2),
                                   xs[:, :, s0:s0 + RS])
            first = False
    return y[:, :, :S].permute(0, 2, 1, 3), h.transpose(-1, -2)


def _masked(cb, cum):
    """(C Bᵀ) o the mask as the kernel forms it, per 64 x 64 tile (i, j) and
    16-row warp block: exp(cum_t - cum_a) exp(cum_a - cum_s) for keys s
    before the anchor a (the tile's first row below the diagonal, the warp's
    first row on it), exp(cum_t - cum_s) where a <= s <= t, 0 above; cb (B,
    Qc, Qc) f32, cum (B, nh, Qc) f64."""
    Qc = cum.shape[-1]
    m = torch.zeros(cum.shape[:2] + (Qc, Qc))
    for r0 in range(0, Qc, WR):
        rows = slice(r0, r0 + WR)
        i0 = r0 // TILE * TILE
        # keys of the tiles left of the diagonal (anchor: the tile's first
        # row), then keys of the diagonal tile before the warp (anchor: the
        # warp's first row)
        for a, keys in ((i0, slice(0, i0)), (r0, slice(i0, r0))):
            if keys.stop > keys.start:
                r = torch.exp((cum[..., rows] - cum[..., a:a + 1]).float())
                c = torch.exp((cum[..., a:a + 1] - cum[..., keys]).float())
                m[..., rows, keys] = (cb[:, None, rows, keys] * r[..., :, None]
                                      * c[..., None, :])
        own = slice(r0, r0 + WR)                # the warp's own keys
        d = cum[..., rows, None] - cum[..., None, own]
        tri = torch.tril(torch.ones(d.shape[-2:], dtype=torch.bool))
        e = torch.exp(torch.where(tri, d, torch.zeros_like(d)).float())
        m[..., rows, own] = torch.where(tri, cb[:, None, rows, own] * e, torch.zeros(()))
    return m


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,S,nh,hd,N,Q", SHAPES)
def test_emulation_matches_repros_interpret_mode_kernel(B, S, nh, hd, N, Q):
    ins = _inputs(B, S, nh, hd, N, seed=S)
    y, _ = emulate(*_t(*ins), chunk=Q)
    yk = np.asarray(j_ssd_scan(*[jnp.asarray(a) for a in ins], chunk=Q, interpret=True))
    np.testing.assert_allclose(y.numpy(), yk, **TOL)


@pytest.mark.parametrize("B,S,nh,hd,N,Q", [(2, 45, 3, 8, 4, 32), (1, 300, 2, 16, 16, 256),
                                           (1, 600, 2, 8, 8, 512)])
def test_emulation_matches_ssd_chunked_across_chunks(B, S, nh, hd, N, Q):
    """Ragged two-chunk shapes (C h from the second chunk on), and Q 512
    walked as sub-chunks of 256 and 256."""
    ins = _t(*_inputs(B, S, nh, hd, N, seed=S + 1))
    y, h = emulate(*ins, chunk=Q)
    yr, hr = ssd_chunked(*ins, chunk=Q)
    torch.testing.assert_close(y, yr, **TOL)
    torch.testing.assert_close(h, hr, **TOL)


def test_skipping_c_h_on_the_first_chunk_changes_no_bit():
    ins = _t(*_inputs(1, 100, 2, 16, 8, seed=3))
    for a, b in zip(emulate(*ins, chunk=64), emulate(*ins, chunk=64, skip_first=False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,Q", [(200, 256), (300, 256)])
def test_emulation_at_the_models_decays_no_further_from_f64_than_chunked(S, Q):
    """A = -linspace(1, 16) at a reduced width (16 heads of 16, N 32):
    cum reaches the thousands inside a chunk; the double prefix sums keep
    the kernel's order at least as close to the f64 oracle as the plain
    f32 path."""
    ins = _t(*_inputs(1, S, 16, 16, 32, seed=S, model_decays=True))
    y, h = emulate(*ins, chunk=Q)
    yc, hc = ssd_chunked(*ins, chunk=Q)
    y64, h64 = ssd_sequential_ref(*(t.double() for t in ins))
    torch.testing.assert_close(y.double(), y64, **TOL)
    torch.testing.assert_close(h.double(), h64, **TOL)
    for k, c, r in ((y, yc, y64), (h, hc, h64)):
        assert (k.double() - r).abs().max() <= (c.double() - r).abs().max()


def test_one_tf32_pass_for_the_masked_product_misses_the_tolerance():
    """Why three passes: one TF32 pass of M xdt alone lies outside the
    scan's tolerance at the serving chunk."""
    ins = _t(*_inputs(1, 256, 2, 64, 128, seed=5))
    xh, Bm, Cm, dt, A = ins
    y, _ = emulate(*ins, chunk=256)
    cum = torch.cumsum((dt * A).permute(0, 2, 1).double(), -1)
    xdt = (xh * dt[..., None]).permute(0, 2, 1, 3)
    cb = Cm @ Bm.transpose(1, 2)
    tri = torch.tril(torch.ones(256, 256, dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    m = torch.where(tri, cb[:, None] * torch.exp(torch.where(tri, diff, 0.0).float()), 0.0)
    y1 = (tf32_rna(m) @ tf32_rna(xdt)).permute(0, 2, 1, 3)
    yr, _ = ssd_chunked(*ins, chunk=256)
    torch.testing.assert_close(y, yr, **TOL)
    assert not torch.allclose(y1, yr, **TOL)


def test_anchored_mask_never_overflows_and_matches_the_difference():
    """At the model's decays cum spans thousands inside a chunk, so exp(-cum_s)
    alone overflows f32; the anchored factors are <= 1 and their product is
    exp(cum_t - cum_s), each difference rounded once, to within the f32
    rounding of the exponents (|cum_t - cum_s| < 88 where it does not
    underflow)."""
    xh, Bm, Cm, dt, A = _t(*_inputs(1, 256, 4, 8, 8, seed=2, model_decays=True))
    cum = torch.cumsum((dt * A).permute(0, 2, 1).double(), -1)
    assert torch.isinf(torch.exp(-cum.float())).any()
    m = _masked(torch.ones(1, 256, 256), cum)
    d = cum[..., :, None] - cum[..., None, :]
    tri = torch.tril(torch.ones(256, 256, dtype=torch.bool))
    direct = torch.where(tri, torch.exp(torch.where(tri, d, 0.0).float()), 0.0)
    assert bool(torch.isfinite(m).all()) and bool((m <= 1).all())
    torch.testing.assert_close(m, direct, rtol=3e-5, atol=1e-37)
