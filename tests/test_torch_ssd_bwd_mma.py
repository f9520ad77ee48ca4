"""The SSD scan backward's launch plan and order of work
(``csrc/ssd_scan_bwd.cu``, ``kernels/ssd_scan/plan.py::ssd_bwd_plan``),
held on the CPU before the card.

* The plan: every (batch, head, segment) is served by one pairs block and
  one rows block per 64-row tile, every causal pair tile (i, j) of a
  segment is formed by exactly one pairs block (the one of key tile j), and
  every C Bᵀ tile and state tile by one prep block; a head group never
  spans two batch rows or segments; the plan depends only on its arguments
  and keeps >= 4 blocks per SM once it groups heads; the wrapper hands it
  to the C entry unchanged.
* The arithmetic, emulated in torch in the kernel's order: every product
  in 3xTF32, each 32-deep K-chunk's three passes summed into a zeroed
  fragment first (the helpers of ``test_torch_tf32x3``); segments of at
  most 256 rows; the mask from double prefix sums with the forward's
  anchors; each pair tile's P formed once, its row and column sums (for
  dg) from the same values; dB and dC added up over a head group in order,
  then over the groups in order; dg's scans in double.  Within 1e-4 (of
  the largest entry) of ``ssd_scan_bwd_ref``, no further from the f64
  witness than 3x f32 autograd through the chunked algorithm, and carried
  to the model layout by the pre-scaling's chain rule within 1e-5 of
  ``jax.grad`` of ``repro``'s ``ssd_chunked``.  One TF32 pass misses the
  tolerance.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.plan import (BWD_MIN_WAVES, SUBCHUNK, TILE, bwd_segments,
                                               ssd_bwd_plan, vec_loads)
from test_torch_ssd_mma import OnCard
from test_torch_ssd_scan_grad import CASES, IDS, Q as GRAD_Q, _inputs, _j_grad, _kernel_layout
from test_torch_tf32x3 import split3, tf32_rna

ops = importlib.import_module("repro_torch.kernels.ssd_scan.ops")

SMS = 132
KC = 32                 # depth of a zeroed K-chunk
PLAN_SHAPES = [(2, 80, 512, 64, 128, 256), (6, 80, 512, 64, 128, 256),
               (1, 80, 512, 64, 128, 256), (2, 4, 64, 32, 16, 32), (2, 8, 512, 128, 64, 256),
               (6, 81, 512, 64, 128, 256), (1, 2, 1024, 64, 128, 512), (2, 3, 96, 100, 5, 48),
               (1, 1, 600, 8, 8, 300)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _tile_of(p):
    i = 0
    while (i + 1) * (i + 2) // 2 <= p:
        i += 1
    return i, p - i * (i + 1) // 2


@pytest.mark.parametrize("B,nh,S,hd,N,Q", PLAN_SHAPES)
def test_every_pair_tile_is_formed_once_and_every_row_tile_served_once(B, nh, S, hd, N, Q):
    """The pairs and rows launches' indexing, as the kernel decodes
    blockIdx.x: (batch, segment, head group, tile r), the group's heads in
    turn, tiles past a ragged segment idle."""
    p = ssd_bwd_plan(B, nh, S, hd, N, Q, SMS)
    segs = bwd_segments(S, Q)
    assert len(segs) == p.segments and p.seg == min(Q, SUBCHUNK)
    assert p.chunk_blocks == B * p.segments * p.groups * p.tiles
    formed, rows, heads_seen = {}, {}, {}
    for x in range(p.chunk_blocks):
        u, r = divmod(x, p.tiles)
        u, grp = divmod(u, p.groups)
        b, k = divmod(u, p.segments)
        start, L = segs[k]
        T = -(-L // TILE)
        if r >= T:
            continue
        for head in range(grp * p.heads, min(nh, (grp + 1) * p.heads)):
            heads_seen[(b, head, k)] = heads_seen.get((b, head, k), 0) + 1
            for i in range(r, T):                   # pairs block r: column r
                formed[(b, head, k, i, r)] = formed.get((b, head, k, i, r), 0) + 1
            rows[(b, head, k, r)] = rows.get((b, head, k, r), 0) + 1
    want = {(b, h, k, i, j) for b in range(B) for h in range(nh)
            for k, (_, L) in enumerate(segs) for i in range(-(-L // TILE)) for j in range(i + 1)}
    assert set(formed) == want and set(formed.values()) == {1}
    assert set(rows.values()) == {1} and len(rows) == sum(
        B * nh * -(-L // TILE) for _, L in segs)
    assert set(heads_seen) == {(b, h, k) for b in range(B) for h in range(nh)
                               for k in range(p.segments)}
    # the segments tile each chunk in order
    assert [s for s, _ in segs] == [c + m for c in range(0, S, Q) for m in range(0, Q, SUBCHUNK)]
    assert all(0 < L <= SUBCHUNK for _, L in segs) and sum(L for _, L in segs) == S


@pytest.mark.parametrize("B,nh,S,hd,N,Q", PLAN_SHAPES)
def test_prep_forms_every_cb_tile_and_state_tile_once(B, nh, S, hd, N, Q):
    p = ssd_bwd_plan(B, nh, S, hd, N, Q, SMS)
    segs = bwd_segments(S, Q)
    cb_blocks = B * p.segments * p.pairs
    cb = {}
    for x in range(cb_blocks):
        u, pi = divmod(x, p.pairs)
        b, k = divmod(u, p.segments)
        i, j = _tile_of(pi)
        if i < -(-segs[k][1] // TILE):
            cb[(b, k, i, j)] = cb.get((b, k, i, j), 0) + 1
    assert set(cb.values()) == {1} and len(cb) == sum(
        B * (-(-L // TILE)) * (-(-L // TILE) + 1) // 2 for _, L in segs)
    dtl, ntl = -(-hd // TILE), -(-N // TILE)
    states = {}
    for x in range(p.prep_blocks - cb_blocks):
        u, nt = divmod(x, ntl)
        u, dtile = divmod(u, dtl)
        bh, d = divmod(u, 2)
        states[(bh, d, dtile, nt)] = states.get((bh, d, dtile, nt), 0) + 1
    assert set(states.values()) == {1} and len(states) == B * nh * 2 * dtl * ntl


@pytest.mark.parametrize("B,nh,S,hd,N,Q", PLAN_SHAPES)
def test_bwd_plan_depends_only_on_its_arguments(B, nh, S, hd, N, Q):
    p = ssd_bwd_plan(B, nh, S, hd, N, Q, SMS)
    ssd_bwd_plan(7, 3, 99, 16, 8, 33, 16)          # another plan in between changes nothing
    assert ssd_bwd_plan(B, nh, S, hd, N, Q, SMS) == p
    assert p.heads in (1, 2, 4, 8) and p.groups == -(-nh // p.heads)
    assert p.heads == 1 or p.chunk_blocks >= BWD_MIN_WAVES * SMS
    bigger = ssd_bwd_plan(B, nh, S, hd, N, Q, 10 ** 6)
    assert bigger.heads == 1 and bigger.groups == nh
    assert hd <= 16 * p.dtiles and (p.dtiles == 2 or hd > 8 * p.dtiles)


def test_bwd_plan_at_the_training_shapes():
    """Mamba2-2.7B (80 heads of 64, N 128, Q 256): a client's B 2 groups
    heads in pairs (640 blocks), the server's B 6 in fours (960), B 1
    keeps one head a block (640); the head sum then reads 40, 20 or 80
    partials instead of 80."""
    got = [ssd_bwd_plan(B, 80, 512, 64, 128, 256, SMS) for B in (2, 6, 1)]
    assert [(p.heads, p.groups, p.chunk_blocks) for p in got] == [
        (2, 40, 640), (4, 20, 960), (1, 80, 640)]
    assert {(p.tiles, p.pairs, p.dtiles, p.segments) for p in got} == {(4, 10, 4, 2)}
    with pytest.raises(ValueError, match="head dim"):
        ssd_bwd_plan(1, 2, 64, 256, 16, 32, SMS)


@pytest.fixture
def bwd_launches(monkeypatch):
    """ssd_scan_bwd_kernel on CPU tensors that report a CUDA device, with the
    C entries replaced by recorders: returns the list of (entry, args)."""
    calls = []

    def entries():
        def ws(*args):
            calls.append(("workspace", args))
            return 1024

        def fn(*args):
            assert len(args) == 21
            calls.append(("launch", args))
            return 0
        return ws, fn

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
    monkeypatch.setattr(ops, "_bwd_entries", entries)
    monkeypatch.setattr(ops.build, "check", lambda *a: None)
    monkeypatch.setattr(ops.backend, "count_launch", lambda op: None)
    monkeypatch.setattr(ops.torch.cuda, "device", NoDevice)
    monkeypatch.setattr(ops.torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(ops.torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(ops.torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    return calls


def _on_card(*shape):
    return torch.Tensor._make_subclass(OnCard, torch.zeros(*shape))


@pytest.mark.parametrize("B,S,nh,hd,N,with_dh", [(2, 512, 80, 64, 128, True),
                                                 (6, 512, 80, 64, 128, False),
                                                 (2, 96, 3, 100, 5, True)])
def test_bwd_wrapper_passes_its_plan(bwd_launches, B, S, nh, hd, N, with_dh):
    Q = min(256, S)
    xdt, g, dy = _on_card(B, nh, S, hd), _on_card(B, nh, S), _on_card(B, nh, S, hd)
    Bm, Cm = _on_card(B, S, N), _on_card(B, S, N)
    dh = _on_card(B, nh, hd, N) if with_dh else None
    ops.ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh, chunk=256)
    (_, ws), (_, args) = bwd_launches
    p = ssd_bwd_plan(B, nh, S, hd, N, Q, SMS)
    assert ws == (B, nh, S, hd, N, Q, p.heads)
    assert (args[5] is None) == (not with_dh)
    ptrs = (xdt, Bm, Cm, dy) + ((dh,) if with_dh else ())
    assert args[11:17] == (B, nh, S, hd, N, Q)
    assert args[17:20] == (p.heads, p.dtiles,
                           int(vec_loads(N, hd, *(t.data_ptr() for t in ptrs))))


def test_bwd_wrapper_refuses_a_head_dim_above_128(bwd_launches):
    xdt, g = _on_card(1, 2, 64, 136), _on_card(1, 2, 64)
    Bm = _on_card(1, 64, 16)
    with pytest.raises(ValueError, match="head dim 136"):
        ops.ssd_scan_bwd_kernel(xdt, g, Bm, Bm, xdt, chunk=32)
    assert not bwd_launches


# ---------------------------------------------------------------------------
# the arithmetic, in the kernel's order
# ---------------------------------------------------------------------------

def product_3x(a, b):
    """a @ b in 3xTF32 into a zeroed fragment: one f32 sum of the three
    exact products (small*big + big*small + big*big)."""
    ab, as_ = split3(a)
    bb, bs = split3(b)
    return torch.cat([as_, ab, ab], -1) @ torch.cat([bb, bs, bb], -2)


def product_1x(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def chunked(a, b, product, acc=None):
    """acc (zero by default) + a @ b over K in chunks of KC, each into a
    zeroed fragment, then added to the accumulator in order."""
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], KC):
        acc = acc + product(a[..., k0:k0 + KC], b[..., k0:k0 + KC, :])
    return acc


def _exp(d):
    """exp of a double difference rounded once to f32."""
    return torch.exp(d.float())


def pair_mask(cum, i, r, ri, rr):
    """E of the pair tile (query tile i, key tile r) as the kernel forms
    it: left of the diagonal exp(cum_t - cum_a) exp(cum_a - cum_s) at a the
    query tile's first row; on it the anchor is each warp's first row (16-row
    blocks), its own 16 keys exp(cum_t - cum_s) itself where s <= t.
    cum (..., L) f64; returns (..., 64, 64) f32, zero past ri rows, rr keys."""
    a0, r0 = i * TILE, r * TILE
    E = torch.zeros(cum.shape[:-1] + (TILE, TILE))
    ct = cum[..., a0:a0 + ri]
    cs = cum[..., r0:r0 + rr]
    if i > r:
        E[..., :ri, :rr] = (_exp(ct - cum[..., a0:a0 + 1])[..., :, None]
                            * _exp(cum[..., a0:a0 + 1] - cs)[..., None, :])
        return E
    for w0 in range(0, ri, 16):
        rows = slice(w0, min(w0 + 16, ri))
        aw = cum[..., a0 + w0:a0 + w0 + 1]
        if w0:
            E[..., rows, :w0] = (_exp(cum[..., a0 + w0:a0 + rows.stop] - aw)[..., :, None]
                                 * _exp(aw - cs[..., :w0])[..., None, :])
        own = slice(w0, min(w0 + 16, rr))
        d = cum[..., a0 + w0:a0 + rows.stop, None] - cs[..., None, own]
        tri = torch.tril(torch.ones(d.shape[-2:], dtype=torch.bool))
        E[..., rows, own] = torch.where(tri, _exp(torch.where(tri, d, 0.0)), 0.0)
    return E


def emulate_bwd(xdt, g, Bm, Cm, dy, dh, *, chunk, heads=1, product=product_3x, record=None):
    """The kernel on the kernel layout (f32 operands), pass by pass.  Returns
    (dxdt, dg, dBm, dCm); ``record`` (a list) gets each pair tile's P with
    the row and column sums taken from it."""
    Bsz, nh, S, hd = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    segs = bwd_segments(S, Q)
    ns = len(segs)
    dx = torch.zeros_like(xdt)
    d1 = torch.zeros(Bsz, nh, S, dtype=torch.float64)
    rs = torch.zeros(Bsz, nh, S, dtype=torch.float64)
    kc = torch.zeros(Bsz, nh, ns, dtype=torch.float64)
    pb = torch.zeros(Bsz, nh, S, N)
    pc = torch.zeros(Bsz, nh, S, N)
    cums = [torch.cumsum(g[..., s:s + L].double(), -1) for s, L in segs]

    # 1. prep: the states entering each segment and dh at each one's end,
    # over 32-row slices; C B^T per (batch, segment)
    H = [torch.zeros(Bsz, nh, hd, N)]
    h = H[0]
    for k, (s, L) in enumerate(segs[:-1]):
        cum = cums[k]
        w = _exp(cum[..., -1:] - cum)
        h = h * _exp(cum[..., -1])[..., None, None]
        for q in range(0, L, KC):
            e = min(q + KC, L)
            xs = (xdt[:, :, s + q:s + e] * w[..., q:e, None]).transpose(-1, -2)
            h = h + product(xs, Bm[:, None, s + q:s + e])
        H.append(h)
    dhs = [None] * ns
    dhc = torch.zeros(Bsz, nh, hd, N) if dh is None else dh.clone()
    for k in reversed(range(ns)):
        dhs[k] = dhc
        if k == 0:
            break
        s, L = segs[k]
        cum = cums[k]
        w = _exp(cum)
        dhc = dhc * _exp(cum[..., -1])[..., None, None]
        for q in range(0, L, KC):
            e = min(q + KC, L)
            ys = (dy[:, :, s + q:s + e] * w[..., q:e, None]).transpose(-1, -2)
            dhc = dhc + product(ys, Cm[:, None, s + q:s + e])

    for k, (s, L) in enumerate(segs):
        cum = cums[k]
        T = -(-L // TILE)
        rows = [min(TILE, L - i * TILE) for i in range(T)]
        sl = [slice(s + i * TILE, s + i * TILE + rows[i]) for i in range(T)]
        cb = {(i, j): chunked(Cm[:, sl[i]], Bm[:, sl[j]].transpose(-1, -2), product)
              for i in range(T) for j in range(i + 1)}
        wend = _exp(cum[..., -1:] - cum)                      # (B, nh, L)
        win = _exp(cum)
        egs = {}
        # 2. pairs: tile r's column, each P once
        for r in range(T):
            rr = rows[r]
            colsum = torch.zeros(Bsz, nh, rr, dtype=torch.float64)
            acc = torch.zeros(Bsz, nh, rr, hd)
            for i in range(r, T):
                ri = rows[i]
                G = chunked(dy[:, :, sl[i]], xdt[:, :, sl[r]].transpose(-1, -2), product)
                E = pair_mask(cum, i, r, ri, rr)[..., :ri, :rr]
                EG = E * G
                Pt = cb[(i, r)][:, None] * EG
                Mt = cb[(i, r)][:, None] * E
                rowp = Pt.double().sum(-1)
                colsum = colsum + Pt.double().sum(-2)
                if record is not None:
                    record.append((Pt, rowp, Pt.double().sum(-2)))
                egs[(i, r)] = EG
                d1[..., sl[i]] += rowp
                acc = chunked(Mt.transpose(-1, -2), dy[:, :, sl[i]], product, acc)
            br = Bm[:, None, sl[r]] * wend[..., r * TILE:r * TILE + rr, None]
            dx[:, :, sl[r]] = chunked(br, dhs[k].transpose(-1, -2), product, acc)
            d1[..., sl[r]] -= colsum
        # 3. rows: tile r's dB (the state term first, then the column's
        # pairs) and dC (the inter-chunk term first, then the row's pairs)
        for r in range(T):
            rr = rows[r]
            st = chunked(xdt[:, :, sl[r]] * wend[..., r * TILE:r * TILE + rr, None], dhs[k],
                         product)
            rs[..., sl[r]] = (st * Bm[:, None, sl[r]]).double().sum(-1)
            for i in range(r, T):
                st = chunked(egs[(i, r)].transpose(-1, -2), Cm[:, None, sl[i]], product, st)
            pb[:, :, sl[r]] = st
            it = None
            if k > 0:
                it = chunked(dy[:, :, sl[r]] * win[..., r * TILE:r * TILE + rr, None], H[k],
                             product)
                d1[..., sl[r]] += (it * Cm[:, None, sl[r]]).double().sum(-1)
            for j in range(r + 1):
                it = chunked(egs[(r, j)], Bm[:, None, sl[j]], product, it)
            pc[:, :, sl[r]] = it
        if k > 0:
            kc[..., k] = ((dhs[k].double() * H[k].double()).sum((-2, -1))
                          * _exp(cum[..., -1]).double())
    # 4. finish: dB, dC over each head group in order, then the groups in
    # order; dg's scans in double
    def head_sum(p):
        groups = [sum_in_order(p[:, h0:h0 + heads]) for h0 in range(0, nh, heads)]
        return sum_in_order(torch.stack(groups, 1))

    dg = torch.zeros_like(g)
    for k, (s, L) in enumerate(segs):
        seg = slice(s, s + L)
        suf = torch.flip(torch.cumsum(torch.flip(d1[..., seg], (-1,)), -1), (-1,))
        pre = F.pad(torch.cumsum(rs[..., seg], -1)[..., :-1], (1, 0))
        dg[..., seg] = (suf + pre + kc[..., k:k + 1]).float()
    return dx, dg, head_sum(pb), head_sum(pc)


def sum_in_order(p):
    out = p[:, 0]
    for h in range(1, p.shape[1]):
        out = out + p[:, h]
    return out


def _operands(B, S, nh, hd, N, seed, with_dh=True):
    """The card test's operands: the model's decays (A = -linspace(1, 16))."""
    gen = torch.Generator().manual_seed(seed)
    dt = F.softplus(torch.randn(B, nh, S, generator=gen))
    xdt = torch.randn(B, nh, S, hd, generator=gen) * dt[..., None]
    g = -dt * torch.linspace(1.0, 16.0, nh)[None, :, None]
    Bm = torch.randn(B, S, N, generator=gen) * N ** -0.5
    Cm = torch.randn(B, S, N, generator=gen) * N ** -0.5
    dy = torch.randn(B, nh, S, hd, generator=gen)
    dh = torch.randn(B, nh, hd, N, generator=gen) if with_dh else None
    return xdt, g, Bm, Cm, dy, dh


def _autograd(ops_, dtype, Q):
    xdt, g, Bm, Cm, dy, dh = ops_
    leaves = [t.to(dtype).clone().requires_grad_() for t in (xdt, g, Bm, Cm)]
    y, h = ssd_scan_ref(*leaves, chunk=Q)
    loss = (y * dy.to(dtype)).sum() + (0.0 if dh is None else (h * dh.to(dtype)).sum())
    return torch.autograd.grad(loss, leaves)


EMU_SHAPES = [(1, 512, 2, 64, 32, 256, True), (2, 96, 3, 32, 16, 32, False),
              (1, 200, 2, 16, 16, 100, True), (1, 300, 2, 8, 8, 300, True),
              (2, 96, 3, 100, 5, 48, True)]


@pytest.mark.parametrize("B,S,nh,hd,N,Q,with_dh", EMU_SHAPES)
def test_emulation_matches_the_plain_backward_and_the_f64_witness(B, S, nh, hd, N, Q, with_dh):
    """Within 1e-4 of ``ssd_scan_bwd_ref``'s largest entry (phase 16 (a)'s
    check) and no further from autograd in f64 than 3x autograd in f32;
    head groups of 2 summed in order."""
    o = _operands(B, S, nh, hd, N, seed=S + hd, with_dh=with_dh)
    got = emulate_bwd(*o, chunk=Q, heads=2)
    want = ssd_scan_bwd_ref(*o, chunk=Q)
    w64 = _autograd(o, torch.float64, Q)
    a32 = _autograd(o, torch.float32, Q)
    for name, k, p, w, a in zip(("dxdt", "dg", "dB", "dC"), got, want, w64, a32):
        assert k.shape == p.shape
        assert (k - p).abs().max() <= 1e-4 * max(1.0, p.abs().max().item()), name
        dk = (k.double() - w).abs().max() / w.abs().max()
        da = (a.double() - w).abs().max() / w.abs().max()
        assert dk <= 3 * da, (name, dk.item(), da.item())


def test_each_pair_tile_is_formed_once_and_both_sums_read_it():
    """The emulation records every pair tile's P: there are T (T + 1) / 2 per
    (batch, segment), and the row sums and column sums that dg reads are
    those of that one P; dg's pairs then cancel over the segment to double
    rounding.  Column sums taken from a P formed again in another order
    (one TF32 pass, as a second product would round) do not cancel."""
    o = _operands(1, 256, 2, 32, 16, seed=7)
    rec = []
    emulate_bwd(*o, chunk=256, record=rec)
    assert len(rec) == 4 * 5 // 2
    tot_rows = tot_cols = 0.0
    for Pt, rowp, colp in rec:
        assert torch.equal(rowp, Pt.double().sum(-1)) and torch.equal(colp, Pt.double().sum(-2))
        tot_rows = tot_rows + rowp.sum(-1)
        tot_cols = tot_cols + colp.sum(-1)
    scale = sum(Pt.double().abs().sum((-2, -1)) for Pt, _, _ in rec)
    assert ((tot_rows - tot_cols).abs() <= 1e-12 * scale).all()
    # a second forming of P in one TF32 pass: the sums no longer cancel
    xdt, g, Bm, Cm, dy, _ = o
    cum = torch.cumsum(g.double(), -1)
    E = pair_mask(cum, 0, 0, TILE, TILE)
    cb = product_3x(Cm[:, :TILE], Bm[:, :TILE].transpose(-1, -2))[:, None]
    P3 = cb * (E * product_3x(dy[:, :, :TILE], xdt[:, :, :TILE].transpose(-1, -2)))
    P1 = cb * (E * product_1x(dy[:, :, :TILE], xdt[:, :, :TILE].transpose(-1, -2)))
    gap = (P3.double().sum((-2, -1)) - P1.double().sum((-2, -1))).abs()
    assert (gap > 1e-9 * P3.double().abs().sum((-2, -1))).all()


def test_one_tf32_pass_misses_the_tolerance():
    """Why three passes: the same order of work with one TF32 pass per
    product lies outside 1e-4 of the plain backward at Mamba2-2.7B's head
    shape (heads of 64, N 128, chunks of 256)."""
    o = _operands(1, 256, 2, 64, 128, seed=5)
    want = ssd_scan_bwd_ref(*o, chunk=256)
    got3 = emulate_bwd(*o, chunk=256)
    got1 = emulate_bwd(*o, chunk=256, product=product_1x)
    ok3 = [bool((k - p).abs().max() <= 1e-4 * max(1.0, p.abs().max().item()))
           for k, p in zip(got3, want)]
    ok1 = [bool((k - p).abs().max() <= 1e-4 * max(1.0, p.abs().max().item()))
           for k, p in zip(got1, want)]
    assert all(ok3) and not all(ok1)


@pytest.mark.parametrize("S,with_dh", CASES, ids=IDS)
def test_emulation_carried_to_the_model_layout_matches_jax_grad(S, with_dh):
    """The chain rule of ``_kernel_route``'s pre-scaling (dxh = dxdt dt, ddt
    = sum_d dxdt x + dg A, dA = sum dg dt) applied to the emulation, against
    ``jax.grad`` of ``repro``'s ``ssd_chunked`` (atol 1e-5)."""
    ins, dy, dh = _inputs(S, seed=1)
    dh_used = dh if with_dh else np.zeros_like(dh)
    jg = _j_grad([jnp.asarray(a) for a in ins], jnp.asarray(dy), jnp.asarray(dh_used))
    xh, Bm, Cm, dt, A = (torch.from_numpy(a) for a in ins)
    xdt, g, Bk, Ck = _kernel_layout(xh, Bm, Cm, dt, A)
    dyk = F.pad(torch.from_numpy(dy).permute(0, 2, 1, 3), (0, 0, 0, (-S) % GRAD_Q))
    dxdt, dg, dB, dC = emulate_bwd(xdt.contiguous(), g.contiguous(), Bk, Ck, dyk,
                                   torch.from_numpy(dh) if with_dh else None, chunk=GRAD_Q,
                                   heads=2)
    dxdt, dg = dxdt[:, :, :S].permute(0, 2, 1, 3), dg[:, :, :S].permute(0, 2, 1)
    got = (dxdt * dt[..., None], dB[:, :S], dC[:, :S], (dxdt * xh).sum(-1) + dg * A,
           (dg * dt).sum((0, 1)))
    for name, t, j in zip(("x", "B", "C", "dt", "A"), got, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
