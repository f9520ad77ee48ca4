"""The split-K decode body (``csrc/decode_split.cuh``) without the card:
its launch plan (``kernels/flash_attention/plan.py``), a torch emulation
of the kernel's order of work, and the wrappers' hand-off of the plan to
the C entries.

The emulation follows the kernel: each cluster rank takes an equal
contiguous share of the slot's live 32-position tiles, clipped to
[lo, hi); within a block, row streams of ``lanes`` lanes (4 warps x
32 / lanes) take rows ``base + u * streams + stream`` in batches of U
rows, each stream with its own online softmax; the streams of a warp merge
by xor butterfly, the warps in warp order, the cluster's blocks in rank
order.  Over int8 K/V (the Int8KV policy) a row is its int8 entries times
the KV head's f32 scale, 16 entries a 16-byte piece.  It is held against
the plain versions (1e-6, f32 q; the q8 pair's too), against ``repro``'s
interpret-mode Pallas kernels at one small shape (1e-5, float and int8
K/V), and for exact zeros on dead slots."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib                                            # noqa: E402

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention import flash_decode as j_flash_decode  # noqa: E402
from repro.kernels.flash_attention import paged_decode as j_paged_decode  # noqa: E402

from repro_torch.kernels.flash_attention import (flash_decode_q8_ref,  # noqa: E402
                                                 flash_decode_ref, paged_decode_q8_ref,
                                                 paged_decode_ref)
from repro_torch.kernels.flash_attention.plan import (DECODE_MAX_HEAD_DIM,  # noqa: E402
                                                      INT8_MAX_HEADS, MAX_HEADS,
                                                      MAX_SPLITS, SMS, TILE,
                                                      decode_plan, partial_plan)
from repro_torch.precision import quantize_kv_int8          # noqa: E402

ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

NW = 4                      # warps of a block (SPLIT_NW)
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the kernel's order of work, in torch
# ---------------------------------------------------------------------------

def live_range(length, capacity, window):
    hi = max(0, min(length, capacity))
    lo = min(max(0, length - window), hi) if window > 0 else 0
    return lo, hi


def block_share(lo, hi, S, rank):
    """[p0, p1) of cluster rank ``rank``: an equal contiguous share of the
    live tiles, clipped to [lo, hi) (empty when p0 >= p1)."""
    t_lo = lo // TILE
    per = (-(-hi // TILE) - t_lo + S - 1) // S
    return max(lo, (t_lo + rank * per) * TILE), min(hi, (t_lo + (rank + 1) * per) * TILE)


def rows_in_flight(GT, NC, EPV, max_rows):
    n = GT * NC * EPV
    return min(8 if n <= 16 else 4 if n <= 32 else 2, max_rows)


MAX_ROWS = {4: 8, 2: 8, 1: 2}   # the policies' MAX_ROWS by entry width: FloatKV, Int8KV


def stream_rows(p0, p1, streams, U):
    """Per stream, the rows it reads in order: row u of the batch at base is
    base + u * streams + stream."""
    return [[j for base in range(p0, p1, U * streams) for u in range(U)
             for j in (base + u * streams + st,) if j < p1] for st in range(streams)]


def _merge(m, l, acc, m2, l2, acc2):
    mm = torch.maximum(m, m2)
    a, b = torch.exp(m - mm), torch.exp(m2 - mm)
    return mm, l * a + l2 * b, acc * a[..., None] + acc2 * b[..., None]


def emulate(q, rows, lengths, capacity, plan, window=0, entry_bytes=4, per_head=False):
    """The kernel's arithmetic in f32 torch.  q (B, KH, G, D); rows(b, j)
    gives the K and V rows (KH, *j.shape, D) of slot b at positions j as
    f32, as the element policy unpacks them; ``entry_bytes`` is the width
    of a K/V entry (4 f32, 2 bf16, 1 int8), which sets the entries of a
    16-byte piece and so the rows in flight.  ``per_head`` takes each
    query head's products apart, as the kernel does (no head's sum meets
    another's), so that a head's bits do not depend on the block's
    number of heads through torch's own blocking of a batched product."""
    B, KH, G, D = q.shape
    S, GT, lanes, NC = plan.splits, plan.heads, plan.lanes, plan.vectors
    U = rows_in_flight(GT, NC, 16 // entry_bytes, MAX_ROWS[entry_bytes])
    rpw = 32 // lanes
    streams = NW * rpw
    out = torch.zeros(B, KH, G, D)
    for b in range(B):
        lo, hi = live_range(int(lengths[b]), capacity, window)
        for grp in range(plan.groups):
            n = min(G, grp * GT + GT) - grp * GT
            qg = torch.zeros(KH, GT, D)
            qg[:, :n] = q[b, :, grp * GT:grp * GT + n].float() * D ** -0.5
            recs = []
            for rank in range(S):
                p0, p1 = block_share(lo, hi, S, rank)
                m = torch.full((KH, GT, streams), NEG_INF)
                l = torch.zeros(KH, GT, streams)
                acc = torch.zeros(KH, GT, streams, D)
                for base in range(p0, p1, U * streams):
                    j = base + torch.arange(U)[:, None] * streams + torch.arange(streams)
                    live = j < p1
                    k, v = rows(b, torch.where(live, j, p0))
                    k, v = k * live[..., None], v * live[..., None]
                    if per_head:
                        s = torch.stack([torch.einsum("hd,husd->hus", qg[:, g], k)
                                         for g in range(GT)], 1)
                    else:
                        s = torch.einsum("hgd,husd->hgus", qg, k)
                    mx = torch.maximum(m, torch.where(live, s, NEG_INF).amax(2))
                    alpha = torch.exp(m - mx)
                    p = torch.where(live, torch.exp(s - mx[:, :, None]), 0.0)
                    m, l = mx, l * alpha + p.sum(2)
                    if per_head:
                        pv = torch.stack([torch.einsum("hus,husd->hsd", p[:, g], v)
                                          for g in range(GT)], 1)
                    else:
                        pv = torch.einsum("hgus,husd->hgsd", p, v)
                    acc = acc * alpha[..., None] + pv
                # the warp's streams: xor butterfly over the row slot
                m, l = m.reshape(KH, GT, NW, rpw), l.reshape(KH, GT, NW, rpw)
                acc = acc.reshape(KH, GT, NW, rpw, D)
                bit = 1
                while bit < rpw:
                    perm = torch.arange(rpw) ^ bit
                    m, l, acc = _merge(m, l, acc, m[..., perm], l[..., perm],
                                       acc[..., perm, :])
                    bit *= 2
                m, l, acc = m[..., 0], l[..., 0], acc[..., 0, :]
                # the warps in warp order
                mb = m.amax(-1)
                lb = torch.zeros(KH, GT)
                ab = torch.zeros(KH, GT, D)
                for w in range(NW):
                    e = torch.exp(m[..., w] - mb)
                    lb, ab = lb + e * l[..., w], ab + e[..., None] * acc[..., w, :]
                recs.append((mb, lb, ab))
            # the cluster's blocks in rank order
            mm = torch.stack([r[0] for r in recs]).amax(0)
            num, den = torch.zeros(KH, GT, D), torch.zeros(KH, GT)
            for mb, lb, ab in recs:
                e = torch.exp(mb - mm)
                den, num = den + e * lb, num + e[..., None] * ab
            o = num / den.clamp_min(1e-30)[..., None]
            out[b, :, grp * GT:grp * GT + n] = o[:, :n]
    return out


def slab_rows(k, v):
    """(B, L, KH, D) caches -> rows(b, j) as the kernel's SlabAddr reads them."""
    return lambda b, j: (k[b, j].movedim(-2, 0), v[b, j].movedim(-2, 0))


def paged_rows(kp, vp, bt):
    """(KH, NP, PS, D) pools and (B, MP) tables -> rows(b, j) as PagedAddr
    reads them (page bt[b, j // PS], offset j % PS)."""
    PS = kp.shape[2]
    return lambda b, j: (kp[:, bt[b, j // PS].long(), j % PS],
                         vp[:, bt[b, j // PS].long(), j % PS])


def _dequantized(x, scale):
    """Int8KV's unpacking: (KH, ..., D) int8 rows -> f32 * the head's scale."""
    return x.float() * scale.reshape(-1, *[1] * (x.dim() - 1))


def slab_rows_q8(kq, vq, ks, vs):
    """Int8 (B, L, KH, D) caches with (KH,) scales -> rows(b, j), dequantized."""
    return lambda b, j: (_dequantized(kq[b, j].movedim(-2, 0), ks),
                         _dequantized(vq[b, j].movedim(-2, 0), vs))


def paged_rows_q8(kq, vq, ks, vs, bt):
    """Int8 pools with (KH,) scales -> rows(b, j) through the tables, dequantized."""
    PS = kq.shape[2]
    return lambda b, j: (_dequantized(kq[:, bt[b, j // PS].long(), j % PS], ks),
                         _dequantized(vq[:, bt[b, j // PS].long(), j % PS], vs))


def _slab(B, KH, G, D, L, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, KH, G, D), (B, L, KH, D), (B, L, KH, D))]


def _paged(B, KH, G, D, PS, MP, lengths, seed):
    rng = np.random.default_rng(seed)
    NP = B * MP + 1
    q = rng.normal(size=(B, KH, G, D)).astype(np.float32)
    kp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    vp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    pages = rng.permutation(NP - 1) + 1
    bt = np.zeros((B, MP), np.int32)
    for b, n in enumerate(lengths):
        npg = -(-n // PS)
        bt[b, :npg] = pages[b * MP:b * MP + npg]
    return [torch.from_numpy(x) for x in (q, kp, vp, bt)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16]
KV_DTYPES = [torch.float32, torch.bfloat16, torch.int8]      # the plan's kv_dtype
KV_IDS = ["f32", "bf16", "int8"]


@pytest.mark.parametrize("dtype", KV_DTYPES, ids=KV_IDS)
@pytest.mark.parametrize("capacity", [1, 16, 33, 96, 512, 1024, 2048])
def test_splits_are_powers_of_two_up_to_eight(dtype, capacity):
    for B, KH, G, D in ((8, 12, 1, 64), (1, 12, 1, 64), (4, 2, 4, 128), (64, 16, 1, 64),
                        (1, 1, 8, 256), (3, 2, 3, 42)):
        p = decode_plan(capacity, B, KH, G, D, dtype)
        tiles = -(-capacity // TILE)
        assert p.splits in (1, 2, 4, 8)
        assert p.splits <= max(1, tiles)                           # no more than the tiles
        units = B * KH * p.groups
        # the fewest that give two blocks per SM, unless capped
        assert (p.splits == 1 or units * (p.splits // 2) < 2 * SMS)
        assert (units * p.splits >= 2 * SMS or p.splits == MAX_SPLITS
                or 2 * p.splits > tiles)


def test_every_split_is_taken_at_the_main_paths_shapes():
    f32 = torch.float32
    assert decode_plan(512, 8, 12, 1, 64, f32).splits == 4     # serving: 96 units
    assert decode_plan(512, 1, 12, 1, 64, f32).splits == 8     # the naive loop
    assert decode_plan(16, 8, 12, 1, 64, f32).splits == 1      # one tile
    assert decode_plan(33, 1, 2, 4, 64, f32).splits == 2       # two tiles
    assert decode_plan(512, 16, 12, 1, 64, f32).splits == 2    # 192 units
    # int8 K/V: phase 10's shapes take the same splits
    assert decode_plan(512, 8, 12, 1, 64, torch.int8).splits == 4
    assert decode_plan(512, 1, 12, 1, 64, torch.int8).splits == 8


@pytest.mark.parametrize("dtype", KV_DTYPES, ids=KV_IDS)
def test_plan_depends_only_on_its_arguments(dtype):
    args = [(c, B, KH, G, D) for c in (16, 512, 2048) for B in (1, 8) for KH in (1, 12)
            for G in (1, 3, 8, 12) for D in (1, 20, 64, 256)]
    first = [decode_plan(*a, dtype) for a in args]
    again = [decode_plan(*a, dtype) for a in reversed(args)][::-1]
    assert first == again
    # the row layout follows from (D, dtype) alone, the heads from G alone
    for a, p in zip(args, first):
        assert (p.lanes, p.vectors, p.vec) == (lambda r: (r.lanes, r.vectors, r.vec))(
            decode_plan(1, 1, 1, 1, a[4], dtype))
        assert (p.heads, p.groups) == (lambda r: (r.heads, r.groups))(
            decode_plan(1, 1, 1, a[3], 64, dtype))


@pytest.mark.parametrize("dtype", KV_DTYPES, ids=KV_IDS)
def test_a_row_is_covered_by_its_lanes(dtype):
    per = 16 // dtype.itemsize
    for D in range(1, DECODE_MAX_HEAD_DIM + 1):
        p = decode_plan(512, 8, 12, 1, D, dtype)
        span = p.lanes * p.vectors * per
        assert span >= D and (p.lanes == 1 or span // 2 < D)    # the least power of two
        assert p.lanes in (1, 2, 4, 8, 16, 32) and p.vectors in (1, 2)
        assert p.vectors == 1 or (dtype == torch.float32 and D > 128 and p.lanes == 32)
    if dtype == torch.int8:                 # 16 entries a piece: at most 16 lanes
        assert decode_plan(512, 8, 12, 1, 64, dtype).lanes == 4      # GPT-2-S: 8 rows a warp
        assert decode_plan(512, 8, 12, 1, 256, dtype).lanes == 16


@pytest.mark.parametrize("dtype", KV_DTYPES, ids=KV_IDS)
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 12])
def test_q_and_acc_registers_stay_in_the_budget(dtype, G):
    """heads x vectors x entries a piece: <= 64 over float K/V (GT up to
    8), <= 16 over int8 K/V (GT 1), for every D."""
    per = 16 // dtype.itemsize
    budget = 16 if dtype == torch.int8 else 64
    for D in range(1, DECODE_MAX_HEAD_DIM + 1):
        p = decode_plan(512, 2, 2, G, D, dtype)
        assert p.heads * p.vectors * per <= budget, (G, D, p)
    cap = INT8_MAX_HEADS if dtype == torch.int8 else MAX_HEADS
    assert decode_plan(512, 2, 2, G, 64, dtype).heads == min(cap, 1 << (G - 1).bit_length())


def _float_plan_before(capacity, B, KH, G, D, dtype, aligned=True):
    """The f32/bf16 plan as it was before int8 K/V took the split body."""
    per = 16 // dtype.itemsize
    pieces = 1 << (-(-D // per) - 1).bit_length()
    lanes = min(pieces, 32)
    heads = min(8, 1 << (G - 1).bit_length())
    groups = -(-G // heads)
    s = 1
    while s < 8 and 2 * s <= -(-capacity // TILE) and B * KH * groups * s < 2 * SMS:
        s *= 2
    return (s, heads, groups, lanes, pieces // lanes, aligned and D % per == 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_float_plans_are_unchanged(dtype):
    for c in (1, 16, 33, 512, 2048):
        for B, KH in ((1, 12), (8, 12), (64, 16)):
            for G in (1, 3, 8, 12):
                for D in (1, 20, 42, 64, 128, 200, 256):
                    for aligned in (True, False):
                        p = decode_plan(c, B, KH, G, D, dtype, aligned=aligned)
                        assert (p.splits, p.heads, p.groups, p.lanes, p.vectors, p.vec) == \
                            _float_plan_before(c, B, KH, G, D, dtype, aligned)


@pytest.mark.parametrize("dtype", KV_DTYPES, ids=KV_IDS)
def test_vector_loads_only_where_d_dtype_and_pointers_allow(dtype):
    per = 16 // dtype.itemsize
    for D in range(1, DECODE_MAX_HEAD_DIM + 1):
        assert decode_plan(512, 8, 12, 1, D, dtype).vec == (D % per == 0)
        assert not decode_plan(512, 8, 12, 1, D, dtype, aligned=False).vec
    assert decode_plan(512, 8, 12, 1, 42, torch.float32).vec is False     # 168 B rows
    assert decode_plan(512, 8, 12, 1, 20, torch.float32).vec is True      # 80 B rows
    assert decode_plan(512, 8, 12, 1, 20, torch.bfloat16).vec is False    # 40 B rows
    assert decode_plan(512, 8, 12, 1, 64, torch.int8).vec is True         # 64 B rows
    assert decode_plan(512, 8, 12, 1, 40, torch.int8).vec is False        # 40 B rows


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 8, 12, 16])
def test_query_heads_go_in_groups_of_a_power_of_two(G):
    p = decode_plan(512, 2, 2, G, 64, torch.float32)
    assert p.heads in (1, 2, 4, 8) and p.heads * p.groups >= G > (p.groups - 1) * p.heads
    assert p.heads == min(8, 1 << (G - 1).bit_length())


def test_the_plan_refuses_a_head_dim_over_the_cap():
    for dtype in KV_DTYPES:
        decode_plan(512, 1, 1, 1, DECODE_MAX_HEAD_DIM, dtype)
        for D in (0, DECODE_MAX_HEAD_DIM + 1):
            with pytest.raises(ValueError, match="head dim"):
                decode_plan(512, 1, 1, 1, D, dtype)


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 37], ids=["full", "window"])
@pytest.mark.parametrize("capacity", [16, 33, 96, 512])
def test_shares_cover_each_live_position_once(capacity, window):
    """Every length 0..capacity + 1 and every split: the blocks' streams read
    each position of [lo, hi) exactly once and nothing outside it."""
    for length in range(capacity + 2):
        lo, hi = live_range(length, capacity, window)
        for S in (1, 2, 4, 8):
            for streams, U in ((8, 8), (4, 8), (128, 2), (32, 2)):
                read = []
                for rank in range(S):
                    p0, p1 = block_share(lo, hi, S, rank)
                    for rows in stream_rows(p0, p1, streams, U):
                        read += rows
                assert sorted(read) == list(range(lo, hi)), (length, S, streams)


def test_shares_are_equal_runs_of_whole_tiles():
    lo, hi = live_range(255, 512, 0)
    assert [block_share(lo, hi, 4, r) for r in range(4)] == [(0, 64), (64, 128),
                                                               (128, 192), (192, 255)]
    lo, hi = live_range(513, 512, 100)          # L + 1 with a window
    assert (lo, hi) == (413, 512)
    assert [block_share(lo, hi, 2, r) for r in range(2)] == [(413, 448), (448, 512)]
    assert [block_share(0, 0, 8, r) for r in range(8)] == [(0, 0)] * 8


def _slab_case(B, KH, G, D, L, lengths, window, seed):
    q, k, v = _slab(B, KH, G, D, L, seed)
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = decode_plan(L, B, KH, G, D, torch.float32)
    got = emulate(q, slab_rows(k, v), lens, L, plan, window)
    want = flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens, window=window)
    return got, want, plan


@pytest.mark.parametrize("B,KH,G,D,L,window", [
    (4, 12, 1, 64, 512, 0),     # GPT-2-S's heads, the serving capacity
    (3, 12, 1, 64, 512, 100),   # a window
    (3, 2, 4, 64, 96, 0),       # G 4
    (2, 1, 12, 16, 70, 0),      # two head groups of 8
    (3, 1, 4, 42, 2048, 0),     # eight splits of many tiles, a ragged D
], ids=["gpt2s", "window", "g4", "g12", "long"])
def test_emulation_matches_flash_decode_ref(B, KH, G, D, L, window):
    lengths = [0, L + 1, 255, L, 33][:B]
    got, want, plan = _slab_case(B, KH, G, D, L, lengths, window, seed=B + L)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert (got[0] == 0).all()                  # the dead slot: exact zeros


@pytest.mark.parametrize("KH,G,D,PS,MP", [(12, 1, 64, 16, 32), (2, 4, 64, 16, 8),
                                          (2, 4, 32, 1, 96), (1, 8, 64, 48, 11)],
                         ids=["gpt2s", "g4", "ps1", "ps48"])
def test_emulation_matches_paged_decode_ref(KH, G, D, PS, MP):
    lengths = [0, 1, PS, PS + 1, MP * PS - 1, MP * PS]
    B = len(lengths)
    q, kp, vp, bt = _paged(B, KH, G, D, PS, MP, lengths, seed=PS + G)
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = decode_plan(MP * PS, B, KH, G, D, torch.float32)
    got = emulate(q, paged_rows(kp, vp, bt), lens, MP * PS, plan)
    torch.testing.assert_close(got, paged_decode_ref(q, kp, vp, lens, bt),
                               atol=1e-6, rtol=1e-6)
    assert (got[0] == 0).all()


def _quantized(k, v, head_axis):
    kq, ks = quantize_kv_int8(k, head_axis=head_axis)
    vq, vs = quantize_kv_int8(v, head_axis=head_axis)
    return kq, vq, ks, vs


@pytest.mark.parametrize("B,KH,G,D,L,window", [
    (4, 12, 1, 64, 512, 0),     # GPT-2-S's heads, the serving capacity
    (3, 12, 1, 64, 512, 100),   # a window
    (3, 2, 4, 64, 96, 0),       # G 4: four head groups of 1
    (2, 1, 12, 16, 70, 0),      # twelve head groups of 1
    (3, 1, 4, 42, 2048, 0),     # eight splits of many tiles, a ragged D
], ids=["gpt2s", "window", "g4", "g12", "long"])
def test_int8_emulation_matches_flash_decode_q8_ref(B, KH, G, D, L, window):
    q, k, v = _slab(B, KH, G, D, L, seed=B + L + 1)
    kq, vq, ks, vs = _quantized(k, v, 2)
    lens = torch.tensor([0, L + 1, 255, L, 33][:B], dtype=torch.int32)
    plan = decode_plan(L, B, KH, G, D, torch.int8)
    assert plan.heads <= INT8_MAX_HEADS
    got = emulate(q, slab_rows_q8(kq, vq, ks, vs), lens, L, plan, window, entry_bytes=1)
    want = flash_decode_q8_ref(q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, lens,
                               window=window)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert (got[0] == 0).all()                  # the dead slot: exact zeros


@pytest.mark.parametrize("KH,G,D,PS,MP", [(12, 1, 64, 16, 32), (2, 4, 64, 16, 8),
                                          (2, 4, 32, 1, 96), (1, 8, 64, 48, 11)],
                         ids=["gpt2s", "g4", "ps1", "ps48"])
def test_int8_emulation_matches_paged_decode_q8_ref(KH, G, D, PS, MP):
    lengths = [0, 1, PS, PS + 1, MP * PS - 1, MP * PS]
    B = len(lengths)
    q, kp, vp, bt = _paged(B, KH, G, D, PS, MP, lengths, seed=PS + G + 1)
    kq, vq, ks, vs = _quantized(kp, vp, 0)
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = decode_plan(MP * PS, B, KH, G, D, torch.int8)
    got = emulate(q, paged_rows_q8(kq, vq, ks, vs, bt), lens, MP * PS, plan, entry_bytes=1)
    torch.testing.assert_close(got, paged_decode_q8_ref(q, kq, vq, ks, vs, lens, bt),
                               atol=1e-6, rtol=1e-6)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_every_split_gives_the_same_answer(S):
    """The split changes the order of the merge, not the result."""
    B, KH, G, D, L = 3, 2, 2, 32, 300
    q, k, v = _slab(B, KH, G, D, L, seed=4)
    lens = torch.tensor([300, 161, 7], dtype=torch.int32)
    p = decode_plan(L, B, KH, G, D, torch.float32)
    forced = type(p)(S, p.heads, p.groups, p.lanes, p.vectors, p.vec)
    got = emulate(q, slab_rows(k, v), lens, L, forced)
    want = flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_dead_slots_give_exact_zeros():
    B, KH, G, D, L = 3, 2, 4, 64, 64
    q, k, v = _slab(B, KH, G, D, L, seed=1)
    for window in (0, 5):
        lens = torch.tensor([0, 0, 0], dtype=torch.int32)
        plan = decode_plan(L, B, KH, G, D, torch.float32)
        out = emulate(q, slab_rows(k, v), lens, L, plan, window)
        assert (out == 0).all() and not torch.signbit(out).any()


def test_emulation_matches_repro_interpret_kernels():
    """One small shape through repro's Pallas kernels in interpret mode, as
    tests/test_torch_flash_decode.py and test_torch_paged_decode.py run them."""
    B, H, KH, L, D = 3, 4, 2, 64, 32
    q, k, v = _slab(B, KH, H // KH, D, L, seed=7)
    lengths = np.array([0, 40, L], np.int32)
    plan = decode_plan(L, B, KH, H // KH, D, torch.float32)
    got = emulate(q, slab_rows(k, v), torch.from_numpy(lengths), L, plan)
    jo = j_flash_decode(jnp.asarray(q.reshape(B, H, D).numpy()), jnp.asarray(k.numpy()),
                        jnp.asarray(v.numpy()), jnp.asarray(lengths), bk=32, interpret=True)
    np.testing.assert_allclose(got.reshape(B, H, D).numpy(), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)

    PS, MP = 8, 4
    plens = [0, 9, MP * PS]
    q, kp, vp, bt = _paged(B, KH, H // KH, D, PS, MP, plens, seed=8)
    plan = decode_plan(MP * PS, B, KH, H // KH, D, torch.float32)
    got = emulate(q, paged_rows(kp, vp, bt), torch.tensor(plens, dtype=torch.int32),
                  MP * PS, plan)
    jo = j_paged_decode(jnp.asarray(q.reshape(B, 1, H, D).numpy()), jnp.asarray(kp.numpy()),
                        jnp.asarray(vp.numpy()), jnp.asarray(np.array(plens, np.int32)),
                        jnp.asarray(bt.numpy()), interpret=True)
    np.testing.assert_allclose(got.reshape(B, 1, H, D).numpy(), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)


def _j(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("window", [0, 24], ids=["full", "window"])
def test_int8_emulation_matches_repro_interpret_kernels(window):
    """The Int8KV emulation against repro's q8 Pallas kernels in interpret
    mode, as tests/test_torch_flash_decode.py runs them."""
    B, H, KH, L, D = 3, 8, 2, 64, 32
    q, k, v = _slab(B, KH, H // KH, D, L, seed=17)
    kq, vq, ks, vs = _quantized(k, v, 2)
    lengths = np.array([0, 40, L], np.int32)
    plan = decode_plan(L, B, KH, H // KH, D, torch.int8)
    got = emulate(q, slab_rows_q8(kq, vq, ks, vs), torch.from_numpy(lengths), L, plan,
                  window, entry_bytes=1)
    jo = j_flash_decode(*_j(q.reshape(B, H, D), kq, vq), jnp.asarray(lengths),
                        window=window, k_scale=jnp.asarray(ks.numpy()),
                        v_scale=jnp.asarray(vs.numpy()), bk=32, interpret=True)
    np.testing.assert_allclose(got.reshape(B, H, D).numpy(), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)
    assert (got[0] == 0).all()

    PS, MP = 8, 4
    plens = [0, 9, MP * PS]
    q, kp, vp, bt = _paged(B, KH, H // KH, D, PS, MP, plens, seed=18)
    kq, vq, ks, vs = _quantized(kp, vp, 0)
    plan = decode_plan(MP * PS, B, KH, H // KH, D, torch.int8)
    got = emulate(q, paged_rows_q8(kq, vq, ks, vs, bt), torch.tensor(plens, dtype=torch.int32),
                  MP * PS, plan, entry_bytes=1)
    jo = j_paged_decode(*_j(q.reshape(B, 1, H, D), kq, vq),
                        jnp.asarray(np.array(plens, np.int32)), jnp.asarray(bt.numpy()),
                        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
                        bk=8, interpret=True)
    np.testing.assert_allclose(got.reshape(B, 1, H, D).numpy(), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the wrappers hand the plan to the C entries
# ---------------------------------------------------------------------------

@pytest.fixture
def launches(monkeypatch):
    """Run the decode wrappers on CPU tensors with the C entries replaced by
    recorders: returns {entry name: [argument tuples]}."""
    calls = {}

    def entry(lib, name):
        n_ptr, n_int = ops._SIGNATURES[(lib, name)]

        def fn(*args):
            assert len(args) == n_ptr + n_int + 3, (name, len(args))
            calls.setdefault(name, []).append(args)
            return 0
        return fn

    class NoDevice:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(ops, "_entry", entry)
    monkeypatch.setattr(ops, "_on_card", lambda op, **t: t["q"].device)
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(ops.torch.cuda, "device", NoDevice)
    monkeypatch.setattr(ops.build, "check", lambda *a: None)
    monkeypatch.setattr(ops.backend, "count_launch", lambda op: None)
    return calls


def _plan_args(p):
    return (p.splits, p.heads, p.lanes, p.vectors, int(p.vec))


# (q dtype, K/V dtype): the float pair, then the int8 pair under each q
WRAPPED = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.int8), (torch.bfloat16, torch.int8)]
WRAPPED_IDS = ["f32", "bf16", "q8-f32", "q8-bf16"]


def _flash_call(q, k, v, lens, **kw):
    """The slab wrapper for K/V's dtype; returns its C entry's name and the
    index of the first plan int in its arguments."""
    if k.dtype == torch.int8:
        s = torch.ones(k.shape[2])
        ops.flash_decode_q8_kernel(q, k, v, lens, s, s, **kw)
        return "flash_decode_q8_launch", 13
    ops.flash_decode_kernel(q, k, v, lens, **kw)
    return "flash_decode_launch", 11


def _paged_call(q, kp, vp, lens, bt):
    if kp.dtype == torch.int8:
        s = torch.ones(kp.shape[0])
        ops.paged_decode_q8_kernel(q, kp, vp, lens, bt, s, s)
        return "paged_decode_q8_launch", 15
    ops.paged_decode_kernel(q, kp, vp, lens, bt)
    return "paged_decode_launch", 13


@pytest.mark.parametrize("dtype", WRAPPED, ids=WRAPPED_IDS)
@pytest.mark.parametrize("B,KH,G,D,L", [(8, 12, 1, 64, 512), (1, 12, 1, 64, 512),
                                        (3, 2, 3, 42, 33), (2, 1, 8, 256, 2048)])
def test_flash_decode_wrapper_passes_its_plan(launches, dtype, B, KH, G, D, L):
    qd, kd = dtype
    q = torch.zeros(B, KH, G, D, dtype=qd)
    k = torch.zeros(B, L, KH, D, dtype=kd)
    name, at = _flash_call(q, k, k.clone(), torch.zeros(B, dtype=torch.int32), window=5)
    (args,) = launches[name]
    assert args[at - 6:at] == (B, KH, G, D, L, 5)
    assert args[at:at + 5] == _plan_args(decode_plan(L, B, KH, G, D, kd))
    assert args[at + 6] == (0 if qd == torch.float32 else 1)


@pytest.mark.parametrize("qd", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L", [(4, 4, 8, 128, 65), (3, 2, 3, 42, 33)])
def test_flash_decode_partial_wrapper_passes_its_plan(launches, qd, B, KH, G, D, L):
    """The partial softmax is csrc/decode_partial.cu's kernel: it takes
    partial_plan's split, warps, stages and copy width over the piece and
    writes three f32 outputs: m and l (B, KH, G), o (B, KH, G, D)."""
    q = torch.zeros(B, KH, G, D, dtype=qd)
    k = torch.zeros(B, L, KH, D, dtype=qd)
    m, l, o = ops.flash_decode_partial_kernel(q, k, k.clone(), torch.zeros(B, dtype=torch.int32))
    (args,) = launches["flash_decode_partial_launch"]
    assert ops._SIGNATURES[("decode_partial", "flash_decode_partial_launch")] == (7, 9)
    assert args[7:12] == (B, KH, G, D, L)
    p = partial_plan(L, B, KH, G, D, qd)
    assert args[12:16] == (p.splits, p.warps, p.stages, int(p.vec))
    assert args[16] == D ** -0.5 and args[17] == (0 if qd == torch.float32 else 1)
    assert args[4:7] == (m.data_ptr(), l.data_ptr(), o.data_ptr())
    assert [tuple(t.shape) for t in (m, l, o)] == [(B, KH, G), (B, KH, G), (B, KH, G, D)]
    assert all(t.dtype == torch.float32 for t in (m, l, o))


@pytest.mark.parametrize("PS,MP", [(16, 32), (1, 100), (48, 3)])
def test_paged_decode_wrapper_passes_its_plan(launches, PS, MP):
    B, KH, G, D = 4, 2, 4, 64
    q = torch.zeros(B, KH, G, D)
    pool = torch.zeros(KH, B * MP + 1, PS, D)
    ops.paged_decode_kernel(q, pool, pool.clone(), torch.zeros(B, dtype=torch.int32),
                            torch.zeros(B, MP, dtype=torch.int32))
    (args,) = launches["paged_decode_launch"]
    assert args[6:13] == (B, KH, G, D, B * MP + 1, PS, MP)
    assert args[13:18] == _plan_args(decode_plan(MP * PS, B, KH, G, D, torch.float32))


@pytest.mark.parametrize("qd", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("PS,MP,G", [(16, 32, 1), (1, 100, 4), (48, 3, 8)])
def test_paged_decode_q8_wrapper_passes_its_plan(launches, qd, PS, MP, G):
    B, KH, D = 4, 2, 64
    q = torch.zeros(B, KH, G, D, dtype=qd)
    pool = torch.zeros(KH, B * MP + 1, PS, D, dtype=torch.int8)
    name, at = _paged_call(q, pool, pool.clone(), torch.zeros(B, dtype=torch.int32),
                           torch.zeros(B, MP, dtype=torch.int32))
    (args,) = launches[name]
    assert name == "paged_decode_q8_launch"
    assert args[8:15] == (B, KH, G, D, B * MP + 1, PS, MP)
    plan = decode_plan(MP * PS, B, KH, G, D, torch.int8)
    assert args[15:20] == _plan_args(plan) and plan.heads == min(G, INT8_MAX_HEADS)
    assert args[21] == (0 if qd == torch.float32 else 1)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["float", "int8"])
def test_an_unaligned_base_takes_element_loads(launches, kv):
    B, KH, G, D, L = 2, 2, 1, 64, 40
    q = torch.zeros(B, KH, G, D)
    buf = torch.zeros(B * L * KH * D + 1, dtype=kv)
    k = buf[1:].view(B, L, KH, D)
    assert k.data_ptr() % 16 and k.is_contiguous()
    lens = torch.zeros(B, dtype=torch.int32)
    name, at = _flash_call(q, k, k, lens)
    _flash_call(q, k.clone(), k.clone(), lens)
    pool = buf[1:].view(KH, B * L // 16, 16, D)
    bt = torch.zeros(B, 2, dtype=torch.int32)
    pname, pat = _paged_call(q, pool, pool, lens, bt)
    _paged_call(q, pool.clone(), pool.clone(), lens, bt)
    for n, i in ((name, at), (pname, pat)):
        unaligned, aligned = launches[n]
        assert unaligned[i + 4] == 0 and aligned[i + 4] == 1
        assert unaligned[i:i + 4] == aligned[i:i + 4]


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["float", "int8"])
def test_the_wrappers_raise_over_the_head_dim_cap(launches, kv):
    D = DECODE_MAX_HEAD_DIM + 8
    q = torch.zeros(1, 1, 1, D)
    with pytest.raises(ValueError, match="head dim"):
        _flash_call(q, torch.zeros(1, 4, 1, D, dtype=kv), torch.zeros(1, 4, 1, D, dtype=kv),
                    torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="head dim"):
        _paged_call(q, torch.zeros(1, 2, 4, D, dtype=kv), torch.zeros(1, 2, 4, D, dtype=kv),
                    torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32))
    assert not launches
