"""The partial-softmax decode kernel (``csrc/decode_partial.cu``) without
the card: its launch plan (``kernels/flash_attention/plan.py::
partial_plan``) and a torch emulation of the kernel's order of work.

The emulation follows the kernel: a block serves 8 query heads of one
(slot, KV head); cluster rank r takes an equal contiguous share of the
piece's live 16-position tiles and its warp w the share's tiles w, w +
warps, ...; a tile's scores are S^T = K q^T in 3xTF32 (bf16 operands
whole: exact in TF32), each 8-deep k step into a zeroed fragment, added in
f32 in order, scaled after; the online softmax keeps a running max a head
and a sum a head and row group (rows gid and gid + 8 of the tile), summed
over the row groups by the warp's xor butterfly at the end; each tile's
O^T = V^T P^T (P f32, split; V split in f32, whole in bf16), each 8
positions into a zeroed fragment, joins the output as acc * alpha + (the
two halves' sum); the warps merge in warp order, the cluster's blocks in
rank order, each record weighted by exp(m - M) computed once a head.  It is held against ``flash_decode_partial_ref``
(1e-5, f32 and bf16 operands: the products are exact or 3xTF32), one TF32
pass misses that, and its pieces over tp 2, 4 and 8, joined as
``sharding.tp.lse_combine`` joins them, against ``repro``'s flash_decode
in interpret mode on the whole cache (f32 1e-5, bf16 3e-2)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_decode as j_flash_decode

from repro_torch.kernels.flash_attention import flash_decode_partial_ref
from repro_torch.kernels.flash_attention.plan import (MAX_SPLITS, PARTIAL_HEADS,
                                                      PARTIAL_MAX_STAGES, PARTIAL_MAX_WARPS,
                                                      PARTIAL_SMEM, PARTIAL_TILE, SMS,
                                                      partial_padded_dim, partial_plan,
                                                      partial_smem)
from test_torch_tf32x3 import split3, tf32_rna

NEG_INF = -1e30
SMEM_MAX = 232448          # dynamic shared memory a block may use
KC = 8                  # depth of a zeroed score fragment: one k step
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)       # repro's own decode tolerance


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def warp_tiles(hi, S, NW, rank, warp):
    """The tiles warp ``warp`` of cluster rank ``rank`` walks, in order."""
    tiles = -(-hi // PARTIAL_TILE)
    per = -(-tiles // S)
    return list(range(rank * per + warp, min(tiles, (rank + 1) * per), NW))


PLAN_SHAPES = [(65, 4, 4, 8, 128), (520, 4, 4, 8, 128), (4096, 4, 4, 8, 128),
               (64, 8, 12, 1, 64), (65, 2, 2, 16, 256), (16, 1, 1, 1, 1), (33, 3, 2, 3, 42),
               (2048, 64, 16, 8, 128), (1, 1, 1, 8, 256)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity,B,KH,G,D", PLAN_SHAPES)
def test_every_live_position_is_covered_once(dtype, capacity, B, KH, G, D):
    p = partial_plan(capacity, B, KH, G, D, dtype)
    for hi in range(capacity + 1):
        seen = [t * PARTIAL_TILE + j for r in range(p.splits) for w in range(p.warps)
                for t in warp_tiles(hi, p.splits, p.warps, r, w)
                for j in range(PARTIAL_TILE) if t * PARTIAL_TILE + j < hi]
        assert sorted(seen) == list(range(hi))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity,B,KH,G,D", PLAN_SHAPES)
def test_the_plan_depends_only_on_its_arguments_and_fits_a_block(dtype, capacity, B, KH, G, D):
    p = partial_plan(capacity, B, KH, G, D, dtype)
    partial_plan(7, 3, 1, 5, 17, torch.bfloat16)      # another plan in between changes nothing
    assert partial_plan(capacity, B, KH, G, D, dtype) == p
    assert p.splits in (1, 2, 4, 8) and p.groups == -(-G // PARTIAL_HEADS)
    assert 1 <= p.warps <= PARTIAL_MAX_WARPS and 1 <= p.stages <= PARTIAL_MAX_STAGES
    assert partial_smem(D, dtype, p.warps, p.stages) <= PARTIAL_SMEM < SMEM_MAX
    assert D <= partial_padded_dim(D) and partial_padded_dim(D) % 32 == 0
    assert p.vec == (D % (16 // dtype.itemsize) == 0)
    assert not partial_plan(capacity, B, KH, G, D, dtype, aligned=False).vec


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity,B,KH,G,D", PLAN_SHAPES)
def test_the_grid_reaches_the_sm_count_where_the_tiles_allow(dtype, capacity, B, KH, G, D):
    """S doubles until the cluster is full, every tile of the capacity has
    a block or the doubled grid would pass the SM count; 4 warps a block
    and as many stages as a warp's share of tiles (at most 3), fewer only
    where two blocks would not fit an SM."""
    p = partial_plan(capacity, B, KH, G, D, dtype)
    tiles = -(-capacity // PARTIAL_TILE)
    units = B * KH * p.groups
    assert p.splits == MAX_SPLITS or p.splits >= tiles or units * 2 * p.splits > SMS
    assert p.splits == 1 or (p.splits // 2 < tiles and units * p.splits <= SMS)
    assert p.warps == PARTIAL_MAX_WARPS or partial_smem(D, dtype, p.warps + 1, 1) > PARTIAL_SMEM
    assert partial_smem(D, dtype, p.warps, p.stages) <= PARTIAL_SMEM
    want = min(PARTIAL_MAX_STAGES, -(-tiles // (p.splits * PARTIAL_MAX_WARPS)))
    assert p.stages == want or partial_smem(D, dtype, p.warps, p.stages + 1) > PARTIAL_SMEM


def test_the_plan_at_the_main_paths_pieces():
    """yi-9b's piece at tp 8 (B 4, KH 4, G 8, D 128, Lc 65: 5 tiles), a
    piece of 520 and a decode_32k piece (Lc 4096): 8 blocks of 4 warps a
    unit (128 blocks), one stage a warp in f32 and two in bf16, so that
    two blocks fit an SM; GPT-2-S's piece at tp 8 (B 8, KH 12, G 1, D 64,
    Lc 64: 96 units) one block a unit; f32 D 256 keeps 2 warps."""
    def plan(*args):
        p = partial_plan(*args)
        return p.splits, p.warps, p.stages, p.groups

    f32, bf16 = torch.float32, torch.bfloat16
    assert plan(65, 4, 4, 8, 128, f32) == (8, 4, 1, 1)
    assert plan(520, 4, 4, 8, 128, f32) == (8, 4, 1, 1)
    assert plan(4096, 4, 4, 8, 128, f32) == (8, 4, 1, 1)
    assert plan(4096, 4, 4, 8, 128, bf16) == (8, 4, 2, 1)
    assert plan(64, 8, 12, 1, 64, f32) == (1, 4, 1, 1)
    assert plan(4096, 1, 1, 8, 256, f32) == (8, 2, 1, 1)
    assert plan(4096, 1, 1, 16, 256, bf16) == (8, 4, 1, 2)


def test_the_plan_refuses_a_head_dim_over_256():
    with pytest.raises(ValueError, match="head dim"):
        partial_plan(64, 1, 1, 8, 264, torch.float32)


# ---------------------------------------------------------------------------
# the kernel's order of work, in torch
# ---------------------------------------------------------------------------

def product_3x(a, b):
    """a @ b in 3xTF32 into one zeroed fragment: the three exact products
    (small*big + big*small + big*big) summed in f32."""
    ab, as_ = split3(a)
    bb, bs = split3(b)
    return torch.cat([as_, ab, ab], -1) @ torch.cat([bb, bs, bb], -2)


def product_1x(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _merge(states):
    """(m, l, acc) records merged as the kernel merges warps or ranks: the
    largest max, then each record rescaled to it and added in order."""
    mm = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(mm)
    acc = torch.zeros_like(states[0][2])
    for m, l_, a in states:
        w = torch.exp(m - mm)
        l = l + w * l_
        acc = acc + w[:, None] * a
    return mm, l, acc


def _butterfly(x):
    """The xor butterfly over the 8 row groups (last axis): pairs, then
    pairs of pairs, then the halves."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def warp_walk(qg, kt, vt, tiles, hi, D, scale, split, product):
    """One warp over its tiles: qg (8, DP) the block's heads, kt/vt (L, D)
    the KV head's rows; returns (m (8,), l (8,), acc (8, D))."""
    dp = qg.shape[1]
    m = torch.full((PARTIAL_HEADS,), NEG_INF)
    lp = torch.zeros(PARTIAL_HEADS, PARTIAL_TILE // 2)         # a head's row-group parts
    acc = torch.zeros(PARTIAL_HEADS, D)
    for t in tiles:
        rows = torch.arange(t * PARTIAL_TILE, (t + 1) * PARTIAL_TILE)
        live = rows < hi
        kz = torch.zeros(PARTIAL_TILE, dp)
        vz = torch.zeros(PARTIAL_TILE, dp)
        kz[live, :D] = kt[rows[live]]
        vz[live, :D] = vt[rows[live]]
        s = torch.zeros(PARTIAL_TILE, PARTIAL_HEADS)
        for c in range(0, dp, KC):
            chunk = (product(kz[:, c:c + KC], qg[:, c:c + KC].T) if split
                     else kz[:, c:c + KC] @ qg[:, c:c + KC].T)
            s = s + chunk
        s = torch.where(live[:, None], s * scale, torch.tensor(NEG_INF))
        mn = torch.maximum(m, s.amax(0))
        alpha = torch.exp(m - mn)
        m = mn
        p = torch.where(live[:, None], torch.exp(s - mn), torch.tensor(0.0))
        lp = lp * alpha[:, None] + (p[:8] + p[8:]).T
        halves = []
        for h in (slice(0, 8), slice(8, 16)):       # 8 positions a zeroed fragment
            if split:
                halves.append(product(vz[h].T, p[h]))
            else:                                   # V exact in TF32, P split
                pb, ps = split3(p[h])
                halves.append(torch.cat([vz[h].T, vz[h].T], 1) @ torch.cat([ps, pb], 0))
        acc = acc * alpha[:, None] + (halves[0] + halves[1]).T[:, :D]
    return m, _butterfly(lp), acc


def emulate(q, k, v, lengths, plan, product=product_3x):
    """The kernel on q (B, KH, G, D), k/v (B, L, KH, D) (f32 or bf16 values
    as f32): (m, l, o) f32."""
    B, KH, G, D = q.shape
    L = k.shape[1]
    dp = partial_padded_dim(D)
    split = q.dtype == torch.float32
    qf, kf, vf = q.float(), k.float(), v.float()
    m_out = torch.empty(B, KH, G)
    l_out = torch.empty(B, KH, G)
    o_out = torch.empty(B, KH, G, D)
    for b in range(B):
        hi = max(0, min(int(lengths[b]), L))
        for h in range(KH):
            for grp in range(plan.groups):
                g0 = grp * PARTIAL_HEADS
                n = min(G, g0 + PARTIAL_HEADS) - g0
                qg = torch.zeros(PARTIAL_HEADS, dp)
                qg[:n, :D] = qf[b, h, g0:g0 + n]
                ranks = [_merge([warp_walk(qg, kf[b, :, h], vf[b, :, h],
                                           warp_tiles(hi, plan.splits, plan.warps, r, w), hi,
                                           D, D ** -0.5, split, product)
                                 for w in range(plan.warps)])
                         for r in range(plan.splits)]
                mm, l, acc = _merge(ranks)
                m_out[b, h, g0:g0 + n] = mm[:n]
                l_out[b, h, g0:g0 + n] = l[:n]
                o_out[b, h, g0:g0 + n] = acc[:n]
    return m_out, l_out, o_out


def _case(B, KH, G, D, L, dtype, seed):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, KH, G, D)), dtype=torch.float32).to(dtype)
    k = torch.tensor(rng.standard_normal((B, L, KH, D)), dtype=torch.float32).to(dtype)
    v = torch.tensor(rng.standard_normal((B, L, KH, D)), dtype=torch.float32).to(dtype)
    return q, k, v


def _ref(q, k, v, lengths):
    return flash_decode_partial_ref(q, k.transpose(1, 2), v.transpose(1, 2), lengths)


# (B, KH, G, D, L): yi-9b's heads (G 8) at D 64, G 1 (GPT-2-S), G 3 and 16
# (two head groups, one ragged), D 20 and 42 (element copies), 256
EMU_CASES = [(3, 2, 8, 64, 65), (4, 3, 1, 64, 64), (3, 1, 3, 42, 40), (2, 1, 16, 20, 33),
             (2, 1, 8, 256, 24)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L", EMU_CASES)
def test_emulation_matches_flash_decode_partial_ref(dtype, B, KH, G, D, L):
    """Lengths 0 (m -1e30, l 0, o 0 exactly), 1, a tile's edge and past
    the piece, at the plan's split and at every split and warp count."""
    q, k, v = _case(B, KH, G, D, L, dtype, seed=B + G + D + L)
    lengths = torch.tensor([0, L + 1, 1, 16, 17][:B], dtype=torch.int32)
    want = _ref(q, k, v, lengths)
    plans = [partial_plan(L, B, KH, G, D, dtype)]
    plans += [plans[0].__class__(s, w, 1, plans[0].groups, True) for s, w in ((1, 1), (8, 3))]
    for plan in plans:
        got = emulate(q, k, v, lengths, plan)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, **F32)
        assert bool((got[0][0] == NEG_INF).all()) and bool((got[1][0] == 0).all())
        assert bool((got[2][0] == 0).all())


def test_one_tf32_pass_misses_the_tolerance():
    """The split is what holds f32: one TF32 pass per product lies ~1e-3
    off."""
    q, k, v = _case(2, 1, 8, 64, 48, torch.float32, seed=3)
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    plan = partial_plan(48, 2, 1, 8, 64, torch.float32)
    want = _ref(q, k, v, lengths)
    e3 = max((g_ - w_).abs().max().item() for g_, w_ in zip(emulate(q, k, v, lengths, plan),
                                                           want))
    e1 = max((g_ - w_).abs().max().item()
             for g_, w_ in zip(emulate(q, k, v, lengths, plan, product=product_1x), want))
    assert e3 < 1e-5 < e1


def _lse_join(parts):
    """``sharding.tp.lse_combine``'s formula over the pieces' (m, l, o)."""
    M = torch.stack([p_[0] for p_ in parts]).amax(0)
    w = [torch.exp(p_[0] - M) for p_ in parts]
    l = sum(wi * p_[1] for wi, p_ in zip(w, parts))
    o = sum(wi[..., None] * p_[2] for wi, p_ in zip(w, parts))
    return o / l[..., None]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_pieces_joined_match_repro_on_the_whole_cache(dtype, tp):
    """The cache cut into tp pieces, each with its live prefix clamp(length
    - r Lc, 0, Lc), emulated at each piece's plan and joined, against
    repro's flash_decode (interpret mode) on the whole cache."""
    B, KH, G, D, L = 4, 2, 4, 32, 64
    q, k, v = _case(B, KH, G, D, L, dtype, seed=50 + tp)
    lengths = torch.tensor([1, L // 2 + 3, L, L + 1], dtype=torch.int32)
    Lc = L // tp
    plan = partial_plan(Lc, B, KH, G, D, dtype)
    parts = [emulate(q, k[:, r * Lc:(r + 1) * Lc], v[:, r * Lc:(r + 1) * Lc],
                     (lengths - r * Lc).clamp(0, Lc), plan) for r in range(tp)]
    got = _lse_join(parts).reshape(B, KH * G, D)
    as_j = (lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)) if dtype == torch.bfloat16 \
        else (lambda t: jnp.asarray(t.numpy()))
    jo = j_flash_decode(as_j(q.reshape(B, KH * G, D)), as_j(k), as_j(v),
                        jnp.asarray(lengths.numpy()), bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jo, np.float32),
                               **(F32 if dtype == torch.float32 else BF16))
