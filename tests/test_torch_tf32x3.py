"""The arithmetic and the launch plans of the LoRA kernels' two regimes,
held on the CPU before the card.

* 3xTF32: the tile regime of ``csrc/lora_mma.cuh`` splits each f32
  operand v into big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big)
  and accumulates small*big + big*small + big*big in f32.  Emulated here in
  torch with the integer form the kernel rounds with, (bits + 0x1000) &
  ~0x1fff (round to nearest, ties away from zero, on the 13 mantissa bits
  TF32 drops), at the main path's shapes with phase 4's input
  distributions: three passes keep f32 accuracy, one pass does not, and a
  bf16 operand is exact in TF32 (so bf16 takes one pass).
* The int8-base pair on the same tile: every int8 value is exact in TF32,
  so only the f32 operand is split and two passes (small*W_q + big*W_q)
  keep f32 accuracy against f64 dequantize-first, with the scale after
  the reduction (forward) or folded into dY before the split (dX).
* The plan (``kernels/lora_matmul/plan.py``): which regime, split and tile
  the CUDA launchers get (and the rank reduce's padded rank, columns per
  thread and splits of M), and that the wrappers hand it over unchanged.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.lora_matmul.plan import (DECODE, DECODE_MAX_M, MAX_SPLITS,
                                                  MIN_SPLIT_ROWS, MIN_TILE_SPLIT_ROWS,
                                                  RR_MAX_ACC, RR_MIN_SPLIT_ROWS, SMS,
                                                  TILE, decode_split, dx_plan,
                                                  forward_plan, q8_dx_plan,
                                                  q8_forward_plan, rank_reduce_plan,
                                                  tile_splits)
from repro_torch.precision import quantize_weight_int8

ops = importlib.import_module("repro_torch.kernels.lora_matmul.ops")

TOL = dict(atol=1e-4, rtol=1e-4)        # chip_smoke.py's f32 lora_matmul / GRAD_TOL
SHAPES = [(8, 2560, 10576), (8, 5120, 2560), (768, 768, 768)]   # ssm_in, ssm_out, SFL


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 explicit mantissa bits of an f32, round
    to nearest with ties away from zero (add half of the dropped 13 bits'
    range to the magnitude, then clear them)."""
    bits = v.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split3(v: torch.Tensor):
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def product_3x(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the tile computes it: the three TF32 products (each exact
    in f32) summed into one f32 accumulator."""
    xb, xs = split3(x)
    wb, ws = split3(w)
    return torch.cat([xs, xb, xb], 1) @ torch.cat([wb, ws, wb], 0)


def inputs(M, K, N, seed=0):
    # phase 4's distributions: x ~ N(0, 1), W ~ N(0, 1/K)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32))
    return x, w


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                     # TF32's unit in the last place at 1.0
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      1 + ulp / 4, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(v), want)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    t = tf32_rna(r)
    assert not bool((t.view(torch.int32) & 0x1FFF).any())          # 13 bits dropped
    assert bool(((t - r).abs() <= r.abs() * 2.0 ** -11).all())      # half an ulp


def test_big_plus_small_keeps_22_bits():
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(1 << 16).astype(np.float32))
    big, small = split3(r)
    err = (r.double() - big.double() - small.double()).abs()
    assert bool((err <= r.double().abs() * 2.0 ** -22).all())


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_three_pass_tf32_keeps_f32_accuracy(M, K, N):
    x, w = inputs(M, K, N)
    exact = x.double() @ w.double()
    y3 = product_3x(x, w)
    d3 = (y3.double() - exact).abs().max().item()
    d32 = ((x @ w).double() - exact).abs().max().item()
    assert torch.allclose(y3.double(), exact, **TOL)
    assert d3 <= 4 * d32, (d3, d32)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_single_pass_tf32_misses_the_f32_tolerance(M, K, N):
    x, w = inputs(M, K, N)
    y1 = tf32_rna(x) @ tf32_rna(w)
    assert not torch.allclose(y1.double(), x.double() @ w.double(), **TOL)


def test_bf16_is_exact_in_tf32():
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(1 << 16).astype(np.float32))
    v = r.to(torch.bfloat16).float()
    big, small = split3(v)
    assert torch.equal(big, v) and not bool(small.any())


# ---------------------------------------------------------------------------
# the int8-base pair: two passes, W_q whole
# ---------------------------------------------------------------------------

Q8_SHAPES = [(256, 768, 768), (768, 768, 768), (200, 5120, 2560)]   # client, server, ssm_out


def q8_inputs(M, K, N, seed=0):
    """x, W_q, s as phase 4 draws them (W ~ N(0, 1/K), quantized per
    column) and dY ~ N(0, 1); the f64 dequantize-first products beside."""
    x, w = inputs(M, K, N, seed)
    wq, s = quantize_weight_int8(w)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((M, N))
                          .astype(np.float32))
    w64 = wq.double() * s.double()
    return x, wq, s, dy, x.double() @ w64, dy.double() @ w64.T


def q8_forward_2x(x, wq, s):
    """The tile's f32 forward: x split, W_q whole (exact), both passes into
    one f32 sum, s applied after the reduction."""
    xb, xs = split3(x)
    wf = wq.float()
    return (torch.cat([xs, xb], 1) @ torch.cat([wf, wf], 0)) * s


def q8_dx_2x(dy, wq, s):
    """The tile's f32 dX: dY * s rounded once in f32, then split; W_q
    whole."""
    lb, ls = split3(dy * s)
    wt = wq.float().T
    return torch.cat([ls, lb], 1) @ torch.cat([wt, wt], 0)


def test_every_int8_value_is_exact_in_tf32():
    v = torch.arange(-128, 128, dtype=torch.float32)
    big, small = split3(v)
    assert torch.equal(tf32_rna(v), v) and torch.equal(big, v) and not bool(small.any())


@pytest.mark.parametrize("M,K,N", Q8_SHAPES)
def test_two_pass_q8_keeps_f32_accuracy(M, K, N):
    x, wq, s, dy, fwd64, dx64 = q8_inputs(M, K, N)
    wf = wq.float() * s                         # the plain path: dequantize, f32 matmul
    for got, plain, exact in ((q8_forward_2x(x, wq, s), x @ wf, fwd64),
                              (q8_dx_2x(dy, wq, s), dy @ wf.T, dx64)):
        d2 = (got.double() - exact).abs().max().item()
        d32 = (plain.double() - exact).abs().max().item()
        assert torch.allclose(got.double(), exact, **TOL)
        assert d2 <= 4 * d32, (d2, d32)


@pytest.mark.parametrize("M,K,N", Q8_SHAPES)
def test_single_pass_q8_misses_the_f32_tolerance(M, K, N):
    x, wq, s, dy, fwd64, dx64 = q8_inputs(M, K, N)
    wf = wq.float()
    assert not torch.allclose(((tf32_rna(x) @ wf) * s).double(), fwd64, **TOL)
    assert not torch.allclose((tf32_rna(dy * s) @ wf.T).double(), dx64, **TOL)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

KN = [(768, 768), (2560, 10576), (5120, 2560), (100, 70), (300, 129), (7, 1), (70, 45)]


def blocks(p, M, P):
    """Blocks in the plan's grid for an (M, P) output."""
    return -(-M // p.row_tile) * -(-P // p.col_tile) * p.splits


def order_key(p):
    """The plan's fields that fix the order in which a row's terms are
    summed: the split and, in the decode regime, the column tile (which
    sets the block's k lanes); the mma tile's shape does not (32-deep
    chunks in order within a split, whatever the tile)."""
    return (p.regime, p.col_tile, p.splits) if p.regime == DECODE else (p.regime, p.splits)


@pytest.mark.parametrize("K,N", KN)
def test_plan_depends_on_m_only_through_the_threshold(K, N):
    dec = {order_key(forward_plan(M, K, N)) for M in range(1, DECODE_MAX_M + 1)}
    til = {order_key(forward_plan(M, K, N)) for M in (DECODE_MAX_M + 1, 40, 200, 256, 768)}
    assert len(dec) == 1 and len(til) == 1
    assert dec.pop()[0] == DECODE and til.pop()[0] == TILE
    assert {forward_plan(M, K, N).row_tile for M in range(1, 9)} == {8}
    assert {forward_plan(M, K, N).row_tile for M in range(9, DECODE_MAX_M + 1)} == {16}
    assert order_key(dx_plan(5, K, N)) == order_key(dx_plan(768, K, N))


@pytest.mark.parametrize("K,N", KN)
def test_splits_are_powers_of_two_of_enough_rows(K, N):
    bn, s = decode_split(K, N)
    assert bn in (32, 64, 128) and s & (s - 1) == 0 and 1 <= s <= MAX_SPLITS
    assert s == 1 or K // s >= MIN_SPLIT_ROWS
    t = tile_splits(K, N)
    assert t & (t - 1) == 0 and 1 <= t <= MAX_SPLITS
    assert t == 1 or K // t >= MIN_TILE_SPLIT_ROWS


@pytest.mark.parametrize("M,K,N,want", [
    (8, 768, 768, (DECODE, 8, 32, 8)),      # GPT-2-S decode: 24 x 8 = 192 blocks
    (16, 768, 768, (DECODE, 16, 32, 8)),    # paged prefill chunk
    (8, 2560, 10576, (DECODE, 8, 128, 2)),  # Mamba2 ssm_in: 83 x 2 = 166
    (8, 5120, 2560, (DECODE, 8, 128, 8)),   # Mamba2 ssm_out: 20 x 8 = 160
    (200, 2560, 10576, (TILE, 64, 64, 2)),  # Mamba2 prefill: 4 x 166 x 2
    (200, 5120, 2560, (TILE, 64, 64, 8)),   # 4 x 40 x 8
    (17, 768, 768, (TILE, 32, 32, 4)),      # 1 x 24 x 4 (no shape reaches 132)
    (256, 768, 768, (TILE, 64, 64, 4)),     # one client's rows: 4 x 12 x 4 = 192
    (768, 768, 768, (TILE, 64, 64, 4)),     # the server's rows: 12 x 12 x 4 = 576
])
def test_plan_fills_the_card_at_the_main_paths_shapes(M, K, N, want):
    p = forward_plan(M, K, N)
    assert (p.regime, p.row_tile, p.col_tile, p.splits) == want
    assert p.vec and (blocks(p, M, N) >= SMS or M < 32)


@pytest.mark.parametrize("M", [256, 768])
def test_dx_plan_fills_the_card(M):
    p = dx_plan(M, 768, 768)
    assert p.regime == TILE and blocks(p, M, 768) >= SMS and p.vec


@pytest.mark.parametrize("M,K,N,dx", [(5, 100, 70, False), (33, 300, 129, False),
                                      (33, 70, 45, True), (1, 7, 1, False)])
def test_unaligned_pitches_choose_element_copies(M, K, N, dx):
    p = dx_plan(M, K, N) if dx else forward_plan(M, K, N)
    assert not p.vec
    assert forward_plan(8, 768, 768).vec and forward_plan(40, 768, 768).vec
    assert not forward_plan(8, 768, 768, aligned=False).vec
    # bf16 moves 8 elements per 16 bytes: N = 772 is whole in f32, not in bf16
    assert forward_plan(40, 768, 772).vec and not forward_plan(40, 768, 772, 2).vec
    assert not forward_plan(40, 770, 768).vec        # the tile also streams x's rows
    assert forward_plan(8, 770, 768).vec             # the decode streams only W's


@pytest.mark.parametrize("K,N", KN)
def test_q8_plans_are_the_tile_with_splits_from_k_and_n_only(K, N):
    for M in (1, 8, DECODE_MAX_M, DECODE_MAX_M + 1, 200, 256, 768):
        f, d = q8_forward_plan(M, K, N), q8_dx_plan(M, K, N)
        assert f.regime == d.regime == TILE
        assert f.splits == tile_splits(K, N) and d.splits == tile_splits(N, K)
        assert (f.row_tile, f.col_tile) in ((64, 64), (32, 32))
        assert (d.row_tile, d.col_tile) in ((64, 64), (32, 32))


@pytest.mark.parametrize("K,N,fwd_vec,dx_vec", [
    (768, 768, True, True),
    (768, 45, False, False), (768, 301, False, False),      # ragged N: every pitch
    (7, 768, False, True), (70, 768, False, True),          # ragged K: x's rows only
    (768, 772, False, False),     # whole 16 bytes in f32 dY, not in int8 W_q rows
])
def test_q8_ragged_pitches_choose_element_copies(K, N, fwd_vec, dx_vec):
    assert q8_forward_plan(256, K, N).vec == fwd_vec
    assert q8_dx_plan(256, K, N).vec == dx_vec
    assert not q8_forward_plan(256, K, N, aligned=False).vec
    assert not q8_dx_plan(256, K, N, aligned=False).vec


@pytest.fixture
def launches(monkeypatch):
    """Run the kernel wrappers on CPU tensors with the C entries replaced
    by recorders: returns {entry name: [argument tuples]}."""
    calls = {}

    def bind(lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
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

    monkeypatch.setattr(ops, "_bind", bind)
    monkeypatch.setattr(ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(ops.torch.cuda, "device", NoDevice)
    monkeypatch.setattr(ops.backend, "count_launch", lambda op: None)
    return calls


@pytest.mark.parametrize("M", [1, 8, DECODE_MAX_M, DECODE_MAX_M + 1, 40, 200])
def test_gather_and_single_adapter_entries_get_the_same_plan(launches, M):
    K, N, r, A = 768, 768, 4, 3
    x, w = torch.zeros(M, K), torch.zeros(K, N)
    ops.lora_matmul_kernel(x, w, torch.zeros(r, K), torch.zeros(N, r), 2.0)
    ops.lora_matmul_gather_kernel(x, w, torch.zeros(A, r, K), torch.zeros(A, N, r),
                                  torch.zeros(M, dtype=torch.int32), 2.0)
    (one,), (pool,) = launches["lora_matmul_fwd_launch"], launches["lora_matmul_gather_launch"]
    p = forward_plan(M, K, N)
    want = (p.regime, p.row_tile, p.col_tile, p.splits, int(p.vec))
    assert one[11:16] == want and pool[13:18] == want
    assert one[5:9] == (M, K, N, r) and pool[6:11] == (M, K, N, r, A)


def test_dx_wrapper_passes_its_plan(launches):
    M, K, N, r = 256, 768, 770, 4
    ops.lora_matmul_dx_kernel(torch.zeros(M, N), torch.zeros(K, N), torch.zeros(r, K),
                              torch.zeros(N, r), 2.0)
    (args,) = launches["lora_matmul_dx_launch"]
    p = dx_plan(M, K, N)
    assert args[5:9] == (M, K, N, r)
    assert args[11:15] == (p.row_tile, p.col_tile, p.splits, 0) and p.splits == 4


def test_a_forced_regime_reaches_the_launch(launches):
    x, w = torch.zeros(32, 768), torch.zeros(768, 768)
    a, b = torch.zeros(4, 768), torch.zeros(768, 4)
    ops.lora_matmul_kernel(x, w, a, b, 1.0, regime=DECODE)
    ops.lora_matmul_kernel(x, w, a, b, 1.0)
    forced, chosen = launches["lora_matmul_fwd_launch"]
    assert forced[11:15] == (DECODE, 16, 32, 8) and chosen[11] == TILE


@pytest.mark.parametrize("M,K,N", [(256, 768, 768), (768, 768, 770), (33, 70, 45)])
def test_q8_wrappers_pass_their_plan(launches, M, K, N):
    r = 8
    wq, ws = torch.zeros(K, N, dtype=torch.int8), torch.ones(N)
    ops.lora_matmul_q8_kernel(torch.zeros(M, K), wq, ws, torch.zeros(r, K),
                              torch.zeros(N, r), 2.0)
    ops.lora_matmul_q8_dx_kernel(torch.zeros(M, N), wq, ws, torch.zeros(r, K),
                                 torch.zeros(N, r), 2.0)
    (fwd,), (dx,) = launches["lora_matmul_q8_fwd_launch"], launches["lora_matmul_q8_dx_launch"]
    for args, p in ((fwd, q8_forward_plan(M, K, N)), (dx, q8_dx_plan(M, K, N))):
        assert args[6:10] == (M, K, N, r) and args[11] == 0          # f32
        assert args[12:16] == (p.row_tile, p.col_tile, p.splits, int(p.vec))


# ---------------------------------------------------------------------------
# the rank reduce's plan: one launch over a cluster that splits M
# ---------------------------------------------------------------------------

RR_SHAPES = [(768, 768), (256, 768), (33, 45), (1, 7), (5000, 70), (771, 770), (129, 13),
             (300, 99), (64, 1), (1023, 1030)]
RANKS = [1, 2, 3, 4, 5, 8, 16, 33, 64]
V_DTYPES = [torch.float32, torch.bfloat16]


def split_rows(M, splits):
    """The rows [lo, hi) each block of the rank reduce's cluster sums, as
    csrc/lora_matmul_bwd.cu computes them: ceil(M / splits) rows a block,
    the last block the rest."""
    per = -(-M // splits)
    return [(min(M, s * per), min(M, s * per + per)) for s in range(splits)]


@pytest.mark.parametrize("M,N", RR_SHAPES)
def test_rank_reduce_covers_every_row_once(M, N):
    for r in RANKS:
        p = rank_reduce_plan(M, r, N, torch.float32)
        rows = [m for lo, hi in split_rows(M, p.splits) for m in range(lo, hi)]
        assert rows == list(range(M)), (M, r, p)


@pytest.mark.parametrize("dtype", V_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", RANKS)
def test_rank_reduce_plan_fits_its_limits(dtype, r):
    for M, N in RR_SHAPES:
        p = rank_reduce_plan(M, r, N, dtype)
        assert p.rank_pad >= r and p.rank_pad & (p.rank_pad - 1) == 0
        assert p.rank_pad == 1 or p.rank_pad // 2 < r             # the smallest such
        assert p.cols * p.rank_pad <= RR_MAX_ACC
        assert p.cols * dtype.itemsize <= 16                      # one load of <= 16 bytes
        assert 1 <= p.splits <= MAX_SPLITS and p.splits & (p.splits - 1) == 0
        assert p.splits == 1 or -(-M // p.splits) >= RR_MIN_SPLIT_ROWS


def test_rank_reduce_plan_depends_only_on_m_r_n_and_dtype():
    for M, N in RR_SHAPES:
        for r in RANKS:
            for dtype in V_DTYPES:
                assert rank_reduce_plan(M, r, N, dtype) == rank_reduce_plan(M, r, N, dtype)
        # the split of M depends on M alone: every rank, width and dtype agree
        splits = {rank_reduce_plan(M, r, n, dt).splits for r in RANKS for n in (N, N + 1)
                  for dt in V_DTYPES}
        assert len(splits) == 1
    # the main path: the server's and a client's rows, at the phase 6 and fleet ranks
    assert rank_reduce_plan(768, 4, 768, torch.float32).splits == 8
    assert rank_reduce_plan(256, 8, 768, torch.float32).splits == 4
    assert rank_reduce_plan(768, 4, 768, torch.float32).cols == 4
    assert rank_reduce_plan(768, 4, 768, torch.bfloat16).cols == 8


@pytest.mark.parametrize("dtype", V_DTYPES, ids=["f32", "bf16"])
def test_rank_reduce_vec_only_where_pitch_and_pointer_allow(dtype):
    for M, N in RR_SHAPES:
        for r in RANKS:
            p = rank_reduce_plan(M, r, N, dtype)
            assert p.vec == (p.cols > 1 and N % p.cols == 0)
            assert not rank_reduce_plan(M, r, N, dtype, aligned=False).vec
    assert rank_reduce_plan(768, 4, 768, dtype).vec
    assert not rank_reduce_plan(771, 3, 770, torch.bfloat16).vec     # 770 % 8
    assert not rank_reduce_plan(771, 3, 771, torch.float32).vec      # 771 % 4


@pytest.mark.parametrize("dtype", V_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("M,r,N", [(768, 4, 768), (256, 8, 768), (771, 3, 770), (300, 64, 99)])
def test_rank_reduce_wrapper_passes_its_plan(launches, dtype, M, r, N):
    u, v = torch.zeros(M, r), torch.zeros(M, N, dtype=dtype)
    ops.lora_rank_reduce_kernel(u, v)
    (args,) = launches["lora_rank_reduce_launch"]
    p = rank_reduce_plan(M, r, N, dtype, v.data_ptr() % 16 == 0)
    assert args[3:7] == (M, r, N, 0 if dtype == torch.float32 else 1)
    assert args[7:11] == (p.rank_pad, p.cols, p.splits, int(p.vec))
    assert "lora_rank_reduce_splits" not in launches           # one entry, one launch
