"""The port's launch-plan tuners (``kernels/lora_matmul/tune.py``,
``kernels/flash_attention/tune.py``, ``kernels/autotune.py``) without the
card, mirroring ``repro``'s tuner tests (tests/test_kernels.py,
test_multitenant.py, test_flash_decode.py, test_paged_kv.py): memo hits
and clears, memos kept apart, the heuristic plan on the CPU and within
abstract evaluation, every candidate keeping the heuristic plan's order
of addition and naming an instantiated kernel, the decode body's
emulated order bit-equal over every ``heads`` candidate, and the
launchers handing their C entry the tuner's winner (the entries replaced
by recorders, the timer stubbed) with no tuning launch counted."""
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune, backend            # noqa: E402
from repro_torch.kernels.flash_attention import (best_decode_block,  # noqa: E402
                                                 best_paged_block, clear_paged_cache)
from repro_torch.kernels.flash_attention import clear_cache as clear_decode_cache  # noqa: E402
from repro_torch.kernels.flash_attention.plan import (INT8_MAX_HEADS,  # noqa: E402
                                                      MAX_HEADS, DecodePlan, decode_plan,
                                                      rows_in_flight)
from repro_torch.kernels.lora_matmul import (best_blocks, best_gather_blocks,  # noqa: E402
                                             clear_cache)
from repro_torch.kernels.lora_matmul.plan import (DECODE, DECODE_COL_TILES,  # noqa: E402
                                                  DECODE_ROW_TILES, TILE, TILE_SHAPES,
                                                  TUNED_TILES, dx_plan, forward_plan,
                                                  q8_dx_plan, q8_forward_plan,
                                                  ring_holds_tile)

from test_torch_decode_split import _slab, emulate, slab_rows   # noqa: E402

lora_tune = importlib.import_module("repro_torch.kernels.lora_matmul.tune")
decode_tune = importlib.import_module("repro_torch.kernels.flash_attention.tune")
lora_ops = importlib.import_module("repro_torch.kernels.lora_matmul.ops")
decode_ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)      # a key only: nothing here touches a card
F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
# the main path's LoRA shapes: GPT-2-S, Mamba2's ssm_in / ssm_out, the
# front ends, yi-9b's TP-local down; ragged ones
LORA_SHAPES = [(8, 768, 768), (16, 768, 768), (17, 768, 768), (200, 2560, 10576),
               (200, 5120, 2560), (768, 768, 768), (1280, 2048, 2048), (512, 5504, 4096),
               (33, 70, 45), (1, 7, 1)]
DECODE_SHAPES = [(8, 12, 1, 512, 64), (4, 4, 8, 512, 128), (2, 2, 4, 64, 64),
                 (3, 2, 3, 33, 42), (2, 1, 2, 2048, 256), (1, 8, 5, 300, 128)]


@pytest.fixture(autouse=True)
def _memos():
    """Each test starts and ends with empty memos: a stubbed timer's winner
    must not reach another test's CPU launch."""
    for clear in (clear_cache, clear_decode_cache, clear_paged_cache):
        clear()
    autotune.reset_stats()
    yield
    for clear in (clear_cache, clear_decode_cache, clear_paged_cache):
        clear()
    autotune.reset_stats()


# ---------------------------------------------------------------------------
# memos
# ---------------------------------------------------------------------------

def test_a_hit_returns_the_memoized_plan_and_clear_cache_empties_both_memos():
    p = best_blocks(768, 768, 768, 4, F32, CPU)
    assert best_blocks(768, 768, 768, 4, F32, CPU) is p
    g = best_gather_blocks(8, 768, 768, 4, 8, F32, torch.int32, CPU)
    assert best_gather_blocks(8, 768, 768, 4, 8, F32, torch.int32, CPU) is g
    assert len(lora_tune._CACHE) == len(lora_tune._GATHER_CACHE) == 1
    clear_cache()
    assert not lora_tune._CACHE and not lora_tune._GATHER_CACHE


def test_decode_memos_hit_and_clear_apart():
    d = best_decode_block(8, 12, 1, 512, 64, F32, CPU)
    pg = best_paged_block(8, 12, 1, 32, 16, 64, F32, CPU)
    assert best_decode_block(8, 12, 1, 512, 64, F32, CPU) is d
    assert best_paged_block(8, 12, 1, 32, 16, 64, F32, CPU) is pg
    assert len(decode_tune._CACHE) == len(decode_tune._PAGED_CACHE) == 1
    clear_paged_cache()
    assert len(decode_tune._CACHE) == 1 and not decode_tune._PAGED_CACHE
    clear_decode_cache()
    assert not decode_tune._CACHE


def test_the_memos_are_kept_apart():
    M, K, N, r = 40, 768, 770, 4
    fwd = best_blocks(M, K, N, r, F32, CPU)
    assert best_blocks(M, K, N, r, F32, CPU, problem="dx") == dx_plan(M, K, N)
    assert best_blocks(M, K, N, r, F32, CPU, I8) == q8_forward_plan(M, K, N)
    assert best_blocks(M, K, N, r, F32, CPU, I8, problem="dx") == q8_dx_plan(M, K, N)
    assert best_blocks(M, K, N, r, BF16, CPU) == forward_plan(M, K, N, 2)
    assert best_blocks(M, K, N, r, F32, CPU, aligned=False) == forward_plan(M, K, N, 4, False)
    assert best_blocks(M, K, N, r, F32, CPU, regime=DECODE) == forward_plan(M, K, N, 4,
                                                                           True, DECODE)
    assert fwd == forward_plan(M, K, N)
    assert len(lora_tune._CACHE) == 7 and not lora_tune._GATHER_CACHE
    # a forced regime that is the default one shares the default's key
    assert best_blocks(M, K, N, r, F32, CPU, regime=TILE) is fwd
    # the gather: its own memo, keyed by pool size and index dtype too
    for pool, idx in ((4, torch.int32), (8, torch.int32), (4, torch.int64)):
        assert best_gather_blocks(M, K, N, r, pool, F32, idx, CPU) == fwd
    assert len(lora_tune._GATHER_CACHE) == 3 and len(lora_tune._CACHE) == 7
    # f32 vs int8 K/V, slab vs paged
    B, KH, G, D = 8, 4, 8, 128
    assert best_decode_block(B, KH, G, 512, D, F32, CPU) == decode_plan(512, B, KH, G, D, F32)
    assert best_decode_block(B, KH, G, 512, D, F32, CPU, I8) == decode_plan(512, B, KH, G, D, I8)
    assert best_paged_block(B, KH, G, 32, 16, D, F32, CPU, I8) == decode_plan(512, B, KH, G, D,
                                                                              I8)
    assert len(decode_tune._CACHE) == 2 and len(decode_tune._PAGED_CACHE) == 1


def test_the_device_is_part_of_the_key():
    best_blocks(768, 768, 768, 4, F32, CPU)
    best_blocks(768, 768, 768, 4, F32, "cpu")
    best_blocks(768, 768, 768, 4, F32, torch.device("meta"))
    assert len(lora_tune._CACHE) == 2


# ---------------------------------------------------------------------------
# off the card: plan.py's plan, nothing launched
# ---------------------------------------------------------------------------

def _fail_launch():
    raise AssertionError("nothing may be launched off the card")


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_cpu_and_abstract_evaluation_give_the_heuristic_plans(dtype):
    e = dtype.itemsize
    for M, K, N in LORA_SHAPES:
        for r in (1, 4, 64):
            want = {("forward", None): forward_plan(M, K, N, e),
                    ("dx", None): dx_plan(M, K, N, e),
                    ("forward", I8): q8_forward_plan(M, K, N, e),
                    ("dx", I8): q8_dx_plan(M, K, N, e)}
            for (problem, w_dtype), plan in want.items():
                assert best_blocks(M, K, N, r, dtype, CPU, w_dtype, problem=problem,
                                   run=_fail_launch) == plan
                with backend.abstract_evaluation():
                    for dev in (CARD, torch.device("meta")):
                        assert best_blocks(M, K, N, r, dtype, dev, w_dtype, problem=problem,
                                           run=_fail_launch) == plan
            assert best_gather_blocks(M, K, N, r, 8, dtype, torch.int32, CPU,
                                      run=_fail_launch) == want[("forward", None)]
    for B, KH, G, L, D in DECODE_SHAPES:
        for kv in (dtype, I8):
            want = decode_plan(L, B, KH, G, D, kv)
            assert best_decode_block(B, KH, G, L, D, dtype, CPU, kv, run=_fail_launch) == want
            with backend.abstract_evaluation():
                assert best_decode_block(B, KH, G, L, D, dtype, CARD, kv,
                                         run=_fail_launch) == want
                assert best_paged_block(B, KH, G, -(-L // 16), 16, D, dtype, CARD, kv,
                                        run=_fail_launch) == decode_plan(
                                            -(-L // 16) * 16, B, KH, G, D, kv)
    # a CUDA key within abstract evaluation is not memoized: the card times it later
    assert all(k[7] != CARD for k in lora_tune._CACHE)
    assert all(k[7] != CARD for k in decode_tune._CACHE)
    assert not decode_tune._PAGED_CACHE
    assert autotune.STATS == {"keys": 0, "candidates": 0, "launches": 0, "ms": 0.0}


# ---------------------------------------------------------------------------
# the candidates
# ---------------------------------------------------------------------------

# the (rows, columns) each C dispatch instantiates: lora_matmul.cu's decode
# cases, and the tile cases of lora_matmul.cu (forward, gather),
# lora_matmul_bwd.cu (dX) and lora_matmul_q8.cu (q8 forward and dX) by
# copy width: the tuner's shapes only with 16-byte copies
DECODE_INSTANCES = {(bm, bn) for bm in (8, 16) for bn in (32, 64, 128)}


def c_tiles(problem, elem_bytes, w_bytes, vec):
    tiles = {(64, 64), (32, 32)}
    if vec:
        tiles |= {(64, 128)} if problem == "dx" else {(64, 128), (32, 64)}
        if (problem, elem_bytes, w_bytes) == ("forward", 2, 1):
            tiles.discard((64, 128))
    return tiles


def test_the_tile_shapes_are_the_c_dispatchs():
    assert set(TILE_SHAPES) == c_tiles("forward", 4, 4, False)
    assert set(TILE_SHAPES + TUNED_TILES[False]) == c_tiles("forward", 4, 4, True)
    assert set(TILE_SHAPES + TUNED_TILES[True]) == c_tiles("dx", 4, 4, True)
    assert set(DECODE_ROW_TILES) == {8, 16} and set(DECODE_COL_TILES) == {32, 64, 128}
    # every ring holds every tile but the bf16 q8 forward's 64 x 128
    for e, w in ((4, 4), (2, 2), (4, 1), (2, 1)):
        for bm, bn in TILE_SHAPES + TUNED_TILES[False]:
            for rq in (False, True):
                assert ring_holds_tile(e, w, bm, bn, rq) == (
                    (e, w, bm, bn, rq) != (2, 1, 64, 128, False))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_every_lora_candidate_keeps_the_order_and_names_a_kernel(dtype):
    e = dtype.itemsize
    for M, K, N in LORA_SHAPES + [(M, 768, 768) for M in (1, 2, 5, 9, 12, 15)]:
        for problem, w_bytes, aligned in itertools.product(("forward", "dx"), (e, 1),
                                                            (True, False)):
            plan = lora_tune.heuristic_plan(problem, M, K, N, e, w_bytes == 1, aligned)
            cands = lora_tune.candidates(plan, M, e, w_bytes, problem == "dx")
            assert cands[0] == plan and len(set(cands)) == len(cands)
            for c in cands:
                assert (c.regime, c.splits, c.vec) == (plan.regime, plan.splits, plan.vec)
                if c.regime == DECODE:
                    assert c.col_tile == plan.col_tile
                    assert (c.row_tile, c.col_tile) in DECODE_INSTANCES
                    assert c.row_tile >= M or c.row_tile == plan.row_tile
                else:
                    assert (c.row_tile, c.col_tile) in c_tiles(problem, e, w_bytes,
                                                               plan.vec)
                    assert ring_holds_tile(e, w_bytes, c.row_tile, c.col_tile,
                                           problem == "dx")
            want = (2 if M <= 8 else 1) if plan.regime == DECODE else len(
                c_tiles(problem, e, w_bytes, plan.vec))
            assert len(cands) == want, (M, K, N, problem, w_bytes, cands)


@pytest.mark.parametrize("kv", [F32, BF16, I8], ids=["f32", "bf16", "int8"])
def test_every_decode_candidate_keeps_the_order_and_names_a_kernel(kv):
    for B, KH, G, L, D in DECODE_SHAPES + [(2, 2, G, 64, 64) for G in (1, 2, 3, 4, 5, 8, 16)]:
        plan = decode_plan(L, B, KH, G, D, kv)
        cands = decode_tune.candidates(plan, G, kv)
        assert cands[0] == plan
        for c in cands:
            assert (c.splits, c.lanes, c.vectors, c.vec) == (plan.splits, plan.lanes,
                                                            plan.vectors, plan.vec)
            assert c.heads & (c.heads - 1) == 0 and 1 <= c.heads <= plan.heads
            assert c.heads <= (INT8_MAX_HEADS if kv == I8 else MAX_HEADS)
            assert c.groups == -(-G // c.heads)
            assert rows_in_flight(c, kv) == rows_in_flight(plan, kv)
        # every smaller power of two with the heuristic's rows in flight
        others = {gt for gt in (1, 2, 4) if gt < plan.heads
                  and rows_in_flight(DecodePlan(plan.splits, gt, 1, plan.lanes,
                                                plan.vectors, plan.vec), kv)
                  == rows_in_flight(plan, kv)}
        assert {c.heads for c in cands[1:]} == others
    # the main path's decode shapes have one candidate: GPT-2-S's G 1 and
    # yi-9b's G 8 (8 heads a block take 4 rows in flight, 4 heads 8)
    assert decode_tune.candidates(decode_plan(512, 8, 12, 1, 64, kv), 1, kv) == [
        decode_plan(512, 8, 12, 1, 64, kv)]
    assert len(decode_tune.candidates(decode_plan(512, 8, 4, 8, 128, kv), 8, kv)) == 1
    if kv == F32:
        assert [c.heads for c in decode_tune.candidates(
            decode_plan(512, 4, 8, 2, 128, kv), 2, kv)] == [2, 1]      # InternVL2-2B's G 2


@pytest.mark.parametrize("G,D,dtype", [(4, 64, F32), (3, 42, F32), (2, 128, F32),
                                       (2, 256, F32), (2, 64, BF16)])
def test_the_emulated_order_is_bit_equal_over_every_heads_candidate(G, D, dtype):
    """The decode body's order (tests/test_torch_decode_split.py's
    emulation, each head's products apart as in the kernel) gives equal
    bits under every candidate; a GT with other rows in flight does not."""
    B, KH, L = 2, 2, 300
    q, k, v = (t.to(dtype).float() for t in _slab(B, KH, G, D, L, seed=G * D))
    lens = torch.tensor([300, 141], dtype=torch.int32)
    plan = decode_plan(L, B, KH, G, D, dtype)
    cands = decode_tune.candidates(plan, G, dtype)
    assert len(cands) > 1
    outs = [emulate(q, slab_rows(k, v), lens, L, c, entry_bytes=dtype.itemsize,
                    per_head=True) for c in cands]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    ref = emulate(q, slab_rows(k, v), lens, L, plan, entry_bytes=dtype.itemsize)
    torch.testing.assert_close(outs[0], ref, atol=1e-6, rtol=1e-6)


def test_a_heads_candidate_with_other_rows_in_flight_changes_the_bits():
    B, KH, G, D, L = 2, 2, 8, 128, 300
    q, k, v = _slab(B, KH, G, D, L, seed=5)
    lens = torch.tensor([300, 141], dtype=torch.int32)
    plan = decode_plan(L, B, KH, G, D, F32)
    four = DecodePlan(plan.splits, 4, 2, plan.lanes, plan.vectors, plan.vec)
    assert (rows_in_flight(plan, F32), rows_in_flight(four, F32)) == (4, 8)
    assert four not in decode_tune.candidates(plan, G, F32)
    a, b = (emulate(q, slab_rows(k, v), lens, L, p, per_head=True) for p in (plan, four))
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the launchers take the tuner's winner; tuning launches are not counted
# ---------------------------------------------------------------------------

class NoDevice:
    def __init__(self, dev):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for a card's: the tuners measure (timer stubbed:
    a plan's time is ``times[plan]``, after one launch of it), the C
    entries record their arguments, ``count_launch`` counts.  Returns
    (calls {entry: [args]}, counted {op: n}, times)."""
    calls, counted, times = {}, {}, {}

    def bind(lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            calls.setdefault(name, []).append(args)
            return 0
        return fn

    def entry(lib, name):
        n_ptr, n_int = decode_ops._SIGNATURES[(lib, name)]

        def fn(*args):
            assert len(args) == n_ptr + n_int + 3, (name, len(args))
            calls.setdefault(name, []).append(args)
            return 0
        return fn

    def time_plan(device, run, plan, what):
        run(plan)
        autotune.STATS["launches"] += 1
        return [times.get(plan, 10.0)] * 4 + [times.get(plan, 10.0) + 0.5] * 3

    for mod in (lora_ops, decode_ops):
        monkeypatch.setattr(mod, "_stream", lambda dev: 0)
        monkeypatch.setattr(mod.build, "check", lambda *a: None)
        monkeypatch.setattr(mod.backend, "count_launch",
                            lambda op: counted.__setitem__(op, counted.get(op, 0) + 1))
    monkeypatch.setattr(lora_ops, "_bind", bind)
    monkeypatch.setattr(lora_ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(decode_ops, "_entry", entry)
    monkeypatch.setattr(decode_ops, "_on_card", lambda op, **t: t["q"].device)
    monkeypatch.setattr(torch.cuda, "device", NoDevice)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(autotune, "measures", lambda device: True)
    monkeypatch.setattr(autotune, "time_plan", time_plan)
    return calls, counted, times


def _tile(bm, bn, plan):
    return type(plan)(TILE, bm, bn, plan.splits, plan.vec)


def test_the_forward_launcher_hands_its_entry_the_winner(card):
    calls, counted, times = card
    M, K, N, r = 200, 768, 768, 4
    plan = forward_plan(M, K, N)
    times[_tile(32, 64, plan)] = 7.0          # beats 10 by more than the spread 0.5
    x, w, a, b = torch.zeros(M, K), torch.zeros(K, N), torch.zeros(r, K), torch.zeros(N, r)
    for _ in range(2):
        lora_ops.lora_matmul_kernel(x, w, a, b, 2.0)
    fwd = calls["lora_matmul_fwd_launch"]
    assert len(fwd) == 4 + 2                  # one stubbed timing launch a candidate, two calls
    assert [c[11:16] for c in fwd[:4]] == [
        (TILE, bm, bn, plan.splits, 1) for bm, bn in
        [(plan.row_tile, plan.col_tile)] + [s for s in TILE_SHAPES + TUNED_TILES[False]
                                            if s != (plan.row_tile, plan.col_tile)]]
    assert fwd[4][11:16] == fwd[5][11:16] == (TILE, 32, 64, plan.splits, 1)
    assert counted == {"lora_matmul": 2}
    assert autotune.STATS["keys"] == 1 and autotune.STATS["candidates"] == 4
    assert autotune.STATS["launches"] == 4


def test_a_candidate_within_the_spread_keeps_the_heuristic_plan(card):
    calls, counted, times = card
    M, K, N, r = 8, 768, 768, 4
    plan = forward_plan(M, K, N)
    assert plan.regime == DECODE and plan.row_tile == 8
    times[type(plan)(DECODE, 16, plan.col_tile, plan.splits, plan.vec)] = 9.6
    lora_ops.lora_matmul_kernel(torch.zeros(M, K), torch.zeros(K, N), torch.zeros(r, K),
                                torch.zeros(N, r), 2.0)
    fwd = calls["lora_matmul_fwd_launch"]
    assert [c[12] for c in fwd] == [8, 16, 8] and counted == {"lora_matmul": 1}


def test_the_other_lora_launchers_take_the_winner(card):
    calls, counted, times = card
    M, K, N, r, A = 256, 768, 768, 8, 3
    for plan in (forward_plan(M, K, N), dx_plan(M, K, N), q8_forward_plan(M, K, N),
                 q8_dx_plan(M, K, N)):
        times[_tile(64, 128, plan)] = 3.0
    x, dy, w, a, b = (torch.zeros(M, K), torch.zeros(M, N), torch.zeros(K, N),
                      torch.zeros(r, K), torch.zeros(N, r))
    wq, ws = torch.zeros(K, N, dtype=I8), torch.ones(N)
    lora_ops.lora_matmul_gather_kernel(x, w, torch.zeros(A, r, K), torch.zeros(A, N, r),
                                       torch.zeros(M, dtype=torch.int32), 2.0)
    lora_ops.lora_matmul_dx_kernel(dy, w, a, b, 2.0)
    lora_ops.lora_matmul_q8_kernel(x, wq, ws, a, b, 2.0)
    lora_ops.lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, 2.0)
    for name, at, n in (("lora_matmul_gather_launch", 14, 4), ("lora_matmul_dx_launch", 11, 3),
                        ("lora_matmul_q8_fwd_launch", 12, 4), ("lora_matmul_q8_dx_launch", 12, 3)):
        got = calls[name]
        assert len(got) == n + 1 and got[-1][at:at + 2] == (64, 128), name
    assert counted == {"lora_matmul_gather": 1, "lora_matmul_dx": 1, "lora_matmul_q8": 1,
                       "lora_matmul_q8_dx": 1}
    assert autotune.STATS["keys"] == 4


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_the_decode_launchers_take_the_winner_timed_at_full_capacity(card, paged):
    calls, counted, times = card
    B, KH, G, D, L = 3, 2, 4, 64, 64
    plan = decode_plan(L, B, KH, G, D, F32)
    one = DecodePlan(plan.splits, 1, G, plan.lanes, plan.vectors, plan.vec)
    times[one] = 2.0
    q = torch.zeros(B, KH, G, D)
    lens = torch.tensor([5, 64, 0], dtype=torch.int32)
    if paged:
        kp = torch.zeros(KH, 9, 16, D)
        bt = torch.zeros(B, 4, dtype=torch.int32)
        decode_ops.paged_decode_kernel(q, kp, kp.clone(), lens, bt)
        got, at = calls["paged_decode_launch"], 13
    else:
        k = torch.zeros(B, L, KH, D)
        decode_ops.flash_decode_kernel(q, k, k.clone(), lens, window=7)
        got, at = calls["flash_decode_launch"], 11
        assert [c[at - 1] for c in got] == [0, 0, 0, 7]       # timed without a window
    assert [c[at:at + 5][1] for c in got] == [4, 2, 1, 1]
    assert got[-1][at:at + 5] == (plan.splits, 1, plan.lanes, plan.vectors, int(plan.vec))
    # the timing launches read a scratch lengths, the counted one the caller's
    assert {c[3] for c in got[:3]} != {lens.data_ptr()} and got[-1][3] == lens.data_ptr()
    assert counted == {("paged_decode" if paged else "flash_decode"): 1}


def test_the_int8_kv_pair_has_one_candidate_and_times_nothing(card):
    calls, counted, times = card
    B, KH, G, D, L = 2, 2, 4, 64, 64
    q, k = torch.zeros(B, KH, G, D), torch.zeros(B, L, KH, D, dtype=I8)
    s = torch.ones(KH)
    decode_ops.flash_decode_q8_kernel(q, k, k.clone(), torch.zeros(B, dtype=torch.int32), s, s)
    assert len(calls["flash_decode_q8_launch"]) == 1
    assert autotune.STATS["keys"] == 0 and len(decode_tune._CACHE) == 1


def test_a_miss_under_stream_capture_raises(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="stream capture"):
        best_blocks(768, 768, 768, 4, F32, CPU, run=lambda p: None)
    with pytest.raises(RuntimeError, match="stream capture"):
        best_decode_block(2, 2, 4, 64, 64, F32, CPU, run=lambda p, n: None)
    # a key with one candidate needs no timing, under capture too
    assert best_decode_block(8, 12, 1, 512, 64, F32, CPU) == decode_plan(512, 8, 12, 1, 64, F32)


def test_a_candidate_the_entry_refuses_raises_naming_the_plan():
    plan = forward_plan(768, 768, 768)

    def refuse(p):
        raise RuntimeError("lora_matmul: CUDA error 1 at launch: invalid argument")

    with pytest.raises(RuntimeError, match=r"candidate Plan\(regime=1, row_tile=64"):
        autotune.time_plan(CPU, refuse, plan, "lora_matmul forward tuner")


def test_pick_keeps_the_heuristic_unless_beaten_by_more_than_its_spread():
    h = [10.0, 10.2, 10.1, 9.9, 10.0, 10.3, 9.8]          # IQR 0.3
    assert autotune.pick(["h", "a"], [h, [9.8] * 7]) == "h"
    assert autotune.pick(["h", "a", "b"], [h, [9.0] * 7, [8.5] * 7]) == "b"
    assert autotune.pick(["h", "a"], [h, [np.nextafter(10.0, 0)] * 7]) == "h"
