"""The port's slab serving path against ``repro`` on the same weights
(GPT-2-S cut to 2 layers at d 64): prefill logits and caches (1e-5),
``decode_step`` from one cache through ``interop`` with a per-slot
position vector (1e-4), ``generate()`` greedy ids, and the slab
``ServingEngine`` — identical greedy ids to ``repro``'s
``ServingEngine(paged=False)`` and to the port's paged engine, the naive
loop identical to the fused step, bucketed prefill identical to exact,
gap-length prompts, the ``paged=None`` rule, sampling independent of
arrival order, and no silent move to the CPU."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.models.generate import SampleConfig as JSampleConfig  # noqa: E402
from repro.models.generate import generate as j_generate    # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.models.generate import SampleConfig        # noqa: E402
from repro_torch.serving import Request, ServingEngine, bucket_len  # noqa: E402

KW = dict(num_layers=2, d_model=64, vocab=128)
ENG = dict(max_slots=3, max_len=48, page_size=8)
GREEDY = SampleConfig(greedy=True)


def _weights(seed=0):
    jcfg = j_get_arch("gpt2-s").reduced(**KW)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    lora = jax.tree.map(np.asarray, JM.init_lora_stack(jcfg, jax.random.key(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    return jcfg, params, lora


def _port(params, lora):
    return (t_get_arch("gpt2-s").reduced(**KW),
            interop.params_from_numpy(params, device="cpu"),
            interop.lora_from_numpy(lora, device="cpu"))


def _requests(n=7, seed=0, gen=6, lo=1, hi=20):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 128, int(rng.integers(lo, hi))).tolist(), gen)
            for i in range(n)]


def _serve_port(params, lora, reqs, **kw):
    cfg, tp, tl = _port(params, lora)
    eng = ServingEngine(cfg, tp, lora=tl, device="cpu", **{**ENG, **kw})
    rs = [Request(uid=u, prompt=list(p), max_new_tokens=g) for u, p, g in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in rs)
    return eng, [r.output for r in rs]


RUNTIMES = [("plain", TM.Runtime(), JM.Runtime(attn_impl="naive")),
            ("serve", TM.default_serve_runtime(), JM.default_serve_runtime())]


@pytest.mark.parametrize("name,trt,jrt", RUNTIMES, ids=[r[0] for r in RUNTIMES])
@pytest.mark.parametrize("cache_len,logit_index", [(0, None), (24, None), (16, 9)],
                         ids=["exact", "longer-cache", "bucket-padded"])
def test_prefill_logits_and_caches_match_repro(name, trt, jrt, cache_len, logit_index):
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    toks = np.random.default_rng(1).integers(1, 128, (2, 16)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt,
                        cache_len=cache_len, logit_index=logit_index)
    tl_, tc = TM.prefill(cfg, tp, torch.from_numpy(toks), lora=tl, rt=trt,
                         cache_len=cache_len, logit_index=logit_index)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    back = interop.slab_cache_to_numpy(tc, len(jcfg.pattern))
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jc))
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,trt,jrt", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_decode_step_matches_repro_from_the_same_cache(name, trt, jrt):
    """repro prefills three slots; its cache crosses through interop and
    both packages decode one step with each slot at its own position."""
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    toks = np.random.default_rng(2).integers(1, 128, (3, 12)).astype(np.int32)
    _, jc = JM.prefill(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt, cache_len=20)
    tc = interop.slab_cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc[0]["pos"].dtype == torch.int32 and len(tc) == cfg.num_layers
    last = np.array([[5], [77], [3]], np.int32)
    pos = np.array([12, 9, 4], np.int32)           # slot 1, 2 rewind inside their rows
    jl, jc2 = JM.decode_step(jcfg, params, jnp.asarray(last), jc, jnp.asarray(pos),
                             lora=lora, rt=jrt)
    tl2, tc2 = TM.decode_step(cfg, tp, torch.from_numpy(last), tc, torch.from_numpy(pos),
                              lora=tl, rt=trt)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc2)),
                    jax.tree.leaves(interop.slab_cache_to_numpy(tc2, len(jcfg.pattern)))):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    # a scalar position decodes every slot there
    jl3, _ = JM.decode_step(jcfg, params, jnp.asarray(last), jc2, jnp.int32(13),
                            lora=lora, rt=jrt)
    tl3, _ = TM.decode_step(cfg, tp, torch.from_numpy(last), tc2, 13, lora=tl, rt=trt)
    np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), atol=1e-4, rtol=1e-4)


def test_slab_cache_interop_round_trip():
    jcfg, params, lora = _weights()
    jc = jax.tree.map(np.asarray, JM.init_cache(jcfg, 2, 8, jnp.float32))
    tc = interop.slab_cache_from_numpy(jc, device="cpu")
    assert tuple(tc[0]["k"].shape) == (2, 8, jcfg.num_kv_heads, jcfg.head_dim)
    tc0 = TM.init_cache(t_get_arch("gpt2-s").reduced(**KW), 2, 8, device="cpu")
    for a, b in zip(tc, tc0):
        for n in ("k", "v", "pos"):
            assert torch.equal(a[n], b[n])
    back = interop.slab_cache_to_numpy(tc, len(jcfg.pattern))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,trt,jrt", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_generate_greedy_ids_identical_to_repro(name, trt, jrt):
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    toks = np.random.default_rng(3).integers(1, 128, (2, 7)).astype(np.int32)
    jo, jd = j_generate(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt,
                        max_new_tokens=8, sc=JSampleConfig(greedy=True))
    to, td = TM.generate(cfg, tp, torch.from_numpy(toks), lora=tl, rt=trt,
                         max_new_tokens=8, sc=GREEDY)
    assert to.dtype == torch.int32 and tuple(to.shape) == (2, 8)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # an eos that row 0 emits stops it; the loop then runs on for row 1
    eos = int(jo[0, 2])
    jo, jd = j_generate(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt,
                        max_new_tokens=8, sc=JSampleConfig(greedy=True, eos_id=eos))
    to, td = TM.generate(cfg, tp, torch.from_numpy(toks), lora=tl, rt=trt,
                         max_new_tokens=8, sc=SampleConfig(greedy=True, eos_id=eos))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert bool(td[0])


def test_slab_engine_ids_identical_to_repro_and_to_the_paged_engine():
    jcfg, params, lora = _weights()
    reqs = _requests()
    jeng = JEngine(jcfg, params, lora=lora, paged=False, **ENG)
    assert not jeng.paged
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for r in jr:
        jeng.submit(r)
    jeng.run()
    eng, slab = _serve_port(params, lora, reqs, paged=False)
    assert not eng.paged and eng.fused
    _, paged = _serve_port(params, lora, reqs)
    for a, b, c in zip(jr, slab, paged):
        assert len(b) == a.max_new_tokens
        assert b == a.output, (a.uid, a.output, b)
        assert c == b
    assert eng.check_consistency(resync=False)
    assert 1 <= eng.prefill_compiles() <= math.log2(ENG["max_len"])
    assert eng.stats["prefills"] == len(reqs) and eng.stats["prefill_chunks"] == 0
    assert eng.stats["decode_steps"] > 0


@pytest.mark.parametrize("sc", [GREEDY, SampleConfig(temperature=0.8, top_k=20)],
                         ids=["greedy", "temperature"])
def test_naive_loop_identical_to_fused_step(sc):
    _, params, lora = _weights()
    reqs = _requests(6, seed=4, gen=5)
    _, fused = _serve_port(params, lora, reqs, paged=False, sc=sc, seed=3)
    eng, naive = _serve_port(params, lora, reqs, fused=False, sc=sc, seed=3)
    assert not eng.paged and not eng.fused
    assert naive == fused
    # the naive path prefills at exact length: one shape per prompt length
    assert eng.prefill_compiles() == len({len(p) for _, p, _ in reqs})
    if not sc.greedy:
        _, paged = _serve_port(params, lora, reqs, sc=sc, seed=3)
        assert paged == fused          # one (seed, uid, t) stream per token


def test_bucketed_prefill_identical_to_exact_prefill():
    jcfg, params, lora = _weights()
    reqs = _requests(5, seed=5, gen=5)
    _, bucketed = _serve_port(params, lora, reqs, paged=False)
    eng, exact = _serve_port(params, lora, reqs, paged=False, prefill_buckets=False)
    assert bucketed == exact
    assert eng.prefill_compiles() == len({len(p) for _, p, _ in reqs})
    cfg, tp, tl = _port(params, lora)
    for (_, p, g), out in zip(reqs, bucketed):
        ref, _ = TM.generate(cfg, tp, torch.tensor([p]), lora=tl, max_new_tokens=g,
                             sc=GREEDY)
        assert out == ref[0].tolist()


def test_bucket_len_on_repros_cases():
    assert bucket_len(5, 48) == 8
    assert bucket_len(20, 48) == 32          # not 48
    assert bucket_len(32, 48) == 32
    assert bucket_len(3, 64) == 8            # floor
    assert bucket_len(33, 64) == 64          # power-of-two cap
    for n in (33, 40, 47):                   # gap prompts: cap < n < max_len
        with pytest.raises(ValueError, match="exact length"):
            bucket_len(n, 48)


@pytest.mark.parametrize("buckets", [True, False], ids=["bucketed", "exact"])
def test_gap_length_prompts_served_at_exact_length(buckets):
    """Prompts past the largest power-of-two bucket under a non-power-of-
    two max_len (32 < P < 48) prefill at exact length, as in repro."""
    jcfg, params, lora = _weights()
    rng = np.random.default_rng(9)
    reqs = [(0, rng.integers(1, 128, 40).tolist(), 4),
            (1, rng.integers(1, 128, 35).tolist(), 6),
            (2, rng.integers(1, 128, 5).tolist(), 3)]
    eng, out = _serve_port(params, lora, reqs, paged=False, prefill_buckets=buckets)
    assert eng._prefill_lens == ({40, 35, 8} if buckets else {40, 35, 5})
    jeng = JEngine(jcfg, params, lora=lora, paged=False, prefill_buckets=buckets, **ENG)
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for r in jr:
        jeng.submit(r)
    jeng.run()
    assert out == [r.output for r in jr]
    # a request that fills the cache finishes there: token 0 from the
    # prefill, then one per position 40..47
    _, full = _serve_port(params, lora, [(0, reqs[0][1], 20)], paged=False)
    assert len(full[0]) == ENG["max_len"] - 40 + 1


def test_paged_auto_rule():
    _, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    mk = lambda **kw: ServingEngine(cfg, tp, lora=tl, device="cpu",   # noqa: E731
                                    **{**ENG, **kw})
    assert mk().paged                                  # 48 % 8 == 0
    assert not mk(max_len=50).paged                    # auto falls back to slab
    assert not mk(paged=False).paged
    assert not mk(fused=False).paged                   # naive is slab
    with pytest.raises(ValueError, match="multiple of page_size"):
        mk(max_len=50, paged=True)
    with pytest.raises(ValueError, match="fused"):
        mk(paged=True, fused=False)
    # the slab engine serves the max_len the pages do not divide
    eng = mk(max_len=50)
    r = Request(uid=0, prompt=[3, 4, 5], max_new_tokens=4)
    eng.submit(r)
    eng.run()
    assert r.done and len(r.output) == 4 and eng.check_consistency()


def test_temperature_outputs_independent_of_arrival_order():
    _, params, lora = _weights()
    sc = SampleConfig(temperature=0.9, top_k=20)
    base = _requests(5, seed=2)

    def serve(order, slots, **kw):
        cfg, tp, tl = _port(params, lora)
        eng = ServingEngine(cfg, tp, lora=tl, device="cpu", sc=sc, seed=7,
                            **{**ENG, "max_slots": slots, "paged": False, **kw})
        reqs = {u: Request(uid=u, prompt=p, max_new_tokens=g) for u, p, g in base}
        for u in order:
            eng.submit(reqs[u])
        eng.run()
        return {u: r.output for u, r in reqs.items()}

    a = serve([0, 1, 2, 3, 4], 3)
    assert a == serve([4, 2, 0, 3, 1], 2)
    assert a == serve([3, 1, 4, 0, 2], 2, fused=False)
    _, greedy = _serve_port(params, lora, base[:1], paged=False)
    assert a[0] != greedy[0]              # sampling really sampled


def test_slab_engine_raises_for_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_get_arch("gpt2-s").reduced(**KW)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for kw in (dict(paged=False), dict(fused=False), dict(max_len=50)):
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(cfg, params, **{**ENG, **kw})
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_cache(cfg, 2, 8)


def test_serve_cli_modes_emit_the_same_ids(capsys):
    """``repro_torch.launch.serve`` on the CPU: the paged, slab and naive
    engines print the same sample ids, each under its own mode; --profile
    traces the run (no device events on the CPU)."""
    from repro_torch.launch.serve import main
    base = ["--arch", "gpt2-s", "--reduced", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--gen", "4", "--prompt-len", "12"]
    ids = {}
    for flags, mode in (([], "paged(ps=16"), (["--slab"], "slab engine"),
                        (["--naive"], "naive engine"),
                        (["--slab", "--profile"], "slab engine")):
        main(base + flags)
        out = capsys.readouterr().out
        assert mode in out
        ids[" ".join(flags)] = [ln for ln in out.splitlines()
                                if ln.startswith("sample token ids")]
        if "--profile" in flags:
            assert "profile: no device events traced" in out
    assert len(set(map(tuple, ids.values()))) == 1 and ids[""]
