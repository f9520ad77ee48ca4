"""Mamba2 in the port against ``repro`` on the same weights (Mamba2-2.7B
cut by ``reduced`` to 2 layers at d 64: d_inner 128, 4 SSD heads of 32,
state 16, chunk 32; LoRA on ssm_in/ssm_out with B != 0): the config and
its ``reduced`` field for field; one block's prefill (output, ssm and
conv state) and one decode step; ``prefill`` then ``decode_step`` across
chunks (1e-4); an f64 prefill; the slab-cache and params interop with
its f32 leaves; ``generate()`` greedy ids; the slab engine, fused and
naive, against ``repro``'s ``ServingEngine`` (identical greedy ids over
mixed lengths, slots reused); the serve CLI; and the refusals (mode
"chunk", paged)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.models import ssm as j_ssm                       # noqa: E402
from repro.models.generate import SampleConfig as JSampleConfig  # noqa: E402
from repro.models.generate import generate as j_generate    # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.models import ssm as t_ssm                 # noqa: E402
from repro_torch.models.generate import SampleConfig        # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

ARCH = "mamba2-2.7b"
KW = dict(num_layers=2, d_model=64, vocab=128)
ENG = dict(max_slots=2, max_len=64)
GREEDY = SampleConfig(greedy=True)
RUNTIMES = [("plain", TM.Runtime(), JM.Runtime(attn_impl="naive")),
            ("serve", TM.default_serve_runtime(), JM.default_serve_runtime())]


def _fields(cfg):
    """Field values, each LayerPattern as its (mixer, mlp) pair (the two
    packages' LayerPattern classes never compare equal)."""
    def plain(v):
        if isinstance(v, tuple):
            return tuple(plain(x) for x in v)
        return (v.mixer, v.mlp) if hasattr(v, "mixer") else v
    return {f.name: plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def _weights(seed=0):
    jcfg = j_get_arch(ARCH).reduced(**KW)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    lora = jax.tree.map(np.asarray, JM.init_lora_stack(jcfg, jax.random.key(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    return jcfg, params, lora


def _port(params, lora, dtype=None):
    return (t_get_arch(ARCH).reduced(**KW),
            interop.params_from_numpy(params, device="cpu", dtype=dtype),
            interop.lora_from_numpy(lora, device="cpu"))


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_and_reduced_match_repro_field_for_field(reduce):
    j, t = j_get_arch(ARCH), t_get_arch(ARCH)
    if reduce:
        j, t = j.reduced(**KW), t.reduced(**KW)
    jf, tf = _fields(j), _fields(t)
    for name, value in tf.items():
        assert jf[name] == value, name
    for prop in ("d_inner", "ssm_num_heads", "pattern_repeats"):
        assert getattr(j, prop) == getattr(t, prop), prop
    if not reduce:
        assert (t.num_layers, t.d_model, t.d_inner, t.ssm_num_heads, t.ssm_head_dim,
                t.ssm_state, t.ssm_chunk, t.vocab_size) == (64, 2560, 5120, 80, 64, 128,
                                                            256, 50280)
    else:
        assert (t.ssm_state, t.ssm_head_dim, t.ssm_chunk) == (16, 32, 32)


@pytest.mark.parametrize("S", [2, 45])
def test_mamba_block_and_step_match_repro(S):
    """One layer's prefill (output, ssm state, conv tail — zero-padded in
    front when S < W - 1) then one decode step from that state."""
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    jp = jax.tree.map(lambda v: v[0], params["layers"][0]["mixer"])
    jl = jax.tree.map(lambda v: v[0], lora[0]["mixer"])
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, js = j_ssm.mamba_block(jcfg, jp, jnp.asarray(x), lora=jl, lora_scale=2.0,
                               return_state=True)
    to, ts = t_ssm.mamba_block(cfg, tp["layers"][0]["mixer"], torch.from_numpy(x),
                               lora=tl[0]["mixer"], lora_scale=2.0, return_state=True)
    _close(to, jo)
    assert ts["ssm"].dtype == torch.float32
    for k in ("ssm", "conv"):
        assert tuple(ts[k].shape) == js[k].shape
        _close(ts[k], js[k])
    x1 = np.random.default_rng(2).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo1, js1 = j_ssm.mamba_step(jcfg, jp, jnp.asarray(x1), js, lora=jl, lora_scale=2.0)
    cache = {k: v.clone() for k, v in ts.items()}
    to1, ts1 = t_ssm.mamba_step(cfg, tp["layers"][0]["mixer"], torch.from_numpy(x1),
                                cache, lora=tl[0]["mixer"], lora_scale=2.0)
    _close(to1, jo1)
    assert ts1 is cache                          # written in place
    for k in ("ssm", "conv"):
        _close(ts1[k], js1[k])


@pytest.mark.parametrize("name,trt,jrt", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_prefill_then_decode_match_repro_across_chunks(name, trt, jrt):
    """Prompts of 45 tokens (chunks of 32: the state crosses a chunk
    boundary and the last chunk is ragged), then two decode steps."""
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    toks = np.random.default_rng(3).integers(1, 128, (2, 45)).astype(np.int32)
    jlg, jc = JM.prefill(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt)
    tlg, tc = TM.prefill(cfg, tp, torch.from_numpy(toks), lora=tl, rt=trt)
    _close(tlg, jlg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(interop.slab_cache_to_numpy(tc, len(jcfg.pattern)))):
        _close(b, a)
    for step, tok in enumerate(([[5], [77]], [[9], [3]])):
        tok = np.asarray(tok, np.int32)
        jlg, jc = JM.decode_step(jcfg, params, jnp.asarray(tok), jc, 45 + step,
                                 lora=lora, rt=jrt)
        tlg, tc = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc, 45 + step,
                                 lora=tl, rt=trt)
        _close(tlg, jlg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(interop.slab_cache_to_numpy(tc, len(jcfg.pattern)))):
        _close(b, a)


def test_prefill_in_f64_stays_f64_and_matches_repro():
    """The f64 witness of the chip check: every leaf cast to f64, the plain
    path's prefill computes in f64 (logits and every state f64) and lies
    within 1e-4 of repro's f32 prefill and of the port's own."""
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    to64 = lambda t: tree_map(lambda v: v.double() if v.is_floating_point() else v, t)
    toks = np.random.default_rng(4).integers(1, 128, (2, 45)).astype(np.int32)
    jlg, _ = JM.prefill(jcfg, params, jnp.asarray(toks), lora=lora,
                        rt=JM.Runtime(attn_impl="naive"))
    lg, c = TM.prefill(cfg, tp, torch.from_numpy(toks), lora=tl, rt=TM.Runtime())
    lg64, c64 = TM.prefill(cfg, to64(tp), torch.from_numpy(toks), lora=to64(tl),
                           rt=TM.Runtime())
    assert lg64.dtype == torch.float64
    assert {t.dtype for layer in c64 for t in layer.values()} == {torch.float64}
    _close(lg64, jlg)
    _close(lg64, lg)
    for a, b in zip(c, c64):
        for k in ("ssm", "conv"):
            _close(a[k], b[k])


def test_cache_and_params_interop_keep_the_f32_leaves():
    jcfg, params, lora = _weights()
    jc = jax.tree.map(np.asarray, JM.init_cache(jcfg, 2, 8, jnp.bfloat16))
    tc = interop.slab_cache_from_numpy(jc, device="cpu", dtype=torch.bfloat16)
    cfg = t_get_arch(ARCH).reduced(**KW)
    tc0 = TM.init_cache(cfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert len(tc) == len(tc0) == cfg.num_layers
    for a, b in zip(tc, tc0):
        assert set(a) == set(b) == {"ssm", "conv"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
    assert tc0[0]["ssm"].dtype == torch.float32 and tc0[0]["conv"].dtype == torch.bfloat16
    back = interop.slab_cache_to_numpy(tc, len(jcfg.pattern))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    _, tp, _ = _port(params, lora, dtype=torch.bfloat16)
    mixer = tp["layers"][1]["mixer"]
    for k in ("A_log", "D", "dt_bias"):
        assert mixer[k].dtype == torch.float32, k
    assert mixer["in_proj"]["w"].dtype == torch.bfloat16
    moved = interop.tree_to(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                           device="cpu"), "cpu", torch.bfloat16)
    assert moved["layers"][0]["mixer"]["D"].dtype == torch.float32
    assert moved["layers"][0]["mixer"]["conv_w"].dtype == torch.bfloat16
    # the port's own init keeps them f32 as repro's does
    own = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert own["layers"][0]["mixer"]["A_log"].dtype == torch.float32
    pairs = zip(jax.tree.leaves(interop.params_to_numpy(own, 1)),
                jax.tree.leaves(jax.tree.map(np.asarray,
                                             JM.init_params(jcfg, jax.random.key(0),
                                                            jnp.bfloat16))))
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("name,trt,jrt", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_generate_greedy_ids_identical_to_repro(name, trt, jrt):
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    toks = np.random.default_rng(4).integers(1, 128, (2, 37)).astype(np.int32)
    jo, jd = j_generate(jcfg, params, jnp.asarray(toks), lora=lora, rt=jrt,
                        max_new_tokens=6, sc=JSampleConfig(greedy=True))
    to, td = TM.generate(cfg, tp, torch.from_numpy(toks), lora=tl, rt=trt,
                         max_new_tokens=6, sc=GREEDY)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _requests():
    rng = np.random.default_rng(5)
    return [(i, rng.integers(1, 128, n).tolist(), 5) for i, n in enumerate((40, 7, 40, 13, 7))]


def test_slab_engine_fused_and_naive_ids_identical_to_repro():
    """Five requests of three lengths through two slots: each slot is
    reused, so a stale state would show in the later requests' ids."""
    jcfg, params, lora = _weights()
    reqs = _requests()
    jeng = JEngine(jcfg, params, lora=lora, **ENG)
    assert not jeng.paged
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for r in jr:
        jeng.submit(r)
    jeng.run()
    cfg, tp, tl = _port(params, lora)
    for fused in (True, False):
        eng = ServingEngine(cfg, tp, lora=tl, device="cpu", fused=fused, **ENG)
        assert not eng.paged and not eng.prefill_buckets
        rs = [Request(uid=u, prompt=list(p), max_new_tokens=g) for u, p, g in reqs]
        for r in rs:
            eng.submit(r)
        eng.run()
        for a, b in zip(jr, rs):
            assert b.done and b.output == a.output, (fused, a.uid, a.output, b.output)
        assert eng.stats["prefills"] == len(reqs)
        assert eng.prefill_compiles() == jeng.prefill_compiles() == 3    # exact lengths


def test_serve_cli_serves_mamba_and_refuses_adapters(capsys):
    from repro_torch.launch.serve import main
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--gen", "4", "--prompt-len", "12"]
    ids = []
    for flags in ([], ["--naive"]):
        main(base + flags)
        out = capsys.readouterr().out
        assert ("naive engine" if flags else "slab engine") in out
        ids.append([ln for ln in out.splitlines() if ln.startswith("sample token ids")])
    assert ids[0] == ids[1] and ids[0]
    with pytest.raises(NotImplementedError, match="paged engine"):
        main(base + ["--adapters", "2"])


def test_paged_serving_and_chunk_mode_are_refused():
    jcfg, params, lora = _weights()
    cfg, tp, tl = _port(params, lora)
    with pytest.raises(NotImplementedError, match="attention-only"):
        ServingEngine(cfg, tp, lora=tl, device="cpu", paged=True, **ENG)
    with pytest.raises(NotImplementedError, match="attention-only"):
        TM.init_paged_cache(cfg, 9, 8, device="cpu")
    toks = torch.ones((1, 8), dtype=torch.int32)
    caches = TM.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="not paged"):
        TM.paged_prefill_chunk(cfg, tp, toks, caches, torch.zeros(4, dtype=torch.int32),
                               0, 7, lora=tl)
    with pytest.raises(NotImplementedError, match="not paged"):
        TM.paged_decode_step(cfg, tp, toks[:, :1], caches,
                             torch.zeros((1, 4), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), lora=tl)
