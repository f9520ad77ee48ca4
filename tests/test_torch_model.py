"""The port's model against ``repro.models.model`` on the same weights:
interop round trip, chunked prefill + paged decode steps (logits and both
page pools), and the page allocator against ``repro.serving.paging``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.serving import paging as jpaging                 # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.serving import paging as tpaging           # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
PS, MP = 8, 4


def _cfgs():
    kw = dict(num_layers=2, d_model=64, vocab=128)
    return j_get_arch("gpt2-s").reduced(**kw), t_get_arch("gpt2-s").reduced(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(seed=0):
    """JAX-initialised params and a LoRA tree whose B is NOT zero (the
    repo's init zeroes B, which would make the rank path a no-op)."""
    jcfg, _ = _cfgs()
    params = _np_tree(JM.init_params(jcfg, jax.random.key(seed)))
    lora = _np_tree(JM.init_lora_stack(jcfg, jax.random.key(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    assert any(np.abs(v).max() > 0 for v in jax.tree.leaves(lora))
    return params, lora


def test_interop_round_trip_f32_and_bf16():
    jcfg, _ = _cfgs()
    for dt in (jnp.float32, jnp.bfloat16):
        params = _np_tree(JM.init_params(jcfg, jax.random.key(3), dt))
        tp = interop.params_from_numpy(params, device="cpu")
        assert len(tp["layers"]) == jcfg.num_layers
        back = interop.params_to_numpy(tp, len(jcfg.pattern))
        flat_a, tree_a = jax.tree.flatten(params)
        flat_b, tree_b = jax.tree.flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    lora = _np_tree(JM.init_lora_stack(jcfg, jax.random.key(4)))
    tl = interop.lora_from_numpy(lora, device="cpu")
    assert len(tl) == jcfg.num_layers
    np.testing.assert_array_equal(tl[1]["mixer"]["q"]["a"].numpy(),
                                  lora[0]["mixer"]["q"]["a"][1])


def _episode(rt_name):
    """Two prefilled slots and one dead slot through 3 decode steps on
    both packages; returns [(jax logits, port logits), ...] and the final
    pools of both."""
    jcfg, tcfg = _cfgs()
    params, lora = _weights()
    tparams = interop.params_from_numpy(params, device="cpu")
    tlora = interop.lora_from_numpy(lora, device="cpu")
    jrt = JM.default_serve_runtime()
    trt = TM.default_serve_runtime() if rt_name == "serve" else TM.Runtime()
    NP = 10
    jc = JM.init_paged_cache(jcfg, NP, PS, jnp.float32)
    tc = TM.init_paged_cache(tcfg, NP, PS, torch.float32, device="cpu")
    bt = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, 11), rng.integers(1, 128, 5)]
    pairs = []
    for s, prompt in enumerate(prompts):
        P = len(prompt)
        for start in range(0, P, PS):
            chunk = np.zeros((1, PS), np.int32)
            m = min(PS, P - start)
            chunk[0, :m] = prompt[start:start + m]
            li = min(max(P - 1 - start, 0), PS - 1)
            jl, jc = JM.paged_prefill_chunk(jcfg, params, jnp.asarray(chunk), jc,
                                            jnp.asarray(bt[s]), start, li,
                                            lora=lora, rt=jrt)
            tl, tc = TM.paged_prefill_chunk(tcfg, tparams, torch.from_numpy(chunk),
                                            tc, torch.from_numpy(bt[s]), start, li,
                                            lora=tlora, rt=trt)
            pairs.append((np.asarray(jl), tl.numpy()))
    pos = np.array([11, 5, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(1, 128, (3, 1)).astype(np.int32)
        jl, jc = JM.paged_decode_step(jcfg, params, jnp.asarray(tok), jc,
                                      jnp.asarray(bt), jnp.asarray(pos),
                                      lora=lora, rt=jrt)
        tl, tc = TM.paged_decode_step(tcfg, tparams, torch.from_numpy(tok), tc,
                                      torch.from_numpy(bt), torch.from_numpy(pos),
                                      lora=tlora, rt=trt)
        pairs.append((np.asarray(jl), tl.numpy()))
        pos = pos + np.array([1, 1, 0], np.int32)
    return pairs, jc, tc


@pytest.mark.parametrize("rt_name", ["serve", "plain"])
def test_prefill_chunks_and_decode_steps_match_repro(rt_name):
    pairs, jc, tc = _episode(rt_name)
    assert len(pairs) == 2 + 1 + 3
    for jl, tl in pairs:
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, **TOL)
    jpools = jax.tree.map(np.asarray, jc)
    for i, layer in enumerate(tc):
        for name in ("k", "v"):
            # repro stacks the pools over repeats: layer i = repeat i
            np.testing.assert_allclose(layer[name].numpy(), jpools[0][name][i], **TOL)


def test_paging_matches_repro_on_the_same_masks():
    rng = np.random.default_rng(0)
    jp, tp = jpaging.init_pager(9), tpaging.init_pager(9, device="cpu")
    jbt = np.zeros((3, 3), np.int32)
    tbt = torch.zeros((3, 3), dtype=torch.int32)
    col = np.zeros(3, int)
    for step in range(40):
        if rng.random() < 0.6:
            need = (rng.random(3) < 0.6) & (col < 3)
            jp, jpages, jok = jpaging.alloc_pages(jp, jnp.asarray(need))
            tp, tpages, tok = tpaging.alloc_pages(tp, torch.from_numpy(need))
            np.testing.assert_array_equal(tpages.numpy(), np.asarray(jpages))
            assert bool(tok) == bool(jok)
            if bool(jok):
                for s in np.flatnonzero(need):
                    jbt[s, col[s]] = int(jpages[s])
                    tbt[s, col[s]] = int(tpages[s])
                    col[s] += 1
        else:
            mask = rng.random(3) < 0.4
            jp, jbt_d = jpaging.free_pages(jp, jnp.asarray(jbt), jnp.asarray(mask))
            tp, tbt = tpaging.free_pages(tp, tbt, torch.from_numpy(mask))
            jbt = np.array(jbt_d)
            col[mask] = 0
            np.testing.assert_array_equal(tbt.numpy(), jbt)
        assert int(tp["head"]) == int(jp["head"])
        head = int(jp["head"])
        np.testing.assert_array_equal(tp["free"][:head].numpy(),
                                      np.asarray(jp["free"])[:head])


def test_alloc_all_or_nothing_and_null_lanes():
    tp = tpaging.init_pager(4, device="cpu")          # 3 usable pages
    tp, pages, ok = tpaging.alloc_pages(tp, torch.tensor([True, False, True]))
    assert bool(ok) and pages[1] == tpaging.NULL_PAGE and 0 not in (pages[0], pages[2])
    tp, pages, ok = tpaging.alloc_pages(tp, torch.ones(2, dtype=torch.bool))
    assert not bool(ok) and (pages == 0).all() and int(tp["head"]) == 1


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope", "swiglu", "gelu"])
def test_layers_match_repro(name):
    """The primitives the paper models do not reach (rope, swiglu,
    rmsnorm) and the ones they do, against repro.models.layers."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a))     # a writable copy
    if name == "rmsnorm":
        s = rng.normal(size=(16,)).astype(np.float32)
        want, got = jl.rmsnorm(x, s), tl.rmsnorm(t(x), t(s))
    elif name == "layernorm":
        s, b = (rng.normal(size=(16,)).astype(np.float32) for _ in range(2))
        want, got = jl.layernorm(x, s, b), tl.layernorm(t(x), t(s), t(b))
    elif name == "rope":
        pos = np.arange(3, 8, dtype=np.int32)[None].repeat(2, 0)
        want = jl.apply_rope(x, pos, 10_000.0)
        got = tl.apply_rope(t(x), t(pos), 10_000.0)
    else:
        cfg = t_get_arch("gpt2-s").reduced(num_layers=2, d_model=16, vocab=32)
        if name == "swiglu":
            cfg = cfg.replace(mlp_kind="swiglu", norm="rmsnorm")
        jcfg = j_get_arch("gpt2-s").reduced(num_layers=2, d_model=16, vocab=32)
        jcfg = jcfg.replace(mlp_kind=cfg.mlp_kind, norm=cfg.norm)
        p = _np_tree(jl.init_mlp(jcfg, jax.random.key(0), jnp.float32))
        names = ("w_gate", "w_up", "w_down") if name == "swiglu" else ("w_up", "w_down")
        lora = {n: {"a": rng.normal(size=(2, p[f"w_{n}"]["w"].shape[0])).astype(np.float32),
                    "b": rng.normal(size=(p[f"w_{n}"]["w"].shape[1], 2)).astype(np.float32)}
                for n in ("up", "down")}
        assert set(p) == set(names)
        want = jl.apply_mlp(jcfg, x[..., 0, :], p, lora, 2.0)
        got = tl.apply_mlp(cfg, t(x[..., 0, :]), interop.tree_map(t, p),
                           interop.tree_map(t, lora), 2.0, dense_impl="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# llama4-scout-17b-a16e (reduced) with its MLP made dense; the MoE block
# itself is held in tests/test_torch_moe.py
# ---------------------------------------------------------------------------

def _llama4_cfgs(mlp=None):
    """repro's llama4-scout-17b-a16e at 2 layers, d 128, vocab 256, and the
    port's config of the same fields (``mlp`` overrides the pattern's)."""
    import dataclasses
    from repro.configs.base import LayerPattern as JLayerPattern
    from repro_torch.configs import ArchConfig, LayerPattern
    jcfg = j_get_arch("llama4-scout-17b-a16e").reduced(num_layers=2, d_model=128, vocab=256)
    if mlp is not None:
        jcfg = jcfg.replace(pattern=tuple(JLayerPattern(p.mixer, mlp) for p in jcfg.pattern))
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)
          if f.name != "pattern"}
    tcfg = ArchConfig(**kw, pattern=tuple(LayerPattern(p.mixer, p.mlp) for p in jcfg.pattern))
    return jcfg, tcfg


def test_a_dense_config_still_imports_and_runs():
    """The same reduced config with a dense MLP imports and gives repro's
    logits."""
    jcfg, tcfg = _llama4_cfgs(mlp="dense")
    params = _np_tree(JM.init_params(jcfg, jax.random.key(1), jnp.float32))
    tp = interop.params_from_numpy(params, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jl, _ = JM.forward(jcfg, params, jnp.asarray(tokens))
    tl, _ = TM.forward(tcfg, tp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
