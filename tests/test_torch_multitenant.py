"""Multi-tenant adapter serving in the port against ``repro``: the plain
gather against ``repro``'s interpret-mode gather kernel and its oracle
(out-of-range indices and leading dims too), ``dense(adapter_idx=)`` and
``paged_decode_step(adapter_idx=)`` on the same weights, the
``AdapterRegistry`` driven through the same sequence as ``repro``'s, and
the multi-tenant engine against ``repro``'s and against per-tenant
single-adapter engines (token ids, LRU stats, quota admission order,
tenant sampling streams, configuration errors, the serve CLI)."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.kernels.lora_matmul import (lora_matmul_gather_kernel as j_gather_kernel,  # noqa: E402
                                       lora_matmul_gathered as j_gathered,
                                       lora_matmul_gathered_ref as j_gathered_ref)
from repro.models import layers as JL                       # noqa: E402
from repro.precision import quantize_weight_int8 as j_quantize  # noqa: E402
from repro.serving import AdapterRegistry as JRegistry      # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.kernels.lora_matmul import (lora_matmul,   # noqa: E402
                                             lora_matmul_gathered,
                                             lora_matmul_gathered_ref)
from repro_torch.models import layers as TL                 # noqa: E402
from repro_torch.models.generate import SampleConfig, stream_seed  # noqa: E402
from repro_torch.serving import AdapterRegistry, Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

KW = dict(num_layers=2, d_model=64, vocab=128)
GREEDY = SampleConfig(greedy=True)


def _cfgs():
    return j_get_arch("gpt2-s").reduced(**KW), t_get_arch("gpt2-s").reduced(**KW)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pool_inputs(M, K, N, r, A, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(M, K)).astype(f), (rng.normal(size=(K, N)) * K ** -0.5).astype(f),
            (rng.normal(size=(A, r, K)) * K ** -0.5).astype(f),
            rng.normal(size=(A, N, r)).astype(f), rng.integers(0, A, M).astype(np.int32))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# ---------------------------------------------------------------------------
# the gather: plain version against repro's kernel (interpret) and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,r,A", [(16, 64, 48, 4, 8), (8, 128, 64, 8, 3),
                                       (32, 64, 64, 2, 16)])
def test_plain_gather_matches_repros_kernel_and_oracle(M, K, N, r, A):
    x, w, a, b, idx = _pool_inputs(M, K, N, r, A)
    yk = np.asarray(j_gather_kernel(x, w, a, b, jnp.asarray(idx), scale=1.5, bn=16, bk=32,
                                    interpret=True))
    yo = np.asarray(j_gathered_ref(x, w, a, b, jnp.asarray(idx), 1.5))
    yt = lora_matmul_gathered_ref(*_t(x, w, a, b, idx), 1.5).numpy()
    np.testing.assert_allclose(yt, yk, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(yt, yo, atol=1e-5, rtol=1e-5)


def test_out_of_range_indices_follow_repros_oracle():
    """jnp.take's fill mode: [-A, 0) counts from the end, anything else
    outside the pool is a NaN row — through the plain version and through
    the op's CPU route."""
    M, K, N, r, A = 8, 32, 24, 4, 5
    x, w, a, b, _ = _pool_inputs(M, K, N, r, A, seed=4)
    idx = np.array([-A - 1, -1, A, A + 3, 0, A - 1, -A, 2], np.int32)
    yo = np.asarray(j_gathered_ref(x, w, a, b, jnp.asarray(idx), 0.75))
    assert np.isnan(yo[[0, 2, 3]]).all() and np.isfinite(yo[[1, 4, 5, 6, 7]]).all()
    for yt in (lora_matmul_gathered_ref(*_t(x, w, a, b, idx), 0.75),
               lora_matmul_gathered(*_t(x, w, a, b, idx), scale=0.75)):
        np.testing.assert_allclose(yt.numpy(), yo, atol=1e-5, rtol=1e-5, equal_nan=True)


def test_leading_dims_and_broadcast_index_match_repro():
    M, K, N, r, A = 8, 40, 24, 3, 5
    x, w, a, b, idx = _pool_inputs(M, K, N, r, A, seed=7)
    xb = x.reshape(2, 4, K)
    for ai in (idx[:2], idx.reshape(2, 4)):            # (B,) broadcast; exact lead
        yj = np.asarray(j_gathered(xb, w, a, b, jnp.asarray(ai), scale=1.25,
                                   use_kernel=False))
        yt = lora_matmul_gathered(*_t(xb, w, a, b, ai), scale=1.25)
        assert tuple(yt.shape) == (2, 4, N)
        np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


def test_gather_equals_lora_matmul_on_each_tenants_rows():
    M, K, N, r, A = 24, 64, 48, 4, 8
    x, w, a, b, _ = _pool_inputs(M, K, N, r, A, seed=3)
    idx = (np.arange(M) % A).astype(np.int32)          # every adapter used
    tx, tw, ta, tb, ti = _t(x, w, a, b, idx)
    y = lora_matmul_gathered(tx, tw, ta, tb, ti, scale=0.5)
    for t in range(A):
        rows = ti == t
        yt = lora_matmul(tx[rows], tw, ta[t], tb[t], scale=0.5)
        torch.testing.assert_close(y[rows], yt, atol=1e-5, rtol=1e-5, msg=f"tenant {t}")


# ---------------------------------------------------------------------------
# dense and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8-base"])
@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_dense_adapter_idx_matches_repro(impl, q8):
    rng = np.random.default_rng(11)
    d, n, r, A = 64, 48, 4, 5
    x = rng.normal(size=(3, 2, d)).astype(np.float32)
    w = (rng.normal(size=(d, n)) * d ** -0.5).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    pool = {"a": (rng.normal(size=(A, r, d)) * r ** -0.5).astype(np.float32),
            "b": rng.normal(0, 0.05, (A, n, r)).astype(np.float32)}
    idx = np.array([2, 0, 4], np.int32)
    ws = None
    if q8:
        wq, ws = (np.asarray(t) for t in j_quantize(jnp.asarray(w)))
        w = wq
    yj = np.asarray(JL.dense(x, w, bias, lora=pool, lora_scale=2.0, impl="einsum",
                             adapter_idx=jnp.asarray(idx), w_scale=ws))
    tpool = {k: torch.from_numpy(v) for k, v in pool.items()}
    yt = TL.dense(*_t(x, w, bias), lora=tpool, lora_scale=2.0, impl=impl,
                  adapter_idx=torch.from_numpy(idx),
                  w_scale=None if ws is None else _t(ws)[0])
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_size1_pool_is_bit_identical_to_the_single_adapter(impl):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, 64, generator=g)
    w = torch.randn(64, 64, generator=g) * 0.02
    single = {"a": torch.randn(4, 64, generator=g), "b": torch.randn(64, 4, generator=g)}
    pool = {"a": single["a"][None], "b": single["b"][None]}
    y1 = TL.dense(x, w, lora=single, lora_scale=2.0, impl=impl)
    yp = TL.dense(x, w, lora=pool, lora_scale=2.0, impl=impl,
                  adapter_idx=torch.zeros(3, dtype=torch.int32))
    assert torch.equal(y1, yp)


def _adapter(jcfg, t, rank=None):
    """Tenant t's adapter as numpy leaves: repro's init for A, and a B
    that is NOT zero (under B = 0 every tenant computes the same thing)."""
    lora = _np(JM.init_lora_stack(jcfg, jax.random.key(100 + t), rank))
    rng = np.random.default_rng(1000 + t)
    return jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)


def _stack_pool(ads):
    """repro's registry pool layout: the adapter axis at position 1."""
    return jax.tree.map(lambda *ls: np.stack(ls, axis=1), *ads)


@pytest.mark.parametrize("rt_name", ["serve", "plain"])
def test_paged_decode_step_with_adapter_idx_matches_repro(rt_name):
    jcfg, tcfg = _cfgs()
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    jpool = _stack_pool([_adapter(jcfg, t) for t in range(4)])
    tpool = interop.lora_from_numpy(jpool, device="cpu")         # (R, A, ...) -> (A, ...)
    assert tuple(tpool[1]["mixer"]["q"]["a"].shape) == jpool[0]["mixer"]["q"]["a"].shape[1:]
    rng = np.random.default_rng(2)
    R, KH, NP, PS, D = jcfg.num_layers, jcfg.num_kv_heads, 13, 8, jcfg.head_dim
    kv = {n: rng.normal(size=(R, KH, NP, PS, D)).astype(np.float32) for n in "kv"}
    bt = np.array([[3, 5, 0], [7, 0, 0], [1, 2, 4], [0, 0, 0]], np.int32)
    pos = np.array([11, 5, 20, 0], np.int32)
    tok = rng.integers(1, 128, (4, 1)).astype(np.int32)
    idx = np.array([2, 0, 2, 3], np.int32)                        # one repeated
    jl, jc = JM.paged_decode_step(jcfg, params, jnp.asarray(tok), ({n: jnp.asarray(v)
                                                                    for n, v in kv.items()},),
                                  jnp.asarray(bt), jnp.asarray(pos), lora=jpool,
                                  rt=JM.default_serve_runtime(),
                                  adapter_idx=jnp.asarray(idx))
    tc = [{n: torch.from_numpy(kv[n][i].copy()) for n in "kv"} for i in range(R)]
    trt = TM.default_serve_runtime() if rt_name == "serve" else TM.Runtime()
    tl, tc = TM.paged_decode_step(tcfg, interop.params_from_numpy(params, device="cpu"),
                                  *_t(tok), tc, *_t(bt, pos), lora=tpool, rt=trt,
                                  adapter_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for i in range(R):
        for n in "kv":
            np.testing.assert_allclose(tc[i][n].numpy(), np.asarray(jc[0][n][i]),
                                       atol=1e-4, rtol=1e-4)


def test_slab_decode_step_with_adapter_idx_matches_repro():
    jcfg, tcfg = _cfgs()
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    jpool = _stack_pool([_adapter(jcfg, t) for t in range(3)])
    tpool = interop.lora_from_numpy(jpool, device="cpu")
    rng = np.random.default_rng(3)
    R, B, L, KH, D = jcfg.num_layers, 3, 24, jcfg.num_kv_heads, jcfg.head_dim
    pos = np.array([5, 17, 0], np.int32)
    caches = ({"k": rng.normal(size=(R, B, L, KH, D)).astype(np.float32),
               "v": rng.normal(size=(R, B, L, KH, D)).astype(np.float32),
               "pos": np.where(np.arange(L)[None, None] < pos[None, :, None],
                               np.arange(L, dtype=np.int32), -1).astype(np.int32)
               * np.ones((R, 1, 1), np.int32)},)
    tok = rng.integers(1, 128, (B, 1)).astype(np.int32)
    idx = np.array([1, 2, 1], np.int32)
    jl, jc = JM.decode_step(jcfg, params, jnp.asarray(tok), jax.tree.map(jnp.asarray, caches),
                            jnp.asarray(pos), lora=jpool, rt=JM.default_serve_runtime(),
                            adapter_idx=jnp.asarray(idx))
    tl, tc = TM.decode_step(tcfg, interop.params_from_numpy(params, device="cpu"),
                            *_t(tok), interop.slab_cache_from_numpy(caches, device="cpu"),
                            *_t(pos), lora=tpool, rt=TM.default_serve_runtime(),
                            adapter_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    back = interop.slab_cache_to_numpy(tc, len(tcfg.pattern))
    for lt, lj in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        np.testing.assert_allclose(lt, np.asarray(lj), atol=1e-4, rtol=1e-4)
    # the chunk and the training modes take no adapter_idx: a chunk runs with
    # its request's adapter sliced out of the pool
    with pytest.raises(ValueError, match="adapter_idx"):
        TM.apply_stack(tcfg, interop.params_from_numpy(params, device="cpu")["layers"],
                       torch.zeros(1, 4, tcfg.d_model), lora=tpool, rt=TM.Runtime(),
                       positions=torch.arange(4), adapter_idx=torch.zeros(1))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_follows_repros_through_the_same_sequence():
    jcfg, tcfg = _cfgs()
    ads = [_adapter(jcfg, t) for t in range(4)]
    v2 = _adapter(jcfg, 99)
    jreg = JRegistry(jcfg, pool_size=2)
    treg = AdapterRegistry(tcfg, pool_size=2, device="cpu")
    ptrs = [p.data_ptr() for p in tree_leaves(treg.pool)]
    ops = [("publish", 0, ads[0]), ("publish", 1, ads[1]), ("publish", 2, ads[2]),
           ("acquire", 0, ()), ("acquire", 1, ()), ("acquire", 0, ()),
           ("acquire", 2, ()),                  # evicts 1, the least recently used
           ("publish", 2, v2),                  # resident: hot swap in place
           ("acquire", 1, {2}),                 # 0 is the LRU and unpinned
           ("publish", 3, ads[3]), ("acquire", 3, {1}), ("acquire", 0, {3})]
    for op, t, arg in ops:
        if op == "publish":
            assert jreg.publish(t, arg) == treg.publish(
                t, interop.lora_from_numpy(arg, device="cpu"))
        else:
            assert jreg.acquire(t, pinned=arg) == treg.acquire(t, pinned=arg)
        assert treg.stats == jreg.stats
        assert [treg.slot_of(u) for u in range(5)] == [jreg.slot_of(u) for u in range(5)]
        assert [treg.version(u) for u in range(5)] == [jreg.version(u) for u in range(5)]
        assert treg.tenants() == jreg.tenants()
        back = interop.lora_to_numpy(treg.pool, len(tcfg.pattern))    # (R, A, ...)
        for lt, lj in zip(jax.tree.leaves(back), jax.tree.leaves(jreg.pool)):
            np.testing.assert_array_equal(lt, np.asarray(lj))
    assert treg.stats == {"swaps": 6, "hot_swaps": 1, "evictions": 4}
    assert [p.data_ptr() for p in tree_leaves(treg.pool)] == ptrs    # storage never moved
    assert treg.load_compiles() == jreg.load_compiles() == 1
    for reg in (jreg, treg):
        with pytest.raises(RuntimeError):
            reg.acquire(2, pinned={0, 3})           # every slot pinned
        with pytest.raises(KeyError):
            reg.acquire(99)                         # never published


@pytest.mark.parametrize("rank", [2, 8])
def test_registry_rejects_other_ranks_as_repro_does(rank):
    """repro's class docstring says other ranks zero-pad at publish; its
    ``_check_tree`` raises, and the port raises as the code does."""
    jcfg, tcfg = _cfgs()
    ad = _adapter(jcfg, 0, rank=rank)
    with pytest.raises(ValueError):
        JRegistry(jcfg, pool_size=2).publish(0, ad)
    treg = AdapterRegistry(tcfg, pool_size=2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        treg.publish(0, interop.lora_from_numpy(ad, device="cpu"))
    wrong = interop.lora_from_numpy(_adapter(jcfg, 0), device="cpu")
    del wrong[0]["mixer"]["v"]
    with pytest.raises(ValueError, match="tree"):
        treg.publish(0, wrong)
    assert treg.tenants() == []


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _mt_setup(nt, seed=0):
    jcfg, tcfg = _cfgs()
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    ads = [_adapter(jcfg, t) for t in range(nt)]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(5, 128, int(rng.integers(4, 10))).tolist() for _ in range(nt)]
    return jcfg, tcfg, params, ads, prompts


def _registries(jcfg, tcfg, ads, pool):
    jreg = JRegistry(jcfg, pool_size=pool)
    treg = AdapterRegistry(tcfg, pool_size=pool, device="cpu")
    for t, a in enumerate(ads):
        jreg.publish(t, a)
        treg.publish(t, interop.lora_from_numpy(a, device="cpu"))
    return jreg, treg


def _port_engine(tcfg, params, **kw):
    return ServingEngine(tcfg, interop.params_from_numpy(params, device="cpu"),
                         max_len=32, device="cpu", **kw)


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _single(tcfg, params, ad, uid, prompt, n):
    eng = _port_engine(tcfg, params, lora=interop.lora_from_numpy(ad, device="cpu"),
                       max_slots=1, sc=GREEDY)
    return _serve(eng, [Request(uid=uid, prompt=prompt, max_new_tokens=n)])[0]


def test_mixed_batch_matches_repro_and_per_tenant_engines():
    NT = 8
    jcfg, tcfg, params, ads, prompts = _mt_setup(NT)
    jreg, treg = _registries(jcfg, tcfg, ads, NT)
    lens = [3, 5, 4, 6, 3, 4, 5, 3]
    jout = _serve(JEngine(jcfg, params, adapters=jreg, max_slots=NT, max_len=32, sc=GREEDY),
                  [JRequest(uid=i, prompt=p, max_new_tokens=n, tenant=i)
                   for i, (p, n) in enumerate(zip(prompts, lens))])
    eng = _port_engine(tcfg, params, adapters=treg, max_slots=NT, sc=GREEDY)
    tout = _serve(eng, [Request(uid=i, prompt=p, max_new_tokens=n, tenant=i)
                        for i, (p, n) in enumerate(zip(prompts, lens))])
    assert tout == jout
    for t in range(NT):
        assert tout[t] == _single(tcfg, params, ads[t], t, prompts[t], lens[t]), f"tenant {t}"
    assert eng.stats["tenant_tokens"] == {t: lens[t] for t in range(NT)}
    assert eng.stats["adapter_swaps"] == NT
    assert eng.check_consistency(resync=False) and eng.pages_in_use() == 0
    # a shared prompt under two tenants: the adapters make the difference
    outs = {t: _single(tcfg, params, ads[t], 0, prompts[0], 6) for t in range(NT)}
    assert len({tuple(o) for o in outs.values()}) > 1


def test_lru_paging_under_pressure_matches_repro():
    NT = 5
    jcfg, tcfg, params, ads, prompts = _mt_setup(NT, seed=2)
    jreg, treg = _registries(jcfg, tcfg, ads, 2)
    je = JEngine(jcfg, params, adapters=jreg, max_slots=2, max_len=32, sc=GREEDY)
    te = _port_engine(tcfg, params, adapters=treg, max_slots=2, sc=GREEDY)
    jout = _serve(je, [JRequest(uid=i, prompt=prompts[i], max_new_tokens=4, tenant=i)
                       for i in range(NT)])
    tout = _serve(te, [Request(uid=i, prompt=prompts[i], max_new_tokens=4, tenant=i)
                       for i in range(NT)])
    assert tout == jout
    assert te.stats["tenant_tokens"] == je.stats["tenant_tokens"]
    assert te.stats["adapter_swaps"] == je.stats["adapter_swaps"] == NT
    assert treg.stats == jreg.stats and treg.stats["evictions"] > 0
    for t in range(NT):
        assert tout[t] == _single(tcfg, params, ads[t], t, prompts[t], 4), f"tenant {t}"


def test_tenant_quota_admission_order_matches_repro():
    jcfg, tcfg, params, ads, prompts = _mt_setup(2, seed=8)
    jreg, treg = _registries(jcfg, tcfg, ads, 2)
    je = JEngine(jcfg, params, adapters=jreg, max_slots=2, max_len=32, sc=GREEDY,
                 tenant_quota=1)
    te = _port_engine(tcfg, params, adapters=treg, max_slots=2, sc=GREEDY, tenant_quota=1)
    spec = [(i, 0) for i in range(3)] + [(10, 1)]       # tenant 1 queued behind 0's backlog
    jr = [JRequest(uid=u, prompt=prompts[t], max_new_tokens=6, tenant=t) for u, t in spec]
    tr = [Request(uid=u, prompt=prompts[t], max_new_tokens=6, tenant=t) for u, t in spec]
    for a, b in zip(jr, tr):
        je.submit(a)
        te.submit(b)
    seen_both = False
    for _ in range(100):
        if not te.queue and all(s is None for s in te.slots):
            break
        je.step()
        te.step()
        live = [r.tenant for r in te.slots if r is not None]
        assert live.count(0) <= 1 and live.count(1) <= 1
        seen_both = seen_both or set(live) == {0, 1}
        assert ([None if r is None else r.uid for r in te.slots]
                == [None if r is None else r.uid for r in je.slots])
        assert [r.uid for r in te.queue] == [r.uid for r in je.queue]
    assert seen_both and all(r.done for r in tr) and all(r.done for r in jr)
    assert [r.output for r in tr] == [r.output for r in jr]


def test_tenant_streams_independent_of_coresidency_and_order():
    NT = 3
    jcfg, tcfg, params, ads, prompts = _mt_setup(NT, seed=5)
    sc = SampleConfig(temperature=0.8)

    def serve(order, slots):
        _, treg = _registries(jcfg, tcfg, ads, max(slots, NT))
        eng = _port_engine(tcfg, params, adapters=treg, max_slots=slots, sc=sc, seed=11)
        reqs = {t: Request(uid=t, prompt=prompts[t], max_new_tokens=5, tenant=t)
                for t in order}
        _serve(eng, [reqs[t] for t in order])
        return {t: r.output for t, r in reqs.items()}

    together = serve([0, 1, 2], slots=3)
    reordered = serve([2, 0, 1], slots=3)
    serial = serve([1], slots=1) | serve([0], slots=1) | serve([2], slots=1)
    for t in range(NT):
        assert together[t] == reordered[t] == serial[t], f"tenant {t}"
    # the same uid and prompt under two tenants with identical weights
    _, treg = _registries(jcfg, tcfg, [ads[0], ads[0]], 2)
    eng = _port_engine(tcfg, params, adapters=treg, max_slots=2, sc=sc, seed=11)
    ra, rb = (Request(uid=7, prompt=prompts[0], max_new_tokens=8, tenant=t) for t in (0, 1))
    _serve(eng, [ra, rb])
    assert ra.output != rb.output


def test_stream_seed_without_a_tenant_is_unchanged():
    # the values of the single-adapter engines' seeds before tenants existed
    assert stream_seed(0, 0, 0) == 2558736989570252433
    assert stream_seed(7, 3, 5) == 8523025203025855591
    assert stream_seed(11, 2 ** 40, 31) == 980655797761988109
    assert stream_seed(7, 3, 5, tenant=None) == stream_seed(7, 3, 5)
    assert len({stream_seed(7, 3, 5), stream_seed(7, 3, 5, 0), stream_seed(7, 3, 5, 1)}) == 3


def test_hot_swap_between_steps_keeps_storage_and_other_tenants():
    jcfg, tcfg, params, ads, prompts = _mt_setup(2, seed=6)
    v2 = _adapter(jcfg, 999)
    _, treg = _registries(jcfg, tcfg, ads, 2)
    eng = _port_engine(tcfg, params, adapters=treg, max_slots=2, sc=GREEDY)
    r0 = Request(uid=0, prompt=prompts[0], max_new_tokens=8, tenant=0)
    r1 = Request(uid=1, prompt=prompts[1], max_new_tokens=8, tenant=1)
    eng.submit(r0)
    eng.submit(r1)
    for _ in range(3):
        eng.step()
    ptrs = [p.data_ptr() for p in tree_leaves(treg.pool)]
    assert treg.publish(1, interop.lora_from_numpy(v2, device="cpu")) == 2
    assert [p.data_ptr() for p in tree_leaves(treg.pool)] == ptrs
    eng.run()
    assert treg.stats["hot_swaps"] == 1
    assert r0.output == _single(tcfg, params, ads[0], 0, prompts[0], 8)
    rn = Request(uid=5, prompt=prompts[1], max_new_tokens=6, tenant=1)
    _serve(eng, [rn])
    assert rn.output == _single(tcfg, params, v2, 5, prompts[1], 6)


def test_configuration_errors_raise_as_in_repro():
    jcfg, tcfg, params, ads, _ = _mt_setup(1)
    jreg, treg = _registries(jcfg, tcfg, ads, 1)
    tlora = interop.lora_from_numpy(ads[0], device="cpu")
    cases = [(ValueError, dict(lora=ads[0]), dict(lora=tlora)),          # both
             (ValueError, dict(max_slots=2), dict(max_slots=2)),        # pool < slots
             (NotImplementedError, dict(paged=False), dict(paged=False)),  # slab
             (NotImplementedError, dict(fused=False), dict(fused=False))]  # naive
    for exc, jkw, tkw in cases:
        with pytest.raises(exc):
            JEngine(jcfg, params, adapters=jreg, max_len=32, **{"max_slots": 1, **jkw})
        with pytest.raises(exc):
            _port_engine(tcfg, params, adapters=treg, **{"max_slots": 1, **tkw})
    with pytest.raises(ValueError):
        JEngine(jcfg, params, tenant_quota=1, max_len=32)
    with pytest.raises(ValueError, match="tenant_quota"):
        _port_engine(tcfg, params, tenant_quota=1)


def test_serve_cli_multi_tenant_lines_match_repro(capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    flags = ["--arch", "gpt2-s", "--reduced", "--requests", "6", "--gen", "4",
             "--adapters", "5", "--adapter-pool", "4", "--tenant-trace", "zipf",
             "--tenant-quota", "1"]
    tserve.main(flags + ["--device", "cpu"])
    tout = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    jout = capsys.readouterr().out.splitlines()
    pick = lambda lines, head: [ln for ln in lines if ln.startswith(head)]   # noqa: E731
    for head in ("multi-tenant:", "per-tenant tokens:"):
        assert len(pick(tout, head)) == 1 and pick(tout, head) == pick(jout, head)
    assert "5 tenants over 4 pool slots (zipf trace)" in pick(tout, "multi-tenant:")[0]
