"""The ``Runtime`` knobs the port took over last: ``attn_impl``,
``kv_chunk``, ``q_chunk`` (the causal-prefix walk and the mapped form),
``attn_s_bf16`` and ``remat_policy`` ("full", "dots"), against ``repro``.

* ``run_attention`` forward and gradients (a cotangent through
  ``jax.vjp``) on ``tests/test_models.py``'s (kv_chunk, q_chunk) grid
  (16, 0), (16, 16), (64, 32), (7, 0), with and without a window of 24,
  causal-prefix and mapped, and ``impl="naive"``: 1e-5 (f32).
* ``attn_s_bf16``: bf16 q/k/v with the score einsum in bf16, forward and
  gradients against ``repro``'s at bf16 tolerance (2e-2 of the largest
  entry: a bf16 score is off by 2^-8 relative, which the softmax carries
  into the output at that scale).
* remat "full" and "dots" on reduced yi-9b (GQA, LoRA on q, v, o, up,
  down; fused and einsum dense): loss and LoRA gradients equal to no
  remat (1e-6) and within 1e-4 of ``repro``'s ``loss_fn`` under
  ``Runtime(remat=True, remat_policy="dots")``; counting the fused
  projection's forward (``backend.dispatch`` of "lora_matmul"), "dots"
  runs each projection once, as no remat does, and "full" twice.
* ``Runtime`` has every field of ``repro``'s with its default, and
  ``default_train_runtime`` takes "dots".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_arch as j_get_arch
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch import models as TM
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import backend
from repro_torch.launch.steps import _value_and_grad
from repro_torch.models import attention as tattn
from repro_torch.tree import tree_leaves

TOL = dict(atol=1e-5, rtol=1e-5)
GRID = [(16, 0), (16, 16), (64, 32), (7, 0)]


def _qkv(seed, dtype=np.float32, S=64):
    rng = np.random.default_rng(seed)
    B, H, KH, D = 2, 4, 2, 16
    q, k, v, cot = (rng.normal(size=s).astype(np.float32) for s in
                    ((B, S, H, D), (B, S, KH, D), (B, S, KH, D), (B, S, H, D)))
    return q, k, v, cot, np.arange(S, dtype=np.int32)


def _both(q, k, v, cot, pos, kw, jdtype=jnp.float32, tdtype=torch.float32):
    """(port out, port grads, repro out, repro grads) of run_attention."""
    p = torch.from_numpy(pos)
    jo, vjp = jax.vjp(lambda q, k, v: jattn.run_attention(q, k, v, pos, pos, **kw),
                      *(jnp.asarray(t, jdtype) for t in (q, k, v)))
    jg = vjp(jnp.asarray(cot, jdtype))
    ts = [torch.from_numpy(t).to(tdtype).requires_grad_() for t in (q, k, v)]
    to = tattn.run_attention(*ts, p, p, **kw)
    to.backward(torch.from_numpy(cot).to(tdtype))
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))        # noqa: E731
    return (to.detach().float().numpy(), [t.grad.float().numpy() for t in ts],
            f(jo), [f(g) for g in jg])


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("causal_prefix", [True, False])
@pytest.mark.parametrize("kv_chunk,q_chunk", GRID)
def test_run_attention_matches_repro(kv_chunk, q_chunk, causal_prefix, window):
    q, k, v, cot, pos = _qkv(kv_chunk + q_chunk + window)
    kw = dict(impl="chunked", window=window, kv_chunk=kv_chunk, q_chunk=q_chunk,
              causal_prefix=causal_prefix)
    to, tg, jo, jg = _both(q, k, v, cot, pos, kw)
    np.testing.assert_allclose(to, jo, **TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_naive_impl_and_the_one_chunk_rule():
    q, k, v, cot, pos = _qkv(3)
    to, tg, jo, jg = _both(q, k, v, cot, pos, dict(impl="naive", window=24))
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    p = torch.from_numpy(pos)
    # repro's rule: whole KV in one chunk and no query blocking -> naive;
    # query blocking or the low-precision scores -> the online softmax
    naive = tattn.naive_attention(*t, p, p)
    assert torch.equal(tattn.run_attention(*t, p, p, kv_chunk=64), naive)
    blocked = tattn.run_attention(*t, p, p, kv_chunk=64, q_chunk=32, causal_prefix=True)
    assert not torch.equal(blocked, naive)
    torch.testing.assert_close(blocked, naive, **TOL)
    lowp = tattn.run_attention(*t, p, p, kv_chunk=64, s_low_precision=True)
    assert torch.equal(lowp, tattn.online_attention(*t, p, p, kv_chunk=64,
                                                    s_low_precision=True))


@pytest.mark.parametrize("q_chunk", [0, 32])
def test_attn_s_bf16_matches_repro_at_bf16(q_chunk):
    q, k, v, cot, pos = _qkv(7)
    kw = dict(impl="chunked", kv_chunk=16, q_chunk=q_chunk, causal_prefix=True,
              s_low_precision=True)
    to, tg, jo, jg = _both(q, k, v, cot, pos, kw, jnp.bfloat16, torch.bfloat16)
    assert np.abs(to - jo).max() <= 2e-2 * np.abs(jo).max()
    for a, b in zip(tg, jg):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()
    # the bf16 scores are what moved: f32 scores on the same bf16 inputs
    # give other values
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    p = torch.from_numpy(pos)
    f32 = tattn.online_attention(*t, p, p, kv_chunk=16, q_chunk=q_chunk, causal_prefix=True)
    low = tattn.online_attention(*t, p, p, kv_chunk=16, q_chunk=q_chunk, causal_prefix=True,
                                 s_low_precision=True)
    assert not torch.equal(f32, low)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

def _yi():
    kw = dict(num_layers=2, d_model=64, vocab=256)
    jcfg = j_get_arch("yi-9b").reduced(**kw).replace(lora_targets=("q", "v", "o", "up", "down"))
    tcfg = t_get_arch("yi-9b").reduced(**kw).replace(lora_targets=("q", "v", "o", "up", "down"))
    params = JM.init_params(jcfg, jax.random.key(0))
    lora = JM.init_lora_stack(jcfg, jax.random.key(1))
    lora = jax.tree.map(lambda v: v + 0.05 * jax.random.normal(jax.random.key(2), v.shape),
                        lora)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    return jcfg, tcfg, params, lora, {"tokens": toks, "labels": toks}


@pytest.fixture(scope="module")
def yi():
    jcfg, tcfg, params, lora, batch = _yi()
    jrt = JM.Runtime(remat=True, remat_policy="dots")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda lo: JM.loss_fn(jcfg, params, lo, batch, rt=jrt), has_aux=True))(lora)
    host = lambda t: jax.tree.map(np.asarray, t)                  # noqa: E731
    return {"tcfg": tcfg, "params": interop.params_from_numpy(host(params), "cpu"),
            "lora": interop.lora_from_numpy(host(lora), "cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "repro": (float(jl), interop.split_layers(jax.tree.map(np.asarray, jg)))}


def _run(yi, rt):
    calls = {"n": 0}
    dispatch = backend.dispatch

    def counting(op, **kw):
        calls["n"] += op == "lora_matmul"
        return dispatch(op, **kw)

    backend.dispatch = counting
    try:
        loss, _, grads = _value_and_grad(
            lambda lo: TM.loss_fn(yi["tcfg"], yi["params"], lo, yi["batch"], rt=rt), yi["lora"])
    finally:
        backend.dispatch = dispatch
    return float(loss), tree_leaves(grads), calls["n"]


@pytest.mark.parametrize("dense_impl", ["fused", "einsum"])
def test_remat_policies_match_no_remat_and_repro(yi, dense_impl):
    base = TM.Runtime(dense_impl=dense_impl)
    loss0, g0, n0 = _run(yi, base)
    jl, jg = yi["repro"]
    assert abs(loss0 - jl) < 1e-4
    for a, b in zip(g0, tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    counts = {}
    for policy in ("full", "dots"):
        loss, g, counts[policy] = _run(yi, base.replace(remat=True, remat_policy=policy))
        assert abs(loss - loss0) < 1e-6, policy
        for a, b in zip(g, g0):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=policy)
    if dense_impl == "fused":
        # 5 adapted projections a layer, 2 layers
        assert n0 == 10
        assert counts == {"full": 2 * n0, "dots": n0}
    else:
        assert n0 == 0 and counts == {"full": 0, "dots": 0}


def test_remat_policy_is_checked():
    jcfg, tcfg, *_ = _yi()
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat_policy"):
        TM.loss_fn(tcfg, params, None, {"tokens": toks, "labels": toks},
                   rt=TM.Runtime(remat=True, remat_policy="everything"))


def test_runtime_has_every_field_of_repros():
    jf = {f.name: f.default for f in dataclasses.fields(JM.Runtime)}
    tf = {f.name: f.default for f in dataclasses.fields(TM.Runtime)}
    for name, default in jf.items():
        assert name in tf, name
        if name != "precision":
            assert tf[name] == default, name
    assert set(tf) - set(jf) == {"ssd_impl", "pool", "mesh"}
    assert TM.default_train_runtime().remat_policy == "dots"
    assert JM.default_train_runtime().remat_policy == "dots"
