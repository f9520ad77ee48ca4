"""The port's precision module and int8-base LoRA matmul against ``repro``
on the same inputs: ``fake_quant`` (scalar and per-client bits, error
feedback, the all-zero guard, the exact 16-bit disarm) and the int8
weight / KV quantizers bit for bit; stochastic rounding by the
properties ``repro`` asserts; ``lora_matmul(..., w_scale=)`` forward
and every cotangent at 1e-5 / 2e-4 (the tolerances of the port's other
kernel tests); ``dense`` over an int8 base.  Inputs come from numpy
seeds; JAX runs on the CPU as its own tests run it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro import precision as jprec                        # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul  # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import precision as tprec                  # noqa: E402
from repro_torch.kernels.lora_matmul import (lora_matmul, lora_matmul_q8_dx,  # noqa: E402
                                             lora_matmul_q8_dx_ref, lora_matmul_q8_ref)
from repro_torch.models.layers import dense                 # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# fake_quant: bit-equal to repro's
# ---------------------------------------------------------------------------

BITS = {"scalar8": 8, "scalar4": 4, "scalar16": 16,
        "per_client_4_8_16": np.array([4, 8, 16], np.float32),
        "per_client_16": np.array([16, 16, 16], np.float32)}


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("bits", list(BITS), ids=list(BITS))
def test_fake_quant_bit_equal_to_repro(bits, with_err):
    rng = _rng(list(BITS).index(bits))
    x = (rng.normal(size=(3, 2, 16, 64)) * 3).astype(np.float32)
    err = (rng.normal(size=x.shape) * 0.05).astype(np.float32) if with_err else None
    b = BITS[bits]
    jo, je = jprec.fake_quant(jnp.asarray(x), jnp.asarray(b),
                              err=None if err is None else jnp.asarray(err))
    to, te = tprec.fake_quant(torch.from_numpy(x), torch.as_tensor(b),
                              err=None if err is None else torch.from_numpy(err))
    assert _same(to.numpy(), jo)
    assert (te is None) == (je is None)
    if te is not None:
        assert _same(te.numpy(), je)
    if np.all(np.asarray(b) >= 16):                 # exact disarm
        assert _same(to.numpy(), x)
        if te is not None:
            assert not te.any()


def test_fake_quant_per_client_16_row_is_the_input():
    x = _rng(1).normal(size=(3, 4, 8)).astype(np.float32)
    out, _ = tprec.fake_quant(torch.from_numpy(x), torch.tensor([4.0, 8.0, 16.0]))
    assert _same(out[2].numpy(), x[2])
    assert not np.array_equal(out[0].numpy(), x[0])


def test_fake_quant_all_zero_guard():
    """An all-zero tensor (a zero-init boundary) quantizes to zeros, not
    NaN, with and without error feedback — as repro's SCALE_FLOOR does."""
    z = np.zeros((3, 2, 4, 8), np.float32)
    for bits in (8, np.array([4, 8, 16], np.float32)):
        jo, je = jprec.fake_quant(jnp.asarray(z), jnp.asarray(bits), err=jnp.asarray(z))
        to, te = tprec.fake_quant(torch.from_numpy(z), torch.as_tensor(bits),
                                  err=torch.from_numpy(z))
        assert torch.isfinite(to).all() and torch.isfinite(te).all()
        assert _same(to.numpy(), jo) and _same(te.numpy(), je)
        assert not to.any() and not te.any()
    assert tprec.SCALE_FLOOR == jprec.SCALE_FLOOR


def test_fake_quant_ste_passes_the_gradient_straight_through():
    x = torch.from_numpy(_rng(2).normal(size=(3, 8)).astype(np.float32)).requires_grad_()
    out, _ = tprec.fake_quant_ste(x, torch.tensor([4.0, 8.0, 16.0]))
    q, _ = tprec.fake_quant(x.detach(), torch.tensor([4.0, 8.0, 16.0]))
    assert torch.equal(out.detach(), q)
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_precision_config_validation():
    with pytest.raises(ValueError):
        tprec.PrecisionConfig(act_bits=6)
    with pytest.raises(ValueError):
        tprec.PrecisionConfig(grad_bits=2)
    cfg = tprec.PrecisionConfig()
    assert (cfg.act_bits, cfg.grad_bits) == (16, 16)
    assert cfg.replace(grad_bits=8).grad_bits == 8
    with pytest.raises(ValueError):
        cfg.replace(act_bits=2)
    assert cfg.rng_seed == jprec.PrecisionConfig().rng_seed


# ---------------------------------------------------------------------------
# stochastic rounding: the properties repro asserts (tests/test_precision.py)
# ---------------------------------------------------------------------------

def _off_grid(v):
    # constant payload + one pinned max, so the scale is fixed at 1/127
    return torch.cat([torch.full((63,), v), torch.ones(1)])


def test_stochastic_rounding_unbiased():
    x = _off_grid(0.123)
    det, _ = tprec.fake_quant(x, 8)
    det_bias = abs(float(det[:63].mean()) - 0.123)
    n = 400
    acc = sum(float(tprec.fake_quant(x, 8, gen=tprec.round_key(1, i, 0))[0][:63].mean())
              for i in range(n))
    sto_bias = abs(acc / n - 0.123)
    assert det_bias > 1e-3                 # 0.123 sits off-grid by design
    assert sto_bias < 5e-4                 # the mean converges to the value
    assert sto_bias < det_bias


@pytest.mark.parametrize("v", [0.02, 0.31, 0.5, 0.77, 0.98])
def test_stochastic_rounding_mean_within_a_quarter_step(v):
    x = _off_grid(v)
    n = 200
    acc = sum(float(tprec.fake_quant(x, 8, gen=tprec.round_key(3, i, 1))[0][:63].mean())
              for i in range(n))
    assert abs(acc / n - v) < 0.25 / 127.0          # one step is 1/127


def test_round_key_same_seed_same_draws():
    x = torch.from_numpy(_rng(4).normal(size=(2, 64)).astype(np.float32))
    a, _ = tprec.fake_quant(x, 4, gen=tprec.round_key(7, 3, 0))
    b, _ = tprec.fake_quant(x, 4, gen=tprec.round_key(7, 3, 0))
    assert torch.equal(a, b)
    draws = {tuple(torch.rand(8, generator=tprec.round_key(7, s, st)).tolist())
             for s in range(4) for st in (0, 1)}
    assert len(draws) == 8                 # step and stream both move the draws


# ---------------------------------------------------------------------------
# int8 weights and KV: bit-equal to repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 32), (3, 64, 32), (70, 45)])
def test_quantize_weight_int8_bit_equal_to_repro(shape):
    w = (_rng(5).normal(size=shape) * 0.1).astype(np.float32)
    jq, js = jprec.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tprec.quantize_weight_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert _same(tq.numpy(), jq) and _same(ts.numpy(), js)
    assert _same(tprec.dequantize_weight(tq, ts).numpy(), jprec.dequantize_weight(jq, js))


def test_quantize_params_int8_bit_equal_to_repro():
    """The per-layer walk gives repro's stacked (int8 w, f32 w_scale) pairs
    layer for layer; embeddings, norms and biases stay f32; the input is
    left alone and a second pass changes nothing."""
    jcfg = j_get_arch("gpt2-s").reduced(num_layers=2)
    params = jax.tree.map(np.array, JM.init_params(jcfg, jax.random.key(0)))
    jqp = jax.tree.map(np.asarray, jprec.quantize_params_int8(params))
    tp = interop.params_from_numpy(params, "cpu")
    before = [t.clone() for t in tree_leaves(tp)]
    tqp = tprec.quantize_params_int8(tp)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    want = interop.params_from_numpy(jqp, "cpu")
    for a, b in zip(tree_leaves(tqp), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tqp["layers"][0]["mixer"]["wq"]["w"].dtype == torch.int8
    assert tqp["layers"][0]["mixer"]["wq"]["w_scale"].shape == (jcfg.d_model,)
    assert tqp["embed"]["tok"].dtype == torch.float32
    again = tprec.quantize_params_int8(tqp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(tqp)))
    # int8 crosses back to repro's stacked layout unchanged
    back = interop.params_to_numpy(tqp, len(jcfg.pattern))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jqp)):
        assert _same(a, b)


@pytest.mark.parametrize("shape,head_axis", [((2, 3, 16, 8), 1), ((3, 5, 4, 8), 0)])
def test_quantize_kv_int8_bit_equal_to_repro(shape, head_axis):
    kv = _rng(6).normal(size=shape).astype(np.float32)
    jq, js = jprec.quantize_kv_int8(jnp.asarray(kv), head_axis=head_axis)
    tq, ts = tprec.quantize_kv_int8(torch.from_numpy(kv), head_axis=head_axis)
    assert _same(tq.numpy(), jq) and _same(ts.numpy(), js)


# ---------------------------------------------------------------------------
# lora_matmul over an int8 base: forward and cotangents vs repro's CPU route
# ---------------------------------------------------------------------------

def _q8_inputs(M, K, N, r, seed=0):
    rng = _rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    a = (rng.normal(size=(r, K)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=(N, r)).astype(np.float32)
    cot = rng.normal(size=(M, N)).astype(np.float32)
    wq, ws = (np.array(t) for t in jprec.quantize_weight_int8(jnp.asarray(w)))
    return x, wq, ws, a, b, cot


@pytest.mark.parametrize("M,K,N,r", [(64, 128, 96, 4), (33, 70, 45, 2), (16, 64, 64, 8)])
def test_lora_matmul_q8_matches_repro(M, K, N, r):
    """Forward at 1e-5 and dx, da, db at 2e-4 against
    ``repro.kernels.lora_matmul.lora_matmul(..., w_scale=)`` on the CPU
    (its plain route and the non-kernel branch of ``_bwd_value_q8``)."""
    x, wq, ws, a, b, cot = _q8_inputs(M, K, N, r)
    s = 1.25

    def jf(x_, a_, b_):
        return j_lora_matmul(x_, jnp.asarray(wq), a_, b_, scale=s, w_scale=jnp.asarray(ws))

    jy, vjp = jax.vjp(jf, *(jnp.asarray(t) for t in (x, a, b)))
    jdx, jda, jdb = vjp(jnp.asarray(cot))
    tx, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    tw, tws = torch.from_numpy(wq), torch.from_numpy(ws)
    ty = lora_matmul(tx, tw, ta, tb, scale=s, w_scale=tws)
    ty.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD_TOL)
    for name, g, want in (("dx", tx.grad, jdx), ("da", ta.grad, jda), ("db", tb.grad, jdb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=name, **GRAD_TOL)


def test_lora_matmul_q8_takes_no_gradient_for_the_int8_base():
    """The int8 W cannot carry a gradient and its scale gets none (JAX's
    float0 and dropped zeros); a frozen x gets no dX."""
    x, wq, ws, a, b, cot = _q8_inputs(8, 32, 24, 2)
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    tws = torch.from_numpy(ws).requires_grad_()
    tx = torch.from_numpy(x)
    lora_matmul(tx, torch.from_numpy(wq), ta, tb, scale=2.0, w_scale=tws).backward(
        torch.from_numpy(cot))
    assert tws.grad is None and tx.grad is None
    assert ta.grad is not None and tb.grad is not None


def test_q8_plain_versions_match_repro_formulas():
    """lora_matmul_q8_ref and lora_matmul_q8_dx_ref against repro's q8
    oracle and the dX of ``_bwd_value_q8``'s non-kernel branch."""
    from repro.kernels.lora_matmul.ref import lora_matmul_q8_ref as j_ref
    x, wq, ws, a, b, cot = _q8_inputs(33, 70, 45, 2, seed=3)
    y = lora_matmul_q8_ref(*(torch.from_numpy(t) for t in (x, wq, ws, a, b)), 1.5)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_ref(x, wq, ws, a, b, 1.5)), **FWD_TOL)
    wf = wq.astype(np.float32) * ws.reshape(1, -1)
    want = cot @ wf.T + 1.5 * (cot @ b) @ a
    for fn in (lora_matmul_q8_dx_ref, lora_matmul_q8_dx):
        dx = fn(torch.from_numpy(cot), torch.from_numpy(wq), torch.from_numpy(ws),
                torch.from_numpy(a), torch.from_numpy(b), 1.5)
        np.testing.assert_allclose(dx.numpy(), want, **FWD_TOL)


# ---------------------------------------------------------------------------
# dense over an int8 base
# ---------------------------------------------------------------------------

def test_dense_refuses_an_int8_weight_without_its_scale():
    x = torch.randn(2, 8)
    wq = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(TypeError, match="w_scale"):
        dense(x, wq)
    with pytest.raises(TypeError, match="w_scale"):
        dense(x, wq, lora={"a": torch.zeros(2, 8), "b": torch.zeros(4, 2)}, impl="fused")


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_dense_int8_matches_repro(impl):
    """dense(..., w_scale=) on both routes against repro's dense on the
    CPU (which dequantizes at the mouth), with and without an adapter."""
    from repro.models.layers import dense as j_dense
    x, wq, ws, a, b, _ = _q8_inputs(6, 32, 24, 2, seed=8)
    x3 = x.reshape(2, 3, 32)
    bias = _rng(9).normal(size=(24,)).astype(np.float32)
    for lora in (None, {"a": a, "b": b}):
        jy = j_dense(jnp.asarray(x3), jnp.asarray(wq), jnp.asarray(bias),
                     lora=None if lora is None else jax.tree.map(jnp.asarray, lora),
                     lora_scale=2.0, impl=impl, w_scale=jnp.asarray(ws))
        ty = dense(torch.from_numpy(x3), torch.from_numpy(wq), torch.from_numpy(bias),
                   lora=None if lora is None else {k: torch.from_numpy(v)
                                                   for k, v in lora.items()},
                   lora_scale=2.0, impl=impl, w_scale=torch.from_numpy(ws))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD_TOL)
