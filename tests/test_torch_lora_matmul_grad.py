"""The port's differentiable fused LoRA matmul (CPU route: the plain
backward of ``_FusedLoraMatmul``) against ``jax.vjp`` of ``repro``'s
``lora_matmul`` with the Pallas dX and rank-reduce kernels in interpret
mode, on the same numpy inputs.  f32 tolerance 2e-4 (``repro``'s
GRAD_TOLS): both sides accumulate in f32 and differ in summation order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul  # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.lora_matmul import (lora_matmul,  # noqa: E402
                                             lora_matmul_dx, lora_matmul_dx_kernel,
                                             lora_matmul_dx_ref, lora_rank_reduce,
                                             lora_rank_reduce_kernel,
                                             lora_rank_reduce_ref)

GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
SCALE = 1.25

# the shapes of test_kernels.py::test_lora_matmul_vjp_parity
SHAPES = [(64, 128, 96, 4),     # block-aligned-ish
          (33, 70, 45, 2),      # ragged everywhere
          (48, 64, 40, 1),      # ragged N, rank 1
          (128, 96, 64, 8)]


def _inputs(M, K, N, r, seed=0):
    rng = np.random.default_rng(seed + M + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    a = (rng.normal(size=(r, K)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=(N, r)).astype(np.float32)
    cot = rng.normal(size=(M, N)).astype(np.float32)
    return x, w, a, b, cot


def _port_grads(x, w, a, b, cot, need=(True, True, True, True)):
    ts = [torch.from_numpy(t).requires_grad_(n) for t, n in zip((x, w, a, b), need)]
    y = lora_matmul(*ts, scale=SCALE)
    y.backward(torch.from_numpy(cot))
    return y, [t.grad for t in ts]


@pytest.mark.parametrize("M,K,N,r", SHAPES)
def test_vjp_matches_repro_interpret_kernels(M, K, N, r):
    x, w, a, b, cot = _inputs(M, K, N, r)
    backend.reset_launch_counts()
    y, grads = _port_grads(x, w, a, b, cot)
    assert backend.LAUNCH_COUNTS == {}                      # CPU: no launch

    def fk(x, w, a, b):
        return j_lora_matmul(x, w, a, b, scale=SCALE, bm=32, bn=32, bk=32,
                             interpret=True, use_kernel=True)

    jy, vjp = jax.vjp(fk, *(jnp.asarray(t) for t in (x, w, a, b)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
    for name, g, jg in zip(("dx", "dw", "da", "db"), grads, vjp(jnp.asarray(cot))):
        assert tuple(g.shape) == jg.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("lead", [(2, 3), (1, 16)])
def test_vjp_with_leading_dims(lead):
    """x (..., K): the op flattens the leading dims and its gradient comes
    back in x's shape."""
    x, w, a, b, _ = _inputs(int(np.prod(lead)), 40, 24, 4)
    cot = np.random.default_rng(1).normal(size=lead + (24,)).astype(np.float32)
    xl = x.reshape(lead + (40,))
    y, grads = _port_grads(xl, w, a, b, cot)
    jy, vjp = jax.vjp(lambda *z: j_lora_matmul(*z, scale=SCALE, use_kernel=False),
                      *(jnp.asarray(t) for t in (xl, w, a, b)))
    assert tuple(y.shape) == lead + (24,)
    for g, jg in zip(grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)


def _mm_count(fn) -> int:
    with torch.autograd.profiler.profile() as prof:
        fn()
    return sum(1 for e in prof.function_events if e.name in ("aten::mm", "aten::matmul"))


def test_dw_is_not_computed_for_a_frozen_w():
    """A frozen W (requires_grad False) gets no gradient and its product
    x^T dY is never formed: the backward runs one matmul fewer."""
    x, w, a, b, cot = _inputs(33, 70, 45, 2)
    _, g_frozen = _port_grads(x, w, a, b, cot, need=(True, False, True, True))
    _, g_all = _port_grads(x, w, a, b, cot)
    assert g_frozen[1] is None
    for gf, ga in zip(g_frozen[::2] + g_frozen[3:], g_all[::2] + g_all[3:]):
        torch.testing.assert_close(gf, ga)

    def bwd(need_w):
        ts = [torch.from_numpy(t).requires_grad_(n)
              for t, n in zip((x, w, a, b), (True, need_w, True, True))]
        y = lora_matmul(*ts, scale=SCALE)
        return lambda: y.backward(torch.from_numpy(cot))

    assert _mm_count(bwd(False)) < _mm_count(bwd(True))


def test_no_dx_when_x_is_a_constant():
    """Layer 0's input does not require grad: no dX is formed."""
    x, w, a, b, cot = _inputs(16, 24, 8, 2)
    _, grads = _port_grads(x, w, a, b, cot, need=(False, False, True, True))
    assert grads[0] is None and grads[1] is None
    assert grads[2] is not None and grads[3] is not None


def test_gradcheck_float64_plain_path():
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(s, generator=g, dtype=torch.float64, requires_grad=True)
          for s in ((5, 7), (7, 6), (3, 7), (6, 3))]
    assert torch.autograd.gradcheck(lambda *z: lora_matmul(*z, scale=1.5), ts)


@pytest.mark.parametrize("M,K,N,r", SHAPES)
def test_plain_backward_pieces_match_repro_oracle(M, K, N, r):
    """The two plain versions the CUDA kernels are held against on the
    card agree with the math of repro's non-kernel backward branch."""
    x, w, a, b, cot = _inputs(M, K, N, r)
    t = [torch.from_numpy(v) for v in (x, w, a, b, cot)]
    dx = lora_matmul_dx_ref(t[4], t[1], t[2], t[3], SCALE)
    ref_dx = cot @ w.T + SCALE * ((cot @ b) @ a)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **GRAD_TOL)
    assert torch.equal(lora_matmul_dx(t[4], t[1], t[2], t[3], SCALE), dx)
    z2 = t[4] @ t[3]
    out = lora_rank_reduce_ref(z2, t[0])
    assert out.dtype == torch.float32 and tuple(out.shape) == (r, K)
    np.testing.assert_allclose(out.numpy(), (cot @ b).T @ x, **GRAD_TOL)
    assert torch.equal(lora_rank_reduce(z2, t[0]), out)
    bf = lora_rank_reduce_ref(z2, t[0].to(torch.bfloat16))
    assert bf.dtype == torch.float32


def test_kernel_entries_refuse_cpu_tensors():
    """The CUDA entries never take a CPU tensor: no silent route."""
    x, w, a, b, cot = (torch.from_numpy(v) for v in _inputs(8, 16, 12, 2))
    with pytest.raises(ValueError, match="CUDA"):
        lora_matmul_dx_kernel(cot, w, a, b, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        lora_rank_reduce_kernel(cot @ b, x)
