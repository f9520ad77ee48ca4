"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against
``repro``'s on the same numpy inputs: the op against ``repro``'s
``ssd_scan`` run as its own tests run it on the CPU (the Pallas
interpreter) and against the per-token oracle, at the four shapes of
``tests/test_kernels.py::test_ssd_scan_sweep`` (f32, atol 1e-4, rtol
1e-3); ``ssd_chunked`` against ``repro.models.ssm.ssd_chunked`` (y and
the final state, S not a multiple of the chunk); the per-token oracles
against each other; both plain versions in f64; the CPU route and its
launch count; and the kernel wrapper's refusals (no card here: a CPU
tensor is refused, never run)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan   # noqa: E402
from repro.kernels.ssd_scan import ssd_sequential_ref as j_seq  # noqa: E402
from repro.models.ssm import ssd_chunked as j_chunked       # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan,  # noqa: E402
                                          ssd_scan_kernel, ssd_scan_with_state,
                                          ssd_sequential_ref)

TOL = dict(atol=1e-4, rtol=1e-3)
SHAPES = [(2, 64, 4, 32, 16, 16), (1, 100, 2, 16, 8, 32), (2, 31, 3, 8, 4, 16),
          (1, 256, 2, 64, 32, 64)]


def _inputs(B, S, nh, hd, N, seed=0):
    """The sweep's distributions: x ~ N(0, 1), B/C ~ N(0, 1/N), dt =
    softplus(N(0, 1)), A = -exp(linspace(0, 1.5, nh))."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * N ** -0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * N ** -0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -np.exp(np.linspace(0.0, 1.5, nh)).astype(np.float32)
    return xh, Bm, Cm, dt, A


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("B,S,nh,hd,N,Q", SHAPES)
def test_ssd_scan_matches_repros_kernel_and_oracle(B, S, nh, hd, N, Q):
    ins = _inputs(B, S, nh, hd, N, seed=S)
    y = ssd_scan(*_t(*ins), chunk=Q)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, nh, hd)
    yk = np.asarray(j_ssd_scan(*_j(*ins), chunk=Q, interpret=True))
    yr, _ = j_seq(*_j(*ins))
    np.testing.assert_allclose(y.numpy(), yk, **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)


@pytest.mark.parametrize("B,S,nh,hd,N,Q", [(2, 45, 3, 8, 4, 16), (1, 100, 2, 16, 8, 32),
                                           (1, 7, 2, 4, 4, 32)])
def test_ssd_chunked_matches_repro_y_and_state(B, S, nh, hd, N, Q):
    ins = _inputs(B, S, nh, hd, N, seed=7)
    y, h = ssd_chunked(*_t(*ins), chunk=Q)
    jy, jh = j_chunked(*_j(*ins), chunk=Q)
    assert tuple(h.shape) == (B, nh, hd, N) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    # both against the per-token oracle, state included
    ys, hs = ssd_sequential_ref(*_t(*ins))
    jys, jhs = j_seq(*_j(*ins))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **TOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), **TOL)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), **TOL)


def test_cpu_route_is_ssd_chunked_and_launches_nothing():
    ins = _t(*_inputs(2, 45, 3, 8, 4))
    backend.reset_launch_counts()
    y, h = ssd_scan_with_state(*ins, chunk=16)
    y2, h2 = ssd_chunked(*ins, chunk=16)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert "ssd_scan" not in backend.LAUNCH_COUNTS
    # use_kernel=False takes the per-token oracle, as in repro
    assert torch.equal(ssd_scan(*ins, chunk=16, use_kernel=False),
                       ssd_sequential_ref(*ins)[0])


def test_cpu_route_keeps_autograd():
    xh, Bm, Cm, dt, A = _t(*_inputs(1, 20, 2, 4, 4))
    xh.requires_grad_()
    y, h = ssd_scan_with_state(xh, Bm, Cm, dt, A, chunk=8)
    (y.sum() + h.sum()).backward()
    assert xh.grad is not None and bool(torch.isfinite(xh.grad).all())


def test_bf16_inputs_compute_in_f32():
    ins = _inputs(1, 40, 2, 8, 8, seed=3)
    tb = [t.to(torch.bfloat16) for t in _t(*ins[:4])] + [torch.from_numpy(ins[4])]
    y = ssd_scan(*tb, chunk=16)
    assert y.dtype == torch.bfloat16
    yf, _ = ssd_chunked(*[t.float() for t in tb], chunk=16)
    np.testing.assert_allclose(y.float().numpy(), yf.to(torch.bfloat16).float().numpy(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("B,S,nh,hd,N,Q", [(2, 31, 3, 8, 4, 16), (1, 100, 2, 16, 8, 32)])
def test_plain_versions_compute_in_f64_when_given_f64(B, S, nh, hd, N, Q):
    """The double-precision witness: f64 in, f64 throughout and out; the
    two plain versions agree to f64 rounding, and the f32 run lies within
    the scan's tolerance of it."""
    ins = _inputs(B, S, nh, hd, N, seed=5)
    t64 = [t.double() for t in _t(*ins)]
    y64, h64 = ssd_chunked(*t64, chunk=Q)
    ys64, hs64 = ssd_sequential_ref(*t64)
    assert {t.dtype for t in (y64, h64, ys64, hs64)} == {torch.float64}
    assert ssd_scan(*t64, chunk=Q).dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), ys64.numpy(), atol=1e-12, rtol=1e-10)
    np.testing.assert_allclose(h64.numpy(), hs64.numpy(), atol=1e-12, rtol=1e-10)
    y, h = ssd_chunked(*_t(*ins), chunk=Q)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **TOL)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """Without a card the kernel entry never runs: a CPU tensor is refused
    (no silent fallback), as are a dtype, a shape or a chunk it does not
    take, before any library is built."""
    B, nh, S, hd, N = 1, 2, 32, 8, 4
    xdt = torch.zeros(B, nh, S, hd)
    g = torch.zeros(B, nh, S)
    Bm = torch.zeros(B, S, N)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan_kernel(xdt.double(), g, Bm, Bm, chunk=16)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_scan_kernel(xdt, g[:, :1], Bm, Bm, chunk=16)
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(B, S, 257)
        ssd_scan_kernel(xdt, g, big, big, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_kernel(xdt, g, Bm, Bm, chunk=24)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_kernel(xdt, g, Bm, Bm, chunk=16)
