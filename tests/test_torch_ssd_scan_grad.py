"""The SSD scan's backward against ``repro`` on the same numpy inputs:
``ssd_scan_bwd_ref`` (the closed form, the backward kernel's plain
version) against autograd through the port's ``ssd_chunked`` in f64 (rel
1e-9), and the kernel route (``_SsdScan``: the pre-scaling, permutes and
padding as torch ops, the scan and its backward as the plain versions on
the CPU) against ``jax.grad`` of ``repro.models.ssm.ssd_chunked`` in f32
(atol 1e-5, the per-kernel tolerance).  S 40 and 72 at Q 32 (several
chunks, a padded tail), with and without a cotangent on the final state;
outputs that no loss reads take none; the backward wrapper's refusals (no
card here: a CPU tensor is refused, never run)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.models.ssm import ssd_chunked as j_chunked       # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan_bwd_kernel,  # noqa: E402
                                          ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ops import _kernel_route  # noqa: E402

Q = 32
CASES = [(40, False), (40, True), (72, False), (72, True)]
IDS = [f"S{s}-{'dh' if d else 'no_dh'}" for s, d in CASES]


def _inputs(S, B=2, nh=3, hd=8, N=16, seed=0):
    """Reduced Mamba2's head shapes (heads of 8 here, state 16, chunk 32);
    dt post-softplus, A = -exp(linspace(0, 1.5)); the cotangents dy (B, S,
    nh, hd) and dh (B, nh, hd, N)."""
    rng = np.random.default_rng(seed + S)
    xh = rng.standard_normal((B, S, nh, hd))
    Bm = rng.standard_normal((B, S, N)) * N ** -0.5
    Cm = rng.standard_normal((B, S, N)) * N ** -0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    A = -np.exp(np.linspace(0.0, 1.5, nh))
    dy = rng.standard_normal((B, S, nh, hd))
    dh = rng.standard_normal((B, nh, hd, N))
    return [a.astype(np.float32) for a in (xh, Bm, Cm, dt, A)], dy.astype(np.float32), \
        dh.astype(np.float32)


def _kernel_layout(xh, Bm, Cm, dt, A):
    """``_kernel_route``'s operands, in xh's dtype: xdt, g, Bm, Cm padded to
    a multiple of Q."""
    B, S, nh, hd = xh.shape
    pad = (-S) % Q
    xdt = torch.nn.functional.pad((xh * dt[..., None]).permute(0, 2, 1, 3), (0, 0, 0, pad))
    g = torch.nn.functional.pad((dt * A).permute(0, 2, 1), (0, pad))
    Bk = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    Ck = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    return xdt, g, Bk, Ck


@pytest.mark.parametrize("S,with_dh", CASES, ids=IDS)
def test_bwd_ref_matches_autograd_through_ssd_chunked_in_f64(S, with_dh):
    """The closed form in the kernel layout, carried back to the model
    layout by the chain rule of the pre-scaling (dxh = dxdt dt, ddt = sum_d
    dxdt x + dg A, dA = sum dg dt), against autograd through ``ssd_chunked``
    on the model-layout operands, all in f64."""
    ins, dy, dh = _inputs(S)
    xh, Bm, Cm, dt, A = (torch.from_numpy(a).double().requires_grad_() for a in ins)
    dy, dh = torch.from_numpy(dy).double(), torch.from_numpy(dh).double()
    y, h = ssd_chunked(xh, Bm, Cm, dt, A, chunk=Q)
    loss = (y * dy).sum() + ((h * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(loss, (xh, Bm, Cm, dt, A))

    with torch.no_grad():
        xdt, g, Bk, Ck = _kernel_layout(xh, Bm, Cm, dt, A)
        dyk = torch.nn.functional.pad(dy.permute(0, 2, 1, 3), (0, 0, 0, (-S) % Q))
        dxdt, dg, dB, dC = ssd_scan_bwd_ref(xdt, g, Bk, Ck, dyk, dh if with_dh else None,
                                            chunk=Q)
        assert {t.dtype for t in (dxdt, dg, dB, dC)} == {torch.float64}
        dxdt, dg = dxdt[:, :, :S].permute(0, 2, 1, 3), dg[:, :, :S].permute(0, 2, 1)
        got = (dxdt * dt[..., None], dB[:, :S], dC[:, :S],
               (dxdt * xh).sum(-1) + dg * A, (dg * dt).sum((0, 1)))
    for name, a, b in zip(("x", "B", "C", "dt", "A"), got, want):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= 1e-9, (name, err)


_j_grad = jax.jit(jax.grad(
    lambda ins, dy, dh: (jnp.sum(j_chunked(*ins, chunk=Q)[0] * dy)
                         + jnp.sum(j_chunked(*ins, chunk=Q)[1] * dh))))


@pytest.mark.parametrize("S,with_dh", CASES, ids=IDS)
def test_kernel_route_grads_match_jax_grad_of_repros_ssd_chunked(S, with_dh):
    """``_kernel_route`` on the CPU: ``_SsdScan`` takes ``ssd_scan_ref``
    forward and ``ssd_scan_bwd_ref`` backward (the kernels' plain
    versions; nothing is launched), autograd carries the pre-scaling.  Its
    y, final state and five gradients against ``repro``'s ``ssd_chunked``
    and ``jax.grad`` of it."""
    ins, dy, dh = _inputs(S, seed=1)
    dh_used = dh if with_dh else np.zeros_like(dh)
    jg = _j_grad([jnp.asarray(a) for a in ins], jnp.asarray(dy), jnp.asarray(dh_used))
    jy, jh = j_chunked(*[jnp.asarray(a) for a in ins], chunk=Q)
    t_ins = [torch.from_numpy(a).requires_grad_() for a in ins]
    backend.reset_launch_counts()
    y, h = _kernel_route(*t_ins, chunk=Q)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dh:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    loss.backward()
    assert not backend.LAUNCH_COUNTS
    for name, t, j in zip(("x", "B", "C", "dt", "A"), t_ins, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("used", ["y", "h"])
def test_an_output_no_loss_reads_takes_no_cotangent(used):
    """Only y (training: the block drops the state) or only the final
    state: the backward gets None for the other and equals autograd
    through ``ssd_chunked``."""
    ins, dy, _ = _inputs(40, seed=2)
    a = [torch.from_numpy(x).double().requires_grad_() for x in ins]
    b = [torch.from_numpy(x).requires_grad_() for x in ins]
    ya, ha = ssd_chunked(*a, chunk=Q)
    yb, hb = _kernel_route(*b, chunk=Q)
    ((ya * torch.from_numpy(dy).double()).sum() if used == "y" else ha.sum()).backward()
    ((yb * torch.from_numpy(dy)).sum() if used == "y" else hb.sum()).backward()
    for x, z in zip(a, b):          # h does not read C: autograd leaves its grad None
        want = torch.zeros_like(x) if x.grad is None else x.grad
        np.testing.assert_allclose(z.grad.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_ref_forward_is_ssd_chunked_in_the_kernel_layout():
    ins, _, _ = _inputs(72, seed=3)
    xh, Bm, Cm, dt, A = (torch.from_numpy(a) for a in ins)
    y, h = ssd_chunked(xh, Bm, Cm, dt, A, chunk=Q)
    yk, hk = ssd_scan_ref(*_kernel_layout(xh, Bm, Cm, dt, A), chunk=Q)
    torch.testing.assert_close(yk[:, :, :72].permute(0, 2, 1, 3), y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(hk, h, atol=1e-6, rtol=1e-6)


def test_bwd_kernel_wrapper_refuses_what_it_does_not_take():
    """Without a card the backward entry never runs: a CPU tensor is
    refused (no silent fallback), as are a dtype, a shape or a chunk it
    does not take, before any library is built."""
    B, nh, S, hd, N = 1, 2, 32, 8, 4
    xdt = torch.zeros(B, nh, S, hd)
    g = torch.zeros(B, nh, S)
    Bm = torch.zeros(B, S, N)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan_bwd_kernel(xdt, g, Bm, Bm, xdt.double(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_bwd_kernel(xdt, g, Bm, Bm, xdt.transpose(2, 3), chunk=16)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_scan_bwd_kernel(xdt, g[:, :1], Bm, Bm, xdt, chunk=16)
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(B, S, 257)
        ssd_scan_bwd_kernel(xdt, g, big, big, xdt, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_bwd_kernel(xdt, g, Bm, Bm, xdt, chunk=24)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd_kernel(xdt, g, Bm, Bm, xdt, torch.zeros(B, nh, hd, N), chunk=16)
