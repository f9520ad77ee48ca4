"""The port's fused LoRA matmul (CPU route: its plain version) against
``repro``'s Pallas kernel in interpret mode and its jnp oracle, on the
same numpy inputs.  f32 tolerance 1e-5: both sides accumulate in f32 and
differ only in summation order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul      # noqa: E402
from repro.kernels.lora_matmul import lora_matmul_ref as j_lora_matmul_ref  # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.lora_matmul import (lora_matmul,  # noqa: E402
                                             lora_matmul_kernel, lora_matmul_ref)

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [
    ((8,), 64, 48, 4),          # decode-like: M = slots
    ((2, 3), 40, 24, 1),        # leading batch dims
    ((5,), 100, 70, 8),         # ragged M/K/N
    ((1, 16), 33, 17, 4),       # chunk-like: (1, C, d), ragged K/N
    ((3,), 128, 130, 8),        # N just past a tile
]


def _inputs(lead, K, N, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (K,)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    a = (rng.normal(size=(r, K)) * r ** -0.5).astype(np.float32)
    b = (rng.normal(size=(N, r)) * 0.1).astype(np.float32)
    return x, w, a, b


@pytest.mark.parametrize("lead,K,N,r", CASES)
def test_matches_repro_interpret_kernel_and_oracle(lead, K, N, r):
    x, w, a, b = _inputs(lead, K, N, r)
    backend.reset_launch_counts()
    y = lora_matmul(*(torch.from_numpy(t) for t in (x, w, a, b)), scale=2.0)
    assert backend.LAUNCH_COUNTS.get("lora_matmul", 0) == 0   # CPU: no launch
    assert tuple(y.shape) == lead + (N,) and y.dtype == torch.float32
    jy = j_lora_matmul(*(jnp.asarray(t) for t in (x, w, a, b)), scale=2.0,
                       interpret=True, use_kernel=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    jref = j_lora_matmul_ref(x.reshape(-1, K), w, a, b, 2.0)
    np.testing.assert_allclose(y.numpy().reshape(-1, N), np.asarray(jref), **TOL)


@pytest.mark.parametrize("r", [1, 4, 8])
def test_ranks_match_oracle(r):
    x, w, a, b = _inputs((6,), 48, 40, r, seed=r)
    y = lora_matmul_ref(*(torch.from_numpy(t) for t in (x, w, a, b)), 0.5)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_lora_matmul_ref(x, w, a, b, 0.5)),
                               **TOL)


def test_bf16_plain_version_matches_oracle():
    x, w, a, b = _inputs((4,), 64, 32, 4)
    tt = [torch.from_numpy(t).to(torch.bfloat16) for t in (x, w, a, b)]
    y = lora_matmul(*tt, scale=2.0)
    assert y.dtype == torch.bfloat16
    jy = j_lora_matmul_ref(*(jnp.asarray(t, jnp.bfloat16) for t in (x, w, a, b)), 2.0)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_requires_grad_inputs_raise():
    """Inputs that require grad no longer raise: the op is differentiable
    (``_FusedLoraMatmul``) and its gradient matches autograd of the plain
    version."""
    x, w, a, b = (torch.from_numpy(t) for t in _inputs((4,), 16, 8, 2))
    a = a.requires_grad_()
    y = lora_matmul(x, w, a, b, scale=2.0)
    assert y.requires_grad
    (ga,) = torch.autograd.grad(y.sum(), a)
    a_ref = a.detach().clone().requires_grad_()
    (ga_ref,) = torch.autograd.grad(lora_matmul_ref(x, w, a_ref, b, 2.0).sum(), a_ref)
    torch.testing.assert_close(ga, ga_ref, **TOL)


def test_kernel_entry_refuses_what_it_cannot_launch():
    """The CUDA entry never takes a CPU tensor: no silent route."""
    x, w, a, b = (torch.from_numpy(t) for t in _inputs((4,), 16, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        lora_matmul_kernel(x, w, a, b, 1.0)
