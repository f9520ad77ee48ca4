"""The port's causal flash-attention op (CPU route: ``flash_attention_ref``)
against ``repro``'s ``flash_attention`` with the Pallas kernel in
interpret mode, on the sweep of ``test_kernels.py`` and the same numpy
inputs.  f32 tolerance 2e-5 (``repro``'s TOLS)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash_attention  # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.models.attention import naive_attention, online_attention  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
SWEEP = [(2, 64, 64, 4, 2, 32, 0),
         (1, 64, 128, 4, 1, 64, 0),
         (2, 64, 64, 8, 8, 32, 24),
         (1, 40, 72, 2, 1, 16, 0),
         (1, 128, 128, 4, 2, 128, 33)]


def _qkv(B, Sq, Sk, H, KH, D, seed=0):
    rng = np.random.default_rng(seed + Sq + Sk)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,win", SWEEP)
def test_matches_repro_interpret_kernel(B, Sq, Sk, H, KH, D, win):
    q, k, v = _qkv(B, Sq, Sk, H, KH, D)
    backend.reset_launch_counts()
    o = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), window=win)
    assert backend.LAUNCH_COUNTS == {}                      # CPU: no launch
    jo = j_flash_attention(*(jnp.asarray(t) for t in (q, k, v)), window=win,
                           bq=32, bk=32, interpret=True)
    assert tuple(o.shape) == (B, Sq, H, D) and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,win", SWEEP[:3])
def test_plain_version_agrees_with_the_models_attention(B, Sq, Sk, H, KH, D, win):
    """The op's plain version, the naive and the chunked online-softmax
    training attention compute one function (q at the sequence end)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(B, Sq, Sk, H, KH, D))
    o = flash_attention_ref(q, k, v, window=win)
    q_pos = torch.arange(Sk - Sq, Sk)
    k_pos = torch.arange(Sk)
    torch.testing.assert_close(naive_attention(q, k, v, q_pos, k_pos, win), o, **TOL)
    torch.testing.assert_close(
        online_attention(q, k, v, q_pos, k_pos, window=win, kv_chunk=16), o, **TOL)


def test_bf16_plain_version_tracks_f32():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 40, 72, 2, 1, 16))
    o32 = flash_attention(q, k, v)
    o16 = flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16.float(), o32, atol=2e-2, rtol=2e-2)


def test_row_that_sees_no_key_is_zero():
    """A window smaller than the gap past the last key masks whole rows;
    they come back as zeros (l floored at 1e-30), as in the kernel."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 8, 4, 2, 2, 8))
    o = flash_attention(q, k, v, window=2)       # Sq > Sk: q_offset 0
    assert torch.isfinite(o).all()
    assert (o[0, 5:] == 0).all() and (o[0, :5].abs().sum(-1) > 0).all()


def test_forward_only_and_no_silent_route():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 8, 8, 2, 1, 8))
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q.detach(), k, v)
