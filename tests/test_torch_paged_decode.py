"""The port's paged decode (CPU route: its plain version) against
``repro``'s scalar-prefetch Pallas kernel in interpret mode and its jnp
oracle: ragged lengths, an exhaustive length scan, dead slots (exact
zeros), a permuted pool, MHA/GQA/MQA; f32 at 1e-5, bf16 at 2e-2."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention import paged_decode as j_paged_decode  # noqa: E402
from repro.kernels.flash_attention import paged_decode_ref as j_paged_decode_ref  # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.flash_attention import (paged_decode,  # noqa: E402
                                                 paged_decode_kernel,
                                                 paged_decode_ref)


def _case(B, KH, G, D, PS, MP, lengths, seed=0, permute=True):
    """Pool with each slot's live pages scattered (optionally shuffled)
    over [1, NP); table entries past the live prefix are the null page."""
    rng = np.random.default_rng(seed)
    NP = B * MP + 1
    q = rng.normal(size=(B, 1, KH * G, D)).astype(np.float32)
    kp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    vp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    pages = (rng.permutation(NP - 1) + 1) if permute else np.arange(1, NP)
    bt = np.zeros((B, MP), np.int32)
    for b, n in enumerate(lengths):
        npg = -(-int(n) // PS)
        bt[b, :npg] = pages[b * MP:b * MP + npg]
    return q, kp, vp, np.asarray(lengths, np.int32), bt


def _port(q, kp, vp, lens, bt, dtype=torch.float32):
    t = [torch.from_numpy(x) for x in (q, kp, vp)]
    return paged_decode(*(x.to(dtype) for x in t), torch.from_numpy(lens),
                        torch.from_numpy(bt))


@pytest.mark.parametrize("KH,G,D", [(2, 1, 16), (2, 2, 16), (1, 4, 32)],
                         ids=["mha", "gqa", "mqa"])
def test_matches_repro_interpret_kernel(KH, G, D):
    PS, MP = 8, 4
    lengths = [0, 1, PS, PS + 1, MP * PS, 13]
    q, kp, vp, lens, bt = _case(len(lengths), KH, G, D, PS, MP, lengths)
    backend.reset_launch_counts()
    o = _port(q, kp, vp, lens, bt)
    assert backend.LAUNCH_COUNTS.get("paged_decode", 0) == 0      # CPU: no launch
    jo = j_paged_decode(*(jnp.asarray(x) for x in (q, kp, vp, lens, bt)),
                        interpret=True)
    assert tuple(o.shape) == q.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    assert (o[0] == 0).all()                   # dead slot: exact zeros, no NaN


def test_exhaustive_length_scan():
    PS, MP, KH, G, D = 4, 3, 2, 2, 8
    lengths = list(range(MP * PS + 1))
    q, kp, vp, lens, bt = _case(len(lengths), KH, G, D, PS, MP, lengths, seed=3)
    o = _port(q, kp, vp, lens, bt)
    qt = q[:, 0].reshape(len(lengths), KH, G, D)
    jo = j_paged_decode_ref(*(jnp.asarray(x) for x in (qt, kp, vp, lens, bt)))
    np.testing.assert_allclose(o.numpy().reshape(jo.shape), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)
    assert np.isfinite(o.numpy()).all() and (o[0] == 0).all()


def test_pool_layout_does_not_matter():
    """The same logical KV through a shuffled pool gives the same output."""
    PS, MP = 8, 3
    lengths = [5, 17, 24]
    q, kp, vp, lens, bt = _case(3, 2, 2, 16, PS, MP, lengths, permute=False)
    perm = np.random.default_rng(5).permutation(kp.shape[1] - 1) + 1
    inv = np.zeros(kp.shape[1], np.int64)
    inv[perm] = np.arange(1, kp.shape[1])
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[:, inv[1:]], vp2[:, inv[1:]] = kp[:, 1:], vp[:, 1:]
    bt2 = np.where(bt > 0, inv[bt], 0).astype(np.int32)
    np.testing.assert_allclose(_port(q, kp2, vp2, lens, bt2).numpy(),
                               _port(q, kp, vp, lens, bt).numpy(), atol=1e-6)


def test_bf16_matches_repro_interpret_kernel():
    PS, MP = 8, 4
    lengths = [0, 3, 9, 32]
    q, kp, vp, lens, bt = _case(4, 2, 2, 16, PS, MP, lengths, seed=1)
    o = _port(q, kp, vp, lens, bt, torch.bfloat16)
    assert o.dtype == torch.bfloat16
    jo = j_paged_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
                        jnp.asarray(lens), jnp.asarray(bt), interpret=True)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_plain_version_is_the_cpu_route_and_kernel_refuses_cpu():
    q, kp, vp, lens, bt = _case(2, 2, 1, 8, 4, 2, [3, 0])
    qt = torch.from_numpy(q[:, 0].reshape(2, 2, 1, 8))
    args = (torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(lens),
            torch.from_numpy(bt))
    np.testing.assert_array_equal(_port(q, kp, vp, lens, bt).numpy().reshape(qt.shape),
                                  paged_decode_ref(qt, *args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_kernel(qt, *args)
