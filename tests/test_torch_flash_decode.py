"""The port's flash decode and the int8-KV decode pair (CPU route: their
plain versions) against ``repro``'s Pallas kernels in interpret mode:
ragged lengths, windows, MHA/GQA/MQA, every length 0..L+1 (a finished
slab slot passes L + 1, which reads the whole cache), dead slots (exact
zeros), q of rank 3 and 4, int8 slab caches and pools; f32 at atol 1e-5,
bf16 at 3e-2 (``repro``'s own decode tolerance).  The partial-softmax
entry over the tp pieces of a cache cut by its length, joined by
``sharding.tp.lse_combine``'s formula, against ``repro``'s kernel on the
whole cache.  The launchers refuse CPU tensors and the ops refuse
unpaired or misplaced scales."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention import flash_decode as j_flash_decode  # noqa: E402
from repro.kernels.flash_attention import paged_decode as j_paged_decode  # noqa: E402

from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.flash_attention import (flash_decode,  # noqa: E402
                                                 flash_decode_kernel,
                                                 flash_decode_partial,
                                                 flash_decode_partial_kernel,
                                                 flash_decode_q8_kernel,
                                                 flash_decode_ref, paged_decode,
                                                 paged_decode_q8_kernel)
from repro_torch.precision import quantize_kv_int8          # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, H, KH, L, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, L, KH, D)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("B,H,KH,L,D,bk,win", [
    (2, 4, 2, 64, 32, 32, 0),     # GQA, block-aligned
    (3, 4, 1, 40, 16, 16, 0),     # MQA, L not a multiple of the tile
    (2, 8, 8, 72, 32, 32, 0),     # MHA, ragged L
    (2, 4, 2, 64, 32, 32, 24),    # sliding window
    (3, 2, 1, 33, 16, 64, 5),     # window, one clipped tile
], ids=["gqa", "mqa", "mha", "window", "window-clipped"])
def test_matches_repro_interpret_kernel(B, H, KH, L, D, bk, win):
    q, k, v = _inputs(B, H, KH, L, D, seed=B + L)
    lengths = np.linspace(1, L, B).round().astype(np.int32)
    backend.reset_launch_counts()
    o = flash_decode(*_t(q, k, v, lengths), window=win)
    assert backend.LAUNCH_COUNTS.get("flash_decode", 0) == 0      # CPU: no launch
    jo = j_flash_decode(*(jnp.asarray(x) for x in (q, k, v, lengths)), window=win,
                        bk=bk, interpret=True)
    assert tuple(o.shape) == q.shape and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)


def test_bf16_matches_repro_interpret_kernel():
    B, H, KH, L, D = 3, 4, 2, 48, 16
    q, k, v = _inputs(B, H, KH, L, D, seed=4)
    lengths = np.array([5, 31, 48], np.int32)
    o = flash_decode(*(t.to(torch.bfloat16) for t in _t(q, k, v)),
                     torch.from_numpy(lengths))
    assert o.dtype == torch.bfloat16
    jo = j_flash_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                        jnp.asarray(lengths), bk=16, interpret=True)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("win", [0, 3], ids=["full", "window"])
def test_every_length_up_to_one_past_the_cache(win):
    """One slot per length 0..L+1: length 0 gives exact zeros, and L + 1 —
    a finished slab slot decoding on at position L — reads all L entries,
    as repro's grid does when its tile divides L (as in the engine; with a
    padded L, repro's kernel reads one zero pad entry at L + 1 where its
    own oracle does not, so the tile here divides L)."""
    H, KH, L, D = 2, 1, 20, 8
    lengths = np.arange(L + 2, dtype=np.int32)
    B = len(lengths)
    q, k, v = _inputs(B, H, KH, L, D, seed=7)
    o = flash_decode(*_t(q, k, v, lengths), window=win)
    jo = j_flash_decode(*(jnp.asarray(x) for x in (q, k, v, lengths)), window=win,
                        bk=4, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    jr = j_flash_decode(*(jnp.asarray(x) for x in (q, k, v, lengths)), window=win,
                        use_kernel=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(jr), **F32)
    assert np.isfinite(o.numpy()).all()
    assert (o[0] == 0).all()                    # dead slot: exact zeros, no NaN
    if not win:
        # L + 1 is L: the whole cache, nothing past it
        same = flash_decode(*_t(q[-1:], k[-1:], v[-1:], np.array([L], np.int32)))
        np.testing.assert_array_equal(o[-1:].numpy(), same.numpy())


def test_q_of_rank_three_and_four_agree():
    B, H, KH, L, D = 2, 4, 2, 16, 8
    q, k, v = _inputs(B, H, KH, L, D, seed=2)
    lengths = np.array([3, 16], np.int32)
    o3 = flash_decode(*_t(q, k, v, lengths))
    o4 = flash_decode(*_t(q[:, None], k, v, lengths))
    assert tuple(o4.shape) == (B, 1, H, D)
    np.testing.assert_array_equal(o4[:, 0].numpy(), o3.numpy())
    # the plain version in the kernel layout is what the op routes to on CPU
    ref = flash_decode_ref(torch.from_numpy(q).reshape(B, KH, H // KH, D),
                           *(torch.from_numpy(x).transpose(1, 2) for x in (k, v)),
                           torch.from_numpy(lengths))
    np.testing.assert_array_equal(o3.numpy(), ref.reshape(B, H, D).numpy())


def _lse_join(parts):
    """``sharding.tp.lse_combine``'s formula over the pieces' (m, l, o),
    in one process: rescale to the common max, sum, divide."""
    M = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - M) for p in parts]
    l = sum(wi * p[1] for wi, p in zip(w, parts))
    o = sum(wi[..., None] * p[2] for wi, p in zip(w, parts))
    return o / l[..., None]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("H,KH", [(4, 2), (8, 1)], ids=["gqa", "mqa"])
def test_partial_pieces_joined_match_repro_on_the_whole_cache(tp, H, KH):
    """The cache cut into tp pieces of L / tp positions; each piece's live
    prefix clamp(length - r * Lc, 0, Lc) (empty pieces past the length, a
    length of L + 1 reading every piece whole); the joined partials
    against repro's kernel (interpret mode) on the whole cache."""
    B, L, D = 6, 32, 16
    q, k, v = _inputs(B, H, KH, L, D, seed=40 + tp + KH)
    lengths = np.array([1, 3, L // 2, L // 2 + 1, L, L + 1], np.int32)
    qt, kt, vt, lt = _t(q, k, v, lengths)
    Lc = L // tp
    backend.reset_launch_counts()
    parts = [flash_decode_partial(qt, kt[:, r * Lc:(r + 1) * Lc], vt[:, r * Lc:(r + 1) * Lc],
                                  (lt - r * Lc).clamp(0, Lc).int()) for r in range(tp)]
    assert not backend.LAUNCH_COUNTS                           # CPU: no launch
    m, l, o = parts[-1]
    assert tuple(m.shape) == tuple(l.shape) == (B, H) and tuple(o.shape) == (B, H, D)
    dead = (lt <= (tp - 1) * Lc)[:, None]                      # the last piece is empty
    assert bool(dead.any())
    assert bool(((m == -1e30) == dead).all()) and bool((l[dead[:, 0]] == 0).all())
    assert bool((o[dead[:, 0]] == 0).all())
    jo = j_flash_decode(*(jnp.asarray(x) for x in (q, k, v, lengths)), bk=8, interpret=True)
    np.testing.assert_allclose(_lse_join(parts).numpy(), np.asarray(jo), **F32)


def test_partial_of_the_whole_cache_is_flash_decode_unnormalised():
    """One piece: o / l is flash_decode's output, q of rank 4 keeps its
    singleton axis, a dead slot gives (-1e30, 0, 0) exactly."""
    B, H, KH, L, D = 3, 4, 2, 24, 8
    q, k, v = _inputs(B, H, KH, L, D, seed=9)
    lengths = np.array([0, 7, L + 1], np.int32)
    m, l, o = flash_decode_partial(*_t(q[:, None], k, v, lengths))
    assert tuple(m.shape) == (B, 1, H) and tuple(o.shape) == (B, 1, H, D)
    assert bool((m[0] == -1e30).all()) and bool((l[0] == 0).all()) and bool((o[0] == 0).all())
    want = flash_decode(*_t(q, k, v, lengths))
    np.testing.assert_allclose((o[1:, 0] / l[1:, 0, :, None]).numpy(), want[1:].numpy(), **F32)


@pytest.mark.parametrize("B,H,KH,L,D,bk,win", [(2, 4, 2, 64, 32, 32, 0),
                                                (3, 4, 1, 40, 16, 16, 0),
                                                (2, 4, 2, 48, 12, 16, 9)],
                         ids=["gqa", "mqa", "ragged-d-window"])
def test_q8_slab_matches_repro_interpret_kernel(B, H, KH, L, D, bk, win):
    q, k, v = _inputs(B, H, KH, L, D, seed=11 + L)
    kq, ks = quantize_kv_int8(torch.from_numpy(k), head_axis=2)
    vq, vs = quantize_kv_int8(torch.from_numpy(v), head_axis=2)
    lengths = np.linspace(1, L, B).round().astype(np.int32)
    backend.reset_launch_counts()
    o = flash_decode(torch.from_numpy(q), kq, vq, torch.from_numpy(lengths), window=win,
                     k_scale=ks, v_scale=vs)
    assert backend.LAUNCH_COUNTS.get("flash_decode_q8", 0) == 0
    jo = j_flash_decode(*(jnp.asarray(x) for x in (q, kq.numpy(), vq.numpy(), lengths)),
                        window=win, k_scale=jnp.asarray(ks.numpy()),
                        v_scale=jnp.asarray(vs.numpy()), bk=bk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    # and the int8 cache stays close to the f32 attention (repro's bound)
    of = flash_decode(*_t(q, k, v, lengths), window=win)
    assert float((o - of).abs().max()) < 0.1


def test_q8_paged_matches_repro_interpret_kernel():
    B, H, KH, MP, PS, D, bk = 3, 4, 2, 3, 16, 32, 8
    NP = B * MP + 3
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    vp = rng.normal(size=(KH, NP, PS, D)).astype(np.float32)
    bt = (rng.permutation(NP - 1)[:B * MP] + 1).reshape(B, MP).astype(np.int32)
    kq, ks = quantize_kv_int8(torch.from_numpy(kp), head_axis=0)
    vq, vs = quantize_kv_int8(torch.from_numpy(vp), head_axis=0)
    lengths = np.array([0, 17, MP * PS], np.int32)
    backend.reset_launch_counts()
    o = paged_decode(torch.from_numpy(q), kq, vq, torch.from_numpy(lengths),
                     torch.from_numpy(bt), k_scale=ks, v_scale=vs)
    assert backend.LAUNCH_COUNTS.get("paged_decode_q8", 0) == 0
    jo = j_paged_decode(jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                        jnp.asarray(lengths), jnp.asarray(bt),
                        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
                        bk=bk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    assert (o[0] == 0).all()
    of = paged_decode(*_t(q, kp, vp, lengths, bt))
    assert float((o - of).abs().max()) < 0.1


def test_launchers_refuse_cpu_tensors_and_ops_refuse_bad_scales():
    B, H, KH, L, D = 2, 4, 2, 8, 8
    q, k, v = _t(*_inputs(B, H, KH, L, D))
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    qt = q.reshape(B, KH, H // KH, D)
    kq, ks = quantize_kv_int8(k, head_axis=2)
    vq, vs = quantize_kv_int8(v, head_axis=2)
    pool = torch.zeros(KH, 3, 4, D, dtype=torch.int8)
    bt = torch.ones(B, 2, dtype=torch.int32)
    for call in (lambda: flash_decode_kernel(qt, k, v, lengths),
                 lambda: flash_decode_partial_kernel(qt, k, v, lengths),
                 lambda: flash_decode_q8_kernel(qt, kq, vq, lengths, ks, vs),
                 lambda: paged_decode_q8_kernel(qt, pool, pool, lengths, bt, ks, vs)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="together"):
        flash_decode(q, kq, vq, lengths, k_scale=ks)
    with pytest.raises(ValueError, match="together"):
        paged_decode(q, pool, pool, lengths, bt, v_scale=vs)
    with pytest.raises(TypeError, match="int8 K/V need"):
        flash_decode(q, kq, vq, lengths)
    with pytest.raises(TypeError, match="int8 K/V need"):
        paged_decode(q, pool, pool, lengths, bt)
    with pytest.raises(TypeError, match="belong to an int8"):
        flash_decode(q, k, v, lengths, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="one scale per KV head"):
        flash_decode(q, kq, vq, lengths, k_scale=ks[:1], v_scale=vs)
    with pytest.raises(ValueError, match="one scale per KV head"):
        paged_decode(q, pool, pool, lengths, bt, k_scale=ks, v_scale=vs.double())
