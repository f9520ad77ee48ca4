"""The arithmetic of the flash-attention kernel (``csrc/flash_attention.cu``),
emulated in torch on the CPU in the kernel's order, at GPT-2-S's head
shape (D 64) with S 64 and S 1024.

The kernel walks 64-key tiles with an online softmax in base 2: Q is
scaled once by D^-0.5 * log2(e) (rounded in f32) and split into
big = rna(q) and small = rna(q - big) (TF32, as ``tests/test_torch_tf32x3.py``
holds); each tile's scores are the three TF32 products small*big +
big*small + big*big of Q and K; p = 2^(s - m); each tile's P V (P split
the same way) goes into a zeroed fragment and joins the output as
acc * alpha + tile; a walk of 4 tiles or more in a small grid is shared
by two warp groups (even and odd tiles) whose (m, l, O) join at the end.  Held here:
that order lies within the f32 attention tolerance of the plain
``flash_attention_ref`` and about as close to an f64 oracle as that plain
f32 path; one TF32 pass does not; bf16 Q, K and V are exact in TF32, so
the kernel takes them whole.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref
from test_torch_tf32x3 import split3, tf32_rna

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)   # chip_smoke.py's ATTN_TOL for f32
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # ... and for bf16
LOG2E = 1.4426950408889634              # LOG2E in csrc/flash_attention.cu
NEG_INF = -1e30
BK = 64                                 # keys per KV tile
LONG_WALK = 4                           # KV tiles from which two warp groups share a walk
H, D = 2, 64                            # two heads of GPT-2-S's width


def qkv(S, seed=0):
    """q, k, v ~ N(0, 1) in the model layout (1, S, H, D), as phase 4 draws
    them."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((1, S, H, D)).astype(np.float32))
                 for _ in range(3))


def product(a, b, passes):
    """a @ b on the TF32 tensor cores: 3 (small*big + big*small + big*big,
    one f32 sum), 2 (b exact in TF32: small*b + big*b) or 1 pass."""
    if passes == 3:
        ab, as_ = split3(a)
        bb, bs = split3(b)
        return torch.cat([as_, ab, ab], -1) @ torch.cat([bb, bs, bb], -2)
    if passes == 2:
        ab, as_ = split3(a)
        return torch.cat([as_, ab], -1) @ torch.cat([b, b], -2)
    return tf32_rna(a) @ tf32_rna(b)


def emulate(q, k, v, passes=3):
    """The kernel's causal forward (Sq == Sk) on (1, S, H, D) f32 inputs:
    f32 Q, K and V take ``passes`` TF32 passes per product; bf16 inputs
    (``passes=None``) are taken whole, the scale goes on the scores and
    P V takes two passes (P split, V exact).  Walks of ``LONG_WALK`` tiles
    or more go to two warp groups (even and odd tiles), whose states
    join at the end, as the kernel does while its grid has fewer blocks
    than two per SM (here: two heads, one batch)."""
    bf16 = passes is None
    qh, kh, vh = (t[0].transpose(0, 1).float() for t in (q, k, v))     # (H, S, D)
    S = qh.shape[1]
    c = (torch.tensor(D ** -0.5, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))                   # qscale, in f32
    if not bf16:
        qh = qh * c
    pos = torch.arange(S)
    n_tiles = -(-S // BK)
    groups = 2 if n_tiles >= LONG_WALK else 1
    states = []
    for g in range(groups):
        m = torch.full((H, S, 1), NEG_INF)
        l = torch.zeros(H, S, 1)
        o = torch.zeros(H, S, D)
        for k0 in range(g * BK, S, groups * BK):
            kt, vt = kh[:, k0:k0 + BK], vh[:, k0:k0 + BK]
            if bf16:
                s = (qh @ kt.transpose(1, 2)) * c       # products exact in f32
            else:
                s = product(qh, kt.transpose(1, 2), passes)
            keys = k0 + torch.arange(kt.shape[1])
            s = torch.where(keys[None, :] <= pos[:, None], s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_use = torch.where(m_new == NEG_INF, torch.zeros(()), m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(s - m_use)
            l = l * alpha + p.sum(-1, keepdim=True)
            tile = product(p, vt, 2 if bf16 else passes)          # a zeroed fragment
            o = o * alpha + tile
            m = m_new
        states.append((m, l, o))
    m, l, o = states[0]
    if groups == 2:
        m1, l1, o1 = states[1]
        m_new = torch.maximum(m, m1)
        m_use = torch.where(m_new == NEG_INF, torch.zeros(()), m_new)
        a0, a1 = torch.exp2(m - m_use), torch.exp2(m1 - m_use)
        l = l * a0 + l1 * a1
        o = o * a0 + o1 * a1
    return (o / l.clamp_min(1e-30)).transpose(0, 1)[None]    # (1, S, H, D)


def oracle(q, k, v):
    """Causal attention in f64."""
    q, k, v = (t.double() for t in (q, k, v))
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("S", [64, 1024])
def test_three_pass_tiles_lie_within_the_f32_tolerance_of_the_plain_path(S):
    q, k, v = qkv(S)
    torch.testing.assert_close(emulate(q, k, v), flash_attention_ref(q, k, v), **ATTN_TOL)


@pytest.mark.parametrize("S", [64, 1024])
def test_three_pass_tiles_are_as_close_to_f64_as_the_plain_f32_path(S):
    q, k, v = qkv(S)
    exact = oracle(q, k, v)
    d_kernel = (emulate(q, k, v).double() - exact).abs().max().item()
    d_plain = (flash_attention_ref(q, k, v).double() - exact).abs().max().item()
    assert d_kernel <= 2 * d_plain, (d_kernel, d_plain)


@pytest.mark.parametrize("S", [64, 1024])
def test_single_pass_tf32_misses_the_f32_tolerance(S):
    q, k, v = qkv(S)
    one = emulate(q, k, v, passes=1)
    assert not torch.allclose(one, flash_attention_ref(q, k, v), **ATTN_TOL)


def test_bf16_q_k_v_are_exact_in_tf32():
    for t in qkv(256, seed=1):
        x = t.to(torch.bfloat16).float()
        big, small = split3(x)
        assert torch.equal(big, x) and not bool(small.any())


@pytest.mark.parametrize("S", [64, 1024])
def test_bf16_inputs_taken_whole_lie_within_the_bf16_tolerance(S):
    q, k, v = (t.to(torch.bfloat16) for t in qkv(S, seed=2))
    got = emulate(q, k, v, passes=None).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v).float(), **BF16_TOL)
