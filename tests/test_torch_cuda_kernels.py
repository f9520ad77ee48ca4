"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor ``repro``, so it also runs on a machine
with the card and no JAX (``--noconftest`` skips the JAX fixtures of
tests/conftest.py):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                    # noqa: E402
from repro_torch.kernels import backend                     # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_ref, flash_decode,
                                                 flash_decode_kernel,
                                                 flash_decode_partial_kernel,
                                                 flash_decode_partial_ref,
                                                 flash_decode_q8_kernel,
                                                 flash_decode_q8_ref, flash_decode_ref,
                                                 paged_decode, paged_decode_kernel,
                                                 paged_decode_q8_kernel,
                                                 paged_decode_q8_ref, paged_decode_ref)
from repro_torch.kernels.lora_matmul import (lora_matmul,   # noqa: E402
                                             lora_matmul_dx_kernel,
                                             lora_matmul_gather_kernel,
                                             lora_matmul_gathered,
                                             lora_matmul_gathered_ref,
                                             lora_matmul_dx_ref, lora_matmul_kernel,
                                             lora_matmul_q8_dx_kernel,
                                             lora_matmul_q8_dx_ref, lora_matmul_q8_kernel,
                                             lora_matmul_q8_ref, lora_matmul_ref,
                                             lora_rank_reduce_kernel,
                                             lora_rank_reduce_ref)
from repro_torch.kernels.lora_matmul.plan import DECODE_MAX_M  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan_bwd_kernel,  # noqa: E402
                                          ssd_scan_bwd_ref, ssd_scan_kernel,
                                          ssd_scan_with_state, ssd_sequential_ref)
from repro_torch.models import init_lora_stack, init_params  # noqa: E402
from repro_torch.precision import (quantize_kv_int8, quantize_params_int8,  # noqa: E402
                                   quantize_weight_int8)
from repro_torch.serving import (AdapterRegistry, Request,  # noqa: E402
                                 ServingEngine)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# gradients in bf16: repro's GRAD_TOLS
GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-1, rtol=5e-2)}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", [(8, 768, 768, 4), (16, 768, 768, 4),
                                     (5, 100, 70, 3), (33, 300, 129, 64), (1, 7, 1, 1),
                                     # both sides of the decode threshold T = 16, the
                                     # training M, Mamba2's projections at decode and
                                     # prefill M
                                     (17, 768, 768, 4), (768, 768, 768, 4),
                                     (8, 2560, 10576, 4), (8, 5120, 2560, 4),
                                     (200, 2560, 10576, 4), (200, 5120, 2560, 4)])
def test_lora_matmul_kernel_matches_plain(cuda, dtype, M, K, N, r):
    g = torch.Generator().manual_seed(M * 1000 + r)
    x = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda, dtype)
    a = (torch.randn(r, K, generator=g) * r ** -0.5).to(cuda, dtype)
    b = (torch.randn(N, r, generator=g) * 0.05).to(cuda, dtype)
    before = backend.LAUNCH_COUNTS.get("lora_matmul", 0)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["lora_matmul"] == before + 1
    torch.testing.assert_close(y.float(), lora_matmul_ref(x, w, a, b, 2.0).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,PS,MP", [(8, 12, 1, 64, 16, 32), (4, 2, 4, 128, 16, 8),
                                            (5, 1, 8, 64, 8, 6), (3, 2, 3, 40, 5, 4)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, B, KH, G, D, PS, MP):
    g = torch.Generator().manual_seed(B * 100 + D)
    NP = B * MP + 1
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    kp = torch.randn(KH, NP, PS, D, generator=g).to(cuda, dtype)
    vp = torch.randn(KH, NP, PS, D, generator=g).to(cuda, dtype)
    lengths = [0, 1, PS, PS + 1, MP * PS, 2 * PS - 1, 3, PS * MP - 1][:B]
    pages = torch.randperm(NP - 1, generator=g) + 1
    bt = torch.zeros(B, MP, dtype=torch.int32)
    for i, n in enumerate(lengths):
        npg = -(-n // PS)
        bt[i, :npg] = pages[i * MP:i * MP + npg].int()
    lens, bt = torch.tensor(lengths, dtype=torch.int32, device=cuda), bt.to(cuda)
    o = paged_decode_kernel(q, kp, vp, lens, bt)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), paged_decode_ref(q, kp, vp, lens, bt).float(),
                               atol=tol, rtol=tol)
    assert (o[0] == 0).all()                          # dead slot: exact zeros


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 16, device=cuda)
    w, a, b = torch.randn(16, 8, device=cuda), torch.randn(2, 16, device=cuda), \
        torch.randn(8, 2, device=cuda)
    with pytest.raises(TypeError):
        lora_matmul_kernel(x, w.double(), a, b, 1.0)
    with pytest.raises(ValueError):
        lora_matmul_kernel(x, w.T.contiguous().T, a, b, 1.0)           # not contiguous
    with pytest.raises(ValueError):
        lora_matmul_kernel(x, w, torch.randn(65, 16, device=cuda),
                           torch.randn(8, 65, device=cuda), 1.0)       # rank > 64
    q = torch.randn(2, 1, 4, 8, device=cuda)
    pool = torch.zeros(2, 3, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        paged_decode(q, pool, pool, torch.ones(2, dtype=torch.int64, device=cuda),
                     torch.zeros(2, 2, dtype=torch.int32, device=cuda))


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    cfg = get_arch("gpt2-s").reduced(num_layers=2, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, lora=lora, max_slots=3, max_len=48,
                            page_size=8, device=dev)
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 3 * i)), max_new_tokens=6)
                for i in range(5)]
        for r in reqs:
            eng.submit(r)
        backend.reset_launch_counts()
        eng.run()
        if dev == "cuda":
            assert backend.LAUNCH_COUNTS["lora_matmul"] > 0
            assert backend.LAUNCH_COUNTS["paged_decode"] > 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", [(256, 768, 768, 4), (768, 768, 768, 4),
                                     (33, 70, 45, 2), (1, 7, 1, 1), (70, 130, 300, 64),
                                     (16, 768, 768, 4), (17, 768, 768, 4),
                                     (8, 2560, 10576, 4), (200, 5120, 2560, 4)])
def test_lora_matmul_dx_kernel_matches_plain(cuda, dtype, M, K, N, r):
    g = torch.Generator().manual_seed(M + K + r)
    dy = torch.randn(M, N, generator=g).to(cuda, dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda, dtype)
    a = (torch.randn(r, K, generator=g) * r ** -0.5).to(cuda, dtype)
    b = (torch.randn(N, r, generator=g) * 0.05).to(cuda, dtype)
    before = backend.LAUNCH_COUNTS.get("lora_matmul_dx", 0)
    dx = lora_matmul_dx_kernel(dy, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["lora_matmul_dx"] == before + 1
    assert dx.dtype == dtype and tuple(dx.shape) == (M, K)
    tol = TOL[dtype]
    torch.testing.assert_close(dx.float(), lora_matmul_dx_ref(dy, w, a, b, 2.0).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,r,N", [(768, 4, 768), (33, 2, 45), (1, 1, 7), (5000, 64, 70),
                                   # padded ranks, N not a multiple of 4 or 8 (element
                                   # loads), M not a multiple of the split
                                   (256, 4, 768), (768, 8, 768), (771, 3, 770),
                                   (1000, 16, 1030), (300, 64, 99), (129, 8, 13)])
def test_lora_rank_reduce_kernel_matches_plain_and_is_deterministic(cuda, vdtype, M, r, N):
    g = torch.Generator().manual_seed(M + N)
    u = torch.randn(M, r, generator=g).to(cuda)
    v = torch.randn(M, N, generator=g).to(cuda, vdtype)
    backend.reset_launch_counts()
    out = lora_rank_reduce_kernel(u, v)
    assert backend.LAUNCH_COUNTS == {"lora_rank_reduce": 1}
    again = lora_rank_reduce_kernel(u, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and tuple(out.shape) == (r, N)
    assert torch.equal(out, again)                      # fixed summation order
    torch.testing.assert_close(out, lora_rank_reduce_ref(u, v), atol=1e-4 * M ** 0.5,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("need_w", [False, True], ids=["w_frozen", "w_grad"])
@pytest.mark.parametrize("M,K,N,r", [(256, 768, 768, 4), (33, 70, 45, 2)])
def test_autograd_backward_matches_plain_autograd(cuda, dtype, need_w, M, K, N, r):
    g = torch.Generator().manual_seed(M + N + r)
    # z = x A^T and z2 = dY B are O(1): each term the backward sums is O(1)
    x = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda, dtype)
    a = (torch.randn(r, K, generator=g) * K ** -0.5).to(cuda, dtype)
    b = (torch.randn(N, r, generator=g) * N ** -0.5).to(cuda, dtype)
    cot = torch.randn(M, N, generator=g).to(cuda, dtype)
    need = (True, need_w, True, True)
    ins_k = [t.clone().requires_grad_(n) for t, n in zip((x, w, a, b), need)]
    ins_r = [t.clone().requires_grad_(n) for t, n in zip((x, w, a, b), need)]
    backend.reset_launch_counts()
    lora_matmul(*ins_k, scale=2.0).backward(cot)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"lora_matmul": 1, "lora_matmul_dx": 1,
                                     "lora_rank_reduce": 2}
    lora_matmul_ref(*ins_r, 2.0).backward(cot)
    for name, tk, tr in zip(("dx", "dw", "da", "db"), ins_k, ins_r):
        if tr.grad is None:
            assert tk.grad is None
            continue
        torch.testing.assert_close(tk.grad.float(), tr.grad.float(),
                                   msg=lambda m, n=name: f"{n}: {m}", **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,win", [(12, 64, 64, 12, 12, 64, 0),
                                                (1, 1024, 1024, 12, 12, 64, 0),
                                                (1, 40, 72, 2, 1, 16, 0),
                                                (1, 128, 128, 4, 2, 128, 33),
                                                (2, 8, 4, 2, 2, 8, 2),
                                                (1, 1, 7, 1, 1, 1, 0),
                                                # D 80 and 128 (padded to the mma's
                                                # k8/n8), Sq != Sk, GQA at S 1024, a
                                                # window across KV tiles, ragged D
                                                (2, 100, 100, 4, 4, 80, 0),
                                                (1, 200, 130, 2, 1, 128, 0),
                                                (1, 70, 300, 4, 2, 64, 0),
                                                (1, 1024, 1024, 12, 4, 64, 0),
                                                (2, 300, 300, 4, 2, 64, 100),
                                                (1, 96, 160, 2, 2, 42, 70),
                                                # two warp groups share the walk: D 128
                                                # and 96 (f32: no room to prefetch),
                                                # 80, a window, Sq < Sk
                                                (1, 512, 512, 2, 1, 128, 0),
                                                (1, 600, 600, 2, 2, 64, 300),
                                                (1, 300, 300, 2, 2, 80, 0),
                                                (1, 100, 400, 2, 1, 96, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KH, D, win):
    g = torch.Generator().manual_seed(Sq + Sk + D)
    q = torch.randn(B, Sq, H, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, Sk, KH, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, Sk, KH, D, generator=g).to(cuda, dtype)
    before = backend.LAUNCH_COUNTS.get("flash_attention", 0)
    o = flash_attention(q, k, v, window=win)
    again = flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["flash_attention"] == before + 2
    assert torch.equal(o, again)                        # no atomics: equal bits
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(o.float(), flash_attention_ref(q, k, v, window=win).float(),
                               atol=tol, rtol=tol)


def test_training_step_on_the_card_matches_the_cpu_step(cuda):
    """One SFL local step through the kernels equals the CPU step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SflLLM
    from repro_torch.interop import tree_to
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    cfg = get_arch("gpt2-s").reduced(num_layers=4, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    tc = TrainConfig(num_clients=2, batch_size=2, local_steps=1)
    tokens = torch.randint(0, 128, (2, 2, 16), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}
    outs = []
    for dev in ("cpu", "cuda"):
        sfl = SflLLM(cfg, params, 2, tc, adamw(1e-3), device=dev)
        backend.reset_launch_counts()
        st, m = sfl.local_step(sfl.init_state(lora), batch)
        if dev == "cuda":
            assert backend.LAUNCH_COUNTS == {"lora_matmul": 2 * (2 * 2 + 2),
                                             "lora_matmul_dx": 2 * (2 * 1 + 2),
                                             "lora_rank_reduce": 4 * (2 * 2 + 2)}
        outs.append((float(m["loss"]), tree_to([st.lora_client, st.lora_server], "cpu")))
    assert abs(outs[0][0] - outs[1][0]) < 1e-4
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# the int8-base pair: lora_matmul_q8 and lora_matmul_q8_dx
# ---------------------------------------------------------------------------

# f32 at atol = rtol 1e-4 (sums over 768 terms, TF32 off); bf16 at repro's
# GRAD_TOLS
Q8_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: GRAD_TOL[torch.bfloat16]}
Q8_SHAPES = [(8, 768, 768, 8), (256, 768, 768, 8), (768, 768, 768, 8), (256, 768, 768, 1),
             (768, 768, 768, 2), (256, 768, 768, 4), (33, 70, 45, 2), (5, 100, 70, 1),
             (70, 130, 301, 64), (1, 7, 1, 1), (200, 5120, 2560, 4)]


def _q8_inputs(cuda, dtype, M, K, N, r, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(cuda, dtype)
    wq, ws = quantize_weight_int8(torch.randn(K, N, generator=g) * K ** -0.5)
    a = (torch.randn(r, K, generator=g) * K ** -0.5).to(cuda, dtype)
    b = (torch.randn(N, r, generator=g) * N ** -0.5).to(cuda, dtype)
    return x, wq.to(cuda), ws.to(cuda), a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", Q8_SHAPES)
def test_lora_matmul_q8_kernels_match_plain(cuda, dtype, M, K, N, r):
    x, wq, ws, a, b = _q8_inputs(cuda, dtype, M, K, N, r, M + K + N + r)
    dy = torch.randn(M, N, generator=torch.Generator().manual_seed(r)).to(cuda, dtype)
    before = {k: backend.LAUNCH_COUNTS.get(k, 0) for k in ("lora_matmul_q8",
                                                           "lora_matmul_q8_dx")}
    y = lora_matmul_q8_kernel(x, wq, ws, a, b, 2.0)
    dx = lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, 2.0)
    torch.cuda.synchronize()
    assert all(backend.LAUNCH_COUNTS[k] == v + 1 for k, v in before.items())
    assert y.dtype == dx.dtype == dtype
    assert tuple(y.shape) == (M, N) and tuple(dx.shape) == (M, K)
    torch.testing.assert_close(y.float(), lora_matmul_q8_ref(x, wq, ws, a, b, 2.0).float(),
                               **Q8_TOL[dtype])
    torch.testing.assert_close(dx.float(),
                               lora_matmul_q8_dx_ref(dy, wq, ws, a, b, 2.0).float(),
                               **Q8_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", [(256, 768, 768, 8), (33, 70, 45, 2)])
def test_lora_matmul_q8_kernels_take_minus_128(cuda, dtype, M, K, N, r):
    """-128, which quantize_weight_int8 never makes, is exact in TF32 too:
    a W_q holding it, on 16-byte copies (768) and element copies (45)."""
    x, wq, ws, a, b = _q8_inputs(cuda, dtype, M, K, N, r, 3 * M + r)
    wq[::3, ::5] = -128
    dy = torch.randn(M, N, generator=torch.Generator().manual_seed(r)).to(cuda, dtype)
    y = lora_matmul_q8_kernel(x, wq, ws, a, b, 2.0)
    dx = lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, 2.0)
    torch.testing.assert_close(y.float(), lora_matmul_q8_ref(x, wq, ws, a, b, 2.0).float(),
                               **Q8_TOL[dtype])
    torch.testing.assert_close(dx.float(),
                               lora_matmul_q8_dx_ref(dy, wq, ws, a, b, 2.0).float(),
                               **Q8_TOL[dtype])


@pytest.mark.parametrize("M", [256, 768])
def test_q8_kernels_give_equal_bits_on_two_runs(cuda, M):
    """No atomics and a fixed order: the same inputs give the same bits."""
    x, wq, ws, a, b = _q8_inputs(cuda, torch.float32, M, 768, 768, 8, M)
    dy = torch.randn(M, 768, generator=torch.Generator().manual_seed(M)).to(cuda)
    for fn, lhs in ((lora_matmul_q8_kernel, x), (lora_matmul_q8_dx_kernel, dy)):
        first, again = fn(lhs, wq, ws, a, b, 2.0), fn(lhs, wq, ws, a, b, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(first, again), fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", [(256, 768, 768, 8), (768, 768, 768, 2), (33, 70, 45, 2)])
def test_q8_autograd_backward_matches_plain_autograd(cuda, dtype, M, K, N, r):
    """dx, da, db of lora_matmul(..., w_scale=) through the kernels against
    autograd of the plain version (and, printed, both against float64
    autograd); no gradient for the int8 W or its scale."""
    x, wq, ws, a, b = _q8_inputs(cuda, dtype, M, K, N, r, 7 * M + r)
    cot = torch.randn(M, N, generator=torch.Generator().manual_seed(M)).to(cuda, dtype)
    ink = [t.clone().requires_grad_() for t in (x, a, b)]
    inr = [t.clone().requires_grad_() for t in (x, a, b)]
    wsk = ws.clone().requires_grad_()
    backend.reset_launch_counts()
    lora_matmul(ink[0], wq, ink[1], ink[2], scale=2.0, w_scale=wsk).backward(cot)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"lora_matmul_q8": 1, "lora_matmul_q8_dx": 1,
                                     "lora_rank_reduce": 2}
    assert wsk.grad is None
    lora_matmul_q8_ref(inr[0], wq, ws, inr[1], inr[2], 2.0).backward(cot)
    in64 = [t.double().requires_grad_() for t in (x, a, b)]
    lora_matmul_q8_ref(in64[0], wq, ws, in64[1], in64[2], 2.0).backward(cot.double())
    for name, tk, tr, t64 in zip(("dx", "da", "db"), ink, inr, in64):
        print(f"{name}: kernel vs f64 {(tk.grad.double() - t64.grad).abs().max().item():.3g}"
              f", plain vs f64 {(tr.grad.double() - t64.grad).abs().max().item():.3g}, "
              f"max|ref| {t64.grad.abs().max().item():.4g}")
        torch.testing.assert_close(tk.grad.float(), tr.grad.float(),
                                   msg=lambda m, n=name: f"{n}: {m}", **GRAD_TOL[dtype])


def test_q8_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, wq, ws, a, b = _q8_inputs(cuda, torch.float32, 4, 16, 8, 2, 0)
    with pytest.raises(TypeError):
        lora_matmul_q8_kernel(x, wq.float(), ws, a, b, 1.0)            # W not int8
    with pytest.raises(ValueError):
        lora_matmul_q8_kernel(x, wq, ws[:4], a, b, 1.0)                # scale (4,) for N 8
    with pytest.raises(ValueError):
        lora_matmul_q8_dx_kernel(torch.randn(4, 8, device=cuda), wq, ws.cpu(), a, b, 1.0)
    with pytest.raises(TypeError):
        lora_matmul_q8_kernel(x, wq, ws, a.bfloat16(), b, 1.0)         # mixed dtypes


def test_q8_fleet_step_on_the_card_matches_the_cpu_step(cuda):
    """One local step of a mixed fleet over an int8 base (splits 1/2/3,
    ranks 1/2/4, act bits 4/8/16, grad bits 8, error feedback) through the
    kernels equals the CPU step, with the launches its splits imply.  SGD,
    so that an entry the two devices round to another quantization level
    moves the adapters by lr times a small gradient change, not by a
    whole Adam step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SflLLM
    from repro_torch.interop import tree_to
    from repro_torch.models import default_train_runtime
    from repro_torch.optim import sgd
    from repro_torch.precision import PrecisionConfig
    from repro_torch.tree import tree_leaves

    cfg = get_arch("gpt2-s").reduced(num_layers=4, d_model=64, vocab=128)
    params = quantize_params_int8(init_params(cfg, torch.Generator().manual_seed(0),
                                              device="cpu"))
    rt = default_train_runtime().replace(
        precision=PrecisionConfig(grad_bits=8, error_feedback=True))
    tc = TrainConfig(num_clients=3, batch_size=2, local_steps=1)
    tokens = torch.randint(0, 128, (3, 2, 16), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}
    outs = []
    for dev in ("cpu", "cuda"):
        sfl = SflLLM(cfg, params, (1, 2, 3), tc, sgd(0.1), rt=rt, device=dev,
                     ranks=(1, 2, 4), act_bits=(4, 8, 16))
        lora = sfl.init_lora(torch.Generator().manual_seed(1))
        backend.reset_launch_counts()
        st, m = sfl.local_step(sfl.init_state(lora), batch)
        if dev == "cuda":
            fwd = 2 * (1 + 2 + 3 + 4 - 1)
            assert backend.LAUNCH_COUNTS == {"lora_matmul_q8": fwd,
                                             "lora_matmul_q8_dx": 2 * (0 + 1 + 2 + 4 - 1),
                                             "lora_rank_reduce": 2 * fwd}
        outs.append((float(m["loss"]), tree_to([st.lora_client, st.lora_server], "cpu")))
    assert abs(outs[0][0] - outs[1][0]) < 1e-4
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


# -- the decode family: flash_decode (slab), its int8 twin, the int8 pool ----

DECODE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# (B, KH, G, D, L, window): the engine's shape, GQA with G > 1, ragged D
# (D % 4 != 0 reads int8 rows byte by byte), L not a multiple of the tile
SLAB_SHAPES = [(8, 12, 1, 64, 512, 0), (4, 2, 4, 128, 96, 0), (5, 1, 8, 64, 40, 0),
               (6, 2, 3, 42, 33, 7), (7, 2, 2, 20, 64, 16), (3, 1, 1, 1, 1, 0)]


def _slab_lengths(B, L):
    """0 (dead), 1, tile edges, L and L + 1 (a finished slot decoding on)."""
    return ([0, L + 1, 1, L, 31, 32, 33, L - 1] + list(range(2, B)))[:B]


def _slab_inputs(cuda, dtype, B, KH, G, D, L, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    lens = torch.tensor([max(0, n) for n in _slab_lengths(B, L)], dtype=torch.int32,
                        device=cuda)
    return q, k, v, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L,window", SLAB_SHAPES)
def test_flash_decode_kernel_matches_plain(cuda, dtype, B, KH, G, D, L, window):
    q, k, v, lens = _slab_inputs(cuda, dtype, B, KH, G, D, L, B * 100 + D + window)
    before = backend.LAUNCH_COUNTS.get("flash_decode", 0)
    o = flash_decode_kernel(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["flash_decode"] == before + 1
    ref = flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens, window=window)
    torch.testing.assert_close(o.float(), ref.float(), **DECODE_TOL[dtype])
    assert (o[0] == 0).all() and bool(torch.isfinite(o.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L", [shape[:5] for shape in SLAB_SHAPES]
                         + [(4, 2, 16, 64, 65), (3, 1, 8, 256, 64), (4, 1, 16, 256, 40),
                            (6, 4, 8, 128, 65)])
def test_flash_decode_partial_kernel_matches_plain(cuda, dtype, B, KH, G, D, L):
    """The partial-softmax kernel (f32 m, l, o whatever q's dtype) against
    its plain version (G 1 to 16, D 1 to 256), and its pieces joined as
    ``lse_combine`` joins them against ``flash_decode_kernel`` on the whole
    cache: the cache cut into two pieces, each with its live prefix
    (empty, partial, whole)."""
    q, k, v, lens = _slab_inputs(cuda, dtype, B, KH, G, D, L, B * 1000 + D)
    before = backend.LAUNCH_COUNTS.get("flash_decode_partial", 0)
    m, l, o = flash_decode_partial_kernel(q, k, v, lens)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["flash_decode_partial"] == before + 1
    assert all(t.dtype == torch.float32 for t in (m, l, o))
    for got, want in zip((m, l, o), flash_decode_partial_ref(q, k.transpose(1, 2),
                                                             v.transpose(1, 2), lens)):
        torch.testing.assert_close(got, want, **DECODE_TOL[torch.float32])
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (o[0] == 0).all()
    if L < 2:
        return
    c = L // 2
    parts = [flash_decode_partial_kernel(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                                         (lens - a).clamp(0, b - a).int())
             for a, b in ((0, c), (c, L))]
    M = torch.maximum(parts[0][0], parts[1][0])
    w = [torch.exp(p[0] - M) for p in parts]
    num = sum(wi[..., None] * p[2] for wi, p in zip(w, parts))
    den = sum(wi * p[1] for wi, p in zip(w, parts))
    whole = (lens.clamp(max=L)).int()
    want = flash_decode_kernel(q, k, v, whole).float()
    torch.testing.assert_close(num / den.clamp_min(1e-30)[..., None], want,
                               **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L,window", SLAB_SHAPES)
def test_flash_decode_q8_kernel_matches_plain(cuda, dtype, B, KH, G, D, L, window):
    q, k, v, lens = _slab_inputs(cuda, dtype, B, KH, G, D, L, B * 10 + D + window)
    kq, ks = quantize_kv_int8(k, head_axis=2)
    vq, vs = quantize_kv_int8(v, head_axis=2)
    before = backend.LAUNCH_COUNTS.get("flash_decode_q8", 0)
    o = flash_decode_q8_kernel(q, kq, vq, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["flash_decode_q8"] == before + 1
    ref = flash_decode_q8_ref(q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, lens,
                              window=window)
    torch.testing.assert_close(o.float(), ref.float(), **DECODE_TOL[dtype])
    assert o.dtype == dtype and (o[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,PS,MP", [(8, 12, 1, 64, 16, 32), (4, 2, 4, 128, 16, 8),
                                            (5, 1, 8, 64, 8, 6), (3, 2, 3, 42, 5, 4)])
def test_paged_decode_q8_kernel_matches_plain(cuda, dtype, B, KH, G, D, PS, MP):
    g = torch.Generator().manual_seed(B * 7 + D)
    NP = B * MP + 1
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    kq, ks = quantize_kv_int8(torch.randn(KH, NP, PS, D, generator=g).to(cuda), head_axis=0)
    vq, vs = quantize_kv_int8(torch.randn(KH, NP, PS, D, generator=g).to(cuda), head_axis=0)
    lengths = [0, 1, PS, PS + 1, MP * PS, 2 * PS - 1, 3, PS * MP - 1][:B]
    pages = torch.randperm(NP - 1, generator=g) + 1
    bt = torch.zeros(B, MP, dtype=torch.int32)
    for i, n in enumerate(lengths):
        npg = -(-n // PS)
        bt[i, :npg] = pages[i * MP:i * MP + npg].int()
    lens, bt = torch.tensor(lengths, dtype=torch.int32, device=cuda), bt.to(cuda)
    before = backend.LAUNCH_COUNTS.get("paged_decode_q8", 0)
    o = paged_decode_q8_kernel(q, kq, vq, lens, bt, ks, vs)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["paged_decode_q8"] == before + 1
    ref = paged_decode_q8_ref(q, kq, vq, ks, vs, lens, bt)
    torch.testing.assert_close(o.float(), ref.float(), **DECODE_TOL[dtype])
    assert (o[0] == 0).all()


def test_q8_decode_reads_unaligned_rows_byte_by_byte(cuda):
    """D % 16 == 0 but the int8 cache starts one byte into its buffer: no
    row is 16-byte aligned, so the kernel takes the byte path, and gives
    the aligned copy's bits."""
    B, KH, G, D, L = 3, 2, 2, 64, 40
    q, k, v, lens = _slab_inputs(cuda, torch.float32, B, KH, G, D, L, 5)
    kq, ks = quantize_kv_int8(k, head_axis=2)
    vq, vs = quantize_kv_int8(v, head_axis=2)
    n = kq.numel()
    kb = torch.zeros(n + 1, dtype=torch.int8, device=cuda)
    vb = torch.zeros(n + 1, dtype=torch.int8, device=cuda)
    kb[1:] = kq.reshape(-1)
    vb[1:] = vq.reshape(-1)
    ku, vu = kb[1:].view(kq.shape), vb[1:].view(vq.shape)
    assert ku.data_ptr() % 4 == 1 and ku.is_contiguous()
    o = flash_decode_q8_kernel(q, ku, vu, lens, ks, vs)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, flash_decode_q8_kernel(q, kq, vq, lens, ks, vs),
                               atol=0, rtol=0)


def test_decode_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, lens = _slab_inputs(cuda, torch.float32, 2, 2, 2, 16, 8, 0)
    kq, ks = quantize_kv_int8(k, head_axis=2)
    vq, vs = quantize_kv_int8(v, head_axis=2)
    with pytest.raises(TypeError):
        flash_decode_kernel(q, k.bfloat16(), v.bfloat16(), lens)       # dtype mismatch
    with pytest.raises(TypeError):
        flash_decode_kernel(q, k, v, lens.long())                      # int64 lengths
    with pytest.raises(ValueError):
        flash_decode_kernel(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens)
    with pytest.raises(ValueError):
        flash_decode_kernel(q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous(), lens)
    with pytest.raises(ValueError):
        flash_decode_kernel(q, k, v, lens, window=-1)
    with pytest.raises(TypeError):
        flash_decode_q8_kernel(q, k, v, lens, ks, vs)                  # float K/V
    with pytest.raises(ValueError):
        flash_decode_q8_kernel(q, kq, vq, lens, ks[:1], vs)            # (1,) for KH 2
    with pytest.raises(ValueError):
        flash_decode_q8_kernel(q, kq, vq, lens, ks.cpu(), vs)
    pool = torch.zeros(2, 3, 4, 16, dtype=torch.int8, device=cuda)
    bt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        paged_decode_q8_kernel(q, pool, pool, lens, bt, ks, vs.double())
    with pytest.raises(TypeError):
        flash_decode(q[:, None].reshape(2, 1, 4, 16), kq, vq, lens)    # no scales


# -- the split-K body (csrc/decode_split.cuh): the f32/bf16 pair and, through
# the Int8KV policy, the int8 pair (kv "int8": K/V quantized per KV head)

KV_KINDS = ["float", "int8"]


def _paged_inputs(cuda, dtype, B, KH, G, D, PS, MP, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    NP = B * MP + 1
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    kp = torch.randn(KH, NP, PS, D, generator=g).to(cuda, dtype)
    vp = torch.randn(KH, NP, PS, D, generator=g).to(cuda, dtype)
    pages = torch.randperm(NP - 1, generator=g) + 1
    bt = torch.zeros(B, MP, dtype=torch.int32)
    for i, n in enumerate(lengths):
        npg = -(-n // PS)
        bt[i, :npg] = pages[i * MP:i * MP + npg].int()
    return q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device=cuda), bt.to(cuda)


def _one_launch_twice(op, fn):
    """fn() launches op's kernel once a call, and two calls give equal bits."""
    before = backend.LAUNCH_COUNTS.get(op, 0)
    o = fn()
    again = fn()
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS[op] == before + 2
    assert torch.equal(o, again)
    return o


def _slab_call(kv, q, k, v, lens, window=0):
    """(op, kernel call, plain version) over float K/V or their int8 copy."""
    if kv == "float":
        return ("flash_decode", lambda: flash_decode_kernel(q, k, v, lens, window=window),
                lambda: flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens,
                                         window=window))
    (kq, ks), (vq, vs) = quantize_kv_int8(k, head_axis=2), quantize_kv_int8(v, head_axis=2)
    return ("flash_decode_q8",
            lambda: flash_decode_q8_kernel(q, kq, vq, lens, ks, vs, window=window),
            lambda: flash_decode_q8_ref(q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs,
                                        lens, window=window))


def _paged_call(kv, q, kp, vp, lens, bt):
    if kv == "float":
        return ("paged_decode", lambda: paged_decode_kernel(q, kp, vp, lens, bt),
                lambda: paged_decode_ref(q, kp, vp, lens, bt))
    (kq, ks), (vq, vs) = quantize_kv_int8(kp, head_axis=0), quantize_kv_int8(vp, head_axis=0)
    return ("paged_decode_q8", lambda: paged_decode_q8_kernel(q, kq, vq, lens, bt, ks, vs),
            lambda: paged_decode_q8_ref(q, kq, vq, ks, vs, lens, bt))


def _flash_split_case(cuda, dtype, B, KH, G, D, L, lengths, window, seed, kv="float"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    op, kern, ref = _slab_call(kv, q, k, v, lens, window)
    o = _one_launch_twice(op, kern)
    torch.testing.assert_close(o.float(), ref().float(), **DECODE_TOL[dtype])
    return o


def _paged_split_case(cuda, dtype, B, KH, G, D, PS, MP, lengths, seed, kv):
    q, kp, vp, lens, bt = _paged_inputs(cuda, dtype, B, KH, G, D, PS, MP, lengths, seed)
    op, kern, ref = _paged_call(kv, q, kp, vp, lens, bt)
    o = _one_launch_twice(op, kern)
    torch.testing.assert_close(o.float(), ref().float(), **DECODE_TOL[dtype])
    assert (o[0] == 0).all()
    return o


@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("length", [511, 512, 513])
def test_flash_decode_one_slot_at_the_capacity(cuda, dtype, length, kv):
    """The naive loop's shape (one slot, eight splits) at the cache's end."""
    _flash_split_case(cuda, dtype, 1, 12, 1, 64, 512, [length], 0, length, kv)


@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("L", [16, 33, 96, 1024, 2048])
def test_flash_decode_every_split(cuda, dtype, G, L, kv):
    """Capacities that take S = 1 (one tile) to 8 (many tiles a block), with
    and without a window; a dead slot gives exact zeros."""
    for window in (0, 37):
        o = _flash_split_case(cuda, dtype, 3, 2, G, 64, L, [0, L, L // 2 + 1], window,
                              L + G + window, kv)
        assert (o[0] == 0).all()


@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [20, 42, 128, 256])
def test_decode_pair_head_dims(cuda, dtype, D, kv):
    """Element loads (D 20 in bf16 and int8, 42), 16-byte loads, two pieces
    a lane (f32 D 256), for both kernels."""
    o = _flash_split_case(cuda, dtype, 4, 2, 2, D, 96, [0, 97, 33, 64], 0, D, kv)
    assert (o[0] == 0).all()
    _paged_split_case(cuda, dtype, 4, 2, 2, D, 16, 5, [0, 1, 17, 80], D, kv)


@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("PS", [1, 16, 48])
def test_paged_decode_page_sizes(cuda, dtype, G, PS, kv):
    """Pages of one position (a table entry per row), of 16, and of 48 (not
    a divisor of the 32-position tile)."""
    MP = -(-300 // PS)
    _paged_split_case(cuda, dtype, 5, 2, G, 64, PS, MP, [0, 1, PS + 1, 255, MP * PS], PS + G,
                      kv)


@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_pair_unaligned_base_takes_element_loads(cuda, dtype, kv):
    """K and V one entry into their buffers: no row is 16-byte aligned, so
    the kernels read entry by entry, and give the aligned copy's bits."""
    B, KH, G, D, L = 3, 2, 2, 64, 40

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:] = t.reshape(-1)
        out = buf[1:].view(t.shape)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    def q8(t, axis):
        return quantize_kv_int8(t, head_axis=axis) if kv == "int8" else (t, None)

    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    (k, ks), (v, vs) = [q8(torch.randn(B, L, KH, D, generator=g).to(cuda, dtype), 2)
                        for _ in range(2)]
    lens = torch.tensor([0, 40, 17], dtype=torch.int32, device=cuda)
    if kv == "int8":
        o = flash_decode_q8_kernel(q, shifted(k), shifted(v), lens, ks, vs)
        want = flash_decode_q8_kernel(q, k, v, lens, ks, vs)
    else:
        o, want = flash_decode_kernel(q, shifted(k), shifted(v), lens), \
            flash_decode_kernel(q, k, v, lens)
    torch.testing.assert_close(o, want, atol=0, rtol=0)
    q, kp, vp, lens, bt = _paged_inputs(cuda, dtype, 3, KH, G, D, 16, 4, [0, 64, 20], 4)
    (kp, ks), (vp, vs) = q8(kp, 0), q8(vp, 0)
    if kv == "int8":
        o = paged_decode_q8_kernel(q, shifted(kp), shifted(vp), lens, bt, ks, vs)
        want = paged_decode_q8_kernel(q, kp, vp, lens, bt, ks, vs)
    else:
        o, want = paged_decode_kernel(q, shifted(kp), shifted(vp), lens, bt), \
            paged_decode_kernel(q, kp, vp, lens, bt)
    torch.testing.assert_close(o, want, atol=0, rtol=0)


def test_decode_pair_refuses_a_head_dim_over_the_cap(cuda):
    D = 264
    q = torch.zeros(1, 1, 1, D, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    bt = torch.ones(1, 1, dtype=torch.int32, device=cuda)
    s = torch.ones(1, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_kernel(q, torch.zeros(1, 4, 1, D, device=cuda),
                            torch.zeros(1, 4, 1, D, device=cuda), lens)
    with pytest.raises(ValueError, match="head dim"):
        paged_decode_kernel(q, torch.zeros(1, 2, 4, D, device=cuda),
                            torch.zeros(1, 2, 4, D, device=cuda), lens, bt)
    k8 = torch.zeros(1, 4, 1, D, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_q8_kernel(q, k8, k8, lens, s, s)
    p8 = torch.zeros(1, 2, 4, D, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        paged_decode_q8_kernel(q, p8, p8, lens, bt, s, s)


def test_slab_and_naive_engines_on_the_card_match_the_cpu_engine(cuda):
    cfg = get_arch("gpt2-s").reduced(num_layers=2, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    outs = []
    for dev, kw in (("cpu", dict(paged=False)), ("cuda", dict(paged=False)),
                    ("cuda", dict(fused=False)), ("cuda", dict(max_len=50))):
        eng = ServingEngine(cfg, params, lora=lora, max_slots=3, page_size=8, device=dev,
                            **{"max_len": 48, **kw})
        assert not eng.paged
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 3 * i)), max_new_tokens=6)
                for i in range(5)]
        for r in reqs:
            eng.submit(r)
        backend.reset_launch_counts()
        eng.run()
        if dev == "cuda":
            assert backend.LAUNCH_COUNTS["lora_matmul"] > 0
            assert backend.LAUNCH_COUNTS["flash_decode"] > 0
            assert "paged_decode" not in backend.LAUNCH_COUNTS
        outs.append([r.output for r in reqs])
    assert all(o == outs[0] for o in outs)


# ---------------------------------------------------------------------------
# the multi-tenant gather (lora_matmul.cu's gather entry)
# ---------------------------------------------------------------------------

GATHER_SHAPES = [(8, 768, 768, 4, 8), (16, 768, 768, 4, 16), (5, 100, 70, 3, 3),
                 (33, 300, 129, 64, 5), (7, 130, 45, 1, 2), (1, 7, 1, 1, 1)]


def _gather_inputs(M, K, N, r, A, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(dev, dtype)
    a = (torch.randn(A, r, K, generator=g) * r ** -0.5).to(dev, dtype)
    b = (torch.randn(A, N, r, generator=g) * 0.05).to(dev, dtype)
    return x, w, a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("order", ["distinct", "repeated", "out_of_range"])
@pytest.mark.parametrize("M,K,N,r,A", GATHER_SHAPES)
def test_lora_matmul_gather_kernel_matches_plain(cuda, dtype, order, M, K, N, r, A):
    x, w, a, b = _gather_inputs(M, K, N, r, A, dtype, cuda, M * 1000 + r * 10 + A)
    if order == "distinct":
        idx = torch.arange(M) % A
    elif order == "repeated":
        idx = torch.full((M,), A - 1)
        idx[::3] = 0
    else:                        # [-A, 0) counts from the end; the rest are NaN rows
        idx = torch.tensor([-A - 1, -1, A, A + 3, 0, -A, A - 1, 1 % A])[torch.arange(M) % 8]
    idx = idx.to(cuda, torch.int32)
    before = backend.LAUNCH_COUNTS.get("lora_matmul_gather", 0)
    y = lora_matmul_gather_kernel(x, w, a, b, idx, 2.0)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS["lora_matmul_gather"] == before + 1
    want = lora_matmul_gathered_ref(x, w, a, b, idx, 2.0)
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    torch.testing.assert_close(y.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype],
                               equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [12, 40])
def test_gathered_rows_bit_equal_lora_matmul_on_each_tenants_rows(cuda, dtype, M):
    """The gather and the single-adapter forward are one body per regime
    with the same arithmetic order, and a row's result depends on the
    regime, K and N, not on M or its tile neighbours: each tenant's rows
    are bit for bit lora_matmul on them, alone at a decode M (12) and, at a
    tile M (40), first in a call padded with other rows to T + 1 rows."""
    K, N, r, A = 768, 768, 4, 8
    x, w, a, b = _gather_inputs(M, K, N, r, A, dtype, cuda, 7)
    idx = torch.randint(0, A, (M,), generator=torch.Generator().manual_seed(8))
    y = lora_matmul_gathered(x, w, a, b, idx.to(cuda, torch.int32), scale=2.0)
    for t in range(A):
        rows = (idx == t).to(cuda)
        n = int(rows.sum())
        if n:
            xt = x[rows]
            if M > DECODE_MAX_M:
                xt = torch.cat([xt, x[~rows][:max(0, DECODE_MAX_M + 1 - n)]])
            assert torch.equal(y[rows], lora_matmul(xt.contiguous(), w, a[t], b[t],
                                                    scale=2.0)[:n])


def test_gather_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 16, device=cuda)
    w = torch.randn(16, 8, device=cuda)
    a, b = torch.randn(3, 2, 16, device=cuda), torch.randn(3, 8, 2, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        lora_matmul_gather_kernel(x, w, a, b, idx.long(), 1.0)            # idx not int32
    with pytest.raises(TypeError):
        lora_matmul_gather_kernel(x, w, a.double(), b, idx, 1.0)
    with pytest.raises(ValueError):
        lora_matmul_gather_kernel(x, w, a, b, idx.cpu(), 1.0)             # idx off the card
    with pytest.raises(ValueError):
        lora_matmul_gather_kernel(x, w, a.transpose(1, 2).contiguous().transpose(1, 2), b,
                                  idx, 1.0)                               # not contiguous
    with pytest.raises(ValueError):
        lora_matmul_gather_kernel(x, w, a, b[:, :7], idx, 1.0)            # N disagrees
    with pytest.raises(ValueError):
        lora_matmul_gather_kernel(x, w, torch.randn(3, 65, 16, device=cuda),
                                  torch.randn(3, 8, 65, device=cuda), idx, 1.0)  # rank > 64


def _digest(t):
    import hashlib
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def lora_matmul_digests(dev):
    """SHA-256 (first 16 hex digits) of lora_matmul_kernel's output bytes on
    inputs made by numpy at fixed seeds: (dtype, M, K, N, r) -> digest."""
    import numpy as np
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N, r in ((8, 768, 768, 4), (16, 768, 768, 4), (5, 100, 70, 3),
                           (33, 300, 129, 64), (17, 768, 768, 4), (200, 2560, 10576, 4)):
            rng = np.random.default_rng(M * 1000 + K + r)
            x = rng.normal(size=(M, K)).astype(np.float32)
            w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
            a = (rng.normal(size=(r, K)) * r ** -0.5).astype(np.float32)
            b = (rng.normal(size=(N, r)) * 0.05).astype(np.float32)
            ts = [torch.from_numpy(v).to(dev, dtype) for v in (x, w, a, b)]
            y = lora_matmul_kernel(*ts, 2.0)
            out[(str(dtype).split(".")[1], M, K, N, r)] = _digest(y)
    return out


# lora_matmul_kernel's outputs on the two-regime body (split-K decode tile
# for M <= 16, 3xTF32 mma tile above), recorded on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (torch 2.11+cu128, CUDA 12.8)
LORA_MATMUL_DIGESTS = {
    ("float32", 8, 768, 768, 4): "992a2423d1e7df2b",
    ("float32", 16, 768, 768, 4): "aacc306a5761ab81",
    ("float32", 5, 100, 70, 3): "b21af82546865f5b",
    ("float32", 33, 300, 129, 64): "6b93261844fed0df",
    ("float32", 17, 768, 768, 4): "7ab11e63ee003cd0",
    ("float32", 200, 2560, 10576, 4): "1c24a8eec34716e5",
    ("bfloat16", 8, 768, 768, 4): "871c648998e49662",
    ("bfloat16", 16, 768, 768, 4): "a46fdbc589b94a79",
    ("bfloat16", 5, 100, 70, 3): "1c758a734036a79e",
    ("bfloat16", 33, 300, 129, 64): "e1bb74246a915161",
    ("bfloat16", 17, 768, 768, 4): "0c573c034d37daae",
    ("bfloat16", 200, 2560, 10576, 4): "c52891440e3a7689",
}


def test_lora_matmul_kernel_bit_identical_to_its_outputs_after_the_redesign(cuda):
    assert lora_matmul_digests(cuda) == LORA_MATMUL_DIGESTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m_small,m_big", [(3, 16), (17, 200), (200, 768)])
def test_lora_matmul_rows_do_not_depend_on_m_within_a_regime(cuda, dtype, m_small, m_big):
    """The first rows of a call equal the call on those rows alone, bit for
    bit, while both calls take one regime (the tile shapes differ: 32 x 32
    at M 17, 64 x 64 at M 200 and 768)."""
    g = torch.Generator().manual_seed(m_big)
    K = N = 768
    x = torch.randn(m_big, K, generator=g).to(cuda, dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda, dtype)
    a = torch.randn(4, K, generator=g).to(cuda, dtype)
    b = (torch.randn(N, 4, generator=g) * 0.05).to(cuda, dtype)
    assert torch.equal(lora_matmul_kernel(x[:m_small].contiguous(), w, a, b, 2.0),
                       lora_matmul_kernel(x, w, a, b, 2.0)[:m_small])


@pytest.mark.parametrize("op,M,K,N", [("lora_matmul", 8, 5120, 2560),
                                      ("lora_matmul", 17, 768, 768),
                                      ("lora_matmul", 768, 768, 768),
                                      ("lora_matmul_dx", 256, 768, 768)])
def test_kernels_give_equal_bits_on_two_runs(cuda, op, M, K, N):
    """No atomics and a fixed order: the same inputs give the same bits."""
    g = torch.Generator().manual_seed(M + K)
    lhs = torch.randn(M, K if op == "lora_matmul" else N, generator=g).to(cuda)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda)
    a, b = torch.randn(4, K, generator=g).to(cuda), torch.randn(N, 4, generator=g).to(cuda)
    fn = lora_matmul_kernel if op == "lora_matmul" else lora_matmul_dx_kernel
    first, again = fn(lhs, w, a, b, 2.0), fn(lhs, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_multi_tenant_engine_on_the_card_matches_the_cpu_engine(cuda):
    cfg = get_arch("gpt2-s").reduced(num_layers=2, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for dev in ("cpu", "cuda"):
        reg = AdapterRegistry(cfg, pool_size=3, device=dev)
        for t in range(5):
            lora = init_lora_stack(cfg, torch.Generator().manual_seed(10 + t), device="cpu")
            for layer in lora:
                for ad in layer["mixer"].values():
                    ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(20 + t))
            reg.publish(t, lora)
        eng = ServingEngine(cfg, params, adapters=reg, max_slots=3, max_len=48,
                            page_size=8, device=dev)
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 3 * i)), max_new_tokens=6,
                        tenant=i % 5) for i in range(7)]
        for r in reqs:
            eng.submit(r)
        backend.reset_launch_counts()
        eng.run()
        if dev == "cuda":
            st = eng.stats
            assert backend.LAUNCH_COUNTS["lora_matmul_gather"] == 4 * st["decode_steps"]
            assert backend.LAUNCH_COUNTS["lora_matmul"] == 4 * st["prefill_chunks"]
            assert reg.stats["evictions"] > 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the SSD scan (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

# (B, S, nh, hd, N, chunk): tests/test_kernels.py's four, then the
# full-width Mamba2-2.7B prefill (80 heads of 64, state 128, chunk 256) at
# one short, one ragged single-chunk, two-chunk and ragged two-chunk S
SSD_SHAPES = [(2, 64, 4, 32, 16, 16), (1, 100, 2, 16, 8, 32), (2, 31, 3, 8, 4, 16),
              (1, 256, 2, 64, 32, 64), (1, 8, 80, 64, 128, 256), (1, 200, 80, 64, 128, 256),
              (1, 512, 80, 64, 128, 256), (1, 300, 80, 64, 128, 256),
              (2, 70, 3, 100, 256, 48)]


def _ssd_inputs(B, S, nh, hd, N, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    xh = torch.randn(B, S, nh, hd, generator=g)
    Bm = torch.randn(B, S, N, generator=g) * N ** -0.5
    Cm = torch.randn(B, S, N, generator=g) * N ** -0.5
    dt = torch.nn.functional.softplus(torch.randn(B, S, nh, generator=g))
    A = -torch.exp(torch.linspace(0.0, 1.5, nh))
    return [t.to(dev) for t in (xh, Bm, Cm, dt, A)]


@pytest.mark.parametrize("B,S,nh,hd,N,Q", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, B, S, nh, hd, N, Q):
    ins = _ssd_inputs(B, S, nh, hd, N, cuda, seed=S)
    backend.reset_launch_counts()
    y, h = ssd_scan_with_state(*ins, chunk=Q)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"ssd_scan": 1}
    yr, hr = ssd_chunked(*ins, chunk=Q)
    tol = dict(atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(y, yr, **tol)
    torch.testing.assert_close(h, hr, **tol)
    if S <= 256:
        ys, hs = ssd_sequential_ref(*ins)
        torch.testing.assert_close(y, ys, **tol)
        torch.testing.assert_close(h, hs, **tol)


# the redesigned kernel's edges at chunk 256 (B, S, nh, hd, N): S 1, 7, 64,
# 65, 256, 257 and 1024 (four chunks), nh 1, 7 and 80 (7 and 80 not
# multiples of the cluster with some column tiles), hd 8, 80 (a ragged
# column tile) and 64, N 3 (element copies), 4, 16, 128 and 256
SSD_EDGE_SHAPES = [(1, 1, 1, 8, 4), (1, 7, 7, 8, 16), (1, 64, 80, 64, 128),
                   (1, 65, 7, 80, 128), (1, 256, 1, 64, 256), (1, 257, 80, 64, 128),
                   (1, 1024, 7, 80, 16), (2, 1024, 1, 64, 128), (1, 200, 80, 80, 256),
                   (2, 65, 80, 8, 4), (1, 100, 7, 64, 3)]


@pytest.mark.parametrize("B,S,nh,hd,N", SSD_EDGE_SHAPES)
def test_ssd_scan_kernel_edges_one_launch_and_equal_bits(cuda, B, S, nh, hd, N):
    ins = _ssd_inputs(B, S, nh, hd, N, cuda, seed=S + nh)
    backend.reset_launch_counts()
    y, h = ssd_scan_with_state(*ins, chunk=256)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"ssd_scan": 1}
    y2, h2 = ssd_scan_with_state(*ins, chunk=256)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    tol = dict(atol=1e-4, rtol=1e-3)
    yr, hr = ssd_chunked(*ins, chunk=256)
    torch.testing.assert_close(y, yr, **tol)
    torch.testing.assert_close(h, hr, **tol)
    if S <= 256:
        ys, hs = ssd_sequential_ref(*ins)
        torch.testing.assert_close(y, ys, **tol)
        torch.testing.assert_close(h, hs, **tol)


@pytest.mark.parametrize("B,S,nh,hd,N", [(1, 200, 80, 64, 128), (1, 65, 7, 80, 16)])
def test_ssd_scan_kernel_off_a_16_byte_boundary_gives_the_aligned_bits(cuda, B, S, nh, hd, N):
    """xdt, Bm and Cm one float off a 16-byte boundary take element copies;
    the copy width never changes the arithmetic."""
    xh, Bm, Cm, dt, A = _ssd_inputs(B, S, nh, hd, N, cuda, seed=1)
    xdt = (xh * dt[..., None]).permute(0, 2, 1, 3).contiguous()
    g = (dt * A).permute(0, 2, 1).contiguous()

    def off(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    xo, Bo, Co = off(xdt), off(Bm), off(Cm)
    assert xo.data_ptr() % 16 and Bo.data_ptr() % 16 and xo.is_contiguous()
    y, h = ssd_scan_kernel(xdt, g, Bm, Cm, chunk=256)
    yo, ho = ssd_scan_kernel(xo, g, Bo, Co, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y, yo) and torch.equal(h, ho)


def test_ssd_scan_refuses_autograd_and_bad_operands_on_the_card(cuda):
    """Autograd on the card now runs the backward kernel (one launch of
    each kernel, no fallback to ``ssd_chunked``); bad operands are still
    refused by both wrappers."""
    xh, Bm, Cm, dt, A = _ssd_inputs(1, 40, 2, 8, 8, cuda)
    backend.reset_launch_counts()
    y, h = ssd_scan_with_state(xh.requires_grad_(), Bm, Cm, dt, A, chunk=16)
    (y.sum() + h.sum()).backward()
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    assert bool(torch.isfinite(xh.grad).all())
    xdt = torch.zeros(1, 2, 32, 8, device=cuda)
    g = torch.zeros(1, 2, 32, device=cuda)
    Bk = torch.zeros(1, 32, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_kernel(xdt.transpose(2, 3).contiguous().transpose(2, 3), g, Bk, Bk,
                        chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_kernel(xdt, g, Bk.cpu(), Bk, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd_kernel(xdt, g, Bk, Bk, xdt.cpu(), chunk=16)
    with pytest.raises(ValueError, match="does not match"):
        ssd_scan_bwd_kernel(xdt, g, Bk, Bk, xdt[:, :1].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_bwd_kernel(xdt, g, Bk, Bk, xdt, chunk=24)


# the backward (csrc/ssd_scan_bwd.cu), (B, S, nh, hd, N, Q) in the kernel
# layout: reduced Mamba2 / Jamba (4 heads of 32, N 16, Q 32), Mamba2-2.7B's
# heads at one and two chunks and its training shape (B 2, 320 tokens padded
# to 512), Jamba's full-width heads (128, N 64), hd 128 at N 256, ragged
# tiles (Q 48, 100), B 4 and S 1024; the plan's edges: each instantiation
# (hd 32, 64, 128), N 16 to 256, Q 32, 64 and 256 at three chunks, head
# groups that do not divide the heads, and chunks of 512 (two segments)
SSD_BWD_SHAPES = [(2, 64, 4, 32, 16, 32), (1, 256, 80, 64, 128, 256),
                  (2, 512, 80, 64, 128, 256), (2, 512, 8, 128, 64, 256),
                  (1, 256, 3, 128, 256, 256), (2, 96, 3, 100, 5, 48),
                  (1, 200, 2, 16, 16, 100), (4, 1024, 2, 64, 128, 256),
                  (3, 160, 5, 32, 64, 32), (2, 96, 6, 32, 256, 32),
                  (2, 192, 3, 64, 64, 64), (1, 192, 3, 128, 128, 64),
                  (1, 768, 4, 32, 128, 256), (6, 512, 81, 64, 128, 256),
                  (1, 1024, 2, 64, 128, 512)]


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("B,S,nh,hd,N,Q", SSD_BWD_SHAPES)
def test_ssd_scan_bwd_kernel_matches_plain_one_launch_equal_bits(cuda, B, S, nh, hd, N, Q,
                                                                 with_dh):
    """At the model's decays (A = -linspace(1, 16)): the four cotangents
    within 1e-4 of the plain version's largest entry (f32 sums in another
    order), one launch a call, two runs bit-equal."""
    gen = torch.Generator().manual_seed(S + nh + hd)
    dt = torch.nn.functional.softplus(torch.randn(B, nh, S, generator=gen))
    xdt = (torch.randn(B, nh, S, hd, generator=gen) * dt[..., None]).to(cuda)
    g = (-dt * torch.linspace(1.0, 16.0, nh)[None, :, None]).to(cuda)
    Bm = (torch.randn(B, S, N, generator=gen) * N ** -0.5).to(cuda)
    Cm = (torch.randn(B, S, N, generator=gen) * N ** -0.5).to(cuda)
    dy = torch.randn(B, nh, S, hd, generator=gen).to(cuda)
    dh = torch.randn(B, nh, hd, N, generator=gen).to(cuda) if with_dh else None
    backend.reset_launch_counts()
    got = ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    again = ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"ssd_scan_bwd": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_scan_bwd_ref(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    for k, r in zip(got, want):
        assert k.shape == r.shape and bool(torch.isfinite(k).all())
        assert (k - r).abs().max() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("B,S,nh,hd,N,Q", [(1, 128, 2, 192, 32, 64),
                                           (2, 96, 3, 136, 16, 48),
                                           (1, 256, 2, 256, 64, 256)])
def test_ssd_scan_bwd_kernel_takes_any_head_dim(cuda, B, S, nh, hd, N, Q):
    """A head dim over 128 runs one launch per slice of at most 128 (dg, dBm
    and dCm summed over the slices): within 1e-4 of the plain version's
    largest entry, two runs bit-equal."""
    gen = torch.Generator().manual_seed(S + nh + hd)
    dt = torch.nn.functional.softplus(torch.randn(B, nh, S, generator=gen))
    xdt = (torch.randn(B, nh, S, hd, generator=gen) * dt[..., None]).to(cuda)
    g = (-dt * torch.linspace(1.0, 16.0, nh)[None, :, None]).to(cuda)
    Bm = (torch.randn(B, S, N, generator=gen) * N ** -0.5).to(cuda)
    Cm = (torch.randn(B, S, N, generator=gen) * N ** -0.5).to(cuda)
    dy = torch.randn(B, nh, S, hd, generator=gen).to(cuda)
    dh = torch.randn(B, nh, hd, N, generator=gen).to(cuda)
    backend.reset_launch_counts()
    got = ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    again = ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    torch.cuda.synchronize()
    assert backend.LAUNCH_COUNTS == {"ssd_scan_bwd": 2 * -(-hd // 128)}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_scan_bwd_ref(xdt, g, Bm, Cm, dy, dh, chunk=Q)
    for k, r in zip(got, want):
        assert k.shape == r.shape and bool(torch.isfinite(k).all())
        assert (k - r).abs().max() <= 1e-4 * max(1.0, r.abs().max().item())


def test_mamba_training_step_on_the_card_matches_the_cpu_step(cuda):
    """One SFL local step of reduced Mamba2 (2 layers, chunks of 32, 40
    tokens: two chunks, a padded tail) through the kernels equals the CPU
    step (ssd_chunked under autograd); the scan and its backward once per
    block per client or server pass."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SflLLM
    from repro_torch.interop import tree_to
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    cfg = get_arch("mamba2-2.7b").reduced(num_layers=2, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    tc = TrainConfig(num_clients=2, batch_size=2, local_steps=1)
    tokens = torch.randint(0, 128, (2, 2, 40), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}
    outs = []
    for dev in ("cpu", "cuda"):
        sfl = SflLLM(cfg, params, 1, tc, adamw(1e-3), device=dev)
        backend.reset_launch_counts()
        st, m = sfl.local_step(sfl.init_state(lora), batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert backend.LAUNCH_COUNTS == {"ssd_scan": 2 + 1, "ssd_scan_bwd": 2 + 1,
                                             "lora_matmul": 2 * (2 + 1),
                                             "lora_matmul_dx": 2 * (2 * 1 - 1) + 2 * 1,
                                             "lora_rank_reduce": 4 * (2 + 1)}
        outs.append((float(m["loss"]), tree_to([st.lora_client, st.lora_server], "cpu")))
    assert abs(outs[0][0] - outs[1][0]) < 1e-4
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


def test_mamba_slab_engines_on_the_card_match_the_cpu_engine(cuda):
    cfg = get_arch("mamba2-2.7b").reduced(num_layers=2, d_model=64, vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    outs = []
    for dev, fused in (("cpu", True), ("cuda", True), ("cuda", False)):
        eng = ServingEngine(cfg, params, lora=lora, max_slots=3, max_len=64, device=dev,
                            fused=fused)
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 9 * i)), max_new_tokens=6)
                for i in range(5)]
        for r in reqs:
            eng.submit(r)
        backend.reset_launch_counts()
        eng.run()
        if dev == "cuda":
            st = eng.stats
            assert backend.LAUNCH_COUNTS["ssd_scan"] == 2 * st["prefills"]
            assert backend.LAUNCH_COUNTS["lora_matmul"] == (
                6 * st["prefills"] + 4 * (st["decode_steps"] if fused else
                                          sum(len(r.output) - 1 for r in reqs)))
        outs.append([r.output for r in reqs])
    assert all(o == outs[0] for o in outs)


@pytest.mark.parametrize("S,Q", [(200, 256), (300, 256), (45, 16)])
def test_ssd_scan_kernel_at_the_models_decays_no_further_from_f64_than_chunked(cuda, S, Q):
    """A = -linspace(1, 16), as the model draws it: cum reaches the
    thousands inside a 256-token chunk.  The kernel's y and state are held
    against the per-token oracle in f64, no further from it than twice
    ``ssd_chunked``'s distance (the f32 prefix sum it once took rounded
    the decays up to 22x further)."""
    xh, Bm, Cm, dt, _ = _ssd_inputs(1, S, 16, 64, 128, cuda, seed=S)
    ins = (xh, Bm, Cm, dt, -torch.linspace(1.0, 16.0, 16, device=cuda))
    y, h = ssd_scan_with_state(*ins, chunk=Q)
    yc, hc = ssd_chunked(*ins, chunk=Q)
    y64, h64 = ssd_sequential_ref(*(t.double() for t in ins))
    torch.testing.assert_close(y.double(), y64, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(h.double(), h64, atol=1e-4, rtol=1e-3)
    for k, c, r in ((y, yc, y64), (h, hc, h64)):
        assert (k.double() - r).abs().max() <= 2 * (c.double() - r).abs().max()


# -- the dense RoPE family and the MoE FFN at full width: the shapes their
# paths give the kernels (yi-9b's q and v at d 4096 with 4 KV heads of 128,
# minicpm-2b's d 2304, olmoe-1b-7b's d 2048; decode at 8 slots x 512)

NEW_WIDTHS = [(8, 4096, 4096, 4), (16, 4096, 4096, 4), (8, 4096, 512, 4),
              (16, 4096, 512, 4), (8, 2304, 2304, 4), (16, 2048, 2048, 4),
              (768, 4096, 512, 4), (768, 2304, 2304, 4), (768, 2048, 2048, 4)]


@pytest.mark.parametrize("M,K,N,r", NEW_WIDTHS)
def test_lora_kernels_at_the_new_widths(cuda, M, K, N, r):
    """The forward at decode, chunk and training M; dX and the rank reduce
    at the training M (the SFL round's 3 clients x 4 x 64 tokens)."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g).to(cuda)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda)
    a = (torch.randn(r, K, generator=g) * r ** -0.5).to(cuda)
    b = (torch.randn(N, r, generator=g) * 0.05).to(cuda)
    y = _one_launch_twice("lora_matmul", lambda: lora_matmul_kernel(x, w, a, b, 2.0))
    torch.testing.assert_close(y, lora_matmul_ref(x, w, a, b, 2.0), atol=1e-4, rtol=1e-4)
    if M > DECODE_MAX_M:
        dy = torch.randn(M, N, generator=g).to(cuda)
        dx = _one_launch_twice("lora_matmul_dx",
                               lambda: lora_matmul_dx_kernel(dy, w, a, b, 2.0))
        torch.testing.assert_close(dx, lora_matmul_dx_ref(dy, w, a, b, 2.0),
                                   atol=1e-4, rtol=1e-4)
        u = torch.randn(M, r, generator=g).to(cuda)
        ur = _one_launch_twice("lora_rank_reduce", lambda: lora_rank_reduce_kernel(u, dy))
        torch.testing.assert_close(ur, lora_rank_reduce_ref(u, dy), atol=1e-4 * M ** 0.5,
                                   rtol=1e-4)


# (KH, G, D): yi-9b (G 8, D 128), olmoe-1b-7b (16 KV heads of 128), minicpm-2b
# (36 of 64), deepseek-7b (32 of 128); llama4-scout's G 5 and mistral-large's
# G 12 (reduced only on one card) go through the wrappers too: a group over
# the plan's 8 heads a block is split into ragged groups
NEW_HEAD_GROUPS = [(4, 8, 128), (16, 1, 128), (36, 1, 64), (32, 1, 128), (8, 5, 128),
                   (8, 12, 128)]
NEW_LENGTHS = [0, 1, 16, 17, 512, 31, 3, 511]


@pytest.mark.parametrize("KH,G,D", NEW_HEAD_GROUPS)
def test_decode_kernels_at_the_new_head_groups(cuda, KH, G, D):
    o = _paged_split_case(cuda, torch.float32, 8, KH, G, D, 16, 32, NEW_LENGTHS,
                          KH * G + D, "float")
    assert o.shape == (8, KH, G, D)
    o = _flash_split_case(cuda, torch.float32, 8, KH, G, D, 512, NEW_LENGTHS, 0,
                          KH * G + D + 1)
    assert (o[0] == 0).all()


# -- the modality front ends at full width: InternVL2-2B (d 2048, q 2048,
# v 1024 over 8 KV heads of 128, G 2) and MusicGen-Large (d 2048, q and v
# 2048, 32 KV heads of 64, G 1) with their prefixes of 256 and 64 rows:
# decode M 4, a client's training M b * (F + S) (4 x 320, 4 x 128) and the
# server's pooled 3 clients' worth (3840, 1536)

FRONTEND_WIDTHS = [(4, 2048, 2048, 4), (4, 2048, 1024, 4), (1280, 2048, 2048, 4),
                   (1280, 2048, 1024, 4), (3840, 2048, 1024, 4), (512, 2048, 2048, 4),
                   (1536, 2048, 2048, 4)]


@pytest.mark.parametrize("M,K,N,r", FRONTEND_WIDTHS)
def test_lora_kernels_at_the_front_end_widths(cuda, M, K, N, r):
    test_lora_kernels_at_the_new_widths(cuda, M, K, N, r)


# (KH, G, D, L): generate()'s slab caches of F + S + new positions: 256 +
# 48 + 32 for InternVL2, 64 + 48 + 32 for MusicGen; 4 prompts at lengths
# from the prefix alone to the last decode step's
FRONTEND_HEAD_GROUPS = [(8, 2, 128, 336, [256, 304, 305, 335]),
                        (32, 1, 64, 144, [64, 112, 113, 143])]


@pytest.mark.parametrize("KH,G,D,L,lengths", FRONTEND_HEAD_GROUPS,
                         ids=["internvl2-2b", "musicgen-large"])
def test_flash_decode_at_the_front_end_head_groups(cuda, KH, G, D, L, lengths):
    o = _flash_split_case(cuda, torch.float32, 4, KH, G, D, L, lengths, 0, KH * G + D)
    assert o.shape == (4, KH, G, D) and bool(torch.isfinite(o).all())


# ---------------------------------------------------------------------------
# the multi-device path's collectives with CUDA tensors
# ---------------------------------------------------------------------------

_COLLECTIVE_RANK = r"""
import sys, torch
sys.path.insert(0, sys.argv[5])
from repro_torch.launch.mesh import init_file_store, make_debug_mesh
from repro_torch.sharding import collectives as C
rank, world, store, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = init_file_store(store, rank, world, device="cuda", backend=backend)
mesh = make_debug_mesh(1, world, device=dev)
g = mesh.group("model")
x = torch.arange(6.0, device=dev).reshape(3, 2) + 10 * rank
s = C.all_reduce(x, g)
want = sum(torch.arange(6.0, device=dev).reshape(3, 2) + 10 * r for r in range(world))
assert s.is_cuda and torch.equal(s, want), s
a = C.all_gather(x, g, dim=1)
assert a.is_cuda and a.shape == (3, 2 * world) and torch.equal(a[:, 2 * rank:2 * rank + 2], x)
t = torch.arange(4.0 * world, device=dev) + 100 * rank
o = C.all_to_all(t, g)
assert o.is_cuda and all(torch.equal(o[4 * r:4 * r + 4], torch.arange(4.0 * rank, 4.0 * rank + 4,
                                                                      device=dev) + 100 * r)
                         for r in range(world))
tl = t.clone().requires_grad_()
(C.all_to_all_grad(tl, g) * torch.arange(4.0 * world, device=dev)).sum().backward()
assert tl.grad.is_cuda and torch.equal(tl.grad, C.all_to_all(torch.arange(4.0 * world,
                                                                          device=dev), g))
print("RANK", rank, "OK", mesh.staged)
"""


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_collectives_carry_cuda_tensors(cuda, tmp_path, world, backend):
    """all_reduce, all_gather (dim 1), the equal-split all_to_all and its
    differentiable form on CUDA tensors: over a one-rank
    NCCL group, and over gloo between two ranks sharing the card (staged
    through host memory, which the mesh reports)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen([sys.executable, "-c", _COLLECTIVE_RANK, str(r), str(world),
                               str(tmp_path / "store"), backend, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK {r} OK {backend == 'gloo'}" in out, out[-2000:]


# -- the launch-plan tuners (kernels/lora_matmul/tune.py,
# kernels/flash_attention/tune.py): every candidate a tuner may pick gives
# the heuristic plan's bits, since each keeps its order of addition

TUNE_LORA = [("forward", 8, 768, 768, 4), ("forward", 200, 768, 768, 4),
             ("forward", 768, 768, 768, 4), ("forward", 200, 2560, 10576, 4),
             ("forward", 1280, 2048, 2048, 4), ("forward", 33, 300, 129, 64),
             ("dx", 256, 768, 768, 4), ("dx", 33, 300, 129, 8), ("dx", 512, 5504, 4096, 4),
             ("q8", 256, 768, 768, 8), ("q8", 200, 5120, 2560, 8),
             ("q8_dx", 768, 768, 770, 8), ("gather", 8, 768, 768, 4),
             ("gather", 40, 768, 768, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("problem,M,K,N,r", TUNE_LORA)
def test_every_lora_tuner_candidate_gives_the_heuristic_plans_bits(cuda, dtype, problem,
                                                                   M, K, N, r):
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.lora_matmul import tune
    g = torch.Generator().manual_seed(M + K + N)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(cuda, dtype)

    a, b = rnd(r, K, std=r ** -0.5), rnd(N, r, std=0.05)
    int8 = problem in ("q8", "q8_dx")
    if int8:
        w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(cuda)
        ws = (torch.rand(N, generator=g) * 0.01).to(cuda)
    else:
        w = rnd(K, N, std=K ** -0.5)
    if problem in ("dx", "q8_dx"):
        lhs, out = rnd(M, N), torch.empty(M, K, dtype=dtype, device=cuda)
        launch = ((lambda p: lops.launch_q8_dx(lhs, w, ws, a, b, out, 2.0, p)) if int8
                  else (lambda p: lops.launch_dx(lhs, w, a, b, out, 2.0, p)))
    else:
        lhs, out = rnd(M, K), torch.empty(M, N, dtype=dtype, device=cuda)
        if problem == "gather":
            ap, bp = rnd(3, r, K, std=r ** -0.5), rnd(3, N, r, std=0.05)
            idx = (torch.arange(M, dtype=torch.int32) % 3).to(cuda)
            launch = (lambda p: lops.launch_gather(lhs, w, ap, bp, idx, out, 2.0, p))
        elif int8:
            launch = (lambda p: lops.launch_q8(lhs, w, ws, a, b, out, 2.0, p))
        else:
            launch = (lambda p: lops.launch_forward(lhs, w, a, b, out, 2.0, p))
    plan = tune.heuristic_plan("dx" if problem in ("dx", "q8_dx") else "forward", M, K, N,
                               dtype.itemsize, int8, True)
    cands = tune.candidates(plan, M, dtype.itemsize, 1 if int8 else dtype.itemsize,
                            problem in ("dx", "q8_dx"))
    assert len(cands) > 1
    outs = []
    for p in cands:
        launch(p)
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert torch.isfinite(outs[0].float()).all()
    bad = [p for p, o in zip(cands, outs) if not torch.equal(o, outs[0])]
    assert not bad, f"{problem} M={M} K={K} N={N}: {bad} differ from {plan}"


TUNE_DECODE = [(8, 4, 4, 64, 512), (4, 8, 2, 128, 512), (3, 2, 3, 42, 300),
               (2, 2, 2, 256, 1000), (4, 4, 4, 128, 65)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,L", TUNE_DECODE)
def test_every_decode_tuner_candidate_gives_the_heuristic_plans_bits(cuda, dtype, B, KH, G,
                                                                     D, L):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import tune
    from repro_torch.kernels.flash_attention.plan import decode_plan
    g = torch.Generator().manual_seed(B * L + D)
    q = torch.randn(B, KH, G, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, L, KH, D, generator=g).to(cuda, dtype)
    lens = torch.randint(0, L + 2, (B,), generator=g, dtype=torch.int32).to(cuda)
    PS = 16
    MP = -(-L // PS)
    kp = torch.randn(KH, B * MP + 1, PS, D, generator=g).to(cuda, dtype)
    vp = torch.randn(KH, B * MP + 1, PS, D, generator=g).to(cuda, dtype)
    bt = (torch.randperm(B * MP, generator=g).int() + 1).reshape(B, MP).to(cuda)
    plens = torch.clamp(lens, max=MP * PS)
    out = torch.empty_like(q)
    for window, paged in ((0, False), (37, False), (0, True)):
        plan = decode_plan(MP * PS if paged else L, B, KH, G, D, dtype)
        cands = tune.candidates(plan, G, dtype)
        outs = []
        for p in cands:
            if paged:
                fops.launch_paged(q, kp, vp, plens, bt, out, p)
            else:
                fops.launch_slab(q, k, v, lens, out, window, p)
            torch.cuda.synchronize()
            outs.append(out.clone())
        bad = [p for p, o in zip(cands, outs) if not torch.equal(o, outs[0])]
        assert not bad, f"paged={paged} window={window}: {bad} differ from {plan}"


def test_the_tuners_memoize_on_the_card_and_count_nothing(cuda):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import best_decode_block
    from repro_torch.kernels.flash_attention import clear_cache as clear_decode_cache
    from repro_torch.kernels.lora_matmul import best_blocks, best_gather_blocks, clear_cache
    clear_cache()
    clear_decode_cache()
    before = dict(backend.LAUNCH_COUNTS)
    autotune.reset_stats()
    p = best_blocks(200, 768, 768, 4, torch.float32, cuda)
    g = best_gather_blocks(40, 768, 768, 4, 3, torch.float32, torch.int32, cuda)
    d = best_decode_block(8, 4, 4, 512, 64, torch.float32, cuda)
    timed = dict(autotune.STATS)
    assert timed["keys"] >= 1 and timed["launches"] > 0
    assert best_blocks(200, 768, 768, 4, torch.float32, cuda) is p
    assert best_gather_blocks(40, 768, 768, 4, 3, torch.float32, torch.int32, cuda) is g
    assert best_decode_block(8, 4, 4, 512, 64, torch.float32, cuda) is d
    assert autotune.STATS == timed and dict(backend.LAUNCH_COUNTS) == before
