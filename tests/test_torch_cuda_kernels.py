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
from repro_torch.kernels.flash_attention import (paged_decode,  # noqa: E402
                                                 paged_decode_kernel,
                                                 paged_decode_ref)
from repro_torch.kernels.lora_matmul import (lora_matmul,   # noqa: E402
                                             lora_matmul_kernel, lora_matmul_ref)
from repro_torch.models import init_lora_stack, init_params  # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,r", [(8, 768, 768, 4), (16, 768, 768, 4),
                                     (5, 100, 70, 3), (33, 300, 129, 64), (1, 7, 1, 1)])
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
