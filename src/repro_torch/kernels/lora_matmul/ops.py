"""Fused LoRA matmul entry: device routing, checks and the kernel launch.

``lora_matmul`` is what ``models.layers.dense(..., impl="fused")`` routes
every LoRA-adapted projection through.  A CUDA tensor launches the
hand-written kernel in ``csrc/lora_matmul.cu``; a CPU tensor takes
``lora_matmul_ref``.  Forward only: serving never differentiates, and an
input that requires grad raises (the ``torch.autograd.Function`` with the
dX and rank-reduce backward kernels belongs to the training path).
"""
from __future__ import annotations

import ctypes

import torch

from .. import backend, build
from .ref import lora_matmul_ref

MAX_RANK = 64                      # RMAX in csrc/lora_matmul.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = build.load("lora_matmul")
    fn = lib.lora_matmul_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lora_matmul_kernel(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on 2-D operands x (M, K), w (K, N),
    a (r, K), b (N, r): all on one CUDA device, contiguous, and of one
    dtype (float32 or bfloat16).  Raises on anything else."""
    dev = x.device
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"lora_matmul: {name} is on {t.device}; every "
                             f"operand must be on x's CUDA device {dev}")
        if t.dtype != x.dtype:
            raise TypeError(f"lora_matmul: {name} is {t.dtype}, x is {x.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"lora_matmul: {name} must be a contiguous 2-D "
                             f"tensor, got shape {tuple(t.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_matmul: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    M, K = x.shape
    N = w.shape[1]
    r = a.shape[0]
    if w.shape[0] != K or a.shape[1] != K or tuple(b.shape) != (N, r):
        raise ValueError(
            f"lora_matmul: shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"a {tuple(a.shape)} b {tuple(b.shape)} do not agree")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul: rank {r} outside [1, {MAX_RANK}]")
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return y
    with torch.cuda.device(dev):
        err = _entry()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                       y.data_ptr(), M, K, N, r, float(scale),
                       _DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check("lora_matmul", err)
    backend.count_launch("lora_matmul")
    return y


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """y = x @ w + scale * (x @ a^T) @ b^T with any leading dims on x.

    x: (..., K); w: (K, N); a: (r, K); b: (N, r).  Routed by x's device
    (``kernels.backend.dispatch``)."""
    if any(t.requires_grad for t in (x, w, a, b)):
        raise RuntimeError("lora_matmul is forward-only in the serving port; "
                           "call it on tensors that do not require grad")
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    y = backend.dispatch(
        "lora_matmul",
        kernel=lambda: lora_matmul_kernel(x2, w, a, b, scale),
        ref=lambda: lora_matmul_ref(x2, w, a, b, scale),
        x=x2)
    return y.reshape(*lead, N)
