"""Attention kernel entries: layout, device routing, checks and the kernel
launches.  A CUDA tensor launches ``csrc/paged_decode.cu`` or
``csrc/flash_attention.cu``; a CPU tensor takes ``paged_decode_ref`` or
``flash_attention_ref``."""
from __future__ import annotations

import ctypes

import torch

from .. import backend, build
from .ref import flash_attention_ref, paged_decode_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = build.load("paged_decode").paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, lengths: torch.Tensor,
                        block_tables: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, KH, G, D) and the pools
    (KH, NP, PS, D) of one dtype (float32 or bfloat16), lengths (B,) and
    block_tables (B, MP) int32, all contiguous on one CUDA device.
    Returns (B, KH, G, D) in q's dtype.  Raises on anything else."""
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths), ("block_tables", block_tables)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"paged_decode: {name} is on {t.device}; every "
                             f"operand must be on q's CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_decode: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode: pools are {k_pages.dtype}/"
                        f"{v_pages.dtype}, q is {q.dtype}")
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_decode: lengths and block_tables must be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("paged_decode: q (B, KH, G, D), pools (KH, NP, PS, D), "
                         "block_tables (B, MP) expected")
    B, KH, G, D = q.shape
    _, NP, PS, _ = k_pages.shape
    MP = block_tables.shape[1]
    if (tuple(k_pages.shape) != (KH, NP, PS, D) or v_pages.shape != k_pages.shape
            or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B):
        raise ValueError(
            f"paged_decode: shapes q {tuple(q.shape)} k {tuple(k_pages.shape)} "
            f"v {tuple(v_pages.shape)} lengths {tuple(lengths.shape)} "
            f"block_tables {tuple(block_tables.shape)} do not agree")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
                       B, KH, G, D, NP, PS, MP, D ** -0.5, _DTYPE_CODES[q.dtype],
                       torch.cuda.current_stream(dev).cuda_stream)
    build.check("paged_decode", err)
    backend.count_launch("paged_decode")
    return out


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 lengths: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """One-token decode attention over a block-table paged KV cache.

    q: (B, 1, H, D) or (B, H, D) — the model layout; k_pages/v_pages:
    (KH, NP, PS, D); lengths: (B,) int32 live entries per slot;
    block_tables: (B, MP) int32 page ids (0 = null page).  Returns q's
    shape.  Routed by q's device (``kernels.backend.dispatch``)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, D = q.shape
    KH = k_pages.shape[0]
    qt = q.reshape(B, KH, H // KH, D)
    o = backend.dispatch(
        "paged_decode",
        kernel=lambda: paged_decode_kernel(qt.contiguous(), k_pages, v_pages,
                                           lengths, block_tables),
        ref=lambda: paged_decode_ref(qt, k_pages, v_pages, lengths, block_tables),
        x=qt)
    o = o.reshape(B, H, D)
    return o[:, None] if squeeze else o


def _flash_entry():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


FLASH_MAX_HEAD_DIM = 128           # DMAX in csrc/flash_attention.cu


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the model layout: q (B, Sq, H, D), k/v
    (B, Sk, KH, D), contiguous on one CUDA device, of one dtype (float32
    or bfloat16), H a multiple of KH, D <= 128.  Query row i sits at
    position max(Sk - Sq, 0) + i.  Returns (B, Sq, H, D) in q's dtype.
    Raises on anything else."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; every "
                             f"operand must be on q's CUDA device {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous 4-D "
                             f"tensor, got shape {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or KH == 0
            or H % KH):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not agree")
    if not 1 <= D <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"[1, {FLASH_MAX_HEAD_DIM}]")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        err = _flash_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             B, Sq, Sk, H, KH, D, max(Sk - Sq, 0), int(window),
                             D ** -0.5, _DTYPE_CODES[q.dtype],
                             torch.cuda.current_stream(dev).cuda_stream)
    build.check("flash_attention", err)
    backend.count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal GQA attention, forward only (as in JAX).  q: (B, Sq, H, D);
    k/v: (B, Sk, KH, D) — the model layout; query row i sits at absolute
    position max(Sk - Sq, 0) + i.  Routed by q's device
    (``kernels.backend.dispatch``).  No model path calls it: training
    attention is plain PyTorch (``models.attention``), as it is jnp in
    JAX."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only (as in repro); "
                           "use models.attention.online_attention to train")
    return backend.dispatch(
        "flash_attention",
        kernel=lambda: flash_attention_kernel(q.contiguous(), k.contiguous(),
                                              v.contiguous(), window=window),
        ref=lambda: flash_attention_ref(q, k, v, window=window), x=q)
