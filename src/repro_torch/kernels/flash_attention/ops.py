"""Paged decode attention entry: layout, device routing, checks and the
kernel launch.  A CUDA tensor launches ``csrc/paged_decode.cu``; a CPU
tensor takes ``paged_decode_ref``."""
from __future__ import annotations

import ctypes

import torch

from .. import backend, build
from .ref import paged_decode_ref

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
