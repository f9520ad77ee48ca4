"""Attention kernel entries: layout, device routing, checks and the kernel
launches.  A CUDA tensor launches ``csrc/paged_decode.cu`` (float and
int8 pools), ``csrc/flash_decode.cu`` (float and int8 slab caches; both
with ``plan.decode_plan``'s split), ``csrc/decode_partial.cu`` (the
partial softmax over a piece of a slab cache, ``plan.partial_plan``) or
``csrc/flash_attention.cu``; a CPU tensor takes the plain version of
``ref.py``.  ``repro``'s ``bk``, ``interpret`` and ``use_kernel``
arguments are gone: the device alone routes, and the four split-K
decode launchers take their plan from ``tune.py`` (``decode_plan``'s,
or a candidate with the same order of addition that the card timed
faster).  ``launch_slab`` and ``launch_paged`` launch with a given plan
and count nothing (the tuner's timing, ``chip_smoke.py``'s
comparisons)."""
from __future__ import annotations

import ctypes

import torch

from .. import backend, build
from . import tune
from .plan import DECODE_MAX_HEAD_DIM, partial_plan
from .ref import (flash_attention_ref, flash_decode_partial_ref, flash_decode_q8_ref,
                  flash_decode_ref, paged_decode_q8_ref, paged_decode_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (library, entry) -> argtypes: pointers, then ints (the decode entries end
# theirs with decode_plan's five, the partial entry with partial_plan's
# four), the softmax scale, the dtype code and the stream
_SIGNATURES = {
    ("paged_decode", "paged_decode_launch"): (6, 12),
    ("paged_decode", "paged_decode_q8_launch"): (8, 12),
    ("flash_decode", "flash_decode_launch"): (5, 11),
    ("flash_decode", "flash_decode_q8_launch"): (7, 11),
    ("decode_partial", "flash_decode_partial_launch"): (7, 9),
    ("flash_attention", "flash_attention_launch"): (4, 8),
}


def _entry(lib: str, name: str):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[(lib, name)]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _plan_ints(p) -> tuple:
    """A DecodePlan as the C entry's five ints."""
    return p.splits, p.heads, p.lanes, p.vectors, int(p.vec)


def _kv_aligned(k: torch.Tensor, v: torch.Tensor) -> bool:
    return k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0


def launch_slab(q, k, v, lengths, out, window: int, plan, k_scale=None,
                v_scale=None) -> None:
    """One launch of ``flash_decode`` (``flash_decode_q8`` with the scales)
    with ``plan`` into ``out``, checked operands taken as they are;
    counts nothing."""
    B, KH, G, D = q.shape
    L = k.shape[1]
    dev = q.device
    with torch.cuda.device(dev):
        if k_scale is None:
            err = _entry("flash_decode", "flash_decode_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, KH, G, D, L, int(window), *_plan_ints(plan),
                D ** -0.5, _DTYPE_CODES[q.dtype], _stream(dev))
        else:
            err = _entry("flash_decode", "flash_decode_q8_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), B, KH, G, D, L,
                int(window), *_plan_ints(plan), D ** -0.5, _DTYPE_CODES[q.dtype],
                _stream(dev))
    build.check("flash_decode", err)


def launch_paged(q, k_pages, v_pages, lengths, block_tables, out, plan, k_scale=None,
                 v_scale=None) -> None:
    """One launch of ``paged_decode`` (``paged_decode_q8`` with the scales)
    with ``plan`` into ``out``; counts nothing."""
    B, KH, G, D = q.shape
    _, NP, PS, _ = k_pages.shape
    MP = block_tables.shape[1]
    dev = q.device
    with torch.cuda.device(dev):
        if k_scale is None:
            err = _entry("paged_decode", "paged_decode_launch")(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                block_tables.data_ptr(), out.data_ptr(), B, KH, G, D, NP, PS, MP,
                *_plan_ints(plan), D ** -0.5, _DTYPE_CODES[q.dtype], _stream(dev))
        else:
            err = _entry("paged_decode", "paged_decode_q8_launch")(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                block_tables.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                out.data_ptr(), B, KH, G, D, NP, PS, MP, *_plan_ints(plan), D ** -0.5,
                _DTYPE_CODES[q.dtype], _stream(dev))
    build.check("paged_decode", err)


def _paged_plan(q, k_pages, v_pages, block_tables, out, k_scale=None, v_scale=None):
    """``tune.best_paged_block``'s plan, its candidates timed on these operands."""
    B, KH, G, D = q.shape
    PS, MP = k_pages.shape[2], block_tables.shape[1]
    return tune.best_paged_block(
        B, KH, G, MP, PS, D, q.dtype, q.device, k_pages.dtype,
        aligned=_kv_aligned(k_pages, v_pages),
        run=lambda p, n: launch_paged(q, k_pages, v_pages, n, block_tables, out, p,
                                      k_scale, v_scale))


def _slab_plan(q, k, v, out, k_scale=None, v_scale=None):
    """``tune.best_decode_block``'s plan, its candidates timed on these
    operands (no window: the key has none)."""
    B, KH, G, D = q.shape
    return tune.best_decode_block(
        B, KH, G, k.shape[1], D, q.dtype, q.device, k.dtype, aligned=_kv_aligned(k, v),
        run=lambda p, n: launch_slab(q, k, v, n, out, 0, p, k_scale, v_scale))


def _on_card(op: str, **tensors: torch.Tensor) -> torch.device:
    """Every operand on q's CUDA device and contiguous, or raise."""
    dev = tensors["q"].device
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}; every operand must "
                             f"be on q's CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    return dev


def _check_kv_dtypes(op: str, q, k, v, lengths, int8: bool) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: dtype {q.dtype} not supported (float32, bfloat16)")
    want = torch.int8 if int8 else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{op}: K/V are {k.dtype}/{v.dtype}, expected {want} "
                        f"(q is {q.dtype})")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{op}: lengths must be int32")


def _check_scales(op: str, k_scale, v_scale, KH: int) -> None:
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != (KH,):
            raise ValueError(f"{op}: {name} must be float32 ({KH},) — one scale "
                             f"per KV head — got {t.dtype} {tuple(t.shape)}")


def _kv_quantized(op: str, k, v, k_scale, v_scale, KH: int) -> bool:
    """Whether an op call takes its int8-KV route; raises on a scale
    without its partner, int8 K/V without scales, scales with float K/V,
    or scales that are not float32 (KH,)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{op}: k_scale and v_scale are given together or not at all")
    int8 = (k.dtype == torch.int8, v.dtype == torch.int8)
    if k_scale is None:
        if any(int8):
            raise TypeError(f"{op}: int8 K/V need their k_scale/v_scale "
                            "(precision.quantize_kv_int8)")
        return False
    if not all(int8):
        raise TypeError(f"{op}: k_scale/v_scale given with {k.dtype}/{v.dtype} "
                        "K/V; the scales belong to an int8 K/V")
    _check_scales(op, k_scale, v_scale, KH)
    return True


def _paged_shapes(op, q, k_pages, v_pages, lengths, block_tables):
    if q.dim() != 4 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{op}: q (B, KH, G, D), pools (KH, NP, PS, D), "
                         "block_tables (B, MP) expected")
    B, KH, G, D = q.shape
    _, NP, PS, _ = k_pages.shape
    MP = block_tables.shape[1]
    if (tuple(k_pages.shape) != (KH, NP, PS, D) or v_pages.shape != k_pages.shape
            or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B):
        raise ValueError(
            f"{op}: shapes q {tuple(q.shape)} k {tuple(k_pages.shape)} "
            f"v {tuple(v_pages.shape)} lengths {tuple(lengths.shape)} "
            f"block_tables {tuple(block_tables.shape)} do not agree")
    if block_tables.dtype != torch.int32:
        raise TypeError(f"{op}: block_tables must be int32")
    return B, KH, G, D, NP, PS, MP


def paged_decode_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, lengths: torch.Tensor,
                        block_tables: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, KH, G, D) and the pools
    (KH, NP, PS, D) of one dtype (float32 or bfloat16), D <= 256, lengths
    (B,) and block_tables (B, MP) int32, all contiguous on one CUDA
    device; one cluster launch with the tuner's plan (``tune.py``).
    Returns (B, KH, G, D) in q's dtype.  Raises on anything else."""
    dev = _on_card("paged_decode", q=q, k_pages=k_pages, v_pages=v_pages,
                   lengths=lengths, block_tables=block_tables)
    _check_kv_dtypes("paged_decode", q, k_pages, v_pages, lengths, int8=False)
    B, KH, G, D, NP, PS, MP = _paged_shapes("paged_decode", q, k_pages, v_pages,
                                            lengths, block_tables)
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"paged_decode: head dim {D} over the kernel's {DECODE_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    plan = _paged_plan(q, k_pages, v_pages, block_tables, out)
    launch_paged(q, k_pages, v_pages, lengths, block_tables, out, plan)
    backend.count_launch("paged_decode")
    return out


def paged_decode_q8_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor) -> torch.Tensor:
    """Launch the int8-pool CUDA kernel: q (B, KH, G, D) float32 or
    bfloat16, int8 pools (KH, NP, PS, D), D <= 256, float32 (KH,) scales,
    lengths (B,) and block_tables (B, MP) int32, all contiguous on one
    CUDA device; one cluster launch with the tuner's plan over int8
    entries.  Returns (B, KH, G, D) in q's dtype.  Raises on anything
    else."""
    dev = _on_card("paged_decode_q8", q=q, k_pages=k_pages, v_pages=v_pages,
                   lengths=lengths, block_tables=block_tables, k_scale=k_scale,
                   v_scale=v_scale)
    _check_kv_dtypes("paged_decode_q8", q, k_pages, v_pages, lengths, int8=True)
    B, KH, G, D, NP, PS, MP = _paged_shapes("paged_decode_q8", q, k_pages, v_pages,
                                            lengths, block_tables)
    _check_scales("paged_decode_q8", k_scale, v_scale, KH)
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_q8: head dim {D} over the kernel's "
                         f"{DECODE_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    plan = _paged_plan(q, k_pages, v_pages, block_tables, out, k_scale, v_scale)
    launch_paged(q, k_pages, v_pages, lengths, block_tables, out, plan, k_scale, v_scale)
    backend.count_launch("paged_decode_q8")
    return out


# shape-only implementations and FLOP formulas (``backend.register``): q·kᵀ
# and p·v, a multiply-add two, over every position the cache can hold (a
# fake tensor has no lengths; a window caps a slab's)
def _decode_shapes(ops, args):
    return [(tuple(ops[0].shape), ops[0].dtype)]


def _slab_flops(sh, args):
    (B, KH, G, D), L = sh[0], sh[1][1]
    window = int(args[0])
    return 4 * B * KH * G * D * (min(L, window) if window else L)


def _partial_shapes(ops, args):
    B, KH, G, D = ops[0].shape
    return [((B, KH, G), torch.float32), ((B, KH, G), torch.float32),
            ((B, KH, G, D), torch.float32)]


def _partial_flops(sh, args):
    (B, KH, G, D), L = sh[0], sh[1][1]
    return 4 * B * KH * G * D * L


def _paged_flops(sh, args):
    (B, KH, G, D), (_, _, PS, _), MP = sh[0], sh[1], sh[4][1]
    return 4 * B * KH * G * D * MP * PS


def causal_pairs(Sq: int, Sk: int, window: int = 0) -> int:
    """The (query, key) pairs causal attention visits: query row i sits at
    position max(Sk - Sq, 0) + i and sees keys at and before it, within
    ``window`` of it when one is set."""
    off = max(Sk - Sq, 0)
    total = 0
    for i in range(Sq):
        hi = min(off + i, Sk - 1) + 1
        total += hi - (max(0, hi - window) if window else 0)
    return total


def _attention_flops(sh, args):
    (B, Sq, H, D), Sk = sh[0], sh[1][1]
    return 4 * B * H * D * causal_pairs(Sq, Sk, int(args[0]))


backend.register("flash_decode", _decode_shapes, _slab_flops)
backend.register("flash_decode_q8", _decode_shapes, _slab_flops)
backend.register("flash_decode_partial", _partial_shapes, _partial_flops)
backend.register("paged_decode", _decode_shapes, _paged_flops)
backend.register("paged_decode_q8", _decode_shapes, _paged_flops)
backend.register("flash_attention", _decode_shapes, _attention_flops)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 lengths: torch.Tensor, block_tables: torch.Tensor, *,
                 k_scale=None, v_scale=None) -> torch.Tensor:
    """One-token decode attention over a block-table paged KV cache.

    q: (B, 1, H, D) or (B, H, D) — the model layout; k_pages/v_pages:
    (KH, NP, PS, D); lengths: (B,) int32 live entries per slot;
    block_tables: (B, MP) int32 page ids (0 = null page).  Returns q's
    shape.  ``k_scale``/``v_scale`` (float32 (KH,), from
    ``precision.quantize_kv_int8(pool, head_axis=0)``) take the int8-pool
    route.  Routed by q's device (``kernels.backend.dispatch``)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, D = q.shape
    KH = k_pages.shape[0]
    qt = q.reshape(B, KH, H // KH, D)
    if _kv_quantized("paged_decode", k_pages, v_pages, k_scale, v_scale, KH):
        o = backend.dispatch(
            "paged_decode_q8",
            kernel=lambda: paged_decode_q8_kernel(qt.contiguous(), k_pages, v_pages,
                                                  lengths, block_tables, k_scale,
                                                  v_scale),
            ref=lambda: paged_decode_q8_ref(qt, k_pages, v_pages, k_scale, v_scale,
                                            lengths, block_tables),
            x=qt, operands=(qt, k_pages, v_pages, lengths, block_tables, k_scale, v_scale))
    else:
        o = backend.dispatch(
            "paged_decode",
            kernel=lambda: paged_decode_kernel(qt.contiguous(), k_pages, v_pages,
                                               lengths, block_tables),
            ref=lambda: paged_decode_ref(qt, k_pages, v_pages, lengths, block_tables),
            x=qt, operands=(qt, k_pages, v_pages, lengths, block_tables))
    o = o.reshape(B, H, D)
    return o[:, None] if squeeze else o


def _slab_shapes(op, q, k, v, lengths, window):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{op}: q (B, KH, G, D) and k/v (B, L, KH, D) expected")
    B, KH, G, D = q.shape
    L = k.shape[1]
    if (tuple(k.shape) != (B, L, KH, D) or v.shape != k.shape
            or tuple(lengths.shape) != (B,) or L == 0):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} lengths {tuple(lengths.shape)} "
                         "do not agree")
    if window < 0:
        raise ValueError(f"{op}: window {window} < 0")
    return B, KH, G, D, L


def flash_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the model's cache layout, read in place:
    q (B, KH, G, D), k/v (B, L, KH, D) of q's dtype (float32 or
    bfloat16), D <= 256, lengths (B,) int32, all contiguous on one CUDA
    device; one cluster launch with the tuner's plan (``tune.py``).  A
    length past L reads all L entries.  Returns (B, KH, G, D) in q's
    dtype.  Raises on anything else."""
    dev = _on_card("flash_decode", q=q, k=k, v=v, lengths=lengths)
    _check_kv_dtypes("flash_decode", q, k, v, lengths, int8=False)
    B, KH, G, D, L = _slab_shapes("flash_decode", q, k, v, lengths, window)
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head dim {D} over the kernel's {DECODE_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch_slab(q, k, v, lengths, out, window, _slab_plan(q, k, v, out))
    backend.count_launch("flash_decode")
    return out


def flash_decode_partial_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lengths: torch.Tensor):
    """Launch the partial-softmax CUDA kernel on the model's cache
    layout, read in place: q (B, KH, G, D), k/v (B, L, KH, D) of q's
    dtype (float32 or bfloat16), D <= 256, lengths (B,) int32, all
    contiguous on one CUDA device; one cluster launch of
    ``csrc/decode_partial.cu`` with ``plan.partial_plan``'s split, warps
    and stages.  A length past L reads all L entries.
    Returns float32 (m (B, KH, G), l (B, KH, G), o (B, KH, G, D)): the
    largest scaled score of the live keys, the sum of exp(s - m) and the
    unnormalised sum of exp(s - m) v (no live key: -1e30, 0, 0).  Raises
    on anything else."""
    dev = _on_card("flash_decode_partial", q=q, k=k, v=v, lengths=lengths)
    _check_kv_dtypes("flash_decode_partial", q, k, v, lengths, int8=False)
    B, KH, G, D, L = _slab_shapes("flash_decode_partial", q, k, v, lengths, 0)
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"flash_decode_partial: head dim {D} over the kernel's "
                         f"{DECODE_MAX_HEAD_DIM}")
    m = torch.empty((B, KH, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return m, l, o
    p = partial_plan(L, B, KH, G, D, q.dtype,
                     aligned=k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = _entry("decode_partial", "flash_decode_partial_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr(), B, KH, G, D, L, p.splits, p.warps, p.stages,
            int(p.vec), D ** -0.5, _DTYPE_CODES[q.dtype], _stream(dev))
    build.check("decode_partial", err)
    backend.count_launch("flash_decode_partial")
    return m, l, o


def flash_decode_q8_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Launch the int8-KV CUDA kernel: q (B, KH, G, D) float32 or
    bfloat16, int8 k/v (B, L, KH, D) read in place, D <= 256, float32
    (KH,) scales, lengths (B,) int32, all contiguous on one CUDA device;
    one cluster launch with the tuner's plan over int8 entries.  Returns
    (B, KH, G, D) in q's dtype.  Raises on anything else."""
    dev = _on_card("flash_decode_q8", q=q, k=k, v=v, lengths=lengths, k_scale=k_scale,
                   v_scale=v_scale)
    _check_kv_dtypes("flash_decode_q8", q, k, v, lengths, int8=True)
    B, KH, G, D, L = _slab_shapes("flash_decode_q8", q, k, v, lengths, window)
    _check_scales("flash_decode_q8", k_scale, v_scale, KH)
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"flash_decode_q8: head dim {D} over the kernel's "
                         f"{DECODE_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch_slab(q, k, v, lengths, out, window, _slab_plan(q, k, v, out, k_scale, v_scale),
                k_scale, v_scale)
    backend.count_launch("flash_decode_q8")
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, window: int = 0, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """One-token decode attention over per-slot slab KV caches.

    q: (B, 1, H, D) or (B, H, D); k/v: (B, L, KH, D) — the model cache
    layout of ``models.attention``, which the kernel reads in place;
    lengths: (B,) int32 live entries per slot, contiguous at [0, length)
    (ring-wrapped windowed caches take ``decode_masked_attention``);
    ``window`` drops entries ``k_idx <= length - 1 - window``.
    ``k_scale``/``v_scale`` (float32 (KH,), from
    ``precision.quantize_kv_int8(kv, head_axis=2)``) take the int8-KV
    route.  Returns q's shape.  Routed by q's device
    (``kernels.backend.dispatch``)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, D = q.shape
    KH = k.shape[2]
    qt = q.reshape(B, KH, H // KH, D)
    if _kv_quantized("flash_decode", k, v, k_scale, v_scale, KH):
        o = backend.dispatch(
            "flash_decode_q8",
            kernel=lambda: flash_decode_q8_kernel(qt.contiguous(), k.contiguous(),
                                                  v.contiguous(), lengths, k_scale,
                                                  v_scale, window=window),
            ref=lambda: flash_decode_q8_ref(qt, k.transpose(1, 2), v.transpose(1, 2),
                                            k_scale, v_scale, lengths, window=window),
            x=qt, operands=(qt, k, v, lengths, k_scale, v_scale), args=(window,))
    else:
        o = backend.dispatch(
            "flash_decode",
            kernel=lambda: flash_decode_kernel(qt.contiguous(), k.contiguous(),
                                               v.contiguous(), lengths, window=window),
            ref=lambda: flash_decode_ref(qt, k.transpose(1, 2), v.transpose(1, 2),
                                         lengths, window=window),
            x=qt, operands=(qt, k, v, lengths), args=(window,))
    o = o.reshape(B, H, D)
    return o[:, None] if squeeze else o


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor):
    """The partial softmax of one-token decode attention over per-slot
    slab KV caches (or this rank's piece of caches cut by their length),
    which ``sharding.tp.lse_combine`` joins over the pieces.

    q: (B, 1, H, D) or (B, H, D); k/v: (B, L, KH, D) — the model cache
    layout, read in place by the kernel; lengths: (B,) int32 live entries
    per slot at [0, length), a length past L reading all L.  Returns
    float32 ``(m, l, o)`` of shapes (B, H), (B, H) and (B, H, D) (with
    q's singleton axis after B for a q of rank 4): the largest score
    q·k * D^-0.5 of the live keys, the sum of exp(s - m) and the
    unnormalised sum of exp(s - m) v; a slot with no live key gives m =
    -1e30, l = 0, o = 0.  Routed by q's device
    (``kernels.backend.dispatch``)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, D = q.shape
    KH = k.shape[2]
    qt = q.reshape(B, KH, H // KH, D)
    m, l, o = backend.dispatch(
        "flash_decode_partial",
        kernel=lambda: flash_decode_partial_kernel(qt.contiguous(), k.contiguous(),
                                                   v.contiguous(), lengths),
        ref=lambda: flash_decode_partial_ref(qt, k.transpose(1, 2), v.transpose(1, 2),
                                             lengths),
        x=qt, operands=(qt, k, v, lengths))
    m, l, o = m.reshape(B, H), l.reshape(B, H), o.reshape(B, H, D)
    if squeeze:
        return m[:, None], l[:, None], o[:, None]
    return m, l, o


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
        err = _entry("flash_attention", "flash_attention_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             B, Sq, Sk, H, KH, D, max(Sk - Sq, 0), int(window),
                             D ** -0.5, _DTYPE_CODES[q.dtype],
                             _stream(dev))
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
        ref=lambda: flash_attention_ref(q, k, v, window=window), x=q,
        operands=(q, k, v), args=(window,))
