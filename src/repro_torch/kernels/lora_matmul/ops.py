"""Fused LoRA matmul entry: device routing, checks, the kernel launches and
the autograd backward.

``lora_matmul`` is what ``models.layers.dense(..., impl="fused")`` routes
every LoRA-adapted projection through.  It is differentiable through
``_FusedLoraMatmul``, the twin of ``repro``'s custom VJP
(``repro.kernels.lora_matmul.ops._bwd_value``):

* forward  — ``csrc/lora_matmul.cu`` on a CUDA tensor (the regime and
  split from ``plan.py``), ``lora_matmul_ref`` on a CPU one;
* backward — dX through ``csrc/lora_matmul_bwd.cu::lora_matmul_dx`` (only
  when x needs a gradient), dA = s·(dY·B)ᵀ·x and dBᵀ = (x·Aᵀ)ᵀ·dY through
  ``lora_rank_reduce`` from the same source (the rank-thin z = x·Aᵀ and
  z2 = dY·B are plain matmuls, as JAX computes them outside any kernel),
  and dW as a plain matmul only when W needs a gradient (JAX leaves it
  to XLA, which drops it for a frozen W).

``lora_matmul_gathered`` is the multi-tenant forward (row m wears adapter
``idx[m]`` of a pool): ``csrc/lora_matmul.cu``'s gather entry on a CUDA
tensor, ``lora_matmul_gathered_ref`` on a CPU one; forward only, as the
serving decode never differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from .. import backend, build
from .plan import dx_plan, forward_plan, q8_dx_plan, q8_forward_plan, rank_reduce_plan
from .ref import (acc_dtype, lora_matmul_dx_ref, lora_matmul_gathered_ref,
                  lora_matmul_q8_dx_ref, lora_matmul_q8_ref, lora_matmul_ref,
                  lora_rank_reduce_ref)

MAX_RANK = 64                      # RMAX in csrc/lora_matmul{,_bwd,_q8}.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: str, name: str, argtypes):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(op: str, dev: torch.device, dtype, **tensors) -> None:
    """Raise unless every operand is a contiguous 2-D tensor on ``dev``
    (a CUDA device), of ``dtype`` when one is given."""
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}; every operand must "
                             f"be on the CUDA device {dev}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")


def _check_rank(op: str, r: int) -> None:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{op}: rank {r} outside [1, {MAX_RANK}]")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned(*tensors) -> bool:
    """Every streamed operand starts on a 16-byte boundary (16-byte copies
    allowed; the plan also needs row pitches of whole 16-byte units)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _plan_args(plan) -> tuple:
    return (plan.regime, plan.row_tile, plan.col_tile, plan.splits, int(plan.vec))


_FWD_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]      # the plan, the stream


def lora_matmul_kernel(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, scale: float, regime: int = None) -> torch.Tensor:
    """Launch the forward CUDA kernel on 2-D operands x (M, K), w (K, N),
    a (r, K), b (N, r): all on one CUDA device, contiguous, and of one
    dtype (float32 or bfloat16).  M picks the regime (``plan.py``);
    ``regime`` forces one, for the crossover sweep.  Raises on anything
    else."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_matmul: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    _check("lora_matmul", x.device, x.dtype, x=x, w=w, a=a, b=b)
    M, K = x.shape
    N = w.shape[1]
    r = a.shape[0]
    if w.shape[0] != K or a.shape[1] != K or tuple(b.shape) != (N, r):
        raise ValueError(
            f"lora_matmul: shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"a {tuple(a.shape)} b {tuple(b.shape)} do not agree")
    _check_rank("lora_matmul", r)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    plan = forward_plan(M, K, N, x.element_size(), _aligned(x, w), regime)
    fn = _bind("lora_matmul", "lora_matmul_fwd_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
               + [ctypes.c_float, ctypes.c_int] + _FWD_PLAN_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 y.data_ptr(), M, K, N, r, float(scale), _DTYPE_CODES[x.dtype],
                 *_plan_args(plan), _stream(x.device))
    build.check("lora_matmul", err)
    backend.count_launch("lora_matmul")
    return y


def lora_matmul_gather_kernel(x: torch.Tensor, w: torch.Tensor, a_pool: torch.Tensor,
                              b_pool: torch.Tensor, idx: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Launch the gather forward: x (M, K), w (K, N), a_pool (A, r, K),
    b_pool (A, N, r) of one dtype (float32 or bfloat16), idx (M,) int32;
    all contiguous on one CUDA device.  Returns y (M, N) in x's dtype.
    ``idx`` stays on the device (no host read); an index outside the pool
    gives a NaN row, as the plain version's.  Raises on anything else."""
    op = "lora_matmul_gather"
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: dtype {x.dtype} not supported (float32, bfloat16)")
    _check(op, x.device, x.dtype, x=x, w=w)
    for name, t, dt, nd in (("a_pool", a_pool, x.dtype, 3), ("b_pool", b_pool, x.dtype, 3),
                            ("idx", idx, torch.int32, 1)):
        if t.device != x.device:
            raise ValueError(f"{op}: {name} is on {t.device}; every operand must be "
                             f"on the CUDA device {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {dt}")
        if t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous {nd}-D tensor, got "
                             f"shape {tuple(t.shape)}")
    M, K = x.shape
    N = w.shape[1]
    A, r = a_pool.shape[:2]
    if (w.shape[0] != K or tuple(a_pool.shape) != (A, r, K)
            or tuple(b_pool.shape) != (A, N, r) or tuple(idx.shape) != (M,) or A < 1):
        raise ValueError(
            f"{op}: shapes x {tuple(x.shape)} w {tuple(w.shape)} a_pool "
            f"{tuple(a_pool.shape)} b_pool {tuple(b_pool.shape)} idx "
            f"{tuple(idx.shape)} do not agree")
    _check_rank(op, r)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    plan = forward_plan(M, K, N, x.element_size(), _aligned(x, w))
    fn = _bind("lora_matmul", "lora_matmul_gather_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_int] + _FWD_PLAN_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(),
                 idx.data_ptr(), y.data_ptr(), M, K, N, r, A, float(scale),
                 _DTYPE_CODES[x.dtype], *_plan_args(plan), _stream(x.device))
    build.check("lora_matmul", err)
    backend.count_launch(op)
    return y


def lora_matmul_dx_kernel(dy: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the dX kernel: dy (M, N), w (K, N), a (r, K), b (N, r), all
    contiguous on one CUDA device and of dy's dtype (float32 or
    bfloat16).  Returns dX (M, K) in dy's dtype.  Raises on anything
    else."""
    if dy.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_matmul_dx: dtype {dy.dtype} not supported "
                        "(float32, bfloat16)")
    _check("lora_matmul_dx", dy.device, dy.dtype, dy=dy, w=w, a=a, b=b)
    M, N = dy.shape
    K = w.shape[0]
    r = a.shape[0]
    if w.shape[1] != N or a.shape[1] != K or tuple(b.shape) != (N, r):
        raise ValueError(
            f"lora_matmul_dx: shapes dy {tuple(dy.shape)} w {tuple(w.shape)} "
            f"a {tuple(a.shape)} b {tuple(b.shape)} do not agree")
    _check_rank("lora_matmul_dx", r)
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if M == 0 or K == 0:
        return dx
    plan = dx_plan(M, K, N, dy.element_size(), _aligned(dy, w))
    fn = _bind("lora_matmul_bwd", "lora_matmul_dx_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
               + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 dx.data_ptr(), M, K, N, r, float(scale), _DTYPE_CODES[dy.dtype],
                 plan.row_tile, plan.col_tile, plan.splits, int(plan.vec),
                 _stream(dy.device))
    build.check("lora_matmul_bwd", err)
    backend.count_launch("lora_matmul_dx")
    return dx


def lora_rank_reduce_kernel(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the rank-reduce kernel: u (M, r) float32, v (M, N) float32
    or bfloat16, both contiguous on one CUDA device.  Returns u^T v as
    (r, N) float32 from one launch (the plan of ``plan.rank_reduce_plan``),
    summed in a fixed order (no atomics).  Raises on anything else."""
    _check("lora_rank_reduce", u.device, torch.float32, u=u)
    _check("lora_rank_reduce", u.device, None, v=v)
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_rank_reduce: v dtype {v.dtype} not supported "
                        "(float32, bfloat16)")
    M, r = u.shape
    N = v.shape[1]
    if v.shape[0] != M:
        raise ValueError(f"lora_rank_reduce: u {tuple(u.shape)} and v "
                         f"{tuple(v.shape)} disagree on M")
    _check_rank("lora_rank_reduce", r)
    if M == 0 or N == 0:
        return torch.zeros((r, N), dtype=torch.float32, device=u.device)
    lib = "lora_matmul_bwd"
    plan = rank_reduce_plan(M, r, N, v.dtype, _aligned(v))
    out = torch.empty((r, N), dtype=torch.float32, device=u.device)
    fn = _bind(lib, "lora_rank_reduce_launch",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), v.data_ptr(), out.data_ptr(), M, r, N,
                 _DTYPE_CODES[v.dtype], plan.rank_pad, plan.cols, plan.splits,
                 int(plan.vec), _stream(u.device))
    build.check(lib, err)
    backend.count_launch("lora_rank_reduce")
    return out


def _check_q8(op: str, dev: torch.device, w_q: torch.Tensor, w_scale: torch.Tensor,
              K: int, N: int) -> None:
    """Raise unless w_q is a contiguous int8 (K, N) and w_scale a contiguous
    float32 (N,), both on the CUDA device ``dev``."""
    _check(op, dev, torch.int8, w_q=w_q)
    if tuple(w_q.shape) != (K, N):
        raise ValueError(f"{op}: w_q {tuple(w_q.shape)}, expected {(K, N)}")
    if (w_scale.device != dev or w_scale.dtype != torch.float32
            or tuple(w_scale.shape) != (N,) or not w_scale.is_contiguous()):
        raise ValueError(f"{op}: w_scale must be a contiguous float32 ({N},) tensor "
                         f"on {dev}, got {w_scale.dtype} {tuple(w_scale.shape)} on "
                         f"{w_scale.device}")


_Q8_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def lora_matmul_q8_kernel(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the int8-base forward kernel: x (M, K), w_q int8 (K, N),
    w_scale float32 (N,), a (r, K), b (N, r); x, a and b of one dtype
    (float32 or bfloat16); all contiguous on one CUDA device.  Returns y
    (M, N) in x's dtype.  Raises on anything else."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_matmul_q8: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    _check("lora_matmul_q8", x.device, x.dtype, x=x, a=a, b=b)
    M, K = x.shape
    N, r = b.shape
    _check_q8("lora_matmul_q8", x.device, w_q, w_scale, K, N)
    if tuple(a.shape) != (r, K):
        raise ValueError(f"lora_matmul_q8: shapes x {tuple(x.shape)} a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} do not agree")
    _check_rank("lora_matmul_q8", r)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    plan = q8_forward_plan(M, K, N, x.element_size(), _aligned(x, w_q))
    fn = _bind("lora_matmul_q8", "lora_matmul_q8_fwd_launch", _Q8_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), a.data_ptr(),
                 b.data_ptr(), y.data_ptr(), M, K, N, r, float(scale),
                 _DTYPE_CODES[x.dtype], plan.row_tile, plan.col_tile, plan.splits,
                 int(plan.vec), _stream(x.device))
    build.check("lora_matmul_q8", err)
    backend.count_launch("lora_matmul_q8")
    return y


def lora_matmul_q8_dx_kernel(dy: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the int8-base dX kernel: dy (M, N), w_q int8 (K, N),
    w_scale float32 (N,), a (r, K), b (N, r); dy, a and b of one dtype
    (float32 or bfloat16); all contiguous on one CUDA device.  Returns dX
    (M, K) in dy's dtype.  Raises on anything else."""
    if dy.dtype not in _DTYPE_CODES:
        raise TypeError(f"lora_matmul_q8_dx: dtype {dy.dtype} not supported "
                        "(float32, bfloat16)")
    _check("lora_matmul_q8_dx", dy.device, dy.dtype, dy=dy, a=a, b=b)
    M, N = dy.shape
    r, K = a.shape
    _check_q8("lora_matmul_q8_dx", dy.device, w_q, w_scale, K, N)
    if tuple(b.shape) != (N, r):
        raise ValueError(f"lora_matmul_q8_dx: shapes dy {tuple(dy.shape)} a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} do not agree")
    _check_rank("lora_matmul_q8_dx", r)
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if M == 0 or K == 0:
        return dx
    plan = q8_dx_plan(M, K, N, dy.element_size(), _aligned(dy, w_q, w_scale))
    fn = _bind("lora_matmul_q8", "lora_matmul_q8_dx_launch", _Q8_ARGTYPES)
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), a.data_ptr(),
                 b.data_ptr(), dx.data_ptr(), M, K, N, r, float(scale),
                 _DTYPE_CODES[dy.dtype], plan.row_tile, plan.col_tile, plan.splits,
                 int(plan.vec), _stream(dy.device))
    build.check("lora_matmul_q8", err)
    backend.count_launch("lora_matmul_q8_dx")
    return dx


def lora_flops(M: int, K: int, N: int, r: int) -> int:
    """The work of the fused forward (and of dX, the same three products
    transposed) at (M, K, N, r): x W, x Aᵀ and (x Aᵀ) Bᵀ, a multiply-add
    two."""
    return 2 * M * K * N + 2 * M * K * r + 2 * M * r * N


# shape-only implementations and FLOP formulas (``backend.register``)
def _fwd_shapes(ops, args):
    return [((ops[0].shape[0], ops[1].shape[1]), ops[0].dtype)]


def _fwd_flops(shapes, args):
    (M, K), N, r = shapes[0], shapes[1][1], shapes[-2][-2]
    return lora_flops(M, K, N, r)


def _dx_shapes(ops, args):
    return [((ops[0].shape[0], ops[1].shape[0]), ops[0].dtype)]


def _dx_flops(shapes, args):
    (M, N), K, r = shapes[0], shapes[1][0], shapes[-1][-1]
    return lora_flops(M, K, N, r)


backend.register("lora_matmul", _fwd_shapes, _fwd_flops)
backend.register("lora_matmul_q8", lambda ops, args: _fwd_shapes([ops[0], ops[1]], args),
                 lambda sh, args: _fwd_flops([sh[0], sh[1], sh[3], sh[4]], args))
backend.register("lora_matmul_gathered", _fwd_shapes,
                 lambda sh, args: _fwd_flops([sh[0], sh[1], sh[2][1:], sh[3][1:]], args))
backend.register("lora_matmul_dx", _dx_shapes, _dx_flops)
backend.register("lora_matmul_q8_dx", lambda ops, args: _dx_shapes([ops[0], ops[1]], args),
                 lambda sh, args: _dx_flops([sh[0], sh[1], sh[3], sh[4]], args))
backend.register("lora_rank_reduce",
                 lambda ops, args: [((ops[0].shape[1], ops[1].shape[1]), torch.float32)],
                 lambda sh, args: 2 * sh[0][0] * sh[0][1] * sh[1][1])


def lora_matmul_dx(dy, w, a, b, scale: float) -> torch.Tensor:
    """dX = dY Wᵀ + scale·(dY B) A, routed by dy's device (operands cast
    to dy's dtype, as JAX does before its kernel)."""
    w, a, b = (t.to(dy.dtype).contiguous() for t in (w, a, b))
    return backend.dispatch(
        "lora_matmul_dx",
        kernel=lambda: lora_matmul_dx_kernel(dy.contiguous(), w, a, b, scale),
        ref=lambda: lora_matmul_dx_ref(dy, w, a, b, scale), x=dy,
        operands=(dy, w, a, b), args=(scale,))


def lora_rank_reduce(u, v) -> torch.Tensor:
    """uᵀ v as (r, N) f32, routed by v's device."""
    return backend.dispatch(
        "lora_rank_reduce",
        kernel=lambda: lora_rank_reduce_kernel(u.float().contiguous(),
                                               v.contiguous()),
        ref=lambda: lora_rank_reduce_ref(u, v), x=v, operands=(u, v))


def lora_matmul_q8_dx(dy, w_q, w_scale, a, b, scale: float) -> torch.Tensor:
    """dX = dY (W_q s)ᵀ + scale·(dY B) A over an int8 base, routed by dy's
    device (a and b cast to dy's dtype, the scale flattened to (N,) f32)."""
    a, b = (t.to(dy.dtype).contiguous() for t in (a, b))
    ws = w_scale.reshape(-1).float().contiguous()
    return backend.dispatch(
        "lora_matmul_q8_dx",
        kernel=lambda: lora_matmul_q8_dx_kernel(dy.contiguous(), w_q.contiguous(), ws,
                                                a, b, scale),
        ref=lambda: lora_matmul_q8_dx_ref(dy, w_q, ws, a, b, scale), x=dy,
        operands=(dy, w_q, ws, a, b), args=(scale,))


def _forward(x2: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             scale: float) -> torch.Tensor:
    return backend.dispatch(
        "lora_matmul",
        kernel=lambda: lora_matmul_kernel(x2, w.contiguous(), a.contiguous(),
                                          b.contiguous(), scale),
        ref=lambda: lora_matmul_ref(x2, w, a, b, scale), x=x2,
        operands=(x2, w, a, b), args=(scale,))


class _FusedLoraMatmul(torch.autograd.Function):
    """y = x2 W + s (x2 Aᵀ) Bᵀ with the fused backward of ``_bwd_value``."""

    @staticmethod
    def forward(ctx, x2, w, a, b, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(x2, w, a, b)
        # within backend.as_ops (remat "dots") as the custom op, entered
        # above the dispatch: a recompute that takes the saved output enters
        # nothing
        return backend.launch("lora_matmul", (x2, w, a, b), (scale,),
                              lambda: _forward(x2, w, a, b, scale))

    @staticmethod
    def backward(ctx, dy):
        x2, w, a, b = ctx.saved_tensors
        scale = ctx.scale
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        dy = dy.contiguous()
        acc = acc_dtype(x2, w, a, b, dy)
        dx = dw = da = db = None
        if need_x:
            dx = lora_matmul_dx(dy, w, a, b, scale).to(x2.dtype)
        if need_w:
            dw = (x2.to(acc).T @ dy.to(acc)).to(w.dtype)
        if need_a:
            z2 = dy.to(acc) @ b.to(acc)                   # (M, r)
            da = (scale * lora_rank_reduce(z2, x2)).to(a.dtype)
        if need_b:
            z = x2.to(acc) @ a.to(acc).T                  # (M, r)
            db = (scale * lora_rank_reduce(z, dy).T).contiguous().to(b.dtype)
        return dx, dw, da, db, None


class _FusedLoraMatmulQ8(torch.autograd.Function):
    """y = x2 (W_q s) + s_l (x2 Aᵀ) Bᵀ over an int8 base, with the backward
    of ``_bwd_value_q8``: dX through the q8 dX kernel (only when x needs
    it), dA and dBᵀ through ``lora_rank_reduce``, nothing for W_q or s."""

    @staticmethod
    def forward(ctx, x2, w_q, w_scale, a, b, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(x2, w_q, w_scale, a, b)
        ws = w_scale.reshape(-1).float().contiguous()
        return backend.dispatch(
            "lora_matmul_q8",
            kernel=lambda: lora_matmul_q8_kernel(x2, w_q.contiguous(), ws,
                                                 a.to(x2.dtype).contiguous(),
                                                 b.to(x2.dtype).contiguous(), scale),
            ref=lambda: lora_matmul_q8_ref(x2, w_q, ws, a, b, scale), x=x2,
            operands=(x2, w_q, ws, a, b), args=(scale,))

    @staticmethod
    def backward(ctx, dy):
        x2, w_q, w_scale, a, b = ctx.saved_tensors
        scale = ctx.scale
        need_x, _, _, need_a, need_b = ctx.needs_input_grad[:5]
        dy = dy.contiguous()
        acc = acc_dtype(x2, a, b, dy)
        dx = da = db = None
        if need_x:
            dx = lora_matmul_q8_dx(dy, w_q, w_scale, a, b, scale).to(x2.dtype)
        if need_a:
            z2 = dy.to(acc) @ b.to(acc)                   # (M, r)
            da = (scale * lora_rank_reduce(z2, x2)).to(a.dtype)
        if need_b:
            z = x2.to(acc) @ a.to(acc).T                  # (M, r)
            db = (scale * lora_rank_reduce(z, dy).T).contiguous().to(b.dtype)
        return dx, None, None, da, db, None


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float = 1.0,
                w_scale: torch.Tensor = None) -> torch.Tensor:
    """y = x @ w + scale * (x @ a^T) @ b^T with any leading dims on x.

    x: (..., K); w: (K, N); a: (r, K); b: (N, r).  Routed by x's device
    (``kernels.backend.dispatch``); differentiable in every operand.

    ``w_scale`` switches on the weight-only int8 base: ``w`` is then an
    int8 (K, N) tensor and ``w_scale`` its f32 per-output-channel scale
    ((N,) or (1, N)); the q8 kernels take them as they are, and no
    gradient flows to either."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    if w_scale is None:
        y = _FusedLoraMatmul.apply(x2, w, a, b, float(scale))
    else:
        y = _FusedLoraMatmulQ8.apply(x2, w, w_scale, a, b, float(scale))
    return y.reshape(*lead, N)


def lora_matmul_gathered(x: torch.Tensor, w: torch.Tensor, a_pool: torch.Tensor,
                         b_pool: torch.Tensor, adapter_idx, *,
                         scale: float = 1.0) -> torch.Tensor:
    """Batched-gather LoRA matmul: row m of x wears adapter
    ``adapter_idx[m]`` of the pool.

    x: (..., K); w: (K, N); a_pool: (A, r, K); b_pool: (A, N, r);
    adapter_idx: integer, either matching x's leading dims or a (B,)
    vector broadcast over the remaining leading dims (one adapter per
    batch row: the serving-slot case), as ``repro``'s
    ``lora_matmul_gathered``.  Forward only.  Routed by x's device:
    ``lora_matmul_gather_kernel`` for a CUDA tensor (w and the pools cast
    to x's dtype, the index to int32, all on the device),
    ``lora_matmul_gathered_ref`` for a CPU one."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    ai = torch.as_tensor(adapter_idx, device=x.device)
    if tuple(ai.shape) != tuple(lead):
        ai = ai.reshape(tuple(ai.shape) + (1,) * (len(lead) - ai.dim()))
    idx = ai.expand(lead).reshape(-1)

    def kernel():
        wk, ak, bk = (t.to(x2.dtype).contiguous() for t in (w, a_pool, b_pool))
        return lora_matmul_gather_kernel(x2, wk, ak, bk,
                                         idx.to(torch.int32).contiguous(), scale)

    y = backend.dispatch(
        "lora_matmul_gathered", kernel=kernel,
        ref=lambda: lora_matmul_gathered_ref(x2, w, a_pool, b_pool, idx, float(scale)),
        x=x2, operands=(x2, w, a_pool, b_pool, idx), args=(scale,))
    return y.reshape(*lead, N)
