"""SSD scan entries: the model layout, the pre-scaling, the padding, device
routing, checks and the kernel launches.  A CUDA tensor launches
``csrc/ssd_scan.cu`` forward and, under autograd, ``csrc/ssd_scan_bwd.cu``
backward (``_SsdScan``); a CPU tensor takes ``ref.ssd_chunked``.
``repro``'s ``interpret`` argument is gone: the device alone routes."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import backend, build
from .plan import BWD_HD_MAX, bwd_head_slices, ssd_bwd_plan, ssd_plan, vec_loads
from .ref import ssd_chunked, ssd_scan_bwd_ref, ssd_scan_ref, ssd_sequential_ref

SSD_MAX_STATE = 256                # SSD_NMAX in csrc/ssd_scan.cu


def _entry():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_entries():
    lib = build.load("ssd_scan_bwd")
    ws, fn = lib.ssd_scan_bwd_workspace, lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        ws.argtypes, ws.restype = [ctypes.c_int] * 7, ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return ws, fn


def _check_operands(op: str, xdt, g, Bm, Cm, chunk: int, extra=()):
    """The checks both kernels share; returns (B, nh, S, hd, N, Q)."""
    operands = (("xdt", xdt), ("g", g), ("Bm", Bm), ("Cm", Cm), *extra)
    for name, t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} is {t.dtype}; the kernel takes float32 "
                            "(the op casts)")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if xdt.dim() != 4:
        raise ValueError(f"{op}: xdt must be (B, nh, S, hd), got {tuple(xdt.shape)}")
    B, nh, S, hd = xdt.shape
    N = Bm.shape[-1]
    if (tuple(g.shape) != (B, nh, S) or tuple(Bm.shape) != (B, S, N)
            or Cm.shape != Bm.shape):
        raise ValueError(f"{op}: shapes xdt {tuple(xdt.shape)} g {tuple(g.shape)} "
                         f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} do not agree")
    if not 1 <= N <= SSD_MAX_STATE:
        raise ValueError(f"{op}: state size {N} outside [1, {SSD_MAX_STATE}]")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"{op}: S={S} is not a multiple of the chunk {Q} "
                         "(the op pads)")
    dev = xdt.device
    for name, t in operands:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}; every operand must "
                             f"be on xdt's CUDA device {dev}")
    return B, nh, S, hd, N, Q


def ssd_scan_kernel(xdt: torch.Tensor, g: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, *, chunk: int):
    """Launch the CUDA kernel on the kernel layout: xdt (B, nh, S, hd) =
    x * dt, g (B, nh, S) = A * dt <= 0 (the kernel's mask factors
    exp(cum_t - cum_a) exp(cum_a - cum_s) at an anchor row a stay <= 1 only
    while the prefix sums of g do not rise), Bm/Cm (B, S, N); float32,
    contiguous, on one CUDA device; S a multiple of Q = min(chunk, S); N <=
    256.  One cluster launch with ``plan.ssd_plan``'s cluster.
    Returns (y (B, nh, S, hd), h_last (B, nh, hd, N)), float32.  Raises on
    anything else."""
    B, nh, S, hd, N, Q = _check_operands("ssd_scan", xdt, g, Bm, Cm, chunk)
    dev = xdt.device
    y = torch.empty_like(xdt)
    h_last = torch.empty((B, nh, hd, N), dtype=torch.float32, device=dev)
    if xdt.numel() == 0:
        return y, h_last.zero_()
    with torch.cuda.device(dev):
        plan = ssd_plan(B, nh, S, hd, N, Q,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
        vec = vec_loads(N, hd, xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr())
        err = _entry()(xdt.data_ptr(), g.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                       y.data_ptr(), h_last.data_ptr(), B, nh, S, hd, N, Q, plan.cluster,
                       int(vec), torch.cuda.current_stream(dev).cuda_stream)
    build.check("ssd_scan", err)
    backend.count_launch("ssd_scan")
    return y, h_last


def ssd_scan_bwd_kernel(xdt: torch.Tensor, g: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, dy: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None, *, chunk: int):
    """Launch the backward kernel (``csrc/ssd_scan_bwd.cu``) on the forward's
    kernel layout: xdt, g, Bm, Cm as ``ssd_scan_kernel`` takes them, dy (B,
    nh, S, hd) the cotangent of y, dh_last (B, nh, hd, N) that of the final
    state or None (zero); float32, contiguous, on one CUDA device; S a
    multiple of Q = min(chunk, S); N <= 256.  Four launches with
    ``plan.ssd_bwd_plan``'s heads a block and instantiation.  A head dim
    over ``BWD_HD_MAX`` runs the kernel once on each slice of
    ``plan.bwd_head_slices``: y's channel p reads only xdt[..., p], so
    each slice gives its own columns of dxdt, and dg, dBm and dCm (sums
    over p) are the slices' sums, added in slice order.  Returns (dxdt,
    dg, dBm, dCm) in the layouts of xdt, g, Bm and Cm (dBm and dCm summed
    over heads), float32; two runs give equal bits.  Raises on anything
    else."""
    extra = (("dy", dy),) + (() if dh_last is None else (("dh_last", dh_last),))
    B, nh, S, hd, N, Q = _check_operands("ssd_scan_bwd", xdt, g, Bm, Cm, chunk, extra)
    if dy.shape != xdt.shape or (dh_last is not None
                                 and tuple(dh_last.shape) != (B, nh, hd, N)):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} or dh_last "
                         f"{None if dh_last is None else tuple(dh_last.shape)} does not "
                         f"match xdt {tuple(xdt.shape)} and a state of {N}")
    if hd > BWD_HD_MAX:
        parts = [ssd_scan_bwd_kernel(
            xdt[..., a:b].contiguous(), g, Bm, Cm, dy[..., a:b].contiguous(),
            None if dh_last is None else dh_last[:, :, a:b].contiguous(), chunk=chunk)
            for a, b in bwd_head_slices(hd)]
        _, dg, dBm, dCm = parts[0]
        for _, g_, b_, c_ in parts[1:]:
            dg, dBm, dCm = dg + g_, dBm + b_, dCm + c_
        return torch.cat([p_[0] for p_ in parts], -1), dg, dBm, dCm
    dev = xdt.device
    outs = (torch.empty_like(xdt), torch.empty_like(g), torch.empty_like(Bm),
            torch.empty_like(Cm))
    if xdt.numel() == 0:
        return tuple(o.zero_() for o in outs)
    with torch.cuda.device(dev):
        plan = ssd_bwd_plan(B, nh, S, hd, N, Q,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
        ptrs = (xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr()) + (
            () if dh_last is None else (dh_last.data_ptr(),))
        vec = vec_loads(N, hd, *ptrs)
        ws_bytes, launch = _bwd_entries()
        ws = torch.empty(ws_bytes(B, nh, S, hd, N, Q, plan.heads), dtype=torch.uint8,
                         device=dev)
        err = launch(xdt.data_ptr(), g.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     dy.data_ptr(), None if dh_last is None else dh_last.data_ptr(),
                     *(o.data_ptr() for o in outs), ws.data_ptr(), B, nh, S, hd, N, Q,
                     plan.heads, plan.dtiles, int(vec),
                     torch.cuda.current_stream(dev).cuda_stream)
    build.check("ssd_scan_bwd", err)
    backend.count_launch("ssd_scan_bwd")
    return outs


def scan_flops(B: int, nh: int, S: int, hd: int, N: int, Q: int) -> int:
    """The forward's work, a multiply-add two: per (batch, chunk) the causal
    half of C Bᵀ (B and C are shared by the heads); per (batch, head,
    chunk) the causal half of the masked product, the state update, and
    C h where the incoming state is not zero (after the first chunk)."""
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = q * (q + 1) // 2
        flops += B * 2 * pairs * N + B * nh * (2 * pairs * hd + 2 * q * N * hd)
        if c0:
            flops += B * nh * 2 * q * N * hd
    return flops


def scan_bwd_flops(B: int, nh: int, S: int, hd: int, N: int, Q: int) -> int:
    """The backward's work: per (batch, chunk) the causal half of C Bᵀ; per
    (batch, head, chunk) the causal halves of dy xdtᵀ, (C Bᵀ ∘ E)ᵀ dy
    (K = hd), (E ∘ G)ᵀ C and (E ∘ G) B (K = N), and the Q x hd x N
    products: dxdt's and dB's state terms in every chunk, dC's inter-chunk
    term in every chunk but the first, the state recurrence in every chunk
    but the last, dh's in every chunk but the first."""
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    return (B * nc * 2 * pairs * N + B * nh * nc * 2 * pairs * (2 * hd + 2 * N)
            + B * nh * (5 * nc - 3) * 2 * Q * hd * N)


def _scan_dims(sh, args):
    (B, nh, S, hd), N = sh[0], sh[2][2]
    return B, nh, S, hd, N, int(args[0])


# shape-only implementations and FLOP formulas (``backend.register``)
backend.register("ssd_scan",
                 lambda ops, args: [(tuple(ops[0].shape), torch.float32),
                                    ((*ops[0].shape[:2], ops[0].shape[3], ops[2].shape[2]),
                                     torch.float32)],
                 lambda sh, args: scan_flops(*_scan_dims(sh, args)))
backend.register("ssd_scan_bwd",
                 lambda ops, args: [(tuple(t.shape), torch.float32) for t in ops[:4]],
                 lambda sh, args: scan_bwd_flops(*_scan_dims(sh, args)))


def _scan(xdt, g, Bm, Cm, chunk):
    return backend.dispatch(
        "ssd_scan", kernel=lambda: ssd_scan_kernel(xdt, g, Bm, Cm, chunk=chunk),
        ref=lambda: ssd_scan_ref(xdt, g, Bm, Cm, chunk=chunk), x=xdt,
        operands=(xdt, g, Bm, Cm), args=(chunk,))


def _scan_bwd(xdt, g, Bm, Cm, dy, dh_last, chunk):
    return backend.dispatch(
        "ssd_scan_bwd",
        kernel=lambda: ssd_scan_bwd_kernel(xdt, g, Bm, Cm, dy, dh_last, chunk=chunk),
        ref=lambda: ssd_scan_bwd_ref(xdt, g, Bm, Cm, dy, dh_last, chunk=chunk), x=xdt,
        operands=(xdt, g, Bm, Cm, dy, dh_last), args=(chunk,))


class _SsdScan(torch.autograd.Function):
    """(y, h_last) = the scan of (xdt, g, Bm, Cm) in the kernel layout, its
    backward the backward kernel: on a CUDA tensor ``ssd_scan_kernel`` and
    ``ssd_scan_bwd_kernel``, on a CPU tensor their plain versions.  Both
    outputs take a cotangent (none, for one that no loss reads)."""

    @staticmethod
    def forward(ctx, xdt, g, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xdt, g, Bm, Cm)
        ctx.chunk = chunk
        return _scan(xdt, g, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        xdt, g, Bm, Cm = ctx.saved_tensors
        dy = torch.zeros_like(xdt) if dy is None else dy.float().contiguous()
        if dh_last is not None:
            dh_last = dh_last.float().contiguous()
        return (*_scan_bwd(xdt, g, Bm, Cm, dy, dh_last, ctx.chunk), None)


def _kernel_route(xh, Bm, Cm, dt, A, chunk: int):
    """Model layout -> the kernel's: xdt = x * dt (B, nh, S, hd), g = A * dt
    (B, nh, S), f32, padded to a multiple of Q = min(chunk, S) with zeros
    (g = 0 and xdt = 0 leave the state unchanged), through ``_SsdScan``;
    autograd carries the pre-scaling, permutes and padding back to x, dt,
    A, Bm and Cm."""
    B, S, nh, hd = xh.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    dtf = dt.float()
    xdt = (xh.float() * dtf[..., None]).permute(0, 2, 1, 3)
    g = (dtf * A.float()[None, None, :]).permute(0, 2, 1)
    Bk, Ck = Bm.float(), Cm.float()
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, pad))
        g = F.pad(g, (0, pad))
        Bk = F.pad(Bk, (0, 0, 0, pad))
        Ck = F.pad(Ck, (0, 0, 0, pad))
    y, h_last = _SsdScan.apply(xdt.contiguous(), g.contiguous(), Bk.contiguous(),
                               Ck.contiguous(), Q)
    return y[:, :, :S].permute(0, 2, 1, 3), h_last


def ssd_scan_with_state(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        dt: torch.Tensor, A: torch.Tensor, *, chunk: int = 256):
    """SSD forward, model layout: xh (B, S, nh, hd); Bm/Cm (B, S, N); dt
    (B, S, nh) post-softplus; A (nh,) negative.  Returns (y (B, S, nh, hd),
    h_last (B, nh, hd, N)), both float32, WITHOUT the D-residual — the
    return of ``repro.models.ssm.ssd_chunked``.  Routed by xh's device
    (``kernels.backend.dispatch``): a CUDA tensor runs the scan kernel and,
    under autograd, the backward kernel (``_SsdScan``); a CPU tensor takes
    ``ssd_chunked`` and autograd through it, as ``repro``'s model does."""
    return backend.dispatch(
        "ssd_scan", kernel=lambda: _kernel_route(xh, Bm, Cm, dt, A, chunk),
        ref=lambda: ssd_chunked(xh, Bm, Cm, dt, A, chunk=chunk), x=xh)


def ssd_scan(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, *, chunk: int = 256, use_kernel: bool = True) -> torch.Tensor:
    """``repro.kernels.ssd_scan.ssd_scan``: the SSD forward in the model
    layout, y (B, S, nh, hd) in xh's dtype, without the D-residual (the
    caller adds D * x, as ``models.ssm`` does).  ``use_kernel=False`` takes
    the per-token oracle ``ssd_sequential_ref`` on any device, as in
    ``repro``."""
    if not use_kernel:
        y, _ = ssd_sequential_ref(xh, Bm, Cm, dt, A)
    else:
        y, _ = ssd_scan_with_state(xh, Bm, Cm, dt, A, chunk=chunk)
    return y.to(xh.dtype)
