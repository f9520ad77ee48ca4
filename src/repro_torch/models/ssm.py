"""Mamba2 / SSD (state-space duality) blocks — the port of
``repro.models.ssm``.

Prefill runs the SSD chunked algorithm [arXiv:2405.21060]: the quadratic
attention form within chunks and a linear recurrence across chunk
states.  Under ``ssd_impl="kernel"`` (the serving and training runtimes)
it goes through ``kernels.ssd_scan.ssd_scan_with_state`` — the CUDA
kernel for a CUDA tensor — and under ``"chunked"`` through its plain twin
``ssd_chunked``, which is what ``repro`` runs in its model.  Decode
carries (conv buffer, SSM state) and costs O(1) per token; it is plain
PyTorch, as ``repro`` runs no kernel there, and it writes the new state
into the cache in place, as the port's attention decode writes its KV.
Activations and the scan compute in f32, as in ``repro``, or in f64 when
the model is run in f64 (``layers.upcast``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_chunked, ssd_scan_with_state
from ..sharding.collectives import all_gather
from ..sharding.tp import WHOLE, Entry, TensorParallel, gather_cut, is_cut, piece
from .layers import _normal, dense, init_dense, rmsnorm, upcast


def _dims(cfg):
    d_in = cfg.d_inner
    nh = cfg.ssm_num_heads
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N            # conv over (x, B, C), ngroups = 1
    return d_in, nh, N, conv_dim


def init_mamba(cfg, gen: torch.Generator, dtype, device) -> dict:
    """``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``dtype``, as
    in ``repro``."""
    d = cfg.d_model
    d_in, nh, N, conv_dim = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    # in_proj -> [z (d_in), xBC (conv_dim), dt (nh)]
    return {
        "in_proj": init_dense(gen, d, 2 * d_in + 2 * N + nh, dtype, device),
        "conv_w": _normal(gen, (cfg.ssm_conv_width, conv_dim), 0.2, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": {"scale": torch.ones((d_in,), dtype=dtype, device=device)},
        "out_proj": init_dense(gen, d_in, d, dtype, device),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_in, nh, N, conv_dim = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W over (B, S, C), in xbc's dtype."""
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i].to(xbc.dtype)
    return out + b.to(xbc.dtype)


def _conv_step(xbc1: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv: xbc1 (B, conv_dim); buf (B, W-1, conv_dim) holds the
    last W-1 pre-activation inputs.  Returns (conv output, the new
    buffer)."""
    window = torch.cat([buf, xbc1[:, None, :].to(buf.dtype)], dim=1)   # (B, W, conv)
    ct = upcast(window).dtype
    y = torch.einsum("bwc,wc->bc", window.to(ct), w.to(ct)) + b.to(ct)
    return y.to(xbc1.dtype), window[:, 1:, :]


def _lora(lora, name):
    return None if lora is None or name not in lora else lora[name]


def mamba_block(cfg, p: dict, x: torch.Tensor, *, lora=None, lora_scale=1.0,
                return_state: bool = False, dense_impl: str = "einsum",
                ssd_impl: str = "chunked", tp: TensorParallel = WHOLE, seq: bool = False):
    """Full Mamba2 block (train / prefill).  x: (B, S, d_model).  With
    ``return_state`` also returns {"ssm": (B, nh, hd, N) f32, "conv":
    (B, W-1, conv_dim)}: the state after the last token, and the last W-1
    PRE-activation conv inputs, recomputed by ``in_proj`` on the tail
    (zero-padded in front when S < W-1), as ``repro`` does.

    Over a tensor-parallel axis ``tp`` (``sharding.tp``) the block's
    pieces are gathered and it runs whole on every rank: x whole rows, or
    with ``seq`` (mode "train") this rank's piece of the sequence (the
    output likewise).  The state it returns is then this rank's piece
    (``sharding.specs.cache_spec``: ``ssm`` over its heads, ``conv`` over
    its channels, each where the axis divides it)."""
    ent = Entry(x, tp, seq)
    if tp.group is not None:
        p = gather_cut(p, init_mamba(cfg, torch.Generator(), p["in_proj"]["w"].dtype, "meta"),
                       tp)
        x = ent.rep()
    B, S, _ = x.shape
    d_in, nh, N, conv_dim = _dims(cfg)
    zxbcdt = dense(x, p["in_proj"]["w"], lora=_lora(lora, "ssm_in"),
                   lora_scale=lora_scale, impl=dense_impl)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(upcast(xbc)).to(x.dtype)
    xh = xbc[..., :d_in].reshape(B, S, nh, cfg.ssm_head_dim)
    Bm = xbc[..., d_in:d_in + N]
    Cm = xbc[..., d_in + N:]
    dt = F.softplus(upcast(dt) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if ssd_impl == "kernel":
        y, h_last = ssd_scan_with_state(xh, Bm, Cm, dt, A, chunk=cfg.ssm_chunk)
    elif ssd_impl == "chunked":
        y, h_last = ssd_chunked(xh, Bm, Cm, dt, A, chunk=cfg.ssm_chunk)
    else:
        raise ValueError(f"ssd_impl {ssd_impl!r}: 'kernel' or 'chunked'")
    y = y + upcast(xh) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(upcast(z)).to(x.dtype)
    y = rmsnorm(y, p["norm"]["scale"], cfg.norm_eps)
    out = dense(y, p["out_proj"]["w"], lora=_lora(lora, "ssm_out"),
                lora_scale=lora_scale, impl=dense_impl)
    if not return_state:
        return ent.exit(whole=out)
    W = cfg.ssm_conv_width
    zxbcdt_tail = dense(x[:, max(0, S - (W - 1)):], p["in_proj"]["w"],
                        lora=_lora(lora, "ssm_in"), lora_scale=lora_scale,
                        impl=dense_impl)
    _, xbc_tail, _ = _split_proj(cfg, zxbcdt_tail)
    pad = (W - 1) - xbc_tail.shape[1]
    if pad > 0:
        xbc_tail = F.pad(xbc_tail, (0, 0, pad, 0))
    state = {"ssm": upcast(h_last), "conv": xbc_tail}
    return out, {k: _state_piece(cfg, k, v, tp) for k, v in state.items()}


# the dim of each state leaf that ``sharding.specs.cache_spec`` cuts over
# "model", and that dim's whole size
_STATE_CUT = {"ssm": (1, lambda cfg: cfg.ssm_num_heads), "conv": (2, lambda cfg: _dims(cfg)[3])}


def _state_piece(cfg, name: str, t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This rank's piece of a whole state leaf (the leaf itself where the
    axis does not divide its cut dim)."""
    dim, whole = _STATE_CUT[name]
    if tp.n > 1 and whole(cfg) % tp.n == 0:
        return piece(t, dim, tp)
    return t.contiguous()


def _state_whole(cfg, name: str, t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A state leaf whole: this rank's piece gathered over the axis."""
    dim, whole = _STATE_CUT[name]
    return all_gather(t, tp.group, dim) if is_cut(t, dim, whole(cfg)) else t


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    d_in, nh, N, conv_dim = _dims(cfg)
    return {"ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                                device=device)}


def mamba_step(cfg, p: dict, x: torch.Tensor, cache: dict, *, lora=None,
               lora_scale=1.0, dense_impl: str = "einsum", tp: TensorParallel = WHOLE):
    """One-token decode.  x: (B, 1, d_model); cache {"ssm", "conv"}.  O(1)
    state update, written into the cache IN PLACE.  Returns (out (B, 1,
    d_model), cache).  Over a tensor-parallel axis ``tp`` the mixer's
    pieces and the cache's are gathered, the step runs whole, and this
    rank's piece of the new state is written back."""
    if tp.group is not None:
        p = gather_cut(p, init_mamba(cfg, torch.Generator(), p["in_proj"]["w"].dtype, "meta"),
                       tp)
        whole = {k: _state_whole(cfg, k, v, tp) for k, v in cache.items()}
        out, h, conv = _step(cfg, p, x, whole, lora, lora_scale, dense_impl)
        cache["ssm"].copy_(_state_piece(cfg, "ssm", h, tp))
        cache["conv"].copy_(_state_piece(cfg, "conv", conv, tp))
        return out, cache
    out, h, conv = _step(cfg, p, x, cache, lora, lora_scale, dense_impl)
    cache["ssm"].copy_(h)
    cache["conv"].copy_(conv)
    return out, cache


def _step(cfg, p, x, cache, lora, lora_scale, dense_impl):
    """(out (B, 1, d), the new ssm state, the new conv buffer) of one token
    over a whole state."""
    B = x.shape[0]
    d_in, nh, N, conv_dim = _dims(cfg)
    zxbcdt = dense(x[:, 0], p["in_proj"]["w"], lora=_lora(lora, "ssm_in"),
                   lora_scale=lora_scale, impl=dense_impl)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc_conv, conv_buf = _conv_step(xbc, cache["conv"], p["conv_w"], p["conv_b"])
    xbc_conv = F.silu(upcast(xbc_conv)).to(x.dtype)
    xh = upcast(xbc_conv[..., :d_in].reshape(B, nh, cfg.ssm_head_dim))
    Bm = upcast(xbc_conv[..., d_in:d_in + N])
    Cm = upcast(xbc_conv[..., d_in + N:])
    dt1 = F.softplus(upcast(dt) + p["dt_bias"])                       # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A[None, :])
    h = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bn,bhd,bh->bhdn", Bm, xh, dt1)
    y = torch.einsum("bn,bhdn->bhd", Cm, h) + xh * p["D"][None, :, None]
    y = y.reshape(B, d_in).to(x.dtype)
    y = y * F.silu(upcast(z)).to(x.dtype)
    y = rmsnorm(y, p["norm"]["scale"], cfg.norm_eps)
    out = dense(y, p["out_proj"]["w"], lora=_lora(lora, "ssm_out"),
                lora_scale=lora_scale, impl=dense_impl)
    return out[:, None, :], h, conv_buf
