"""Precision as a first-class resource — the port of ``repro.precision``.

One typed config (:class:`PrecisionConfig`) describes every precision
knob of the split boundary: activation/gradient bit-widths, stochastic
rounding and error feedback.  The int8 frozen base is a property of the
params (:func:`quantize_params_int8`), not of the config.
The quantizers here are the port's single source of truth for the math:

* :func:`fake_quant` — symmetric per-tensor int quantization.  ``bits``
  may be a scalar or a ``(K,)`` vector broadcast against the leading
  (client) axes; rows with ``bits >= 16`` come back as the untouched
  input (``torch.where`` select), so an all-16 config is bit-identical
  to no quantization at all.
* :func:`quantize_weight_int8` / :func:`dequantize_weight` — per-output-
  channel ``(int8 W, f32 scale)`` pairs consumed by
  ``kernels.lora_matmul`` (the q8 kernels) and ``models.layers.dense``.
* :func:`quantize_kv_int8` — per-KV-head scales for int8 KV caches.

Round-to-nearest is ``torch.round`` (half to even, as ``jnp.round``), so
the deterministic quantizers are bit-equal to ``repro``'s.  Stochastic
rounding draws from a seeded ``torch.Generator`` (:func:`round_key`),
which gives other bits than JAX's keys: it is held to the same
properties (unbiased, reproducible per seed), not to JAX's draws.
This module imports only torch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# floor for every max-abs scale: an all-zero tensor (first step of a
# zero-init LoRA boundary, or a fully masked hetero slot) must quantize
# to zeros, not divide 0/0 into NaN — NaN here poisons the error-feedback
# accumulator forever.
SCALE_FLOOR = 1e-8

_VALID_BITS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Every precision knob in one hashable object.

    ``act_bits`` / ``grad_bits`` quantize the split-boundary upload and
    download (16 = off, bit-identical to the unquantized round).
    ``stochastic_rounding`` draws unbiased rounding from a generator
    seeded per (``rng_seed``, step); ``error_feedback`` carries the
    compression error in ``SflState`` and re-injects it next step."""

    act_bits: int = 16
    grad_bits: int = 16
    stochastic_rounding: bool = False
    error_feedback: bool = False
    rng_seed: int = 0x51C

    def __post_init__(self) -> None:
        if self.act_bits not in _VALID_BITS:
            raise ValueError(f"act_bits must be one of {_VALID_BITS}, got {self.act_bits}")
        if self.grad_bits not in _VALID_BITS:
            raise ValueError(f"grad_bits must be one of {_VALID_BITS}, got {self.grad_bits}")

    def replace(self, **kw) -> "PrecisionConfig":
        return dataclasses.replace(self, **kw)


def round_key(seed: int, step: int, stream: int, device="cpu") -> torch.Generator:
    """Stochastic-rounding generator for one local step: seeded from
    (``seed``, ``step``, ``stream``) — stream 0 for the activation upload,
    1 for the gradient download — on ``device``.  The same triple always
    gives the same draws; the mixing (SplitMix64's finalizer) keeps
    neighbouring steps' seeds far apart."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0x7FFFFFFF) << 1
         | (int(stream) & 1)) & 0xFFFFFFFFFFFFFFFF
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z ^= z >> 31
    return torch.Generator(device=device).manual_seed(z & 0x7FFFFFFFFFFFFFFF)


def _bits_view(bits, ndim: int, device) -> torch.Tensor:
    """Reshape bits to broadcast against a tensor's leading axes."""
    bits = torch.as_tensor(bits, dtype=torch.float32).to(device)
    if bits.dim() > ndim:
        raise ValueError(f"bits has rank {bits.dim()} > tensor rank {ndim}")
    return bits.reshape(tuple(bits.shape) + (1,) * (ndim - bits.dim()))


def fake_quant(x: torch.Tensor, bits, *, gen: Optional[torch.Generator] = None,
               err: Optional[torch.Tensor] = None, rows: Optional[Tuple[int, int]] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Symmetric per-tensor fake quantization.

    ``bits`` broadcasts against ``x``'s leading axes: a scalar gives the
    whole tensor one scale, shape ``(K,)`` gives each client its own
    scale and bit-width.  Rows with ``bits >= 16`` come back as the
    untouched input.  ``gen`` switches round-to-nearest to unbiased
    stochastic rounding (``floor(x/s + u)``, ``u ~ U[0, 1)``).  ``err`` is
    the carried error-feedback accumulator: added before quantizing, the
    fresh residual comes back as the second value (zeros wherever
    disarmed).  No gradient flows through the quantizer: the trainer
    places it outside the client graph (straight-through), or use
    :func:`fake_quant_ste`.

    ``rows=(offset, total)``: ``x`` is rows ``offset..`` of a tensor of
    ``total`` rows along dim 0 (one rank's clients), and ``bits`` has a
    leading axis, so each row's scale is its own: the stochastic draws are
    the whole tensor's, cut to these rows, and the shard rounds as the
    whole would."""
    b = _bits_view(bits, x.dim(), x.device)
    levels = 2.0 ** (b - 1.0) - 1.0
    x_in = x if err is None else x + err.to(x.dtype)
    nb = torch.as_tensor(bits).dim()
    xf = x_in.float()
    axes = tuple(range(nb, x.dim()))
    amax = xf.abs().amax(dim=axes, keepdim=True) if axes else xf.abs()
    scale = torch.clamp_min(amax / torch.clamp_min(levels, 1.0), SCALE_FLOOR)
    scaled = xf / scale
    if gen is not None:
        if rows is None:
            u = torch.rand(x.shape, generator=gen, dtype=torch.float32, device=x.device)
        else:
            if nb == 0:
                raise ValueError("fake_quant(rows=) needs per-row bits")
            u = torch.rand((rows[1],) + tuple(x.shape[1:]), generator=gen,
                           dtype=torch.float32, device=x.device)
            u = u[rows[0]:rows[0] + x.shape[0]]
        q = torch.floor(scaled + u)
    else:
        q = torch.round(scaled)
    q = torch.minimum(torch.maximum(q, -levels), levels)
    deq = (q * scale).to(x.dtype)
    armed = b < 16.0
    out = torch.where(armed, deq, x)
    new_err = None
    if err is not None:
        residual = (x_in.float() - deq.float()).to(err.dtype)
        new_err = torch.where(armed, residual, torch.zeros_like(err))
    return out, new_err


def fake_quant_ste(x: torch.Tensor, bits, *, gen: Optional[torch.Generator] = None,
                   err: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`fake_quant` with a straight-through gradient: the forward
    value is the (de)quantized tensor, the backward sees identity.
    Disarmed rows return ``x`` itself on both passes."""
    q, new_err = fake_quant(x.detach(), bits, gen=gen,
                            err=None if err is None else err.detach())
    b = _bits_view(bits, x.dim(), x.device)
    out = torch.where(b < 16.0, x + (q - x).detach(), x)
    return out, new_err


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weight quantization.

    ``w``: float ``(..., K, N)`` — the trailing two dims are the matmul
    ``(in, out)`` pair; leading dims quantize independently.  Returns
    ``(int8 w-shaped, f32 (..., N) scale)`` with ``w ~= q * scale``."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp_min(amax / 127.0, SCALE_FLOOR)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight_int8` (the plain path)."""
    return (q.float() * scale.float()[..., None, :]).to(dtype)


def quantize_params_int8(tree):
    """Weight-only int8 view of a params tree.

    Every dense layer — any dict carrying a floating matrix ``"w"`` of
    two or more dims — becomes ``{"w": int8, "w_scale": f32 (..., N)}``,
    the pair ``models.layers.dense`` and the q8 kernels consume.
    Embeddings, norms and biases keep their dtype.  Idempotent: dicts
    already carrying ``"w_scale"`` (or an integer ``"w"``) pass
    through.  Returns a new tree; the input is not modified."""
    if isinstance(tree, dict):
        out = {k: quantize_params_int8(v) for k, v in tree.items()}
        w = out.get("w")
        if (torch.is_tensor(w) and w.dim() >= 2 and "w_scale" not in out
                and w.is_floating_point()):
            out["w"], out["w_scale"] = quantize_weight_int8(w)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_params_int8(v) for v in tree)
    return tree


def quantize_kv_int8(kv: torch.Tensor, head_axis: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a KV tensor to int8 with one scale per KV head.

    Slab caches ``(B, KH, L, D)`` (head_axis=1) and paged pools
    ``(KH, pages, page, D)`` (head_axis=0).  Returns ``(int8 kv, f32
    (KH,) scale)``."""
    kvf = kv.float()
    axes = tuple(i for i in range(kvf.dim()) if i != head_axis)
    amax = kvf.abs().amax(dim=axes)
    scale = torch.clamp_min(amax / 127.0, SCALE_FLOOR)
    bshape = tuple(kvf.shape[head_axis] if i == head_axis else 1
                   for i in range(kvf.dim()))
    q = torch.clamp(torch.round(kvf / scale.reshape(bshape)), -127.0, 127.0)
    return q.to(torch.int8), scale
