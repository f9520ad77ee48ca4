"""Shared primitive layers: dense (+ LoRA), norms, rotary embeddings, MLPs,
embeddings — plain functions over explicit parameter dicts, as in
``repro.models.layers``, so each parameter tree matches its JAX twin leaf
for leaf.  Inits draw from an explicit CPU ``torch.Generator`` and then
move to ``device``, so one seed gives the same weights on every device
(a CUDA generator draws on the card instead: ``_normal``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.lora_matmul import lora_matmul, lora_matmul_gathered, take_adapters
from ..precision import dequantize_weight
from ..sharding.collectives import copy_to, gather_along, gather_whole, reduce_from
from ..sharding.tp import WHOLE, Entry, TensorParallel, col_lora, is_cut, row_lora


def _cast_like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == x.dtype else t.to(x.dtype)


# ---------------------------------------------------------------------------
# linear (+ LoRA)
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          lora: Optional[dict] = None, lora_scale: float = 1.0,
          impl: str = "einsum", w_scale: Optional[torch.Tensor] = None,
          adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b) (+ lora_scale * (x @ a^T) @ b_lora^T).

    ``lora`` is ``{"a": (r, in), "b": (out, r)}`` or None.  ``impl="fused"``
    with a Python-number scale routes through ``kernels.lora_matmul`` (the
    CUDA kernel for a CUDA tensor, its plain version for a CPU one); a
    tensor scale, or ``impl="einsum"``, takes the separate products.  The
    bias is added after the kernel, as in JAX.

    Weight-only int8: with ``w_scale`` (the f32 per-output-channel scale
    of ``precision.quantize_weight_int8``) ``w`` is int8; the fused route
    hands the pair to the q8 kernels, every other route dequantizes first
    (``repro``'s ``_w_dense``).  An integer ``w`` without its scale
    raises: cast to x's dtype it would compute with the raw integers.

    Multi-tenant: with ``adapter_idx`` (a (B,) integer tensor, one entry
    per leading batch row of x) the lora leaves are a POOL — ``{"a": (A,
    r, in), "b": (A, out, r)}`` — and row b wears adapter
    ``adapter_idx[b]``.  ``impl="fused"`` with a Python-number scale goes
    through ``kernels.lora_matmul_gathered`` (the gather kernel on a CUDA
    tensor), anything else through the gathered products in plain
    PyTorch; an int8 base is dequantized first on both.  A pool of size 1
    unstacks to the single-adapter path: bit-identical to passing the
    adapter itself, as in ``repro``."""
    if w_scale is None and not w.is_floating_point():
        raise TypeError(f"dense: w is {w.dtype} but no w_scale was given; an "
                        "int8 base weight needs its per-channel scale")
    if adapter_idx is not None and lora is not None and lora["a"].shape[0] == 1:
        lora = {"a": lora["a"][0], "b": lora["b"][0]}
        adapter_idx = None
    fused = impl == "fused" and lora is not None and isinstance(lora_scale, (int, float))
    if adapter_idx is not None and lora is not None:
        wd = (_cast_like(x, w) if w_scale is None
              else dequantize_weight(w, w_scale, dtype=x.dtype))
        if fused:
            y = lora_matmul_gathered(x, wd, lora["a"], lora["b"], adapter_idx,
                                     scale=float(lora_scale))
        else:
            y = x @ wd
            a_sel = take_adapters(_cast_like(x, lora["a"]), adapter_idx)
            b_sel = take_adapters(_cast_like(x, lora["b"]), adapter_idx)
            z = torch.einsum("b...i,bri->b...r", x, a_sel)
            delta = torch.einsum("b...r,bor->b...o", z, b_sel)
            y = y + (lora_scale * delta).to(y.dtype)
    elif fused:
        y = lora_matmul(x, w if w_scale is not None else _cast_like(x, w),
                        _cast_like(x, lora["a"]), _cast_like(x, lora["b"]),
                        scale=float(lora_scale), w_scale=w_scale)
    else:
        wd = (_cast_like(x, w) if w_scale is None
              else dequantize_weight(w, w_scale, dtype=x.dtype))
        y = x @ wd
        if lora is not None:
            z = x @ _cast_like(x, lora["a"]).T
            delta = z @ _cast_like(x, lora["b"]).T
            y = y + (lora_scale * delta).to(y.dtype)
    if b is not None:
        y = y + _cast_like(y, b)
    return y


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std²) drawn in f32 on ``gen``'s device (the CPU for the usual
    CPU generator; a CUDA generator draws large weights on the card, with
    other numbers than a CPU one of the same seed), then moved to
    ``device``."""
    if torch.device(device).type == "meta":
        # an abstract tree: shapes and dtypes, no draws, no memory
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std
    return t.to(device=device, dtype=dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_lora(gen: torch.Generator, d_in: int, d_out: int, rank: int, dtype,
              device) -> dict:
    """LoRA init per Hu et al.: A ~ N(0, 1/r), B = 0 (so delta starts at 0)."""
    return {"a": _normal(gen, (rank, d_in), rank ** -0.5, dtype, device),
            "b": torch.zeros((d_out, rank), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back)
# ---------------------------------------------------------------------------

def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in f32, the precision norms and activations compute in, or as it
    is when it is f64 (a double-precision run of the model)."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.to(xf.dtype)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def init_norm(cfg, d: int, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Angles in
    f32, the rotation in x's dtype (as in JAX)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _sub(lora: Optional[dict], name: str) -> Optional[dict]:
    return None if lora is None or name not in lora else lora[name]


def _proj(x, p: dict, lora, name: str, lora_scale, dense_impl, adapter_idx=None):
    return dense(x, p["w"], p.get("b"), lora=_sub(lora, name), lora_scale=lora_scale,
                 impl=dense_impl, w_scale=p.get("w_scale"), adapter_idx=adapter_idx)


def swiglu_mlp(cfg, x, p: dict, lora: Optional[dict] = None,
               lora_scale: float = 1.0, dense_impl: str = "einsum",
               adapter_idx: Optional[torch.Tensor] = None):
    g = _proj(x, p["w_gate"], lora, "gate", lora_scale, dense_impl, adapter_idx)
    u = _proj(x, p["w_up"], lora, "up", lora_scale, dense_impl, adapter_idx)
    h = F.silu(g.float()).to(x.dtype) * u
    return _proj(h, p["w_down"], lora, "down", lora_scale, dense_impl, adapter_idx)


def gelu_mlp(cfg, x, p: dict, lora: Optional[dict] = None,
             lora_scale: float = 1.0, dense_impl: str = "einsum",
             adapter_idx: Optional[torch.Tensor] = None):
    h = _proj(x, p["w_up"], lora, "up", lora_scale, dense_impl, adapter_idx)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _proj(h, p["w_down"], lora, "down", lora_scale, dense_impl, adapter_idx)


def mlp_parts(cfg, ent: Entry, p: dict, lora: Optional[dict] = None,
              lora_scale: float = 1.0, dense_impl: str = "einsum",
              adapter_idx: Optional[torch.Tensor] = None, kind: Optional[str] = None):
    """The MLP (``kind``, default ``cfg.mlp_kind``) on ``ent``'s input as
    the (partial, whole, bias) that ``Entry.exit`` sums: whole where the
    ff dim is whole, else column-parallel up (and gate) and row-parallel
    down on this rank's ff columns (``sharding.tp``)."""
    fn = swiglu_mlp if (kind or cfg.mlp_kind) == "swiglu" else gelu_mlp
    if not is_cut(p["w_up"]["w"], 1, cfg.d_ff):
        return None, fn(cfg, ent.rep(), p, lora, lora_scale, dense_impl, adapter_idx), None
    tp = ent.tp
    x = ent.par()

    def col(name, lname):
        return dense(x, p[name]["w"], p[name].get("b"), col_lora(_sub(lora, lname), tp),
                     lora_scale, impl=dense_impl)

    u = col("w_up", "up")
    if fn is swiglu_mlp:
        h = F.silu(col("w_gate", "gate").float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    down = p["w_down"]
    return (dense(h, down["w"], None, row_lora(_sub(lora, "down"), tp), lora_scale,
                  impl=dense_impl), None, down.get("b"))


def apply_mlp(cfg, x, p: dict, lora: Optional[dict] = None,
              lora_scale: float = 1.0, dense_impl: str = "einsum",
              adapter_idx: Optional[torch.Tensor] = None, tp: TensorParallel = WHOLE,
              seq: bool = False):
    """The MLP on x (B, S, d); over a tensor-parallel axis ``tp`` on this
    rank's pieces, x whole rows or (``seq``) its piece of the sequence."""
    ent = Entry(x, tp, seq)
    return ent.exit(*mlp_parts(cfg, ent, p, lora, lora_scale, dense_impl, adapter_idx))


def init_mlp(cfg, gen: torch.Generator, dtype, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    bias = cfg.norm == "layernorm"          # GPT-2 family carries biases
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": init_dense(gen, d, ff, dtype, device),
                "w_up": init_dense(gen, d, ff, dtype, device),
                "w_down": init_dense(gen, ff, d, dtype, device)}
    return {"w_up": init_dense(gen, d, ff, dtype, device, bias=bias),
            "w_down": init_dense(gen, ff, d, dtype, device, bias=bias)}


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(cfg, gen: torch.Generator, dtype, device) -> dict:
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device)}
    if cfg.pos_emb == "learned":
        p["pos"] = _normal(gen, (cfg.max_seq_len, cfg.d_model), 0.02, dtype, device)
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model ** -0.5, dtype, device)
    return p


def embed(cfg, p: dict, tokens: torch.Tensor, positions: torch.Tensor,
          tp: TensorParallel = WHOLE) -> torch.Tensor:
    """Whole rows (B, S, d).  Where ``tok``'s vocabulary is this rank's
    piece (``sharding.tp``): a masked lookup in it, summed over the axis;
    where ``pos`` is cut over d: its rows' pieces, gathered."""
    tok = p["tok"]
    if is_cut(tok, 0, cfg.vocab_size):
        idx = tokens.long() - tp.rank * tok.shape[0]
        inside = (idx >= 0) & (idx < tok.shape[0])
        x = reduce_from(tok[idx.clamp(0, tok.shape[0] - 1)] * inside[..., None].to(tok.dtype),
                        tp.group)
    else:
        x = tok[tokens.long()]
    if cfg.pos_emb == "learned":
        pos_table = p["pos"]
        rows = pos_table[positions.long().clamp(0, pos_table.shape[0] - 1)]
        if is_cut(pos_table, 1, cfg.d_model):
            rows = gather_whole(rows, tp.group, -1)
        x = x + rows
    return x


def unembed(cfg, p: dict, x: torch.Tensor, tp: TensorParallel = WHOLE,
            seq: bool = False) -> torch.Tensor:
    """Logits of the final normed x (whole rows, or with ``seq`` its piece
    of the sequence) over all its rows: (B, S, V), or (B, S, V/tp) of
    this rank's piece of the vocabulary where the unembedding (``tok``
    when tied) is cut over it."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    if is_cut(w, 1, cfg.vocab_size):
        x = gather_along(x, tp.group, 1) if seq else copy_to(x, tp.group)
    elif seq:
        x = gather_whole(x, tp.group, 1)
    return x @ _cast_like(x, w)
