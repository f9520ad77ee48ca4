"""Decoder blocks and the layer stack: training, slab serving (prefill
and decode) and paged serving; attention and Mamba2 mixers.

Where ``repro`` stacks each pattern position's parameters over the
repeat axis and ``lax.scan``s over it, the port keeps one entry per layer
(``params["layers"][i]`` is repeat ``i // P`` at pattern position
``i % P``) and runs the stack as a Python loop: PyTorch executes eagerly,
so a scan buys nothing here.  An MoE MLP (``models.moe``) adds its
load-balance aux loss, which the stack sums over the layers it runs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..precision import PrecisionConfig
from ..sharding.tp import seq_sharded, tp_of
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm


@dataclass(frozen=True)
class Runtime:
    """The training and serving knobs: every field of
    ``repro.models.stack.Runtime``, with its default, and the port's own
    (``ssd_impl``, ``pool``, ``mesh``).

    In ``repro`` the layout hints (``dp_axes``, ``tp_axis``, ``seq_shard``,
    ``moe_constraints``) are sharding constraints for GSPMD.  In the port
    they say how the model functions split their work over the ranks of
    ``mesh`` (a ``launch.mesh.Mesh``): ``tp_axis`` names the axis the
    weights' "model" pieces and the heads, ff columns, experts and vocab
    lie over (``sharding.tp``; None: every rank runs whole),
    ``dp_axes`` the axes the batch rows lie over, ``seq_shard`` cuts the
    activations between blocks over ``tp_axis`` on the sequence, and
    ``moe_constraints`` sends each rank's tokens to their experts' ranks
    by all-to-all.  None of them changes a value."""

    attn_impl: str = "chunked"          # "naive" | "chunked"
    dense_impl: str = "einsum"          # "einsum" | "fused" (kernels.lora_matmul)
    kv_chunk: int = 512                 # online-softmax KV chunk
    q_chunk: int = 0                    # 0 = no query blocking
    # "flash" routes decode through the decode kernels — slab caches through
    # kernels.flash_attention.flash_decode, paged pools through
    # kernels.flash_attention.paged_decode (the CUDA kernels on a CUDA
    # tensor); "naive" takes the plain position-masked (slab) or gather
    # (paged) attention
    decode_attn_impl: str = "naive"
    # "kernel" routes a Mamba2 block's SSD scan through
    # kernels.ssd_scan.ssd_scan_with_state (the CUDA kernel on a CUDA
    # tensor); "chunked" takes the plain ssd_chunked, repro's model twin
    ssd_impl: str = "chunked"
    # MoE dispatch: tokens per routing group and the expert capacity factor
    moe_group: int = 128
    capacity_factor: float = 1.25
    # mode "train": run each layer under torch.utils.checkpoint.  "full"
    # keeps none of its activations and recomputes the layer in the
    # backward; "dots" keeps the projections' outputs (``layers.dense``,
    # the fused LoRA op included) and recomputes the rest.  A layer is
    # read from ``layers`` inside, so a stack whose reads gather the layer
    # (``sharding.fsdp``) gathers it again for the recompute
    remat: bool = False
    remat_policy: str = "full"          # "full" | "dots"
    dp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None
    seq_shard: bool = False             # Megatron-style sequence parallelism
    moe_constraints: bool = False       # tokens to their experts by all-to-all
    attn_s_bf16: bool = False           # the score einsum in the input dtype
    # split-boundary bit-widths, stochastic rounding and error feedback
    # (``precision``); the default is fully disarmed (16/16/f32)
    precision: PrecisionConfig = PrecisionConfig()
    # the process group the rows of a pooled batch are split over evenly
    # (the SFL server's client shards, the pod step's ``dp_axes`` shards):
    # an MoE block's load-balance means are then taken over the whole pool
    # (``models.moe.apply_moe(pool=)``).  None: the batch is all here
    pool: Optional[object] = None
    # the mesh ``tp_axis`` names an axis of (``launch.mesh.Mesh``)
    mesh: Optional[object] = field(default=None, compare=False)

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)


def default_train_runtime() -> Runtime:
    """The trainers' fast path: every LoRA-adapted projection through the
    fused ``kernels.lora_matmul`` with its backward kernels, the SSD scan
    kernel, chunked attention, and the cheap "dots" policy if
    rematerialization is switched on (``repro``'s defaults).  Training
    attention is plain PyTorch in every runtime, as it is jnp in JAX
    (``attention.run_attention``)."""
    return Runtime(attn_impl="chunked", dense_impl="fused", ssd_impl="kernel",
                   remat_policy="dots")


def default_serve_runtime() -> Runtime:
    """The serving fast path: fused LoRA projections, the decode kernels
    and the SSD scan kernel (each routed by device: kernels on CUDA, plain
    code on CPU)."""
    return Runtime(dense_impl="fused", decode_attn_impl="flash", ssd_impl="kernel")


def _dots_policy(ctx, op, *args, **kwargs):
    """``repro``'s ``dots_with_no_batch_dims_saveable``: keep the output of
    every matmul without batch dims (``aten.mm``/``addmm``: the
    projections, the einsum form's and the fused op's plain version's
    products) and of the fused LoRA op (its CUDA launch, an opaque custom
    op), recompute the rest (``bmm``: attention scores, MoE experts)."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _dots_saved()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saved():
    from ..kernels import backend, lora_matmul  # noqa: F401  (its registration)
    return (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            backend.kernel_op("lora_matmul"))


def _remat(block, x, policy: str):
    """``block(x)`` under ``torch.utils.checkpoint`` with ``repro``'s
    remat policy."""
    if policy == "full":
        return checkpoint(block, x, use_reentrant=False)
    if policy != "dots":
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    from ..kernels import backend

    def saving(x):
        with backend.as_ops(("lora_matmul",)):   # the fused forward as the op the policy saves
            return block(x)
    return checkpoint(saving, x, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))


def init_block(cfg, pat, gen: torch.Generator, dtype, device) -> dict:
    mixer = (attn_mod.init_attention(cfg, gen, dtype, device) if pat.mixer == "attention"
             else ssm_mod.init_mamba(cfg, gen, dtype, device))
    p: dict = {"norm1": init_norm(cfg, cfg.d_model, dtype, device), "mixer": mixer}
    if pat.mlp != "none":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["mlp"] = (moe_mod.init_moe(cfg, gen, dtype, device) if pat.mlp == "moe"
                    else init_mlp(cfg, gen, dtype, device))
    return p


def apply_block(cfg, pat, p: dict, x, *, lora, lora_scale, rt: Runtime,
                mode: str, cache=None, cur_index=None, block_tables=None,
                positions=None, cache_len: int = 0, adapter_idx=None):
    """mode "train": causal self-attention over the sequence (positions
    (S,)); mode "prefill": the same, also building a slab cache of length
    ``cache_len`` (or S); mode "decode": one token per slot, over the
    paged pool when ``block_tables`` (B, MP) is given, else over the slab
    cache (cur_index a scalar or (B,)); mode "chunk": one paged prefill
    chunk (block_tables (MP,), cur_index the chunk's start).
    ``adapter_idx`` (mode "decode" only) makes the LoRA leaves (A, ...)
    pools with per-slot adapter selection (multi-tenant serving; see
    ``layers.dense``).  A Mamba2 block runs modes "train", "prefill"
    (its cache is the {"ssm", "conv"} state) and slab "decode"; paged
    modes raise, as in ``repro``.  An MoE MLP (``pat.mlp == "moe"``) routes
    every mode's tokens through ``models.moe.apply_moe`` in groups of
    ``rt.moe_group`` (it carries no LoRA, as in ``repro``).  Returns (x,
    cache, aux): aux is the MoE block's f32 load-balance loss, None for a
    block without one.  Under a ``Runtime`` whose ``tp_axis`` has more
    than one rank, modes "train", "prefill" and slab "decode" run on this
    rank's pieces (``sharding.tp``): x is whole rows (B, S, d), or in mode
    "train" with ``seq_shard`` this rank's piece of the sequence,
    positions the whole (S,); a cache is this rank's piece of it
    (``sharding.specs.cache_spec``: an attention layer's KV heads, or its
    length where KH % tp != 0; a Mamba2 layer's state heads and conv
    channels).  The paged modes raise: no engine pages over a mesh."""
    tp = tp_of(rt)
    seq = False
    if tp.n > 1:
        if mode not in ("train", "prefill", "decode") or block_tables is not None:
            raise NotImplementedError(f"tensor parallelism runs modes 'train', 'prefill' and "
                                      f"slab 'decode', not paged {mode!r}")
        if mode == "train":
            S = positions.shape[0]
            seq = seq_sharded(rt, tp, S)
            if x.shape[1] != (S // tp.n if seq else S):
                raise ValueError(f"tp block: x has {x.shape[1]} rows of a sequence of {S}")
    mixer_lora = None if lora is None else lora.get("mixer")
    h = apply_norm(cfg, x, p["norm1"])
    if pat.mixer == "mamba":
        m, cache = _mamba_mixer(cfg, p["mixer"], h, mixer_lora, lora_scale, rt, mode,
                                cache, block_tables, adapter_idx, tp, seq)
    elif mode == "train":
        m = attn_mod.self_attention(
            cfg, p["mixer"], h, positions, lora=mixer_lora, lora_scale=lora_scale,
            dense_impl=rt.dense_impl, tp=tp, seq=seq, **attn_mod.attn_knobs(rt))
    elif mode == "prefill":
        m, cache = attn_mod.self_attention(
            cfg, p["mixer"], h, positions, lora=mixer_lora, lora_scale=lora_scale,
            dense_impl=rt.dense_impl, return_cache=True,
            cache_len=cache["k"].shape[1] if cache is not None else cache_len,
            tp=tp, **attn_mod.attn_knobs(rt))
    elif mode == "decode" and block_tables is not None:
        m, cache = attn_mod.paged_decode_attention(
            cfg, p["mixer"], h, cache, block_tables, cur_index,
            lora=mixer_lora, lora_scale=lora_scale,
            impl=rt.decode_attn_impl, dense_impl=rt.dense_impl, adapter_idx=adapter_idx)
    elif mode == "decode":
        m, cache = attn_mod.decode_attention(
            cfg, p["mixer"], h, cache, cur_index, lora=mixer_lora,
            lora_scale=lora_scale, impl=rt.decode_attn_impl, dense_impl=rt.dense_impl,
            adapter_idx=adapter_idx, tp=tp)
    elif mode == "chunk":
        m, cache = attn_mod.paged_chunk_attention(
            cfg, p["mixer"], h, cache, block_tables, cur_index,
            lora=mixer_lora, lora_scale=lora_scale, dense_impl=rt.dense_impl)
    else:
        raise ValueError(f"mode {mode!r}: the port runs 'train', 'prefill', "
                         "'decode' and 'chunk'")
    x = x + m
    aux = None
    if pat.mlp == "moe":
        mo, aux = moe_mod.apply_moe(cfg, p["mlp"], apply_norm(cfg, x, p["norm2"]),
                                    group_size=rt.moe_group,
                                    capacity_factor=rt.capacity_factor, pool=rt.pool,
                                    tp=tp, seq=seq, constraints=rt.moe_constraints)
        x = x + mo
    elif pat.mlp != "none":
        h = apply_norm(cfg, x, p["norm2"])
        x = x + apply_mlp(cfg, h, p["mlp"],
                          None if lora is None else lora.get("mlp"),
                          lora_scale, dense_impl=rt.dense_impl, adapter_idx=adapter_idx,
                          tp=tp, seq=seq)
    return x, cache, aux


def _mamba_mixer(cfg, p, h, lora, lora_scale, rt: Runtime, mode: str, cache,
                 block_tables, adapter_idx, tp, seq):
    if mode == "chunk" or block_tables is not None:
        raise NotImplementedError(
            "paged serving is attention-only (mamba state is not paged); "
            "init_paged_stack_cache rejects such patterns")
    if adapter_idx is not None:
        raise NotImplementedError("multi-tenant adapters need the paged engine, "
                                  "which is attention-only")
    kw = dict(lora=lora, lora_scale=lora_scale, dense_impl=rt.dense_impl)
    if mode == "decode":
        return ssm_mod.mamba_step(cfg, p, h, cache, tp=tp, **kw)
    if mode == "prefill":
        return ssm_mod.mamba_block(cfg, p, h, return_state=True, ssd_impl=rt.ssd_impl,
                                   tp=tp, **kw)
    if mode == "train":
        return ssm_mod.mamba_block(cfg, p, h, ssd_impl=rt.ssd_impl, tp=tp, seq=seq,
                                   **kw), cache
    raise ValueError(f"mode {mode!r}: the port runs 'train', 'prefill', 'decode' "
                     "and 'chunk'")


def init_stack_cache(cfg, batch: int, cache_len: int, dtype, device) -> List[dict]:
    """One slab cache per layer: {"k", "v": (B, L, KH, D), "pos": (B, L)}
    for an attention layer, {"ssm": (B, nh, hd, N) f32, "conv": (B, W-1,
    conv_dim)} for a Mamba2 layer (no length axis: ``cache_len`` is
    unused there)."""
    return [attn_mod.init_attn_cache(cfg, batch, cache_len, dtype, device)
            if pat.mixer == "attention"
            else ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
            for pat in cfg.layer_kinds]


def init_paged_stack_cache(cfg, num_pages: int, page_size: int, dtype,
                           device) -> List[dict]:
    """One (KH, NP, PS, D) k/v pool pair per layer."""
    if any(pat.mixer != "attention" for pat in cfg.pattern):
        raise NotImplementedError("paged KV cache requires an attention-only pattern")
    return [attn_mod.init_paged_attn_cache(cfg, num_pages, page_size, dtype, device)
            for _ in range(cfg.num_layers)]


def _per_row(bound) -> bool:
    """Whether a gate bound is per row (a host sequence or a tensor with a
    batch axis), not None or one int for every row."""
    return bound is not None and torch.as_tensor(bound, device="cpu").dim() > 0


def _live_rows(rep: int, lo, hi):
    """Which rows apply repeat ``rep`` under the gate ``lo <= rep < hi``:
    True (all), False (none), or a CPU bool mask over the batch rows.
    ``lo``/``hi`` are None, ints, or per-row host sequences / CPU tensors."""
    if lo is None and hi is None:
        return True
    keep = torch.ones((), dtype=torch.bool)
    if lo is not None:
        keep = keep & (rep >= torch.as_tensor(lo, device="cpu"))
    if hi is not None:
        keep = keep & (rep < torch.as_tensor(hi, device="cpu"))
    if bool(keep.all()):
        return True
    if not bool(keep.any()):
        return False
    return keep


def apply_stack(cfg, layers: List[dict], x, *, lora: Optional[List[dict]] = None,
                rt: Runtime, mode: str = "train", caches: Optional[List[dict]] = None,
                cur_index=None, block_tables=None, positions=None,
                lora_scale: Optional[float] = None,
                rep_slice: Optional[Tuple[int, int]] = None,
                rep_gate: Optional[Tuple[object, object]] = None,
                cache_len: int = 0, adapter_idx=None):
    """Run the layers in order.  ``lora`` is a per-layer list of adapter
    dicts (or None); the scale defaults to ``cfg.lora_alpha / cfg.lora_rank``.

    ``rep_slice=(a, b)`` runs pattern repeats [a, b) of the full stack
    (the SFL split point in repeat units), slicing ``layers``, ``lora``
    and ``caches`` alike.  A stack cut at a repeat boundary keeps each
    layer's pattern position, so ``layers`` may also be such a cut.

    ``rep_gate=(lo, hi)`` (mode "train" only) applies repeat i of the
    (sliced) stack to a row iff ``lo <= i < hi``; either bound may be
    None, an int, or a per-row host sequence of the batch.  Gated rows
    pass through bit-unchanged (``torch.where(keep, block(x), x)``, as
    JAX's gate); a repeat no row applies is skipped and one every row
    applies runs ungated — the same values, without the dead blocks.
    The MoE aux follows ``repro``'s gate: under a scalar gate (None or
    ints) a gated repeat adds none, so it is skipped; under a per-row gate
    every repeat adds its aux over the whole batch, so a repeat with an
    MoE block that no row applies still runs, for its aux alone.
    Mode "prefill" builds one slab cache per layer (of length
    ``cache_len``, or the sequence's) and returns them as ``caches``.
    ``adapter_idx`` (B,) (mode "decode" only): multi-tenant decode — each
    layer's lora leaves are pools, (A, r, in) and (A, out, r), and slot b
    wears adapter ``adapter_idx[b]``.
    Returns (x, caches, aux): caches is None in mode "train"; aux is the
    sum of the MoE blocks' load-balance losses (an f32 scalar, 0 without
    MoE)."""
    if adapter_idx is not None and mode != "decode":
        raise ValueError(f"adapter_idx is for mode 'decode', not {mode!r} (a paged "
                         "chunk slices its request's adapter out of the pool)")
    gate_lo, gate_hi = rep_gate if rep_gate is not None else (None, None)
    if (gate_lo is not None or gate_hi is not None) and mode != "train":
        raise NotImplementedError("rep_gate requires mode='train' "
                                  "(gated cache slots would be stale)")
    scale = (cfg.lora_alpha / cfg.lora_rank) if lora_scale is None else lora_scale
    P = len(cfg.pattern)
    if rep_slice is not None:
        lo, hi = rep_slice[0] * P, rep_slice[1] * P
        layers = layers[lo:hi]
        lora = None if lora is None else lora[lo:hi]
        caches = None if caches is None else caches[lo:hi]
    if mode == "prefill" and caches is None:
        caches = [None] * len(layers)
    kinds = cfg.layer_kinds
    aux_ungated = _per_row(gate_lo) or _per_row(gate_hi)
    aux = None
    for i in range(len(layers)):
        live = _live_rows(i // P, gate_lo, gate_hi)
        if live is False and not (aux_ungated and kinds[i].mlp == "moe"):
            continue

        def block(x, i=i):
            return apply_block(
                cfg, kinds[i], layers[i], x, lora=None if lora is None else lora[i],
                lora_scale=scale, rt=rt, mode=mode,
                cache=None if caches is None else caches[i],
                cur_index=cur_index, block_tables=block_tables, positions=positions,
                cache_len=cache_len, adapter_idx=adapter_idx)
        y, c, a = (_remat(block, x, rt.remat_policy) if rt.remat and mode == "train"
                   else block(x))
        if a is not None:
            aux = a if aux is None else aux + a
        if live is False:
            continue
        x = y if live is True else torch.where(live.to(x.device)[:, None, None], y, x)
        if caches is not None:
            caches[i] = c
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux
