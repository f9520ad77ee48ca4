"""Per-layer computation / communication workload tables.

Produces the paper's Section V quantities analytically from an ArchConfig:

    rho_j        FP FLOPs of the frozen weights at layer j, per sample
    varpi_j      BP FLOPs (paper assumption: 2 x FP)
    drho_j       FP FLOPs of the LoRA path at layer j, per rank per sample
    dvarpi_j     BP FLOPs of the LoRA path (2 x FP)
    psi_j        activation bytes at the output of layer j, per sample
    dxi_j        LoRA parameter bytes at layer j, per rank

Embedding/positional FLOPs are neglected (paper Section VII); the LM head
FLOPs are accounted as a server-side constant (the server always holds it).

The port's copy of ``repro.core.workload``: attention and Mamba2 mixers,
dense and MoE MLPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class LayerWorkload:
    rho: float          # FP FLOPs, frozen weights, per sample
    drho: float         # FP FLOPs, LoRA path, per rank per sample
    psi: float          # activation bytes at layer output, per sample
    dxi: float          # LoRA param bytes, per rank

    @property
    def varpi(self) -> float:
        return 2.0 * self.rho

    @property
    def dvarpi(self) -> float:
        return 2.0 * self.drho


def _attn_flops(cfg: ArchConfig, S: int) -> float:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2.0 * S * d * (h * hd) * 2 + 2.0 * S * d * (kh * hd) * 2
    ctx = cfg.attn_window if cfg.attn_window else S
    ctx = min(ctx, S)
    attn = 2.0 * S * ctx * h * hd * 2        # scores + PV (full, per paper)
    return proj + attn


def _mlp_flops(cfg: ArchConfig, S: int) -> float:
    n_mat = 3 if cfg.mlp_kind == "swiglu" else 2
    return 2.0 * S * cfg.d_model * cfg.d_ff * n_mat


def _moe_flops(cfg: ArchConfig, S: int) -> float:
    router = 2.0 * S * cfg.d_model * cfg.num_experts
    expert = 2.0 * S * cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff
    shared = _mlp_flops(cfg, S) if cfg.shared_expert else 0.0
    return router + expert + shared


def _mamba_flops(cfg: ArchConfig, S: int) -> float:
    d, di, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    conv_dim = di + 2 * N
    proj_in = 2.0 * S * d * (2 * di + 2 * N + nh)
    conv = 2.0 * S * cfg.ssm_conv_width * conv_dim
    Q = cfg.ssm_chunk
    # SSD: intra-chunk (CB^T, masking, PV) + state build/apply
    intra = 2.0 * S * min(Q, S) * (N + 2 * nh * cfg.ssm_head_dim)
    states = 4.0 * S * nh * cfg.ssm_head_dim * N
    proj_out = 2.0 * S * di * d
    return proj_in + conv + intra + states + proj_out


def _lora_flops_per_rank(cfg: ArchConfig, pat, S: int) -> float:
    from ..models.model import _lora_dims

    total = 0.0
    for t in cfg.lora_targets:
        dims = _lora_dims(cfg, pat, t)
        if dims is not None:
            _, d_in, d_out = dims
            total += 2.0 * S * (d_in + d_out)
    return total


def _lora_bytes_per_rank(cfg: ArchConfig, pat, bytes_per_param: int) -> float:
    from ..models.model import _lora_dims

    n = 0
    for t in cfg.lora_targets:
        dims = _lora_dims(cfg, pat, t)
        if dims is not None:
            _, d_in, d_out = dims
            n += d_in + d_out
    return float(n * bytes_per_param)


def layer_workloads(cfg: ArchConfig, seq_len: int, *,
                    bytes_per_act: int = 2,
                    bytes_per_param: int = 4) -> List[LayerWorkload]:
    """One LayerWorkload per transformer layer (index j of the paper)."""
    S = seq_len
    out = []
    for pat in cfg.layer_kinds:
        rho = _attn_flops(cfg, S) if pat.mixer == "attention" else _mamba_flops(cfg, S)
        if pat.mlp == "dense":
            rho += _mlp_flops(cfg, S)
        elif pat.mlp == "moe":
            rho += _moe_flops(cfg, S)
        out.append(LayerWorkload(
            rho=rho,
            drho=_lora_flops_per_rank(cfg, pat, S),
            psi=float(S * cfg.d_model * bytes_per_act),
            dxi=_lora_bytes_per_rank(cfg, pat, bytes_per_param),
        ))
    return out


def lm_head_flops(cfg: ArchConfig, seq_len: int) -> float:
    return 2.0 * seq_len * cfg.d_model * cfg.vocab_size


def model_flops_per_token(cfg: ArchConfig, seq_len: int,
                          active_only: bool = True) -> float:
    """6*N*D-style estimate support: FP FLOPs per token for one pass."""
    ws = layer_workloads(cfg, seq_len)
    total = sum(w.rho for w in ws) + lm_head_flops(cfg, seq_len)
    return total / seq_len
