"""Architecture configuration dataclasses (the port's own copy).

A config is a *pattern* of layer blocks (mixer, mlp) repeated over depth.
Field names, defaults and ``reduced`` match ``repro.configs.base`` so that
a config built on either side describes the same model.  The modality
front ends are stubs, as in ``repro``: ``frontend`` names the modality and
``frontend_tokens`` the length F of the prefix of precomputed, already
projected embeddings (B, F, d_model) that the model takes in front of the
text.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

Mixer = Literal["attention", "mamba"]
Mlp = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerPattern:
    """One sub-layer inside the repeating depth pattern."""

    mixer: Mixer = "attention"
    mlp: Mlp = "dense"


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str
    family: str = "dense"
    source: str = ""                    # citation for the config numbers

    # trunk dimensions ------------------------------------------------------
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 3072
    vocab_size: int = 50257

    # depth pattern (len must divide num_layers) ---------------------------
    pattern: Tuple[LayerPattern, ...] = (LayerPattern(),)

    # attention ------------------------------------------------------------
    attn_window: int = 0                # 0 = full attention
    rope_theta: float = 10_000.0
    pos_emb: Literal["rope", "learned", "none"] = "rope"

    # mlp / norm -----------------------------------------------------------
    mlp_kind: Literal["swiglu", "gelu_mlp"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False         # llama4-style always-on expert
    router_aux_coef: float = 0.01       # load-balance loss weight

    # Mamba2 / SSD -----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256                # SSD chunk length

    # modality frontend (a stub: precomputed embeddings of F tokens) --------
    frontend: Optional[Literal["vision", "audio"]] = None
    frontend_tokens: int = 0            # prefix length of stub embeddings

    # fine-tuning (the paper's technique) -----------------------------------
    lora_rank: int = 4
    lora_alpha: float = 8.0
    lora_targets: Tuple[str, ...] = ("q", "v")
    max_seq_len: int = 8192

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: pattern length {len(self.pattern)} must divide "
                f"num_layers {self.num_layers}")
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def layer_kinds(self) -> Tuple[LayerPattern, ...]:
        """Per-layer (mixer, mlp) for all ``num_layers`` layers; layer
        ``r * len(pattern) + p`` is repeat r at pattern position p."""
        return tuple(self.pattern[i % len(self.pattern)] for i in range(self.num_layers))

    @property
    def has_attention(self) -> bool:
        return any(p.mixer == "attention" for p in self.pattern)

    @property
    def pure_full_attention(self) -> bool:
        return self.has_attention and self.attn_window == 0 and all(
            p.mixer == "attention" for p in self.pattern)

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ArchConfig":
        """A tiny same-family variant for CPU tests (same rule as
        ``repro``'s, so both packages shrink a config identically)."""
        if num_layers % len(self.pattern) != 0:
            num_layers = len(self.pattern)
        num_heads = min(self.num_heads, 4) or 0
        num_kv = min(self.num_kv_heads, num_heads) or 0
        if num_heads and num_kv and num_heads % num_kv:
            num_kv = 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=(d_model // num_heads) if num_heads else 0,
            d_ff=0 if self.d_ff == 0 else max(64, d_model * 2),
            vocab_size=vocab,
            num_experts=min(self.num_experts, max_experts),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            frontend_tokens=min(self.frontend_tokens, 8),
            max_seq_len=256,
        )

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes (``configs.shapes``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class TrainConfig:
    """SFL fine-tuning hyper-parameters (paper Section VII defaults) — the
    twin of ``repro.configs.base.TrainConfig``."""

    batch_size: int = 16                 # b, per client mini-batch
    learning_rate: float = 4e-4          # eta_c = eta_s
    num_clients: int = 5                 # K
    local_steps: int = 12                # I (aggregation interval)
    global_rounds: int = 10              # E
    seed: int = 0
    optimizer: str = "adamw"
    schedule: str = "constant"
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
