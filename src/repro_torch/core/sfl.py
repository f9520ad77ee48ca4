"""SflLLM runtime — Algorithm 1 of the paper, the static round of
``repro.core.sfl`` for homogeneous and heterogeneous fleets.

Split-federated semantics, as in JAX:

* K clients each hold the embedding + the first ``ell_k`` layers (frozen)
  plus their *own* client-side LoRA adapter DeltaW_{c,k} of rank r_k;
* the main server holds the remaining layers + LM head (frozen) plus one
  shared server-side adapter DeltaW_s;
* a local step is: client FP -> upload (s_k, y_k) -> server FP + loss over
  the pooled batch (eq. 2) -> server BP + adapter update (eq. 5) ->
  download dL/ds_k -> client BP + adapter update (eq. 6);
* every I local steps the federated server averages the client adapters
  (eq. 7, ``core.aggregation``) and broadcasts the result.

The information flow is the paper's: the server function receives only
split-layer activations and labels (a leaf tensor cut from the clients'
graphs), and the clients receive only the activation gradient.  Where JAX
batches the clients with ``jax.vmap`` and scans the round in one compiled
call, the port runs the clients in a Python loop and the round as eager
steps; every LoRA-adapted projection goes through ``kernels.lora_matmul``
(forward and backward kernels on the card; the q8 kernels over an int8
base from ``precision.quantize_params_int8``).

Heterogeneous fleets (per-client ``ell_c``, ``ranks``, or
:meth:`SflLLM.from_allocation` on a resource-allocation decision): client
adapters are zero-padded to max(r_k) with slot masks
(``core.lora.client_slot_masks``) keeping dead slots exactly zero through
masked updates; FedAvg is slot-wise (``fedavg_het``/``broadcast_het``).
Client k runs its own layers [0, ell_k) (the value JAX's boundary gate
computes, without the dead blocks), and the server runs its layers once
on the pooled batch with a per-sample entry gate
(``models.stack.apply_stack(rep_gate=...)``).  Boundary precision
(``Runtime.precision``, ``act_bits``): the uploaded activations and the
downloaded gradient are fake-quantized outside the client graph — the
straight-through estimator — with optional stochastic rounding and error
feedback (``SflState.err_act``/``err_grad``).

Dynamic wireless rounds (``RoundDynamics``, ``train_round(dynamics=)``):
a (K,) participation mask — explicit, from a round deadline on the
modeled per-client delay (``core.latency.client_round_seconds_host``),
or both multiplied — and, inside a capacity envelope (``ell_range``,
``rank_max``, or ``from_allocation(dynamic=True)``), a per-round
re-allocation of every client's (ell_k, r_k, bits_k) from
:meth:`SflLLM.allocation_dynamics`.  A dropped client still runs its
forward (its upload feeds the quantizer's error feedback, as in
``repro``) but its labels leave the pooled loss, its backward is skipped,
its adapter and optimizer moments freeze and it misses the broadcast;
an empty round freezes the server too.  Every masking op is exact under
full participation, so an all-ones mask gives the static round bit for
bit.

Faults and defenses (``RoundDynamics.byzantine``/``robust``/``poison``):
between the local steps and FedAvg the uploads may be corrupted
(``core.defense.corrupt_updates``; the optimizer moments stay the
client's own), FedAvg may be swapped for the robust aggregator with
per-client anomaly scores (``core.aggregation.robust_aggregate``, against
the round's starting adapters), and ``poison > 0`` NaNs the aggregated
server adapter.  Any non-finite leaf of the new state rolls the whole
round back to its input state, bit for bit.  Benign operands and a
disarmed aggregator give the plain round bit for bit.

Modality front ends (``cfg.frontend``: internvl2-2b, musicgen-large):
the batches may carry ``frontend_emb``, (K, b, F, d) a step and (I, K, b,
F, d) a round; client k puts its rows in front of its embedded text, so
the uploads, the downloaded gradients and the error-feedback accumulators
have F + S rows, and the server's loss drops the F prefix rows.

Client adapter leaves carry a leading K axis, ``(K, ...)``, as in
``repro``'s ``SflState``; adapter trees are per-layer lists.  The
deprecated ``act_quant=True`` warns and maps to 8-bit uploads, as in
``repro``; ``donate=True``, ``repro``'s default, has no effect here (an
eager step builds a new state anyway).

The client axis over ranks (``mesh=``, a ``launch.mesh`` mesh with a
``"clients"`` axis of n ranks, K a multiple of n): ``repro``'s
``sfl_state_shardings`` made explicit.  Each rank holds and runs its K/n
clients — their slice of ``lora_client``, ``opt_client``,
``err_act``/``err_grad`` (the state :meth:`SflLLM.init_state` returns, or
:meth:`SflLLM.shard_state` cuts from a whole one), the batches, slot
masks, scales and dynamics — and runs the server's forward and backward
on its clients' rows.  The callers pass whole batches and dynamics; every
rank cuts its own.  The server adapter and its optimizer state are
replicated: the pooled loss divides by the pool's count of valid labels,
an MoE block's load-balance means are the pool's (``Runtime.pool``), the
server gradient is all-reduced, so every rank steps it identically.
Stochastic rounding draws the whole tensor's noise and cuts its rows, so
a rank rounds its clients as one process would.  Whether anybody is live
is decided over all K (the mask is whole on every rank).  FedAvg and the
robust aggregators all-gather the K adapters, aggregate identically on
every rank, and keep the local slice; losses and anomaly scores come back
whole on every rank, and the roll-back decision is global.  When K is not
a multiple of n every rank runs every client, as ``repro``'s
``_client_spec`` replicates.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..configs import TrainConfig
from ..interop import tree_to
from ..kernels.backend import resolve_device
from ..models import stack as stack_mod
from ..models.layers import apply_norm, unembed
from ..models.model import (IGNORE_ID, cross_entropy, embed_inputs, init_lora_stack, loss_fn,
                            prefix_len, valid_labels)
from ..models.stack import Runtime, default_train_runtime
from ..optim import Optimizer, apply_updates
from ..precision import fake_quant, round_key
from ..sharding.collectives import all_gather_tree, all_reduce, all_reduce_tree
from ..sharding.specs import CLIENT_AXIS
from ..tree import tree_leaves, tree_map, tree_unflatten
from .aggregation import broadcast_het, fedavg_partial, robust_aggregate, tree_all_finite
from .defense import corrupt_updates
from .latency import client_round_seconds_host, workload_tables
from .lora import client_slot_masks
from .split import layers_to_reps, valid_splits

def quantize_activations(s: torch.Tensor) -> torch.Tensor:
    """int8 per-token symmetric fake quantization of split-layer
    activations (``repro``'s standalone reference; the trainer quantizes
    through ``precision.fake_quant``).  Straight-through: the forward sees
    the dequantized value, the backward is the identity.  The scale floor
    1e-8 keeps an all-zero row finite."""
    scale = (s.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    deq = torch.round(s / scale) * scale
    return s + (deq - s).detach()


@dataclass
class SflState:
    lora_client: Any          # per-layer list, leaves (K, ...)
    lora_server: Any          # per-layer list
    opt_client: Any
    opt_server: Any
    step: torch.Tensor        # int32 scalar
    # error-feedback accumulators of the quantized split boundary
    # (``PrecisionConfig.error_feedback``): the compression residual of the
    # activation upload / gradient download, re-injected next step
    err_act: Any = None       # (K, b, S, d) f32 or None
    err_grad: Any = None      # (K, b, S, d) f32 or None


@dataclass
class RoundDynamics:
    """Per-round inputs of a dynamic wireless round (``repro``'s fields).

    Participation: ``participation`` (K,) 0/1, used as given, and/or
    ``deadline_s``, a scalar deadline on each client's modeled delay
    T_k = I(T_k^F + T_k^s + T_k^B) + T_k^f from the channel state
    ``rates_main``/``rates_fed`` (K,) bps and ``f_hz``/``kappa`` (K,), with
    the uploads inflated by the expected HARQ transmission counts
    ``retx_main``/``retx_fed`` (K,).  Both given: the masks multiply.

    Per-round allocation (:meth:`SflLLM.allocation_dynamics`, inside the
    trainer's capacity envelope): ``ell``/``rank`` (K,) for the delay
    model, ``rep_hi`` (K,) split boundaries in repeats, ``slot_masks``
    (per-layer masks as ``core.lora.client_slot_masks`` builds them),
    ``scales`` (K,) alpha / r_k and ``act_bits`` (K,) boundary bit-widths.

    Faults and defenses: ``byzantine`` (``core.defense.ByzantineOps``)
    corrupts the uploads before aggregation, ``robust``
    (``core.aggregation.RobustAggConfig``) replaces FedAvg by the robust
    aggregator and adds ``metrics["anomaly_scores"]``, ``poison`` > 0 NaNs
    the aggregated server adapter (the round then rolls back)."""

    participation: Optional[torch.Tensor] = None
    rates_main: Optional[torch.Tensor] = None
    rates_fed: Optional[torch.Tensor] = None
    f_hz: Optional[torch.Tensor] = None
    kappa: Optional[torch.Tensor] = None
    deadline_s: Optional[torch.Tensor] = None
    ell: Optional[torch.Tensor] = None
    rank: Optional[torch.Tensor] = None
    rep_hi: Optional[torch.Tensor] = None
    slot_masks: Optional[Any] = None
    scales: Optional[torch.Tensor] = None
    retx_main: Optional[torch.Tensor] = None
    retx_fed: Optional[torch.Tensor] = None
    poison: Optional[torch.Tensor] = None
    robust: Optional[Any] = None
    byzantine: Optional[Any] = None
    act_bits: Optional[torch.Tensor] = None


def _host(v, dtype) -> Optional[np.ndarray]:
    """A tensor, sequence or scalar -> numpy of ``dtype`` (None stays None)."""
    if v is None:
        return None
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_()


def _grad_or_zero(v: torch.Tensor) -> torch.Tensor:
    return v.grad if v.grad is not None else torch.zeros_like(v)


def _as_tensors(batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batches -> tensors where they lie (numpy: host)."""
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for k, v in batches.items() if v is not None}


def _batch_to(batches: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batches -> tensors on ``device``."""
    return {k: v.to(device) for k, v in _as_tensors(batches).items()}


def _adapter_ranks(tree: Any, name: str = ""):
    """The rank of every adapter leaf: a (r, d_in), b (d_out, r)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _adapter_ranks(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _adapter_ranks(v, name)
    elif tree is not None:
        yield int(tree.shape[0] if name == "a" else tree.shape[-1])


def _per_client(value, K: int, what: str):
    """An int or a length-K sequence -> a K-tuple of ints."""
    if isinstance(value, (int, np.integer)):
        return (int(value),) * K
    out = tuple(int(v) for v in value)
    if len(out) != K:
        raise ValueError(f"{len(out)} {what} for {K} clients")
    return out


class SflLLM:
    """Split-federated LoRA fine-tuning of one ArchConfig model."""

    def __init__(self, cfg, params: dict, ell_c: Union[int, Sequence[int]],
                 train_cfg, optimizer: Optimizer, rt: Optional[Runtime] = None,
                 device="cuda", *, act_bits: Union[int, Sequence[int], None] = None,
                 ranks: Optional[Sequence[int]] = None,
                 ell_range: Optional[Sequence[int]] = None,
                 rank_max: Optional[int] = None, act_quant: bool = False,
                 aux_coef: Optional[float] = None, mesh=None, donate: bool = True):
        self.cfg = cfg
        self.tc = train_cfg
        self.rt = default_train_runtime() if rt is None else rt
        self.opt = optimizer
        self.device = resolve_device(device)
        # weight of the MoE load-balance aux loss, on both sides of the split
        self.aux_coef = cfg.router_aux_coef if aux_coef is None else aux_coef
        K = train_cfg.num_clients
        P = len(cfg.pattern)

        # ---- the client axis over ranks ---------------------------------
        # this rank runs clients [_lo, _lo + _kl); _group is the "clients"
        # axis's process group (None: one process, or every rank runs all)
        self.mesh = mesh
        self._group, self._lo, self._kl = None, 0, K
        if mesh is not None:
            if CLIENT_AXIS not in mesh.shape:
                raise ValueError(f"SflLLM(mesh=): the mesh has axes {tuple(mesh.shape)}, "
                                 f"not {CLIENT_AXIS!r} (launch.mesh.make_client_mesh)")
            n = mesh.shape[CLIENT_AXIS]
            if K % n == 0 and mesh.group(CLIENT_AXIS) is not None:
                self._group = mesh.group(CLIENT_AXIS)
                self._kl = K // n
                self._lo = mesh.axis_rank(CLIENT_AXIS) * self._kl
        self._rt_server = (self.rt if self._group is None
                           else self.rt.replace(pool=self._group))

        # ---- per-client split points / ranks ----------------------------
        self.ell_k = _per_client(ell_c, K, "split points")
        self.rep_k = tuple(layers_to_reps(cfg, e) for e in self.ell_k)
        self.rep_min, self.rep_max = min(self.rep_k), max(self.rep_k)
        self.rank_k = None if ranks is None else _per_client(ranks, K, "ranks")
        self.r_max = max(self.rank_k) if self.rank_k else cfg.lora_rank

        # ---- capacity envelope (per-round re-allocation) ----------------
        # widen the frozen-weight partition and the adapter rank padding so
        # allocation_dynamics() can move every client's (ell_k, r_k)
        # anywhere inside [ell_range] x [1, rank_max]
        self.dynamic_capacity = ell_range is not None or rank_max is not None
        if ell_range is not None:
            lo, hi = int(min(ell_range)), int(max(ell_range))
            if not 1 <= lo <= hi <= cfg.num_layers:
                raise ValueError(f"ell_range {ell_range} outside [1, {cfg.num_layers}]")
            self.rep_min = min(self.rep_min, layers_to_reps(cfg, lo))
            self.rep_max = max(self.rep_max, layers_to_reps(cfg, hi))
        if rank_max is not None:
            if self.rank_k is None:
                self.rank_k = (cfg.lora_rank,) * K
            self.r_max = max(self.r_max, int(rank_max))
        # gates whenever a client's boundary may sit inside the window the
        # server holds (a mixed fleet or a widened envelope); masks
        # whenever ranks differ or the adapters are padded past every r_k
        self.hetero_split = len(set(self.rep_k)) > 1 or self.rep_min != self.rep_max
        pad_rank = self.rank_k is not None and self.r_max > max(self.rank_k)
        self.hetero = (self.hetero_split or pad_rank
                       or (self.rank_k is not None and len(set(self.rank_k)) > 1))
        # scalar view for homogeneous callers and reports
        self.ell_c = max(self.ell_k)

        # ---- boundary precision -----------------------------------------
        # Runtime.precision is the source of truth; ``act_bits`` (int or
        # per-client, e.g. a HeteroAllocation's bits_k) overrides its
        # act_bits.  An explicit all-16 stays armed: fake_quant's exact
        # disarm returns the input bit for bit.
        self.precision = self.rt.precision
        self.act_quant = bool(act_quant)
        if act_quant:
            warnings.warn(
                "SflLLM(act_quant=True) is deprecated; use "
                "Runtime(precision=PrecisionConfig(act_bits=8)) or the "
                "act_bits kwarg instead", DeprecationWarning, stacklevel=2)
            if act_bits is None and self.precision.act_bits >= 16:
                act_bits = 8
        if act_bits is None:
            act_bits = self.precision.act_bits if self.precision.act_bits < 16 else None
        bits_k = None if act_bits is None else _per_client(act_bits, K, "act_bits")
        if bits_k is not None and any(x not in (4, 8, 16) for x in bits_k):
            raise ValueError(f"act_bits must be 4, 8 or 16, got {bits_k}")
        self.act_bits_k = bits_k
        self._act_bits = (None if bits_k is None
                          else torch.tensor(bits_k, dtype=torch.float32, device=self.device))
        self._grad_bits = (None if self.precision.grad_bits >= 16
                           else torch.full((K,), float(self.precision.grad_bits),
                                           device=self.device))

        # frozen weights, physically partitioned.  Heterogeneous fleets
        # overlap: clients hold the prefix up to max(ell_k), the server
        # holds from min(ell_k) — each sample crosses at its own boundary.
        params = tree_to(params, self.device)
        self.client_base = {"embed": params["embed"],
                            "layers": params["layers"][:self.rep_max * P]}
        self.server_base = {"embed": params["embed"],     # unembedding / LM head
                            "layers": params["layers"][self.rep_min * P:],
                            "final_norm": params["final_norm"]}

        # ---- adapter scales and slot masks ------------------------------
        # explicit ranks scale each client's adapter by alpha/r_k and the
        # padded server adapter by alpha/r_max; None = cfg's alpha/rank
        self._scale_k = (None if self.rank_k is None
                         else tuple(cfg.lora_alpha / r for r in self.rank_k))
        self._server_scale = (cfg.lora_alpha / self.r_max
                              if self.rank_k is not None and self.r_max != cfg.lora_rank
                              else None)
        self._mask_tmpl = None
        self._tables = {}
        self._client_masks = None
        if self.hetero:
            self._client_masks = self._build_client_masks(
                self.rank_k or (self.r_max,) * K, self.rep_k if self.hetero_split else None)

    def _build_client_masks(self, ranks, reps, force: bool = False):
        """Slot masks of a per-client (rank, repeat) configuration against
        the capacity envelope: a template at r_max cut to [:rep_max] layers
        through ``core.lora.client_slot_masks`` — the one construction of
        both the static masks and the per-round ones of
        :meth:`allocation_dynamics`, as in ``repro``."""
        P = len(self.cfg.pattern)
        if self._mask_tmpl is None:
            self._mask_tmpl = init_lora_stack(self.cfg, torch.Generator().manual_seed(0),
                                              rank=self.r_max, device="cpu")[:self.rep_max * P]
        masks = client_slot_masks(self._mask_tmpl, ranks, reps, force=force, pattern_len=P)
        return None if masks is None else tree_to(masks, self.device)

    # ------------------------------------------------------------------
    @classmethod
    def from_allocation(cls, prob, alloc, params: dict, optimizer: Optimizer, *,
                        train_cfg=None, dynamic: bool = False, **kw) -> "SflLLM":
        """Build the trainer straight from a resource-allocation decision:
        ``prob`` a ``core.resource.Problem``, ``alloc`` an ``Allocation``
        (one global pair) or a ``HeteroAllocation`` (per-client ``ell_k``,
        ``rank_k`` and ``bits_k`` from ``bcd_minimize_delay_per_client``).
        ``dynamic=True`` sizes the capacity envelope to the whole search
        space of ``prob``, so per-round re-allocation can move each
        client's (ell_k, r_k).  Other keywords (``rt``, ``device``, ...) go
        to the constructor."""
        K = len(prob.envs)
        if dynamic:
            # the envelope covers prob's whole search space: every valid
            # split x every candidate rank
            splits = valid_splits(prob.cfg)
            kw.setdefault("ell_range", (min(splits), max(splits)))
            kw.setdefault("rank_max", max(prob.rank_candidates))
        if train_cfg is None:
            train_cfg = TrainConfig(num_clients=K, batch_size=prob.batch,
                                    local_steps=prob.local_steps)

        def per_client(vec, scalar):
            v = np.asarray(vec if vec is not None else scalar).reshape(-1)
            return tuple(int(x) for x in (np.full(K, v[0]) if v.size == 1 else v))

        ells = per_client(getattr(alloc, "ell_k", None), alloc.ell_c)
        ranks = per_client(getattr(alloc, "rank_k", None), alloc.rank)
        # per-client boundary precision: HeteroAllocation carries bits_k,
        # the global Allocation one act_bits; 16 = off
        bits = getattr(alloc, "bits_k", None)
        if bits is not None:
            kw.setdefault("act_bits", per_client(bits, None))
        elif int(getattr(alloc, "act_bits", 16) or 16) < 16:
            kw.setdefault("act_bits", int(alloc.act_bits))
        return cls(prob.cfg, params, ells, train_cfg, optimizer, ranks=ranks, **kw)

    def init_lora(self, gen: torch.Generator, dtype=torch.float32):
        """Template adapter for :meth:`init_state` (the full stack), at
        rank max(r_k)."""
        return init_lora_stack(self.cfg, gen, rank=self.r_max, dtype=dtype,
                               device=self.device)

    def init_state(self, lora_template) -> SflState:
        """lora_template: per-layer adapters for the FULL stack, at rank
        max(r_k) when ranks are given (:meth:`init_lora` builds one).  The
        client part is replicated K times (every client starts from the
        same broadcast global adapter, as after an aggregation round) and
        each client's dead slots are zeroed."""
        if self.rank_k is not None:
            bad = {r for r in _adapter_ranks(lora_template) if r != self.r_max}
            if bad:
                raise ValueError(f"template rank {sorted(bad)} != max client rank "
                                 f"{self.r_max}; build the template with SflLLM.init_lora")
        P = len(self.cfg.pattern)
        lora = tree_to(lora_template, self.device)
        lc_k = broadcast_het(lora[:self.rep_max * P], self.tc.num_clients,
                             self._client_masks)
        ls = tree_map(lambda v: v.detach().clone(), lora[self.rep_min * P:])
        return self.shard_state(SflState(
            lora_client=lc_k, lora_server=ls, opt_client=self.opt.init(lc_k),
            opt_server=self.opt.init(ls), step=torch.zeros((), dtype=torch.int32)))

    # ------------------------------------------------------------------
    # the client axis: this rank's slice of K-leading values, and back
    def _mine(self, tree, dim: int = 0, copy: bool = False):
        """This rank's clients of every K-leading leaf (K along ``dim``;
        scalars pass).  Views unless ``copy``; the tree itself when this
        rank runs every client."""
        if self._kl == self.tc.num_clients:
            return tree

        def cut(v):
            if v.dim() <= dim:
                return v
            v = v.narrow(dim, self._lo, self._kl)
            return v.clone() if copy else v
        return tree_map(cut, tree)

    def _gather(self, tree):
        """All K clients of every (K/n, ...) leaf, on every rank."""
        return all_gather_tree(tree, self._group)

    def shard_state(self, state: SflState) -> SflState:
        """This rank's share of a whole state (``repro``'s ``shard_state``
        places one on the mesh): the client leaves cut to its clients, the
        server's kept whole.  The state itself without a client axis."""
        if self._kl == self.tc.num_clients:
            return state
        return dataclasses.replace(
            state, lora_client=self._mine(state.lora_client, copy=True),
            opt_client=self._mine(state.opt_client, copy=True),
            err_act=self._mine(state.err_act, copy=True),
            err_grad=self._mine(state.err_grad, copy=True))

    def gather_state(self, state: SflState) -> SflState:
        """The whole state (all K clients) on every rank; the inverse of
        :meth:`shard_state`."""
        if self._kl == self.tc.num_clients:
            return state
        return dataclasses.replace(
            state, lora_client=self._gather(state.lora_client),
            opt_client=self._gather(state.opt_client), err_act=self._gather(state.err_act),
            err_grad=self._gather(state.err_grad))

    # ------------------------------------------------------------------
    def _client_forward(self, lora_c, tokens: torch.Tensor, frontend_emb=None,
                        rep_hi=None, lora_scale=None):
        """One client's FP: embed + its layers -> (activations s_k, the
        client's MoE aux loss).  ``frontend_emb`` (b, F, d): the client's
        prefix, put in front of its embedded text (which takes positions
        F..F+S-1), so s_k has F + S rows.  ``rep_hi``: the client's own
        boundary in repeats (None = all of the client base); a scalar gate,
        so the repeats past it add no aux, as under ``repro``'s client
        vmap."""
        S = tokens.shape[1] + prefix_len(frontend_emb)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = embed_inputs(self.cfg, self.client_base, tokens, frontend_emb, positions)
        x, _, aux = stack_mod.apply_stack(self.cfg, self.client_base["layers"], x,
                                          positions=positions, lora=lora_c, rt=self.rt,
                                          mode="train", lora_scale=lora_scale,
                                          rep_gate=None if rep_hi is None else (None, rep_hi))
        return x, aux

    def _server_loss(self, lora_s, acts: torch.Tensor, labels: torch.Tensor,
                     rep_lo=None, pooled: bool = True):
        """Pooled loss on the main server.  acts: (K, b, S, d), labels (K,
        b, S_text): the first S - S_text rows of each sequence are the
        front end's prefix, which takes no loss; only the text rows are
        normed and unembedded (the same logits as ``repro``'s, which
        unembeds every row and drops the prefix's).  ``rep_lo``
        (heterogeneous splits): per-sample entry depth in repeats of the
        server base — repeats below it pass the sample through unchanged;
        a per-row gate, so every repeat's MoE aux counts over the whole
        pooled batch, as in ``repro``.  ``pooled``: these are one rank's
        rows of the pool over the client axis, and the loss and aux are
        this rank's shares of the pool's (False: the rows are all there
        is, as in ``eval_loss``).  Returns (loss + aux_coef * aux, loss,
        aux)."""
        K, b, S, d = acts.shape
        x = acts.reshape(K * b, S, d)
        positions = torch.arange(S, dtype=torch.int32, device=acts.device)
        x, _, aux = stack_mod.apply_stack(self.cfg, self.server_base["layers"], x,
                                          positions=positions, lora=lora_s,
                                          rt=self._rt_server if pooled else self.rt,
                                          mode="train", lora_scale=self._server_scale,
                                          rep_gate=None if rep_lo is None else (rep_lo, None))
        labels = labels.reshape(K * b, -1)
        x = apply_norm(self.cfg, x[:, S - labels.shape[1]:], self.server_base["final_norm"])
        logits = unembed(self.cfg, self.server_base["embed"], x)
        denom = (all_reduce(valid_labels(labels), self._group)
                 if pooled and self._group is not None else None)
        loss = cross_entropy(logits, labels, denom)
        return loss + self.aux_coef * aux, loss, aux

    def _client_args(self, k: int, dyn: Optional[dict] = None) -> dict:
        """Client k's boundary and adapter scale for ``_client_forward``:
        this round's re-allocation when ``dyn`` carries one, else the
        trainer's own."""
        if dyn is not None and dyn.get("rep_hi") is not None:
            rep_hi = dyn["rep_hi"][k]
        else:
            rep_hi = self.rep_k[k] if self.hetero_split else None
        if dyn is not None and dyn.get("scales") is not None:
            scale = dyn["scales"][k]
        else:
            scale = None if self._scale_k is None else self._scale_k[k]
        return {"rep_hi": rep_hi, "lora_scale": scale}

    def _rep_lo(self, ks: Sequence[int], b: int, reps: Optional[Sequence[int]] = None):
        """Per-sample server entry depths of the pooled rows of clients
        ``ks`` (b rows each), from ``reps`` (this round's boundaries) or the
        trainer's own; None for a uniform split."""
        if reps is None:
            if not self.hetero_split:
                return None
            reps = self.rep_k
        return [reps[k] - self.rep_min for k in ks for _ in range(b)]

    def _to_device(self, batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return _batch_to(batches, self.device)

    # ------------------------------------------------------------------
    def _step_impl(self, state: SflState, batches: Dict[str, torch.Tensor],
                   dyn: Optional[dict] = None, part: Optional[torch.Tensor] = None):
        """One fine-tuning step (steps a-f of Section IV-A).
        batches: this rank's clients' tokens (K_l, b, S), labels (K_l, b, S)
        and optionally frontend_emb (K_l, b, F, d) on the device (K_l = K
        without a client axis).  ``dyn`` (``rep_hi``/``slot_masks``/
        ``scales``/``act_bits``, host values where per client, all K)
        overrides the trainer's per-client configuration for this round;
        ``part`` is the round's (K,) 0/1 participation mask on the host
        (None = everyone).  Every masking op is exact under full
        participation."""
        tokens, labels = batches["tokens"], batches["labels"]
        fe = batches.get("frontend_emb")
        K, lo, kl = self.tc.num_clients, self._lo, self._kl
        ks = range(lo, lo + kl)
        live = [k for k in ks if part is None or float(part[k]) > 0]
        # an empty round is decided over all K clients, not this rank's
        anyone = part is None or bool((part > 0).any())
        part_l = None if part is None else part[lo:lo + kl]
        if part is not None:
            # a dropped client never uploads: its tokens leave the pooled
            # loss (numerator and denominator), so the server trains on the
            # survivors' pool and the cotangent of its activations is 0
            keep = part_l.to(labels.device).reshape(-1, 1, 1) > 0
            labels = labels.masked_fill(~keep, IGNORE_ID)
        dyn = dyn or {}
        masks = self._mine(dyn["slot_masks"] if dyn.get("slot_masks") is not None
                           else self._client_masks)
        act_bits = self._mine(dyn["act_bits"] if dyn.get("act_bits") is not None
                              else self._act_bits)
        grad_bits = self._mine(self._grad_bits)
        # stochastic rounding draws the whole (K, ...) tensor's noise
        rows = None if kl == K else (lo, K)
        new_err_act, new_err_grad = state.err_act, state.err_grad
        gen_a = gen_g = None
        if self.precision.stochastic_rounding and (
                act_bits is not None or grad_bits is not None):
            step = int(state.step)
            gen_a = round_key(self.precision.rng_seed, step, 0, self.device)
            gen_g = round_key(self.precision.rng_seed, step, 1, self.device)
        with torch.enable_grad():
            # (a) client-side FP, one client at a time, each its own adapter.
            # A dropped client runs too: its upload still passes the
            # quantizer below, whose error feedback covers every client
            lc = [tree_map(lambda v, j=j: _leaf(v[j]), state.lora_client)
                  for j in range(kl)]
            acts_k, aux_k = zip(*(self._client_forward(lc[j], tokens[j],
                                                       None if fe is None else fe[j],
                                                       **self._client_args(k, dyn))
                                  for j, k in enumerate(ks)))
            # (b) upload: the server gets a leaf cut from the client graphs,
            # quantized outside them (the straight-through estimator)
            acts = torch.stack([a.detach() for a in acts_k])
            if act_bits is not None:
                acts, new_err_act = fake_quant(acts, act_bits, gen=gen_a, err=state.err_act,
                                               rows=rows)
            acts.requires_grad_()
            # (c, d) server FP + BP on the pooled activations (this rank's
            # rows of the pool over the client axis)
            ls = tree_map(_leaf, state.lora_server)
            total, loss, aux = self._server_loss(
                ls, acts, labels, self._rep_lo(ks, tokens.shape[1], dyn.get("rep_hi")))
            ls_leaves = tree_leaves(ls)
            grads = torch.autograd.grad(total, ls_leaves + [acts], allow_unused=True)
            g_server = tree_unflatten(
                ls, [g if g is not None else torch.zeros_like(v)
                     for g, v in zip(grads[:-1], ls_leaves)])
            g_acts = grads[-1]
            if self._group is not None:
                # the ranks' shares of the pool's loss and gradient
                g_server = all_reduce_tree(g_server, self._group)
                loss, aux = all_reduce(torch.stack([loss.detach(), aux.detach()]),
                                       self._group)
                total = loss + self.aux_coef * aux
            # (e) download dL/ds_k, quantized like the upload; (f) client BP,
            # for the clients that take part (a dropped one's update is
            # discarded below)
            if grad_bits is not None:
                g_acts, new_err_grad = fake_quant(g_acts, grad_bits, gen=gen_g,
                                                  err=state.err_grad, rows=rows)
            # each client's MoE aux loss enters its backward with the seed
            # aux_coef (a dropped client runs no backward: repro's seed
            # aux_coef * part is 0 there)
            roots, seeds = [], []
            for j, k in enumerate(ks):
                if k not in live:
                    continue
                for t, g in ((acts_k[j], g_acts[j]),
                             (aux_k[j], torch.full_like(aux_k[j], self.aux_coef))):
                    if t.requires_grad:
                        roots.append(t)
                        seeds.append(g)
            if roots:
                torch.autograd.backward(roots, grad_tensors=seeds)
        g_client = tree_map(lambda *vs: torch.stack([_grad_or_zero(v) for v in vs]),
                            lc[0], *lc[1:])
        with torch.no_grad():
            upd_s, opt_s = self.opt.update(g_server, state.opt_server, state.lora_server)
            upd_c, opt_c = self.opt.update(g_client, state.opt_client, state.lora_client)
            if masks is not None:
                # dead slots of the padded adapters stay exactly zero
                upd_c = tree_map(lambda u, m: u * m.to(u.dtype), upd_c, masks)
            if part is not None:
                # a dropped client's adapter AND optimizer moments freeze for
                # the round (zero gradients alone would still decay Adam's)
                pd = part_l.to(self.device)
                pcol = lambda v: pd.reshape((-1,) + (1,) * (v.dim() - 1))  # noqa: E731
                upd_c = tree_map(lambda u: u * pcol(u).to(u.dtype), upd_c)
                opt_c = tree_map(lambda n, o: n if n.dim() == 0
                                 else torch.where(pcol(n) > 0, n, o), opt_c, state.opt_client)
                if not anyone:
                    # an empty round freezes the server as well: nobody
                    # uploaded, nothing trained
                    upd_s = tree_map(torch.zeros_like, upd_s)
                    opt_s = state.opt_server
            new = SflState(lora_client=apply_updates(state.lora_client, upd_c),
                           lora_server=apply_updates(state.lora_server, upd_s),
                           opt_client=opt_c, opt_server=opt_s, step=state.step + 1,
                           err_act=new_err_act, err_grad=new_err_grad)
        return new, {"loss": loss.detach(), "total": total.detach(), "aux": aux.detach()}

    def _ensure_err_state(self, state: SflState, batches: Dict[str, torch.Tensor], *,
                          armed_act: Optional[bool] = None) -> SflState:
        """Attach zero error-feedback accumulators when the config asks for
        them and the state has none yet; a no-op otherwise.  They have the
        uploads' shape (K_l, b, F + S, d), this rank's clients: ``batches``'
        tokens give b and S,
        its frontend_emb (if any) F.  ``armed_act``: the upload is
        quantized this round (default: the trainer's bits)."""
        if not self.precision.error_feedback:
            return state
        if armed_act is None:
            armed_act = self._act_bits is not None
        b, S = batches["tokens"].shape[-2:]
        fe = batches.get("frontend_emb")
        shape = (self._kl, b, S + (0 if fe is None else fe.shape[-2]),
                 self.cfg.d_model)
        zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=self.device)  # noqa: E731
        ea, eg = state.err_act, state.err_grad
        if armed_act and ea is None:
            ea = zeros()
        if self._grad_bits is not None and eg is None:
            eg = zeros()
        if ea is state.err_act and eg is state.err_grad:
            return state
        return dataclasses.replace(state, err_act=ea, err_grad=eg)

    def local_step(self, state: SflState, batches):
        """One local step on K stacked batches (tokens/labels (K, b, S),
        optional frontend_emb (K, b, F, d)); a rank of the client axis cuts
        its own clients' rows."""
        batches = self._to_device(self._mine(_as_tensors(batches)))
        state = self._ensure_err_state(state, batches)
        return self._step_impl(state, batches)

    # ------------------------------------------------------------------
    def _aggregate(self, lora_client, weights, part: Optional[torch.Tensor] = None,
                   masks: Any = None, robust=None, ref: Any = None):
        """Federated-server round (eq. 7) under optional partial
        participation: the global adapter is the survivors' weighted
        average (``fedavg_partial``; slot-wise over each slot's owners for
        a heterogeneous fleet), broadcast with dead slots re-zeroed.  A
        dropped client missed the whole round, broadcast included, and
        keeps its adapter bit for bit; if every client dropped, every
        client keeps its state.  ``masks``: this round's slot masks (None
        = the trainer's).  ``robust`` (a ``RobustAggConfig``) swaps the
        average for ``robust_aggregate`` and scores each client's update
        against ``ref``, the round's starting adapters.  ``lora_client``,
        ``ref`` and ``masks`` hold all K clients.  Returns (the K clients'
        adapters, scores or None)."""
        K = self.tc.num_clients
        masks = self._client_masks if masks is None else masks
        part_w = torch.ones(K, dtype=torch.float32) if part is None else part
        scores = None
        if robust is not None:
            global_c, scores = robust_aggregate(lora_client, ref, weights, part_w,
                                                masks, robust)
        else:
            global_c = fedavg_partial(lora_client, weights, part_w, masks)
        lc_k = broadcast_het(global_c, K, masks)
        if part is not None:
            pd = part.to(self.device)
            lc_k = tree_map(lambda n, o: torch.where(
                pd.reshape((-1,) + (1,) * (n.dim() - 1)) > 0, n, o), lc_k, lora_client)
        return lc_k, scores

    def aggregate(self, state: SflState, sample_counts) -> SflState:
        """FedAvg client adapters + broadcast (eq. 7); over the client axis
        every rank gathers the K adapters and keeps its own slice."""
        lc, _ = self._aggregate(self._gather(state.lora_client),
                                torch.tensor(list(sample_counts), dtype=torch.float32))
        return dataclasses.replace(state, lora_client=self._mine(lc, copy=True))

    def _participation_for(self, dyn: RoundDynamics, batches) -> Optional[torch.Tensor]:
        """The round's (K,) f32 mask on the host, or None (everyone).  An
        explicit ``participation`` and a ``deadline_s`` multiply (a client
        must meet the deadline and not be in outage); either alone is used
        as it is.  The deadline mask is ``T_k <= float32(deadline_s)`` with
        T_k from ``client_round_seconds_host``, the f32 twin of
        ``repro``'s traced delay model as XLA compiles it, so the two
        packages drop the same clients even at T_k one ulp from the
        deadline."""
        K = self.tc.num_clients
        explicit = (None if dyn.participation is None
                    else torch.from_numpy(_host(dyn.participation, np.float32).reshape(K)))
        if dyn.deadline_s is None:
            return explicit
        if dyn.rates_main is None or dyn.rates_fed is None or dyn.f_hz is None \
                or dyn.kappa is None:
            raise ValueError("deadline dropout needs rates_main, rates_fed, f_hz and "
                             "kappa in RoundDynamics")
        I, _, b, S = batches["tokens"].shape
        if S not in self._tables:
            self._tables[S] = workload_tables(self.cfg, S)
        ell = dyn.ell if dyn.ell is not None else self.ell_k
        rank = dyn.rank if dyn.rank is not None else (self.rank_k or (self.cfg.lora_rank,) * K)
        bits = dyn.act_bits if dyn.act_bits is not None else self._act_bits
        t_k = client_round_seconds_host(
            self._tables[S], _host(ell, np.int64), _host(rank, np.float32),
            _host(dyn.f_hz, np.float32), _host(dyn.kappa, np.float32),
            _host(dyn.rates_main, np.float32), _host(dyn.rates_fed, np.float32),
            int(b), int(I), retx_main=_host(dyn.retx_main, np.float32),
            retx_fed=_host(dyn.retx_fed, np.float32), act_bits=_host(bits, np.float32))
        part = torch.from_numpy(
            (t_k <= np.float32(_host(dyn.deadline_s, np.float32))).astype(np.float32))
        return part if explicit is None else part * explicit

    def train_round(self, state: SflState, round_batches, sample_counts,
                    dynamics: Optional[RoundDynamics] = None):
        """One global round: the I local steps, FedAvg and broadcast.
        round_batches: tokens/labels (I, K, b, S), optional frontend_emb
        (I, K, b, F, d).  ``dynamics``: this
        round's :class:`RoundDynamics` (participation / deadline dropout,
        re-allocation, corrupted uploads, robust aggregation, poison).
        Returns (state, metrics) with metrics["loss"], ["total"] (loss +
        aux_coef * aux) and ["aux"] (the server's MoE load-balance loss over
        the pooled batch, 0 without MoE) of shape (I,), ["participation"]
        (K,), the resolved mask,
        ["rolled_back"] and, with ``robust``, ["anomaly_scores"]
        ({"update_norm", "cos_dist"}, (K,) each).  If any floating leaf of
        the new state is not finite, the whole round rolls back: the old
        state is returned unchanged (as ``repro``'s ``tree_all_finite``
        gate does).  Over the client axis every rank passes the whole round
        (all K clients' batches and dynamics) and cuts its own; the losses,
        the mask, the roll-back flag and the scores come back whole."""
        K = self.tc.num_clients
        batches = self._to_device(self._mine(_as_tensors(round_batches), dim=1))
        weights = torch.tensor(list(sample_counts), dtype=torch.float32)
        dyn = RoundDynamics() if dynamics is None else dynamics
        part = self._participation_for(dyn, batches)
        cfg_dyn = None
        if (dyn.rep_hi is not None or dyn.slot_masks is not None
                or dyn.scales is not None or dyn.act_bits is not None):
            # per-client values on the host, tensors on the device
            cfg_dyn = {
                "rep_hi": None if dyn.rep_hi is None else _host(dyn.rep_hi, int).tolist(),
                "slot_masks": (None if dyn.slot_masks is None
                               else tree_to(dyn.slot_masks, self.device)),
                "scales": None if dyn.scales is None else _host(dyn.scales, np.float32).tolist(),
                "act_bits": (None if dyn.act_bits is None else torch.as_tensor(
                    dyn.act_bits, dtype=torch.float32).to(self.device))}
        state = self._ensure_err_state(
            state, batches, armed_act=self._act_bits is not None or dyn.act_bits is not None)
        # the round's starting (post-broadcast) adapters: the local steps
        # build new tensors, so this stays the pre-round upload reference
        ref = state.lora_client
        new, steps = state, []
        for i in range(batches["tokens"].shape[0]):
            new, m = self._step_impl(new, {k: v[i] for k, v in batches.items()}, cfg_dyn, part)
            steps.append(m)
        # the federated server sees all K uploads: gathered over the client
        # axis, aggregated alike on every rank, each keeping its slice
        lc = self._gather(new.lora_client)
        if dyn.byzantine is not None or dyn.robust is not None:
            ref = self._gather(ref)
        if dyn.byzantine is not None:
            # the corrupted radio payload; the optimizer moments stay the
            # client's own
            lc = corrupt_updates(lc, ref, dyn.byzantine)
        lc, scores = self._aggregate(lc, weights, part,
                                     None if cfg_dyn is None else cfg_dyn["slot_masks"],
                                     dyn.robust, ref)
        new = dataclasses.replace(new, lora_client=self._mine(lc, copy=True))
        if dyn.poison is not None and float(dyn.poison) > 0:
            new = dataclasses.replace(new, lora_server=tree_map(
                lambda v: torch.full_like(v, float("nan")), new.lora_server))
        finite = tree_all_finite([new.lora_client, new.lora_server, new.opt_client,
                                  new.opt_server, new.err_act, new.err_grad])
        if self._group is not None:
            # one rank's non-finite leaf rolls every rank back
            finite = all_reduce(finite.float().to(self.device), self._group, "min") > 0
        finite = bool(finite)
        metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        metrics.update({"participation": torch.ones(K) if part is None else part,
                        "rolled_back": torch.tensor(not finite)})
        if scores is not None:
            metrics["anomaly_scores"] = scores
        return (new if finite else state), metrics

    def allocation_dynamics(self, ell_k, rank_k, bits_k=None) -> Dict[str, Any]:
        """A per-client allocation decision as :class:`RoundDynamics`
        keywords (``ell``, ``rank``, ``rep_hi``, ``slot_masks``, ``scales``,
        and ``act_bits`` when ``bits_k`` is given) against this trainer's
        capacity envelope; raises ``ValueError`` when a split or rank falls
        outside it (build with ``from_allocation(dynamic=True)``)."""
        K = self.tc.num_clients
        ells = tuple(int(e) for e in np.asarray(ell_k).reshape(-1))
        ranks = tuple(int(r) for r in np.asarray(rank_k).reshape(-1))
        if len(ells) != K or len(ranks) != K:
            raise ValueError(f"{len(ells)} splits / {len(ranks)} ranks for {K} clients")
        reps = tuple(layers_to_reps(self.cfg, e) for e in ells)
        if max(reps) > self.rep_max or min(reps) < self.rep_min:
            raise ValueError(
                f"split points {ells} leave the capacity envelope reps [{self.rep_min}, "
                f"{self.rep_max}]; build the trainer with ell_range "
                "(from_allocation(dynamic=True))")
        if max(ranks) > self.r_max:
            raise ValueError(f"rank {max(ranks)} > capacity r_max {self.r_max}; "
                             "build with rank_max")
        out = dict(ell=torch.tensor(ells, dtype=torch.int32),
                   rank=torch.tensor(ranks, dtype=torch.float32),
                   rep_hi=torch.tensor(reps, dtype=torch.int32),
                   slot_masks=self._build_client_masks(ranks, reps, force=True),
                   scales=torch.tensor([self.cfg.lora_alpha / r for r in ranks],
                                       dtype=torch.float32))
        if bits_k is not None:
            bits = tuple(int(x) for x in np.asarray(bits_k).reshape(-1))
            if len(bits) != K:
                raise ValueError(f"{len(bits)} bit-widths for {K} clients")
            if any(x not in (4, 8, 16) for x in bits):
                raise ValueError(f"bits_k must be 4, 8 or 16, got {bits}")
            out["act_bits"] = torch.tensor(bits, dtype=torch.float32)
        return out

    def train(self, state: SflState, data_iter, *, global_rounds: int,
              sample_counts, log_every: int = 0, callback=None):
        """E global rounds x I local steps (Algorithm 1)."""
        from ..data.pipeline import stack_rounds

        history = []
        for e in range(global_rounds):
            round_batches = stack_rounds(data_iter, self.tc.local_steps)
            state, metrics = self.train_round(state, round_batches, sample_counts)
            for i, loss in enumerate(metrics["loss"].tolist()):
                history.append(loss)
                if log_every and len(history) % log_every == 0:
                    print(f"round {e} step {i} loss {loss:.4f}")
            if callback is not None:
                callback(state, history)
        return state, history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, state: SflState, batch) -> torch.Tensor:
        """Validation loss through client 0's adapter, split and scale
        (after aggregation every client holds the slots client 0 owns)."""
        batch = self._to_device(batch)
        lora_c0 = tree_map(lambda v: v[0], self._gather(state.lora_client))
        acts, _ = self._client_forward(lora_c0, batch["tokens"], batch.get("frontend_emb"),
                                       **self._client_args(0))
        return self._server_loss(state.lora_server, acts[None], batch["labels"][None],
                                 self._rep_lo([0], batch["tokens"].shape[0]), pooled=False)[1]


# ---------------------------------------------------------------------------
# centralized baseline (Section VII-B comparison)
# ---------------------------------------------------------------------------

class CentralizedLoRA:
    """Pooled-data LoRA fine-tuning — the paper's comparison baseline."""

    def __init__(self, cfg, params: dict, train_cfg, optimizer: Optimizer,
                 rt: Optional[Runtime] = None, device="cuda"):
        self.cfg, self.tc, self.opt = cfg, train_cfg, optimizer
        self.rt = default_train_runtime() if rt is None else rt
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)

    def init_state(self, lora):
        """Fresh copies on the device: the caller's template stays intact."""
        lora = tree_map(lambda v: v.detach().clone(), tree_to(lora, self.device))
        return lora, self.opt.init(lora)

    def step(self, lora, opt_state, batch):
        batch = _batch_to(batch, self.device)
        with torch.enable_grad():
            leaves_tree = tree_map(_leaf, lora)
            total, m = loss_fn(self.cfg, self.params, leaves_tree, batch, rt=self.rt)
            leaves = tree_leaves(leaves_tree)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_unflatten(lora, [g if g is not None else torch.zeros_like(v)
                                      for g, v in zip(grads, leaves)])
        upd, opt_state = self.opt.update(grads, opt_state, lora)
        m = {k: v.detach() for k, v in m.items()}
        return apply_updates(lora, upd), opt_state, m

    def train_round(self, state, round_batches):
        """One round over the leading step axis of round_batches
        (tokens/labels (I, B, S)).  state = (lora, opt_state)."""
        lora, opt_state = state
        ms = []
        batches = _batch_to(round_batches, self.device)
        for i in range(batches["tokens"].shape[0]):
            lora, opt_state, m = self.step(lora, opt_state,
                                           {k: v[i] for k, v in batches.items()})
            ms.append(m)
        return (lora, opt_state), {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
