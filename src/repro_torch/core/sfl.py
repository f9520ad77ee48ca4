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

Client adapter leaves carry a leading K axis, ``(K, ...)``, as in
``repro``'s ``SflState``; adapter trees are per-layer lists.  The dynamic
(``RoundDynamics``, capacity envelope), mesh and robust paths are not
ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..configs import TrainConfig
from ..interop import tree_to
from ..kernels.backend import resolve_device
from ..models import stack as stack_mod
from ..models.layers import apply_norm, embed, unembed
from ..models.model import cross_entropy, init_lora_stack, loss_fn
from ..models.stack import Runtime, default_train_runtime
from ..optim import Optimizer, apply_updates
from ..precision import fake_quant, round_key
from ..tree import tree_leaves, tree_map, tree_unflatten
from .aggregation import broadcast_het, broadcast_stacked, fedavg_partial, tree_all_finite
from .lora import client_slot_masks
from .split import layers_to_reps

_NOT_PORTED = ("SflLLM: {} belong(s) to the dynamic, mesh or robust paths of "
               "repro's SflLLM, which are not ported yet (ROADMAP.md, Open items)")


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


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_()


def _grad_or_zero(v: torch.Tensor) -> torch.Tensor:
    return v.grad if v.grad is not None else torch.zeros_like(v)


def _batch_to(batches: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batches -> tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batches.items() if v is not None}


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
                 ranks: Optional[Sequence[int]] = None, **unported):
        # repro's capacity envelope (ell_range, rank_max), mesh and the
        # deprecated act_quant shim: refused unless left at their defaults
        refused = sorted(k for k, v in unported.items() if v is not None and v is not False)
        if refused:
            raise NotImplementedError(_NOT_PORTED.format(refused))
        self.cfg = cfg
        self.tc = train_cfg
        self.rt = default_train_runtime() if rt is None else rt
        self.opt = optimizer
        self.device = resolve_device(device)
        K = train_cfg.num_clients
        P = len(cfg.pattern)

        # ---- per-client split points / ranks ----------------------------
        self.ell_k = _per_client(ell_c, K, "split points")
        self.rep_k = tuple(layers_to_reps(cfg, e) for e in self.ell_k)
        self.rep_min, self.rep_max = min(self.rep_k), max(self.rep_k)
        self.rank_k = None if ranks is None else _per_client(ranks, K, "ranks")
        self.r_max = max(self.rank_k) if self.rank_k else cfg.lora_rank
        self.hetero_split = len(set(self.rep_k)) > 1
        self.hetero = self.hetero_split or (self.rank_k is not None
                                            and len(set(self.rank_k)) > 1)
        # scalar view for homogeneous callers and reports
        self.ell_c = max(self.ell_k)

        # ---- boundary precision -----------------------------------------
        # Runtime.precision is the source of truth; ``act_bits`` (int or
        # per-client, e.g. a HeteroAllocation's bits_k) overrides its
        # act_bits.  An explicit all-16 stays armed: fake_quant's exact
        # disarm returns the input bit for bit.
        self.precision = self.rt.precision
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
        self._client_masks = None
        if self.hetero:
            tmpl = init_lora_stack(cfg, torch.Generator().manual_seed(0), rank=self.r_max,
                                   device="cpu")[:self.rep_max * P]
            masks = client_slot_masks(tmpl, self.rank_k or (self.r_max,) * K,
                                      self.rep_k if self.hetero_split else None,
                                      pattern_len=P)
            self._client_masks = None if masks is None else tree_to(masks, self.device)

    # ------------------------------------------------------------------
    @classmethod
    def from_allocation(cls, prob, alloc, params: dict, optimizer: Optimizer, *,
                        train_cfg=None, dynamic: bool = False, **kw) -> "SflLLM":
        """Build the trainer straight from a resource-allocation decision:
        ``prob`` a ``core.resource.Problem``, ``alloc`` an ``Allocation``
        (one global pair) or a ``HeteroAllocation`` (per-client ``ell_k``,
        ``rank_k`` and ``bits_k`` from ``bcd_minimize_delay_per_client``).
        Other keywords (``rt``, ``device``, ...) go to the constructor."""
        if dynamic:
            raise NotImplementedError(_NOT_PORTED.format("from_allocation(dynamic=True)"))
        K = len(prob.envs)
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
        return SflState(lora_client=lc_k, lora_server=ls,
                        opt_client=self.opt.init(lc_k), opt_server=self.opt.init(ls),
                        step=torch.zeros((), dtype=torch.int32))

    # ------------------------------------------------------------------
    def _client_forward(self, lora_c, tokens: torch.Tensor, rep_hi=None,
                        lora_scale=None) -> torch.Tensor:
        """One client's FP: embed + its layers -> activations s_k.
        ``rep_hi``: the client's own boundary in repeats (None = all of
        the client base)."""
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = embed(self.cfg, self.client_base["embed"], tokens, positions)
        x, _ = stack_mod.apply_stack(self.cfg, self.client_base["layers"], x,
                                     positions=positions, lora=lora_c, rt=self.rt,
                                     mode="train", lora_scale=lora_scale,
                                     rep_gate=None if rep_hi is None else (None, rep_hi))
        return x

    def _server_loss(self, lora_s, acts: torch.Tensor, labels: torch.Tensor,
                     rep_lo=None):
        """Pooled loss on the main server.  acts: (K, b, S, d).  ``rep_lo``
        (heterogeneous splits): per-sample entry depth in repeats of the
        server base — repeats below it pass the sample through unchanged."""
        K, b, S, d = acts.shape
        x = acts.reshape(K * b, S, d)
        positions = torch.arange(S, dtype=torch.int32, device=acts.device)
        x, _ = stack_mod.apply_stack(self.cfg, self.server_base["layers"], x,
                                     positions=positions, lora=lora_s, rt=self.rt,
                                     mode="train", lora_scale=self._server_scale,
                                     rep_gate=None if rep_lo is None else (rep_lo, None))
        x = apply_norm(self.cfg, x, self.server_base["final_norm"])
        logits = unembed(self.cfg, self.server_base["embed"], x)
        return cross_entropy(logits, labels.reshape(K * b, -1))

    def _client_args(self, k: int) -> dict:
        """Client k's boundary and adapter scale for ``_client_forward``."""
        return {"rep_hi": self.rep_k[k] if self.hetero_split else None,
                "lora_scale": None if self._scale_k is None else self._scale_k[k]}

    def _rep_lo(self, ks: Sequence[int], b: int):
        """Per-sample server entry depths of the pooled rows of clients
        ``ks`` (b rows each), or None for a uniform split."""
        if not self.hetero_split:
            return None
        return [self.rep_k[k] - self.rep_min for k in ks for _ in range(b)]

    def _to_device(self, batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return _batch_to(batches, self.device)

    # ------------------------------------------------------------------
    def _step_impl(self, state: SflState, batches: Dict[str, torch.Tensor]):
        """One fine-tuning step (steps a-f of Section IV-A).
        batches: tokens (K, b, S), labels (K, b, S) on the device."""
        tokens, labels = batches["tokens"], batches["labels"]
        K = self.tc.num_clients
        new_err_act, new_err_grad = state.err_act, state.err_grad
        gen_a = gen_g = None
        if self.precision.stochastic_rounding and (
                self._act_bits is not None or self._grad_bits is not None):
            step = int(state.step)
            gen_a = round_key(self.precision.rng_seed, step, 0, self.device)
            gen_g = round_key(self.precision.rng_seed, step, 1, self.device)
        with torch.enable_grad():
            # (a) client-side FP, one client at a time, each its own adapter
            lc = [tree_map(lambda v, k=k: _leaf(v[k]), state.lora_client)
                  for k in range(K)]
            acts_k = [self._client_forward(lc[k], tokens[k], **self._client_args(k))
                      for k in range(K)]
            # (b) upload: the server gets a leaf cut from the client graphs,
            # quantized outside them (the straight-through estimator)
            acts = torch.stack([a.detach() for a in acts_k])
            if self._act_bits is not None:
                acts, new_err_act = fake_quant(acts, self._act_bits, gen=gen_a,
                                               err=state.err_act)
            acts.requires_grad_()
            # (c, d) server FP + BP on the pooled activations
            ls = tree_map(_leaf, state.lora_server)
            loss = self._server_loss(ls, acts, labels, self._rep_lo(range(K),
                                                                    tokens.shape[1]))
            ls_leaves = tree_leaves(ls)
            grads = torch.autograd.grad(loss, ls_leaves + [acts], allow_unused=True)
            g_server = tree_unflatten(
                ls, [g if g is not None else torch.zeros_like(v)
                     for g, v in zip(grads[:-1], ls_leaves)])
            g_acts = grads[-1]
            # (e) download dL/ds_k, quantized like the upload; (f) client BP
            if self._grad_bits is not None:
                g_acts, new_err_grad = fake_quant(g_acts, self._grad_bits, gen=gen_g,
                                                  err=state.err_grad)
            if any(a.requires_grad for a in acts_k):
                torch.autograd.backward(acts_k, grad_tensors=list(g_acts.unbind(0)))
        g_client = tree_map(lambda *vs: torch.stack([_grad_or_zero(v) for v in vs]),
                            lc[0], *lc[1:])
        with torch.no_grad():
            upd_s, opt_s = self.opt.update(g_server, state.opt_server, state.lora_server)
            upd_c, opt_c = self.opt.update(g_client, state.opt_client, state.lora_client)
            if self._client_masks is not None:
                # dead slots of the padded adapters stay exactly zero
                upd_c = tree_map(lambda u, m: u * m.to(u.dtype), upd_c, self._client_masks)
            new = SflState(lora_client=apply_updates(state.lora_client, upd_c),
                           lora_server=apply_updates(state.lora_server, upd_s),
                           opt_client=opt_c, opt_server=opt_s, step=state.step + 1,
                           err_act=new_err_act, err_grad=new_err_grad)
        loss = loss.detach()
        return new, {"loss": loss, "total": loss}

    def _ensure_err_state(self, state: SflState, b: int, S: int) -> SflState:
        """Attach zero error-feedback accumulators when the config asks for
        them and the state has none yet; a no-op otherwise."""
        if not self.precision.error_feedback:
            return state
        shape = (self.tc.num_clients, b, S, self.cfg.d_model)
        zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=self.device)  # noqa: E731
        ea, eg = state.err_act, state.err_grad
        if self._act_bits is not None and ea is None:
            ea = zeros()
        if self._grad_bits is not None and eg is None:
            eg = zeros()
        if ea is state.err_act and eg is state.err_grad:
            return state
        return dataclasses.replace(state, err_act=ea, err_grad=eg)

    def local_step(self, state: SflState, batches):
        """One local step on K stacked batches (tokens/labels (K, b, S))."""
        batches = self._to_device(batches)
        state = self._ensure_err_state(state, *batches["tokens"].shape[-2:])
        return self._step_impl(state, batches)

    # ------------------------------------------------------------------
    def _aggregate(self, state: SflState, weights) -> SflState:
        """Federated-server round (eq. 7): weighted average over the client
        axis with every client participating — slot-wise over each slot's
        owners for a heterogeneous fleet — then broadcast, dead slots
        re-zeroed."""
        K = self.tc.num_clients
        global_c = fedavg_partial(state.lora_client, weights,
                                  torch.ones(K, dtype=torch.float32), self._client_masks)
        return dataclasses.replace(
            state, lora_client=broadcast_het(global_c, K, self._client_masks))

    def aggregate(self, state: SflState, sample_counts) -> SflState:
        """FedAvg client adapters + broadcast (eq. 7)."""
        return self._aggregate(state, torch.tensor(list(sample_counts),
                                                   dtype=torch.float32))

    def train_round(self, state: SflState, round_batches, sample_counts,
                    dynamics=None):
        """One global round: the I local steps, FedAvg and broadcast.
        round_batches: tokens/labels (I, K, b, S).  Returns (state, metrics)
        with metrics["loss"] and ["total"] of shape (I,), ["participation"]
        (K,) and ["rolled_back"].  If any floating leaf of the new state is
        not finite, the whole round rolls back: the old state is returned
        unchanged (as ``repro``'s ``tree_all_finite`` gate does)."""
        if dynamics is not None:
            raise NotImplementedError(_NOT_PORTED.format("RoundDynamics"))
        batches = self._to_device(round_batches)
        weights = torch.tensor(list(sample_counts), dtype=torch.float32)
        state = self._ensure_err_state(state, *batches["tokens"].shape[-2:])
        new, losses = state, []
        for i in range(batches["tokens"].shape[0]):
            new, m = self._step_impl(new, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
        new = self._aggregate(new, weights)
        finite = bool(tree_all_finite([new.lora_client, new.lora_server, new.opt_client,
                                       new.opt_server, new.err_act, new.err_grad]))
        loss = torch.stack(losses)
        metrics = {"loss": loss, "total": loss,
                   "participation": torch.ones(self.tc.num_clients),
                   "rolled_back": torch.tensor(not finite)}
        return (new if finite else state), metrics

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
        lora_c0 = tree_map(lambda v: v[0], state.lora_client)
        acts = self._client_forward(lora_c0, batch["tokens"], **self._client_args(0))
        return self._server_loss(state.lora_server, acts[None], batch["labels"][None],
                                 self._rep_lo([0], batch["tokens"].shape[0]))


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
