"""SflLLM runtime — Algorithm 1 of the paper, the homogeneous round of
``repro.core.sfl``.

Split-federated semantics, as in JAX:

* K clients each hold the embedding + the first ``ell_c`` layers (frozen)
  plus their *own* client-side LoRA adapter DeltaW_{c,k};
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
(forward and backward kernels on the card).

Client adapter leaves carry a leading K axis, ``(K, ...)``, as in
``repro``'s ``SflState``; adapter trees are per-layer lists.  The
heterogeneous, dynamic, precision, mesh and robust paths are not ported
yet (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..interop import tree_to
from ..models import stack as stack_mod
from ..models.layers import apply_norm, embed, unembed
from ..models.model import cross_entropy, init_lora_stack, loss_fn
from ..models.stack import Runtime, default_train_runtime
from ..optim import Optimizer, apply_updates
from ..tree import tree_leaves, tree_map, tree_unflatten
from .aggregation import broadcast_stacked, fedavg_partial, tree_all_finite
from .split import layers_to_reps

_NOT_PORTED = ("SflLLM: {} belong(s) to the heterogeneous, dynamic, precision, "
               "mesh or robust paths of repro's SflLLM, which are not ported yet "
               "(ROADMAP.md, Open items)")


@dataclass
class SflState:
    lora_client: Any          # per-layer list, leaves (K, ...)
    lora_server: Any          # per-layer list
    opt_client: Any
    opt_server: Any
    step: torch.Tensor        # int32 scalar


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_()


def _grad_or_zero(v: torch.Tensor) -> torch.Tensor:
    return v.grad if v.grad is not None else torch.zeros_like(v)


def _batch_to(batches: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batches -> tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batches.items() if v is not None}


class SflLLM:
    """Split-federated LoRA fine-tuning of one ArchConfig model."""

    def __init__(self, cfg, params: dict, ell_c: Union[int, Sequence[int]],
                 train_cfg, optimizer: Optimizer, rt: Optional[Runtime] = None,
                 device="cuda", **unported):
        if unported:
            raise NotImplementedError(_NOT_PORTED.format(sorted(unported)))
        if not isinstance(ell_c, (int, np.integer)):
            ells = {int(e) for e in ell_c}
            if len(ells) != 1:
                raise NotImplementedError(_NOT_PORTED.format("per-client ell_c"))
            ell_c = ells.pop()
        self.cfg = cfg
        self.tc = train_cfg
        self.rt = default_train_runtime() if rt is None else rt
        self.opt = optimizer
        self.device = resolve_device(device)
        self.ell_c = int(ell_c)
        self.rep_split = layers_to_reps(cfg, self.ell_c)
        params = tree_to(params, self.device)
        # frozen weights, physically partitioned at the split point
        self.client_base = {"embed": params["embed"],
                            "layers": params["layers"][:self.ell_c]}
        self.server_base = {"embed": params["embed"],     # unembedding / LM head
                            "layers": params["layers"][self.ell_c:],
                            "final_norm": params["final_norm"]}

    # ------------------------------------------------------------------
    def init_lora(self, gen: torch.Generator, dtype=torch.float32):
        """Template adapter for :meth:`init_state` (the full stack)."""
        return init_lora_stack(self.cfg, gen, rank=self.cfg.lora_rank, dtype=dtype,
                               device=self.device)

    def init_state(self, lora_template) -> SflState:
        """lora_template: per-layer adapters for the FULL stack.  The client
        part is replicated K times (every client starts from the same
        broadcast global adapter, as after an aggregation round)."""
        lora = tree_to(lora_template, self.device)
        lc_k = broadcast_stacked(lora[:self.ell_c], self.tc.num_clients)
        ls = tree_map(lambda v: v.detach().clone(), lora[self.ell_c:])
        return SflState(lora_client=lc_k, lora_server=ls,
                        opt_client=self.opt.init(lc_k), opt_server=self.opt.init(ls),
                        step=torch.zeros((), dtype=torch.int32))

    # ------------------------------------------------------------------
    def _client_forward(self, lora_c, tokens: torch.Tensor) -> torch.Tensor:
        """One client's FP: embed + layers [0, ell_c) -> activations s_k."""
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = embed(self.cfg, self.client_base["embed"], tokens, positions)
        x, _ = stack_mod.apply_stack(self.cfg, self.client_base["layers"], x,
                                     positions=positions, lora=lora_c, rt=self.rt,
                                     mode="train")
        return x

    def _server_loss(self, lora_s, acts: torch.Tensor, labels: torch.Tensor):
        """Pooled loss on the main server.  acts: (K, b, S, d)."""
        K, b, S, d = acts.shape
        x = acts.reshape(K * b, S, d)
        positions = torch.arange(S, dtype=torch.int32, device=acts.device)
        x, _ = stack_mod.apply_stack(self.cfg, self.server_base["layers"], x,
                                     positions=positions, lora=lora_s, rt=self.rt,
                                     mode="train")
        x = apply_norm(self.cfg, x, self.server_base["final_norm"])
        logits = unembed(self.cfg, self.server_base["embed"], x)
        return cross_entropy(logits, labels.reshape(K * b, -1))

    def _to_device(self, batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return _batch_to(batches, self.device)

    # ------------------------------------------------------------------
    def _step_impl(self, state: SflState, batches: Dict[str, torch.Tensor]):
        """One fine-tuning step (steps a-f of Section IV-A).
        batches: tokens (K, b, S), labels (K, b, S) on the device."""
        tokens, labels = batches["tokens"], batches["labels"]
        K = self.tc.num_clients
        with torch.enable_grad():
            # (a) client-side FP, one client at a time, each its own adapter
            lc = [tree_map(lambda v, k=k: _leaf(v[k]), state.lora_client)
                  for k in range(K)]
            acts_k = [self._client_forward(lc[k], tokens[k]) for k in range(K)]
            # (b) upload: the server gets a leaf cut from the client graphs
            acts = torch.stack([a.detach() for a in acts_k]).requires_grad_()
            # (c, d) server FP + BP on the pooled activations
            ls = tree_map(_leaf, state.lora_server)
            loss = self._server_loss(ls, acts, labels)
            ls_leaves = tree_leaves(ls)
            grads = torch.autograd.grad(loss, ls_leaves + [acts], allow_unused=True)
            g_server = tree_unflatten(
                ls, [g if g is not None else torch.zeros_like(v)
                     for g, v in zip(grads[:-1], ls_leaves)])
            g_acts = grads[-1]
            # (e) download dL/ds_k; (f) client-side BP
            if any(a.requires_grad for a in acts_k):
                torch.autograd.backward(acts_k, grad_tensors=list(g_acts.unbind(0)))
        g_client = tree_map(lambda *vs: torch.stack([_grad_or_zero(v) for v in vs]),
                            lc[0], *lc[1:])
        with torch.no_grad():
            upd_s, opt_s = self.opt.update(g_server, state.opt_server, state.lora_server)
            upd_c, opt_c = self.opt.update(g_client, state.opt_client, state.lora_client)
            new = SflState(lora_client=apply_updates(state.lora_client, upd_c),
                           lora_server=apply_updates(state.lora_server, upd_s),
                           opt_client=opt_c, opt_server=opt_s, step=state.step + 1)
        loss = loss.detach()
        return new, {"loss": loss, "total": loss}

    def local_step(self, state: SflState, batches):
        """One local step on K stacked batches (tokens/labels (K, b, S))."""
        return self._step_impl(state, self._to_device(batches))

    # ------------------------------------------------------------------
    def _aggregate(self, state: SflState, weights) -> SflState:
        """Federated-server round (eq. 7): weighted average over the client
        axis with every client participating, then broadcast."""
        K = self.tc.num_clients
        global_c = fedavg_partial(state.lora_client, weights,
                                  torch.ones(K, dtype=torch.float32))
        return SflState(lora_client=broadcast_stacked(global_c, K),
                        lora_server=state.lora_server, opt_client=state.opt_client,
                        opt_server=state.opt_server, step=state.step)

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
        new, losses = state, []
        for i in range(batches["tokens"].shape[0]):
            new, m = self._step_impl(new, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
        new = self._aggregate(new, weights)
        finite = bool(tree_all_finite([new.lora_client, new.lora_server,
                                       new.opt_client, new.opt_server]))
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
        """Validation loss through client 0's adapter (after aggregation
        every client holds the same adapter)."""
        batch = self._to_device(batch)
        lora_c0 = tree_map(lambda v: v[0], state.lora_client)
        acts = self._client_forward(lora_c0, batch["tokens"])
        return self._server_loss(state.lora_server, acts[None], batch["labels"][None])


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
