"""Minimal functional optimizers over trees of tensors — the twins of
``repro.optim.optimizers``.

Each optimizer is an (init, update) pair bundled in :class:`Optimizer`;
``update(grads, state, params)`` returns (updates, new_state) and
``apply_updates`` adds them (the optax convention).  The formulas are
JAX's, step for step: the Adam bias corrections take the step count as
f32 and eps sits outside the square root, so a run matches ``repro``'s
numbers and not ``torch.optim``'s.  Everything runs under
``torch.no_grad()`` and returns new tensors: the old state stays intact,
which the round's divergence rollback relies on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Union

import torch

from ..tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        state = {"step": _step0()}
        if momentum:
            state["mu"] = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                   params)
        return state

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
            updates = tree_map(lambda m, g: (-lr_t * m).to(g.dtype), mu, grads)
            return updates, {"step": step, "mu": mu}
        updates = tree_map(lambda g: (-lr_t * g.float()).to(g.dtype), grads)
        return updates, {"step": step}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return {"step": _step0(), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        t = step.float()
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)

        def _upd(m_, v_, p):
            u = -lr_t * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(_upd, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
