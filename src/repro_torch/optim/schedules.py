"""Learning-rate schedules over an int step tensor, including MiniCPM's WSD
(warmup-stable-decay) — the twins of ``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))

    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        warm = lr * step.float() / max(warmup_steps, 1)
        return torch.where(step <= warmup_steps, warm, cos(step - warmup_steps))

    return f


def wsd(lr: float, warmup_steps: int, stable_steps: int, decay_steps: int,
        final_frac: float = 0.01):
    """MiniCPM warmup-stable-decay [arXiv:2404.06395]: linear warmup, long
    constant plateau, then a decay linear in log to final_frac * lr."""

    def f(step):
        s = step.float()
        warm = lr * s / max(warmup_steps, 1)
        in_decay = step > (warmup_steps + stable_steps)
        d = torch.clamp((s - warmup_steps - stable_steps) / max(decay_steps, 1), 0.0, 1.0)
        decay = lr * torch.exp(math.log(final_frac) * d)
        return torch.where(step <= warmup_steps, warm,
                           torch.where(in_decay, decay, torch.tensor(lr, dtype=torch.float32)))

    return f
