"""E(r): global rounds to reach a target loss, as a function of LoRA rank.

The paper estimates E(r) offline "through pretraining on a representative
dataset" (Section VI-C) and observes (Figs. 3-4) that higher ranks converge
in fewer steps with diminishing returns.  We model

    E(r) = e_inf + c * r^(-alpha)

and fit (e_inf, c, alpha) by least squares on measured (rank, steps) pairs
— `benchmarks/bench_convergence.py` produces such pairs from real reduced-
model training runs.  DEFAULT_E is a fit to that benchmark's output so the
resource allocator works out of the box.

The port's own copy of ``repro.core.convergence`` (numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class ConvergenceModel:
    e_inf: float
    c: float
    alpha: float

    def __call__(self, rank: float) -> float:
        return self.e_inf + self.c * float(rank) ** (-self.alpha)


def fit_convergence_model(ranks: Sequence[float], steps: Sequence[float],
                          alpha_grid=None) -> ConvergenceModel:
    """Least squares over (e_inf, c) for each alpha on a grid; picks the
    alpha with minimum residual.  Robust for the 3-8 point fits we do."""
    r = np.asarray(ranks, float)
    s = np.asarray(steps, float)
    alpha_grid = alpha_grid if alpha_grid is not None else np.linspace(0.1, 2.0, 39)
    best = None
    for a in alpha_grid:
        X = np.stack([np.ones_like(r), r ** (-a)], axis=1)
        coef, res, *_ = np.linalg.lstsq(X, s, rcond=None)
        e_inf, c = coef
        pred = X @ coef
        sse = float(np.sum((pred - s) ** 2))
        if e_inf < 0:       # keep the model physical
            sse += 1e12
        if best is None or sse < best[0]:
            best = (sse, ConvergenceModel(float(max(e_inf, 0.0)), float(c), float(a)))
    return best[1]


# Fit to the repo's own calibration runs (bench_convergence on the reduced
# GPT-2 / synthetic-E2E task; see EXPERIMENTS.md §Convergence).  Shape
# matches the paper's Fig. 4: steps drop steeply from rank 1 -> 4, then
# flatten through rank 8.
DEFAULT_E = ConvergenceModel(e_inf=18.0, c=42.0, alpha=0.9)

PAPER_RANKS = (1, 2, 4, 6, 8)
