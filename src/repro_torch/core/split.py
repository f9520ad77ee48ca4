"""Model splitting — the mu decision variable of the paper (C3).

C3 requires mu_j >= mu_{j+1}: the client holds a *prefix* of the stack.
We encode the split as ``ell_c`` = number of client-side layers.  For
pattern-based stacks the split must land on a pattern boundary (repeat
granularity); ``valid_splits`` enumerates the legal choices the exhaustive
search (P3) sweeps over.

The port's own copy of ``repro.core.split`` (numpy only).
"""
from __future__ import annotations

from typing import List, Tuple

from ..configs.base import ArchConfig


def valid_splits(cfg: ArchConfig) -> List[int]:
    """Legal ell_c values (layers on the client), pattern-aligned.

    0 is excluded (pure-FL degenerates the paper's setting: the client must
    hold at least the embedding + first block to keep raw data private);
    num_layers is excluded (the main server must hold the head)."""
    P = len(cfg.pattern)
    return [r * P for r in range(1, cfg.pattern_repeats)]


def layers_to_reps(cfg: ArchConfig, ell_c: int) -> int:
    P = len(cfg.pattern)
    if ell_c % P:
        raise ValueError(f"split {ell_c} not on a pattern boundary (P={P})")
    return ell_c // P


def mu_vector(cfg: ArchConfig, ell_c: int) -> Tuple[int, ...]:
    """The paper's binary mu (1 = layer on client), monotone by C3."""
    return tuple(1 if j < ell_c else 0 for j in range(cfg.num_layers))


def check_mu(mu) -> int:
    """Validate C3 and return ell_c."""
    for a, b in zip(mu, mu[1:]):
        if a < b:
            raise ValueError("C3 violated: mu must be non-increasing")
    return sum(mu)
