"""Federated data partitioning: IID and Dirichlet non-IID.

The port's own copy of ``repro.data.partition``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def iid_partition(n: int, num_clients: int, rng=0) -> List[np.ndarray]:
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_clients)]


def dirichlet_partition(labels: Sequence[int], num_clients: int,
                        alpha: float = 0.5, rng=0) -> List[np.ndarray]:
    """Label-skewed non-IID split (the standard FL benchmark protocol)."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    labels = np.asarray(labels)
    classes = np.unique(labels)
    out = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            out[k].extend(part.tolist())
    return [np.sort(np.array(p, dtype=np.int64)) for p in out]
