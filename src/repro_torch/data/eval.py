"""NLG evaluation: corpus perplexity and corpus BLEU (the E2E benchmark's
primary metric family).  Pure-python BLEU (no nltk offline).

The port's own copy of ``repro.data.eval``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, Sequence


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: Sequence[str], references: Sequence[str],
                max_n: int = 4) -> float:
    """Papineni et al. corpus BLEU with a single reference per candidate."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = ref_len = 0
    for cand, ref in zip(candidates, references):
        c = cand.lower().split()
        r = ref.lower().split()
        cand_len += len(c)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            cg, rg = _ngrams(c, n), _ngrams(r, n)
            totals[n - 1] += max(sum(cg.values()), 0)
            clipped[n - 1] += sum(min(v, rg.get(k, 0)) for k, v in cg.items())
    if cand_len == 0 or any(t == 0 for t in totals) or clipped[0] == 0:
        return 0.0
    precisions = [(c or 0.5) / t for c, t in zip(clipped, totals)]  # smoothed
    log_p = sum(math.log(p) for p in precisions) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    return bp * math.exp(log_p)


def corpus_perplexity(losses: Iterable[float]) -> float:
    ls = list(losses)
    return math.exp(min(sum(ls) / max(len(ls), 1), 20.0))
