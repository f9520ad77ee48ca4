"""Batching pipelines: centralized batches and per-client SFL batches (the
port's own copy of ``repro.data.pipeline``; batches stay numpy until the
trainer moves them to its device).

Targets follow the paper's NLG protocol: loss only on the reference tokens
(the MR prefix is conditioning → label = IGNORE_ID there).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..models.model import IGNORE_ID
from .e2e import Example
from .tokenizer import BOS, EOS, PAD, SEP, WordTokenizer


def encode_example(tok: WordTokenizer, ex: Example, seq_len: int):
    """-> (tokens (S,), labels (S,)) — next-token labels, MR masked."""
    mr = tok.encode(ex.mr)
    ref = tok.encode(ex.ref)
    ids = [BOS] + mr + [SEP] + ref + [EOS]
    ids = ids[:seq_len + 1]
    x = np.full(seq_len, PAD, np.int32)
    y = np.full(seq_len, IGNORE_ID, np.int32)
    inp = ids[:-1][:seq_len]
    tgt = ids[1:][:seq_len]
    x[:len(inp)] = inp
    y[:len(tgt)] = tgt
    # mask conditioning positions: everything up to and including <sep>
    sep_pos = len(mr) + 1          # index of <sep> in inp
    y[:min(sep_pos, seq_len)] = IGNORE_ID
    # mask padding
    y[len(tgt):] = IGNORE_ID
    return x, y


def batches(tok: WordTokenizer, examples: Sequence[Example], batch_size: int,
            seq_len: int, rng=0, loop: bool = True) -> Iterator[Dict]:
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    n = len(examples)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            xs, ys = zip(*(encode_example(tok, examples[j], seq_len)
                           for j in order[i:i + batch_size]))
            yield {"tokens": np.stack(xs), "labels": np.stack(ys)}
        if not loop:
            return


def stack_rounds(data_iter: Iterator[Dict], local_steps: int) -> Dict:
    """Pull I batches and stack them on a new leading step axis — the xs of
    the compiled round's ``lax.scan`` (core.sfl.train_round).

    Works for centralized batches (B, S) -> (I, B, S) and stacked SFL
    batches (K, b, S) -> (I, K, b, S)."""
    steps = [next(data_iter) for _ in range(local_steps)]
    keys = steps[0].keys()
    return {k: np.stack([s[k] for s in steps]) for k in keys}


def sfl_batches(tok: WordTokenizer, parts: List[Sequence[Example]],
                batch_size: int, seq_len: int, rng=0) -> Iterator[Dict]:
    """Per-client stacked batches (K, b, S) for the SflLLM runtime."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    iters = [batches(tok, p, batch_size, seq_len,
                     np.random.default_rng(rng.integers(2 ** 31)))
             for p in parts]
    while True:
        bs = [next(it) for it in iters]
        yield {"tokens": np.stack([b["tokens"] for b in bs]),
               "labels": np.stack([b["labels"] for b in bs])}
