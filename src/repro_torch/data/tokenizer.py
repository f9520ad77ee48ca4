"""Whitespace/word tokenizer with a fixed vocabulary.

The real paper uses the GPT-2 BPE; offline we build a deterministic word
vocabulary from the synthetic corpus.  Special ids: 0 = <pad>, 1 = <bos>,
2 = <eos>, 3 = <sep>, 4 = <unk>.

The port's own copy of ``repro.data.tokenizer``.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List

PAD, BOS, EOS, SEP, UNK = 0, 1, 2, 3, 4
_SPECIALS = ["<pad>", "<bos>", "<eos>", "<sep>", "<unk>"]


class WordTokenizer:
    def __init__(self, vocab: List[str]):
        self.itos = list(_SPECIALS) + [w for w in vocab if w not in _SPECIALS]
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    @classmethod
    def from_corpus(cls, texts: Iterable[str], max_vocab: int = 8192
                    ) -> "WordTokenizer":
        counts = Counter()
        for t in texts:
            counts.update(t.lower().split())
        vocab = [w for w, _ in counts.most_common(max_vocab - len(_SPECIALS))]
        return cls(vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(self, text: str, add_special: bool = False) -> List[int]:
        ids = [self.stoi.get(w, UNK) for w in text.lower().split()]
        return [BOS] + ids + [EOS] if add_special else ids

    def decode(self, ids: Iterable[int]) -> str:
        return " ".join(self.itos[i] for i in ids
                        if i < len(self.itos) and i >= len(_SPECIALS))
