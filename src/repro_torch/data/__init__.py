from .e2e import Example, e2e_splits, generate
from .eval import corpus_bleu, corpus_perplexity
from .partition import dirichlet_partition, iid_partition
from .pipeline import batches, encode_example, sfl_batches, stack_rounds
from .tokenizer import WordTokenizer, PAD, BOS, EOS, SEP, UNK

__all__ = [
    "Example", "e2e_splits", "generate", "corpus_bleu", "corpus_perplexity",
    "dirichlet_partition", "iid_partition", "batches", "encode_example",
    "sfl_batches", "stack_rounds", "WordTokenizer", "PAD", "BOS", "EOS",
    "SEP", "UNK",
]
