from .generate import SampleConfig, sample_logits, sample_logits_per_key, stream_seed
from .model import (IGNORE_ID, cross_entropy, forward, init_lora_stack,
                    init_paged_cache, init_params, loss_fn, paged_decode_step,
                    paged_prefill_chunk)
from .stack import (Runtime, apply_stack, default_serve_runtime,
                    default_train_runtime, init_paged_stack_cache)

__all__ = [
    "IGNORE_ID", "Runtime", "apply_stack", "cross_entropy", "default_serve_runtime",
    "default_train_runtime", "forward", "init_paged_stack_cache", "loss_fn",
    "init_lora_stack", "init_paged_cache", "init_params", "paged_decode_step",
    "paged_prefill_chunk", "SampleConfig", "sample_logits",
    "sample_logits_per_key", "stream_seed",
]
