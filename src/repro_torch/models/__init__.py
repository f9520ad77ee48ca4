from .generate import (SampleConfig, generate, sample_logits, sample_logits_per_key,
                       stream_seed)
from .model import (IGNORE_ID, cross_entropy, decode_step, forward, init_cache,
                    init_lora_stack, init_paged_cache, init_params, lora_num_params,
                    loss_fn, num_active_params, num_params, paged_decode_step,
                    paged_prefill_chunk, prefill)
from .stack import (Runtime, apply_stack, default_serve_runtime,
                    default_train_runtime, init_paged_stack_cache, init_stack_cache)

__all__ = [
    "IGNORE_ID", "Runtime", "apply_stack", "cross_entropy", "decode_step",
    "default_serve_runtime", "default_train_runtime", "forward", "generate",
    "init_cache", "init_paged_stack_cache", "init_stack_cache", "loss_fn",
    "init_lora_stack", "init_paged_cache", "init_params", "lora_num_params",
    "num_active_params", "num_params", "paged_decode_step",
    "paged_prefill_chunk", "prefill", "SampleConfig", "sample_logits",
    "sample_logits_per_key", "stream_seed",
]
