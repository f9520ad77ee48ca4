from .generate import SampleConfig, sample_logits, sample_logits_per_key, stream_seed
from .model import (init_lora_stack, init_paged_cache, init_params,
                    paged_decode_step, paged_prefill_chunk)
from .stack import (Runtime, apply_stack, default_serve_runtime,
                    init_paged_stack_cache)

__all__ = [
    "Runtime", "apply_stack", "default_serve_runtime", "init_paged_stack_cache",
    "init_lora_stack", "init_paged_cache", "init_params", "paged_decode_step",
    "paged_prefill_chunk", "SampleConfig", "sample_logits",
    "sample_logits_per_key", "stream_seed",
]
