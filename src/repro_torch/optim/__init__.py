from .optimizers import Optimizer, adamw, apply_updates, clip_by_global_norm, sgd
from .schedules import constant, cosine, linear_warmup_cosine, wsd

__all__ = [
    "Optimizer", "adamw", "apply_updates", "clip_by_global_norm", "sgd",
    "constant", "cosine", "linear_warmup_cosine", "wsd",
]
