"""The multi-device path's layout: ``repro``'s partition rules
(``specs``), the collectives GSPMD inserts there, written out
(``collectives``), FSDP of the frozen base over "data" (``fsdp``) and
tensor parallelism over "model" (``tp``, imported by the model functions
that run on its pieces)."""
from .specs import (CLIENT_AXIS, P, batch_axes, batch_spec, batch_specs, cache_spec,
                    cache_specs, client_batch_specs, client_spec, client_stacked_specs,
                    lora_specs, opt_state_specs, param_spec, params_specs, path_specs,
                    round_batch_specs, round_dynamics_specs, sfl_state_specs, shard,
                    stacked_batch_specs, unshard)

__all__ = [
    "CLIENT_AXIS", "P", "batch_axes", "batch_spec", "batch_specs", "cache_spec",
    "cache_specs", "client_batch_specs", "client_spec", "client_stacked_specs", "lora_specs",
    "opt_state_specs", "param_spec", "params_specs", "path_specs", "round_batch_specs",
    "round_dynamics_specs", "sfl_state_specs", "shard", "stacked_batch_specs", "unshard",
]
