"""The paper's primary contribution in the port: SflLLM — split federated
LoRA fine-tuning (Algorithm 1, homogeneous and heterogeneous fleets, and
dynamic rounds under ``RoundDynamics``) — with FedAvg (rank-aware for
mixed fleets, partial for dropped clients), the Section V delay model,
the Section VI resource allocator, the time-varying channel (fading,
outages and HARQ) (numpy copies of ``repro.core``'s host modules), and the
trust boundary: Byzantine-robust aggregation, the corruption model and
the reputation quarantine (``aggregation``, ``defense``)."""
from .aggregation import (RobustAggConfig, anomaly_scores, broadcast, broadcast_het,
                          broadcast_stacked, clip_updates, coordinate_median, fedavg,
                          fedavg_het, fedavg_partial, fedavg_stacked, robust_aggregate,
                          tree_all_finite, trimmed_mean, update_norms)
from .defense import ByzantineOps, DefenseConfig, ReputationTracker, corrupt_updates
from .channel import (ClientEnv, FadingProcess, expected_transmissions, fade_clients,
                      outage_probability, residual_outage, sample_clients)
from .latency import (client_round_seconds_host, het_local_round_latency, het_total_latency,
                      latency_report, latency_report_het, local_round_latency,
                      split_workload, total_latency, workload_tables)
from .lora import (adapter_bytes_per_layer, client_slot_masks, concat_tree, count_params,
                   merge_adapter, split_tree, tree_bytes)
from .resource import (Allocation, HeteroAllocation, Problem, as_hetero, bcd_minimize_delay,
                       bcd_minimize_delay_per_client, objective_het, reallocate_warm,
                       total_delay)
from .sfl import CentralizedLoRA, RoundDynamics, SflLLM, SflState, quantize_activations
from .split import layers_to_reps, mu_vector, valid_splits
from .workload import layer_workloads, lm_head_flops

__all__ = [
    "RobustAggConfig", "anomaly_scores", "clip_updates", "coordinate_median",
    "robust_aggregate", "trimmed_mean", "update_norms", "ByzantineOps", "DefenseConfig",
    "ReputationTracker", "corrupt_updates", "quantize_activations",
    "broadcast", "broadcast_het", "broadcast_stacked", "fedavg", "fedavg_het",
    "fedavg_partial", "fedavg_stacked", "tree_all_finite", "ClientEnv",
    "FadingProcess", "expected_transmissions", "fade_clients", "outage_probability",
    "residual_outage", "sample_clients", "client_round_seconds_host",
    "het_local_round_latency", "het_total_latency", "latency_report", "latency_report_het",
    "local_round_latency", "split_workload", "total_latency", "workload_tables",
    "adapter_bytes_per_layer", "client_slot_masks",
    "concat_tree", "count_params", "merge_adapter", "split_tree", "tree_bytes", "Allocation",
    "HeteroAllocation", "Problem", "as_hetero", "bcd_minimize_delay",
    "bcd_minimize_delay_per_client", "objective_het", "reallocate_warm",
    "total_delay", "CentralizedLoRA", "RoundDynamics", "SflLLM", "SflState", "layers_to_reps",
    "mu_vector", "valid_splits", "layer_workloads", "lm_head_flops",
]
