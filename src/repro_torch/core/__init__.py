"""The paper's primary contribution in the port: SflLLM — split federated
LoRA fine-tuning (Algorithm 1, homogeneous and heterogeneous fleets) —
with FedAvg (rank-aware for mixed fleets), the Section V delay model and
the Section VI resource allocator (numpy copies of ``repro.core``'s host
modules)."""
from .aggregation import (broadcast, broadcast_het, broadcast_stacked, fedavg,
                          fedavg_het, fedavg_partial, fedavg_stacked, tree_all_finite)
from .channel import ClientEnv, sample_clients
from .latency import (latency_report, latency_report_het, local_round_latency,
                      split_workload, total_latency)
from .lora import (adapter_bytes_per_layer, client_slot_masks, concat_tree, count_params,
                   split_tree, tree_bytes)
from .resource import (Allocation, HeteroAllocation, Problem, bcd_minimize_delay,
                       bcd_minimize_delay_per_client, total_delay)
from .sfl import CentralizedLoRA, SflLLM, SflState
from .split import layers_to_reps, mu_vector, valid_splits
from .workload import layer_workloads, lm_head_flops

__all__ = [
    "broadcast", "broadcast_het", "broadcast_stacked", "fedavg", "fedavg_het",
    "fedavg_partial", "fedavg_stacked", "tree_all_finite", "ClientEnv",
    "sample_clients", "latency_report", "latency_report_het", "local_round_latency",
    "split_workload", "total_latency", "adapter_bytes_per_layer", "client_slot_masks",
    "concat_tree", "count_params", "split_tree", "tree_bytes", "Allocation",
    "HeteroAllocation", "Problem", "bcd_minimize_delay", "bcd_minimize_delay_per_client",
    "total_delay", "CentralizedLoRA", "SflLLM", "SflState", "layers_to_reps",
    "mu_vector", "valid_splits", "layer_workloads", "lm_head_flops",
]
