"""Per-device cost and roofline of a step, by abstract evaluation on fake
tensors (``cost``), on the H100's rates (``roofline``), and the dry-run's
tables (``report``) — the port of ``repro.analysis`` without its HLO
parser, which stays with XLA."""
from .cost import StepCost, measure
from .roofline import (PEAK_FLOPS_BF16, Roofline, build_report, collective_breakdown, link,
                       model_flops)

__all__ = ["StepCost", "measure", "PEAK_FLOPS_BF16", "Roofline", "build_report",
           "collective_breakdown", "link", "model_flops"]
