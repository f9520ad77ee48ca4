from .ops import ssd_scan, ssd_scan_bwd_kernel, ssd_scan_kernel, ssd_scan_with_state
from .ref import ssd_chunked, ssd_scan_bwd_ref, ssd_scan_ref, ssd_sequential_ref

__all__ = ["ssd_chunked", "ssd_scan", "ssd_scan_bwd_kernel", "ssd_scan_bwd_ref",
           "ssd_scan_kernel", "ssd_scan_ref", "ssd_scan_with_state", "ssd_sequential_ref"]
