"""Shared device routing + launch counting for the port's kernel wrappers.

The route is chosen by where the tensor lies, and by nothing else: a CUDA
tensor goes to the hand-written kernel, a CPU tensor to the plain PyTorch
version.  There is no "try the kernel, else the plain version" path — a
kernel that cannot launch raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

# op name -> number of kernel launches.  A wrapper adds one right after its
# kernel launched (``count_launch``), and nowhere else, so a run can show
# that its main path really went through the kernels.
LAUNCH_COUNTS: Dict[str, int] = {}


def count_launch(op: str) -> None:
    LAUNCH_COUNTS[op] = LAUNCH_COUNTS.get(op, 0) + 1


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA without a card
    raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dispatch(op: str, *, kernel: Callable[[], object],
             ref: Callable[[], object], x: torch.Tensor):
    """Route one op by ``x``'s device: ``kernel()`` for CUDA, ``ref()``
    for CPU; any other device raises."""
    if x.device.type == "cuda":
        return kernel()
    if x.device.type == "cpu":
        return ref()
    raise ValueError(f"{op}: no route for a tensor on {x.device}")
