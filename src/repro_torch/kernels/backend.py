"""Shared device routing + launch counting for the port's kernel wrappers.

The route is chosen by where the tensor lies, and by nothing else: a CUDA
tensor goes to the hand-written kernel, a CPU tensor to the plain PyTorch
version.  There is no "try the kernel, else the plain version" path — a
kernel that cannot launch raises.

A fake tensor (``torch._subclasses.FakeTensorMode``: shapes, dtypes and a
device, no data) takes a third route, abstract evaluation: each kernel
has a shape-only implementation and a FLOP formula (:func:`register`),
and runs as the custom op ``repro_torch::kernel_<op>``, whose fake
implementation gives the output shapes and whose formula
``torch.utils.flop_counter.FlopCounterMode`` counts.  The formula counts
the work the kernel does, so a step's count is the same whatever runs
it.  A fake tensor never runs the plain version.  A ``meta`` tensor takes
that route only within :func:`abstract_evaluation` (the dry-run's count),
and raises elsewhere.  A real tensor's launch goes through the same
custom op only within :func:`as_ops` (a FLOP count of a real run, remat
"dots"); elsewhere it is bare, since the op's dispatch costs host time.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Sequence

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


# ---------------------------------------------------------------------------
# abstract evaluation
# ---------------------------------------------------------------------------

# op -> (shapes(operands, args) -> [(shape, dtype)], flops(shapes, args) -> int)
_ABSTRACT: Dict[str, tuple] = {}
_STATE = threading.local()
_LIB = None


def register(op: str, shapes: Callable, flops: Callable) -> None:
    """Give kernel ``op`` its shape-only implementation, ``shapes(operands,
    args)`` -> the outputs' [(shape, dtype)], and its FLOP formula,
    ``flops(operand shapes, args)`` -> int; ``operands`` are the tensors
    (or None) and ``args`` the numbers its wrapper passes to
    :func:`dispatch`."""
    _ABSTRACT[op] = (shapes, flops)


@contextlib.contextmanager
def abstract_evaluation():
    """Within it, on this thread, ``meta`` tensors take the abstract route
    as fake ones do (outside it they raise)."""
    depth = getattr(_STATE, "abstract", 0)
    _STATE.abstract = depth + 1
    try:
        yield
    finally:
        _STATE.abstract = depth


def in_abstract_evaluation() -> bool:
    """Whether this thread is within :func:`abstract_evaluation`."""
    return getattr(_STATE, "abstract", 0) > 0


@contextlib.contextmanager
def as_ops(ops: Sequence[str] = None):
    """Within it, on this thread, a real tensor's launch of a kernel in
    ``ops`` (every kernel when None) runs as its custom op
    ``kernel_<op>``, which a dispatch mode sees: ``FlopCounterMode``
    counts it by its formula, and ``torch.utils.checkpoint``'s selective
    policy can save its output (remat "dots", ``models.stack``).
    Elsewhere the launch is bare: the op's dispatch adds tens of µs of
    host time a call (``PERF.md`` §6)."""
    prev = getattr(_STATE, "ops", ())
    _STATE.ops = prev + ((None if ops is None else frozenset(ops)),)
    try:
        yield
    finally:
        _STATE.ops = prev


def _routed(op: str) -> bool:
    """Whether a real launch of ``op`` goes through its custom op here: within
    :func:`as_ops` for it, and not already inside a custom op's launch."""
    ops = getattr(_STATE, "ops", ())
    return bool(ops) and getattr(_STATE, "launch", None) is None and \
        any(s is None or op in s for s in ops)


def _is_fake(x: torch.Tensor) -> bool:
    if type(x) is torch.Tensor:         # a real tensor: all a launch pays
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def kernel_op(op: str):
    """``repro_torch::kernel_<op>(Tensor?[] operands, float[] args) ->
    Tensor[]``, defined at first use: its fake (and meta) implementation
    the registered shapes, its FLOP formula the registered one, and its
    CPU and CUDA implementations the launch the wrapper handed over."""
    global _LIB
    name = f"kernel_{op}"
    ns = torch.ops.repro_torch
    if not hasattr(ns, name):
        from torch.utils.flop_counter import register_flop_formula
        if _LIB is None:
            _LIB = torch.library.Library("repro_torch", "FRAGMENT")
        _LIB.define(f"{name}(Tensor?[] operands, float[] args) -> Tensor[]")
        shapes, flops = _ABSTRACT[op]

        def run(operands, args):
            out = _STATE.launch()
            return list(out) if isinstance(out, tuple) else [out]

        def fake(operands, args):
            dev = next(t.device for t in operands if t is not None)
            return [torch.empty(s, dtype=d, device=dev) for s, d in shapes(operands, args)]

        for key in ("CPU", "CUDA"):
            _LIB.impl(name, run, key)
        torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
        register_flop_formula(getattr(ns, name))(
            lambda operands, args, out_val=None, **kw: int(flops(operands, args)))
    return getattr(ns, name).default


def define_ops() -> None:
    """Define every registered kernel's custom op now: a
    ``FlopCounterMode`` reads the FLOP formulas when it is made, so a
    count must be made after this."""
    from . import flash_attention, lora_matmul, ssd_scan  # noqa: F401  (registrations)
    for op in _ABSTRACT:
        kernel_op(op)


def _through_op(op: str, operands, args, run: Callable[[], object]):
    """The outputs of ``op`` through its custom op: shape-only on fake or
    meta operands, else ``run()``'s (which the CPU and CUDA
    implementations call; a launch within it is bare)."""
    prev = getattr(_STATE, "launch", None)
    _STATE.launch = run
    try:
        outs = kernel_op(op)(list(operands), [float(a) for a in args])
    finally:
        _STATE.launch = prev
    return outs[0] if len(outs) == 1 else tuple(outs)


def launch(op: str, operands, args, run: Callable[[], object]):
    """``run()``'s outputs: through ``op``'s custom op within :func:`as_ops`
    for it, else bare."""
    if operands is not None and _routed(op):
        return _through_op(op, operands, args, run)
    return run()


def dispatch(op: str, *, kernel: Callable[[], object], ref: Callable[[], object],
             x: torch.Tensor, operands: Sequence = None, args: Sequence = ()):
    """Route one op by ``x``'s device: ``kernel()`` for CUDA, ``ref()`` for
    CPU; any other device raises.  ``operands``/``args``: the tensors and
    numbers of the kernel ``op`` (:func:`register`): a fake tensor (or a
    meta one within :func:`abstract_evaluation`) gets its shape-only
    outputs through the custom op, and a real one goes through it within
    :func:`as_ops` (:func:`launch`).  Without ``operands`` the op is a
    route to kernels that dispatch themselves (the SSD scan's pre-scaling
    around its kernel), and a fake tensor takes ``kernel()``."""
    if _is_fake(x) or x.device.type == "meta":
        if x.device.type == "meta" and not getattr(_STATE, "abstract", 0):
            raise ValueError(f"{op}: a meta tensor reached the kernel outside abstract "
                             "evaluation (kernels.backend.abstract_evaluation)")
        if operands is None:
            return kernel()
        return _through_op(op, operands, args, None)
    if x.device.type == "cuda":
        return launch(op, operands, args, kernel)
    if x.device.type == "cpu":
        return launch(op, operands, args, ref)
    raise ValueError(f"{op}: no route for a tensor on {x.device}")
