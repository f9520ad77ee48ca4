"""What the two launch-plan tuners share (``lora_matmul/tune.py``,
``flash_attention/tune.py``): where a plan is measured, how a candidate
is timed on the card, how the winner is taken, and the counts of the
tuning this process has done.

A plan is measured only on a CUDA device, outside
``backend.abstract_evaluation`` and outside a fake-tensor mode; anywhere
else the tuner returns its heuristic plan and launches nothing.  On the
card a candidate is timed by CUDA events around each of ``REPS``
launches, after one warm launch, each launch behind a read of 64 MB that
evicts the 50 MB L2 (the main path finds its operands cold: a layer's
weights and caches leave L2 before the layer comes again), all queued
behind a short device sleep so that the events see the device's time
and not the host's; its time is the median.  The heuristic plan is kept
unless a candidate's median beats it by more than the heuristic's spread
(the interquartile range of its launches).

Tuning launches go through the C entries directly: no launch counter
(``backend.count_launch``) sees them.  ``STATS`` counts them instead.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Sequence

import torch

from . import backend

REPS = 7                # timed launches a candidate, after one warm launch
SLEEP_CYCLES = 500_000  # device sleep ahead of a candidate's launches (~0.3 ms)
FLUSH_BYTES = 64 << 20  # read before each timed launch: more than the L2
_FLUSH: Dict[torch.device, torch.Tensor] = {}

# the tuning this process has done on the card: keys timed, candidates
# timed, their launches (warm ones too) and the host milliseconds spent
STATS: Dict[str, float] = {"keys": 0, "candidates": 0, "launches": 0, "ms": 0.0}


def reset_stats() -> None:
    STATS.update(keys=0, candidates=0, launches=0, ms=0.0)


def device_key(device) -> torch.device:
    """``device`` as the memos key it: None is the current CUDA device
    where there is a card, else the CPU (``repro``'s default backend);
    a CUDA device without an index gets the current one."""
    if type(device) is torch.device and (device.type != "cuda" or device.index is not None):
        return device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        device = torch.device("cuda", index)
    return device


def normalized(memo: dict, key: tuple, at: int):
    """(``memo``'s plan or None, the key, the device) with the device at
    ``key[at]`` as the memos key it (:func:`device_key`): a caller that
    passes a ``torch.device`` with an index hits on its first lookup, any
    other after this one."""
    device = device_key(key[at])
    key = key[:at] + (device,) + key[at + 1:]
    return memo.get(key), key, device


def _fake_mode() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def measures(device: torch.device) -> bool:
    """Whether a miss on ``device`` times its candidates on the card."""
    return (device.type == "cuda" and not backend.in_abstract_evaluation()
            and not _fake_mode())


def time_plan(device: torch.device, run: Callable, plan, what: str) -> list:
    """Milliseconds of each of ``REPS`` launches of ``run(plan)`` (which
    launches the kernel with ``plan`` and counts nothing), after one warm
    launch.  A launch the C entry refuses raises, naming the plan."""
    try:
        run(plan)
    except RuntimeError as exc:
        raise RuntimeError(f"{what}: candidate {plan} failed to launch: {exc}") from exc
    flush = _FLUSH.get(device)
    if flush is None:
        flush = _FLUSH[device] = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32,
                                            device=device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(REPS)]
    stream = torch.cuda.current_stream(device)
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.sum()
        start.record(stream)
        run(plan)
        end.record(stream)
    events[-1][1].synchronize()
    STATS["launches"] += REPS + 1
    return [start.elapsed_time(end) for start, end in events]


def pick(candidates: Sequence, samples: Sequence[list]):
    """The heuristic plan ``candidates[0]``, unless another's median time
    beats its median by more than its interquartile range: then the
    fastest such candidate."""
    base = statistics.median(samples[0])
    q = statistics.quantiles(samples[0], n=4)
    best, best_t = candidates[0], base - (q[2] - q[0])
    for plan, s in zip(candidates[1:], samples[1:]):
        t = statistics.median(s)
        if t < best_t:
            best, best_t = plan, t
    return best


def choose(memo: dict, key, heuristic, candidates: Sequence, device: torch.device,
           make_launch: Callable, what: str):
    """The plan of ``key`` at a miss, memoized in ``memo``: the heuristic
    plan where nothing is measured (memoized on the CPU and meta devices,
    not on a CUDA device within abstract evaluation), or at a key with one
    candidate; else the fastest candidate (:func:`pick`), each timed on the
    card by ``launch(plan)``, ``launch = make_launch()`` (called only
    here, so that scratch operands are made only to be timed)."""
    if not measures(device):
        if device.type != "cuda":
            memo[key] = heuristic
        return heuristic
    if len(candidates) > 1:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: no tuned plan for {key} under CUDA stream "
                               "capture; run the shape once before capturing")
        t0 = time.perf_counter()
        launch = make_launch()
        samples = [time_plan(device, launch, p, what) for p in candidates]
        heuristic = pick(candidates, samples)
        STATS["keys"] += 1
        STATS["candidates"] += len(candidates)
        STATS["ms"] += (time.perf_counter() - t0) * 1e3
    memo[key] = heuristic
    return heuristic
