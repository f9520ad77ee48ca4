"""Build the hand-written CUDA kernels at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` holds one kernel family behind a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds, not minutes); the
``csrc/*.cuh`` headers hold device code that several of them include (the
TF32 LoRA GEMM tile of ``lora_mma.cuh``, which the int8-base pair shares,
and the split-K decode body of ``decode_split.cuh``).  Each source
is compiled for Hopper (``sm_90a``) into
``<repo>/build/kernels/lib<name>.so`` — a git-ignored directory inside the
checkout — and rebuilt whenever it or any header is newer than the
library.  Nothing here runs at import time: the
CPU tests import every module of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lora_matmul", "lora_matmul_bwd", "lora_matmul_q8", "paged_decode",
           "flash_attention", "flash_decode", "decode_partial", "ssd_scan", "ssd_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# source -> the compiler's output of its last build in this process
# (``-Xptxas -v``: registers, shared memory and spills of every kernel)
LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/csrc at first use")


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temp name and rename: a concurrent loader never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.tmp, proc.name, proc.t0 = tmp, name, time.perf_counter()
    return proc


def build(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, float]:
    """Compile every stale source (every source with ``force``), one
    ``nvcc`` per source, all started together.  Returns seconds per source
    built; raises with the compiler's output if any build fails."""
    procs = [_start(n) for n in names if force or _stale(n)]
    errors = []
    built = {}
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(p.tmp)
            errors.append(f"nvcc failed for {p.name}.cu:\n{out}")
            continue
        os.replace(p.tmp, BUILD_DIR / f"lib{p.name}.so")
        LOGS[p.name] = out
        built[p.name] = time.perf_counter() - p.t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def resource_usage(name: str) -> List[str]:
    """One line per kernel of ``name``'s last build: its (demangled) name,
    registers, static shared memory and spill bytes, from ptxas's
    ``-v`` report in ``LOGS``."""
    lines, cur = [], None
    for ln in LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"fn": m.group(1), "regs": "?", "smem": "0", "spill": "0/0"}
            lines.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = m.group(1)
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = sm.group(1) if sm else "0"
    filt = shutil.which("c++filt")
    if filt and lines:
        names = subprocess.run([filt], input="\n".join(d["fn"] for d in lines),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(lines):
            for d, n in zip(lines, names):
                d["fn"] = n.replace("(anonymous namespace)::", "")
    return [f"{d['fn'].split('(')[0]}: {d['regs']} registers, {d['smem']} B static "
            f"shared memory, spill stores/loads {d['spill']} B" for d in lines]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by ``name``'s launch
    entry (each library exports ``<name>_error_string``)."""
    if err != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{fn(err).decode()}")
