"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100.

Mirrors ``repro``'s layout (configs, core, data, kernels, models, optim,
serving, launch) and
imports neither JAX nor ``repro``.  Kernels are hand-written CUDA C++ for
``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first use; entry
points run on the card unless the caller passes ``device="cpu"``.
"""
