"""Multi-pod dry-run: one rank's step of every (architecture x input
shape) on the production meshes, evaluated abstractly — the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape decode_32k [--multi-pod | --both-meshes] [--out DIR] \\
        [--rt dense_impl=fused decode_attn_impl=flash ssd_impl=kernel]

``repro`` lowers and compiles the step for XLA over 256 or 512 host
devices.  The port plays rank 0 of a fake world of that size
(``launch.mesh.init_fake``: every collective returns at once with its
result's shape) on fake tensors, which hold shapes and no data
(``torch._subclasses.FakeTensorMode``), and runs the step once: its
params, adapters, batch and caches are that rank's pieces
(``launch.steps.input_specs(mesh=)``), the frozen base FSDP-sharded over
the data axes (``sharding.fsdp``) and cut over "model" (``sharding.tp``).
``analysis.cost`` counts its FLOPs, bytes, collectives and memory and
``analysis.roofline`` puts them on the H100's rates.  No card is needed
and nothing is computed: a kernel takes its shape-only route
(``kernels.backend``), never the plain version.  The fake tensors lie on
the card's device where this torch is built with CUDA; a CPU-only build
cannot index a fake ``cuda`` tensor (its device guard needs CUDA), so
there they are ``meta`` ones, which route alike.

Each pair writes ``repro``'s JSON keys.  ``lower_s`` is the set-up (the
inputs' pieces and the step) and ``compile_s`` the abstract run.
``memory_analysis`` has ``argument_size_in_bytes``,
``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of live
bytes beyond the arguments, less the results); XLA's alias and
generated-code sizes have no counterpart and are left out.
``cost_analysis`` has ``flops`` and ``bytes accessed`` (the eager,
unfused traffic: ``analysis.cost``).  The defaults follow ``repro``'s
``default_runtime``; ``--rt dense_impl=fused decode_attn_impl=flash
ssd_impl=kernel`` dry-runs the kernel path.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from ..analysis.cost import measure
from ..analysis.roofline import build_report
from ..configs import ARCHS, PORTED
from ..configs.shapes import SHAPES
from ..models import model as model_mod
from ..models.stack import Runtime
from ..optim import adamw
from ..sharding.specs import P, batch_axes, map_with_path, param_spec, shard
from ..tree import tree_map
from .mesh import init_fake, make_production_mesh
from .steps import (PARAM_DTYPE, arch_for_shape, input_specs, make_decode_step,
                    make_full_finetune_step, make_prefill_step, make_train_step)


def default_runtime(shape_kind: str, mesh=None, overrides: Optional[dict] = None) -> Runtime:
    """``repro``'s dry-run runtime: chunked attention (KV chunks of 512,
    query blocks of 2048), remat for training, the batch over the data
    axes and tensor parallelism over "model"."""
    dp = tuple(a for a in ("pod", "data") if mesh is not None and a in mesh.axis_names)
    rt = Runtime(attn_impl="chunked", kv_chunk=512, q_chunk=2048,
                 remat=(shape_kind == "train"), dp_axes=dp,
                 tp_axis="model" if mesh is not None else None, mesh=mesh)
    if overrides:
        rt = rt.replace(**overrides)
    return rt


def fake_device() -> torch.device:
    """Where the fake tensors lie: the card's device on a CUDA build, else
    ``meta`` (see the module's docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "meta")


def build_step_and_args(cfg, shape, mesh, rt_overrides: Optional[dict] = None,
                        lora_rank: Optional[int] = None, full_finetune: bool = False):
    """-> (cfg, step, args): the step of ``shape`` for one rank of ``mesh``
    and its arguments as ``meta`` pieces (made fake by :func:`evaluate`);
    ``cfg`` is the config ``shape`` runs (``arch_for_shape``)."""
    from ..sharding.fsdp import ShardedParams
    cfg = arch_for_shape(cfg, shape)
    rt = default_runtime(shape.kind, mesh, rt_overrides)
    opt = adamw(1e-4)
    args, _ = input_specs(cfg, shape, optimizer=opt, lora_rank=lora_rank, mesh=mesh)
    whole = model_mod.abstract_params(cfg, PARAM_DTYPE)

    def base(local):
        """The step's params: reads gather this rank's pieces over "data"."""
        return ShardedParams.from_local(whole, local, mesh).view()

    if shape.kind == "train":
        dp = batch_axes(mesh)
        rt = rt.replace(pool=mesh.group_over(dp), dp_axes=dp)
        if full_finetune:
            # the baseline the paper's LoRA choice avoids: every weight
            # trained, each rank's "model" piece whole over the data axes
            # (no FSDP of a trained base)
            params = map_with_path(lambda p, v: shard(v, P(*(
                e if e == "model" else None for e in param_spec(p, tuple(v.shape), mesh))),
                mesh), whole)
            full = make_full_finetune_step(cfg, rt, opt)
            opt_state = tree_map(lambda v: v.to("meta"), opt.init(params))
            return cfg, full, (params, opt_state, args[3])
        train = make_train_step(cfg, rt, opt)
        return cfg, (lambda local, *rest: train(base(local), *rest)), args
    if full_finetune:
        raise ValueError("--full-ft is for train shapes")
    step = (make_prefill_step if shape.kind == "prefill" else make_decode_step)(cfg, rt)
    return cfg, (lambda local, *rest: step(base(local), *rest)), args


def evaluate(cfg, shape, mesh, rt_overrides: Optional[dict] = None,
             lora_rank: Optional[int] = None, full_finetune: bool = False):
    """One rank's step of ``shape`` over ``mesh`` (a mesh of the fake world,
    on :func:`fake_device`), run on fake tensors -> (the config it ran,
    ``analysis.cost.StepCost``, the set-up seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    cfg, step, meta_args = build_step_and_args(cfg, shape, mesh, rt_overrides, lora_rank,
                                               full_finetune)
    dev = mesh.device
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tree_map(lambda v: torch.empty(v.shape, dtype=v.dtype, device=dev), meta_args)
        setup = time.time() - t0
        _, cost = measure(step, args)
    return cfg, cost, setup


def dryrun_one(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               rt_overrides: Optional[dict] = None, lora_rank: Optional[int] = None,
               full_finetune: bool = False, verbose: bool = True) -> dict:
    """One pair on rank 0 of the production mesh (every rank's pieces have
    the same shapes); the fake world is joined (again) when its size
    differs from the mesh's."""
    import torch.distributed as dist
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != chips:
        init_fake(chips)
    dev = fake_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    shape = SHAPES[shape_name]
    cfg, cost, setup = evaluate(ARCHS[arch_name], shape, mesh, rt_overrides, lora_rank,
                                full_finetune)
    rep = build_report(arch=arch_name, shape_cfg=shape, mesh_name=mesh_name, chips=chips,
                       cost=cost, cfg=cfg)
    mem = {"argument_size_in_bytes": cost.argument_bytes,
           "output_size_in_bytes": cost.output_bytes,
           "temp_size_in_bytes": cost.temp_bytes}
    result = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "device": str(dev),
        "lower_s": round(setup, 2), "compile_s": round(cost.seconds, 2),
        "memory_analysis": mem,
        "cost_analysis": {"flops": cost.flops, "bytes accessed": cost.bytes},
        "flops_by_op": cost.flops_by_op,
        "bytes_by_op": cost.bytes_by_op,
        "collectives": rep.coll_breakdown,
        "roofline": {
            "flops_per_device": rep.flops, "bytes_per_device": rep.bytes_accessed,
            "coll_bytes_per_device": rep.coll_bytes, "t_compute": rep.t_compute,
            "t_memory": rep.t_memory, "t_collective": rep.t_collective,
            "dominant": rep.dominant, "model_flops_global": rep.model_flops_global,
            "useful_ratio": rep.useful_ratio, "coll_links": rep.coll_links,
        },
    }
    if verbose:
        print(f"== {arch_name} x {shape_name} @ {mesh_name} (set-up "
              f"{result['lower_s']}s, abstract run {result['compile_s']}s)")
        print("memory_analysis:", json.dumps(mem))
        print("cost_analysis:", json.dumps(result["cost_analysis"]))
        rf = result["roofline"]
        print(f"roofline: compute {rf['t_compute']:.4g}s | memory "
              f"{rf['t_memory']:.4g}s | collective {rf['t_collective']:.4g}s "
              f"-> dominant: {rf['dominant']} | useful {rf['useful_ratio']:.3f} "
              f"(H100 SXM5: bf16 989 TFLOP/s, HBM3 3.35 TB/s, links {rf['coll_links']})",
              flush=True)
    return result


def parse_overrides(items) -> dict:
    """``k=v`` pairs: ints parsed, True/False as booleans, else strings."""
    out = {}
    for kv in items:
        k, v = kv.split("=")
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v if v not in ("True", "False") else v == "True"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help=f"one of {sorted(ARCHS)} or 'all'")
    ap.add_argument("--shape", default="all", help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="directory for per-pair JSON results")
    ap.add_argument("--rt", nargs="*", default=[], help="Runtime overrides k=v (ints parsed)")
    ap.add_argument("--lora-rank", type=int, default=None)
    ap.add_argument("--full-ft", action="store_true",
                    help="full fine-tuning baseline (train shapes only)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.rt)
    arch_names = [a.name for a in PORTED] if args.arch == "all" else [args.arch]
    shape_names = sorted(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.time()
    for mp in meshes:
        for arch in arch_names:
            for shape in shape_names:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.full_ft:
                    tag += "_fullft"
                try:
                    res = dryrun_one(arch, shape, multi_pod=mp, rt_overrides=overrides,
                                     lora_rank=args.lora_rank, full_finetune=args.full_ft)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(res, f, indent=1)
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    failures.append((tag, repr(e)))
                    print(f"!! FAILED {tag}: {e!r}", flush=True)
    n = len(meshes) * len(arch_names) * len(shape_names)
    print(f"\n{n - len(failures)} of {n} pairs passed in {time.time() - t0:.1f}s")
    if failures:
        print(f"{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
