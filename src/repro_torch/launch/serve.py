"""Serving entry point of the port: the continuous-batching engine on a
full-width ``--arch`` (GPT-2-S by default, any registered config:
the dense RoPE family, the MoE models, Mamba2-2.7B; ``--reduced`` for a
tiny variant), on the card by default — the paged KV pool where
``--page-size`` divides ``--max-len``, the slab layout with ``--slab`` (or
otherwise), the naive per-slot loop with ``--naive``; ``--adapters N``
serves N tenants' adapters from one paged engine through an
``AdapterRegistry`` of ``--adapter-pool`` slots.  Mamba2 always takes the
slab engine (its recurrent state is not paged), so the engine refuses
``--adapters`` for it, as ``repro``'s does.  ``--lora-checkpoint PATH``
serves a saved adapter (``restore_lora``) in place of the seeded one.
``--deadline-steps N`` caps each request's decode steps per residency
(preempted and recomputed past it) and ``--preempt`` lets the paged
engine evict a lower-priority request under page pressure; greedy ids are
the same with and without them:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-s --reduced \
      --device cpu --checkpoint "$TMPDIR/ck.msgpack"
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s --reduced \
      --device cpu --lora-checkpoint "$TMPDIR/ck.msgpack"

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s --reduced \
      --device cpu --requests 8 --slots 4 --gen 8 [--slab | --naive]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s --reduced \
      --device cpu --requests 8 --slots 4 --gen 8 --preempt --deadline-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s --reduced \
      --device cpu --adapters 5 --adapter-pool 4 --tenant-trace zipf --tenant-quota 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --reduced \
      --device cpu --requests 4 --slots 2 --gen 6 --prompt-len 12 [--naive]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --slots 8 \
      --max-len 512 --profile
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-s")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--lora-checkpoint", default="",
                    help="serve this saved adapter (restore_lora) at rank --rank")
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--naive", action="store_true",
                    help="per-slot decode loop with host-side sampling (baseline)")
    ap.add_argument("--slab", action="store_true",
                    help="fixed-slab KV cache instead of the paged pool")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV page pool size (0 = slab-equivalent capacity)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request decode-step residency budget; a request over it "
                         "is preempted and requeued for prefix recompute (0 = none; "
                         "paged engine only)")
    ap.add_argument("--preempt", action="store_true",
                    help="under page pressure, evict the lowest-priority resident "
                         "instead of queueing new work (paged engine only)")
    ap.add_argument("--adapters", type=int, default=0,
                    help="serve N distinct tenant adapters from ONE engine "
                         "(multi-tenant; paged engine only; 0 = single shared adapter)")
    ap.add_argument("--adapter-pool", type=int, default=0,
                    help="device-resident adapter slots (0 = auto: enough for the "
                         "batch, capped at 8 so cold tenants exercise LRU paging)")
    ap.add_argument("--tenant-trace", choices=["roundrobin", "zipf"],
                    default="roundrobin",
                    help="how requests map to tenants: uniform round-robin or a "
                         "Zipf-skewed popularity mix")
    ap.add_argument("--tenant-quota", type=int, default=0,
                    help="max live slots per tenant (0 = unlimited)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve one warm-up request first, then trace the run with "
                         "torch.profiler: device busy share and device time by kernel")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_arch
    from ..models import init_lora_stack, init_params
    from ..models.generate import SampleConfig
    from ..serving import AdapterRegistry, Request, ServingEngine

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=max(4, len(cfg.pattern)))
    dtype = getattr(torch, args.dtype)
    # drawn by a generator on the serving device: on the card, billions of
    # weights without minutes of host draws (other numbers than the CPU
    # generator's for the same seed)
    params = init_params(cfg, torch.Generator(device=args.device).manual_seed(args.seed),
                         dtype, args.device)
    registry, lora = None, None
    if args.adapters:
        # one trained adapter per tenant (federated fleets emit these); the
        # pool holds a bounded working set and LRU-pages the rest
        pool = args.adapter_pool or max(args.slots, min(args.adapters, 8))
        registry = AdapterRegistry(cfg, pool_size=pool, rank=args.rank, dtype=dtype,
                                   device=args.device)
        for t in range(args.adapters):
            registry.publish(t, tenant_adapter(cfg, args.seed + 1 + t, args.rank))
    else:
        lora = init_lora_stack(cfg, torch.Generator().manual_seed(args.seed + 1),
                               args.rank, dtype, args.device)
        if args.lora_checkpoint:
            lora = restore_lora(cfg, args.lora_checkpoint, lora)
            print("loaded adapter from", args.lora_checkpoint)
    sc = (SampleConfig(greedy=True) if args.temperature == 0.0
          else SampleConfig(temperature=args.temperature))
    paged = False if (args.slab or args.naive) else None     # None = auto
    eng = ServingEngine(cfg, params, lora=lora, adapters=registry,
                        tenant_quota=args.tenant_quota, max_slots=args.slots,
                        max_len=args.max_len, sc=sc, seed=args.seed,
                        fused=not args.naive, paged=paged, page_size=args.page_size,
                        num_pages=args.num_pages or None, preempt=args.preempt,
                        device=args.device, dtype=dtype)
    if (args.deadline_steps or args.preempt) and not eng.paged:
        raise SystemExit("--deadline-steps/--preempt need the paged engine "
                         "(drop --slab/--naive)")

    rng = np.random.default_rng(args.seed)

    def tenant_of(i: int) -> int:
        if not args.adapters:
            return 0
        if args.tenant_trace == "zipf":
            return int(rng.zipf(1.5)) % args.adapters
        return i % args.adapters

    reqs = [Request(uid=i,
                    prompt=rng.integers(5, cfg.vocab_size,
                                        rng.integers(4, args.prompt_len + 1)).tolist(),
                    max_new_tokens=args.gen, deadline_steps=args.deadline_steps or None,
                    tenant=tenant_of(i))
            for i in range(args.requests)]
    if eng.device.type == "cuda":
        from ..kernels import build
        build.build()            # nvcc at first use: keep it out of the timing
    if args.profile:             # first calls (cuBLAS, allocator) out of the trace
        eng.submit(Request(uid=-1, prompt=[5, 6, 7], max_new_tokens=2))
        eng.run()
        eng.reset_stats()
    for r in reqs:
        eng.submit(r)

    prof = _profiler(eng.device) if args.profile else None
    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs):
        eng.step()
        steps += 1
    if prof is not None:
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
    wall = time.perf_counter() - t0
    eng.check_consistency()
    total = sum(len(r.output) for r in reqs)
    dev = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
           else "cpu")
    mode = "naive" if args.naive else ("slab" if not eng.paged else
                                       f"paged(ps={eng.page_size},np={eng.num_pages})")
    print(f"served {len(reqs)} requests / {total} tokens in {wall:.2f}s "
          f"({total / wall:.1f} tok/s) on {dev} with {args.slots} slots, "
          f"{steps} engine steps, {eng.prefill_compiles()} prefill compiles "
          f"({mode} engine, {args.dtype})")
    if eng.paged and (args.deadline_steps or args.preempt):
        print(f"fault stats: {eng.stats['preemptions']} preemptions "
              f"({eng.stats['deadline_preemptions']} deadline), "
              f"{eng.stats['recomputed_tokens']} tokens recomputed, "
              f"{eng.stats['quarantined']} quarantined")
    if registry is not None:
        tt = eng.stats["tenant_tokens"]
        dist = " ".join(f"t{t}:{tt[t]}" for t in sorted(tt))
        print(f"multi-tenant: {args.adapters} tenants over {registry.pool_size} pool "
              f"slots ({args.tenant_trace} trace), {eng.stats['adapter_swaps']} adapter "
              f"swaps ({registry.stats['evictions']} evictions, "
              f"{registry.stats['hot_swaps']} hot swaps)")
        print(f"per-tenant tokens: {dist}")
    print("sample token ids:", reqs[0].output[:12])
    st = eng.stats
    prefills = st["prefills"] + st["prefill_chunks"]
    print(f"decode {st['decode_steps']} steps, {st['decode_s'] * 1e3:.1f} ms "
          f"({st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms/step); prefill "
          f"{prefills} calls, {st['prefill_s'] * 1e3:.1f} ms "
          f"({st['prefill_s'] / max(prefills, 1) * 1e3:.2f} ms/call) (host clock)")
    if prof is not None:
        _report(prof, wall)


def restore_lora(cfg, path: str, template):
    """The served adapter stack saved at ``path``, in ``template``'s place
    (the port's per-layer stack; dtype and device follow the template).

    The file is ``repro``'s format, holding the whole stack (what
    ``repro.launch.serve --lora-checkpoint`` reads) or ``launch.train
    --checkpoint``'s ``{"lora_client" (K, ...), "lora_server"}``, served
    with client 0's adapter below the split and the server's above it, as
    ``examples/serve_lora.py`` joins a trainer's hand-off.  Client and
    server parts that do not tile the stack (a heterogeneous fleet's
    overlap) raise ``ValueError``: the file does not say where client 0
    splits."""
    from ..checkpoint import restore_pytree
    from ..core.lora import concat_tree
    from ..interop import lora_from_numpy, lora_to_numpy
    from ..tree import tree_leaves, tree_map

    leaf = tree_leaves(template)[0]
    stack = lora_to_numpy(template, len(cfg.pattern))
    try:
        return lora_from_numpy(restore_pytree(path, stack), leaf.device, leaf.dtype)
    except KeyError:
        tree = restore_pytree(path, {"lora_client": stack, "lora_server": stack})
    parts = [lora_from_numpy(tree_map(lambda v: v[0], tree["lora_client"]), leaf.device,
                             leaf.dtype),
             lora_from_numpy(tree["lora_server"], leaf.device, leaf.dtype)]
    if len(parts[0]) + len(parts[1]) != len(template):
        raise ValueError(f"{path!r}: {len(parts[0])} client and {len(parts[1])} server layers "
                         f"do not tile the {len(template)}-layer stack")
    return concat_tree(*parts)


def tenant_adapter(cfg, seed: int, rank: int):
    """Tenant ``seed``'s adapter, on the CPU (the registry keeps it as the
    host copy): LoRA's A from ``init_lora_stack`` and a random B ~ N(0,
    0.02²) from the same generator.  B must not be 0 — under LoRA's B = 0
    init every tenant computes the same thing, and a gather that ignored
    its index would pass unseen."""
    import torch
    from ..models import init_lora_stack
    gen = torch.Generator().manual_seed(seed)
    lora = init_lora_stack(cfg, gen, rank, torch.float32, "cpu")
    for layer in lora:
        for block in layer.values():
            for ad in block.values():
                ad["b"].copy_(torch.randn(ad["b"].shape, generator=gen) * 0.02)
    return lora


def _profiler(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _report(prof, wall_s: float, top: int = 12) -> None:
    """Device busy share (the union of the traced kernels' intervals over
    the run's wall time) and device time by kernel name."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (b - a))
    if not spans:
        print("profile: no device events traced (CPU run, or no device trace)")
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(t for _, t in by_name.values())
    print(f"profile: device busy {busy / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"({100 * busy * 1e-6 / wall_s:.1f}%), {len(spans)} kernels, "
          f"{total / 1e3:.1f} ms of kernel time")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"profile:   {t / 1e3:8.2f} ms  {100 * t / total:5.1f}%  {n:6d}x  {name[:90]}")


if __name__ == "__main__":
    main()
