"""Serving driver for the port: the paged, single-adapter continuous-
batching engine on full-width GPT-2-S (``--reduced`` for a tiny variant),
on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-s --reduced \
      --device cpu --requests 8 --slots 4 --gen 8
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
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV page pool size (0 = slab-equivalent capacity)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_arch
    from ..models import init_lora_stack, init_params
    from ..models.generate import SampleConfig
    from ..serving import Request, ServingEngine

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=max(4, len(cfg.pattern)))
    dtype = getattr(torch, args.dtype)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         dtype, args.device)
    lora = init_lora_stack(cfg, torch.Generator().manual_seed(args.seed + 1),
                           args.rank, dtype, args.device)
    sc = (SampleConfig(greedy=True) if args.temperature == 0.0
          else SampleConfig(temperature=args.temperature))
    eng = ServingEngine(cfg, params, lora=lora, max_slots=args.slots,
                        max_len=args.max_len, sc=sc, seed=args.seed,
                        page_size=args.page_size,
                        num_pages=args.num_pages or None,
                        device=args.device, dtype=dtype)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(5, cfg.vocab_size,
                                        rng.integers(4, args.prompt_len + 1)).tolist(),
                    max_new_tokens=args.gen)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    if eng.device.type == "cuda":
        from ..kernels import build
        build.build()            # nvcc at first use: keep it out of the timing

    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs):
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0
    eng.check_consistency()
    total = sum(len(r.output) for r in reqs)
    dev = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
           else "cpu")
    print(f"served {len(reqs)} requests / {total} tokens in {wall:.2f}s "
          f"({total / wall:.1f} tok/s) on {dev} with {args.slots} slots, "
          f"{steps} engine steps, {eng.prefill_compiles()} prefill program "
          f"(paged(ps={eng.page_size},np={eng.num_pages}) engine, {args.dtype})")
    print("sample token ids:", reqs[0].output[:12])


if __name__ == "__main__":
    main()
