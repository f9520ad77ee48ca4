"""Continuous-batching serving demo on the PyTorch/CUDA port
(``examples/continuous_batching.py`` on ``repro_torch``): stream E2E-style
requests of varying length through a fixed-slot engine.

The fused engine keeps its KV in a paged pool (16-token pages of a
96-position view a slot), prefills admitted prompts in page-sized chunks,
and decodes every live slot, samples and advances the slot state in one
batched step a token.  The run ends by replaying the same traffic through
the naive per-slot loop (``fused=False``, batch-1 slab decode) for a
throughput comparison; both must emit the same ids.

    PYTHONPATH=src python examples/torch_continuous_batching.py [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch import models as M
from repro_torch.configs import get_arch
from repro_torch.data import WordTokenizer, e2e_splits
from repro_torch.data.tokenizer import SEP
from repro_torch.models.generate import SampleConfig
from repro_torch.serving import Request, ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

cfg = get_arch("gpt2-s").reduced(num_layers=4)
params = M.init_params(cfg, torch.Generator().manual_seed(0), device=args.device)
lora = M.init_lora_stack(cfg, torch.Generator().manual_seed(1), rank=4,
                         device=args.device)

train, _, test = e2e_splits(500, 50, 50)
tok = WordTokenizer.from_corpus([e.text for e in train])


def make_requests():
    return [Request(uid=i, prompt=tok.encode(e.mr) + [SEP],
                    max_new_tokens=6 + i % 10)
            for i, e in enumerate(test[:10])]


def serve(fused: bool):
    eng = ServingEngine(cfg, params, lora=lora, max_slots=3, max_len=96,
                        sc=SampleConfig(greedy=True), fused=fused, device=args.device)
    requests = make_requests()
    for r in requests:
        eng.submit(r)
    t0 = time.time()
    steps = 0
    while any(not r.done for r in requests):
        n = eng.step()
        steps += 1
        if fused and steps % 5 == 0:
            done = sum(r.done for r in requests)
            print(f"step {steps:3d}: {n} live slots, "
                  f"{done}/{len(requests)} done")
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.time() - t0
    total = sum(len(r.output) for r in requests)
    return requests, total, wall, eng


requests, total, wall, eng = serve(fused=True)
print(f"\nfused engine ({'paged' if eng.paged else 'slab'} KV): {len(requests)} requests / "
      f"{total} tokens in {wall:.1f}s ({total/wall:.1f} tok/s), "
      f"{eng.prefill_compiles()} prefill shapes")
print("sample:", tok.decode(requests[0].output[:10]))

req_naive, total_n, wall_n, _ = serve(fused=False)
print(f"naive loop:   {total_n} tokens in {wall_n:.1f}s "
      f"({total_n/wall_n:.1f} tok/s)")
assert [r.output for r in requests] == [r.output for r in req_naive]
print(f"outputs identical; fused speedup {wall_n / wall:.2f}x")
