"""Serving example on the PyTorch/CUDA port (``examples/serve_lora.py`` on
``repro_torch``): load a LoRA adapter (e.g. from torch_train_sfl_e2e.py
or train_sfl_e2e.py: ``repro``'s msgpack format, read by the port's own
codec) and serve E2E-style prompts through the continuous-batching
engine — each request keeps its own length (bucketed prefill, no
host-side batch padding) and every live slot decodes in one batched step
a token.

    PYTHONPATH=src python examples/torch_serve_lora.py [--adapter /tmp/sfl_lora.msgpack] \\
        [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given; on the
card the projections go through the fused LoRA kernels and the decode
attention through the split-K decode kernel.
"""
import argparse

import torch

from repro_torch import models as M
from repro_torch.configs import get_arch
from repro_torch.data import WordTokenizer, e2e_splits
from repro_torch.models.generate import SampleConfig
from repro_torch.serving import Request, ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--adapter", default="")
ap.add_argument("--gen", type=int, default=16)
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

cfg = get_arch("gpt2-s").reduced(num_layers=6, d_model=256)
params = M.init_params(cfg, torch.Generator().manual_seed(0), device=args.device)
lora = M.init_lora_stack(cfg, torch.Generator().manual_seed(1), rank=4,
                         device=args.device)

train, _, test = e2e_splits(1000, 100, 100)
tok = WordTokenizer.from_corpus([e.text for e in train])

if args.adapter:
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.core.lora import concat_tree, split_tree
    from repro_torch.interop import lora_from_numpy, lora_to_numpy

    P = len(cfg.pattern)
    client, server = split_tree(lora, 2, P)
    saved = restore_pytree(args.adapter, {"lora_server": lora_to_numpy(server, P),
                                          "lora_client0": lora_to_numpy(client, P)})
    lora = concat_tree(lora_from_numpy(saved["lora_client0"], args.device),
                       lora_from_numpy(saved["lora_server"], args.device))
    print("loaded adapter from", args.adapter)

prompts = [t.mr + " <sep>" for t in test[:4]]
requests = [Request(uid=i, prompt=tok.encode(p), max_new_tokens=args.gen)
            for i, p in enumerate(prompts)]

eng = ServingEngine(cfg, params, lora=lora, max_slots=4,
                    max_len=max(len(r.prompt) for r in requests) + args.gen,
                    sc=SampleConfig(greedy=True), device=args.device)
for r in requests:
    eng.submit(r)
eng.run()

for p, r in zip(prompts, requests):
    print("-" * 60)
    print("PROMPT:", p)
    print("OUTPUT:", tok.decode(r.output))
