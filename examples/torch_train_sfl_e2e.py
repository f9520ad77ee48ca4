"""End-to-end training on the PyTorch/CUDA port (``examples/train_sfl_e2e.py``
on ``repro_torch``): resource allocation chooses (split, rank), then
split-federated LoRA fine-tuning of a GPT-2-family model on the synthetic
E2E corpus through the round engine (I eager local steps on the device
and a FedAvg per global round), with validation tracking, the modeled
wireless wall clock, and the adapters saved in ``repro``'s msgpack format
(the port's own codec), which ``examples/torch_serve_lora.py --adapter``
and ``examples/serve_lora.py --adapter`` both read.

Default is a small model; ``--full`` trains the real GPT2-S (124M, the
paper's model).  It runs on the card (``cuda``) unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/torch_train_sfl_e2e.py [--steps 240] [--full] \\
        [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import DEFAULT_SYSTEM, TrainConfig, get_arch
from repro_torch.core import Problem, bcd_minimize_delay, latency_report, sample_clients
from repro_torch.core.sfl import SflLLM
from repro_torch.data import WordTokenizer, batches, e2e_splits, iid_partition, sfl_batches
from repro_torch.launch.engine import SflRound, Trainer
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=240)
ap.add_argument("--full", action="store_true", help="real GPT2-S (124M)")
ap.add_argument("--clients", type=int, default=5)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--local-steps", type=int, default=12)
ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sfl_lora.msgpack"))
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

cfg = get_arch("gpt2-s")
if not args.full:
    cfg = cfg.reduced(num_layers=6, d_model=256)

# ---- data: 42k-style corpus, K-way federated ------------------------------
train, val, test = e2e_splits(8000, 800, 800)
tok = WordTokenizer.from_corpus([e.text for e in train])
parts = [np.array(train, dtype=object)[i]
         for i in iid_partition(len(train), args.clients)]
data = sfl_batches(tok, parts, args.batch, args.seq)
val_batch = next(batches(tok, val, 64, args.seq, rng=9))

# ---- resource allocation picks split + rank (Algorithm 3) ----------------
envs = tuple(sample_clients(DEFAULT_SYSTEM, 0))
prob = Problem(cfg=cfg, sys_cfg=DEFAULT_SYSTEM, envs=envs, seq_len=args.seq,
               batch=args.batch, local_steps=args.local_steps)
alloc, hist = bcd_minimize_delay(prob)
print(f"allocator: split l_c={alloc.ell_c}, rank r={alloc.rank}, "
      f"modeled delay {hist[-1]:.0f}s over the wireless network")

# ---- SFL training through the round engine --------------------------------
params = M.init_params(cfg, torch.Generator().manual_seed(0), device=args.device)
lora = M.init_lora_stack(cfg, torch.Generator().manual_seed(1), rank=alloc.rank,
                         device=args.device)
tc = TrainConfig(num_clients=args.clients, batch_size=args.batch,
                 local_steps=args.local_steps)
sfl = SflLLM(cfg, params, ell_c=alloc.ell_c, train_cfg=tc,
             optimizer=adamw(3e-3), device=args.device)
state = sfl.init_state(lora)

rounds = max(1, args.steps // args.local_steps)
report = latency_report(
    cfg, DEFAULT_SYSTEM, envs, alloc.rates_main(DEFAULT_SYSTEM, envs),
    alloc.rates_fed(DEFAULT_SYSTEM, envs), alloc.ell_c, alloc.rank,
    args.seq, args.batch, args.local_steps, rounds)
t0 = time.time()
val_hist = []


def on_round(e, st, h):
    vl = float(sfl.eval_loss(st, val_batch))
    val_hist.append(vl)
    print(f"  step {len(h.losses):4d}  train {h.losses[-1]:.4f}  "
          f"val {vl:.4f}  ({time.time()-t0:.0f}s; modeled "
          f"{h.modeled_seconds:.0f}s)")


algo = SflRound(sfl, [len(p) for p in parts])
trainer = Trainer(algo, local_steps=args.local_steps, round_latency=report,
                  callback=on_round)
state, hist = trainer.fit(state, data, global_rounds=rounds)
print(f"\ntrained {len(hist.losses)} steps in {hist.wall_seconds:.0f}s "
      f"({hist.steps_per_sec:.2f} steps/s); "
      f"val loss {val_hist[0]:.3f} -> {val_hist[-1]:.3f}")

# the schema examples/torch_serve_lora.py and examples/serve_lora.py read:
# repro's stacked layout, numpy leaves (post-aggregation all clients are
# identical, so client 0 stands for the broadcast global adapter)
payload = algo.checkpoint_payload(state)
save_pytree(args.out, {"lora_server": payload["lora_server"],
                       "lora_client0": tree_map(lambda v: v[0], payload["lora_client"])})
print("adapters saved to", args.out)
