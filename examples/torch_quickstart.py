"""Quickstart on the PyTorch/CUDA port: split-federated LoRA fine-tuning of
a small GPT-2 on the synthetic E2E task, through the port's public API
(``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given; on the
card every adapted projection goes through the fused LoRA kernels.  Set
REPRO_SMOKE=1 for extra-tiny shapes.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import models as M
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.core.sfl import SflLLM
from repro_torch.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
from repro_torch.launch.engine import SflRound, Trainer
from repro_torch.optim import adamw

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

SMOKE = bool(os.environ.get("REPRO_SMOKE"))
K, BATCH, SEQ = 3, 4, 32 if SMOKE else 48
N_TRAIN, STEPS, ROUNDS = (200, 2, 2) if SMOKE else (1000, 6, 3)

# 1. model: reduced GPT-2 (the paper's architecture), LoRA rank 4 ---------
cfg = get_arch("gpt2-s").reduced(num_layers=4)
params = M.init_params(cfg, torch.Generator().manual_seed(0),
                       device=args.device)                        # frozen base
lora = M.init_lora_stack(cfg, torch.Generator().manual_seed(1), rank=4,
                         device=args.device)                      # trainable adapters

# 2. federated data: E2E-style corpus split across K clients --------------
train, _, _ = e2e_splits(N_TRAIN, 100, 100)
tok = WordTokenizer.from_corpus([e.text for e in train])
parts = [np.array(train, dtype=object)[i] for i in iid_partition(len(train), K)]
data = sfl_batches(tok, parts, BATCH, SEQ)

# 3. SflLLM: clients hold layers [0, 2), main server the rest -------------
tc = TrainConfig(num_clients=K, batch_size=BATCH, local_steps=STEPS)
sfl = SflLLM(cfg, params, ell_c=2, train_cfg=tc, optimizer=adamw(3e-3),
             device=args.device)
state = sfl.init_state(lora)

# 4. train: E global rounds, each I local steps (the clients' forward, the
#    server's forward and backward, the clients' backward, eager on the
#    device) and a FedAvg of the client adapters, through the engine -----
trainer = Trainer(SflRound(sfl, [len(p) for p in parts]),
                  local_steps=tc.local_steps, log_every=1)
state, hist = trainer.fit(state, data, global_rounds=ROUNDS)
print(f"\nloss: {hist.losses[0]:.3f} -> {hist.losses[-1]:.3f} over "
      f"{len(hist.losses)} steps ({hist.steps_per_sec:.2f} steps/s)")
