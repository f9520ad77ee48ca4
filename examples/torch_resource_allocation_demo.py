"""Resource allocation demo on the PyTorch/CUDA port
(``examples/resource_allocation_demo.py`` on ``repro_torch``) — the
paper's Algorithms 2-3 end to end, then the heterogeneous fleet they
describe actually training:

1. sample a wireless scenario (Table II), build the delay model for GPT2-S,
   run BCD (greedy subchannels -> convex power control -> exhaustive split
   -> exhaustive rank) and compare against baselines a-d;
2. extend the search per client: each device gets its own (ell_k, r_k);
3. hand the decision to ``SflLLM.from_allocation`` and run real global
   rounds of the mixed fleet (slot-masked rank padding, rank-aware FedAvg,
   each round's local steps eager on the device) with the modeled
   wireless wall clock accumulated by launch.engine.Trainer;
4. make the episode time-varying: per-round block fading, a round deadline
   that drops stragglers, and drift-triggered warm re-allocation inside
   the capacity envelope that ``from_allocation(dynamic=True)`` sizes.

    PYTHONPATH=src python examples/torch_resource_allocation_demo.py [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given.  Set
REPRO_SMOKE=1 for extra-tiny shapes.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import DEFAULT_SYSTEM, get_arch
from repro_torch.core import (Problem, bcd_minimize_delay, bcd_minimize_delay_per_client,
                              latency_report, sample_clients, total_delay)
from repro_torch.core.resource import baseline, objective
from repro_torch.launch.engine import (SflRound, Trainer, WirelessDynamics,
                                       allocation_round_latency)

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

SMOKE = bool(os.environ.get("REPRO_SMOKE"))

cfg = get_arch("gpt2-s")
envs = tuple(sample_clients(DEFAULT_SYSTEM, rng=0))
print("clients:")
for k, e in enumerate(envs):
    print(f"  {k}: f={e.f_hz/1e9:.2f} GHz, d_main={e.d_main_m:.0f} m, "
          f"d_fed={e.d_fed_m:.1f} m")

prob = Problem(cfg=cfg, sys_cfg=DEFAULT_SYSTEM, envs=envs, seq_len=512,
               batch=16, local_steps=12)

t0 = time.perf_counter()
alloc, hist = bcd_minimize_delay(prob, verbose=True)
bcd_wall = time.perf_counter() - t0
print(f"\nBCD picked split l_c={alloc.ell_c}/{cfg.num_layers}, "
      f"rank r={alloc.rank}")
print(f"modeled total training delay: {hist[-1]:.0f} s")

# the (ell, rank) grid + convex power solves are memoized per episode
t0 = time.perf_counter()
bcd_minimize_delay(dataclasses.replace(prob, memoize=False))
bcd_wall_nomemo = time.perf_counter() - t0
stats = prob.cache_stats()
print(f"BCD wall: {bcd_wall*1e3:.0f} ms memoized vs "
      f"{bcd_wall_nomemo*1e3:.0f} ms cold "
      f"({bcd_wall_nomemo/max(bcd_wall, 1e-9):.1f}x; "
      f"{stats['sw_hits']} sw hits, {stats['pair_hits']} grid hits)")

rep = latency_report(cfg, DEFAULT_SYSTEM, envs,
                     alloc.rates_main(DEFAULT_SYSTEM, envs),
                     alloc.rates_fed(DEFAULT_SYSTEM, envs),
                     alloc.ell_c, alloc.rank, 512, 16, 12, 30.0)
print(f"per-round: T1={rep['t1']:.2f}s  T_sF={rep['t_server_fp']:.2f}s  "
      f"T_sB={rep['t_server_bp']:.2f}s  T2={rep['t2']:.2f}s  "
      f"T3={rep['t3']:.2f}s")

print("\nbaselines (mean of 5 seeds):")
for w in "abcd":
    ts = [objective(prob, baseline(prob, w, np.random.default_rng(s)))
          for s in range(5)]
    print(f"  baseline {w}: {np.mean(ts):9.0f} s "
          f"(+{100*(np.mean(ts)/hist[-1]-1):.0f}% vs proposed)")

# ---------------------------------------------------------------------------
# per-client (ell_k, r_k): heterogeneity pays when the edge server is the
# bottleneck — fast clients keep more layers to unload the pooled server
# pass, slow ones offload almost everything
# ---------------------------------------------------------------------------
edge_sys = dataclasses.replace(DEFAULT_SYSTEM, total_bandwidth_hz=50e6,
                               f_server_hz=1.0e9,
                               f_client_hz_range=(0.3e9, 3.0e9))
edge_envs = tuple(sample_clients(edge_sys, rng=0))
edge_prob = Problem(cfg=cfg, sys_cfg=edge_sys, envs=edge_envs, seq_len=512,
                    batch=16, local_steps=12)
g_alloc, g_hist = bcd_minimize_delay(edge_prob)
h_alloc, h_hist = bcd_minimize_delay_per_client(edge_prob)
print("\nedge scenario (50 MHz, 1 GHz server, clients 0.3-3.0 GHz):")
print(f"  best global pair: l_c={g_alloc.ell_c}, r={g_alloc.rank}  "
      f"-> {g_hist[-1]:.0f} s")
print(f"  per-client:       ell_k={h_alloc.ell_k.tolist()}, "
      f"r_k={h_alloc.rank_k.tolist()}  -> {h_hist[-1]:.0f} s "
      f"({100*(1 - h_hist[-1]/g_hist[-1]):.1f}% faster)")

# ---------------------------------------------------------------------------
# train the fleet the optimizer chose — reduced model so the demo runs in
# seconds; same code path as the full-size system
# ---------------------------------------------------------------------------
small_cfg = cfg.reduced(num_layers=4)
small_sys = dataclasses.replace(edge_sys, num_clients=3,
                                f_server_hz=0.4e9,
                                f_client_hz_range=(0.2e9, 5.0e9))
small_envs = tuple(sample_clients(small_sys, rng=3))
SEQ, BATCH, STEPS = (64, 2, 2) if SMOKE else (128, 4, 4)
small_prob = Problem(cfg=small_cfg, sys_cfg=small_sys, envs=small_envs,
                     seq_len=SEQ, batch=BATCH, local_steps=STEPS,
                     rank_candidates=(1, 2, 4))
small_alloc, small_hist = bcd_minimize_delay_per_client(small_prob)
print(f"\ntraining fleet: ell_k={small_alloc.ell_k.tolist()}, "
      f"r_k={small_alloc.rank_k.tolist()} "
      f"(modeled {total_delay(small_prob, small_alloc):.1f} s total)")

from repro_torch import models as M  # noqa: E402
from repro_torch.core import SflLLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

params = M.init_params(small_cfg, torch.Generator().manual_seed(0), device=args.device)
sfl = SflLLM.from_allocation(small_prob, small_alloc, params,
                             optimizer=adamw(1e-3), device=args.device)
state = sfl.init_state(sfl.init_lora(torch.Generator().manual_seed(7)))

K, b, S = 3, small_prob.batch, small_prob.seq_len
tokens = np.random.default_rng(0).integers(0, small_cfg.vocab_size,
                                           (K, b, S)).astype(np.int32)
batch = {"tokens": tokens, "labels": tokens}


def data_iter():
    while True:
        yield batch


trainer = Trainer(SflRound(sfl, [1.0] * K),
                  local_steps=small_prob.local_steps, log_every=1,
                  round_latency=allocation_round_latency(small_prob,
                                                         small_alloc))
state, history = trainer.fit(state, data_iter(), global_rounds=3)
print(f"trained 3 global rounds of the mixed fleet on {sfl.device}: "
      f"loss {history.losses[0]:.3f} -> {history.losses[-1]:.3f}; "
      f"hardware {history.wall_seconds:.1f}s, "
      f"modeled wireless {history.modeled_seconds:.1f}s")

# ---------------------------------------------------------------------------
# dynamic wireless rounds: the same fleet under per-round block fading,
# deadline straggler dropout (the mask computed from each round's channel
# state) and drift-triggered warm re-allocation of (ell_k, r_k) inside
# the capacity envelope, which is sized once, so a re-allocating round
# rebuilds nothing
# ---------------------------------------------------------------------------
dyn_sfl = SflLLM.from_allocation(small_prob, small_alloc, params,
                                 optimizer=adamw(1e-3), dynamic=True,
                                 device=args.device)
dyn_state = dyn_sfl.init_state(dyn_sfl.init_lora(torch.Generator().manual_seed(7)))
wireless = WirelessDynamics(small_prob, small_alloc, dyn_sfl,
                            fade_std_db=8.0, fade_rho=0.5,
                            deadline_factor=1.2, drift_threshold=0.15,
                            rng=0)
dyn_trainer = Trainer(SflRound(dyn_sfl, [1.0] * K),
                      local_steps=small_prob.local_steps, log_every=1,
                      dynamics=wireless)
dyn_state, dh = dyn_trainer.fit(dyn_state, data_iter(), global_rounds=3)
dropped = sum(len(p) - sum(p) for p in dh.participation)
print(f"dynamic episode: {len(dh.realloc_rounds)} re-allocations, {dropped} "
      f"client-rounds dropped, modeled wireless {dh.modeled_seconds:.1f}s "
      f"(deadline {wireless.deadline_s:.2f}s/round)")
