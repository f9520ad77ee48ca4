"""SflLLM training driver — argument parsing over launch.engine.Trainer.

Two modes, as in ``repro.launch.train``:

* ``--mode sfl`` (default): the paper's Algorithm 1 — K clients + main
  server + federated server (core.sfl), the resource allocator picking
  the split point (``--split`` overrides it), and the engine reporting the
  modeled wireless wall clock of every round.  Under ``torchrun`` with a
  world size that divides K, the client axis is cut over a
  ``("clients",)`` mesh (``SflLLM(mesh=)``).
* ``--mode pod``: the datacenter lowering — ``launch.engine.PodRound``,
  one LoRA train step over an (n, 1) ``("data", "model")`` mesh of the
  world's ranks, the frozen base FSDP-sharded over ``"data"``, I steps a
  round on the clients' pooled batches.

It runs on the card by default; every LoRA-adapted projection then goes
through the CUDA forward and backward kernels of ``kernels.lora_matmul``.
One process is a world of one; ``torchrun --nproc-per-node N -m
repro_torch.launch.train ...`` runs N ranks (NCCL between cards, one card
a rank; gloo with ``--device cpu``), of which rank 0 alone prints the log
lines and writes ``--checkpoint``.
``--checkpoint PATH`` saves the adapters at the end (``repro``'s file
format: the K clients' stacked adapters and the server's), which
``launch.serve --lora-checkpoint`` serves.  A front-end arch
(``--arch internvl2-2b|musicgen-large``) trains its language model on the
text alone, as ``repro.launch.train`` does: the CLI feeds no prefix.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-s --split 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-s --reduced \
      --device cpu --steps 12 --local-steps 6 [--checkpoint "$TMPDIR/ck.msgpack"]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --arch gpt2-s --reduced --device cpu --mode pod --steps 4 --local-steps 2
"""
from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-s")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--mode", choices=["sfl", "pod"], default="sfl",
                    help="sfl: Algorithm 1; pod: the FSDP LoRA step over the ranks")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--split", type=int, default=0, help="0 = allocator picks")
    ap.add_argument("--local-steps", type=int, default=6)
    ap.add_argument("--checkpoint", default="",
                    help="save the adapters here at the end (repro's msgpack format)")
    ap.add_argument("--log-every", type=int, default=1, help="rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def run(args: argparse.Namespace, *, params=None, lora=None):
    """Build the data, the allocation and the trainer, and train.  Returns
    (state, history, the ``SflLLM``, or the ``PodRound`` in pod mode).
    ``params`` / ``lora`` (the port's trees) replace the weights drawn
    from ``--seed``; the model config must match them."""
    import numpy as np
    import torch

    from ..configs import DEFAULT_SYSTEM, TrainConfig, get_arch
    from ..core import (Problem, SflLLM, bcd_minimize_delay, latency_report,
                        sample_clients)
    from ..data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from ..kernels.backend import resolve_device
    from ..models import init_lora_stack, init_params
    from ..optim import adamw
    from ..sharding.fsdp import ShardedParams
    from .engine import PodRound, SflRound, Trainer
    from .mesh import global_rank, init_from_env, make_client_mesh, make_mesh, world_size

    device = init_from_env(resolve_device(args.device))
    world, rank0 = world_size(), global_rank() == 0
    cfg = get_arch(args.arch)
    if args.reduced:
        # two pattern periods at least, so that a split exists (repro's CLI
        # takes max(4, len(pattern)): one period of Jamba's 8, no split)
        cfg = cfg.reduced(num_layers=max(4, 2 * len(cfg.pattern)))
    cfg = cfg.replace(lora_rank=args.rank)

    # data ------------------------------------------------------------------
    train, val, _ = e2e_splits(4000, 400, 400, seed=args.seed)
    tok = WordTokenizer.from_corpus([e.text for e in train])
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, tok.vocab_size)) \
        if tok.vocab_size > cfg.vocab_size else cfg
    parts = [np.array(train, dtype=object)[idx]
             for idx in iid_partition(len(train), args.clients, args.seed)]
    data = sfl_batches(tok, parts, args.batch, args.seq, args.seed)

    gen = torch.Generator().manual_seed(args.seed)
    if params is None and args.mode == "sfl":
        params = init_params(cfg, gen, device=device)
    if lora is None:
        lora = init_lora_stack(cfg, torch.Generator().manual_seed(args.seed + 1),
                               args.rank, device=device)
    tc = TrainConfig(num_clients=args.clients, batch_size=args.batch,
                     local_steps=args.local_steps, learning_rate=args.lr)
    rounds = max(1, args.steps // args.local_steps)

    # resource allocation (paper Algorithm 3) picks split + validates rank --
    envs = tuple(sample_clients(DEFAULT_SYSTEM, args.seed))
    prob = Problem(cfg=cfg, sys_cfg=DEFAULT_SYSTEM, envs=envs,
                   seq_len=args.seq, batch=args.batch,
                   local_steps=args.local_steps,
                   rank_candidates=(args.rank,))
    alloc, hist = bcd_minimize_delay(prob, rank0=args.rank)
    ell_c = args.split or alloc.ell_c
    if rank0:
        print(f"allocator: split={alloc.ell_c} rank={alloc.rank} "
              f"modeled total delay {hist[-1]:.1f}s (using split={ell_c})")

    if args.mode == "sfl":
        # client-axis data parallelism when the world size divides K
        mesh = (make_client_mesh(device=device)
                if world > 1 and args.clients % world == 0 else None)
        if mesh is not None and rank0:
            print(f"sharding the client axis over {world} ranks")
        algo = SflRound(SflLLM(cfg, params, ell_c=ell_c, train_cfg=tc,
                               optimizer=adamw(args.lr), device=device, mesh=mesh),
                        [len(p) for p in parts])
        state = algo.sfl.init_state(lora)
        report = latency_report(
            cfg, DEFAULT_SYSTEM, envs, alloc.rates_main(DEFAULT_SYSTEM, envs),
            alloc.rates_fed(DEFAULT_SYSTEM, envs), ell_c, alloc.rank,
            args.seq, args.batch, args.local_steps, rounds)
    else:
        mesh = make_mesh((world, 1), ("data", "model"), device)
        # each rank draws the seeded weights a subtree at a time and keeps
        # its pieces: no card holds the whole base
        algo = PodRound(cfg, ShardedParams.init(cfg, gen, mesh) if params is None else params,
                        None, adamw(args.lr), mesh)
        del params
        state = algo.init_state(lora)
        report = None
        data = ({"tokens": kb["tokens"].reshape(-1, args.seq),
                 "labels": kb["labels"].reshape(-1, args.seq)} for kb in data)
    trainer = Trainer(algo, local_steps=args.local_steps, log_every=args.log_every,
                      round_latency=report, checkpoint_path=args.checkpoint)
    state, history = trainer.fit(state, data, global_rounds=rounds)
    return state, history, algo.sfl if args.mode == "sfl" else algo


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    _, hist, trainer = run(args)
    from .mesh import global_rank
    if global_rank() != 0:
        return
    dev = trainer.device
    import torch
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    msg = (f"{len(hist.losses)} steps in {hist.wall_seconds:.1f}s "
           f"({hist.steps_per_sec:.2f} steps/s) on {where}; "
           f"loss {hist.losses[0]:.3f} -> {hist.losses[-1]:.3f}")
    if hist.modeled_seconds:
        msg += f"; modeled wireless wall clock {hist.modeled_seconds:.1f}s"
    print(msg)
    if args.checkpoint:
        print("saved", args.checkpoint)


if __name__ == "__main__":
    main()
