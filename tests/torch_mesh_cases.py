"""Cases of the port's multi-rank paths, run in one process (no group) and
in every rank of a gloo group, for ``test_torch_mesh_sfl.py``,
``test_torch_pod.py``, ``test_torch_tp.py``, ``test_torch_tp_serving.py``
and ``test_torch_moe_shard_map.py``.  Imports no JAX: the ranks are plain
PyTorch.

As a script it is one rank:

    python tests/torch_mesh_cases.py SUITE RANK WORLD STORE OUT [INPUTS]

SUITE is ``sfl``, ``pod``, ``tp``, ``serve`` or ``moe``; STORE the
FileStore path every rank shares; OUT the pickle rank 0 writes (every case's results, every tensor as
numpy); INPUTS a pickle of numpy trees handed over by the test (weights
drawn by ``repro``).  Each rank prints ``RANK r OK`` at the end.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch import models as TM  # noqa: E402
from repro_torch.models import model as TMM  # noqa: E402
from repro_torch.configs import TrainConfig, get_arch  # noqa: E402
from repro_torch.core.aggregation import RobustAggConfig  # noqa: E402
from repro_torch.core.sfl import RoundDynamics, SflLLM  # noqa: E402
from repro_torch.interop import lora_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.precision import PrecisionConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

K, B, S, I = 4, 2, 16, 2
COUNTS = [1.0, 2.0, 3.0, 4.0]
SFL_CASES = ("repro", "mixed", "dropped", "trimmed", "trimmed_weighted", "olmoe", "internvl")


def _np(tree):
    return tree_map(lambda v: v.detach().cpu().numpy(), tree)


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def sfl_setup(case: str, inputs=None):
    """-> (cfg, params, lora, SflLLM kwargs, round batches, dynamics)."""
    rng = np.random.default_rng(11)
    kw = {}
    dyn = None
    if case == "repro":
        cfg = get_arch("gpt2-s").reduced(num_layers=4)
        params = params_from_numpy(inputs["params"], "cpu")
        lora = lora_from_numpy(inputs["lora"], "cpu")
        toks = inputs["tokens"]
        return cfg, params, lora, dict(ell_c=2), {"tokens": toks, "labels": toks}, None
    if case in ("olmoe", "internvl"):
        name = "olmoe-1b-7b" if case == "olmoe" else "internvl2-2b"
        cfg = get_arch(name).reduced(num_layers=2, d_model=64)
        ell = 1
    else:
        cfg = get_arch("gpt2-s").reduced(num_layers=4, d_model=64)
        ell = 2
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(4), device="cpu")
    toks = _tokens(rng, cfg, (I, K, B, S))
    labels = _tokens(rng, cfg, (I, K, B, S))
    batches = {"tokens": toks, "labels": labels}
    if case == "mixed":
        kw = dict(ell_c=(1, 2, 3, 2), ranks=(2, 4, 8, 4), act_bits=(4, 8, 16, 8),
                  rt=TM.default_train_runtime().replace(precision=PrecisionConfig(
                      grad_bits=8, stochastic_rounding=True, error_feedback=True)))
        lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(4), rank=8, device="cpu")
    else:
        kw = dict(ell_c=ell)
    if case == "dropped":
        dyn = RoundDynamics(participation=torch.tensor([1.0, 0.0, 1.0, 1.0]))
    if case in ("trimmed", "trimmed_weighted"):
        dyn = RoundDynamics(robust=RobustAggConfig.make(trim=1))
    if case == "internvl":
        F = cfg.frontend_tokens
        batches["frontend_emb"] = (0.5 * rng.standard_normal(
            (I, K, B, F, cfg.d_model))).astype(np.float32)
    return cfg, params, lora, kw, batches, dyn


def run_sfl_case(case: str, mesh=None, inputs=None) -> dict:
    """One round (twice for the mixed fleet: its error feedback carries)
    of ``case``; the whole state and metrics as numpy."""
    cfg, params, lora, kw, batches, dyn = sfl_setup(case, inputs)
    # a weighted trimmed mean jumps where two clients' values tie (which of
    # them is trimmed moves the weights), and Adam's first steps make ties
    # (every update is about +-lr).  "trimmed" keeps Adam and weighs the
    # clients equally, which keeps the mean continuous; "trimmed_weighted"
    # keeps the engine's sample-count weights and takes SGD, whose updates
    # follow each client's own gradient, so no two clients tie
    opt = sgd(0.1) if case == "trimmed_weighted" else adamw(3e-3)
    tc = TrainConfig(num_clients=K, batch_size=B, local_steps=I)
    sfl = SflLLM(cfg, params, train_cfg=tc, optimizer=opt, device="cpu", mesh=mesh, **kw)
    st = sfl.init_state(lora)
    out = {}
    for rnd in range(2 if case == "mixed" else 1):
        counts = [1.0] * K if case == "trimmed" else COUNTS
        st, m = sfl.train_round(st, batches, counts, dynamics=dyn)
        out[f"loss{rnd}"] = m["loss"].numpy()
        out[f"aux{rnd}"] = m["aux"].numpy()
        out[f"total{rnd}"] = m["total"].numpy()
    if "anomaly_scores" in m:
        out["scores"] = {k: v.numpy() for k, v in m["anomaly_scores"].items()}
    whole = sfl.gather_state(st)
    out["lora_client"] = _np(whole.lora_client)
    out["lora_server"] = _np(whole.lora_server)
    out["opt_client"] = _np(whole.opt_client)
    out["err_act"] = None if whole.err_act is None else whole.err_act.numpy()
    out["err_grad"] = None if whole.err_grad is None else whole.err_grad.numpy()
    out["local_clients"] = int(tree_leaves(st.lora_client)[0].shape[0])
    return out


POD_CASES = ("repro", "olmoe")


def pod_setup(case: str, inputs=None):
    """-> (cfg, params, lora, pooled round batches (I, 2B, S))."""
    if case == "repro":
        cfg = get_arch("gpt2-s").reduced(num_layers=4)
        toks = inputs["pod_tokens"]
        return (cfg, params_from_numpy(inputs["params"], "cpu"),
                lora_from_numpy(inputs["lora"], "cpu"), {"tokens": toks, "labels": toks})
    cfg = get_arch("olmoe-1b-7b").reduced(num_layers=2, d_model=64)
    rng = np.random.default_rng(5)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(4), device="cpu")
    return cfg, params, lora, {"tokens": _tokens(rng, cfg, (I, 2 * B, S)),
                               "labels": _tokens(rng, cfg, (I, 2 * B, S))}


def run_pod_case(case: str, mesh, inputs=None) -> dict:
    from repro_torch.launch.engine import PodRound
    from repro_torch.sharding.specs import param_spec, shard, unshard
    cfg, params, lora, batches = pod_setup(case, inputs)
    # shard then unshard gives each leaf back whole, along its own dim
    roundtrip = all(torch.equal(unshard(shard(v, param_spec(p, tuple(v.shape), mesh), mesh),
                                        param_spec(p, tuple(v.shape), mesh), mesh), v)
                    for p, v in (("layers/0/mixer/wq/w", params["layers"][0]["mixer"]["wq"]["w"]),
                                 ("layers/0/mixer/wo/w", params["layers"][0]["mixer"]["wo"]["w"]),
                                 ("embed/tok", params["embed"]["tok"])))
    pod = PodRound(cfg, params, None, adamw(3e-3), mesh)
    del params
    (lo, _), m = pod.run_round(pod.init_state(lora), batches)
    sh, rep = pod.params.rule_bytes()
    layer = max(pod.params.gathered_bytes(f"layers/{i}") for i in range(cfg.num_layers))
    # the olmoe case's weights come from init_params at seed 3: drawn a
    # subtree at a time, this rank's pieces are the same as those cut from
    # the whole tree
    same_init = None
    if case == "olmoe":
        from repro_torch.sharding.fsdp import ShardedParams
        drawn = ShardedParams.init(cfg, torch.Generator().manual_seed(3), mesh)
        same_init = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(drawn.local), tree_leaves(pod.params.local)))
    return {"loss": m["loss"].numpy(), "aux": m["aux"].numpy(), "lora": _np(lo),
            "resident": pod.params.resident_bytes(), "sharded": sh, "replicated": rep,
            "peak_live": pod.params.peak_live_bytes, "layer_bytes": layer,
            "embed_bytes": pod.params.gathered_bytes("embed"), "roundtrip": roundtrip,
            "remat": pod.rt.remat, "same_init": same_init}


# the tensor-parallel cases: name -> (mesh shape, axes, config key, Runtime
# knobs).  A mesh smaller than the world runs once per block of its size
# (``tp_mesh``), every block alike
TP_CASES = {
    "gpt2_12": ((1, 2), ("data", "model"), "gpt2", {}),
    "gpt2_22": ((2, 2), ("data", "model"), "gpt2", {}),
    "gpt2_22_full": ((2, 2), ("data", "model"), "gpt2", {"remat_policy": "full"}),
    "gpt2_pod": ((2, 1, 2), ("pod", "data", "model"), "gpt2", {}),
    "gqa_div": ((2, 2), ("data", "model"), "gqa_div", {}),
    "gqa_nodiv": ((1, 2), ("data", "model"), "gqa_nodiv", {}),
    "olmoe": ((2, 2), ("data", "model"), "olmoe", {}),
    "olmoe_mc": ((1, 2), ("data", "model"), "olmoe", {"moe_constraints": True}),
    "jamba": ((1, 2), ("data", "model"), "jamba", {}),
    "gqa_seq": ((2, 2), ("data", "model"), "gqa_div_s128", {"seq_shard": True}),
    "olmoe_seq": ((1, 2), ("data", "model"), "olmoe_s128", {"seq_shard": True}),
    "olmoe_seq_mc": ((2, 2), ("data", "model"), "olmoe_s128",
                     {"seq_shard": True, "moe_constraints": True}),
}
TP_ROWS = 8
# SGD: the adapters then move by the gradients themselves.  Adam's first
# steps move an entry by about lr g / (|g| + eps), which turns an f32
# reordering error of 1e-8 in a gradient near eps = 1e-8 into 1e-3 of
# the update: two correct sums disagree there whatever the layout
TP_LR = 0.1


def tp_config(get_arch, key: str):
    """-> (cfg, S, moe_group) of a config key, built alike by either
    package's ``get_arch``.  GPT-2-S: biases, LayerNorm, learned positions,
    a tied vocabulary of 512 (cut over "model"); the GQA RoPE model with
    LoRA on q, v, o, up, down (row-parallel LoRA), its 4 KV heads cut on
    whole groups or its one KV head not (and a vocabulary of 509 that no
    axis cuts); olmoe with 4 experts of 2; Jamba's period of 8 (Mamba,
    attention, MoE every other layer) with LoRA in the Mamba mixers too;
    S 128 for seq_shard, whose olmoe groups of 32 fall within a rank's 64
    (at S 16 a group of 16 is cut over the two ranks)."""
    base = key.replace("_s128", "")
    S = 128 if key.endswith("_s128") else 16
    moe_group = 32 if key == "olmoe_s128" else 128
    if base == "gpt2":
        cfg = get_arch("gpt2-s").reduced(num_layers=2, d_model=64, vocab=512)
    elif base in ("gqa_div", "gqa_nodiv"):
        cfg = get_arch("yi-9b").reduced(num_layers=2, d_model=64,
                                        vocab=512 if base == "gqa_div" else 509)
        cfg = cfg.replace(lora_targets=("q", "v", "o", "up", "down"))
        if base == "gqa_nodiv":
            cfg = cfg.replace(num_kv_heads=1)
    elif base == "olmoe":
        cfg = get_arch("olmoe-1b-7b").reduced(num_layers=2, d_model=64)
    elif base == "jamba":
        cfg = get_arch("jamba-1.5-large-398b").reduced(num_layers=8, d_model=64)
        cfg = cfg.replace(lora_targets=("q", "v", "ssm_in", "ssm_out"))
    else:
        raise KeyError(key)
    return cfg, S, moe_group


def tp_mesh(shape, axes):
    """A mesh of ``shape`` over a world that it divides: the world is cut
    into blocks of its size (rank-major), each its own mesh."""
    import math
    from repro_torch.launch.mesh import Mesh, make_mesh, world_size
    n, world = math.prod(shape), world_size()
    if n == world:
        return make_mesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cpu", (world // n,) + tuple(shape),
                          mesh_dim_names=("block",) + tuple(axes))
    return Mesh(tuple(axes), dict(zip(axes, shape)), torch.device("cpu"),
                device_mesh=dm[tuple(axes)], backend="gloo")


def tp_runtime(cfg_key: str, knobs: dict):
    _, _, moe_group = tp_config(get_arch, cfg_key)
    return TM.default_train_runtime().replace(ssd_impl="chunked", moe_group=moe_group,
                                              **knobs)


def run_tp_case(case: str, mesh, inputs) -> dict:
    """Two steps of ``PodRound`` on ``case``'s config and knobs over
    ``mesh`` (or one process for a mesh of one), on ``repro``'s weights.
    ``gap``: the smallest margin, over every routed token of the run,
    between two of its K + 1 most probable experts (None without MoE):
    under it, any reordering of f32 sums can route a token differently
    (another expert, or the choices in another order)."""
    from repro_torch.launch.engine import PodRound
    from repro_torch.models import moe as moe_mod
    key, knobs = TP_CASES[case][2], TP_CASES[case][3]
    cfg, _, _ = tp_config(get_arch, key)
    inp = inputs["tp"][key]
    pod = PodRound(cfg, params_from_numpy(inp["params"], "cpu"), tp_runtime(key, knobs),
                   sgd(TP_LR), mesh)
    gaps, route = [], moe_mod.route

    def recording_route(cfg, p, xg):
        probs, gates, ids = route(cfg, p, xg)
        top = torch.topk(probs.detach(), cfg.experts_per_token + 1, dim=-1).values
        gaps.append(float((top[..., :-1] - top[..., 1:]).min()))
        return probs, gates, ids

    moe_mod.route = recording_route
    try:
        (lo, _), m = pod.run_round(pod.init_state(lora_from_numpy(inp["lora"], "cpu")),
                                   {"tokens": inp["tokens"], "labels": inp["labels"]})
    finally:
        moe_mod.route = route
    return {"loss": m["loss"].numpy(), "aux": m["aux"].numpy(), "lora": _np(lo),
            "resident": pod.params.resident_bytes(),
            "coord": {a: mesh.axis_rank(a) for a in mesh.axis_names},
            "tp": pod.rt.tp_axis, "remat": pod.rt.remat, "gap": min(gaps, default=None)}


# the serving cases over "model": name -> (mesh shape, config key, decode
# attention).  Each runs prefill and SERVE_STEPS decode steps on fixed tokens
SERVE_CASES = {
    "gqa_heads_12": ((1, 2), "gqa_heads", "flash"),
    "gqa_heads_14": ((1, 4), "gqa_heads", "flash"),
    "gqa_len_14": ((1, 4), "gqa_len", "naive"),
    "gqa_len_flash_14": ((1, 4), "gqa_len", "flash"),
    "mamba_12": ((1, 2), "mamba", "flash"),
    "jamba_12": ((1, 2), "jamba", "naive"),
    "olmoe_12": ((1, 2), "olmoe", "flash"),
}
SERVE_B, SERVE_S, SERVE_STEPS = 2, 12, 3
SERVE_L = 16            # the cache length: divides over 4 ranks


def serve_config(get_arch, key: str):
    """A serving config key built alike by either package's ``get_arch``:
    the GQA RoPE model (yi-9b at d 64, 4 heads of 16) with its 4 KV heads
    (cut on whole heads at tp 2 and 4) or 2 (KH 2 over tp 4: q/k/v
    gathered, the cache cut over its length); reduced Mamba2 (4 heads of
    32, the state cut over heads and channels); Jamba's period of 8 at
    d 64; olmoe with 4 experts of 2."""
    if key.startswith("gqa"):
        cfg = get_arch("yi-9b").reduced(num_layers=2, d_model=64)
        return cfg.replace(num_kv_heads=2) if key == "gqa_len" else cfg
    if key == "mamba":
        return get_arch("mamba2-2.7b").reduced(num_layers=2, d_model=64)
    if key == "jamba":
        return get_arch("jamba-1.5-large-398b").reduced(num_layers=8, d_model=64)
    if key == "olmoe":
        return get_arch("olmoe-1b-7b").reduced(num_layers=2, d_model=64)
    raise KeyError(key)


def run_serve_case(case: str, mesh, inputs) -> dict:
    """Prefill and ``SERVE_STEPS`` decode steps of ``case`` on ``repro``'s
    weights, over ``mesh``'s "model" axis (None: one process); the logits
    gathered whole, each rank's cache-leaf shapes and the pieces of
    ``abstract_cache`` by ``sharding.specs.cache_spec``."""
    from repro_torch.sharding.collectives import all_gather
    from repro_torch.sharding.specs import map_with_path, param_spec, shard
    _, key, impl = SERVE_CASES[case]
    cfg = serve_config(get_arch, key)
    inp = inputs["serve"][key]
    params = params_from_numpy(inp["params"], "cpu")
    lora = lora_from_numpy(inp["lora"], "cpu")
    rt = TM.Runtime(dense_impl="fused", decode_attn_impl=impl, ssd_impl="kernel")
    group = None
    if mesh is not None:
        params = map_with_path(lambda p, v: shard(v, param_spec(p, tuple(v.shape), mesh),
                                                  mesh), params)
        rt = rt.replace(tp_axis="model", mesh=mesh)
        group = mesh.group("model")

    def whole(logits):
        return (logits if logits.shape[-1] == cfg.vocab_size
                else all_gather(logits, group, -1)).numpy()

    toks = torch.from_numpy(inp["tokens"])
    L = SERVE_L
    logits, caches = TM.prefill(cfg, params, toks[:, :SERVE_S], lora=lora, rt=rt,
                                cache_len=L)
    out = {"logits": [whole(logits)], "cache_shapes": [
        {k: tuple(v.shape) for k, v in c.items()} for c in caches]}
    if mesh is not None:
        out["want_shapes"] = [{k: tuple(v.shape) for k, v in c.items()}
                              for c in TMM.abstract_cache(cfg, SERVE_B, L, mesh=mesh)]
        out["init_shapes"] = [{k: tuple(v.shape) for k, v in c.items()}
                              for c in TM.init_cache(cfg, SERVE_B, L, device="cpu", mesh=mesh)]
    for t in range(SERVE_STEPS):
        logits, caches = TM.decode_step(cfg, params, toks[:, SERVE_S + t:SERVE_S + t + 1],
                                        caches, SERVE_S + t, lora=lora, rt=rt)
        out["logits"].append(whole(logits))
    out["logits"] = np.stack(out["logits"])
    return out


MOE = dict(B=4, S=16, E=4, top=2, d=64, ff=32)


def moe_setup(inputs):
    cfg = get_arch("olmoe-1b-7b").reduced(d_model=MOE["d"]).replace(
        num_experts=MOE["E"], experts_per_token=MOE["top"], d_ff=MOE["ff"])
    p = tree_map(lambda a: torch.tensor(np.array(a)), inputs["moe_params"])
    return (cfg, p, torch.tensor(np.array(inputs["moe_x"])),
            torch.tensor(np.array(inputs["moe_ct"])))


def run_moe_case(mesh, inputs) -> dict:
    """This rank's piece of apply_moe_shard_map (capacity 16, no drops) and
    of the gradient of sum(y * ct) with respect to x."""
    from repro_torch.models.moe_shard_map import (apply_moe_shard_map, shard_moe_input,
                                                  shard_moe_params)
    cfg, p, x, ct = moe_setup(inputs)
    xl = shard_moe_input(x, mesh).requires_grad_()
    y = apply_moe_shard_map(cfg, shard_moe_params(p, mesh), xl, mesh, capacity_factor=16.0)
    (y * shard_moe_input(ct, mesh)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
            "coord": (mesh.axis_rank("data"), mesh.axis_rank("model"))}


def main(argv) -> None:
    suite, rank, world, store, out_path = argv[:5]
    rank, world = int(rank), int(world)
    inputs = None
    if len(argv) > 5:
        with open(argv[5], "rb") as f:
            inputs = pickle.load(f)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_file_store, make_client_mesh, make_mesh
    init_file_store(store, rank, world)
    results = {}
    if suite == "sfl":
        mesh = make_client_mesh()
        for case in SFL_CASES:
            results[case] = run_sfl_case(case, mesh, inputs)
    elif suite == "pod":
        mesh = make_mesh((world, 1), ("data", "model"))
        for case in POD_CASES:
            results[case] = run_pod_case(case, mesh, inputs)
    elif suite == "tp":
        for case, (shape, axes, key, _) in TP_CASES.items():
            if key in inputs["tp"]:             # the configs handed over
                results[case] = run_tp_case(case, tp_mesh(shape, axes), inputs)
    elif suite == "serve":
        for case, (shape, key, _) in SERVE_CASES.items():
            if key in inputs["serve"]:
                results[case] = run_serve_case(case, tp_mesh(shape, ("data", "model")),
                                               inputs)
    elif suite == "moe":
        results["moe"] = run_moe_case(make_mesh((2, world // 2), ("data", "model")), inputs)
    else:
        raise ValueError(suite)
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


def spawn(suite: str, world: int, tmp, inputs=None):
    """Start the ranks of ``suite`` as subprocesses (a FileStore in
    ``tmp``); -> (procs, out prefix).  ``collect`` waits for them."""
    import subprocess
    args = [suite, None, str(world), str(tmp / "store"), str(tmp / "out")]
    if inputs is not None:
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        args.append(str(tmp / "inputs.pkl"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        args[1] = str(r)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env=env))
    return procs, tmp / "out"


def collect(procs, out, timeout: float) -> list:
    """Wait for every rank (killing all of them at ``timeout`` seconds);
    -> each rank's results.  A rank that failed fails the caller."""
    import subprocess
    import time
    logs, t_end = [], time.time() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, t_end - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"ranks did not finish in {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK {r} OK" in log, log[-3000:]
    out_list = []
    for r in range(len(procs)):
        with open(f"{out}.{r}", "rb") as f:
            out_list.append(pickle.load(f))
    return out_list


if __name__ == "__main__":
    main(sys.argv[1:])
