"""Cases of the port's multi-rank paths, run in one process (no group) and
in every rank of a gloo group, for ``test_torch_mesh_sfl.py`` and
``test_torch_pod.py``.  Imports no JAX: the ranks are plain PyTorch.

As a script it is one rank:

    python tests/torch_mesh_cases.py SUITE RANK WORLD STORE OUT [INPUTS]

SUITE is ``sfl`` or ``pod``; STORE the FileStore path every rank shares;
OUT the pickle rank 0 writes (every case's results, every tensor as
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
