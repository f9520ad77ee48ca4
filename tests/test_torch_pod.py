"""The pod mode (``launch.engine.PodRound``): the FSDP LoRA step over a
(2, 1) ``("data", "model")`` gloo group (a "model" axis above 1 is
``test_torch_tp.py``'s), one spawn for every case
(``torch_mesh_cases``), and the ``--mode pod`` CLI under ``torchrun``.

* GPT-2-S reduced to 4 layers on ``repro``'s weights, a pooled batch of
  8 x 16 cut over "data", I 2: losses and adapters against ``repro``'s
  ``PodRound`` on a (1, 1) mesh within 1e-4, and against the port's
  one-process ``PodRound`` within 1e-5; so is reduced olmoe (its MoE aux
  over both ranks' rows).
* Each rank's resident frozen bytes equal the rule table's count: half of
  every leaf ``repro``'s ``param_spec`` shards over "data" = 2 plus every
  other leaf whole; at most two gathered layers (or the embedding and a
  layer) are alive at once.
* Each rank's pieces drawn a subtree at a time (``ShardedParams.init``)
  equal those cut from the whole tree; the layers are recomputed in the
  backward over 2 ranks and not in a world of one, where the view and
  ``Runtime.remat`` give the plain loss and gradients.
* ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
  --mode pod`` prints the one-process run's loss lines.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import torch_mesh_cases as C
from repro import models as JM
from repro.configs import get_arch as j_get_arch
from repro.launch.engine import PodRound as JPodRound
from repro.launch.mesh import make_mesh_compat
from repro.optim import adamw as j_adamw
from repro.sharding import specs as JS
from repro_torch.interop import split_layers
from repro_torch.launch.mesh import make_debug_mesh

TIMEOUT = 150
ROWS = 8
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in t for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [np.asarray(t)]


def _maxerr(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    cfg = j_get_arch("gpt2-s").reduced(num_layers=4)
    params = JM.init_params(cfg, jax.random.key(0))
    lora = JM.init_lora_stack(cfg, jax.random.key(7))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (C.I, ROWS, C.S)).astype(np.int32)
    inputs = {"params": jax.tree.map(np.asarray, params),
              "lora": jax.tree.map(np.asarray, lora), "pod_tokens": toks}
    procs, out = C.spawn("pod", 2, tmp, inputs)
    jpod = JPodRound(cfg, params, None, j_adamw(3e-3),
                     make_mesh_compat((1, 1), ("data", "model")))
    (jlora, _), jm = jpod.run_round(jpod.init_state(lora), {"tokens": toks, "labels": toks})
    one = make_debug_mesh(1, 1)
    ref = {case: C.run_pod_case(case, one, inputs) for case in C.POD_CASES}
    ranks = C.collect(procs, out, TIMEOUT)
    # repro's rule-table count of one rank's bytes on a (2, 1) mesh
    jmesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, axis_names=("data", "model"))
    want_bytes = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0]:
        spec = JS.param_spec(JS._key_str(kp), leaf.shape, jmesh)
        want_bytes += leaf.nbytes // (2 if any(e is not None for e in spec) else 1)
    return {"ranks": ranks, "ref": ref, "want_bytes": want_bytes,
            "repro": {"loss": np.asarray(jm["loss"]),
                      "lora": split_layers(jax.tree.map(np.asarray, jlora))}}


def test_pod_round_matches_repro(runs):
    got, want = runs["ranks"][0]["repro"], runs["repro"]
    assert np.abs(got["loss"] - want["loss"]).max() < 1e-4
    assert _maxerr(got["lora"], want["lora"]) < 1e-4
    assert np.abs(runs["ref"]["repro"]["loss"] - want["loss"]).max() < 1e-4


@pytest.mark.parametrize("case", C.POD_CASES)
def test_pod_round_matches_one_process(runs, case):
    got, want = runs["ranks"][0][case], runs["ref"][case]
    for k in ("loss", "aux", "lora"):
        assert _maxerr(got[k], want[k]) < 1e-5, (case, k)
    for k in ("loss", "aux", "lora"):
        assert _maxerr(got[k], runs["ranks"][1][case][k]) == 0.0
    if case == "olmoe":
        assert (got["aux"] > 0).all()


@pytest.mark.parametrize("rank", [0, 1])
def test_resident_bytes_follow_the_rule_table(runs, rank):
    got = runs["ranks"][rank]["repro"]
    assert got["roundtrip"]            # shard + unshard (wq dim 0, wo dim 1, tok dim 1)
    assert got["resident"] == runs["want_bytes"]
    assert got["resident"] == got["sharded"] // 2 + got["replicated"]
    assert got["sharded"] > 0 and got["replicated"] > 0
    # one world: nothing sharded, nothing gathered
    one = runs["ref"]["repro"]
    assert one["resident"] == one["replicated"] and one["peak_live"] == 0
    two = max(2 * got["layer_bytes"], got["layer_bytes"] + got["embed_bytes"])
    assert 0 < got["peak_live"] <= two


@pytest.mark.parametrize("rank", [0, 1])
def test_drawn_pieces_equal_the_cut_tree(runs, rank):
    """ShardedParams.init (a subtree drawn, then cut) keeps the pieces
    that cutting init_params's whole tree gives, over 2 ranks and 1."""
    assert runs["ranks"][rank]["olmoe"]["same_init"] is True
    assert runs["ref"]["olmoe"]["same_init"] is True


def test_layers_are_recomputed_only_over_ranks(runs):
    assert runs["ranks"][0]["repro"]["remat"] and runs["ranks"][1]["repro"]["remat"]
    assert not runs["ref"]["repro"]["remat"]


def test_view_and_remat_match_the_plain_loss():
    """The FSDP view in a world of one reads the layers as they are
    (slices stay lazy), and loss_fn over it, with and without
    Runtime.remat, gives the plain loss and LoRA gradients."""
    import torch
    from repro_torch import models as TM
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.sharding.fsdp import ShardedParams
    from repro_torch.tree import tree_leaves
    cfg = get_arch("gpt2-s").reduced(num_layers=3, d_model=64)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks, "labels": toks}
    view = ShardedParams(params, make_debug_mesh(1, 1)).view()
    layers = view["layers"]
    assert len(layers) == 3 and len(layers[1:]) == 2
    assert layers[1:][0]["mixer"]["wq"]["w"] is params["layers"][1]["mixer"]["wq"]["w"]
    assert view["embed"]["tok"] is params["embed"]["tok"]
    want = _value_and_grad(lambda lo: TM.loss_fn(cfg, params, lo, batch, rt=TM.Runtime()), lora)
    for rt in (TM.Runtime(), TM.Runtime(remat=True)):
        got = _value_and_grad(lambda lo: TM.loss_fn(cfg, view, lo, batch, rt=rt), lora)
        assert torch.equal(got[0], want[0])
        for a, b in zip(tree_leaves(got[2]), tree_leaves(want[2])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
        assert max(g.abs().max().item() for g in tree_leaves(want[2])) > 1e-3


def test_step_builders_match_the_model_functions():
    """launch.steps: the LoRA step equals CentralizedLoRA.step, the full
    fine-tune step takes the same loss and moves the base, and the prefill
    and decode steps are model.prefill and model.decode_step."""
    import torch
    from repro_torch import models as TM
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core.sfl import CentralizedLoRA
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    cfg = get_arch("gpt2-s").reduced(num_layers=2, d_model=64)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks, "labels": toks}
    rt, opt = TM.Runtime(), adamw(1e-3)
    lo, _, m = steps.make_train_step(cfg, rt, opt)(params, lora, opt.init(lora), batch)
    cen = CentralizedLoRA(cfg, params, TrainConfig(), opt, rt=rt, device="cpu")
    lo2, _, m2 = cen.step(lora, opt.init(lora), batch)
    assert torch.equal(m["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(lo), tree_leaves(lo2)))
    p2, _, mf = steps.make_full_finetune_step(cfg, rt, opt)(params, opt.init(params), batch)
    assert torch.equal(mf["loss"], m["loss"])
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(p2), tree_leaves(params))]
    assert any(moved)
    logits, caches = steps.make_prefill_step(cfg, rt)(params, lora, {"tokens": toks})
    want, wcaches = TM.prefill(cfg, params, toks, lora=lora, rt=rt, cache_len=8)
    assert torch.equal(logits, want) and len(caches) == cfg.num_layers
    tok = toks[:, -1:]
    got = steps.make_decode_step(cfg, rt)(params, lora, tok, caches, torch.tensor(7))
    want = TM.decode_step(cfg, params, tok, wcaches, torch.tensor(7), lora=lora, rt=rt)
    assert torch.equal(got[0], want[0])


def test_torchrun_pod_cli_matches_one_process(tmp_path):
    argv = ["-m", "repro_torch.launch.train", "--reduced", "--device", "cpu", "--mode", "pod",
            "--steps", "4", "--local-steps", "2", "--batch", "2", "--seq", "16"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    two = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2"] + argv, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    one = subprocess.run([sys.executable] + argv, capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=TIMEOUT)
    try:
        out2, err2 = two.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        two.kill()
        raise
    assert one.returncode == 0, one.stderr[-2000:]
    assert two.returncode == 0, err2[-2000:]

    def losses(out):
        lines = [ln for ln in out.splitlines() if ln.startswith("round ") or " -> " in ln]
        return [ln.split("loss", 1)[1].split(";")[0] for ln in lines]
    assert len(losses(one.stdout)) == 3
    assert losses(out2) == losses(one.stdout)
