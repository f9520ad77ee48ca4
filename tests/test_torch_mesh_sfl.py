"""Client-axis SFL rounds over ranks (``SflLLM(mesh=)``): K 4 clients over
a 2-rank gloo group, one spawn for every case (``torch_mesh_cases``).

* GPT-2-S reduced to 4 layers, b 2, S 16, I 2, on ``repro``'s weights:
  the sharded round against ``repro``'s single-device ``train_round``
  within 1e-4 (loss and adapters; ``tests/test_engine.py``'s bar for
  ``repro``'s own client mesh).
* Against the port's own one-process round within 1e-5: that case, a
  mixed fleet (splits 1/2/3/2, ranks 2/4/8/4, upload bits 4/8/16/8,
  8-bit downloads, stochastic rounding, error feedback, two rounds), a
  dropped client, trimmed-mean aggregation (equal weights under AdamW,
  and the sample-count weights under SGD), reduced olmoe (the server's
  MoE aux over the pooled rows of both ranks) and an InternVL2 prefix.
  Losses, aux, totals, the gathered state (adapters, moments,
  error-feedback accumulators) and anomaly scores.
* Each rank holds K/2 clients, and the ranks' gathered states are equal
  bit for bit (the replicated server adapter steps identically).
"""
import jax
import numpy as np
import pytest

import torch_mesh_cases as C
from repro import models as JM
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as j_get_arch
from repro.core.sfl import SflLLM as JSflLLM
from repro.optim import adamw as j_adamw
from repro_torch.interop import split_layers

TIMEOUT = 150
PORT_CASES = C.SFL_CASES


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in t for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [] if t is None else [np.asarray(t)]


def _maxerr(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return max([float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(la, lb)] or [0.0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_sfl")
    cfg = j_get_arch("gpt2-s").reduced(num_layers=4)
    params = JM.init_params(cfg, jax.random.key(0))
    lora = JM.init_lora_stack(cfg, jax.random.key(7))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (C.I, C.K, C.B, C.S)).astype(np.int32)
    inputs = {"params": jax.tree.map(np.asarray, params),
              "lora": jax.tree.map(np.asarray, lora), "tokens": tokens}
    procs, out = C.spawn("sfl", 2, tmp, inputs)
    # meanwhile: repro's single-device round and the port's one-process ones
    tc = JTrainConfig(num_clients=C.K, batch_size=C.B, local_steps=C.I)
    jsfl = JSflLLM(cfg, params, ell_c=2, train_cfg=tc, optimizer=j_adamw(3e-3))
    jst, jm = jsfl.train_round(jsfl.init_state(lora), {"tokens": tokens, "labels": tokens},
                               C.COUNTS)
    ref = {case: C.run_sfl_case(case, None, inputs) for case in PORT_CASES}
    ranks = C.collect(procs, out, TIMEOUT)
    repro = {"loss": np.asarray(jm["loss"]),
             "lora_client": split_layers(jax.tree.map(np.asarray, jst.lora_client), axis=1),
             "lora_server": split_layers(jax.tree.map(np.asarray, jst.lora_server))}
    return {"ranks": ranks, "ref": ref, "repro": repro}


def test_sharded_round_matches_repro_single_device(runs):
    got, want = runs["ranks"][0]["repro"], runs["repro"]
    assert np.abs(got["loss0"] - want["loss"]).max() < 1e-4
    assert _maxerr(got["lora_client"], want["lora_client"]) < 1e-4
    assert _maxerr(got["lora_server"], want["lora_server"]) < 1e-4


@pytest.mark.parametrize("case", PORT_CASES)
def test_sharded_round_matches_one_process(runs, case):
    got, want = runs["ranks"][0][case], runs["ref"][case]
    assert set(got) == set(want)
    for k in want:
        if k == "local_clients":
            continue
        assert _maxerr(got[k], want[k]) < 1e-5, (case, k, _maxerr(got[k], want[k]))
    if case in ("trimmed", "trimmed_weighted"):
        assert set(got["scores"]) == {"update_norm", "cos_dist"}
    if case == "olmoe":
        assert (got["aux0"] > 0).all()
    if case == "mixed":
        assert got["err_act"].shape[0] == C.K and np.abs(got["err_act"]).max() > 0


@pytest.mark.parametrize("case", PORT_CASES)
def test_each_rank_holds_half_and_ranks_agree(runs, case):
    r0, r1 = runs["ranks"][0][case], runs["ranks"][1][case]
    assert r0["local_clients"] == r1["local_clients"] == C.K // 2
    assert runs["ref"][case]["local_clients"] == C.K
    for k in r0:
        assert _maxerr(r0[k], r1[k]) == 0.0, (case, k)
