"""Prefill and slab decode over a ("data", "model") mesh (``sharding.tp``,
``models.stack.apply_block`` modes "prefill" and "decode"): one spawn of 4
gloo ranks runs every case of ``torch_mesh_cases.SERVE_CASES`` — a (1, 2)
mesh on each half of the world, a (1, 4) mesh on all of it — on
``repro``'s weights: a prefill of ``SERVE_B`` x ``SERVE_S`` tokens and
``SERVE_STEPS`` decode steps on fixed tokens, the fused runtime
(``dense_impl="fused"``, ``ssd_impl="kernel"``; their plain versions on
the CPU):

* the GQA RoPE model with its KV heads cut over the axis (tp 2 and 4,
  ``decode_attn_impl="flash"``: ``flash_decode`` on the rank's heads);
* KH 2 over tp 4: q/k/v gathered, the cache cut over its length, the
  ranks' partial softmaxes joined by ``lse_combine``, under
  ``decode_attn_impl="naive"`` (plain, masked by position) and "flash"
  (``flash_decode_partial`` over each piece's live prefix);
* reduced Mamba2 (the mixer gathered whole, its state kept in pieces over
  heads and channels), reduced Jamba (Mamba, attention and MoE), reduced
  olmoe (experts over the axis).

Each rank's logits, gathered over its vocabulary pieces, are held against
the port in one process within 1e-5 and against ``repro``'s ``prefill`` /
``decode_step`` (jitted, one device) within 1e-4; each rank's cache
leaves have the piece shapes ``sharding.specs.cache_spec`` gives, and so
does ``init_cache(mesh=)``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as C
from repro import models as JM
from repro.configs import get_arch as j_get_arch
from repro_torch import models as TM
from repro_torch.models import model as TMM
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import Mesh

TIMEOUT = 150
WORLD = 4
SEEDS = {"gqa_heads": 31, "gqa_len": 32, "mamba": 33, "jamba": 34, "olmoe": 35}
KEYS = sorted({c[1] for c in C.SERVE_CASES.values()})


def _inputs(key, seed):
    cfg = C.serve_config(j_get_arch, key)
    params = JM.init_params(cfg, jax.random.key(seed))
    lora = JM.init_lora_stack(cfg, jax.random.key(seed + 1))
    rng = np.random.default_rng(seed)
    # B != 0, so that the adapters move the logits
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if str(kp[-1].key) == "b" else np.asarray(v), lora)
    toks = rng.integers(0, cfg.vocab_size,
                        (C.SERVE_B, C.SERVE_S + C.SERVE_STEPS)).astype(np.int32)
    return cfg, {"params": jax.tree.map(np.asarray, params), "lora": lora, "tokens": toks}


def _repro_logits(cfg, inp):
    """repro's prefill and decode steps on one device, jitted."""
    rt = JM.Runtime()
    L = C.SERVE_L
    toks = jnp.asarray(inp["tokens"])
    pre = jax.jit(functools.partial(JM.prefill, cfg, rt=rt, cache_len=L))
    dec = jax.jit(functools.partial(JM.decode_step, cfg, rt=rt))
    logits, caches = pre(inp["params"], toks[:, :C.SERVE_S], lora=inp["lora"])
    out = [np.asarray(logits)]
    for t in range(C.SERVE_STEPS):
        i = C.SERVE_S + t
        logits, caches = dec(inp["params"], toks[:, i:i + 1], caches, jnp.int32(i),
                             lora=inp["lora"])
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    cfgs, inputs = {}, {}
    for key in KEYS:
        cfgs[key], inputs[key] = _inputs(key, SEEDS[key])
    procs, out = C.spawn("serve", WORLD, tmp, {"serve": inputs})
    repro = {k: _repro_logits(cfgs[k], inputs[k]) for k in KEYS}
    first = {}
    for case, (_, key, _) in C.SERVE_CASES.items():
        first.setdefault(key, case)
    ref = {key: C.run_serve_case(case, None, {"serve": inputs}) for key, case in first.items()}
    ranks = C.collect(procs, out, TIMEOUT)
    return {"ranks": ranks, "repro": repro, "ref": ref, "inputs": inputs}


@pytest.mark.parametrize("case", list(C.SERVE_CASES))
def test_tp_serving_matches_one_process(runs, case):
    key = C.SERVE_CASES[case][1]
    want = runs["ref"][key]["logits"]
    assert np.isfinite(want).all()
    for r in runs["ranks"]:
        got = r[case]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-5, case


@pytest.mark.parametrize("case", list(C.SERVE_CASES))
def test_tp_serving_matches_repro(runs, case):
    key = C.SERVE_CASES[case][1]
    want = runs["repro"][key]
    for r in runs["ranks"]:
        assert np.abs(r[case]["logits"] - want).max() < 1e-4, case


@pytest.mark.parametrize("case", list(C.SERVE_CASES))
def test_tp_serving_caches_are_cache_spec_pieces(runs, case):
    key = C.SERVE_CASES[case][1]
    whole = runs["ref"][key]["cache_shapes"]
    for r in runs["ranks"]:
        got = r[case]
        assert got["cache_shapes"] == got["want_shapes"] == got["init_shapes"], case
    # something is cut: the KV heads, the length, or the state
    assert got["cache_shapes"] != whole


def test_length_cut_cache_and_heads_cut_cache():
    """The two attention layouts of the cache at tp 4: KV heads over the
    axis at KH 4, the length at KH 2."""
    mesh = Mesh(("data", "model"), {"data": 1, "model": 4}, torch.device("cpu"))
    heads = TMM.abstract_cache(C.serve_config(get_arch, "gqa_heads"), 2, 16, mesh=mesh)
    length = TMM.abstract_cache(C.serve_config(get_arch, "gqa_len"), 2, 16, mesh=mesh)
    assert tuple(heads[0]["k"].shape) == (2, 16, 1, 16)
    assert tuple(heads[0]["pos"].shape) == (2, 16)
    assert tuple(length[0]["k"].shape) == (2, 4, 2, 16)
    assert tuple(length[0]["pos"].shape) == (2, 4)


def test_paged_modes_refuse_a_model_axis():
    from repro_torch.models import stack as S
    cfg = C.serve_config(get_arch, "gqa_heads")
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, torch.device("cpu"))
    rt = TM.Runtime(tp_axis="model", mesh=mesh)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["layers"][0]
    with pytest.raises(NotImplementedError, match="paged"):
        S.apply_block(cfg, cfg.layer_kinds[0], p, torch.zeros(1, 4, cfg.d_model), lora=None,
                      lora_scale=1.0, rt=rt, mode="chunk", cur_index=0,
                      block_tables=torch.zeros(4, dtype=torch.int32))
