"""Mamba2 and Jamba training in the port against ``repro`` on the same
weights (drawn by the port's init, handed to both as numpy trees; LoRA B
!= 0): reduced Mamba2-2.7B (4 layers at d 64: 4 SSD heads of 32, state
16, chunk 32; LoRA on ssm_in/ssm_out) and reduced jamba-1.5-large-398b
(one attention and seven mamba layers a period, MoE on the odd layers, 4
experts top-2, d 64; LoRA on q and v, so every client gradient crosses
seven mamba blocks).  ``loss_fn`` and the LoRA gradients against
``jax.grad`` under the plain and the training runtime (2e-4); one
homogeneous SFL round of each and one ``from_allocation`` round of reduced
Mamba2 against ``repro``'s ``train_round`` (1e-4); Jamba's slab engine,
fused and naive, giving ``repro``'s greedy ids, and its paged engine
refused as ``repro``'s is; the train CLI on both (the port reduces Jamba to
two periods, where ``repro``'s CLI leaves one and no split).  Sequences of
40 tokens: two chunks of 32, the second padded."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core.sfl import SflLLM as JSflLLM                # noqa: E402
from repro.core.split import valid_splits as j_valid_splits  # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core.sfl import SflLLM                     # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
ROUND_TOL = dict(atol=1e-4, rtol=1e-4)
MAMBA, JAMBA = "mamba2-2.7b", "jamba-1.5-large-398b"
# layers: Mamba2 4 (split 2), Jamba two periods of 8 (split 8)
LAYERS = {MAMBA: 4, JAMBA: 16}
SPLIT = {MAMBA: 2, JAMBA: 8}
K, B, S, I, LR = 3, 2, 40, 2, 1e-3
_j_loss_grad = jax.jit(jax.value_and_grad(
    lambda lora, cfg, params, batch: JM.loss_fn(cfg, params, lora, batch,
                                                rt=JM.default_train_runtime()),
    has_aux=True), static_argnums=(1,))


def _np(tree):
    return jax.tree.map(np.array, tree)           # writable copies


def _cfgs(name, num_layers=None):
    kw = dict(num_layers=num_layers or LAYERS[name], d_model=64, vocab=128)
    return j_get_arch(name).reduced(**kw), t_get_arch(name).reduced(**kw)


def _weights(tcfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = interop.params_to_numpy(TM.init_params(tcfg, gen, device="cpu"),
                                     len(tcfg.pattern))
    lora = TM.init_lora_stack(tcfg, gen, device="cpu")
    for layer in lora:              # Jamba's mamba layers carry no adapter
        for ad in layer.get("mixer", {}).values():
            ad["b"].normal_(0, 0.05, generator=gen)
    return params, interop.lora_to_numpy(lora, len(tcfg.pattern))


def _assert_tree_close(a, b, **tol):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                   **tol)


def _batch(vocab, shape, seed):
    tokens = np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -3:] = -1
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# loss and LoRA gradients
# ---------------------------------------------------------------------------

GRAD_CASES = [(MAMBA, "plain"), (MAMBA, "train"), (JAMBA, "plain"), (JAMBA, "train")]


@pytest.mark.parametrize("name,rt", GRAD_CASES, ids=[f"{n[:5]}-{r}" for n, r in GRAD_CASES])
def test_loss_and_lora_grads_match_jax_grad(name, rt):
    """``Runtime()`` (ssd_chunked, einsum projections) and
    ``default_train_runtime()`` (the scan's kernel route and the fused
    LoRA op: their plain versions here) against ``jax.grad`` of
    ``repro``'s loss with its training runtime.  Jamba at one period."""
    jcfg, tcfg = _cfgs(name, num_layers=8 if name == JAMBA else None)
    params, lora = _weights(tcfg)
    batch = _batch(jcfg.vocab_size, (2, S), 1)
    tp = interop.params_from_numpy(params, "cpu")
    (jt, jm), jg = _j_loss_grad(jax.tree.map(jnp.asarray, lora), jcfg, params, batch)
    tl_ = tree_map(lambda v: v.requires_grad_(), interop.lora_from_numpy(lora, "cpu"))
    total, m = TM.loss_fn(tcfg, tp, tl_, {k: torch.from_numpy(v) for k, v in batch.items()},
                          rt=TM.default_train_runtime() if rt == "train" else TM.Runtime())
    total.backward()
    np.testing.assert_allclose(total.item(), float(jt), **GRAD_TOL)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), **GRAD_TOL)
    g = interop.lora_to_numpy(tree_map(lambda v: v.grad, tl_), len(tcfg.pattern))
    _assert_tree_close(g, _np(jg), **GRAD_TOL)
    assert max(np.abs(x).max() for x in jax.tree.leaves(g)) > 1e-3     # gradients flow


# ---------------------------------------------------------------------------
# SFL rounds against repro's train_round
# ---------------------------------------------------------------------------

def _hold_round(jsfl, tsfl, lora, pattern_len):
    jst0 = jsfl.init_state(lora)
    tst0 = interop.sfl_state_from_numpy(
        {f: _np(getattr(jst0, f)) for f in ("lora_client", "lora_server", "opt_client",
                                            "opt_server", "step")}, "cpu")
    rb = _batch(jsfl.cfg.vocab_size, (I, K, B, S), 0)
    counts = [3.0, 1.0, 2.0]
    jst, jm = jsfl.train_round(jst0, rb, counts)
    tst, tm = tsfl.train_round(tst0, rb, counts)
    for k in ("loss", "total"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **ROUND_TOL)
    got = interop.sfl_state_to_numpy(tst, pattern_len)
    for f in ("lora_client", "lora_server"):
        _assert_tree_close(got[f], _np(getattr(jst, f)), **ROUND_TOL)
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(got["lora_client"]), jax.tree.leaves(_np(jst0.lora_client))))
    assert moved > 1e-4                                    # the round trained


@pytest.mark.parametrize("name", [MAMBA, JAMBA], ids=["mamba", "jamba"])
def test_sfl_round_matches_repro(name):
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    tc = dict(num_clients=K, batch_size=B, local_steps=I)
    jsfl = JSflLLM(jcfg, params, SPLIT[name], JTrainConfig(**tc), j_adamw(LR), donate=False)
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), SPLIT[name],
                  TTrainConfig(**tc), t_adamw(LR), device="cpu")
    _hold_round(jsfl, tsfl, lora, len(jcfg.pattern))


def test_from_allocation_round_of_mamba_matches_repro():
    """A from_allocation(dynamic=True) fleet of reduced Mamba2 at splits
    1/3/2 of 4 layers and ranks 4/2/4: per-client split gates and rank
    masks over mamba blocks."""
    jcfg, tcfg = _cfgs(MAMBA)
    params, lora = _weights(tcfg)
    alloc = types.SimpleNamespace(ell_k=np.array([1, 3, 2]), rank_k=np.array([4, 2, 4]),
                                  ell_c=2, rank=4)

    def prob(cfg):
        return types.SimpleNamespace(cfg=cfg, envs=(None,) * K, batch=B, local_steps=I,
                                     rank_candidates=(2, 4))

    jsfl = JSflLLM.from_allocation(prob(jcfg), alloc, params, j_adamw(LR), dynamic=True,
                                   donate=False)
    tsfl = SflLLM.from_allocation(prob(tcfg), alloc, interop.params_from_numpy(params, "cpu"),
                                  t_adamw(LR), dynamic=True, device="cpu")
    assert tsfl.ell_k == (1, 3, 2)
    _hold_round(jsfl, tsfl, lora, len(jcfg.pattern))


# ---------------------------------------------------------------------------
# Jamba serving
# ---------------------------------------------------------------------------

ENG = dict(max_slots=2, max_len=64)


def test_jamba_slab_engine_fused_and_naive_ids_identical_to_repro():
    """Three requests of two lengths (one across a chunk boundary) through
    two slots: the hybrid cache (KV for the attention layer, conv and SSM
    state for the mamba layers) of a reused slot."""
    jcfg, tcfg = _cfgs(JAMBA, num_layers=8)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(1, 128, n).tolist(), 5) for i, n in enumerate((40, 7, 40))]
    jeng = JEngine(jcfg, params, lora=lora, **ENG)
    assert not jeng.paged
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for r in jr:
        jeng.submit(r)
    jeng.run()
    for fused in (True, False):
        eng = ServingEngine(tcfg, interop.params_from_numpy(params, "cpu"),
                            lora=interop.lora_from_numpy(lora, "cpu"), device="cpu",
                            fused=fused, **ENG)
        assert not eng.paged
        rs = [Request(uid=u, prompt=list(p), max_new_tokens=g) for u, p, g in reqs]
        for r in rs:
            eng.submit(r)
        eng.run()
        for a, b in zip(jr, rs):
            assert b.done and b.output == a.output, (fused, a.uid, a.output, b.output)


def test_jamba_paged_engine_is_refused_as_repros_is():
    jcfg, tcfg = _cfgs(JAMBA, num_layers=8)
    params, lora = _weights(tcfg)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jcfg, params, lora=lora, paged=True, **ENG)
    with pytest.raises(NotImplementedError, match="attention-only") as terr:
        ServingEngine(tcfg, interop.params_from_numpy(params, "cpu"),
                      lora=interop.lora_from_numpy(lora, "cpu"), paged=True, device="cpu",
                      **ENG)
    assert "attention-only" in str(jerr.value) and "attention-only" in str(terr.value)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [MAMBA, JAMBA], ids=["mamba", "jamba"])
def test_train_cli_trains_reduced_mamba_and_jamba(name, capsys):
    """``launch.train --arch ... --reduced --device cpu``: one round of two
    local steps over 40 tokens.  ``repro``'s CLI reduces Jamba to one
    period, where no split is valid; the port's takes two (Mamba2 keeps
    4 layers)."""
    from repro_torch.launch.train import build_argparser, run
    args = build_argparser().parse_args(
        ["--arch", name, "--reduced", "--device", "cpu", "--steps", "2", "--local-steps",
         "2", "--seq", "40", "--batch", "2", "--log-every", "1"])
    state, hist, sfl = run(args)
    assert "round 1/1" in capsys.readouterr().out
    assert len(hist.losses) == 2 and all(np.isfinite(hist.losses))
    jcfg = j_get_arch(name)
    assert sfl.cfg.num_layers == (16 if name == JAMBA else 4)
    assert sfl.ell_c in j_valid_splits(jcfg.reduced(num_layers=sfl.cfg.num_layers))
    if name == JAMBA:
        assert not j_valid_splits(jcfg.reduced(num_layers=max(4, len(jcfg.pattern))))
