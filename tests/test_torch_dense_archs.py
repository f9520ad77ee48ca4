"""The dense RoPE family (minicpm-2b, deepseek-7b, yi-9b, mistral-large-123b)
and the config-level functions of the slice against ``repro``: every
assigned config but Mamba2 (the RoPE family, the MoE models, Jamba and
the two front ends, ``frontend``/``frontend_tokens`` included) field by
field (and their ``reduced()``), a ``KeyError`` for an unknown name,
forward, loss and LoRA gradients on the
same weights (2 layers, d 128-256; yi-9b at GQA 8 through
``reduced().replace(num_heads=8, num_kv_heads=1)``, since ``reduced()``
caps the heads at 4), GPT-2-M's loss and LoRA gradients at full width
and 2 layers, the paged engine's ids for yi-9b at GQA 8 and the
slab engine's for deepseek-7b, ``layer_workloads`` (with the MoE and
Mamba2 terms), ``num_params``/``num_active_params``/``lora_num_params`` at
full width, ``merge_adapter``, and the serve and train CLIs on the new
names.  Tolerances: 1e-5 for logits, 1e-4 for the loss and gradients."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import lora as jlora                        # noqa: E402
from repro.core import workload as jwork                    # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import ARCHS, ArchConfig           # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import lora as tlora                  # noqa: E402
from repro_torch.core import workload as twork              # noqa: E402
from repro_torch.models import model as tmodel              # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ("minicpm-2b", "deepseek-7b", "yi-9b", "mistral-large-123b", "olmoe-1b-7b",
       "llama4-scout-17b-a16e", "jamba-1.5-large-398b", "internvl2-2b", "musicgen-large")
_j_forward = jax.jit(JM.forward, static_argnums=(0,))


def _fields(cfg) -> dict:
    """The port's fields of a config, patterns as (mixer, mlp) pairs."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ArchConfig)}
    out["pattern"] = tuple((p.mixer, p.mlp) for p in cfg.pattern)
    return out


@pytest.mark.parametrize("name", NEW)
def test_config_equals_repros_field_by_field(name):
    jcfg, tcfg = j_get_arch(name), t_get_arch(name)
    assert _fields(tcfg) == _fields(jcfg)
    for kw in ({}, dict(num_layers=4, d_model=128, vocab=256, max_experts=8)):
        assert _fields(tcfg.reduced(**kw)) == _fields(jcfg.reduced(**kw))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        j_get_arch("gpt2-xl")
    with pytest.raises(KeyError, match="unknown arch 'gpt2-xl'"):
        t_get_arch("gpt2-xl")
    assert "gpt2-xl" not in ARCHS


# ---------------------------------------------------------------------------
# forward, loss and LoRA gradients
# ---------------------------------------------------------------------------

def _cfgs(name, gqa8=False, d_model=256):
    kw = dict(num_layers=2, d_model=d_model, vocab=256)
    jcfg, tcfg = j_get_arch(name).reduced(**kw), t_get_arch(name).reduced(**kw)
    if gqa8:
        jcfg = jcfg.replace(num_heads=8, num_kv_heads=1)
        tcfg = tcfg.replace(num_heads=8, num_kv_heads=1)
    return jcfg, tcfg


def _weights(tcfg, seed=0):
    """Params and a LoRA stack (q, v) with B != 0 as numpy trees in repro's
    layout, drawn by the port's init (no JAX init ops to compile)."""
    gen = torch.Generator().manual_seed(seed)
    params = interop.params_to_numpy(TM.init_params(tcfg, gen, device="cpu"),
                                     len(tcfg.pattern))
    lora = TM.init_lora_stack(tcfg, gen, device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=gen)
    return params, interop.lora_to_numpy(lora, len(tcfg.pattern))


DENSE = [("minicpm-2b", False), ("deepseek-7b", False), ("mistral-large-123b", False),
         ("yi-9b", True)]


@pytest.mark.parametrize("name,gqa8", DENSE, ids=[n if not g else n + "-gqa8" for n, g in DENSE])
def test_forward_loss_and_lora_grads_match_repro(name, gqa8):
    jcfg, tcfg = _cfgs(name, gqa8)
    if gqa8:
        assert tcfg.num_heads // tcfg.num_kv_heads == 8
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[:, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    tp = interop.params_from_numpy(params, "cpu")
    if jcfg.tie_embeddings:
        assert "unembed" not in tp["embed"]
    jl, _ = _j_forward(jcfg, params, jnp.asarray(tokens))
    tl, taux = TM.forward(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(taux) == 0.0
    (jt, _), jg = jax.jit(jax.value_and_grad(
        lambda l: JM.loss_fn(jcfg, params, l, batch, rt=JM.default_train_runtime()),
        has_aux=True))(jax.tree.map(jnp.asarray, lora))
    tl_ = tree_map(lambda v: v.requires_grad_(), interop.lora_from_numpy(lora, "cpu"))
    total, _ = TM.loss_fn(tcfg, tp, tl_, {k: torch.from_numpy(v) for k, v in batch.items()},
                          rt=TM.default_train_runtime())
    total.backward()
    np.testing.assert_allclose(total.item(), float(jt), **GRAD_TOL)
    got = interop.lora_to_numpy(tree_map(lambda v: v.grad, tl_), len(tcfg.pattern))
    fa, ta = jax.tree.flatten(got)
    fb, tb = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    assert ta == tb
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_gpt2_m_loss_and_lora_grads_match_repro():
    """The paper's second model at its full width (d 1024, 16 heads of 64,
    d_ff 4096, the tied vocabulary of 50257, 1024 learned positions), cut
    to 2 layers: the loss and the LoRA gradients within 1e-4."""
    jcfg, tcfg = (get("gpt2-m").replace(num_layers=2) for get in (j_get_arch, t_get_arch))
    assert jcfg.d_model == 1024 and jcfg.tie_embeddings and jcfg.pos_emb == "learned"
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[:, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    (jt, _), jg = jax.jit(jax.value_and_grad(
        lambda l: JM.loss_fn(jcfg, params, l, batch, rt=JM.default_train_runtime()),
        has_aux=True))(jax.tree.map(jnp.asarray, lora))
    tl_ = tree_map(lambda v: v.requires_grad_(), interop.lora_from_numpy(lora, "cpu"))
    total, _ = TM.loss_fn(tcfg, interop.params_from_numpy(params, "cpu"), tl_,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          rt=TM.default_train_runtime())
    total.backward()
    np.testing.assert_allclose(total.item(), float(jt), **GRAD_TOL)
    got = interop.lora_to_numpy(tree_map(lambda v: v.grad, tl_), len(tcfg.pattern))
    fa, ta = jax.tree.flatten(got)
    fb, tb = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    assert ta == tb
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ENG = dict(max_slots=3, max_len=48, page_size=8)


@pytest.mark.parametrize("name,gqa8,paged", [("yi-9b", True, True),
                                             ("deepseek-7b", False, False)],
                         ids=["yi-9b-gqa8-paged", "deepseek-7b-slab"])
def test_engine_ids_identical_to_repros_engine(name, gqa8, paged):
    jcfg, tcfg = _cfgs(name, gqa8, d_model=128)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(1, jcfg.vocab_size, int(rng.integers(2, 20))).tolist(), 6)
            for i in range(5)]
    jeng = JEngine(jcfg, params, lora=lora, paged=paged, **ENG)
    teng = ServingEngine(tcfg, interop.params_from_numpy(params, "cpu"),
                         lora=interop.lora_from_numpy(lora, "cpu"), paged=paged,
                         device="cpu", **ENG)
    assert teng.paged == paged
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    tr = [Request(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for a, b in zip(jr, tr):
        jeng.submit(a)
        teng.submit(b)
    jeng.run()
    teng.run()
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == b.max_new_tokens
        assert b.output == a.output, (b.uid, a.output, b.output)


# ---------------------------------------------------------------------------
# workloads, parameter counts, merge_adapter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_workloads_and_param_counts_match_repro_at_full_width(name):
    """Every ported config at full width: the allocator's per-layer tables
    (the MoE and Mamba2 FLOP terms included) and the parameter counts, from
    the config alone (repro traces its init abstractly; the port counts)."""
    jcfg, tcfg = j_get_arch(name), t_get_arch(name)
    for S in (64, 1024):
        jw, tw = jwork.layer_workloads(jcfg, S), twork.layer_workloads(tcfg, S)
        assert [dataclasses.astuple(w) for w in tw] == [dataclasses.astuple(w) for w in jw]
        assert twork.model_flops_per_token(tcfg, S) == jwork.model_flops_per_token(jcfg, S)
    assert tmodel.num_params(tcfg) == JM.num_params(jcfg)
    assert tmodel.num_active_params(tcfg) == JM.num_active_params(jcfg)
    for r in (None, 8):
        assert tmodel.lora_num_params(tcfg, r) == JM.lora_num_params(jcfg, r)


def test_param_counts_equal_the_built_trees():
    """On reduced configs the counts equal the leaves init_params and
    init_lora_stack build (dense, tied, MoE with a shared expert, Mamba2)."""
    for name in ("gpt2-s", "minicpm-2b", "olmoe-1b-7b", "llama4-scout-17b-a16e",
                 "mamba2-2.7b"):
        cfg = t_get_arch(name).reduced(num_layers=2, d_model=64, vocab=128)
        gen = torch.Generator().manual_seed(0)
        assert tmodel.num_params(cfg) == tlora.count_params(TM.init_params(cfg, gen,
                                                                           device="cpu"))
        assert tmodel.lora_num_params(cfg, 2) == tlora.count_params(
            TM.init_lora_stack(cfg, gen, rank=2, device="cpu"))


def test_merge_adapter_matches_repro():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    ad = {"a": rng.normal(size=(4, 48)).astype(np.float32),
          "b": rng.normal(size=(40, 4)).astype(np.float32)}
    want = np.asarray(jlora.merge_adapter(jnp.asarray(w), ad, 2.0))
    got = tlora.merge_adapter(torch.from_numpy(w), tree_map(torch.from_numpy, ad), 2.0)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    # the merged weight computes what the adapted projection does
    x = torch.from_numpy(rng.normal(size=(3, 48)).astype(np.float32))
    from repro_torch.models.layers import dense
    np.testing.assert_allclose((x @ got).numpy(),
                               dense(x, torch.from_numpy(w), lora=tree_map(torch.from_numpy,
                                                                           ad),
                                     lora_scale=2.0).numpy(), atol=1e-4, rtol=1e-5)
    wb = torch.from_numpy(w).bfloat16()
    assert tlora.merge_adapter(wb, tree_map(torch.from_numpy, ad), 2.0).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the CLIs on the new names
# ---------------------------------------------------------------------------

def test_serve_cli_on_yi_9b_paged_and_slab_emit_the_same_ids(capsys):
    from repro_torch.launch.serve import main
    base = ["--arch", "yi-9b", "--reduced", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--gen", "4", "--prompt-len", "10"]
    ids = []
    for flags, mode in (([], "paged(ps=16"), (["--slab"], "slab engine")):
        main(base + flags)
        out = capsys.readouterr().out
        assert mode in out
        ids.append([ln for ln in out.splitlines() if ln.startswith("sample token ids")])
    assert ids[0] == ids[1] and ids[0]


def test_train_cli_on_olmoe_reports_its_aux(capsys):
    """``launch.train --arch olmoe-1b-7b --reduced --device cpu``: one round
    of two local steps; the server's aux per step is finite and > 0 and is
    in the total."""
    from repro_torch.launch.train import build_argparser, run
    args = build_argparser().parse_args(
        ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--steps", "2",
         "--local-steps", "2", "--seq", "16", "--batch", "2", "--log-every", "1"])
    state, hist, sfl = run(args)
    out = capsys.readouterr().out
    assert "round 1/1" in out and "aux" in out
    assert len(hist.losses) == 2 and all(np.isfinite(hist.losses))
    assert sfl.cfg.pattern[0].mlp == "moe" and sfl.aux_coef == 0.01
