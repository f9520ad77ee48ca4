"""The modality front ends (internvl2-2b, musicgen-large) against ``repro``:
both configs stub their encoder, so the model takes a prefix of
precomputed embeddings ``frontend_emb`` (B, F, d) in front of the text.
On the same weights (2 layers, d 128, F 8; InternVL2 kept at GQA 4/2,
since ``reduced()`` caps the heads at 4; MusicGen with its learned
positions, which the text takes from F on): forward logits (1e-5), loss
and LoRA gradients (1e-4), ``prefill`` with and without ``logit_index``
and a ``decode_step`` after it (1e-5), greedy ``generate`` ids, the
prefix's effect on the text logits, ``SflLLM`` local steps and rounds
with (I, K, b, F, d) prefixes (plain, 8-bit uploads with error feedback
over F + S rows, a participation mask; SGD, 1e-4), ``eval_loss``,
``CentralizedLoRA.step``, ``Trainer.fit`` carrying the prefix through
``stack_rounds``, the serving engines' and the serve CLI's refusal, the
train CLI on text alone, and MusicGen's position table through
``interop``."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import RoundDynamics as JRD                 # noqa: E402
from repro.core import SflLLM as JSflLLM                    # noqa: E402
from repro.models.generate import SampleConfig as JSampleConfig  # noqa: E402
from repro.models.generate import generate as j_generate    # noqa: E402
from repro.optim import sgd as j_sgd                        # noqa: E402
from repro.precision import PrecisionConfig as JPC          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import RoundDynamics as TRD           # noqa: E402
from repro_torch.core import SflLLM                         # noqa: E402
from repro_torch.core.sfl import CentralizedLoRA            # noqa: E402
from repro_torch.models.generate import SampleConfig        # noqa: E402
from repro_torch.optim import sgd as t_sgd                  # noqa: E402
from repro_torch.precision import PrecisionConfig as TPC    # noqa: E402
from repro_torch.serving import ServingEngine               # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("internvl2-2b", "musicgen-large")
K, B, S, I, ELL, LR = 3, 2, 12, 2, 1, 0.1
_j_forward = jax.jit(JM.forward, static_argnums=(0,))
_j_prefill = jax.jit(JM.prefill, static_argnums=(0,), static_argnames=("cache_len", "rt"))


def _np(tree):
    return jax.tree.map(np.array, tree)           # writable copies


def _cfgs(name, layers=2):
    kw = dict(num_layers=layers, d_model=128, vocab=256)
    jcfg, tcfg = j_get_arch(name).reduced(**kw), t_get_arch(name).reduced(**kw)
    if name == "internvl2-2b":
        jcfg, tcfg = jcfg.replace(num_kv_heads=2), tcfg.replace(num_kv_heads=2)
    assert jcfg.frontend_tokens == tcfg.frontend_tokens == 8
    return jcfg, tcfg


def _weights(tcfg, seed=0):
    """Params and a LoRA stack (q, v) with B != 0 as numpy trees in repro's
    layout, drawn by the port's init."""
    gen = torch.Generator().manual_seed(seed)
    params = interop.params_to_numpy(TM.init_params(tcfg, gen, device="cpu"),
                                     len(tcfg.pattern))
    lora = TM.init_lora_stack(tcfg, gen, device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=gen)
    return params, interop.lora_to_numpy(lora, len(tcfg.pattern))


def _prefix(rng, cfg, *lead):
    """0.1 N(0, 1) embeddings (..., F, d), as tests/test_smoke_archs.py
    draws them."""
    return (0.1 * rng.normal(size=lead + (cfg.frontend_tokens, cfg.d_model))
            ).astype(np.float32)


def _tokens(rng, cfg, *shape, ignore_tail=3):
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -ignore_tail:] = -1                         # IGNORE_ID tail
    return tokens, labels


def _port(tcfg, params, lora):
    return interop.params_from_numpy(params, "cpu"), interop.lora_from_numpy(lora, "cpu")


def _assert_tree_close(a, b, **tol):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                   **tol)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_with_prefix_matches_repro(name):
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(1)
    tokens, _ = _tokens(rng, jcfg, 2, S)
    fe = _prefix(rng, jcfg, 2)
    jl, _ = _j_forward(jcfg, params, jnp.asarray(tokens), lora=lora,
                       frontend_emb=jnp.asarray(fe))
    tp, tl = _port(tcfg, params, lora)
    got, aux = TM.forward(tcfg, tp, torch.from_numpy(tokens), lora=tl,
                          frontend_emb=torch.from_numpy(fe))
    assert tuple(got.shape) == (2, 8 + S, jcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
    # the text takes positions F..F+S-1: without the prefix the same tokens
    # embed at 0..S-1, which moves MusicGen's learned-position logits
    plain, _ = TM.forward(tcfg, tp, torch.from_numpy(tokens), lora=tl)
    assert tuple(plain.shape) == (2, S, jcfg.vocab_size)
    assert float((plain - got[:, 8:]).abs().max()) > 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_lora_grads_with_prefix_match_repro(name):
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(2)
    tokens, labels = _tokens(rng, jcfg, 2, S)
    batch = {"tokens": tokens, "labels": labels, "frontend_emb": _prefix(rng, jcfg, 2)}
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda l: JM.loss_fn(jcfg, params, l, batch, rt=JM.default_train_runtime()),
        has_aux=True))(jax.tree.map(jnp.asarray, lora))
    tp, tl = _port(tcfg, params, lora)
    tl = tree_map(lambda v: v.requires_grad_(), tl)
    total, m = TM.loss_fn(tcfg, tp, tl, {k: torch.from_numpy(v) for k, v in batch.items()},
                          rt=TM.default_train_runtime())
    total.backward()
    np.testing.assert_allclose(total.item(), float(jt), **MODEL_TOL)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **MODEL_TOL)
    got = interop.lora_to_numpy(tree_map(lambda v: v.grad, tl), len(tcfg.pattern))
    _assert_tree_close(got, jax.tree.map(np.asarray, jg), **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("logit_index", [None, 5], ids=["last", "index5"])
def test_prefill_and_decode_step_with_prefix_match_repro(name, logit_index):
    """prefill reads text row ``logit_index`` (the prefix offset added
    inside), its caches hold F + S positions, and one decode step at
    absolute position F + S follows."""
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(3)
    tokens, _ = _tokens(rng, jcfg, 2, 10)
    fe = _prefix(rng, jcfg, 2)
    cache_len = 8 + 10 + 4
    jl, jc = _j_prefill(jcfg, params, jnp.asarray(tokens), lora=lora,
                        rt=JM.Runtime(attn_impl="naive"), frontend_emb=jnp.asarray(fe),
                        cache_len=cache_len, logit_index=logit_index)
    tp, tl = _port(tcfg, params, lora)
    got, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens), lora=tl,
                         frontend_emb=torch.from_numpy(fe), cache_len=cache_len,
                         logit_index=logit_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(interop.slab_cache_to_numpy(tc, len(jcfg.pattern)))):
        np.testing.assert_allclose(b, a, **LOGIT_TOL)
    last = tokens[:, -1:]
    jd, _ = JM.decode_step(jcfg, params, jnp.asarray(last), jc, jnp.int32(18), lora=lora,
                           rt=JM.Runtime(attn_impl="naive"))
    td, _ = TM.decode_step(tcfg, tp, torch.from_numpy(last), tc, 18, lora=tl)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_generate_with_prefix_greedy_ids_identical_to_repro(name):
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(4)
    tokens, _ = _tokens(rng, jcfg, 2, 7)
    fe = _prefix(rng, jcfg, 2)
    jo, jd = j_generate(jcfg, params, jnp.asarray(tokens), lora=lora,
                        rt=JM.default_serve_runtime(), max_new_tokens=6,
                        sc=JSampleConfig(greedy=True), frontend_emb=jnp.asarray(fe))
    tp, tl = _port(tcfg, params, lora)
    to, td = TM.generate(tcfg, tp, torch.from_numpy(tokens), lora=tl,
                         rt=TM.default_serve_runtime(), max_new_tokens=6,
                         sc=SampleConfig(greedy=True), frontend_emb=torch.from_numpy(fe))
    assert tuple(to.shape) == (2, 6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("name", NAMES)
def test_frontend_prefix_changes_text_logits(name):
    """The twin of tests/test_models.py::test_frontend_prefix_changes_text_logits
    (zeros against ones).  Under MusicGen's LayerNorm a constant row and a
    zero row normalise alike, so there the ones leave the text logits as
    they are, and a random prefix moves them."""
    cfg = t_get_arch(name).reduced()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
    fe1 = torch.zeros(1, cfg.frontend_tokens, cfg.d_model)
    l1, _ = TM.forward(cfg, params, tokens, frontend_emb=fe1)
    l2, _ = TM.forward(cfg, params, tokens, frontend_emb=torch.ones_like(fe1))
    assert l1.shape[1] == 8 + cfg.frontend_tokens
    moved = float((l1[:, -1] - l2[:, -1]).abs().max())
    if cfg.norm == "layernorm":
        assert moved < 1e-5
        l2, _ = TM.forward(cfg, params, tokens,
                           frontend_emb=0.1 * torch.randn(fe1.shape, generator=gen))
        moved = float((l1[:, -1] - l2[:, -1]).abs().max())
    assert moved > 1e-4


def test_musicgen_position_table_counts_and_crosses_interop():
    """MusicGen's learned table (max_seq_len, d): 524288 x 2048 = 1.07 B
    of its parameters at full width; reduced, it crosses interop both ways
    unchanged."""
    full = t_get_arch("musicgen-large")
    assert TM.num_params(full) - TM.num_params(full.replace(pos_emb="rope")) == 524288 * 2048
    assert TM.num_params(full) == JM.num_params(j_get_arch("musicgen-large"))
    _, tcfg = _cfgs("musicgen-large")
    params, _ = _weights(tcfg)
    assert params["embed"]["pos"].shape == (tcfg.max_seq_len, tcfg.d_model)
    tp = interop.params_from_numpy(params, "cpu")
    assert tuple(tp["embed"]["pos"].shape) == (256, 128)
    back = interop.params_to_numpy(tp, len(tcfg.pattern))
    np.testing.assert_array_equal(back["embed"]["pos"], params["embed"]["pos"])


# ---------------------------------------------------------------------------
# SflLLM with per-client prefixes
# ---------------------------------------------------------------------------

# (arch, case): plain rounds, 8-bit uploads with error feedback, a client
# dropped by the participation mask
CASES = [("internvl2-2b", "plain"), ("musicgen-large", "plain"),
         ("musicgen-large", "ef8"), ("internvl2-2b", "part")]


def _sfl_batches(cfg, seed, steps=I):
    rng = np.random.default_rng(seed)
    tokens, labels = _tokens(rng, cfg, steps, K, B, S)
    return {"tokens": tokens, "labels": labels, "frontend_emb": _prefix(rng, cfg, steps, K, B)}


def _state_np(state):
    return {f: _np(getattr(state, f)) for f in
            ("lora_client", "lora_server", "step", "err_act", "err_grad")}


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def sfl_run(request):
    """One local step and one round on both packages from the same start."""
    name, case = request.param
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    jrt, trt = JM.default_train_runtime(), TM.default_train_runtime()
    if case == "ef8":
        jrt = jrt.replace(precision=JPC(act_bits=8, error_feedback=True))
        trt = trt.replace(precision=TPC(act_bits=8, error_feedback=True))
    tc = dict(num_clients=K, batch_size=B, local_steps=I)
    jsfl = JSflLLM(jcfg, params, ell_c=ELL, train_cfg=JTrainConfig(**tc),
                   optimizer=j_sgd(LR), rt=jrt, donate=False)
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), ELL, TTrainConfig(**tc),
                  t_sgd(LR), trt, device="cpu")
    rb = _sfl_batches(jcfg, 5)
    step = {k: v[0] for k, v in rb.items()}
    part = np.array([1.0, 0.0, 1.0], np.float32) if case == "part" else None
    counts = [1.0, 2.0, 3.0]
    j0 = jsfl.init_state(lora)
    t0 = tsfl.init_state(interop.lora_from_numpy(lora, "cpu"))
    js, jsm = jsfl.local_step(j0, jax.tree.map(jnp.asarray, step))
    ts, tsm = tsfl.local_step(t0, step)
    jr, jrm = jsfl.train_round(j0, rb, counts,
                               dynamics=None if part is None else JRD(participation=part))
    tr, trm = tsfl.train_round(t0, rb, counts,
                               dynamics=None if part is None else TRD(participation=part))
    ev = {k: v[1, 0] for k, v in rb.items()}
    return dict(case=case, jcfg=jcfg, tcfg=tcfg, jsfl=jsfl, tsfl=tsfl, lora=lora,
                counts=counts, P=len(tcfg.pattern),
                step=(_state_np(js), float(jsm["loss"]), ts, float(tsm["loss"])),
                round=(_state_np(jr), np.asarray(jrm["loss"]), tr, trm),
                eval=(float(jsfl.eval_loss(jr, jax.tree.map(jnp.asarray, ev))),
                      float(tsfl.eval_loss(tr, ev))))


def _adapters_close(tstate, jstate, P):
    got = interop.sfl_state_to_numpy(tstate, P)
    for side in ("lora_client", "lora_server"):
        _assert_tree_close(got[side], jstate[side], **MODEL_TOL)


def test_sfl_local_step_with_prefix_matches_repro(sfl_run):
    jst, jloss, tst, tloss = sfl_run["step"]
    np.testing.assert_allclose(tloss, jloss, **MODEL_TOL)
    _adapters_close(tst, jst, sfl_run["P"])


def test_sfl_round_with_prefix_matches_repro(sfl_run):
    jst, jloss, tst, tm = sfl_run["round"]
    assert tm["loss"].shape == (I,) and not bool(tm["rolled_back"])
    np.testing.assert_allclose(tm["loss"].numpy(), jloss, **MODEL_TOL)
    _adapters_close(tst, jst, sfl_run["P"])
    if sfl_run["case"] == "part":
        assert tm["participation"].tolist() == [1.0, 0.0, 1.0]
        # the dropped client keeps its starting adapter bit for bit
        got = interop.sfl_state_to_numpy(tst, sfl_run["P"])["lora_client"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(
                sfl_run["jsfl"].init_state(sfl_run["lora"]).lora_client))):
            np.testing.assert_array_equal(a[1], b[1])


def test_sfl_error_feedback_accumulators_cover_the_prefix(sfl_run):
    """With 8-bit uploads and error feedback the accumulator has the
    uploads' shape (K, b, F + S, d) on both sides; it holds x - Q(x) of
    activations whose entries reach a few units, so it is held at 1e-4."""
    for jst, tst in ((sfl_run["step"][0], sfl_run["step"][2]),
                     (sfl_run["round"][0], sfl_run["round"][2])):
        if sfl_run["case"] != "ef8":
            assert tst.err_act is None and jst["err_act"] is None
            continue
        shape = (K, B, 8 + S, sfl_run["tcfg"].d_model)
        assert tuple(tst.err_act.shape) == jst["err_act"].shape == shape
        assert tst.err_grad is None
        np.testing.assert_allclose(tst.err_act.numpy(), jst["err_act"], atol=1e-4, rtol=1e-4)
        assert float(tst.err_act.abs().max()) > 0


def test_sfl_eval_loss_with_prefix_matches_repro(sfl_run):
    jev, tev = sfl_run["eval"]
    np.testing.assert_allclose(tev, jev, **MODEL_TOL)


def test_trainer_fit_carries_the_prefix_through_stack_rounds(sfl_run):
    """Trainer.fit over SflRound, two rounds from an iterator of per-step
    batches that hold frontend_emb (K, b, F, d): stack_rounds stacks it to
    (I, K, b, F, d) and the losses are repro's."""
    from repro.launch.engine import SflRound as JSflRound
    from repro.launch.engine import Trainer as JTrainer
    from repro_torch.data.pipeline import stack_rounds
    from repro_torch.launch.engine import SflRound, Trainer
    jsfl, tsfl, lora = sfl_run["jsfl"], sfl_run["tsfl"], sfl_run["lora"]
    raw = _sfl_batches(sfl_run["jcfg"], 6, steps=2 * I)
    steps = [{k: v[i] for k, v in raw.items()} for i in range(2 * I)]
    stacked = stack_rounds(iter(steps), I)
    assert stacked["frontend_emb"].shape == (I, K, B, 8, sfl_run["tcfg"].d_model)
    _, jh = JTrainer(JSflRound(jsfl, sfl_run["counts"]), local_steps=I).fit(
        jsfl.init_state(lora), iter(steps), global_rounds=2)
    _, th = Trainer(SflRound(tsfl, sfl_run["counts"]), local_steps=I).fit(
        tsfl.init_state(interop.lora_from_numpy(lora, "cpu")), iter(steps), global_rounds=2)
    assert len(th.losses) == 2 * I and th.rolled_back_rounds == []
    np.testing.assert_allclose(th.losses, jh.losses, **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_centralized_step_with_prefix_matches_repro(name):
    from repro.core.sfl import CentralizedLoRA as JCentralizedLoRA
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(7)
    tokens, labels = _tokens(rng, jcfg, K * B, S)
    batch = {"tokens": tokens, "labels": labels, "frontend_emb": _prefix(rng, jcfg, K * B)}
    tc = dict(num_clients=1, batch_size=K * B, local_steps=1)
    jcen = JCentralizedLoRA(jcfg, params, JTrainConfig(**tc), j_sgd(LR), donate=False)
    tcen = CentralizedLoRA(tcfg, interop.params_from_numpy(params, "cpu"),
                           TTrainConfig(**tc), t_sgd(LR), device="cpu")
    jl, jo = jcen.init_state(jax.tree.map(jnp.asarray, lora))
    jl, _, jm = jcen.step(jl, jo, jax.tree.map(jnp.asarray, batch))
    tl, to = tcen.init_state(interop.lora_from_numpy(lora, "cpu"))
    tl, _, tm = tcen.step(tl, to, batch)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **MODEL_TOL)
    _assert_tree_close(interop.lora_to_numpy(tl, len(tcfg.pattern)), _np(jl), **MODEL_TOL)


# ---------------------------------------------------------------------------
# serving refusals and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_serving_engines_refuse_frontend_archs_like_repro(name):
    from repro.serving import ServingEngine as JEngine
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    tp, tl = _port(tcfg, params, lora)
    msg = "ServingEngine serves text-only requests"
    with pytest.raises(NotImplementedError, match=msg):
        JEngine(jcfg, params, lora=lora)
    for paged in (None, True, False):
        # the first check: ahead of paged=True's page_size rule (48 % 7)
        with pytest.raises(NotImplementedError, match=msg):
            ServingEngine(tcfg, tp, lora=tl, paged=paged, max_len=48, page_size=7,
                          device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_refuses_frontend_archs_like_repro(name, monkeypatch):
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main
    argv = ["--arch", name, "--reduced", "--requests", "2", "--slots", "2", "--gen", "2"]
    with pytest.raises(NotImplementedError, match="text-only"):
        main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(NotImplementedError, match="text-only"):
        j_main()


def test_train_cli_on_internvl2_trains_text_only_like_repro():
    """``launch.train --arch internvl2-2b --reduced`` feeds no prefix, as
    repro.launch.train does: on repro's initial weights its losses are
    repro's SflLLM through repro's Trainer on the same batches."""
    from repro.configs import DEFAULT_SYSTEM
    from repro.core import Problem, bcd_minimize_delay, sample_clients
    from repro.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro.launch.engine import SflRound as JSflRound
    from repro.launch.engine import Trainer as JTrainer
    from repro_torch.launch.train import build_argparser, run

    args = build_argparser().parse_args(
        ["--arch", "internvl2-2b", "--reduced", "--device", "cpu", "--steps", "4",
         "--local-steps", "2", "--seq", "32", "--batch", "2", "--seed", "0",
         "--log-every", "0"])
    cfg = j_get_arch(args.arch).reduced(num_layers=4).replace(lora_rank=args.rank)
    train, _, _ = e2e_splits(4000, 400, 400, seed=args.seed)
    tok = WordTokenizer.from_corpus([e.text for e in train])
    if tok.vocab_size > cfg.vocab_size:
        cfg = cfg.replace(vocab_size=tok.vocab_size)
    parts = [np.array(train, dtype=object)[idx]
             for idx in iid_partition(len(train), args.clients, args.seed)]
    params = JM.init_params(cfg, jax.random.key(args.seed))
    lora = JM.init_lora_stack(cfg, jax.random.key(args.seed + 1), args.rank)
    envs = tuple(sample_clients(DEFAULT_SYSTEM, args.seed))
    prob = Problem(cfg=cfg, sys_cfg=DEFAULT_SYSTEM, envs=envs, seq_len=args.seq,
                   batch=args.batch, local_steps=args.local_steps,
                   rank_candidates=(args.rank,))
    alloc, _ = bcd_minimize_delay(prob, rank0=args.rank)
    from repro.optim import adamw as j_adamw
    jsfl = JSflLLM(cfg, params, ell_c=alloc.ell_c,
                   train_cfg=JTrainConfig(num_clients=args.clients, batch_size=args.batch,
                                          local_steps=args.local_steps,
                                          learning_rate=args.lr),
                   optimizer=j_adamw(args.lr))
    _, jhist = JTrainer(JSflRound(jsfl, [len(p) for p in parts]),
                        local_steps=args.local_steps).fit(
        jsfl.init_state(lora), sfl_batches(tok, parts, args.batch, args.seq, args.seed),
        global_rounds=2)
    _, thist, tsfl = run(args, params=interop.params_from_numpy(_np(params), "cpu"),
                         lora=interop.lora_from_numpy(_np(lora), "cpu"))
    assert tsfl.cfg.frontend == "vision" and tsfl.ell_c == alloc.ell_c
    assert len(thist.losses) == 4 and thist.rolled_back_rounds == []
    np.testing.assert_allclose(thist.losses, jhist.losses, **MODEL_TOL)
