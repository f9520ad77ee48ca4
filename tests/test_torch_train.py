"""The port's training path against ``repro`` on the same weights and
batches: training attention (forward and grads), the loss and its LoRA
grads, the optimizers, schedules and gradient clipping, FedAvg, one SFL
global round (losses, adapters, moments, rollback), ``SflLLM.train``, the
centralized baseline through ``Trainer``, the allocator and delay model,
the data pipeline, and the ``launch.train`` CLI end to end.  Tolerances: f32 1e-5 per function,
1e-4 where a whole model sits in between."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import aggregation as jagg                  # noqa: E402
from repro.core.sfl import SflLLM as JSflLLM                # noqa: E402
from repro.models import attention as jattn                 # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402
from repro.optim import sgd as j_sgd                        # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import aggregation as tagg            # noqa: E402
from repro_torch.core.lora import split_tree                # noqa: E402
from repro_torch.core.sfl import CentralizedLoRA, SflLLM    # noqa: E402
from repro_torch.models import attention as tattn          # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.optim import sgd as t_sgd                  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map          # noqa: E402

FN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
K, B, S, I, ELL = 3, 2, 16, 2, 2


def _np(tree):
    return jax.tree.map(np.array, tree)           # writable copies


def _cfgs(layers=4):
    return (j_get_arch("gpt2-s").reduced(num_layers=layers),
            t_get_arch("gpt2-s").reduced(num_layers=layers))


def _weights(seed=0):
    """JAX-initialised params and a LoRA template whose B is not zero."""
    jcfg, _ = _cfgs()
    params = _np(JM.init_params(jcfg, jax.random.key(seed)))
    lora = _np(JM.init_lora_stack(jcfg, jax.random.key(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    return params, lora


def _batches(vocab, seed=0, steps=I):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (steps, K, B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -3:] = -1                                   # IGNORE_ID tail
    return {"tokens": tokens, "labels": labels}


def _state_np(state):
    return {f: _np(getattr(state, f)) for f in
            ("lora_client", "lora_server", "opt_client", "opt_server", "step")}


def _assert_tree_close(a, b, **tol):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                   **tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("which", ["naive", "online"])
def test_attention_forward_and_grads_match_repro(which, window):
    rng = np.random.default_rng(window)
    Bq, Sq, H, KH, D = 2, 40, 4, 2, 16
    q = rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(Bq, Sq, KH, D)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, KH, D)).astype(np.float32)
    cot = rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    if which == "naive":
        jf = lambda q, k, v: jattn.naive_attention(q, k, v, pos, pos, window)
        tf = lambda q, k, v: tattn.naive_attention(q, k, v, torch.from_numpy(pos),
                                                   torch.from_numpy(pos), window)
    else:
        jf = lambda q, k, v: jattn.online_attention(q, k, v, pos, pos, window=window,
                                                    kv_chunk=16)
        tf = lambda q, k, v: tattn.online_attention(q, k, v, torch.from_numpy(pos),
                                                    torch.from_numpy(pos),
                                                    window=window, kv_chunk=16)
    jo, vjp = jax.vjp(jf, *(jnp.asarray(t) for t in (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    to = tf(*ts)
    to.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **FN_TOL)
    for name, t, jg in zip("qkv", ts, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), err_msg=name,
                                   **FN_TOL)


def test_run_attention_takes_the_naive_form_within_one_chunk():
    q = torch.randn(1, 8, 2, 4)
    pos = torch.arange(8)
    a = tattn.run_attention(q, q[..., :1, :], q[..., :1, :], pos, pos, kv_chunk=8)
    b = tattn.naive_attention(q, q[..., :1, :], q[..., :1, :], pos, pos)
    assert torch.equal(a, b)
    c = tattn.run_attention(q, q, q, pos, pos, kv_chunk=4)
    assert torch.equal(c, tattn.online_attention(q, q, q, pos, pos, kv_chunk=4))
    assert tattn.KV_CHUNK == JM.Runtime().kv_chunk         # repro's default chunk


def test_apply_stack_rep_slice_runs_the_split_halves():
    """rep_slice=(a, b) runs repeats [a, b): client half then server half
    equals the whole stack."""
    _, tcfg = _cfgs()
    params, lora = _weights()
    tp = interop.params_from_numpy(params, "cpu")
    tl = interop.lora_from_numpy(lora, "cpu")
    x = torch.randn(2, 16, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(16, dtype=torch.int32)
    kw = dict(positions=pos, lora=tl, rt=TM.default_train_runtime())
    whole, _, _ = TM.apply_stack(tcfg, tp["layers"], x, **kw)
    half, _, _ = TM.apply_stack(tcfg, tp["layers"], x, rep_slice=(0, ELL), **kw)
    both, _, _ = TM.apply_stack(tcfg, tp["layers"], half, rep_slice=(ELL, 4), **kw)
    torch.testing.assert_close(both, whole, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# loss and LoRA grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "einsum"])
def test_loss_fn_and_lora_grads_match_repro(fused):
    jcfg, tcfg = _cfgs()
    params, lora = _weights()
    batch = {k: v[0, 0] for k, v in _batches(jcfg.vocab_size).items()}
    (jl, _), jg = jax.value_and_grad(
        lambda l: JM.loss_fn(jcfg, params, l, batch, rt=JM.default_train_runtime()),
        has_aux=True)(jax.tree.map(jnp.asarray, lora))
    tl_ = tree_map(lambda v: v.requires_grad_(), interop.lora_from_numpy(lora, "cpu"))
    rt = TM.default_train_runtime() if fused else TM.Runtime()
    loss, m = TM.loss_fn(tcfg, interop.params_from_numpy(params, "cpu"), tl_,
                         {k: torch.from_numpy(v) for k, v in batch.items()}, rt=rt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    grads = tree_map(lambda v: v.grad, tl_)
    _assert_tree_close(interop.lora_to_numpy(grads, len(jcfg.pattern)), _np(jg),
                       **MODEL_TOL)


# ---------------------------------------------------------------------------
# optimizers and aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adamw_wd", "sgd", "sgd_momentum"])
def test_optimizers_match_repro_over_three_steps(opt):
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": [rng.normal(size=(4,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2,
                          params) for _ in range(3)]
    make = {"adamw": lambda m: m.adamw(1e-2), "adamw_wd": lambda m: m.adamw(1e-2, weight_decay=0.1),
            "sgd": lambda m: m.sgd(0.1), "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9)}[opt]
    import repro.optim as jo
    import repro_torch.optim as to
    jopt, topt = make(jo), make(to)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jo.apply_updates(jp, ju)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = to.apply_updates(tp, tu)
    _assert_tree_close(tree_map(lambda t: t.numpy(), tp), _np(jp), **FN_TOL)
    for key in ("m", "v", "mu"):
        if key in js:
            _assert_tree_close(tree_map(lambda t: t.numpy(), ts[key]), _np(js[key]),
                               **FN_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3


_SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "cosine": lambda m: m.cosine(3e-3, 10),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(3e-3, 3, 12),
    "wsd": lambda m: m.wsd(3e-3, 2, 4, 5),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedules_match_repro(name):
    """Each schedule at steps 0..14 (warmup, plateau, decay and past the
    end), and adamw driven by it over three steps."""
    import repro.optim as jo
    import repro_torch.optim as to
    jf, tf = _SCHEDULES[name](jo), _SCHEDULES[name](to)
    for step in range(15):
        np.testing.assert_allclose(float(tf(torch.tensor(step, dtype=torch.int32))),
                                   float(jf(jnp.int32(step))), rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jopt, topt = jo.adamw(jf), to.adamw(tf)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jo.apply_updates(jp, ju)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = to.apply_updates(tp, tu)
    _assert_tree_close(tree_map(lambda t: t.numpy(), tp), _np(jp), **FN_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_repro(max_norm):
    from repro.optim import clip_by_global_norm as j_clip
    from repro_torch.optim import clip_by_global_norm as t_clip
    rng = np.random.default_rng(6)
    g = {"a": rng.normal(size=(3, 5)).astype(np.float32),
         "b": [rng.normal(size=(4,)).astype(np.float32)]}
    jg, jn = j_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = t_clip(tree_map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **FN_TOL)
    _assert_tree_close(tree_map(lambda t: t.numpy(), tg), _np(jg), **FN_TOL)
    assert (float(tn) > max_norm) == (max_norm == 0.5)


def test_aggregation_matches_repro():
    rng = np.random.default_rng(4)
    stacked = {"a": rng.normal(size=(K, 3, 5)).astype(np.float32),
               "b": rng.normal(size=(K, 4)).astype(np.float32)}
    w = np.array([3.0, 1.0, 2.0], np.float32)
    part = np.array([1.0, 0.0, 1.0], np.float32)
    tst = tree_map(torch.from_numpy, stacked)
    pairs = [
        (tagg.fedavg_stacked(tst, w), jagg.fedavg_stacked(stacked, w)),
        (tagg.fedavg_partial(tst, w, None), jagg.fedavg_partial(stacked, w, None)),
        (tagg.fedavg_partial(tst, w, part), jagg.fedavg_partial(stacked, w, part)),
        (tagg.fedavg([tree_map(lambda v, k=k: v[k], tst) for k in range(K)], w),
         jagg.fedavg([jax.tree.map(lambda v, k=k: v[k], stacked) for k in range(K)], w)),
    ]
    for got, want in pairs:
        _assert_tree_close(tree_map(lambda t: t.numpy(), got), _np(want), **FN_TOL)
    g = tagg.fedavg_stacked(tst, w)
    bs = tagg.broadcast_stacked(g, K)
    _assert_tree_close(tree_map(lambda t: t.numpy(), bs),
                       _np(jagg.broadcast_stacked(jagg.fedavg_stacked(stacked, w), K)),
                       **FN_TOL)
    assert bool(tagg.tree_all_finite(tst)) and bool(jagg.tree_all_finite(stacked))
    # slot masks (heterogeneous fleets): each slot averaged over its owners
    masks = {"a": (rng.random((K, 3, 1)) < 0.6).astype(np.float32),
             "b": (rng.random((K, 1)) < 0.6).astype(np.float32)}
    _assert_tree_close(
        tree_map(lambda t: t.numpy(),
                 tagg.fedavg_partial(tst, w, part, tree_map(torch.from_numpy, masks))),
        _np(jagg.fedavg_partial(stacked, w, part, masks)), **FN_TOL)
    tst["b"][1, 2] = float("nan")
    assert not bool(tagg.tree_all_finite(tst))


# ---------------------------------------------------------------------------
# one SFL global round
# ---------------------------------------------------------------------------

def _round(opt_name, poison=False, counts=(3.0, 1.0, 2.0)):
    """One global round on both packages from the same state."""
    jcfg, tcfg = _cfgs()
    params, lora = _weights()
    batches = _batches(jcfg.vocab_size)
    lr = {"sgd": 0.1, "adamw": 1e-3}[opt_name]
    jopt = {"sgd": j_sgd, "adamw": j_adamw}[opt_name](lr)
    topt = {"sgd": t_sgd, "adamw": t_adamw}[opt_name](lr)
    jtc = JTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    ttc = TTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    jsfl = JSflLLM(jcfg, params, ell_c=ELL, train_cfg=jtc, optimizer=jopt, donate=False)
    state0 = _state_np(jsfl.init_state(lora))
    if poison:
        state0["lora_client"][0]["mixer"]["q"]["a"][1, 0, 0, 0] = np.nan
    jst, jm = jsfl.train_round(jsfl.init_state(lora) if not poison else
                               jax.tree.map(jnp.asarray, _as_jax_state(jsfl, state0)),
                               batches, list(counts))
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), ELL, ttc, topt,
                  device="cpu")
    tst0 = interop.sfl_state_from_numpy(state0, "cpu")
    tst, tm = tsfl.train_round(tst0, batches, list(counts))
    return (tcfg, lr, _state_np(jst), {k: np.asarray(v) for k, v in jm.items()},
            tst0, tst, tm)


def _as_jax_state(jsfl, state_np):
    from repro.core.sfl import SflState as JSflState
    return JSflState(**{k: jax.tree.map(jnp.asarray, v) for k, v in state_np.items()})


def test_sfl_round_matches_repro_sgd():
    tcfg, lr, jst, jm, _, tst, tm = _round("sgd")
    np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], **FN_TOL)
    assert tm["loss"].shape == (I,) and not bool(tm["rolled_back"])
    got = interop.sfl_state_to_numpy(tst, len(tcfg.pattern))
    _assert_tree_close(got["lora_client"], jst["lora_client"], **FN_TOL)
    _assert_tree_close(got["lora_server"], jst["lora_server"], **FN_TOL)
    assert int(got["step"]) == int(jst["step"]) == I


def test_sfl_round_matches_repro_adamw():
    tcfg, lr, jst, jm, _, tst, tm = _round("adamw")
    np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], **FN_TOL)
    got = interop.sfl_state_to_numpy(tst, len(tcfg.pattern))
    for side in ("opt_client", "opt_server"):
        for mom in ("m", "v"):
            _assert_tree_close(got[side][mom], jst[side][mom], **FN_TOL)
        assert int(got[side]["step"]) == int(jst[side]["step"]) == I
    # an Adam step on a gradient near zero is sensitive to rounding: the
    # adapters agree within a hundredth of one step's size
    for side in ("lora_client", "lora_server"):
        _assert_tree_close(got[side], jst[side], atol=lr * 1e-2, rtol=0)


def test_sfl_round_rolls_back_a_nan_like_repro():
    tcfg, _, jst, jm, tst0, tst, tm = _round("sgd", poison=True)
    assert bool(jm["rolled_back"]) and bool(tm["rolled_back"])
    assert tst is tst0                                       # state unchanged
    got = interop.sfl_state_to_numpy(tst, len(tcfg.pattern))
    for side in ("lora_client", "lora_server"):
        for a, b in zip(jax.tree.leaves(got[side]), jax.tree.leaves(jst[side])):
            np.testing.assert_array_equal(a, b)             # NaN == NaN here


def test_sfl_equals_centralized_sgd():
    """The port of test_sfl.py::test_sfl_equals_centralized_sgd, on the
    port alone: the server adapter equals centralized SGD's, the averaged
    client adapter equals init + centralized update / K."""
    _, tcfg = _cfgs()
    params, lora = _weights()
    tp = interop.params_from_numpy(params, "cpu")
    tl = interop.lora_from_numpy(lora, "cpu")
    eta = 0.1
    batch = {k: v[0] for k, v in _batches(tcfg.vocab_size).items()}
    tc = TTrainConfig(num_clients=K, batch_size=B, local_steps=1)
    sfl = SflLLM(tcfg, tp, ell_c=ELL, train_cfg=tc, optimizer=t_sgd(eta), device="cpu")
    st, m = sfl.local_step(sfl.init_state(tl), batch)
    st = sfl.aggregate(st, [1.0] * K)
    cen = CentralizedLoRA(tcfg, tp, tc, t_sgd(eta), device="cpu")
    l0, opt = cen.init_state(tl)
    pooled = {k: v.reshape(K * B, S) for k, v in batch.items()}
    l1, opt, m2 = cen.step(l0, opt, pooled)
    assert abs(float(m["loss"]) - float(m2["loss"])) < 1e-5
    cli_c, srv_c = split_tree(l1, ELL)
    for a, b in zip(tree_leaves(srv_c), tree_leaves(st.lora_server)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    cli_i, _ = split_tree(tl, ELL)
    exp = tree_map(lambda i, c: i + (c - i) / K, cli_i, cli_c)
    got = tree_map(lambda v: v[0], st.lora_client)
    for a, b in zip(tree_leaves(exp), tree_leaves(got)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert np.isfinite(float(sfl.eval_loss(st, {k: v[0] for k, v in batch.items()})))


def test_centralized_round_through_trainer_matches_repro():
    """CentralizedLoRA under CentralizedRound and Trainer.fit, two rounds
    of I steps on pooled batches: per-step losses and the final adapter."""
    from repro.core.sfl import CentralizedLoRA as JCentralizedLoRA
    from repro.launch.engine import CentralizedRound as JCentralizedRound
    from repro.launch.engine import Trainer as JTrainer
    from repro_torch.launch.engine import CentralizedRound, Trainer
    jcfg, tcfg = _cfgs()
    params, lora = _weights()
    raw = _batches(jcfg.vocab_size, seed=7, steps=2 * I)
    pooled = [{k: v[i].reshape(K * B, S) for k, v in raw.items()} for i in range(2 * I)]
    tc = dict(num_clients=1, batch_size=K * B, local_steps=I)
    jcen = JCentralizedLoRA(jcfg, params, JTrainConfig(**tc), j_sgd(0.1), donate=False)
    tcen = CentralizedLoRA(tcfg, interop.params_from_numpy(params, "cpu"),
                           TTrainConfig(**tc), t_sgd(0.1), device="cpu")
    (jl, _), jh = JTrainer(JCentralizedRound(jcen), local_steps=I).fit(
        jcen.init_state(jax.tree.map(jnp.asarray, lora)), iter(pooled), global_rounds=2)
    (tl, _), th = Trainer(CentralizedRound(tcen), local_steps=I).fit(
        tcen.init_state(interop.lora_from_numpy(lora, "cpu")), iter(pooled),
        global_rounds=2)
    assert len(th.losses) == 2 * I and th.rolled_back_rounds == []
    np.testing.assert_allclose(th.losses, jh.losses, **FN_TOL)
    np.testing.assert_allclose(th.round_losses, jh.round_losses, **FN_TOL)
    _assert_tree_close(interop.lora_to_numpy(tl, len(jcfg.pattern)), _np(jl), **FN_TOL)


def test_sfl_train_matches_repro(capsys):
    """SflLLM.train over two global rounds: the loss history, the log lines
    of log_every and the callback's calls are repro's."""
    jcfg, tcfg = _cfgs()
    params, lora = _weights()
    raw = _batches(jcfg.vocab_size, seed=8, steps=2 * I)
    steps = [{k: v[i] for k, v in raw.items()} for i in range(2 * I)]
    tc = dict(num_clients=K, batch_size=B, local_steps=I)
    jsfl = JSflLLM(jcfg, params, ell_c=ELL, train_cfg=JTrainConfig(**tc),
                   optimizer=j_sgd(0.1), donate=False)
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), ELL,
                  TTrainConfig(**tc), t_sgd(0.1), device="cpu")
    jcalls, tcalls = [], []
    _, jh = jsfl.train(jsfl.init_state(lora), iter(steps), global_rounds=2,
                       sample_counts=[1.0] * K, log_every=3,
                       callback=lambda s, h: jcalls.append(list(h)))
    jout = capsys.readouterr().out
    tst, th = tsfl.train(tsfl.init_state(interop.lora_from_numpy(lora, "cpu")),
                         iter(steps), global_rounds=2, sample_counts=[1.0] * K,
                         log_every=3, callback=lambda s, h: tcalls.append(list(h)))
    tout = capsys.readouterr().out
    np.testing.assert_allclose(th, jh, **FN_TOL)
    assert len(tcalls) == len(jcalls) == 2
    for a, b in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, **FN_TOL)
    assert [ln.rsplit(" ", 1)[0] for ln in tout.splitlines()] == \
        [ln.rsplit(" ", 1)[0] for ln in jout.splitlines()] != []
    assert int(tst.step) == 2 * I


def test_sfl_refuses_what_is_not_ported():
    """A mesh without a "clients" axis raises ValueError (the client axis
    is ported: tests/test_torch_mesh_sfl.py), and repro's default
    donate=True is accepted.  Everything else this test once refused is
    ported now and must be accepted: the
    deprecated act_quant shim (it warns), the fault and robust fields of
    RoundDynamics (poison, robust, byzantine) and WirelessDynamics'
    defense, as are the capacity envelope and dynamic allocation."""
    from repro_torch.configs import DEFAULT_SYSTEM
    from repro_torch.core import Problem, bcd_minimize_delay_per_client, sample_clients
    from repro_torch.core.defense import ByzantineOps, DefenseConfig
    from repro_torch.core.resource import Allocation, HeteroAllocation
    from repro_torch.core.sfl import RoundDynamics
    from repro_torch.launch.engine import WirelessDynamics
    _, tcfg = _cfgs(layers=2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TTrainConfig(num_clients=2, batch_size=1, local_steps=1)
    from repro_torch.launch.mesh import make_debug_mesh
    with pytest.raises(ValueError, match="clients"):
        SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu", mesh=make_debug_mesh(1, 1))
    assert SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu", donate=True).mesh is None
    with pytest.warns(DeprecationWarning, match="act_quant"):
        assert SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu",
                      act_quant=True).act_bits_k == (8, 8)
    dyn = RoundDynamics(poison=torch.zeros(()), robust=tagg.RobustAggConfig.make(trim=1),
                        byzantine=ByzantineOps.benign(2))
    assert dyn.robust.armed and not dyn.byzantine.armed().any()
    sfl = SflLLM(tcfg, tp, (1, 1), tc, t_sgd(0.1), device="cpu", ranks=(2, 4), act_bits=8,
                 ell_range=(1, 1), rank_max=8)
    assert sfl.r_max == 8 and sfl.hetero
    prob = argparse.Namespace(cfg=tcfg, envs=(None, None), batch=1, local_steps=1)
    alloc = Allocation(np.zeros(2, int), np.zeros(2, int), np.ones(2), np.ones(2), 1, 4)
    assert SflLLM.from_allocation(prob, alloc, tp, t_sgd(0.1), device="cpu").ell_k == (1, 1)
    hal = HeteroAllocation(np.zeros(2, int), np.zeros(2, int), np.ones(2), np.ones(2), 1, 4,
                           ell_k=np.array([1, 1]), rank_k=np.array([2, 4]))
    assert SflLLM.from_allocation(prob, hal, tp, t_sgd(0.1), device="cpu").rank_k == (2, 4)
    sys2 = dataclasses.replace(DEFAULT_SYSTEM, num_clients=2)
    real = Problem(cfg=tcfg, sys_cfg=sys2, envs=tuple(sample_clients(sys2, 0)), seq_len=8,
                   batch=1, local_steps=1, rank_candidates=(1, 2))
    ral, _ = bcd_minimize_delay_per_client(real)
    wd = WirelessDynamics(real, ral, SflLLM.from_allocation(real, ral, tp, t_sgd(0.1),
                                                            device="cpu"),
                          deadline_s=1e9, defense=DefenseConfig())
    assert wd.tracker is not None and wd.cursor()["defense"]["total_quarantines"] == 0
    dyn, info = wd.round_dynamics()
    assert info["quarantined"] == [0, 0] and dyn.robust is not None


def test_quantize_activations_matches_repro():
    """The standalone per-token int8 quantizer (repro's legacy helper):
    values equal repro's, the all-zero row stays finite, and the backward
    is the identity (straight-through)."""
    from repro.core.sfl import quantize_activations as j_quant
    from repro_torch.core.sfl import quantize_activations
    rng = np.random.default_rng(3)
    s = (rng.normal(size=(2, 5, 16)) * rng.uniform(0.1, 10, (2, 5, 1))).astype(np.float32)
    s[1, 2] = 0.0
    got = quantize_activations(torch.from_numpy(s))
    want = np.asarray(j_quant(jnp.asarray(s)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert torch.isfinite(got).all() and not got[1, 2].any()
    levels = got / (torch.from_numpy(np.abs(s)).amax(-1, keepdim=True) / 127).clamp_min(1e-8)
    assert torch.allclose(levels, levels.round(), atol=1e-3)
    x = torch.from_numpy(s).requires_grad_()
    quantize_activations(x).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_act_quant_shim_equals_act_bits_8():
    """SflLLM(act_quant=True) warns and trains exactly as act_bits=8, as
    repro's shim does; an explicit act_bits wins over it."""
    _, tcfg = _cfgs(layers=2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TTrainConfig(num_clients=2, batch_size=1, local_steps=1)
    with pytest.warns(DeprecationWarning):
        shim = SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu", act_quant=True)
    with pytest.warns(DeprecationWarning):
        assert SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu", act_quant=True,
                      act_bits=4).act_bits_k == (4, 4)
    plain = SflLLM(tcfg, tp, 1, tc, t_sgd(0.1), device="cpu", act_bits=8)
    lora = TM.init_lora_stack(tcfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (1, 2, 1, 8))
    rb = {"tokens": tokens, "labels": tokens.copy()}
    outs = [s_.train_round(s_.init_state(lora), rb, [1.0, 1.0]) for s_ in (shim, plain)]
    assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(outs[0][0].lora_server),
                                                 tree_leaves(outs[1][0].lora_server)))


def test_sfl_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    _, tcfg = _cfgs(layers=2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TTrainConfig(num_clients=2, batch_size=1, local_steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        SflLLM(tcfg, tp, 1, tc, t_sgd(0.1))


# ---------------------------------------------------------------------------
# allocator, delay model, data pipeline, the CLI
# ---------------------------------------------------------------------------

def test_allocator_and_latency_report_match_repro():
    from repro.configs import DEFAULT_SYSTEM as JSYS
    from repro.core import Problem as JProblem
    from repro.core import bcd_minimize_delay as j_bcd
    from repro.core import latency_report as j_report
    from repro.core import sample_clients as j_sample
    from repro_torch.configs import DEFAULT_SYSTEM as TSYS
    from repro_torch.core import Problem as TProblem
    from repro_torch.core import bcd_minimize_delay as t_bcd
    from repro_torch.core import latency_report as t_report
    from repro_torch.core import sample_clients as t_sample

    out = []
    for cfg, SYS, Prob, bcd, rep, sample in (
            (j_get_arch("gpt2-s"), JSYS, JProblem, j_bcd, j_report, j_sample),
            (t_get_arch("gpt2-s"), TSYS, TProblem, t_bcd, t_report, t_sample)):
        envs = tuple(sample(SYS, 0))
        prob = Prob(cfg=cfg, sys_cfg=SYS, envs=envs, seq_len=64, batch=4,
                    local_steps=6, rank_candidates=(4,))
        alloc, hist = bcd(prob, rank0=4)
        report = rep(cfg, SYS, envs, alloc.rates_main(SYS, envs),
                     alloc.rates_fed(SYS, envs), alloc.ell_c, alloc.rank, 64, 4, 6, 2)
        out.append((alloc, hist, report))
    (ja, jh, jr), (ta, th, tr) = out
    assert (ja.ell_c, ja.rank) == (ta.ell_c, ta.rank)
    np.testing.assert_allclose(th, jh, rtol=1e-12)
    fj, tree_j = jax.tree.flatten(jr)
    ft, tree_t = jax.tree.flatten(tr)
    assert tree_j == tree_t
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-12)


def test_sfl_batches_are_identical():
    from repro.data import WordTokenizer as JTok
    from repro.data import e2e_splits as j_splits
    from repro.data import iid_partition as j_part
    from repro.data import sfl_batches as j_batches
    from repro_torch.data import WordTokenizer as TTok
    from repro_torch.data import e2e_splits as t_splits
    from repro_torch.data import iid_partition as t_part
    from repro_torch.data import sfl_batches as t_batches

    its = []
    for splits, Tok, part, batches in ((j_splits, JTok, j_part, j_batches),
                                       (t_splits, TTok, t_part, t_batches)):
        train, _, _ = splits(400, 40, 40, seed=1)
        tok = Tok.from_corpus([e.text for e in train])
        parts = [np.array(train, dtype=object)[i] for i in part(len(train), 3, 1)]
        its.append(batches(tok, parts, 4, 32, 1))
    for _ in range(3):
        a, b = next(its[0]), next(its[1])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_launch_train_run_reproduces_repro_losses():
    """``repro_torch.launch.train.run`` on repro's initial weights gives
    repro.launch.train's per-step losses (the sfl path of its main())."""
    from repro.configs import DEFAULT_SYSTEM
    from repro.core import Problem, bcd_minimize_delay, sample_clients
    from repro.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro.launch.engine import SflRound, Trainer
    from repro_torch.launch.train import build_argparser, run

    args = build_argparser().parse_args(
        ["--arch", "gpt2-s", "--reduced", "--device", "cpu", "--steps", "12",
         "--local-steps", "6", "--seed", "0", "--log-every", "0"])
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
    tc = JTrainConfig(num_clients=args.clients, batch_size=args.batch,
                      local_steps=args.local_steps, learning_rate=args.lr)
    jsfl = JSflLLM(cfg, params, ell_c=alloc.ell_c, train_cfg=tc,
                   optimizer=j_adamw(args.lr))
    tparams = interop.params_from_numpy(_np(params), "cpu")
    tlora = interop.lora_from_numpy(_np(lora), "cpu")
    _, jhist = Trainer(SflRound(jsfl, [len(p) for p in parts]),
                       local_steps=args.local_steps).fit(
        jsfl.init_state(lora), sfl_batches(tok, parts, args.batch, args.seq, args.seed),
        global_rounds=2)
    _, thist, tsfl = run(args, params=tparams, lora=tlora)
    assert tsfl.ell_c == alloc.ell_c and len(thist.losses) == 12
    np.testing.assert_allclose(thist.losses, jhist.losses, atol=1e-4, rtol=1e-4)
    # repro.launch.train prints 6.285 -> 5.937 for these flags
    assert abs(thist.losses[0] - 6.285) < 5e-3 and abs(thist.losses[-1] - 5.937) < 5e-3
    assert thist.rolled_back_rounds == [] and len(thist.round_seconds) == 2


def test_cli_parses_the_documented_flags():
    from repro_torch.launch.train import build_argparser
    args = build_argparser().parse_args([])
    assert isinstance(args, argparse.Namespace)
    assert (args.device, args.mode, args.split, args.clients) == ("cuda", "sfl", 0, 3)
