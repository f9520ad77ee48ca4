"""The port's dynamic wireless rounds against ``repro``'s on the same
weights and batches (tests/test_dynamic.py's cases): the fading and outage
functions, the deadline mask (equal to ``repro``'s traced ``_dropout_mask``
bit for bit, at T_k one f32 ulp either side of the deadline), full
participation against the static round (bit for bit), a dropped client
with error feedback on (frozen, contributing zero, its error-feedback
state updated as ``repro`` updates it), an all-dropped round (the
identity), per-round re-allocation (``allocation_dynamics`` and rounds
against ``repro``), the capacity envelope's refusals, and whole
``WirelessDynamics`` episodes through ``Trainer``: histories and cursors
against ``repro``'s, the port's resume bit-identical to its uninterrupted
run, and the port resuming from ``repro``'s episode file.

Reduced GPT-2-S (4 layers, d 256), K 3, b 2, S 16, I 2, 3 rounds, LoRA
B != 0.  Tolerances: exact where stated; adapters 1e-5 and losses 1e-4
against ``repro``; the error-feedback accumulators 1e-4 (8-bit levels of
an f32 upload); modeled delays rtol 1e-9."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import DEFAULT_SYSTEM as J_SYS           # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import Problem as JProblem                  # noqa: E402
from repro.core import RoundDynamics as JRD                 # noqa: E402
from repro.core import SflLLM as JSflLLM                    # noqa: E402
from repro.core import bcd_minimize_delay_per_client as j_bcd  # noqa: E402
from repro.core import channel as jch                       # noqa: E402
from repro.core import sample_clients as j_sample           # noqa: E402
from repro.core.latency import client_round_seconds, workload_tables  # noqa: E402
from repro.launch import engine as jeng                     # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402
from repro.precision import PrecisionConfig as JPC          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import DEFAULT_SYSTEM as T_SYS     # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import Problem as TProblem            # noqa: E402
from repro_torch.core import RoundDynamics as TRD           # noqa: E402
from repro_torch.core import SflLLM                         # noqa: E402
from repro_torch.core import bcd_minimize_delay_per_client as t_bcd  # noqa: E402
from repro_torch.core import channel as tch                 # noqa: E402
from repro_torch.core import sample_clients as t_sample     # noqa: E402
from repro_torch.core.latency import client_round_seconds_host  # noqa: E402
from repro_torch.launch import engine as teng               # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.precision import PrecisionConfig as TPC    # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

K, B, S, I = 3, 2, 16, 2
LR = 1e-3
AD_TOL = dict(atol=1e-5, rtol=0)
LOSS_TOL = dict(atol=1e-4, rtol=0)
FIELDS = ("lora_client", "lora_server", "opt_client", "opt_server")


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfgs(layers=4):
    return (j_get_arch("gpt2-s").reduced(num_layers=layers),
            t_get_arch("gpt2-s").reduced(num_layers=layers))


@pytest.fixture(scope="module")
def weights():
    """repro's params and a LoRA stack with B != 0 (numpy), the port's
    copies, and one round's batches."""
    jcfg, tcfg = _cfgs()
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(1)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.02).astype(np.float32)
        if p[-1].key == "b" else v, _np(JM.init_lora_stack(jcfg, jax.random.key(7))))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (I, K, B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -3:] = -1
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, lora=lora,
                tparams=interop.params_from_numpy(params, "cpu"),
                tlora=interop.lora_from_numpy(lora, "cpu"),
                rb={"tokens": tokens, "labels": labels})


def _pair(w, prec=None, **kw):
    """The same static fleet (split 2) in both packages."""
    jrt = trt = None
    if prec is not None:
        jrt = JM.default_train_runtime().replace(precision=JPC(**prec))
        trt = TM.default_train_runtime().replace(precision=TPC(**prec))
    js = JSflLLM(w["jcfg"], w["params"], 2, JTrainConfig(num_clients=K, batch_size=B,
                                                         local_steps=I),
                 j_adamw(LR), rt=jrt, donate=False, **kw)
    ts = SflLLM(w["tcfg"], w["tparams"], 2, TTrainConfig(num_clients=K, batch_size=B,
                                                         local_steps=I),
                t_adamw(LR), rt=trt, device="cpu", **kw)
    return js, ts


def _tstate_np(ts, state):
    return interop.sfl_state_to_numpy(state, len(ts.cfg.pattern))


def _close(tstate, jstate, ts, fields=("lora_client", "lora_server"), tol=AD_TOL):
    got = _tstate_np(ts, tstate)
    for f in fields:
        for a, b in zip(jax.tree.leaves(got[f]), jax.tree.leaves(_np(getattr(jstate, f)))):
            np.testing.assert_allclose(a, b, **tol, err_msg=f)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# host machinery: fading, outages, the delay twin, the deadline mask
# ---------------------------------------------------------------------------

def test_fading_and_outage_functions_match_repro():
    envs_j = tuple(j_sample(J_SYS, 0))
    envs_t = tuple(t_sample(T_SYS, 0))
    jf = jch.FadingProcess(envs_j, std_db=8.0, rho=0.5, rng=3)
    tf = tch.FadingProcess(envs_t, std_db=8.0, rho=0.5, rng=3)
    for _ in range(3):
        a, b = jf.step(), tf.step()
        assert [(e.gain_main, e.gain_fed) for e in a] == [(e.gain_main, e.gain_fed) for e in b]
    assert jf.get_state() == tf.get_state()
    p = np.array([0.0, 1e-3, 0.3, 0.999, 1.0])
    for m in (1, 4):
        assert np.array_equal(jch.expected_transmissions(p, m), tch.expected_transmissions(p, m))
        assert np.array_equal(jch.residual_outage(p, m), tch.residual_outage(p, m))
    snr = np.array([1e-3, 1.0, 10.0, 1e4])
    assert np.array_equal(jch.outage_probability(snr, 10.0), tch.outage_probability(snr, 10.0))


@pytest.mark.parametrize("b,steps", [(B, I), (4, 6)])
def test_client_round_seconds_host_equals_both_of_repros_twins(weights, b, steps):
    """The port's twin is repro's traced twin as jit compiles it on the
    CPU, bit for bit, and lies within two ulps of repro's host twin, which
    rounds two multiply-adds twice where the compiled one contracts them
    into FMAs, an ulp each (the two differ for a few percent of these
    draws)."""
    from repro.core.latency import client_round_seconds_host as j_host
    rng = np.random.default_rng(2)
    n = 2000
    ell, rank = rng.integers(1, 4, n), rng.choice([1, 2, 3, 4, 8], n).astype(np.float32)
    f_hz = rng.uniform(2e8, 5e9, n).astype(np.float32)
    kappa = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rm, rf = (rng.uniform(1e5, 1e8, n).astype(np.float32) for _ in range(2))
    retx = rng.uniform(1.0, 4.0, (2, n)).astype(np.float32)
    bits = rng.choice([4.0, 8.0, 16.0], n).astype(np.float32)
    tables = workload_tables(weights["jcfg"], S)
    apart = 0
    for extra in ({}, dict(act_bits=bits), dict(retx_main=retx[0], retx_fed=retx[1]),
                  dict(retx_main=retx[0], retx_fed=retx[1], act_bits=bits)):
        traced = np.asarray(jax.jit(lambda *a: client_round_seconds(
            tables, *a, b, steps, **{k: jnp.asarray(v) for k, v in extra.items()}))(
                jnp.asarray(ell, jnp.int32), jnp.asarray(rank), jnp.asarray(f_hz),
                jnp.asarray(kappa), jnp.asarray(rm), jnp.asarray(rf)))
        host = j_host(tables, ell, rank, f_hz, kappa, rm, rf, b, steps, **extra)
        args = (tables, ell, rank, f_hz, kappa, rm, rf, b, steps)
        got = client_round_seconds_host(*args, **extra)
        assert got.dtype == host.dtype == np.float32
        assert np.array_equal(got, traced)
        ulps = np.abs(got.view(np.int32).astype(np.int64) - host.view(np.int32))
        assert ulps.max() <= 2
        apart += int((host != traced).sum())
    assert apart > 0


def test_deadline_mask_equals_repros_dropout_mask_at_one_ulp(weights):
    """For each client, a deadline at its T_k, one ulp below and one ulp
    above: the port's mask (its f32 twin) equals repro's traced one, alone
    and multiplied with an explicit participation, with HARQ counts and
    boundary bits in the delay."""
    js, ts = _pair(weights, ranks=(1, 2, 4), act_bits=(4, 8, 16))
    rng = np.random.default_rng(5)
    chan = dict(rates_main=rng.uniform(1e5, 1e7, K), rates_fed=rng.uniform(1e5, 1e7, K),
                f_hz=rng.uniform(2e8, 2e9, K), kappa=np.ones(K),
                retx_main=np.array([1.0, 2.5, 1.0]), retx_fed=np.array([1.0, 1.0, 3.0]))
    chan = {k: v.astype(np.float32) for k, v in chan.items()}
    jb = {"tokens": jnp.zeros((I, K, B, S), jnp.int32)}
    tb = {"tokens": torch.zeros((I, K, B, S), dtype=torch.int32)}
    tables = workload_tables(weights["jcfg"], S)
    t_k = np.asarray(client_round_seconds(
        tables, jnp.asarray(js.ell_k, jnp.int32), jnp.asarray(js.rank_k, jnp.float32),
        *(jnp.asarray(chan[k]) for k in ("f_hz", "kappa", "rates_main", "rates_fed")), B, I,
        retx_main=jnp.asarray(chan["retx_main"]), retx_fed=jnp.asarray(chan["retx_fed"]),
        act_bits=jnp.asarray([4.0, 8.0, 16.0])))
    seen = set()
    for t in t_k:
        for dl in (np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(np.inf))):
            for explicit in (None, np.array([1.0, 0.0, 1.0], np.float32)):
                jm = js._participation_for(JRD(deadline_s=jnp.float32(dl),
                                               participation=explicit,
                                               **{k: jnp.asarray(v) for k, v in chan.items()}),
                                           jb)
                tm = ts._participation_for(TRD(deadline_s=torch.tensor(dl),
                                               participation=None if explicit is None
                                               else torch.from_numpy(explicit),
                                               **{k: torch.from_numpy(v)
                                                  for k, v in chan.items()}), tb)
                assert np.asarray(jm).tolist() == tm.tolist(), (dl, explicit)
                seen.add(tuple(tm.tolist()))
    assert len(seen) >= 4          # the ulp steps really flip clients


# ---------------------------------------------------------------------------
# masked rounds
# ---------------------------------------------------------------------------

def test_full_participation_bitwise_matches_static(weights):
    """All-ones participation, and a deadline that never bites, give the
    static round bit for bit over three rounds."""
    _, ts = _pair(weights)
    ones = TRD(participation=torch.ones(K))
    loose = TRD(deadline_s=torch.tensor(1e9), rates_main=torch.full((K,), 1e6),
                rates_fed=torch.full((K,), 1e6), f_hz=torch.full((K,), 1e9),
                kappa=torch.ones(K))
    runs = []
    for dyn in (None, ones, loose):
        st = ts.init_state(weights["tlora"])
        losses = []
        for _ in range(3):
            st, m = ts.train_round(st, weights["rb"], [1.0] * K, dynamics=dyn)
            losses.append(m["loss"])
            assert m["participation"].tolist() == [1.0] * K
        runs.append((torch.cat(losses), st))
    for losses, st in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        for f in FIELDS:
            assert _same(getattr(st, f), getattr(runs[0][1], f)), f


def test_dropped_client_frozen_and_contributes_zero_with_error_feedback(weights):
    """Client 1 dropped, 8-bit upload and download with error feedback: its
    adapter and moments freeze, its sample weight is irrelevant, and, as
    in repro, which quantizes every client's upload, its error-feedback
    rows move exactly as if it had taken part in the step.  Against repro
    over one local step: over two, the second step's quantizer moves some
    entries to the next level in one package and not the other (ROADMAP
    §3, the quantizer's divergence), so the two-step round is held to the
    port's own invariants only."""
    prec = dict(act_bits=8, grad_bits=8, error_feedback=True)
    js, ts = _pair(weights, prec=prec)
    part = np.array([1.0, 0.0, 1.0], np.float32)
    drop = TRD(participation=torch.from_numpy(part))
    st0 = ts.init_state(weights["tlora"])
    st1, m1 = ts.train_round(st0, weights["rb"], [1.0] * K, dynamics=drop)
    assert m1["participation"].tolist() == part.tolist()
    for f in ("lora_client", "opt_client"):
        for x, y in zip(tree_leaves(getattr(st1, f)), tree_leaves(getattr(st0, f))):
            if x.dim() > 0:
                assert torch.equal(x[1], y[1]), f
    assert not _same(st1.lora_client, st0.lora_client)
    st2, _ = ts.train_round(st0, weights["rb"], [1.0, 1e6, 1.0], dynamics=drop)
    assert _same(st1.lora_client, st2.lora_client)
    # one local step: the dropped client's upload is quantized (and its
    # residual kept) exactly as in the round where everyone takes part
    rb1 = {k: v[:1] for k, v in weights["rb"].items()}
    st_d, m_d = ts.train_round(st0, rb1, [1.0] * K, dynamics=drop)
    st_f, _ = ts.train_round(st0, rb1, [1.0] * K)
    assert st_d.err_act[1].abs().max() > 0 and torch.equal(st_d.err_act[1], st_f.err_act[1])
    jst, jm = js.train_round(js.init_state(weights["lora"]), rb1, [1.0] * K,
                             dynamics=JRD(participation=jnp.asarray(part)))
    np.testing.assert_allclose(m_d["loss"].numpy(), np.asarray(jm["loss"]), **LOSS_TOL)
    _close(st_d, jst, ts, FIELDS)
    for f in ("err_act", "err_grad"):
        np.testing.assert_allclose(getattr(st_d, f).numpy(), np.asarray(getattr(jst, f)),
                                   atol=1e-4, err_msg=f)


def test_all_dropped_round_is_identity(weights):
    _, ts = _pair(weights)
    st0 = ts.init_state(weights["tlora"])
    st1, m = ts.train_round(st0, weights["rb"], [1.0] * K,
                            dynamics=TRD(participation=torch.zeros(K)))
    assert torch.equal(m["loss"], torch.zeros(I))
    for f in FIELDS:
        for x, y in zip(tree_leaves(getattr(st1, f)), tree_leaves(getattr(st0, f))):
            if x.dim() > 0:                # the clients' step counter advances
                assert torch.equal(x, y), f
    assert int(st1.opt_server["step"]) == int(st0.opt_server["step"])


# ---------------------------------------------------------------------------
# per-round re-allocation inside the capacity envelope
# ---------------------------------------------------------------------------

def _problems(jcfg, tcfg, **kw):
    out = []
    for sys0, sample, Prob, cfg in ((J_SYS, j_sample, JProblem, jcfg),
                                    (T_SYS, t_sample, TProblem, tcfg)):
        sys_cfg = dataclasses.replace(sys0, num_clients=K, total_bandwidth_hz=50e6,
                                      f_server_hz=0.4e9, f_client_hz_range=(0.2e9, 5.0e9))
        out.append(Prob(cfg=cfg, sys_cfg=sys_cfg, envs=tuple(sample(sys_cfg, 3)), seq_len=S,
                        batch=B, local_steps=I, rank_candidates=(1, 2, 4), **kw))
    return out


def _episode(weights, **kw):
    jprob, tprob = _problems(weights["jcfg"], weights["tcfg"], **kw)
    jal, _ = j_bcd(jprob)
    tal, _ = t_bcd(tprob)
    assert np.array_equal(jal.ell_k, tal.ell_k) and np.array_equal(jal.rank_k, tal.rank_k)
    return dict(jprob=jprob, tprob=tprob, jal=jal, tal=tal)


@pytest.fixture(scope="module")
def episode(weights):
    return _episode(weights)


def _dyn_pair(w, ep, prec=None):
    jrt = trt = None
    if prec is not None:
        jrt = JM.default_train_runtime().replace(precision=JPC(**prec))
        trt = TM.default_train_runtime().replace(precision=TPC(**prec))
    js = JSflLLM.from_allocation(ep["jprob"], ep["jal"], w["params"], j_adamw(LR),
                                 dynamic=True, donate=False, rt=jrt)
    ts = SflLLM.from_allocation(ep["tprob"], ep["tal"], w["tparams"], t_adamw(LR),
                                dynamic=True, rt=trt, device="cpu")
    return js, ts


def _stack_lora(w, ts):
    """The B != 0 stack at the envelope's r_max (extra slots zero)."""
    def pad(v, name):
        r = v.shape[-2] if name == "a" else v.shape[-1]
        width = [(0, 0)] * v.ndim
        width[-2 if name == "a" else -1] = (0, ts.r_max - r)
        return np.pad(v, width)
    return jax.tree_util.tree_map_with_path(lambda p, v: pad(v, p[-1].key), w["lora"])


def test_allocation_dynamics_matches_repro_and_refuses_outside_the_envelope(weights, episode):
    js, ts = _dyn_pair(weights, episode)
    jd = js.allocation_dynamics([1, 3, 2], [4, 1, 2], bits_k=[16, 4, 8])
    td = ts.allocation_dynamics([1, 3, 2], [4, 1, 2], bits_k=[16, 4, 8])
    for k in ("ell", "rank", "rep_hi", "scales", "act_bits"):
        assert np.asarray(jd[k]).tolist() == td[k].tolist(), k
        assert np.asarray(jd[k]).dtype == td[k].numpy().dtype, k
    want = interop.split_layers(_np(jd["slot_masks"]), axis=1)
    assert all(torch.equal(a, torch.from_numpy(b)) for a, b in
               zip(tree_leaves(td["slot_masks"]), jax.tree.leaves(want)))
    with pytest.raises(ValueError, match="capacity"):
        ts.allocation_dynamics([1] * K, [ts.r_max * 2] * K)
    _, narrow = _pair(weights, ranks=(1, 1, 1))
    with pytest.raises(ValueError, match="capacity envelope"):
        narrow.allocation_dynamics([1, 2, 3], [1, 1, 1])
    with pytest.raises(ValueError, match="capacity"):
        teng.WirelessDynamics(episode["tprob"], episode["tal"], narrow, drift_threshold=0.1)
    teng.WirelessDynamics(episode["tprob"], episode["tal"], narrow, deadline_s=1.0)


def test_reallocation_rounds_match_repro(weights, episode):
    """Three rounds, each re-allocated (splits, ranks and bits drawn at
    random) with its own participation: adapters within 1e-5 of repro's
    after every round, participation identical, dead slots exactly 0."""
    js, ts = _dyn_pair(weights, episode)
    lora = _stack_lora(weights, ts)
    jst = js.init_state(lora)
    tst = ts.init_state(interop.lora_from_numpy(lora, "cpu"))
    rng = np.random.default_rng(1)
    for part in ([1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]):
        ell, rank, bits = rng.integers(1, 4, K), rng.choice([1, 2, 4], K), rng.choice([8, 16], K)
        jd = js.allocation_dynamics(ell, rank, bits_k=bits)
        td = ts.allocation_dynamics(ell, rank, bits_k=bits)
        jst, jm = js.train_round(jst, weights["rb"], [1.0] * K,
                                 dynamics=JRD(participation=jnp.asarray(part), **jd))
        tst, tm = ts.train_round(tst, weights["rb"], [1.0] * K,
                                 dynamics=TRD(participation=torch.tensor(part), **td))
        assert tm["participation"].tolist() == np.asarray(jm["participation"]).tolist()
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), **LOSS_TOL)
        _close(tst, jst, ts)
        for v, m in zip(tree_leaves(tst.lora_client), tree_leaves(td["slot_masks"])):
            assert not (v * (1 - m)).any()


# ---------------------------------------------------------------------------
# whole episodes: WirelessDynamics through Trainer
# ---------------------------------------------------------------------------

KNOBS = dict(fade_std_db=8.0, fade_rho=0.5, deadline_factor=1.0, drift_threshold=0.15,
             outage_snr_db=30.0, max_harq=4, rng=0)


def _override(wd_of):
    """Trainer callback: client 0 in certain outage for round 1 only."""
    def cb(e, state, history):
        wd_of().outage_override = np.array([1.0, 0.0, 0.0]) if e == 0 else None
    return cb


def _run(pkg, w, ep, rounds, path="", every=0, resume=False, cb_extra=None, prec=None):
    js, ts = _dyn_pair(w, ep, prec)
    if pkg == "repro":
        sfl, eng, prob, al = js, jeng, ep["jprob"], ep["jal"]
        state = sfl.init_state(_stack_lora(w, sfl))
    else:
        sfl, eng, prob, al = ts, teng, ep["tprob"], ep["tal"]
        state = sfl.init_state(interop.lora_from_numpy(_stack_lora(w, sfl), "cpu"))
    wd = eng.WirelessDynamics(prob, al, sfl, **KNOBS)
    cb = _override(lambda: wd)

    def callback(e, st, h):
        cb(e, st, h)
        if cb_extra is not None:
            cb_extra(e, st, h)
    tr = eng.Trainer(eng.SflRound(sfl, [1.0] * K), local_steps=I, dynamics=wd,
                     episode_path=path, episode_every=every, callback=callback)
    batch = {k: v[0] for k, v in w["rb"].items()}
    state, hist = tr.fit(state, iter(lambda: batch, None), global_rounds=rounds, resume=resume)
    return sfl, wd, state, hist


@pytest.fixture(scope="module")
def repro_episode(weights, episode, tmp_path_factory):
    """repro's 3-round episode, its episode file after round 2 kept aside."""
    d = tmp_path_factory.mktemp("ep")
    path, kept = str(d / "j.ckpt"), str(d / "j2.ckpt")

    def keep(e, st, h):
        if e == 1:
            shutil.copy(path, kept)
    sfl, wd, state, hist = _run("repro", weights, episode, 3, path, 1, cb_extra=keep)
    return dict(sfl=sfl, wd=wd, state=jax.device_get(state), hist=hist, file=kept)


def test_wireless_episode_matches_repro(weights, episode, repro_episode):
    """Faded, deadline-gated, outaged, re-allocating: participation and
    re-allocation rounds equal, modeled delays within rtol 1e-9, cursors
    equal, losses and adapters against repro's."""
    ref = repro_episode
    ts, twd, tst, th = _run("port", weights, episode, 3)
    jh = ref["hist"]
    assert th.participation == jh.participation
    assert th.realloc_rounds == jh.realloc_rounds and jh.realloc_rounds
    assert any(0 in p for p in jh.participation) and jh.participation[1][0] == 0
    np.testing.assert_allclose(th.modeled_delays, jh.modeled_delays, rtol=1e-9)
    np.testing.assert_allclose(th.modeled_seconds, jh.modeled_seconds, rtol=1e-9)
    assert twd.cursor() == ref["wd"].cursor()
    np.testing.assert_allclose(th.losses, jh.losses, **LOSS_TOL)
    _close(tst, ref["state"], ts)


# 8-bit upload and download with stochastic rounding and error feedback:
# the residuals ride the episode file
EF = dict(grad_bits=8, stochastic_rounding=True, error_feedback=True)


def test_port_resume_is_bit_identical_to_its_uninterrupted_run(weights, tmp_path):
    """Error feedback on, every upload 8-bit (the allocator's only bit-width
    here): the resumed trainer's fresh state has no residuals yet, and
    takes them from the episode file."""
    episode = _episode(weights, bits_candidates=(8,))
    path = str(tmp_path / "t.ckpt")
    _, _, ref, h_ref = _run("port", weights, episode, 3, str(tmp_path / "ref.ckpt"), 1,
                            prec=EF)
    _run("port", weights, episode, 2, path, 1, prec=EF)      # killed after round 2
    _, wd, got, h = _run("port", weights, episode, 3, path, 1, resume=True, prec=EF)
    assert ref.err_act is not None and ref.err_grad is not None
    assert ref.err_act.abs().max() > 0 and ref.err_grad.abs().max() > 0
    for f in FIELDS + ("step", "err_act", "err_grad"):
        assert _same(getattr(got, f), getattr(ref, f)), f
    for f in ("losses", "participation", "realloc_rounds", "modeled_delays",
              "modeled_seconds", "rolled_back_rounds"):
        assert getattr(h, f) == getattr(h_ref, f), f


def test_port_resumes_from_repros_episode_file(weights, episode, repro_episode, tmp_path):
    """repro's file after round 2 -> the port's trainer -> round 3, against
    repro's uninterrupted episode."""
    path = str(tmp_path / "x.ckpt")
    shutil.copy(repro_episode["file"], path)
    ts, wd, got, h = _run("port", weights, episode, 3, path, 1, resume=True)
    jh = repro_episode["hist"]
    assert h.participation == jh.participation and h.realloc_rounds == jh.realloc_rounds
    np.testing.assert_allclose(h.modeled_delays, jh.modeled_delays, rtol=1e-9)
    np.testing.assert_allclose(h.losses, jh.losses, **LOSS_TOL)
    assert wd.cursor() == repro_episode["wd"].cursor()
    _close(got, repro_episode["state"], ts)


def test_trainer_checkpoint_hooks(weights, tmp_path):
    """checkpoint_every=1 saves after every round, 0 once at the end; the
    payload is repro's {lora_client, lora_server} and the callback sees
    each round."""
    from repro_torch.checkpoint import restore_pytree
    _, ts = _pair(weights)
    seen = []
    for every in (1, 0):
        path = str(tmp_path / f"c{every}.ckpt")
        tr = teng.Trainer(teng.SflRound(ts, [1.0] * K), local_steps=I, checkpoint_path=path,
                          checkpoint_every=every,
                          callback=lambda e, st, h: seen.append((e, len(h.losses))))
        batch = {k: v[0] for k, v in weights["rb"].items()}
        st, _ = tr.fit(ts.init_state(weights["tlora"]), iter(lambda: batch, None),
                       global_rounds=2)
        got = restore_pytree(path, tr.algo.checkpoint_payload(st))
        want = tr.algo.checkpoint_payload(st)
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert seen == [(0, I), (1, 2 * I)] * 2
