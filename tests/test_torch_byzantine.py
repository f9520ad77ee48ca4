"""The port's trust-boundary defense against ``repro``'s on the same inputs
(tests/test_byzantine.py's cases): the robust aggregators (norm clip,
trimmed mean with ties, the clamp to one survivor, the coordinate median,
leave-one-out anomaly scores on the clipped uploads), the disarmed
aggregator bit-equal to ``fedavg_partial``, the corruption operands
(sign, scale and replay bit-equal; the noise by its properties, since its
draws cannot follow ``jax.random``), the reputation tracker bit-equal over
a score sequence, a round with ``robust``, ``byzantine`` and ``poison``
against ``repro``'s, a defended sign-flip episode against ``repro``'s,
episode cursors with the tracker's ledger crossing between the packages
both ways, and the resume under an active quarantine bit-identical.

Reduced GPT-2-S (2 layers, d 256), K 3, b 2, S 16, I 2, the allocator's
fleet through ``from_allocation(dynamic=True)``.  Tolerances: exact where
stated; aggregates, norms and clipped uploads rtol 1e-5 (the port sums
over per-layer leaves where ``repro`` sums over its (R, ...) stacks);
``cos_dist`` (one minus a cosine) atol 1e-6; round losses and adapters
against ``repro`` 1e-5."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import DEFAULT_SYSTEM as J_SYS           # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import Problem as JProblem                  # noqa: E402
from repro.core import SflLLM as JSflLLM                    # noqa: E402
from repro.core import aggregation as jagg                  # noqa: E402
from repro.core import bcd_minimize_delay_per_client as j_bcd  # noqa: E402
from repro.core import defense as jdef                      # noqa: E402
from repro.core import sample_clients as j_sample           # noqa: E402
from repro.core.sfl import RoundDynamics as JRD             # noqa: E402
from repro.faults import TrainingFaults as JTF              # noqa: E402
from repro.launch import engine as jeng                     # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch.configs import DEFAULT_SYSTEM as T_SYS     # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import Problem as TProblem            # noqa: E402
from repro_torch.core import SflLLM                         # noqa: E402
from repro_torch.core import aggregation as tagg            # noqa: E402
from repro_torch.core import bcd_minimize_delay_per_client as t_bcd  # noqa: E402
from repro_torch.core import sample_clients as t_sample     # noqa: E402
from repro_torch.core import defense as tdef                # noqa: E402
from repro_torch.core.sfl import RoundDynamics as TRD       # noqa: E402
from repro_torch.faults import TrainingFaults               # noqa: E402
from repro_torch.launch import engine as teng               # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

K, B, S, I = 3, 2, 16, 2
LR = 1e-3
RTOL = dict(rtol=1e-5, atol=0)
COS_TOL = dict(atol=1e-6, rtol=0)
AD_TOL = dict(atol=1e-5, rtol=0)
FIELDS = ("lora_client", "lora_server", "opt_client", "opt_server")


# ---------------------------------------------------------------------------
# the aggregators on a random fleet (repro's _fleet)
# ---------------------------------------------------------------------------

def _fleet(seed=0, k=5):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)       # noqa: E731
    stacked = {"a": f32(k, 3, 4), "b": f32(k, 2)}
    ref = {"a": f32(k, 3, 4), "b": f32(k, 2)}
    w = rng.uniform(1.0, 3.0, k).astype(np.float32)
    part = rng.integers(0, 2, k).clip(max=1).astype(np.float32)
    part[0] = 1.0
    masks = {"a": rng.integers(0, 2, (k, 3, 4)).astype(np.float32),
             "b": np.ones((k, 2), np.float32)}
    return stacked, ref, w, part, masks


def _t(tree):
    return None if tree is None else (
        {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
        if isinstance(tree, dict) else torch.from_numpy(np.array(tree)))


def _j(tree):
    return None if tree is None else (
        {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict)
        else jnp.asarray(tree))


def _close(got, want, tol=RTOL, what=""):
    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol, err_msg=what)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("use_part", [False, True])
@pytest.mark.parametrize("use_masks", [False, True])
def test_disarmed_aggregate_is_fedavg_partial_bit_for_bit(use_part, use_masks):
    stacked, ref, w, part, masks = _fleet(1)
    p = part if use_part else None
    m = masks if use_masks else None
    plain = tagg.fedavg_partial(_t(stacked), _t(w), _t(p), _t(m))
    agg, scores = tagg.robust_aggregate(_t(stacked), _t(ref), _t(w), _t(p), _t(m),
                                        tagg.RobustAggConfig.off())
    assert _same(agg, plain)
    jagg_, jscores = jagg.robust_aggregate(_j(stacked), _j(ref), _j(w), _j(p), _j(m),
                                           jagg.RobustAggConfig.off())
    _close(agg, jagg_)
    np.testing.assert_allclose(scores["update_norm"].numpy(),
                               np.asarray(jscores["update_norm"]), **RTOL)
    np.testing.assert_allclose(scores["cos_dist"].numpy(), np.asarray(jscores["cos_dist"]),
                               **COS_TOL)


def test_trim_zero_is_fedavg_het_bit_for_bit():
    stacked, _, w, part, masks = _fleet(2)
    tm = tagg.trimmed_mean(_t(stacked), _t(w), _t(part), _t(masks), 0)
    assert _same(tm, tagg.fedavg_het(_t(stacked), _t(w * part), _t(masks)))


def test_clip_matches_repro_and_inf_returns_the_uploads():
    stacked, ref, _, _, _ = _fleet(3)
    c, norms = tagg.clip_updates(_t(stacked), _t(ref), float("inf"))
    assert _same(c, _t(stacked))
    jn = jagg.update_norms(_j(stacked), _j(ref))
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), **RTOL)
    cap = 0.25 * float(norms.min())
    c2, pre = tagg.clip_updates(_t(stacked), _t(ref), cap)
    jc2, _ = jagg.clip_updates(_j(stacked), _j(ref), jnp.float32(cap))
    assert torch.equal(pre, norms)                              # pre-clip
    _close(c2, jc2)
    assert float(tagg.update_norms(c2, _t(ref)).max()) <= cap * (1 + 1e-5)


@pytest.mark.parametrize("trim", [1, 2, 3])
@pytest.mark.parametrize("use_masks", [False, True])
def test_trimmed_mean_and_median_match_repro(trim, use_masks):
    stacked, _, w, part, masks = _fleet(4 + trim, k=6)
    stacked["a"][1] = stacked["a"][0]            # ties with unequal weights
    stacked["a"][4] = stacked["a"][0]
    m = masks if use_masks else None
    got = tagg.trimmed_mean(_t(stacked), _t(w), _t(part), _t(m), trim)
    _close(got, jagg.trimmed_mean(_j(stacked), _j(w), _j(part), _j(m), jnp.int32(trim)))
    med = tagg.coordinate_median(_t(stacked), _t(w), _t(part), _t(m))
    _close(med, jagg.coordinate_median(_j(stacked), _j(w), _j(part), _j(m)))


def test_tied_values_are_trimmed_by_client_order():
    """Clients 0 and 1 tie at the low end with weights 1 and 100; trim 1
    drops the first of them (stable order, as jnp.argsort) and client 3's
    5 from above, so the mean is (100 * 1 + 1 * 2) / 101.  Dropping client
    1 instead would give 1.5."""
    stacked = {"a": np.array([[1.0, 0.0], [1.0, 0.0], [2.0, 0.0], [5.0, 0.0]], np.float32)}
    w = np.array([1.0, 100.0, 1.0, 1.0], np.float32)
    got = tagg.trimmed_mean(_t(stacked), _t(w), None, None, 1)["a"]
    want = jagg.trimmed_mean(_j(stacked), _j(w), None, None, jnp.int32(1))["a"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
    np.testing.assert_allclose(float(got[0]), 102.0 / 101.0, rtol=1e-6)


def test_trim_clamps_to_keep_one_survivor():
    stacked, _, w, _, masks = _fleet(5)
    solo = {k: m.copy() for k, m in masks.items()}
    for m in solo.values():
        m[1:] = 0.0                               # client 0 owns every slot alone
    tm = tagg.trimmed_mean(_t(stacked), _t(w), None, _t(solo), 3)
    assert _same(tm, tagg.fedavg_het(_t(stacked), _t(w), _t(solo)))
    _close(tm, jagg.trimmed_mean(_j(stacked), _j(w), None, _j(solo), jnp.int32(3)))


@pytest.mark.parametrize("cfg", [dict(trim=1), dict(clip=0.5, trim=1), dict(median=True),
                                 dict(clip=0.3, median=True)])
def test_robust_aggregate_and_scores_match_repro(cfg):
    stacked, ref, w, part, masks = _fleet(6)
    agg, sc = tagg.robust_aggregate(_t(stacked), _t(ref), _t(w), _t(part), _t(masks),
                                    tagg.RobustAggConfig.make(**cfg))
    jagg_, jsc = jagg.robust_aggregate(_j(stacked), _j(ref), _j(w), _j(part), _j(masks),
                                       jagg.RobustAggConfig.make(**cfg))
    _close(agg, jagg_)
    np.testing.assert_allclose(sc["update_norm"].numpy(), np.asarray(jsc["update_norm"]),
                               **RTOL)
    np.testing.assert_allclose(sc["cos_dist"].numpy(), np.asarray(jsc["cos_dist"]), **COS_TOL)


def test_anomaly_scores_separate_attackers():
    """Sign flip ~2 against correlated peers, blow-up ~30x the median norm,
    benign near 0 (leave-one-out peers), as in repro."""
    rng = np.random.default_rng(9)
    k = 5
    ref = {"a": rng.normal(size=(k, 16)).astype(np.float32)}
    d = rng.normal(size=(1, 16)).astype(np.float32)
    stacked = {"a": (ref["a"] + d + 0.01 * rng.normal(size=(k, 16))).astype(np.float32)}
    ops = tdef.ByzantineOps(sign=[1, 0, 0, 0, 0], scale=[1, 30, 1, 1, 1],
                            noise_std=np.zeros(k), replay=np.zeros(k))
    bad = tdef.corrupt_updates(_t(stacked), _t(ref), ops)
    _, sc = tagg.robust_aggregate(bad, _t(ref), torch.ones(k), None, None,
                                  tagg.RobustAggConfig.make(trim=1))
    cos, norm = sc["cos_dist"].numpy(), sc["update_norm"].numpy()
    assert cos[0] > 1.8 and (cos[2:] < 0.2).all()
    assert norm[1] > 10.0 * np.median(norm)


# ---------------------------------------------------------------------------
# the corruption channel
# ---------------------------------------------------------------------------

def test_benign_corruption_returns_the_uploads():
    stacked, ref, _, _, _ = _fleet(7)
    assert _same(tdef.corrupt_updates(_t(stacked), _t(ref), tdef.ByzantineOps.benign(5)),
                 _t(stacked))


def test_sign_scale_replay_bit_equal_to_repro_and_benign_rows_untouched():
    stacked, ref, _, _, _ = _fleet(8)
    k = 5
    host = dict(sign=np.array([1, 0, 0, 0, 1], np.float32),
                scale=np.array([1, 50, 1, 1, 3], np.float32),
                noise_std=np.zeros(k, np.float32), replay=np.array([0, 0, 1, 0, 0], np.float32))
    got = tdef.corrupt_updates(_t(stacked), _t(ref), tdef.ByzantineOps(**host))
    want = jdef.corrupt_updates(_j(stacked), _j(ref), jdef.ByzantineOps(
        key=jax.random.PRNGKey(0), **{n: jnp.asarray(v) for n, v in host.items()}))
    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(tree_leaves(got), tree_leaves(_t(stacked))):
        assert torch.equal(x[3], y[3])                         # client 3 benign


def test_noise_by_its_properties():
    """Deterministic per (seed, round), fresh across rounds and seeds, at
    the requested std, only on the armed client (the others bit-exact)."""
    k, n = 3, 4096
    ref = {"a": np.zeros((k, n), np.float32), "b": np.zeros((k, 8, 64), np.float32)}
    stacked = {"a": np.ones((k, n), np.float32), "b": np.ones((k, 8, 64), np.float32)}

    def run(seed, rnd, std=0.5):
        ops = tdef.ByzantineOps(sign=np.zeros(k), scale=np.ones(k),
                                noise_std=[0.0, std, 0.0], replay=np.zeros(k),
                                seed=seed, round_idx=rnd)
        return tdef.corrupt_updates(_t(stacked), _t(ref), ops)
    a, b, c, d = run(0, 3), run(0, 3), run(0, 4), run(1, 3)
    assert _same(a, b)
    for other in (c, d):
        assert not torch.equal(a["a"][1], other["a"][1])
    for leaf in ("a", "b"):
        noise = (a[leaf][1] - 1.0).reshape(-1)
        assert abs(float(noise.std()) - 0.5) < 0.05 and abs(float(noise.mean())) < 0.05
        for j in (0, 2):
            assert torch.equal(a[leaf][j], _t(stacked)[leaf][j])
    assert not torch.equal(a["a"][1, :64], a["b"][1, 0])     # a fresh draw per leaf


def test_byzantine_ops_arrays_takes_the_round():
    host = dict(sign=np.zeros(3), scale=np.ones(3), noise_std=np.zeros(3),
                replay=np.zeros(3), seed=5)
    ops = tdef.byzantine_ops_arrays(host, 7)
    assert (ops.seed, ops.round_idx) == (5, 7) and ops.scale.dtype == np.float32
    assert not ops.armed().any()


# ---------------------------------------------------------------------------
# the reputation tracker
# ---------------------------------------------------------------------------

def test_reputation_tracker_bit_equal_to_repros_over_a_score_sequence():
    cfg = dict(norm_mult=3.0, cos_threshold=1.2, ewma=0.6, rep_threshold=0.5,
               quarantine_rounds=2)
    t = tdef.ReputationTracker(4, tdef.DefenseConfig(**cfg))
    j = jdef.ReputationTracker(4, jdef.DefenseConfig(**cfg))
    rng = np.random.default_rng(11)
    quarantined = 0
    for r in range(40):
        norm = rng.lognormal(0, 1.0, 4)
        cos = rng.uniform(0, 2, 4)
        if r % 7 == 3:
            norm[2] = np.nan
        part = (rng.uniform(size=4) > 0.2).astype(float) * t.mask()
        assert np.array_equal(t.mask(), j.mask())
        assert np.array_equal(t.observe(norm, cos, part), j.observe(norm, cos, part))
        assert np.array_equal(t.reputation, j.reputation)
        assert np.array_equal(t.remaining, j.remaining)
        quarantined += int((t.remaining > 0).any())
    assert t.total_quarantines == j.total_quarantines > 0 and quarantined > 0
    s = json.loads(json.dumps(t.state()))
    t2 = tdef.ReputationTracker(4, tdef.DefenseConfig(**cfg))
    t2.load_state(s)
    assert s == j.state()
    assert np.array_equal(t2.reputation, t.reputation) and t2.total_quarantines == \
        t.total_quarantines


def test_reputation_tracker_quarantine_cycle():
    t = tdef.ReputationTracker(3, tdef.DefenseConfig(quarantine_rounds=2))
    part = [1.0, 1.0, 1.0]
    assert t.observe([1, 1, 1], [1.9, 0.1, 0.1], part).tolist() == [True, False, False]
    t.observe([1, 1, 1], [1.9, 0.1, 0.1], part)
    assert t.mask().tolist() == [0.0, 1.0, 1.0]
    t.observe([0, 1, 1], [0.0, 0.1, 0.1], [0.0, 1.0, 1.0])
    t.observe([0, 1, 1], [0.0, 0.1, 0.1], [0.0, 1.0, 1.0])
    assert t.mask().tolist() == [1.0, 1.0, 1.0] and t.reputation[0] == 0.0
    assert t.observe([np.nan, 1, 1], [0.1, 0.1, 0.1], part).tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# rounds and episodes against repro
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_arch("gpt2-s").reduced(num_layers=2)
    tcfg = t_get_arch("gpt2-s").reduced(num_layers=2)
    probs = []
    for sys0, sample, Prob, cfg in ((J_SYS, j_sample, JProblem, jcfg),
                                    (T_SYS, t_sample, TProblem, tcfg)):
        sys_cfg = dataclasses.replace(sys0, num_clients=K, total_bandwidth_hz=50e6,
                                      f_server_hz=0.4e9, f_client_hz_range=(0.2e9, 5.0e9))
        probs.append(Prob(cfg=cfg, sys_cfg=sys_cfg, envs=tuple(sample(sys_cfg, 3)), seq_len=S,
                          batch=B, local_steps=I, rank_candidates=(1, 2, 4)))
    jprob, tprob = probs
    jal, _ = j_bcd(jprob)
    tal, _ = t_bcd(tprob)
    assert np.array_equal(jal.ell_k, tal.ell_k) and np.array_equal(jal.rank_k, tal.rank_k)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0)))
    row = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, B, S)).astype(np.int32)
    tokens = np.broadcast_to(row, (K, B, S)).copy()
    own = np.random.default_rng(1).integers(0, jcfg.vocab_size, (I, K, B, S)).astype(np.int32)
    return dict(jprob=jprob, tprob=tprob, jal=jal, tal=tal, params=params,
                tparams=interop.params_from_numpy(params, "cpu"),
                batch={"tokens": tokens, "labels": tokens.copy()},
                own={"tokens": own, "labels": own.copy()})


def _pair(st):
    js = JSflLLM.from_allocation(st["jprob"], st["jal"], st["params"], j_adamw(LR),
                                 dynamic=True, donate=False)
    ts = SflLLM.from_allocation(st["tprob"], st["tal"], st["tparams"], t_adamw(LR),
                                dynamic=True, device="cpu")
    lora = jax.tree.map(np.asarray, js.init_lora(jax.random.key(7)))
    return js, ts, js.init_state(lora), ts.init_state(interop.lora_from_numpy(lora, "cpu"))


def _shared_data(st):
    """Every client sees the same batch: benign updates correlate, so the
    cosine score separates a sign-flipper (repro's _shared_data)."""
    batch = st["batch"]
    return iter(lambda: batch, None)


def _tnp(ts, state):
    return interop.sfl_state_to_numpy(state, len(ts.cfg.pattern))


def _close_state(ts, tstate, jstate, fields=("lora_client", "lora_server")):
    got = _tnp(ts, tstate)
    for f in fields:
        for a, b in zip(jax.tree.leaves(got[f]), jax.tree.leaves(jax.device_get(
                getattr(jstate, f)))):
            np.testing.assert_allclose(a, np.asarray(b), **AD_TOL, err_msg=f)


def test_round_with_robust_byzantine_and_poison_matches_repro(setup):
    """Round 1: clip + trimmed mean under a sign-flipper and a 20x blow-up;
    round 2: the median with a replaying client and client 2 dropped;
    round 3: poisoned (rolled back in both, the port's state its input bit
    for bit).  Each client has its own data here: with one shared batch the
    updates are equal, a sign-flipper's cancels a benign peer's exactly,
    and a leave-one-out mean of rounding noise has no direction to hold."""
    js, ts, jst, tst = _pair(setup)
    rb = setup["own"]
    rounds = [(dict(clip=0.05, trim=1), dict(sign=[1, 0, 0], scale=[1, 20, 1]), [1, 1, 1], 0),
              (dict(median=True), dict(replay=[0, 1, 0]), [1, 1, 0], 0),
              (dict(trim=1), dict(sign=[1, 0, 0]), [1, 1, 1], 1)]
    for robust, byz, part, poison in rounds:
        ops = dict(sign=np.zeros(K, np.float32), scale=np.ones(K, np.float32),
                   noise_std=np.zeros(K, np.float32), replay=np.zeros(K, np.float32))
        ops.update({k: np.asarray(v, np.float32) for k, v in byz.items()})
        jdyn = JRD(participation=jnp.asarray(part, jnp.float32), poison=jnp.float32(poison),
                   robust=jagg.RobustAggConfig.make(**robust),
                   byzantine=jdef.ByzantineOps(key=jax.random.PRNGKey(0),
                                               **{k: jnp.asarray(v) for k, v in ops.items()}))
        tdyn = TRD(participation=torch.tensor(part, dtype=torch.float32),
                   poison=torch.tensor(float(poison)),
                   robust=tagg.RobustAggConfig.make(**robust),
                   byzantine=tdef.ByzantineOps(**ops))
        before = tst
        jst, jm = js.train_round(jst, rb, [1.0] * K, dynamics=jdyn)
        tst, tm = ts.train_round(tst, rb, [1.0] * K, dynamics=tdyn)
        assert bool(tm["rolled_back"]) == bool(jm["rolled_back"]) == bool(poison)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), **AD_TOL)
        np.testing.assert_allclose(tm["anomaly_scores"]["update_norm"].numpy(),
                                   np.asarray(jm["anomaly_scores"]["update_norm"]), **RTOL)
        np.testing.assert_allclose(tm["anomaly_scores"]["cos_dist"].numpy(),
                                   np.asarray(jm["anomaly_scores"]["cos_dist"]), **COS_TOL)
        if poison:
            for f in FIELDS + ("step",):
                assert _same(getattr(tst, f), getattr(before, f)), f
        _close_state(ts, tst, jst)
    assert tm["anomaly_scores"]["cos_dist"][0] > 1.0      # the sign flip shows


def _episode(pkg, st, rounds, defense=None, byz=None, path="", every=0, resume=False):
    """A WirelessDynamics episode of the allocator's fleet; ``byz``: the
    TrainingFaults calls, e.g. [("sign_flip", [0])], made after arming."""
    js, ts, jst, tst = _pair(st)
    if pkg == "repro":
        sfl, eng, prob, al, state, TF = js, jeng, st["jprob"], st["jal"], jst, JTF
        d = None if defense is None else jdef.DefenseConfig(**defense)
    else:
        sfl, eng, prob, al, state, TF = ts, teng, st["tprob"], st["tal"], tst, TrainingFaults
        d = None if defense is None else tdef.DefenseConfig(**defense)
    wd = eng.WirelessDynamics(prob, al, sfl, fade_std_db=2.0, rng=0, deadline_s=1e9, defense=d)
    if byz is not None:
        tf = TF(wd)
        tf.arm_byzantine(seed=0)
        for name, *args in byz:
            getattr(tf, name)(*args)
    tr = eng.Trainer(eng.SflRound(sfl, [1.0] * K), local_steps=I, dynamics=wd,
                     episode_path=path, episode_every=every)
    state, hist = tr.fit(state, _shared_data(st), global_rounds=rounds, resume=resume)
    return sfl, wd, state, hist


DEFENSE = dict(trim=1, quarantine_rounds=3, ewma=0.5, rep_threshold=0.6, cos_threshold=1.5)


@pytest.fixture(scope="module")
def repro_defended(setup, tmp_path_factory):
    """repro's 6-round sign-flip episode under the defense, its episode
    file after round 3 (mid-quarantine) kept."""
    path = str(tmp_path_factory.mktemp("byz") / "j.ckpt")
    sfl, wd, state, hist = _episode("repro", setup, 6, DEFENSE, [("sign_flip", [0])],
                                    path=path, every=3)
    return dict(wd=wd, state=jax.device_get(state), hist=hist, file=path)


def test_defended_sign_flip_episode_matches_repro(setup, repro_defended):
    ts, twd, tst, th = _episode("port", setup, 6, DEFENSE, [("sign_flip", [0])])
    jh = repro_defended["hist"]
    q = np.asarray(th.quarantined)
    assert th.quarantined == jh.quarantined and th.participation == jh.participation
    assert q.shape == (6, K) and q[:, 0].sum() >= 3 and q[:, 1:].sum() == 0
    p = np.asarray(th.participation)
    assert (p[q[:, 0] == 1, 0] == 0).all()
    # the attacker's cosine is held; a benign client's peers are the
    # attacker and a benign client with the same data, whose updates cancel
    # to rounding noise, so its cosine is only held under the threshold
    for a, b in zip(th.anomaly_scores, jh.anomaly_scores):
        np.testing.assert_allclose(a["update_norm"], b["update_norm"], **RTOL)
        np.testing.assert_allclose(a["cos_dist"][0], b["cos_dist"][0], **COS_TOL)
        assert max(a["cos_dist"][1:] + b["cos_dist"][1:]) < DEFENSE["cos_threshold"]
    assert twd.tracker.total_quarantines == repro_defended["wd"].tracker.total_quarantines
    assert twd.cursor() == repro_defended["wd"].cursor()
    np.testing.assert_allclose(th.losses, jh.losses, **AD_TOL)
    _close_state(ts, tst, repro_defended["state"])


def test_cursors_with_defense_state_cross_both_ways(setup, repro_defended, tmp_path):
    """repro's episode file after round 3 resumes in the port to round 6
    (quarantine, participation, scores, adapters against repro's run); the
    port's cursor restores into repro's WirelessDynamics and repro's into
    the port's, the tracker's ledger with them."""
    import shutil
    path = str(tmp_path / "x.ckpt")
    shutil.copy(repro_defended["file"], path)
    ts, twd, tst, th = _episode("port", setup, 6, DEFENSE, [("sign_flip", [0])],
                                path=path, every=3, resume=True)
    jh = repro_defended["hist"]
    assert th.quarantined == jh.quarantined and th.participation == jh.participation
    assert th.rolled_back_rounds == jh.rolled_back_rounds
    np.testing.assert_allclose(th.losses, jh.losses, **AD_TOL)
    assert twd.cursor() == repro_defended["wd"].cursor()
    _close_state(ts, tst, repro_defended["state"])
    # cursor dicts, both ways
    jwd, c_j = repro_defended["wd"], repro_defended["wd"].cursor()
    assert c_j["defense"]["total_quarantines"] >= 1
    js, ts2, _, _ = _pair(setup)
    fresh_t = teng.WirelessDynamics(setup["tprob"], setup["tal"], ts2, deadline_s=1e9,
                                    defense=tdef.DefenseConfig(**DEFENSE))
    fresh_t.restore_cursor(json.loads(json.dumps(c_j)))
    assert fresh_t.cursor() == c_j
    fresh_j = jeng.WirelessDynamics(setup["jprob"], setup["jal"], js, deadline_s=1e9,
                                    defense=jdef.DefenseConfig(**DEFENSE))
    fresh_j.restore_cursor(json.loads(json.dumps(twd.cursor())))
    assert fresh_j.cursor() == twd.cursor()
    assert fresh_j.tracker.state() == twd.tracker.state()


def test_resume_under_active_quarantine_is_bit_identical(setup, tmp_path):
    """Sign flip plus noise on client 0 (the noise's round index rides the
    cursor): killed after round 3, mid-quarantine, and resumed by a fresh
    trainer with the attacker re-armed, the episode ends bit-equal to the
    uninterrupted run — state, both histories, the tracker and the cursor."""
    byz = [("sign_flip", [0]), ("gaussian_noise", [0], 0.05)]
    p_ref, p_kill = str(tmp_path / "ref.ckpt"), str(tmp_path / "kill.ckpt")
    _, wd_ref, st_ref, h_ref = _episode("port", setup, 6, DEFENSE, byz, p_ref, 3)
    assert np.asarray(h_ref.quarantined)[:3, 0].sum() >= 1
    assert np.asarray(h_ref.quarantined)[3:, 0].sum() >= 1
    _episode("port", setup, 3, DEFENSE, byz, p_kill, 3)
    _, wd_res, st_res, h_res = _episode("port", setup, 6, DEFENSE, byz, p_kill, 3, resume=True)
    for f in FIELDS + ("step",):
        assert _same(getattr(st_res, f), getattr(st_ref, f)), f
    for f in ("losses", "participation", "quarantined", "anomaly_scores",
              "rolled_back_rounds"):
        assert getattr(h_res, f) == getattr(h_ref, f), f
    assert wd_res.tracker.state() == wd_ref.tracker.state()
    assert wd_res.cursor() == wd_ref.cursor()


def test_armed_benign_episode_bit_equals_plain(setup):
    _, _, st0, h0 = _episode("port", setup, 2)
    _, wd, st1, h1 = _episode("port", setup, 2, byz=[])
    assert wd.byzantine_ops is not None
    assert h1.losses == h0.losses
    for f in FIELDS + ("step",):
        assert _same(getattr(st0, f), getattr(st1, f)), f


def test_disarmed_defense_episode_bit_equals_plain(setup):
    """DefenseConfig() (clip inf, trim 0, no median) runs the robust path
    and scores every round, and gives the defense-free rounds bit for bit."""
    _, _, st0, h0 = _episode("port", setup, 2)
    _, wd, st1, h1 = _episode("port", setup, 2, defense={})
    assert len(h1.anomaly_scores) == 2 and h1.quarantined == [[0] * K] * 2
    assert h1.losses == h0.losses
    for f in FIELDS:
        assert _same(getattr(st0, f), getattr(st1, f)), f
