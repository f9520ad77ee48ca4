"""The port's fault injection and recovery against ``repro``'s on the same
weights (tests/test_faults.py's chaos cases).

Serving, the paged engine driven by ``ServingFaults`` in both packages: a
slot crashed mid-decode, residency deadlines, a NaN poke, stolen pages,
priority preemption under page pressure (and the same crash under
multi-tenant serving, where a requeued request acquires its adapter
again).  Token ids equal ``repro``'s and the fault-free run's, and the
counters, ``preempted`` and ``error`` equal ``repro``'s; the page mirror
audits clean at drain.  The resync counter that the port's
``check_consistency`` lacked, the typed admission errors, all-false fault
masks as no-ops, and the serve CLI's ``--preempt --deadline-steps``.

Training, ``TrainingFaults`` on ``WirelessDynamics`` episodes: an outage
burst freezes the round and clearing it resumes (participation against
``repro``'s), armed-but-quiet injectors reproduce the fault-free episode
bit for bit, and a poisoned round rolls back to its input state bit for
bit, in both packages.

Reduced GPT-2-S: 2 layers at d 64 and a 128-token vocabulary for serving
(LoRA B != 0), 2 layers at d 256 for training; every comparison exact."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from repro import models as JM                              # noqa: E402
from repro import faults as jfaults                         # noqa: E402
from repro import serving as jserving                       # noqa: E402
from repro.configs import DEFAULT_SYSTEM as J_SYS           # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import Problem as JProblem                  # noqa: E402
from repro.core import SflLLM as JSflLLM                    # noqa: E402
from repro.core import bcd_minimize_delay_per_client as j_bcd  # noqa: E402
from repro.core import sample_clients as j_sample           # noqa: E402
from repro.launch import engine as jeng                     # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402

from repro_torch import faults as tfaults                   # noqa: E402
from repro_torch import interop                             # noqa: E402
from repro_torch import serving as tserving                 # noqa: E402
from repro_torch.configs import DEFAULT_SYSTEM as T_SYS     # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import Problem as TProblem            # noqa: E402
from repro_torch.core import SflLLM                         # noqa: E402
from repro_torch.core import bcd_minimize_delay_per_client as t_bcd  # noqa: E402
from repro_torch.core import sample_clients as t_sample     # noqa: E402
from repro_torch.launch import engine as teng               # noqa: E402
from repro_torch.models.generate import SampleConfig        # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

KW = dict(num_layers=2, d_model=64, vocab=128)
STATS = ("preemptions", "deadline_preemptions", "quarantined", "recomputed_tokens", "resyncs")


# ---------------------------------------------------------------------------
# serving chaos
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adapter(jcfg, seed):
    lora = _np(JM.init_lora_stack(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_arch("gpt2-s").reduced(**KW)
    return dict(jcfg=jcfg, tcfg=t_get_arch("gpt2-s").reduced(**KW),
                params=_np(JM.init_params(jcfg, jax.random.key(0))), lora=_adapter(jcfg, 1))


def _unaligned(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` that starts one byte past a 64-byte boundary.

    ``repro``'s paged step passes its NaN-poke flags to the jitted step,
    dispatched asynchronously, as ``jnp.asarray(self._nan_poke)``, and
    clears them in place right after.  On the CPU ``jnp.asarray`` aliases
    a host array aligned to 64 bytes, so the step could read the flags
    already cleared: a poke then landed in about one run in three.  JAX
    copies an array that is not so aligned, so the step sees the flags as
    they were at the call."""
    buf = np.zeros(a.nbytes + 65, dtype=np.uint8)
    start = (-buf.ctypes.data) % 64 + 1
    out = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


class Pkg:
    """One package's serving names, and its engine on the shared weights."""

    def __init__(self, name, w):
        self.name, self.w = name, w
        mod, fl = (jserving, jfaults) if name == "repro" else (tserving, tfaults)
        self.Request, self.ServingFaults = mod.Request, fl.ServingFaults

    def engine(self, lora=True, **kw):
        kw.setdefault("max_slots", 2)
        kw.setdefault("max_len", 32)
        kw.setdefault("page_size", 8)
        kw.setdefault("seed", 7)
        w = self.w
        if self.name == "repro":
            eng = jserving.ServingEngine(w["jcfg"], w["params"],
                                         lora=w["lora"] if lora else None, paged=True, **kw)
            eng._nan_poke = _unaligned(eng._nan_poke)
            return eng
        return tserving.ServingEngine(
            w["tcfg"], interop.params_from_numpy(w["params"], "cpu"),
            lora=interop.lora_from_numpy(w["lora"], "cpu") if lora else None,
            device="cpu", **kw)

    def reqs(self, n=6, seed=4, **kw):
        rng = np.random.default_rng(seed)
        return [self.Request(uid=i, prompt=rng.integers(5, 128, int(rng.integers(3, 20))).tolist(),
                             max_new_tokens=int(rng.integers(2, 12)), **kw)
                for i in range(n)]


def _both(weights, scenario):
    """The scenario in each package: {name: its result}."""
    return {name: scenario(Pkg(name, weights)) for name in ("repro", "port")}


def _drained(eng):
    assert eng.check_consistency(resync=False) and eng.pages_in_use() == 0


def _record(reqs, eng):
    return dict(out=[r.output for r in reqs], pre=[r.preempted for r in reqs],
                err=[r.error for r in reqs], done=[r.done for r in reqs],
                stats={k: eng.stats[k] for k in STATS})


def test_crash_preempt_recovers_bit_identical(weights):
    """A slot crashed mid-decode requeues, recomputes its prefix and ends
    with the fault-free run's tokens."""
    def run(pk):
        base = pk.reqs()
        eng = pk.engine()
        for r in base:
            eng.submit(r)
        eng.run()
        chaos = pk.reqs()
        eng2 = pk.engine()
        f = pk.ServingFaults(eng2)
        for r in chaos:
            eng2.submit(r)
        eng2.step()
        eng2.step()
        f.crash_slot(0)
        eng2.run()
        _drained(eng2)
        return [r.output for r in base], _record(chaos, eng2)
    got = _both(weights, run)
    (jbase, j), (tbase, t) = got["repro"], got["port"]
    assert t == j
    assert t["out"] == tbase == jbase and all(t["done"])
    assert sum(t["pre"]) == 1 and t["stats"]["preemptions"] == 1
    assert t["stats"]["recomputed_tokens"] > 0


def test_deadline_preemption_bounds_residency(weights):
    def run(pk):
        free = pk.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=12)
        capped = pk.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=12, deadline_steps=3)
        recs = []
        for r in (free, capped):
            eng = pk.engine(max_len=64)
            eng.submit(r)
            eng.run()
            _drained(eng)
            recs.append(_record([r], eng))
        return recs
    got = _both(weights, run)
    assert got["port"] == got["repro"]
    free, capped = got["port"]
    assert capped["pre"][0] >= 2 and capped["out"] == free["out"]
    assert capped["stats"]["deadline_preemptions"] == capped["pre"][0]


def test_nan_poke_quarantines_only_the_poked_slot(weights):
    def run(pk):
        reqs = [pk.Request(uid=0, prompt=[5, 6, 7, 8], max_new_tokens=10),
                pk.Request(uid=1, prompt=[9, 10, 11], max_new_tokens=10)]
        eng = pk.engine()
        f = pk.ServingFaults(eng)
        for r in reqs:
            eng.submit(r)
        eng.step()
        f.poke_nan(0)
        eng.run()
        _drained(eng)
        return _record(reqs, eng)
    got = _both(weights, run)
    t = got["port"]
    assert t == got["repro"]
    assert t["err"] == ["non-finite logits", None] and all(t["done"])
    assert len(t["out"][1]) == 10 and len(t["out"][0]) == 2
    assert t["stats"]["quarantined"] == 1


def test_page_exhaustion_backpressure_then_recovery(weights):
    def run(pk):
        reqs = pk.reqs(4)
        eng = pk.engine(max_slots=4, num_pages=17)
        f = pk.ServingFaults(eng)
        assert f.exhaust_pages() == 16
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        assert all(s is None for s in eng.slots) and len(eng.queue) == 4
        f.release_pages()
        eng.run()
        _drained(eng)
        return _record(reqs, eng)
    got = _both(weights, run)
    assert got["port"] == got["repro"] and all(got["port"]["done"])


def test_priority_preemption_under_page_pressure(weights):
    """preempt=True: a stalled higher-priority request evicts a strictly
    lower-priority page hog; the hog's output equals its solo run."""
    def run(pk):
        solo = pk.Request(uid=3, prompt=list(range(5, 13)), max_new_tokens=24)
        eng0 = pk.engine()
        eng0.submit(solo)
        eng0.run()
        hog = pk.Request(uid=3, prompt=list(range(5, 13)), max_new_tokens=24, priority=0)
        vip = pk.Request(uid=4, prompt=list(range(20, 26)), max_new_tokens=6, priority=5)
        eng = pk.engine(num_pages=5, preempt=True)
        eng.submit(hog)
        eng.step()
        eng.step()
        eng.submit(vip)
        eng.run()
        _drained(eng)
        return solo.output, _record([hog, vip], eng)
    got = _both(weights, run)
    assert got["port"] == got["repro"]
    solo, t = got["port"]
    assert all(t["done"]) and t["pre"][0] >= 1 and t["stats"]["preemptions"] >= 1
    assert t["out"][0] == solo


def test_multi_tenant_crash_requeues_and_reacquires(weights):
    """The same crash under multi-tenant serving (4 tenants over a pool of
    2): the requeued request acquires its adapter again; ids equal the
    fault-free run's and repro's."""
    ads = [_adapter(weights["jcfg"], 100 + t) for t in range(4)]

    def run(pk, crash):
        if pk.name == "repro":
            reg = jserving.AdapterRegistry(weights["jcfg"], pool_size=2)
            for t, a in enumerate(ads):
                reg.publish(t, a)
            eng = jserving.ServingEngine(weights["jcfg"], weights["params"], adapters=reg,
                                         max_slots=2, max_len=32, page_size=8, seed=7)
        else:
            reg = tserving.AdapterRegistry(weights["tcfg"], pool_size=2, device="cpu")
            for t, a in enumerate(ads):
                reg.publish(t, interop.lora_from_numpy(a, "cpu"))
            eng = tserving.ServingEngine(
                weights["tcfg"], interop.params_from_numpy(weights["params"], "cpu"),
                adapters=reg, max_slots=2, max_len=32, page_size=8, seed=7, device="cpu",
                sc=SampleConfig(greedy=True))
        reqs = [pk.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                           tenant=r.uid % 4) for r in pk.reqs()]
        f = pk.ServingFaults(eng)
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.step()
        if crash:
            f.crash_slot(1)
        eng.run()
        _drained(eng)
        return _record(reqs, eng), reg.stats["swaps"]
    base = run(Pkg("port", weights), False)[0]
    (j, jswaps), (t, tswaps) = (run(Pkg(n, weights), True) for n in ("repro", "port"))
    assert t == j and tswaps == jswaps
    assert t["out"] == base["out"] and sum(t["pre"]) == 1


def test_consistency_audit_detects_and_repairs_desync(weights):
    """check_consistency counts each resync (repro's stats["resyncs"]); the
    repaired engine still serves."""
    def run(pk):
        eng = pk.engine()
        f = pk.ServingFaults(eng)
        assert eng.check_consistency(resync=False)
        f.desync_mirror(2)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert not eng.check_consistency()
        assert len(w) == 1 and "drift" in str(w[0].message)
        assert eng.check_consistency(resync=False)
        r = pk.Request(uid=9, prompt=[3, 4, 5], max_new_tokens=4)
        eng.submit(r)
        eng.run()
        return _record([r], eng)
    got = _both(weights, run)
    assert got["port"] == got["repro"]
    assert got["port"]["stats"]["resyncs"] == 1 and len(got["port"]["out"][0]) == 4


def test_admission_errors_are_typed(weights):
    pk = Pkg("port", weights)
    eng = pk.engine()
    for prompt, reason in (([], "empty-prompt"), ([1] * 40, "prompt-too-long")):
        with pytest.raises(tserving.AdmissionError) as e:
            eng.submit(pk.Request(uid=0, prompt=prompt, max_new_tokens=2))
        assert e.value.reason == reason
    assert not eng.queue


def test_quiet_fault_hooks_change_no_token(weights):
    """A ServingFaults attached and never fired, deadlines that never
    bite, and preempt=True without pressure: the ids and the engine's
    whole state (caches, pager, block tables) equal a plain run's."""
    pk = Pkg("port", weights)
    runs = []
    for kw, extra in ((dict(), dict()), (dict(preempt=True), dict(deadline_steps=1000))):
        reqs = pk.reqs(**extra)
        eng = pk.engine(**kw)
        pk.ServingFaults(eng)
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append(([r.output for r in reqs], eng))
    (a, ea), (b, eb) = runs
    assert a == b and eb.stats["preemptions"] == 0
    for x, y in zip(tree_leaves([ea.caches, ea._pager, ea._bt]),
                    tree_leaves([eb.caches, eb._pager, eb._bt])):
        assert torch.equal(x, y)


def test_serve_cli_preempt_and_deadline_print_the_same_ids(capsys):
    from repro_torch.launch import serve
    base = ["--arch", "gpt2-s", "--reduced", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--gen", "6", "--prompt-len", "12"]
    lines = []
    for extra in ([], ["--preempt", "--deadline-steps", "2"]):
        serve.main(base + extra)
        lines.append(capsys.readouterr().out.splitlines())
    ids = [[ln for ln in out if ln.startswith("sample token ids")] for out in lines]
    assert ids[0] == ids[1] != []
    stats = [ln for ln in lines[1] if ln.startswith("fault stats")]
    assert len(stats) == 1 and "preemptions (" in stats[0] and not stats[0].startswith(
        "fault stats: 0 ")
    with pytest.raises(SystemExit, match="paged engine"):
        serve.main(base + ["--slab", "--preempt"])


# ---------------------------------------------------------------------------
# training chaos
# ---------------------------------------------------------------------------

K, B, S, I = 3, 2, 16, 2


@pytest.fixture(scope="module")
def train_setup():
    jcfg = j_get_arch("gpt2-s").reduced(num_layers=2)
    tcfg = t_get_arch("gpt2-s").reduced(num_layers=2)
    out = {}
    for name, sys0, sample, Prob, cfg, bcd in (("repro", J_SYS, j_sample, JProblem, jcfg, j_bcd),
                                               ("port", T_SYS, t_sample, TProblem, tcfg, t_bcd)):
        sys_cfg = dataclasses.replace(sys0, num_clients=K, total_bandwidth_hz=50e6,
                                      f_server_hz=0.4e9, f_client_hz_range=(0.2e9, 5.0e9))
        prob = Prob(cfg=cfg, sys_cfg=sys_cfg, envs=tuple(sample(sys_cfg, 3)), seq_len=S,
                    batch=B, local_steps=I, rank_candidates=(1, 2, 4))
        out[name] = (prob, bcd(prob)[0])
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (K, B, S)).astype(np.int32)
    return dict(pk=out, params=params, tparams=interop.params_from_numpy(params, "cpu"),
                batch={"tokens": tokens, "labels": tokens.copy()})


def _trainer(st, pkg, **wd_kw):
    prob, alloc = st["pk"][pkg]
    if pkg == "repro":
        sfl = JSflLLM.from_allocation(prob, alloc, st["params"], j_adamw(1e-3), dynamic=True,
                                      donate=False)
        state = sfl.init_state(sfl.init_lora(jax.random.key(7)))
        eng, TF = jeng, jfaults.TrainingFaults
    else:
        js = JSflLLM.from_allocation(*st["pk"]["repro"], st["params"], j_adamw(1e-3),
                                     dynamic=True, donate=False)
        lora = _np(js.init_lora(jax.random.key(7)))
        sfl = SflLLM.from_allocation(prob, alloc, st["tparams"], t_adamw(1e-3), dynamic=True,
                                     device="cpu")
        state = sfl.init_state(interop.lora_from_numpy(lora, "cpu"))
        eng, TF = teng, tfaults.TrainingFaults
    wd_kw.setdefault("fade_std_db", 2.0)
    wd_kw.setdefault("rng", 0)
    wd = eng.WirelessDynamics(prob, alloc, sfl, **wd_kw)
    tr = eng.Trainer(eng.SflRound(sfl, [1.0] * K), local_steps=I, dynamics=wd)
    return sfl, wd, tr, state, TF(wd)


def _data(st):
    batch = st["batch"]
    return iter(lambda: batch, None)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


FIELDS = ("lora_client", "lora_server", "opt_client", "opt_server", "step")


def test_outage_burst_freezes_round_and_recovers(train_setup):
    """A forced p=1 burst hard-outages every client: that round's adapters
    are frozen bit for bit; clearing it resumes training.  Participation
    equals repro's in every round."""
    parts = {}
    for pkg in ("repro", "port"):
        sfl, wd, tr, st, tf = _trainer(train_setup, pkg, outage_snr_db=0.0, max_harq=2)
        hist = []
        st1, h = tr.fit(st, _data(train_setup), global_rounds=1)
        hist += h.participation
        tf.outage_burst(1.0)
        st2, h = tr.fit(st1, _data(train_setup), global_rounds=1)
        hist += h.participation
        tf.clear_outage()
        st3, h = tr.fit(st2, _data(train_setup), global_rounds=1)
        hist += h.participation
        parts[pkg] = hist
        if pkg == "port":
            assert _same(st2.lora_client, st1.lora_client)
            assert _same(st2.lora_server, st1.lora_server)
            assert not _same(st3.lora_client, st2.lora_client)
    assert parts["port"] == parts["repro"]
    assert parts["port"][1] == [0] * K and sum(parts["port"][2]) > 0


def test_quiet_injectors_bitwise_and_poison_rolls_back(train_setup):
    """Injectors attached (poison armed to False, Byzantine operands
    benign) but never fired reproduce the plain episode bit for bit; a
    poisoned round rolls back to its input state bit for bit, as in
    repro, and the next round runs on."""
    _, _, tr0, st0, _ = _trainer(train_setup, "port", deadline_s=1e9)
    _, h0 = tr0.fit(st0, _data(train_setup), global_rounds=2)
    sfl, wd, tr, st, tf = _trainer(train_setup, "port", deadline_s=1e9)
    tf.arm_byzantine(seed=0)
    assert wd.poison_next is False
    st1, h1 = tr.fit(st, _data(train_setup), global_rounds=2)
    assert h1.losses == h0.losses and h1.rolled_back_rounds == []
    tf.poison_round()
    st2, h2 = tr.fit(st1, _data(train_setup), global_rounds=1)
    assert h2.rolled_back_rounds == [0] and wd.poison_next is False
    for f in FIELDS:
        assert _same(getattr(st2, f), getattr(st1, f)), f
    st3, h3 = tr.fit(st2, _data(train_setup), global_rounds=1)
    assert h3.rolled_back_rounds == [] and not _same(st3.lora_server, st2.lora_server)
    # repro rolls the same round back
    _, jwd, jtr, jst, jtf = _trainer(train_setup, "repro", deadline_s=1e9)
    jst, _ = jtr.fit(jst, _data(train_setup), global_rounds=1)
    jtf.poison_round()
    _, jh = jtr.fit(jst, _data(train_setup), global_rounds=1)
    assert jh.rolled_back_rounds == h2.rolled_back_rounds
