"""The port's heterogeneous, precision-aware SFL fleet against ``repro`` on
the same weights and batches: slot masks and rank-aware FedAvg, the
per-sample split gate of ``apply_stack``, ``SflLLM.from_allocation`` on a
mixed fleet over an int8 base (ell_k = (1, 2, 3), r_k = (1, 2, 4),
act_bits = (4, 8, 16), grad_bits = 8, error feedback) for two global
rounds, the exact 16-bit disarm, SFL-state interop with the
error-feedback accumulators, and the modeled round latency of an
allocation.  Tolerances: 1e-5 per function and per round's adapters,
1e-4 on losses across a whole model; each other one is stated where it
is used."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import DEFAULT_SYSTEM as J_SYS           # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import aggregation as jagg                  # noqa: E402
from repro.core.channel import sample_clients as j_sample   # noqa: E402
from repro.core.lora import client_slot_masks as j_masks    # noqa: E402
from repro.core.resource import HeteroAllocation as JHA     # noqa: E402
from repro.core.resource import Problem as JProblem         # noqa: E402
from repro.core.sfl import SflLLM as JSflLLM                # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402
from repro.precision import PrecisionConfig as JPC          # noqa: E402
from repro.precision import quantize_params_int8 as j_q8    # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import DEFAULT_SYSTEM as T_SYS     # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core import aggregation as tagg            # noqa: E402
from repro_torch.core.channel import sample_clients as t_sample  # noqa: E402
from repro_torch.core.lora import client_slot_masks as t_masks  # noqa: E402
from repro_torch.core.resource import HeteroAllocation as THA  # noqa: E402
from repro_torch.core.resource import Problem as TProblem   # noqa: E402
from repro_torch.core.sfl import SflLLM                     # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.precision import PrecisionConfig as TPC    # noqa: E402
from repro_torch.tree import tree_leaves, tree_map          # noqa: E402

FN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
K, B, S, I = 3, 2, 16, 2
ELLS, RANKS, BITS = (1, 2, 3), (1, 2, 4), (4, 8, 16)
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.array, tree)           # writable copies


def _cfgs(layers=4):
    return (j_get_arch("gpt2-s").reduced(num_layers=layers),
            t_get_arch("gpt2-s").reduced(num_layers=layers))


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# slot masks and rank-aware aggregation
# ---------------------------------------------------------------------------

def _mask_case(ranks, reps, layers=4, r_max=4):
    jcfg, tcfg = _cfgs(layers)
    jt = jax.tree.map(lambda v: v[:max(reps or [layers])],
                      JM.init_lora_stack(jcfg, jax.random.key(0), rank=r_max))
    tt = TM.init_lora_stack(tcfg, torch.Generator().manual_seed(0), rank=r_max,
                            device="cpu")[:max(reps or [layers])]
    return jt, tt


@pytest.mark.parametrize("ranks,reps", [((1, 2, 4), (1, 2, 3)), ((1, 2, 4), None),
                                        ((4, 4, 4), (1, 2, 3))])
def test_client_slot_masks_match_repro(ranks, reps):
    jt, tt = _mask_case(ranks, reps)
    jm = j_masks(jt, ranks, reps)
    tm = t_masks(tt, ranks, reps)
    want = interop.split_layers(_np(jm), axis=1)            # (K, R, ...) -> per layer
    assert len(tm) == len(want)
    for a, b in zip(tree_leaves(tm), tree_leaves(tree_map(torch.from_numpy, want))):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_client_slot_masks_none_when_uniform_and_forced_ones():
    _, tt = _mask_case((4, 4, 4), None)
    assert t_masks(tt, (4, 4, 4)) is None
    assert t_masks(tt, (4, 4, 4), (4, 4, 4)) is None        # full depth
    forced = t_masks(tt, (4, 4, 4), force=True)
    assert all(bool((m == 1).all()) for m in tree_leaves(forced))
    with pytest.raises(ValueError, match="rank"):
        t_masks(tt, (2, 8, 4))                               # template below r_max


def _stacked_case(seed=0):
    """A K-stacked 3-layer client tree at r_max 4, its masks, and weights."""
    jt, tt = _mask_case(RANKS, ELLS)
    rng = np.random.default_rng(seed)
    stacked_j = jax.tree.map(lambda v: rng.normal(size=(K,) + v.shape).astype(np.float32), jt)
    stacked_t = tree_map(torch.from_numpy, interop.split_layers(stacked_j, axis=1))
    return (jt, tt, stacked_j, stacked_t, j_masks(jt, RANKS, ELLS), t_masks(tt, RANKS, ELLS),
            np.array([1.0, 2.0, 3.0], np.float32))


def test_fedavg_het_and_partial_match_repro():
    _, _, sj, st, mj, mt, w = _stacked_case()
    for part in (None, np.array([1.0, 0.0, 1.0], np.float32)):
        jout = jagg.fedavg_partial(sj, w, part, mj)
        tout = tagg.fedavg_partial(st, w, part, mt)
        want = interop.split_layers(_np(jout))
        for a, b in zip(tree_leaves(tout), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, **FN_TOL)
    # rank slots 2-3 of a rank-4 template owned by no client (ranks
    # 1, 2, 2) come back exactly zero, not 0/0
    _, tt = _mask_case((1, 2, 2), ELLS)
    tout = tagg.fedavg_het(st, w, t_masks(tt, (1, 2, 2), ELLS))
    for layer in tout:
        for ad in layer["mixer"].values():
            assert not ad["a"][2:].any() and not ad["b"][:, 2:].any()
            assert ad["a"][:2].all() and ad["b"][:, :2].all()


def test_hetero_aggregation_without_masks_is_the_stacked_path_bit_for_bit():
    _, _, _, st, _, _, w = _stacked_case(1)
    ref = tagg.fedavg_stacked(st, w)
    assert _same_tree(tagg.fedavg_het(st, w, None), ref)
    assert _same_tree(tagg.fedavg_partial(st, w, None, None), ref)
    assert _same_tree(tagg.fedavg_partial(st, w, torch.ones(K), None), ref)
    g = tree_map(lambda v: v[0], st)
    assert _same_tree(tagg.broadcast_het(g, K, None), tagg.broadcast_stacked(g, K))


def test_broadcast_het_matches_repro():
    jt, _, sj, st, mj, mt, _ = _stacked_case(2)
    gj = jax.tree.map(lambda v: v[0], sj)
    gt = tree_map(lambda v: v[0], st)
    want = interop.split_layers(_np(jagg.broadcast_het(gj, K, mj)), axis=1)
    got = tagg.broadcast_het(gt, K, mt)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, torch.from_numpy(b))


# ---------------------------------------------------------------------------
# the per-sample split gate of apply_stack
# ---------------------------------------------------------------------------

def test_apply_stack_gate_per_sample_equals_each_rows_own_substack():
    """Row j enters at repeat lo[j]: its output is the sub-stack
    [lo[j], L) applied to it alone, and a row gated past every repeat
    comes back bit-unchanged."""
    _, tcfg = _cfgs()
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    rt = TM.Runtime()
    x = torch.randn(4, 8, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(8, dtype=torch.int32)
    lo = [0, 1, 3, 4]
    y, _, _ = TM.stack.apply_stack(tcfg, params["layers"], x, rt=rt, positions=pos,
                                rep_gate=(lo, None))
    for j, l in enumerate(lo):
        want, _, _ = TM.stack.apply_stack(tcfg, params["layers"][l:], x[j:j + 1], rt=rt,
                                       positions=pos)
        np.testing.assert_allclose(y[j:j + 1].numpy(), want.numpy(), **FN_TOL)
    assert torch.equal(y[3], x[3])
    hi, _, _ = TM.stack.apply_stack(tcfg, params["layers"], x, rt=rt, positions=pos,
                                 rep_gate=(None, 2))
    want, _, _ = TM.stack.apply_stack(tcfg, params["layers"][:2], x, rt=rt, positions=pos)
    assert torch.equal(hi, want)


def test_apply_stack_gate_refuses_serving_modes():
    _, tcfg = _cfgs(2)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="train"):
        TM.stack.apply_stack(tcfg, params["layers"], torch.zeros(1, 1, tcfg.d_model),
                             rt=TM.Runtime(), mode="decode", rep_gate=(None, 1))


# ---------------------------------------------------------------------------
# the mixed fleet over an int8 base: two global rounds against repro
# ---------------------------------------------------------------------------

def _problem(HA, Prob, cfg, sys0, sample):
    sys_cfg = dataclasses.replace(sys0, num_clients=K, total_bandwidth_hz=50e6,
                                  f_server_hz=1.0e9, f_client_hz_range=(0.3e9, 3.0e9))
    prob = Prob(cfg=cfg, sys_cfg=sys_cfg, envs=tuple(sample(sys_cfg, 0)), seq_len=S,
                batch=B, local_steps=I, rank_candidates=(1, 2, 4),
                bits_candidates=(4, 8, 16))
    alloc = HA(assign_main=np.arange(sys_cfg.num_subchannels_main) % K,
               assign_fed=np.arange(sys_cfg.num_subchannels_fed) % K,
               power_main=np.full(K, 0.1), power_fed=np.full(K, 0.1),
               ell_c=max(ELLS), rank=max(RANKS), act_bits=max(BITS),
               ell_k=np.array(ELLS), rank_k=np.array(RANKS), bits_k=np.array(BITS))
    return prob, alloc


def _round_batches(vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (I, K, B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -3:] = -1                                   # IGNORE_ID tail
    return {"tokens": tokens, "labels": labels}


def _jstate_np(state):
    return {f: _np(getattr(state, f)) for f in
            ("lora_client", "lora_server", "opt_client", "opt_server", "step",
             "err_act", "err_grad")}


@pytest.fixture(scope="module")
def fleet():
    jcfg, tcfg = _cfgs()
    params = _np(j_q8(JM.init_params(jcfg, jax.random.key(0))))
    jprob, jal = _problem(JHA, JProblem, jcfg, J_SYS, j_sample)
    tprob, tal = _problem(THA, TProblem, tcfg, T_SYS, t_sample)
    jrt = JM.default_train_runtime().replace(
        precision=JPC(grad_bits=8, error_feedback=True))
    trt = TM.default_train_runtime().replace(
        precision=TPC(grad_bits=8, error_feedback=True))
    jsfl = JSflLLM.from_allocation(jprob, jal, params, j_adamw(LR), rt=jrt, donate=False)
    tsfl = SflLLM.from_allocation(tprob, tal, interop.params_from_numpy(params, "cpu"),
                                  t_adamw(LR), rt=trt, device="cpu")
    lora = _np(jsfl.init_lora(jax.random.key(7)))           # padded to r_max = 4
    rng = np.random.default_rng(0)                          # B != 0
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    rb = [_round_batches(jcfg.vocab_size, s) for s in (1, 2)]
    counts = [1.0, 2.0, 3.0]
    j0 = jsfl.init_state(lora)
    j1, jm1 = jsfl.train_round(j0, rb[0], counts)
    j2, jm2 = jsfl.train_round(j1, rb[1], counts)
    t0 = tsfl.init_state(interop.lora_from_numpy(lora, "cpu"))
    t1, tm1 = tsfl.train_round(t0, rb[0], counts)
    t2, tm2 = tsfl.train_round(t1, rb[1], counts)
    # round 2 again, from repro's state after round 1 carried over by interop
    t1j = interop.sfl_state_from_numpy(_jstate_np(j1), "cpu")
    t2r, tm2r = tsfl.train_round(t1j, rb[1], counts)
    # the yardstick for round 2: repro against itself, from an adapter
    # template moved by one part in 1e7 (about one f32 ulp)
    nudged = jax.tree.map(lambda v: v * np.float32(1 + 1e-7), lora)
    p1, _ = jsfl.train_round(jsfl.init_state(nudged), rb[0], counts)
    p2, _ = jsfl.train_round(p1, rb[1], counts)
    ev = {k: v[0, 0] for k, v in rb[1].items()}
    return dict(jsfl=jsfl, tsfl=tsfl, j=[_jstate_np(j1), _jstate_np(j2)],
                jnudged=_jstate_np(p2),
                jm=[jm1, jm2], t=[t1, t2], tm=[tm1, tm2], t2r=t2r, tm2r=tm2r, t1j=t1j,
                jeval=float(jsfl.eval_loss(j2, jax.tree.map(jnp.asarray, ev))),
                teval=float(tsfl.eval_loss(t2, ev)), P=len(tcfg.pattern))


def test_fleet_is_built_from_the_allocation(fleet):
    tsfl = fleet["tsfl"]
    assert tsfl.ell_k == ELLS and tsfl.rank_k == RANKS and tsfl.act_bits_k == BITS
    assert tsfl.r_max == 4 and tsfl.hetero and tsfl.hetero_split
    assert tsfl.client_base["layers"][0]["mixer"]["wq"]["w"].dtype == torch.int8
    assert len(tsfl.client_base["layers"]) == 3 and len(tsfl.server_base["layers"]) == 3
    cfg = tsfl.cfg
    assert tsfl._scale_k == tuple(cfg.lora_alpha / r for r in RANKS)
    assert tsfl._server_scale is None                       # r_max == cfg.lora_rank


def test_fleet_losses_match_repro_over_two_rounds(fleet):
    for tm, jm in zip(fleet["tm"], fleet["jm"]):
        assert tm["loss"].shape == (I,) and not bool(tm["rolled_back"])
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), **MODEL_TOL)
    np.testing.assert_allclose(fleet["tm2r"]["loss"].numpy(),
                               np.asarray(fleet["jm"][1]["loss"]), **MODEL_TOL)


def test_fleet_eval_loss_matches_repro(fleet):
    np.testing.assert_allclose(fleet["teval"], fleet["jeval"], **FN_TOL)


# err_act = x_in - Q(x_in) keeps the absolute rounding error of the
# uploaded activation x_in, whose entries reach ~10 here (9.95 measured
# for client 1): f32 agreement to ~1e-6 of that size is ~1e-5 in err_act,
# and the measured round-one maximum is 1.5e-5.  It is held at 1e-5
# relative to the activation size, atol 1e-4, and 99% of its entries at
# the plain 1e-5.
ERR_ACT_TOL = dict(atol=1e-4, rtol=0)
# an entry of err_act off by more than this moved to another quantization
# level (one level is amax/127 ~ 0.08 for the 8-bit client, ~1.4 for the
# 4-bit one); f32 rounding alone stays below 1e-4
LEVEL = 1e-3


def _adapter_diffs(got, want):
    return np.concatenate([np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).ravel()
                           for side in ("lora_client", "lora_server")
                           for a, b in zip(jax.tree.leaves(got[side]),
                                           jax.tree.leaves(want[side]))])


def test_fleet_round_one_state_matches_repro(fleet):
    """Round one from the same state: no quantized level differs, and the
    adapters agree within a hundredth of one Adam step (lr 1e-3), as the
    port's homogeneous round does."""
    got = interop.sfl_state_to_numpy(fleet["t"][0], fleet["P"])
    want = fleet["j"][0]
    assert _adapter_diffs(got, want).max() <= LR * 1e-2
    for side in ("opt_client", "opt_server"):
        assert int(got[side]["step"]) == int(want[side]["step"]) == I
        for mom in ("m", "v"):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **FN_TOL),
                         got[side][mom], want[side][mom])
    np.testing.assert_allclose(got["err_grad"], want["err_grad"], **FN_TOL)
    np.testing.assert_allclose(got["err_act"], want["err_act"], **ERR_ACT_TOL)
    close = np.isclose(got["err_act"], want["err_act"], **FN_TOL)
    assert close.mean() >= 0.99, close.mean()


def _check_round_two(got, want, nudged):
    """Round two, where the quantizers' rounding boundaries turn f32
    rounding into level changes.  Estimate: the uploaded activations of
    the two packages differ by ~1.5e-5 (f32 rounding over two layers); an
    8-bit level is ~0.08 wide, so ~4e-4 of the 8192 entries of client 1
    sit close enough to a boundary to round the other way, a few per
    step.  Each such entry changes that client's error-feedback residual
    by a level and, when it is the largest entry, the client's scale and
    with it every level next step: the count grows from a few to some
    hundreds over a round (94 measured from repro's own state, 554 over
    two rounds).  repro itself does the same: run from an adapter moved
    by one part in 1e7, it differs from its own run in 377 entries after
    two rounds, and its adapters by up to 3.1e-5 (``nudged``).  So:
    count the entries whose level differs and hold the count under 5% of
    the quantized entries (a wrong scale or rounding rule would move most
    of them); none in the 16-bit client; the gradient download's residual
    at 1e-5 (its 8-bit levels did not move); and the adapters, where
    Adam turns each changed gradient into a full step for small moments,
    at a hundredth of a step for 99.9% of entries and a tenth of a step
    for all, which repro's own nudged run needs too."""
    flipped = np.abs(got["err_act"] - want["err_act"]) > LEVEL
    assert not flipped[2].any()
    assert flipped.sum() <= 0.05 * flipped[:2].size, int(flipped.sum())
    np.testing.assert_allclose(got["err_grad"], want["err_grad"], **FN_TOL)
    for d in (_adapter_diffs(got, want), _adapter_diffs(nudged, want)):
        assert d.max() <= LR * 1e-1, d.max()
        assert (d <= LR * 1e-2).mean() >= 0.999, (d > LR * 1e-2).sum()


def test_fleet_round_two_from_repros_state_matches_repro(fleet):
    """Round two on both packages from the same state (repro's after round
    one, carried over by interop with its error-feedback accumulators)."""
    got = interop.sfl_state_to_numpy(fleet["t2r"], fleet["P"])
    _check_round_two(got, fleet["j"][1], fleet["jnudged"])
    assert int(got["step"]) == 2 * I


def test_fleet_two_rounds_run_on_stay_within_repros_own_spread(fleet):
    got = interop.sfl_state_to_numpy(fleet["t"][1], fleet["P"])
    _check_round_two(got, fleet["j"][1], fleet["jnudged"])
    assert int(got["step"]) == 2 * I


def test_fleet_dead_slots_stay_exactly_zero(fleet):
    """Rank slots >= r_k and layers >= ell_k of client k's adapter, and of
    its Adam moments, are exactly zero after two rounds (port and repro)."""
    for state in (interop.sfl_state_to_numpy(fleet["t"][1], fleet["P"]), fleet["j"][1]):
        trees = [state["lora_client"], state["opt_client"]["m"], state["opt_client"]["v"]]
        for tree in trees:
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                name = path[-1].key
                for k in range(K):
                    v = leaf[k]                              # (R, r, d) or (R, d, r)
                    assert not v[ELLS[k]:].any()
                    dead = v[:, RANKS[k]:] if name == "a" else v[..., RANKS[k]:]
                    assert not dead.any(), (name, k)
                    live = v[:ELLS[k], :RANKS[k]] if name == "a" else v[:ELLS[k], :, :RANKS[k]]
                    assert live.any()


def test_sfl_state_interop_carries_error_feedback_both_ways(fleet):
    t1j, src = fleet["t1j"], fleet["j"][0]
    assert t1j.err_act.shape == (K, B, S, 256) and t1j.err_grad.dtype == torch.float32
    back = interop.sfl_state_to_numpy(t1j, fleet["P"])
    for f in ("lora_client", "lora_server", "opt_client", "opt_server", "err_act",
              "err_grad"):
        for a, b in zip(jax.tree.leaves(back[f]), jax.tree.leaves(src[f])):
            assert np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# exact 16-bit disarm, refusals, allocation latency
# ---------------------------------------------------------------------------

def test_bits16_is_bit_identical_to_no_quantization():
    """An explicit act_bits = (16, 16, 16) (and grad_bits 16) runs the
    quantizer and returns its input bit for bit, so the round equals the
    round without bits — repro's test_bits16_bitwise_disarm_trainer_and_dynamics."""
    jcfg, tcfg = _cfgs()
    params = interop.params_from_numpy(_np(JM.init_params(jcfg, jax.random.key(0))), "cpu")
    tc = TTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    rb = _round_batches(jcfg.vocab_size, 3)
    out = []
    for kw in ({}, {"act_bits": (16, 16, 16)}):
        sfl = SflLLM(tcfg, params, ELLS, tc, t_adamw(LR), device="cpu", ranks=RANKS, **kw)
        st = sfl.init_state(sfl.init_lora(torch.Generator().manual_seed(7)))
        st, m = sfl.train_round(st, rb, [1.0] * K)
        out.append((sfl, st, m))
    (ref, st_ref, m_ref), (armed, st_armed, m_armed) = out
    assert ref.act_bits_k is None and armed.act_bits_k == (16, 16, 16)
    assert torch.equal(m_ref["loss"], m_armed["loss"])
    for f in ("lora_client", "lora_server", "opt_client", "opt_server"):
        assert _same_tree(getattr(st_ref, f), getattr(st_armed, f)), f


@pytest.mark.parametrize("kind", ["hetero", "pair_8bit", "pair_16bit"])
def test_from_allocation_bookkeeping_matches_repro(kind):
    """Splits, ranks, bits, padding rank, adapter scales and the
    heterogeneity flags that from_allocation derives, for a per-client
    HeteroAllocation and for a global-pair Allocation (with and without
    a boundary bit-width)."""
    from repro.core.resource import Allocation as JAlloc
    from repro_torch.core.resource import Allocation as TAlloc
    jcfg, tcfg = _cfgs()
    jprob, jal = _problem(JHA, JProblem, jcfg, J_SYS, j_sample)
    tprob, tal = _problem(THA, TProblem, tcfg, T_SYS, t_sample)
    if kind != "hetero":
        bits = 8 if kind == "pair_8bit" else 16
        jal, tal = (A(al.assign_main, al.assign_fed, al.power_main, al.power_fed, 2, 2,
                      bits) for A, al in ((JAlloc, jal), (TAlloc, tal)))
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    js = JSflLLM.from_allocation(jprob, jal, params, j_adamw(LR), donate=False)
    ts = SflLLM.from_allocation(tprob, tal, interop.params_from_numpy(params, "cpu"),
                                t_adamw(LR), device="cpu")
    assert ts.ell_k == js.ell_k and ts.rank_k == js.rank_k and ts.r_max == js.r_max
    assert ts.act_bits_k == js.act_bits_k
    assert (ts.hetero, ts.hetero_split) == (js.hetero, js.hetero_split)
    assert (ts.rep_min, ts.rep_max) == (js.rep_min, js.rep_max)
    # the scale each client's adapter runs at (None = cfg's alpha/rank;
    # repro keeps a uniform one as a single float)
    default = jcfg.lora_alpha / jcfg.lora_rank
    want = (js._scale_k if isinstance(js._scale_k, tuple)
            else (default if js._scale_k is None else js._scale_k,) * K)
    got = ts._scale_k or (default,) * K
    assert got == want
    assert ts._server_scale == js._server_scale


def test_from_allocation_refuses_the_dynamic_envelope():
    """The name is kept from when the port refused ``dynamic=True``; the
    envelope is ported now, and this holds it against repro's: the
    partition ``rep_min``/``rep_max``, the padded rank ``r_max``, the
    heterogeneity flags, the scales and the slot masks (exact)."""
    jcfg, tcfg = _cfgs()
    jprob, jal = _problem(JHA, JProblem, jcfg, J_SYS, j_sample)
    tprob, tal = _problem(THA, TProblem, tcfg, T_SYS, t_sample)
    params = _np(JM.init_params(jcfg, jax.random.key(0)))
    js = JSflLLM.from_allocation(jprob, jal, params, j_adamw(LR), donate=False, dynamic=True)
    ts = SflLLM.from_allocation(tprob, tal, interop.params_from_numpy(params, "cpu"),
                                t_adamw(LR), dynamic=True, device="cpu")
    assert ts.dynamic_capacity and js.dynamic_capacity
    assert (ts.rep_min, ts.rep_max, ts.r_max) == (js.rep_min, js.rep_max, js.r_max)
    assert (ts.rep_min, ts.rep_max, ts.r_max) == (1, 3, 4)   # splits 1-3, ranks <= 4
    assert (ts.hetero, ts.hetero_split) == (js.hetero, js.hetero_split) == (True, True)
    assert ts.ell_k == js.ell_k and ts.rank_k == js.rank_k
    assert ts._scale_k == js._scale_k and ts._server_scale == js._server_scale
    want = interop.split_layers(_np(js._client_masks), axis=1)
    assert len(ts._client_masks) == len(want) == 3
    for a, b in zip(tree_leaves(ts._client_masks), tree_leaves(tree_map(torch.from_numpy, want))):
        assert torch.equal(a, b)
    # a widened split envelope alone makes a uniform fleet gate, and a
    # rank envelope above every r_k makes it mask (pad_rank)
    tc = TTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    tparams = interop.params_from_numpy(params, "cpu")
    for kw in (dict(ell_range=(1, 3)), dict(rank_max=8)):
        jt = JSflLLM(jcfg, params, 2, JTrainConfig(num_clients=K, batch_size=B, local_steps=I),
                     j_adamw(LR), donate=False, **kw)
        tt = SflLLM(tcfg, tparams, 2, tc, t_adamw(LR), device="cpu", **kw)
        assert (tt.hetero, tt.hetero_split, tt.rep_min, tt.rep_max, tt.r_max, tt.rank_k) == \
            (jt.hetero, jt.hetero_split, jt.rep_min, jt.rep_max, jt.r_max, jt.rank_k), kw
        assert tt.hetero


@pytest.fixture(scope="module")
def prob_pair():
    """tests/test_hetero.py's ``prob`` fixture, on both packages."""
    out = []
    for get, sys0, sample, Prob in ((j_get_arch, J_SYS, j_sample, JProblem),
                                    (t_get_arch, T_SYS, t_sample, TProblem)):
        sys_cfg = dataclasses.replace(sys0, num_clients=3, total_bandwidth_hz=50e6,
                                      f_server_hz=1.0e9, f_client_hz_range=(0.3e9, 3.0e9))
        out.append(Prob(cfg=get("gpt2-s").reduced(num_layers=4), sys_cfg=sys_cfg,
                        envs=tuple(sample(sys_cfg, 0)), seq_len=64, batch=2,
                        local_steps=2, rank_candidates=(1, 2, 4)))
    return out


def _report_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "per_client":
            for a, b in zip(got[k], want[k]):
                for kk in b:
                    np.testing.assert_allclose(a[kk], b[kk], rtol=1e-12)
        else:
            np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                       rtol=1e-12)


def test_allocation_round_latency_matches_repro(prob_pair):
    from repro.core.resource import bcd_minimize_delay_per_client as j_bcd
    from repro.launch.engine import allocation_round_latency as j_arl
    from repro.launch.engine import modeled_total_seconds as j_mts
    from repro_torch.core.resource import bcd_minimize_delay_per_client as t_bcd
    from repro_torch.launch.engine import allocation_round_latency as t_arl
    from repro_torch.launch.engine import modeled_total_seconds as t_mts
    jprob, tprob = prob_pair
    jal, _ = j_bcd(jprob)
    tal, _ = t_bcd(tprob)
    np.testing.assert_array_equal(tal.ell_k, jal.ell_k)
    np.testing.assert_array_equal(tal.rank_k, jal.rank_k)
    _report_close(t_arl(tprob, tal), j_arl(jprob, jal))
    np.testing.assert_allclose(t_mts(tprob, tal), j_mts(jprob, jal), rtol=1e-12)
    # the global-pair Allocation takes the homogeneous report
    from repro.core.resource import bcd_minimize_delay as j_bcd1
    from repro_torch.core.resource import bcd_minimize_delay as t_bcd1
    jg, _ = j_bcd1(jprob)
    tg, _ = t_bcd1(tprob)
    _report_close(t_arl(tprob, tg), j_arl(jprob, jg))
