"""The port's MoE FFN against ``repro`` on the same weights (olmoe-1b-7b
and llama4-scout-17b-a16e, reduced to 2 layers at d 128; the
heterogeneous fleet at 4 layers): ``apply_moe`` (output and aux, at
capacity factor 1.25 and the dropping 0.25, and at group size 1) and its
gradients against ``jax.grad``; the capacity and group-size rules; the
stack's aux under a scalar and a per-row gate; interop of the MoE leaves;
forward, loss and LoRA gradients with the aux on; the paged and the slab
engine against the same ``repro`` engine; SFL rounds (homogeneous, a
``from_allocation`` fleet whose per-row server gate leaves a repeat with
no live row, and a round with a dropped client).  Tolerances: 1e-5 for a
function's values, 1e-4 for gradients (the router's sums over every token
of a group) and where a whole model sits in between."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core.sfl import RoundDynamics as JRoundDynamics  # noqa: E402
from repro.core.sfl import SflLLM as JSflLLM                # noqa: E402
from repro.models import moe as jmoe                        # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core.sfl import RoundDynamics, SflLLM     # noqa: E402
from repro_torch.models import moe as tmoe                  # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

FN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
OLMOE, LLAMA4 = "olmoe-1b-7b", "llama4-scout-17b-a16e"
K, B, S, I, LR = 3, 2, 16, 2, 1e-3


def _np(tree):
    return jax.tree.map(np.array, tree)           # writable copies


def _cfgs(name, **kw):
    kw = {"num_layers": 2, "d_model": 128, "vocab": 256, **kw}
    return j_get_arch(name).reduced(**kw), t_get_arch(name).reduced(**kw)


def _weights(tcfg, seed=0):
    """Params and a LoRA stack (q, v) whose B is not zero, as numpy trees in
    repro's layout: drawn by the port's init from a seed (no JAX init ops
    to compile) and handed to both packages."""
    gen = torch.Generator().manual_seed(seed)
    params = interop.params_to_numpy(TM.init_params(tcfg, gen, device="cpu"),
                                     len(tcfg.pattern))
    lora = TM.init_lora_stack(tcfg, gen, device="cpu")
    for layer in lora:
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.05, generator=gen)
    return params, interop.lora_to_numpy(lora, len(tcfg.pattern))


_j_apply_moe = jax.jit(jmoe.apply_moe, static_argnums=(0,),
                       static_argnames=("group_size", "capacity_factor"))
_j_forward = jax.jit(JM.forward, static_argnums=(0,))


def _assert_tree_close(a, b, **tol):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                   **tol)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

MOE_CASES = [(OLMOE, 1.25, 128, 4), (OLMOE, 0.25, 128, 4), (OLMOE, 1.25, 1, 4),
             (OLMOE, 0.25, 4, 8), (LLAMA4, 1.25, 128, 4), (LLAMA4, 0.25, 128, 4)]


def _moe_inputs(name, max_experts, seed=0):
    jcfg, tcfg = _cfgs(name, max_experts=max_experts)
    p = tree_map(lambda t: t.numpy(),
                 tmoe.init_moe(tcfg, torch.Generator().manual_seed(seed), torch.float32, "cpu"))
    x = np.random.default_rng(seed).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("name,cf,group,experts", MOE_CASES,
                         ids=[f"{n[:6]}-cf{c}-g{g}-E{e}" for n, c, g, e in MOE_CASES])
def test_apply_moe_matches_repro(name, cf, group, experts):
    jcfg, tcfg, p, x = _moe_inputs(name, experts)
    jo, ja = _j_apply_moe(jcfg, p, jnp.asarray(x), group_size=group, capacity_factor=cf)
    to, ta = tmoe.apply_moe(tcfg, tree_map(torch.from_numpy, p), torch.from_numpy(x),
                            group_size=group, capacity_factor=cf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FN_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert ta.dtype == torch.float32 and ta.dim() == 0
    if cf < 1:
        # the dropping factor really drops: some token loses a routed choice
        full, _ = tmoe.apply_moe(tcfg, tree_map(torch.from_numpy, p), torch.from_numpy(x),
                                 group_size=group, capacity_factor=4.0)
        assert (full - to).abs().max() > 1e-3


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_apply_moe_grads_match_jax(cf):
    """Gradients of sum(out * cot) + 0.7 aux with respect to x and the
    router: they flow through the gates and the density, never the ids."""
    jcfg, tcfg, p, x = _moe_inputs(OLMOE, 8)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(xx, w):
        out, aux = jmoe.apply_moe(jcfg, {**p, "router": {"w": w}}, xx, group_size=8,
                                  capacity_factor=cf)
        return jnp.sum(out * cot) + 0.7 * aux

    jgx, jgw = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(x),
                                                     jnp.asarray(p["router"]["w"]))
    tp = tree_map(torch.from_numpy, p)
    tx = torch.from_numpy(x).requires_grad_()
    tw = tp["router"]["w"].clone().requires_grad_()
    out, aux = tmoe.apply_moe(tcfg, {**tp, "router": {"w": tw}}, tx, group_size=8,
                              capacity_factor=cf)
    (torch.sum(out * torch.from_numpy(cot)) + 0.7 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **GRAD_TOL)


def test_capacity_and_group_rules_match_repro():
    for seq in range(1, 70):
        for target in (1, 4, 16, 128):
            assert tmoe._pick_group_size(seq, target) == jmoe._pick_group_size(seq, target)
    # a paged chunk of 16 at olmoe's E 64, top-8 routes 3 slots an expert; a
    # bucketed 200-token prompt routes in groups of 100 (16 slots); decode one
    # token a group (one slot, which no top-8 choice can overflow)
    assert tmoe.capacity(16, 8, 64, 1.25) == 3
    assert tmoe._pick_group_size(200, 128) == 100 and tmoe.capacity(100, 8, 64, 1.25) == 16
    assert tmoe.capacity(1, 8, 64, 1.25) == 1
    assert tmoe.capacity(64, 8, 64, 1.25) == 12              # 10, padded to 4s


# ---------------------------------------------------------------------------
# the stack's aux under the split gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", ["per-row", "scalar"])
def test_stack_aux_follows_repros_gate(gate):
    """A per-row gate whose repeat 0 no row applies: repro counts that
    repeat's aux over the whole batch (ungated), so the port still runs it;
    under a scalar gate the gated repeat adds none."""
    jcfg, tcfg = _cfgs(OLMOE, num_layers=3)
    params, lora = _weights(tcfg)
    x = np.random.default_rng(2).normal(size=(4, 8, jcfg.d_model)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    lo = [1, 1, 2, 3] if gate == "per-row" else 1
    jx, _, ja = jax.jit(lambda p_, l_, x_: JM.stack.apply_stack(
        jcfg, p_, x_, positions=jnp.asarray(pos), lora=l_, rt=JM.Runtime(),
        rep_gate=(jnp.asarray(lo, jnp.int32), None)))(params["layers"], lora, jnp.asarray(x))
    tp = interop.params_from_numpy(params, "cpu")
    tx, _, ta = TM.stack.apply_stack(tcfg, tp["layers"], torch.from_numpy(x),
                                     positions=torch.from_numpy(pos),
                                     lora=interop.lora_from_numpy(lora, "cpu"),
                                     rt=TM.Runtime(), rep_gate=(lo, None))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **MODEL_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    # the gated repeat's aux is in (per-row) or out (scalar) of the sum
    _, _, tail = TM.stack.apply_stack(tcfg, tp["layers"][1:], torch.from_numpy(x),
                                      positions=torch.from_numpy(pos), rt=TM.Runtime())
    assert (float(ta) > float(tail) + 0.5) == (gate == "per-row")


# ---------------------------------------------------------------------------
# interop, forward, loss and LoRA gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [OLMOE, LLAMA4])
def test_interop_round_trip_of_moe_params(name):
    jcfg, tcfg = _cfgs(name)
    # repro's init tree, shapes only (no JAX init ops to compile), filled
    # with random values
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                          JM.abstract_params(jcfg, jnp.float32))
    tp = interop.params_from_numpy(params, device="cpu")
    mlp = tp["layers"][0]["mlp"]
    E, d, ff = jcfg.num_experts, jcfg.d_model, jcfg.d_ff
    assert mlp["router"]["w"].shape == (d, E) and mlp["w_gate"].shape == (E, d, ff)
    assert mlp["w_down"].shape == (E, ff, d) and ("shared" in mlp) == jcfg.shared_expert
    back = interop.params_to_numpy(tp, len(jcfg.pattern))
    fa, ta = jax.tree.flatten(params)
    fb, tb = jax.tree.flatten(back)
    assert ta == tb
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.structure(interop.params_to_numpy(own, len(tcfg.pattern))) == ta)


@pytest.mark.parametrize("name,fused", [(OLMOE, True), (OLMOE, False), (LLAMA4, True)],
                         ids=["olmoe-fused", "olmoe-einsum", "llama4-fused"])
def test_forward_loss_and_lora_grads_match_repro(name, fused):
    """With LoRA on q and v only, the aux still moves the LoRA gradients
    (through the router's input): they are held with the aux on, and they
    differ from the gradients at router_aux_coef 0."""
    jcfg, tcfg = _cfgs(name)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[:, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    jl, _ = _j_forward(jcfg, params, jnp.asarray(tokens))
    tp = interop.params_from_numpy(params, "cpu")
    tl, taux = TM.forward(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FN_TOL)
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda l: JM.loss_fn(jcfg, params, l, batch, rt=JM.default_train_runtime()),
        has_aux=True))(jax.tree.map(jnp.asarray, lora))
    rt = TM.default_train_runtime() if fused else TM.Runtime()

    def grads(cfg):
        tl_ = tree_map(lambda v: v.requires_grad_(), interop.lora_from_numpy(lora, "cpu"))
        total, m = TM.loss_fn(cfg, tp, tl_, {k: torch.from_numpy(v) for k, v in batch.items()},
                              rt=rt)
        total.backward()
        return total, m, interop.lora_to_numpy(tree_map(lambda v: v.grad, tl_),
                                               len(cfg.pattern))

    total, m, g = grads(tcfg)
    np.testing.assert_allclose(total.item(), float(jt), **MODEL_TOL)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), rtol=1e-5)
    assert m["aux"].item() > 0
    _assert_tree_close(g, _np(jg), **MODEL_TOL)
    _, _, g0 = grads(tcfg.replace(router_aux_coef=0.0))
    assert max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(g),
                                                   jax.tree.leaves(g0))) > 1e-4


# ---------------------------------------------------------------------------
# serving: each engine against the same repro engine (capacity depends on
# the routing group, so paged and slab need not agree with each other)
# ---------------------------------------------------------------------------

ENG = dict(max_slots=3, max_len=48, page_size=8)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_engine_ids_identical_to_repros_engine(paged):
    jcfg, tcfg = _cfgs(OLMOE)
    params, lora = _weights(tcfg)
    rng = np.random.default_rng(5)
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
# SFL rounds against repro's train_round
# ---------------------------------------------------------------------------

def _round_batches(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (I, K, B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -3:] = -1
    return {"tokens": tokens, "labels": labels}


def _hold_round(jsfl, tsfl, lora, pattern_len, dyn=None):
    """One train_round in each package from repro's initial state; losses,
    totals and adapters at 1e-4."""
    jst0 = jsfl.init_state(lora)
    tst0 = interop.sfl_state_from_numpy(
        {f: _np(getattr(jst0, f)) for f in ("lora_client", "lora_server", "opt_client",
                                            "opt_server", "step")}, "cpu")
    rb = _round_batches(jsfl.cfg.vocab_size)
    counts = [3.0, 1.0, 2.0]
    if dyn is None:
        jst, jm = jsfl.train_round(jst0, rb, counts)
        tst, tm = tsfl.train_round(tst0, rb, counts)
    else:
        jst, jm = jsfl.train_round(jst0, rb, counts, dynamics=JRoundDynamics(**dyn))
        tst, tm = tsfl.train_round(tst0, rb, counts,
                                   dynamics=RoundDynamics(**{k: torch.as_tensor(v)
                                                             for k, v in dyn.items()}))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), **MODEL_TOL)
    np.testing.assert_allclose(tm["total"].numpy(), np.asarray(jm["total"]), **MODEL_TOL)
    assert (tm["total"] > tm["loss"]).all()                 # the server's aux is in
    got = interop.sfl_state_to_numpy(tst, pattern_len)
    for f in ("lora_client", "lora_server"):
        _assert_tree_close(got[f], _np(getattr(jst, f)), **MODEL_TOL)
    return tsfl, tst0, tst


def test_sfl_round_matches_repro():
    jcfg, tcfg = _cfgs(OLMOE)
    params, lora = _weights(tcfg)
    jsfl = JSflLLM(jcfg, params, 1, JTrainConfig(num_clients=K, batch_size=B, local_steps=I),
                   j_adamw(LR), donate=False)
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), 1,
                  TTrainConfig(num_clients=K, batch_size=B, local_steps=I), t_adamw(LR),
                  device="cpu")
    assert tsfl.aux_coef == jsfl.aux_coef == 0.01
    _hold_round(jsfl, tsfl, lora, len(jcfg.pattern))


def test_sfl_round_with_a_dropped_client_matches_repro():
    jcfg, tcfg = _cfgs(OLMOE)
    params, lora = _weights(tcfg)
    jsfl = JSflLLM(jcfg, params, 1, JTrainConfig(num_clients=K, batch_size=B, local_steps=I),
                   j_adamw(LR), donate=False)
    tsfl = SflLLM(tcfg, interop.params_from_numpy(params, "cpu"), 1,
                  TTrainConfig(num_clients=K, batch_size=B, local_steps=I), t_adamw(LR),
                  device="cpu")
    _, tst0, tst = _hold_round(jsfl, tsfl, lora, len(jcfg.pattern),
                               dyn={"participation": np.array([1.0, 0.0, 1.0], np.float32)})
    for a, b in zip(jax.tree.leaves(tree_map(lambda v: v[1], tst.lora_client)),
                    jax.tree.leaves(tree_map(lambda v: v[1], tst0.lora_client))):
        assert torch.equal(a, b)                          # the dropped client froze


def test_hetero_fleet_round_matches_repro_with_an_ungated_aux_repeat():
    """A from_allocation(dynamic=True) fleet at splits 2/3/2 of 4 layers:
    the envelope starts the server at repeat 1 (the least valid split), so
    its per-row gate leaves repeat 0 of the server base with no live row.
    repro counts that repeat's aux over the pooled batch; the round would
    differ if the port skipped it."""
    jcfg, tcfg = _cfgs(OLMOE, num_layers=4)
    params, lora = _weights(tcfg)
    alloc = types.SimpleNamespace(ell_k=np.array([2, 3, 2]), rank_k=np.array([4, 2, 4]),
                                  ell_c=3, rank=4)

    def prob(cfg):
        return types.SimpleNamespace(cfg=cfg, envs=(None,) * K, batch=B, local_steps=I,
                                     rank_candidates=(2, 4))

    jsfl = JSflLLM.from_allocation(prob(jcfg), alloc, params, j_adamw(LR), dynamic=True,
                                   donate=False)
    tsfl = SflLLM.from_allocation(prob(tcfg), alloc, interop.params_from_numpy(params, "cpu"),
                                  t_adamw(LR), dynamic=True, device="cpu")
    assert tsfl.rep_min == 1 and min(tsfl._rep_lo(range(K), B)) == 1
    _hold_round(jsfl, tsfl, lora, len(jcfg.pattern))
