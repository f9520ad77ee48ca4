"""The port's paged ServingEngine against ``repro``'s on the same weights
and requests: identical greedy token ids, typed admission errors, page
accounting after drain, sampling that does not depend on arrival order
or slot, and no silent move to the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from repro import models as JM                              # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.serving import Request as JRequest               # noqa: E402
from repro.serving import ServingEngine as JEngine          # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.models.generate import SampleConfig        # noqa: E402
from repro_torch.serving import (AdmissionError, Request,   # noqa: E402
                                 ServingEngine)

KW = dict(num_layers=2, d_model=64, vocab=128)
ENG = dict(max_slots=3, max_len=48, page_size=8)


def _weights(seed=0):
    jcfg = j_get_arch("gpt2-s").reduced(**KW)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    lora = jax.tree.map(np.asarray, JM.init_lora_stack(jcfg, jax.random.key(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda kp, v: (rng.normal(0, 0.05, v.shape).astype(v.dtype)
                       if str(kp[-1]) == "['b']" else v), lora)
    return jcfg, params, lora


def _requests(n=7, seed=0, gen=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 128, int(rng.integers(1, 20))).tolist(), gen)
            for i in range(n)]


def _port_engine(params, lora, **kw):
    cfg = t_get_arch("gpt2-s").reduced(**KW)
    return ServingEngine(cfg, interop.params_from_numpy(params, device="cpu"),
                         lora=interop.lora_from_numpy(lora, device="cpu"),
                         device="cpu", **{**ENG, **kw})


def test_greedy_token_ids_identical_to_repro_paged_engine():
    jcfg, params, lora = _weights()
    reqs = _requests()
    jeng = JEngine(jcfg, params, lora=lora, paged=True, **ENG)
    teng = _port_engine(params, lora)
    jr = [JRequest(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    tr = [Request(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs]
    for a, b in zip(jr, tr):
        jeng.submit(a)
        teng.submit(b)
    jeng.run()
    teng.run()
    assert all(r.done for r in tr)
    for a, b in zip(jr, tr):
        assert len(b.output) == b.max_new_tokens
        assert b.output == a.output, (b.uid, a.output, b.output)
    assert teng.check_consistency(resync=False)
    assert teng.pages_in_use() == 0
    assert teng.prefill_compiles() == 1
    assert teng.stats["decode_steps"] > 0 and teng.stats["prefill_chunks"] >= len(reqs)


def test_admission_errors_are_typed():
    _, params, lora = _weights()
    eng = _port_engine(params, lora)
    with pytest.raises(AdmissionError) as e:
        eng.submit(Request(uid=0, prompt=[]))
    assert e.value.reason == "empty-prompt"
    with pytest.raises(AdmissionError) as e:
        eng.submit(Request(uid=1, prompt=[3] * ENG["max_len"]))
    assert e.value.reason == "prompt-too-long"
    assert not eng.queue


def test_backpressure_and_consistency_after_drain():
    """A pool too small for every slot at once holds the FIFO queue until
    pages come home; the drained engine accounts for every page."""
    _, params, lora = _weights()
    eng = _port_engine(params, lora, num_pages=8)     # 7 usable pages
    reqs = [Request(uid=u, prompt=p, max_new_tokens=10) for u, p, _ in _requests(6)]
    for r in reqs:
        eng.submit(r)
    max_live = 0
    while any(not r.done for r in reqs):
        eng.step()
        max_live = max(max_live, sum(s is not None for s in eng.slots))
        assert eng.pages_in_use() <= sum(eng._reserved)
    assert max_live < ENG["max_slots"] or len(reqs) <= ENG["max_slots"]
    assert all(len(r.output) == 10 for r in reqs)
    eng.run()
    assert eng.check_consistency(resync=False)
    assert eng.pages_in_use() == 0 and eng._free_host == 7
    # a corrupted mirror is detected and rebuilt from the (empty) slots
    eng._free_host -= 2
    with pytest.warns(RuntimeWarning):
        assert not eng.check_consistency()
    assert eng.check_consistency(resync=False)


def test_temperature_outputs_independent_of_arrival_order_and_slot():
    _, params, lora = _weights()
    sc = SampleConfig(temperature=0.9, top_k=20)
    base = _requests(5, seed=2)

    def serve(order, slots):
        eng = _port_engine(params, lora, sc=sc, seed=7, max_slots=slots)
        reqs = {u: Request(uid=u, prompt=p, max_new_tokens=g) for u, p, g in base}
        for u in order:
            eng.submit(reqs[u])
        eng.run()
        return {u: r.output for u, r in reqs.items()}

    a = serve([0, 1, 2, 3, 4], 3)
    b = serve([4, 2, 0, 3, 1], 2)
    assert a == b
    greedy = _port_engine(params, lora)
    g = Request(uid=0, prompt=base[0][1], max_new_tokens=base[0][2])
    greedy.submit(g)
    greedy.run()
    assert a[0] != g.output          # sampling really sampled


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_get_arch("gpt2-s").reduced(**KW)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, **ENG)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_paged_cache(cfg, 4, 8)
