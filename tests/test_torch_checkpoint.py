"""The port's checkpoints (``repro_torch.checkpoint``) against ``repro``'s:
the round trips of tests/test_checkpoint.py (mixed dtypes, a missing leaf,
the atomic write, a heterogeneous slot-masked SFL state after a round, a
paged engine mid-flight with the port engine's own fields, the episode
format with a 128-bit RNG cursor), and the file format itself: the bytes
the port writes equal ``repro``'s for the same tree and meta, each package
restores the other's files, and the msgpack subset codec encodes as
``msgpack.packb(..., use_bin_type=True)`` and refuses other types.  The
hand-off from ``launch.train --checkpoint`` to ``launch.serve
--lora-checkpoint`` is driven through both CLIs.  Reduced GPT-2-S (2
layers, d 256), K 3, b 2, S 16, I 2; every comparison is exact."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
import msgpack                                              # noqa: E402

from repro import checkpoint as jck                         # noqa: E402
from repro import models as JM                              # noqa: E402
from repro.configs import TrainConfig as JTrainConfig       # noqa: E402
from repro.configs import get_arch as j_get_arch            # noqa: E402
from repro.core import SflLLM as JSflLLM                    # noqa: E402
from repro.optim import adamw as j_adamw                    # noqa: E402

from repro_torch import interop                             # noqa: E402
from repro_torch import models as TM                        # noqa: E402
from repro_torch.checkpoint import (restore_episode, restore_pytree,  # noqa: E402
                                    save_episode, save_pytree)
from repro_torch.checkpoint.io import packb, unpackb        # noqa: E402
from repro_torch.configs import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.core.sfl import SflLLM                     # noqa: E402
from repro_torch.launch.engine import SflRound              # noqa: E402
from repro_torch.optim import adamw as t_adamw              # noqa: E402
from repro_torch.serving import Request, ServingEngine      # noqa: E402
from repro_torch.tree import tree_leaves, tree_map          # noqa: E402

K, B, S, I = 3, 2, 16, 2
RANKS = [1, 2, 4]


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _same_np(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# round trips (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_pytree_roundtrip_mixed_dtypes(tmp_path):
    tree = {"f32": torch.linspace(0, 1, 7),
            "bf16": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "i32": torch.arange(5, dtype=torch.int32),
            "bool": torch.tensor([True, False]),
            "nested": {"scalar": torch.tensor(3.125)}}
    path = str(tmp_path / "t.ckpt")
    save_pytree(path, tree)
    assert _same(tree, restore_pytree(path, _zeros_like(tree)))


def test_restore_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "t.ckpt")
    save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_atomic_write_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "t.ckpt")
    save_pytree(path, {"a": torch.zeros(3)})
    assert os.listdir(tmp_path) == ["t.ckpt"]


def _port_fleet(seed=7):
    cfg = t_get_arch("gpt2-s").reduced(num_layers=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    sfl = SflLLM(cfg, params, ell_c=1, train_cfg=tc, optimizer=t_adamw(1e-3),
                 ranks=RANKS, device="cpu")
    return sfl, sfl.init_state(sfl.init_lora(torch.Generator().manual_seed(seed)))


def test_hetero_adapter_state_roundtrip(tmp_path):
    """Per-client slot-masked adapters at mixed ranks, the server adapter,
    both optimizer states and the step counter after one round restore
    bit for bit into a fresh template (through repro's layout, as the
    trainer's episode files keep them)."""
    sfl, state = _port_fleet()
    tokens = np.random.default_rng(0).integers(0, sfl.cfg.vocab_size,
                                               (I, K, B, S)).astype(np.int32)
    state, _ = sfl.train_round(state, {"tokens": tokens, "labels": tokens.copy()}, [1.0] * K)
    algo = SflRound(sfl, [1.0] * K)
    path = str(tmp_path / "sfl.ckpt")
    save_pytree(path, algo.episode_tree(state))
    _, template = _port_fleet(11)
    got = algo.from_episode_tree(restore_pytree(path, algo.episode_tree(template)))
    for f in ("lora_client", "lora_server", "opt_client", "opt_server", "step"):
        assert _same(getattr(state, f), getattr(got, f)), f


def test_paged_engine_state_roundtrip(tmp_path):
    """A paged engine mid-flight: the KV page pool, the pager, the block
    tables and every per-slot counter survive a save and restore."""
    cfg = t_get_arch("gpt2-s").reduced(num_layers=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, max_slots=2, max_len=32, page_size=8, seed=7,
                        device="cpu")
    for i in range(3):
        eng.submit(Request(uid=i, prompt=[5 + i, 6, 7, 8, 9], max_new_tokens=8))
    for _ in range(3):
        eng.step()
    state = {"caches": eng.caches, "pager": eng._pager, "bt": eng._bt, "last": eng._last,
             "positions": eng._positions, "live": eng._live, "ngen": eng._ngen,
             "maxnew": eng._maxnew, "eos": eng._eos}
    assert bool(state["live"].any())             # actually mid-flight
    path = str(tmp_path / "eng.ckpt")
    save_pytree(path, state)
    assert _same(state, restore_pytree(path, _zeros_like(state)))


def test_episode_format_roundtrip_with_rng_cursor(tmp_path):
    """Episode file = tree + JSON meta in one file; a PCG64 cursor's
    128-bit ints survive, and restore_pytree reads the tree half."""
    tree = {"w": torch.linspace(0, 1, 5), "n": torch.arange(3)}
    rng = np.random.default_rng(12345)
    rng.normal(size=7)                          # off the seed state
    meta = {"round": 3, "rng": rng.bit_generator.state, "history": {"losses": [1.0, 0.5]}}
    path = str(tmp_path / "ep.ckpt")
    save_episode(path, tree, meta)
    got_tree, got_meta = restore_episode(path, _zeros_like(tree))
    assert _same(tree, got_tree) and got_meta == meta
    rng2 = np.random.default_rng(0)
    rng2.bit_generator.state = got_meta["rng"]
    assert np.array_equal(rng.normal(size=4), rng2.normal(size=4))
    assert _same(tree, restore_pytree(path, _zeros_like(tree)))


def test_restore_episode_rejects_plain_checkpoint(tmp_path):
    path = str(tmp_path / "plain.ckpt")
    save_pytree(path, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="episode"):
        restore_episode(path, {"a": torch.zeros(2)})


def test_restore_places_tensors_on_the_templates_device_and_numpy_as_numpy(tmp_path):
    path = str(tmp_path / "t.ckpt")
    save_pytree(path, {"a": np.arange(4, dtype=np.float32), "b": torch.ones(2, 2)})
    got = restore_pytree(path, {"a": torch.zeros(1, device="meta"), "b": np.zeros(1)})
    assert got["a"].device.type == "meta" and tuple(got["a"].shape) == (4,)
    assert isinstance(got["b"], np.ndarray) and got["b"].shape == (2, 2)


def test_a_none_template_leaf_takes_the_files_array(tmp_path):
    """A fresh SflState has no error-feedback accumulators yet (None); a
    file that holds them fills them in, as numpy, and a file without them
    leaves the None."""
    path = str(tmp_path / "t.ckpt")
    err = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    save_episode(path, {"a": np.ones(2, np.float32), "err_act": err}, {"round": 1})
    tree, _ = restore_episode(path, {"a": torch.zeros(1), "err_act": None, "err_grad": None})
    assert torch.equal(tree["a"], torch.ones(2))
    assert isinstance(tree["err_act"], np.ndarray) and np.array_equal(tree["err_act"], err)
    assert tree["err_grad"] is None


# ---------------------------------------------------------------------------
# the file format against repro's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_state():
    """repro's hetero SflState after one round (numpy leaves) and the same
    state as the port's tensors."""
    cfg = j_get_arch("gpt2-s").reduced(num_layers=2)
    params = JM.init_params(cfg, jax.random.key(0))
    tc = JTrainConfig(num_clients=K, batch_size=B, local_steps=I)
    sfl = JSflLLM(cfg, params, ell_c=1, train_cfg=tc, optimizer=j_adamw(1e-3),
                  ranks=RANKS, donate=False)
    state = sfl.init_state(sfl.init_lora(jax.random.key(7)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (I, K, B, S)).astype(np.int32)
    state, _ = sfl.train_round(state, {"tokens": tokens, "labels": tokens.copy()}, [1.0] * K)
    state = jax.device_get(state)
    fields = ("lora_client", "lora_server", "opt_client", "opt_server", "step",
              "err_act", "err_grad")
    tstate = interop.sfl_state_from_numpy(
        {f: jax.tree.map(np.array, getattr(state, f)) for f in fields}, "cpu")
    tsfl = SflLLM(t_get_arch("gpt2-s").reduced(num_layers=2),
                  TM.init_params(t_get_arch("gpt2-s").reduced(num_layers=2),
                                 torch.Generator().manual_seed(0), device="cpu"),
                  ell_c=1, train_cfg=TTrainConfig(num_clients=K, batch_size=B, local_steps=I),
                  optimizer=t_adamw(1e-3), ranks=RANKS, device="cpu")
    return state, tstate, SflRound(tsfl, [1.0] * K)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_sfl_state_file_is_byte_equal_to_repros(tmp_path, repro_state):
    jstate, tstate, algo = repro_state
    jck.save_pytree(str(tmp_path / "j.ckpt"), jstate)
    save_pytree(str(tmp_path / "t.ckpt"), algo.episode_tree(tstate))
    assert _bytes(tmp_path / "j.ckpt") == _bytes(tmp_path / "t.ckpt")
    # the trainer's adapter payload too: {"lora_client", "lora_server"}
    jck.save_pytree(str(tmp_path / "jp.ckpt"), {"lora_server": jstate.lora_server,
                                                "lora_client": jstate.lora_client})
    save_pytree(str(tmp_path / "tp.ckpt"), algo.checkpoint_payload(tstate))
    assert _bytes(tmp_path / "jp.ckpt") == _bytes(tmp_path / "tp.ckpt")


def test_episode_file_is_byte_equal_to_repros(tmp_path, repro_state):
    jstate, tstate, algo = repro_state
    rng = np.random.default_rng(3)
    rng.uniform(size=5)
    meta = {"round": 2, "history": {"losses": [6.25, 6.0], "participation": [[1, 0, 1]]},
            "dynamics": {"outage_rng": rng.bit_generator.state, "deadline_s": 0.125,
                         "defense": None}}
    jck.save_episode(str(tmp_path / "j.ckpt"), jstate, meta)
    save_episode(str(tmp_path / "t.ckpt"), algo.episode_tree(tstate), meta)
    assert _bytes(tmp_path / "j.ckpt") == _bytes(tmp_path / "t.ckpt")


def test_each_package_reads_the_others_files(tmp_path, repro_state):
    jstate, tstate, algo = repro_state
    meta = {"round": 1, "x": [1, 2]}
    # repro writes, the port reads
    jck.save_episode(str(tmp_path / "j.ckpt"), jstate, meta)
    tree, got_meta = restore_episode(str(tmp_path / "j.ckpt"), algo.episode_tree(tstate))
    got = algo.from_episode_tree(tree)
    assert got_meta == meta
    for f in ("lora_client", "lora_server", "opt_client", "opt_server", "step"):
        assert _same(getattr(tstate, f), getattr(got, f)), f
    # the port writes, repro reads
    save_episode(str(tmp_path / "t.ckpt"), algo.episode_tree(tstate), meta)
    jtree, jmeta = jck.restore_episode(str(tmp_path / "t.ckpt"), jstate)
    assert jmeta == meta and _same_np(jax.device_get(jtree), jstate)
    save_pytree(str(tmp_path / "tp.ckpt"), algo.checkpoint_payload(tstate))
    want = {"lora_server": jstate.lora_server, "lora_client": jstate.lora_client}
    assert _same_np(jax.device_get(jck.restore_pytree(str(tmp_path / "tp.ckpt"), want)), want)


def test_bf16_leaves_cross_both_ways(tmp_path):
    j = {"w": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)}
    jck.save_pytree(str(tmp_path / "j.ckpt"), j)
    got = restore_pytree(str(tmp_path / "j.ckpt"), {"w": torch.zeros(1, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and got["w"].float().tolist() == [1.5, -2.25, 3.0]
    save_pytree(str(tmp_path / "t.ckpt"), got)
    assert _bytes(tmp_path / "t.ckpt") == _bytes(tmp_path / "j.ckpt")


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000,
    b"", b"x" * 255, b"x" * 256, b"x" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i, b"q"] for i in range(16)},
    {str(i): i for i in range(70000)}],
    ids=lambda o: f"{type(o).__name__}{len(o) if hasattr(o, '__len__') else o}")
def test_codec_encodes_as_msgpack_does(obj):
    """Every header form at its boundaries: fixint/uint8-64, fixstr/str8-32,
    bin8-32, fixarray/array16-32, fixmap/map16-32."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("bad", [-1, 1.5, True, None, np.int64(3), np.zeros(2)],
                         ids=["negative", "float", "bool", "none", "np_int", "ndarray"])
def test_codec_refuses_other_types(bad, tmp_path):
    with pytest.raises(ValueError, match="encode"):
        packb({"a": bad})
    with pytest.raises(ValueError, match="unsupported msgpack type"):
        unpackb(msgpack.packb({"a": 1.5}))


# ---------------------------------------------------------------------------
# the hand-off through the CLIs
# ---------------------------------------------------------------------------

def test_train_checkpoint_serves_through_lora_checkpoint(tmp_path, capsys):
    """launch.train --checkpoint writes {lora_client (K, ...), lora_server};
    launch.serve's restore_lora joins client 0's layers below the split
    and the server's above into the served stack, bit for bit."""
    from repro_torch.launch import serve, train
    path = str(tmp_path / "ck.msgpack")
    args = train.build_argparser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "2", "--local-steps", "1",
         "--clients", "2", "--batch", "1", "--seq", "16", "--split", "2",
         "--checkpoint", path])
    state, _, sfl = train.run(args)
    assert os.path.exists(path)
    cfg = sfl.cfg
    tmpl = TM.init_lora_stack(cfg, torch.Generator().manual_seed(1), 4, device="cpu")
    got = serve.restore_lora(cfg, path, tmpl)
    want = [tree_map(lambda v: v[0], layer) for layer in state.lora_client] + state.lora_server
    assert len(got) == cfg.num_layers and _same(got, want)
    # a whole stack (repro's --lora-checkpoint format)
    save_pytree(str(tmp_path / "s.ckpt"), interop.lora_to_numpy(want, 1))
    assert _same(serve.restore_lora(cfg, str(tmp_path / "s.ckpt"), tmpl), want)
    # a hand-off whose parts overlap does not say where client 0 splits
    save_pytree(str(tmp_path / "o.ckpt"),
                {"lora_client": tree_map(lambda v: v[None], interop.lora_to_numpy(want[:3], 1)),
                 "lora_server": interop.lora_to_numpy(want[1:], 1)})
    with pytest.raises(ValueError, match="tile"):
        serve.restore_lora(cfg, str(tmp_path / "o.ckpt"), tmpl)
    serve.main(["--reduced", "--device", "cpu", "--requests", "2", "--slots", "2",
                "--gen", "3", "--lora-checkpoint", path])
    assert f"loaded adapter from {path}" in capsys.readouterr().out


def test_centralized_round_checkpoint_and_episode_resume(tmp_path):
    """The centralized baseline through the same hooks: its payload is
    repro's {"lora": stacked}, and a killed episode resumes bit for bit."""
    from repro_torch.core.sfl import CentralizedLoRA
    from repro_torch.launch.engine import CentralizedRound, Trainer
    cfg = t_get_arch("gpt2-s").reduced(num_layers=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TTrainConfig(num_clients=1, batch_size=B, local_steps=I)
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, B, S)).astype(np.int32)

    def fit(path, rounds, resume=False):
        cen = CentralizedLoRA(cfg, params, tc, t_adamw(1e-3), device="cpu")
        algo = CentralizedRound(cen)
        st = cen.init_state(TM.init_lora_stack(cfg, torch.Generator().manual_seed(7),
                                               device="cpu"))
        it = iter({"tokens": r, "labels": r} for r in rows)
        tr = Trainer(algo, local_steps=I, episode_path=path, episode_every=1,
                     checkpoint_path=str(tmp_path / "lora.ckpt"))
        return algo, tr.fit(st, it, global_rounds=rounds, resume=resume)

    algo, ((lora, opt), h) = fit(str(tmp_path / "a.ckpt"), 2)
    fit(str(tmp_path / "b.ckpt"), 1)
    _, ((lora_b, opt_b), h_b) = fit(str(tmp_path / "b.ckpt"), 2, resume=True)
    assert _same(lora, lora_b) and _same(opt, opt_b) and h.losses == h_b.losses
    payload = algo.checkpoint_payload((lora, opt))
    assert list(payload) == ["lora"] and payload["lora"][0]["mixer"]["q"]["a"].shape[0] == 2
    got = restore_pytree(str(tmp_path / "lora.ckpt"), payload)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got),
                                                    jax.tree.leaves(payload)))
