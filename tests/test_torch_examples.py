"""The port's five examples (``examples/torch_*.py``) on the CPU: each runs
with ``--device cpu`` and ``REPRO_SMOKE=1`` in a subprocess (the train
example at small ``--steps/--clients/--seq``), with a time limit of its
own, exits 0 and prints its line: the quickstart's loss falls, the
allocator's ``(ell_c, rank)`` equals ``repro``'s ``bcd_minimize_delay``
on the same ``Problem`` (the train example's and the demo's), the serve
example loads the train example's adapters and decodes every prompt, and
the continuous-batching engine's ids equal the naive loop's.  The train
example's msgpack file is read by ``repro.checkpoint.restore_pytree``
too, leaf for leaf as the port's codec reads it (the train -> serve
contract of ``repro``'s examples).

The four independent examples start together and the serve example after
the train example has written its file, so the module takes about as long
as its slowest example.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120                     # seconds, each example
TRAIN = ["--steps", "2", "--local-steps", "1", "--clients", "2", "--batch", "2",
         "--seq", "16"]
NAMES = ["quickstart", "train_sfl_e2e", "resource_allocation_demo", "serve_lora",
         "continuous_batching"]


def _start(name, args, env):
    cmd = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), "--device", "cpu",
           *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=str(ROOT))


def _wait(p):
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        return {"rc": "timeout", "out": out, "err": err}
    return {"rc": p.returncode, "out": out, "err": err}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    ada = str(tmp / "ada.msgpack")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_SMOKE="1",
               OMP_NUM_THREADS="2", TMPDIR=str(tmp))
    procs = {n: _start(n, TRAIN + ["--out", ada] if n == "train_sfl_e2e" else [], env)
             for n in NAMES if n != "serve_lora"}
    res = {"train_sfl_e2e": _wait(procs.pop("train_sfl_e2e"))}
    serve = _start("serve_lora", ["--adapter", ada, "--gen", "4"], env)
    res.update({n: _wait(p) for n, p in procs.items()})
    res["serve_lora"] = _wait(serve)
    res["adapter"] = ada
    return res


def _allocation(seq, batch, local_steps, cfg_fn):
    """repro's bcd_minimize_delay on the Problem the example builds."""
    from repro.configs import DEFAULT_SYSTEM, get_arch
    from repro.core import Problem, bcd_minimize_delay, sample_clients
    envs = tuple(sample_clients(DEFAULT_SYSTEM, 0))
    prob = Problem(cfg=cfg_fn(get_arch("gpt2-s")), sys_cfg=DEFAULT_SYSTEM, envs=envs,
                   seq_len=seq, batch=batch, local_steps=local_steps)
    alloc, _ = bcd_minimize_delay(prob)
    return int(alloc.ell_c), int(alloc.rank)


def _check_quickstart(out):
    a, b = map(float, re.search(r"loss: ([\d.]+) -> ([\d.]+) over", out).groups())
    assert b < a, out


def _check_train_sfl_e2e(out):
    got = tuple(map(int, re.search(r"allocator: split l_c=(\d+), rank r=(\d+)", out).groups()))
    assert got == _allocation(16, 2, 1, lambda c: c.reduced(num_layers=6, d_model=256))
    assert "adapters saved to" in out


def _check_resource_allocation_demo(out):
    got = tuple(map(int, re.search(r"BCD picked split l_c=(\d+)/12, rank r=(\d+)",
                                   out).groups()))
    assert got == _allocation(512, 16, 12, lambda c: c)
    assert "dynamic episode:" in out


def _check_serve_lora(out):
    assert "loaded adapter from" in out
    assert out.count("OUTPUT:") == 4


def _check_continuous_batching(out):
    assert "outputs identical" in out and "fused engine (paged KV)" in out


CHECKS = {"quickstart": _check_quickstart, "train_sfl_e2e": _check_train_sfl_e2e,
          "resource_allocation_demo": _check_resource_allocation_demo,
          "serve_lora": _check_serve_lora, "continuous_batching": _check_continuous_batching}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(runs, name):
    r = runs[name]
    assert r["rc"] == 0, (name, r["rc"], r["err"][-3000:])
    CHECKS[name](r["out"])


def test_trained_adapters_read_in_repro_as_in_the_port(runs):
    """The train example's file in ``repro``'s reader, with the template
    ``examples/serve_lora.py`` builds, and in the port's codec: the same
    leaves."""
    import jax
    from repro import models as JM
    from repro.checkpoint import restore_pytree as j_restore
    from repro.configs import get_arch as j_get_arch
    from repro.core.lora import split_tree as j_split
    from repro_torch.checkpoint import restore_pytree
    assert runs["train_sfl_e2e"]["rc"] == 0
    cfg = j_get_arch("gpt2-s").reduced(num_layers=6, d_model=256)
    lora = JM.init_lora_stack(cfg, jax.random.key(0), rank=4)
    client, server = j_split(lora, 2)
    template = {"lora_server": server, "lora_client0": client}
    got = j_restore(runs["adapter"], template)
    mine = restore_pytree(runs["adapter"], jax.tree.map(np.asarray, template))
    a, b = jax.tree.leaves(got), jax.tree.leaves(mine)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the server's layers past the client's: the split the allocator chose
    n_client = jax.tree.leaves(got["lora_client0"])[0].shape[0]
    n_server = jax.tree.leaves(got["lora_server"])[0].shape[0]
    assert n_client + n_server == cfg.num_layers
