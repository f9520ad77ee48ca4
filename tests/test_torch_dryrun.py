"""The port's dry-run and its analysis (``launch.dryrun``, ``analysis.
cost``/``roofline``/``report``, the kernels' abstract route).

The fake process group is global to a process, so the mesh cases run in
one subprocess (``SCRIPT``), as ``test_dryrun_small.py`` runs ``repro``'s:

* ``test_dryrun_small``'s four pairs (reduced configs, S <= 512, B 8) on
  a fake (4, 2) mesh, rank 3: they finish and report a dominant term;
* a reduced yi-9b prefill on a (1, 1) mesh: its matmul FLOPs equal the
  closed form, through the einsum route and through the kernel route
  (``dense_impl="fused"``, ``decode_attn_impl="flash"``);
* a tensor-parallel train step of reduced yi-9b on (1, 2), no remat: its
  collectives equal the closed form at ``hlo_cost``'s wire convention;
  two all-reduces a layer forward, their conjugates backward, the
  vocabulary-parallel embedding and loss, the LoRA factors' gradients
  and the pool's sums.

In this process: ``model_flops`` against ``repro``'s for every assigned
architecture and shape; the report's tables and summary against
``repro``'s on the same rows; a fake tensor reaching a kernel never runs
the plain version; a ``meta`` tensor outside the count raises; a real
tensor's launch goes through its kernel's custom op (once a call) only
within ``backend.as_ops`` for that kernel.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PAIRS = [("deepseek-7b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
         ("mamba2-2.7b", "decode_32k"), ("jamba-1.5-large-398b", "prefill_32k")]
B, S = 2, 16                      # the closed forms' batch and sequence

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.analysis.roofline import build_report
    from repro_torch.launch.dryrun import evaluate, fake_device
    from repro_torch.launch.mesh import init_fake, make_mesh

    pairs, B, S = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out = {"pairs": {}}
    init_fake(8, 3)
    mesh = make_mesh((4, 2), ("data", "model"), fake_device())
    for arch, name in pairs:
        base = get_arch(arch)
        cfg = base.reduced(num_layers=max(2, len(base.pattern)), d_model=256)
        shape = dataclasses.replace(SHAPES[name], seq_len=min(SHAPES[name].seq_len, 512),
                                    global_batch=8)
        cfg, cost, _ = evaluate(cfg, shape, mesh, {"kv_chunk": 128})
        rep = build_report(arch=arch, shape_cfg=shape, mesh_name="4x2", chips=8,
                           cost=cost, cfg=cfg)
        out["pairs"][arch + "/" + name] = {
            "flops": rep.flops, "bytes": rep.bytes_accessed, "coll": rep.coll_bytes,
            "dominant": rep.dominant, "args": cost.argument_bytes,
            "peak": cost.peak_bytes}
    yi = get_arch("yi-9b").reduced(num_layers=2, d_model=64)
    pre = dataclasses.replace(SHAPES["prefill_32k"], seq_len=S, global_batch=B)
    init_fake(1, 0)
    one = make_mesh((1, 1), ("data", "model"), fake_device())
    out["flops"] = {}
    for route, rt in (("einsum", {}), ("fused", {"dense_impl": "fused",
                                                 "decode_attn_impl": "flash"})):
        _, cost, _ = evaluate(yi, pre, one, rt)
        out["flops"][route] = cost.flops_by_op
    init_fake(2, 1)
    tp = make_mesh((1, 2), ("data", "model"), fake_device())
    train = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
    _, cost, _ = evaluate(yi, train, tp, {"remat": False})
    out["calls"] = [[k, n, list(r)] for k, n, r in cost.coll_calls]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """The subprocess, started before the module's first test so that it
    runs beside the in-process ones."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(PAIRS), str(B), str(S)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    proc.kill()


@pytest.fixture(scope="module")
def fake_runs(spawned):
    out, err = spawned.communicate(timeout=300)
    assert spawned.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_model_flops_match_repro(monkeypatch):
    import functools
    from repro.analysis.roofline import model_flops as j_model_flops
    from repro.configs import ASSIGNED
    from repro.configs import get_arch as j_get_arch
    from repro.configs import get_shape as j_get_shape
    from repro.models import model as JMM
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPES
    # repro counts its parameters by tracing the init: once per config
    monkeypatch.setattr(JMM, "num_active_params",
                        functools.lru_cache(maxsize=None)(JMM.num_active_params))
    for a in ASSIGNED:
        for name, shape in SHAPES.items():
            assert model_flops(get_arch(a.name), shape) == j_model_flops(
                j_get_arch(a.name), j_get_shape(name)), (a.name, name)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_small_mesh_dryrun(fake_runs, arch, shape):
    rep = fake_runs["pairs"][f"{arch}/{shape}"]
    assert rep["flops"] > 0 and rep["bytes"] > 0 and rep["args"] > 0
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["coll"] > 0            # the base is cut over both axes


def _yi():
    from repro_torch.configs import get_arch
    return get_arch("yi-9b").reduced(num_layers=2, d_model=64)


def _prefill_matmul_flops(cfg) -> int:
    """A prefill of B x S on one device: the projections and the LoRA
    factors of every token, the full-square score and value products of
    the online softmax (one KV chunk), the unembedding of the last
    token."""
    T, d, H, KH, hd, ff = B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, cfg.d_ff
    dims = {"q": (d, H * hd), "k": (d, KH * hd), "v": (d, KH * hd), "o": (H * hd, d)}
    layer = sum(2 * T * i * o for i, o in dims.values()) + 3 * 2 * T * d * ff
    layer += sum(2 * T * cfg.lora_rank * sum(dims[t]) for t in cfg.lora_targets)
    layer += 2 * 2 * B * H * S * S * hd
    return cfg.num_layers * layer + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("route", ["einsum", "fused"])
def test_prefill_flops_equal_the_closed_form(fake_runs, route):
    by_op = fake_runs["flops"][route]
    assert sum(by_op.values()) == _prefill_matmul_flops(_yi())
    if route == "fused":              # the projections with an adapter: the kernel
        assert by_op["repro_torch.kernel_lora_matmul"] > 0


def test_kernel_route_counts_the_einsum_routes_work(fake_runs):
    assert sum(fake_runs["flops"]["fused"].values()) == sum(
        fake_runs["flops"]["einsum"].values())


def _tp_train_calls(cfg):
    """(kind, wire bytes, group) of every collective of one tensor-parallel
    train step at (1, 2) without remat: bf16 activations and adapters,
    f32 losses.  Wire bytes: the larger of input and output, an
    all-reduce twice that."""
    L, d, r = cfg.num_layers, cfg.d_model, cfg.lora_rank
    act = B * S * d * 2
    rows = B * S * 4
    model, data = [0, 1], [1]
    ar = lambda n, g=model: ("all-reduce", 2 * n, g)          # noqa: E731
    outs = {"q": cfg.num_heads * cfg.head_dim, "v": cfg.num_kv_heads * cfg.head_dim}
    calls = [ar(act)]                                       # the vocabulary-parallel lookup
    calls += [ar(act)] * (2 * L)                            # attention and MLP exits
    calls += [ar(rows)] * 3                                 # the loss's max, sum-exp, gold
    calls += [ar(4, data)]                                  # the pool's valid labels
    calls += [ar(act)]                                      # the unembedding's entry, back
    calls += [ar(act)] * L                                  # the MLP entries, back
    calls += [ar(act)] * (L - 1)                            # attention entries past layer 0
    for t in cfg.lora_targets:                              # dA summed, dB gathered
        calls += [ar(r * d * 2)] * L + [("all-gather", outs[t] * r * 2, model)] * L
    n_lora = L * sum(r * (d + outs[t]) for t in cfg.lora_targets)
    calls += [ar(4 * n_lora, data), ar(4 * 2, data)]        # the pool's gradients, metrics
    return calls


def test_tp_train_collectives_equal_the_closed_form(fake_runs):
    got = sorted(tuple(c[:2]) + (tuple(c[2]),) for c in fake_runs["calls"])
    want = sorted((k, n, tuple(g)) for k, n, g in _tp_train_calls(_yi()))
    assert got == want


def _rows():
    def row(arch, shape, mesh, dom, colls):
        return {"arch": arch, "shape": shape, "mesh": mesh, "compile_s": 1.25,
                "memory_analysis": {"argument_size_in_bytes": 3 << 30,
                                    "temp_size_in_bytes": 5 << 20},
                "collectives": colls,
                "roofline": {"t_compute": 0.0123, "t_memory": 1.5e-4, "t_collective": 2.0,
                             "dominant": dom, "model_flops_global": 1.2e15,
                             "useful_ratio": 0.4567, "flops_per_device": 3.3e12,
                             "coll_bytes_per_device": 7 << 30}}
    colls = {"all-reduce": {"count": 4.0, "bytes": 1 << 20},
             "all-gather": {"count": 2.0, "bytes": 3 << 30},
             "all-to-all": {"count": 0.0, "bytes": 0.0}}
    return [row("yi-9b", "train_4k", "16x16", "collective", colls),
            row("yi-9b", "long_500k", "16x16", "memory", {}),
            row("mamba2-2.7b", "decode_32k", "2x16x16", "compute", colls)]


@pytest.mark.parametrize("fn", ["roofline_table", "dryrun_table", "summary"])
def test_report_prints_repros_tables(fn, fake_runs):
    from repro.analysis import report as J
    from repro_torch.analysis import report as T
    rows = _rows()
    assert getattr(T, fn)(rows) == getattr(J, fn)(rows)


def test_report_reads_the_dryruns_json(tmp_path):
    from repro_torch.analysis import report as T
    for i, r in enumerate(_rows()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    rows = T.load(str(tmp_path))
    assert len(rows) == 3 and "| yi-9b | train_4k |" in T.roofline_table(rows)


def test_a_fake_tensor_never_runs_the_plain_version(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lora_matmul import ops as lm_ops
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    def boom(*a, **k):
        raise AssertionError("the plain version ran")
    for mod, name in ((lm_ops, "lora_matmul_ref"), (fa_ops, "flash_decode_ref"),
                      (ss_ops, "ssd_scan_ref"), (ss_ops, "ssd_chunked")):
        monkeypatch.setattr(mod, name, boom)
    with FakeTensorMode():
        x, w = torch.empty(8, 64), torch.empty(64, 32)
        a, b = torch.empty(4, 64), torch.empty(32, 4)
        assert lm_ops.lora_matmul(x, w, a, b, scale=2.0).shape == (8, 32)
        q, k = torch.empty(2, 1, 4, 16), torch.empty(2, 32, 2, 16)
        lengths = torch.empty(2, dtype=torch.int32)
        assert fa_ops.flash_decode(q, k, k, lengths).shape == (2, 1, 4, 16)
        xh, Bm = torch.empty(1, 64, 2, 8), torch.empty(1, 64, 16)
        dt, A = torch.empty(1, 64, 2), torch.empty(2)
        y, h = ss_ops.ssd_scan_with_state(xh, Bm, Bm, dt, A, chunk=32)
        assert y.shape == (1, 64, 2, 8) and h.shape == (1, 2, 8, 16)


def test_a_meta_tensor_outside_the_count_raises():
    from repro_torch.kernels import backend
    from repro_torch.kernels.lora_matmul import ops as lm_ops
    x, w = torch.empty(8, 64, device="meta"), torch.empty(64, 32, device="meta")
    a, b = torch.empty(4, 64, device="meta"), torch.empty(32, 4, device="meta")
    with pytest.raises(ValueError, match="abstract evaluation"):
        lm_ops.lora_matmul(x, w, a, b, scale=2.0)
    backend.define_ops()
    with backend.abstract_evaluation():
        assert lm_ops.lora_matmul(x, w, a, b, scale=2.0).shape == (8, 32)


def test_a_real_launch_takes_the_op_only_within_as_ops(monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import backend
    from repro_torch.kernels.lora_matmul import lora_matmul_ref
    from repro_torch.kernels.lora_matmul import ops as lm_ops
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 64, generator=g), torch.randn(64, 32, generator=g)
    a, b = torch.randn(4, 64, generator=g), torch.randn(32, 4, generator=g)
    routed = []
    through = backend._through_op
    monkeypatch.setattr(backend, "_through_op",
                        lambda op, *rest: routed.append(op) or through(op, *rest))
    backend.define_ops()
    want = lora_matmul_ref(x, w, a, b, 2.0)
    for ops, via_op in ((None, True), (("lora_matmul",), True), (("flash_decode",), False),
                        ((), False)):
        routed.clear()
        ctx = backend.as_ops(ops) if ops != () else contextlib.nullcontext()
        with FlopCounterMode(display=False) as fc, ctx:
            got = lm_ops.lora_matmul(x, w, a, b, scale=2.0)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        names = {str(k) for k in fc.get_flop_counts()["Global"]}
        # one custom op a call (the launch inside it is bare), else the
        # plain version's products
        assert routed == (["lora_matmul"] if via_op else []), ops
        assert ("repro_torch.kernel_lora_matmul" in names) == via_op, names
        assert fc.get_total_flops() == lm_ops.lora_flops(8, 64, 32, 4)
