"""The port's rule table (``repro_torch.sharding.specs``) against
``repro.sharding.specs``, with no processes: every leaf of every ported
config at full size (``repro``'s abstract params; the port's on the
``meta`` device) gets ``repro``'s spec minus the repeat axis, on the
meshes (16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 1); so do the slab
caches and the batch, client-stacked, round and stacked-batch trees.
``repro``'s rules read only ``mesh.shape``/``axis_names`` (an
``AbstractMesh`` there, a stub here).  ``launch.steps.input_specs``
gives ``repro``'s shapes and dtypes.

A spec is compared entry by entry after padding with None to the leaf's
rank and writing a one-axis tuple as its name (JAX does both)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as j_get_arch
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import steps as j_steps
from repro.models import model as JMM
from repro.sharding import specs as JS
from repro_torch.configs import PORTED
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import steps as t_steps
from repro_torch.models import model as TMM
from repro_torch.sharding import specs as TS
from repro_torch.tree import tree_leaves

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 1), ("data", "model"))]
NAMES = [c.name for c in PORTED]


def _meshes(shape, axes):
    try:
        jm = AbstractMesh(tuple(shape), tuple(axes))
    except TypeError:
        jm = AbstractMesh(tuple(zip(axes, shape)))
    tm = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes))
    return jm, tm


def _norm(spec, ndim):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _jpaths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {JS._key_str(kp): leaf for kp, leaf in leaves}


def _layer_path(path, P):
    """The port's layer-i path -> repro's stacked path (pattern position)."""
    parts = path.split("/")
    if parts[0] == "layers":
        parts[1] = str(int(parts[1]) % P)
    return "/".join(parts)


@pytest.fixture(scope="module", autouse=True)
def _traced_once():
    """repro's abstract params and adapters, traced once per (config,
    dtype): input_specs asks for them at every shape."""
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("abstract_params", "abstract_lora"):
            mp.setattr(JMM, fn, functools.lru_cache(maxsize=None)(getattr(JMM, fn)))
        yield


@pytest.fixture(scope="module")
def abstract():
    out = {}
    for name in NAMES:
        jcfg = j_get_arch(name)
        out[name] = (jcfg, JMM.abstract_params(jcfg, jnp.bfloat16),
                     TMM.abstract_params(t_get_arch(name), torch.bfloat16))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_repro(abstract, name, mesh):
    jcfg, jparams, tparams = abstract[name]
    jm, tm = _meshes(*mesh)
    P = len(jcfg.pattern)
    jp = _jpaths(jparams)
    tspecs = TS.path_specs(tparams, tm)
    assert len(tspecs) == sum(
        v.shape[0] if k.startswith("layers/") else 1 for k, v in jp.items())
    sharded = 0
    for path, leaf in TS.tree_paths(tparams):
        jpath = _layer_path(path, P)
        jleaf = jp[jpath]
        stacked = path.startswith("layers/")
        assert tuple(jleaf.shape[1:] if stacked else jleaf.shape) == tuple(leaf.shape), path
        want = _norm(JS.param_spec(jpath, jleaf.shape, jm), len(jleaf.shape))
        if stacked:
            assert want[0] is None
            want = want[1:]
        got = _norm(tspecs[path], leaf.dim())
        assert got == want, (path, got, want)
        sharded += any(e is not None for e in got)
    if mesh[0] == (1, 1):
        assert sharded == 0
    if mesh[0] == (16, 16):
        assert sharded > 0


@pytest.mark.parametrize("mesh", MESHES[:3], ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_repro(name, mesh):
    jcfg, tcfg = j_get_arch(name), t_get_arch(name)
    jm, tm = _meshes(*mesh)
    P = len(jcfg.pattern)
    B, L = 32, 256
    jc = _jpaths(JMM.abstract_cache(jcfg, B, L, jnp.bfloat16))
    tc = TMM.abstract_cache(tcfg, B, L, torch.bfloat16)
    n = 0
    for path, leaf in TS.tree_paths(tc):
        i, rest = path.split("/", 1)
        jpath = f"{int(i) % P}/{rest}"
        jleaf = jc[jpath]
        assert tuple(jleaf.shape[1:]) == tuple(leaf.shape), path
        want = _norm(JS.cache_spec(jpath, jleaf.shape, jm), len(jleaf.shape))[1:]
        got = _norm(TS.cache_spec(path, tuple(leaf.shape), tm), leaf.dim())
        assert got == want, (path, got, want)
        n += 1
    assert n == len(tree_leaves(tc))


def _pair(shapes, dtype=jnp.int32):
    jt = {k: jax.ShapeDtypeStruct(s, dtype) for k, s in shapes.items()}
    tt = {k: torch.empty(s, dtype=torch.int32, device="meta") for k, s in shapes.items()}
    return jt, tt


@pytest.mark.parametrize("mesh", MESHES + [((4,), ("clients",)), ((2,), ("clients",)),
                                           ((3,), ("clients",))],
                         ids=lambda m: "-".join(m[1]) + "x".join(map(str, m[0])))
def test_batch_client_round_stacked_specs_match_repro(mesh):
    jm, tm = _meshes(*mesh)
    shapes = {"tokens": (32, 64), "odd": (6, 64), "vec": (4,), "one": (1, 8)}
    jt, tt = _pair(shapes)
    stacked = {"a": (4, 3, 8, 2), "b": (6, 7), "s": (2,)}
    js, ts = _pair(stacked)
    rounds = {"tokens": (3, 4, 2, 16), "labels": (3, 6, 2, 16), "fe": (3, 4, 2, 8, 5)}
    jr, tr = _pair(rounds)
    pod = {"tokens": (2, 32, 64), "labels": (2, 6, 64), "flat": (16,)}
    jp, tp = _pair(pod)
    cases = [
        (JS.batch_shardings(jt, jm), TS.batch_specs(tt, tm), shapes),
        (JS.client_stacked_shardings(js, jm), TS.client_stacked_specs(ts, tm), stacked),
        (JS.client_batch_shardings(js, jm), TS.client_batch_specs(ts, tm), stacked),
        (JS.round_dynamics_shardings(js, jm), TS.round_dynamics_specs(ts, tm), stacked),
        (JS.round_batch_shardings(jr, jm), TS.round_batch_specs(tr, tm), rounds),
        (JS.stacked_batch_shardings(jp, jm), TS.stacked_batch_specs(tp, tm), pod),
        (JS.lora_shardings(js, jm), TS.lora_specs(ts, tm), stacked),
    ]
    for jsh, tsp, shp in cases:
        for k, s in shp.items():
            assert _norm(tsp[k], len(s)) == _norm(jsh[k].spec, len(s)), (k, tsp[k], jsh[k].spec)
    assert TS.batch_axes(tm) == JS.batch_axes(jm)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_repro(shape):
    """Every ported config: the step's inputs have repro's shapes and
    dtypes (params, adapters and caches per layer in the port)."""
    for name in NAMES:
        jcfg, tcfg = j_get_arch(name), t_get_arch(name)
        assert t_steps.arch_for_shape(tcfg, SHAPES[shape]).attn_window == \
            j_steps.arch_for_shape(jcfg, J_SHAPES[shape]).attn_window
        (jargs, _), (targs, _) = (j_steps.input_specs(jcfg, J_SHAPES[shape]),
                                  t_steps.input_specs(tcfg, SHAPES[shape]))
        assert len(jargs) == len(targs)
        P = len(jcfg.pattern)
        for ja, ta in zip(jargs, targs):
            if isinstance(ta, dict) and "tokens" in ta:        # batch
                assert set(ja) == set(ta)
                for k in ta:
                    assert tuple(ja[k].shape) == tuple(ta[k].shape), (name, k)
                    assert str(ja[k].dtype) == str(ta[k].dtype).replace("torch.", "")
                continue
            jl = _jpaths(ja)
            for path, leaf in TS.tree_paths(ta):
                assert leaf.device.type == "meta"
                parts = path.split("/")
                if parts[0] in ("m", "v"):                    # AdamW moments
                    jpath = f"{parts[0]}/{int(parts[1]) % P}/" + "/".join(parts[2:])
                    lead = 1
                elif parts[0] == "layers":
                    jpath, lead = _layer_path(path, P), 1
                elif parts[0].isdigit() and len(parts) > 1:   # lora / caches
                    jpath, lead = f"{int(parts[0]) % P}/" + "/".join(parts[1:]), 1
                else:
                    jpath, lead = path, 0
                jleaf = jl[jpath]
                assert tuple(jleaf.shape[lead:]) == tuple(leaf.shape), (name, path)
                assert str(jleaf.dtype) == str(leaf.dtype).replace("torch.", ""), (name, path)


def test_shard_and_unshard_world_of_one():
    """With no process group a mesh is a world of one: shard is the
    identity, and so is unshard."""
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    assert mesh.device_mesh is None and mesh.group("data") is None
    t = torch.arange(12.0).reshape(3, 4)
    spec = TS.P(None, "data")
    assert TS.shard(t, spec, mesh) is t and TS.unshard(t, spec, mesh) is t
    with pytest.raises(ValueError, match="world has 1"):
        make_debug_mesh(2, 2)
    stub = types.SimpleNamespace(shape={"data": 2, "model": 1}, axis_names=("data", "model"),
                                 axis_rank=lambda a: 1 if a == "data" else 0)
    np.testing.assert_array_equal(TS.shard(t, TS.P(None, "data"), stub).numpy(),
                                  t[:, 2:].numpy())
