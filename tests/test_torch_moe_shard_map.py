"""The expert-parallel MoE (``models.moe_shard_map``) over a (2, 2)
("data", "model") gloo group of 4 ranks, at ``repro``'s test config (E 4,
top 2, d 64, ffn 32; x (4, 16, 64) cut to (2, 8, 64) a rank, 2 experts
a rank, capacity factor 16: no drops): the assembled output against
``repro``'s einsum ``apply_moe(group_size=1, capacity_factor=4.0)``
within 2e-4, as ``tests/test_moe_shard_map.py`` holds ``repro``'s own;
the gradient of sum(y * ct) with respect to x, back through both
all-to-alls, against autograd through the port's ``apply_moe`` (no
drops) within 2e-4; and the capacity formula against ``repro``'s."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as C
from repro.configs import get_arch as j_get_arch
from repro.models.moe import apply_moe as j_apply_moe
from repro.models.moe import init_moe as j_init_moe
from repro_torch.models.moe import apply_moe
from repro_torch.models.moe_shard_map import moe_capacity

TIMEOUT = 150


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    m = C.MOE
    jcfg = j_get_arch("olmoe-1b-7b").reduced(d_model=m["d"]).replace(
        num_experts=m["E"], experts_per_token=m["top"], d_ff=m["ff"])
    p = j_init_moe(jcfg, jax.random.key(0), jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(1), (m["B"], m["S"], m["d"])) * 0.5)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    inputs = {"moe_params": jax.tree.map(np.asarray, p), "moe_x": x, "moe_ct": ct}
    procs, out = C.spawn("moe", 4, tmp, inputs)
    y_ref = np.asarray(j_apply_moe(jcfg, p, jnp.asarray(x), group_size=1,
                                   capacity_factor=4.0)[0])
    cfg, tp, tx, tct = C.moe_setup(inputs)
    tx.requires_grad_()
    (apply_moe(cfg, tp, tx, group_size=1, capacity_factor=4.0)[0] * tct).sum().backward()
    ranks = C.collect(procs, out, TIMEOUT)
    y, dx = np.zeros_like(x), np.zeros_like(x)
    b, s = m["B"] // 2, m["S"] // 2
    for r in ranks:
        i, j = r["moe"]["coord"]
        y[i * b:(i + 1) * b, j * s:(j + 1) * s] = r["moe"]["y"]
        dx[i * b:(i + 1) * b, j * s:(j + 1) * s] = r["moe"]["dx"]
    return {"y": y, "dx": dx, "y_ref": y_ref, "dx_ref": tx.grad.numpy(),
            "coords": sorted(r["moe"]["coord"] for r in ranks)}


def test_shard_map_matches_repro_einsum(runs):
    assert runs["coords"] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert np.abs(runs["y"] - runs["y_ref"]).max() < 2e-4
    assert np.abs(runs["y_ref"]).max() > 1e-2


def test_shard_map_gradient_matches_apply_moe(runs):
    assert np.abs(runs["dx"] - runs["dx_ref"]).max() < 2e-4
    assert np.abs(runs["dx_ref"]).max() > 1e-2


@pytest.mark.parametrize("t_local,k,tp,cf", [(16, 2, 2, 16.0), (256, 8, 2, 1.25),
                                             (3, 1, 4, 0.1)])
def test_capacity_formula(t_local, k, tp, cf):
    assert moe_capacity(t_local, k, tp, cf) == max(1, int(math.ceil(t_local * k / tp * cf)))


def test_world_of_one_is_the_identity_exchange():
    """With no process group the all-to-alls are the identity and the
    shard map is the no-drop einsum MoE (the one-rank layout)."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe_shard_map import apply_moe_shard_map
    cfg = C.get_arch("olmoe-1b-7b").reduced(d_model=32).replace(
        num_experts=4, experts_per_token=2, d_ff=16)
    from repro_torch.models.moe import init_moe
    p = init_moe(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
    y = apply_moe_shard_map(cfg, p, x, make_debug_mesh(1, 1), capacity_factor=8.0)
    y_ref, _ = apply_moe(cfg, p, x, group_size=1, capacity_factor=4.0)
    assert float((y - y_ref).abs().max()) < 1e-5
