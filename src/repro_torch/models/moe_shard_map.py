"""Expert-parallel MoE with explicit collectives — the port of
``repro.models.moe_shard_map``.

Each rank routes its local tokens, packs per-destination capacity
buffers, exchanges them with ONE equal-split all-to-all over the
``"model"`` group (the expert-parallel dimension), runs its local experts,
and sends the results back with a second all-to-all: the Switch/GShard
schedule, written out (``sharding.collectives.all_to_all_grad``, so the
gradient flows back through both exchanges).

Layout contract, as in ``repro`` (every rank passes its local pieces):
  x        : (B, S, d)  local (B/dp, S/tp, d)   (``shard_moe_input``)
  router   : (d, E)     replicated
  experts  : (E, d, f)  local (E/tp, d, f)      (``shard_moe_params``)
  output   : (B, S, d)  local (B/dp, S/tp, d)

The buffers have a fixed size, ``capacity = ceil(T_local * K / tp *
capacity_factor)`` slots per destination rank; a (token, choice) past it
is dropped (output 0 for that expert slot), earlier tokens and lower
choices first.  A dropped entry writes nothing (``repro`` scatters its
zero into the last slot, where XLA's order of duplicate writes decides
whether it overwrites the token kept there).  The experts are plain
einsums, as in ``repro`` (no Pallas kernel there either).  No aux loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.collectives import all_to_all_grad
from ..sharding.specs import P, shard

DATA, MODEL = "data", "model"      # the token-parallel and expert-parallel axes


def _local_moe(cfg, xb, router_w, w_gate, w_up, w_down, *, tp_size: int,
               capacity: int, group):
    """Per-rank body.  xb: (b_l, s_l, d) local tokens."""
    b_l, s_l, d = xb.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    e_local = E // tp_size
    T = b_l * s_l
    x = xb.reshape(T, d)

    # ---- routing (f32) ----------------------------------------------------
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1, sorted=True)           # (T, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- pack per-destination-rank capacity buffers -----------------------
    flat_ids = ids.reshape(T * K)
    flat_gates = gates.reshape(T * K)
    dest = torch.div(flat_ids, e_local, rounding_mode="floor")      # (T*K,) rank
    onehot = F.one_hot(dest, tp_size)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)     # slot per dest
    keep = slot < capacity
    slot = torch.where(keep, slot, capacity - 1)
    tok_idx = torch.arange(T * K, device=x.device) // K
    kd, ks = dest[keep], slot[keep]
    send_x = torch.zeros((tp_size, capacity, d), dtype=xb.dtype, device=x.device)
    send_x = send_x.index_put((kd, ks), x[tok_idx[keep]])
    send_eid = torch.full((tp_size, capacity), -1, dtype=torch.int64, device=x.device)
    send_eid[kd, ks] = flat_ids[keep] % e_local

    # ---- exchange: tokens travel to their expert's rank --------------------
    recv_x = all_to_all_grad(send_x.reshape(tp_size * capacity, d), group)
    recv_eid = all_to_all_grad(send_eid.reshape(tp_size * capacity), group)
    # recv_*: tp_size blocks of capacity rows — block s came from rank s

    # ---- local expert FFN (dense per-local-expert dispatch) ----------------
    disp = (F.one_hot(recv_eid.clamp_min(0), e_local).to(xb.dtype)
            * (recv_eid >= 0)[:, None].to(xb.dtype))                 # (T_r, e_l)
    xd = torch.einsum("te,td->etd", disp, recv_x)
    hg = torch.einsum("etd,edf->etf", xd, w_gate.to(xb.dtype))
    hu = torch.einsum("etd,edf->etf", xd, w_up.to(xb.dtype))
    h = F.silu(hg.float()).to(xb.dtype) * hu
    yd = torch.einsum("etf,efd->etd", h, w_down.to(xb.dtype))
    y_tok = torch.einsum("etd,te->td", yd, disp)                     # (T_r, d)

    # ---- exchange back ------------------------------------------------------
    back = all_to_all_grad(y_tok, group).reshape(tp_size, capacity, d)

    # ---- unpack: gather each (token, choice) result, weight by gate --------
    contrib = back[dest, slot].float()                               # (T*K, d)
    contrib = torch.where(keep[:, None], contrib, 0.0) * flat_gates[:, None]
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, tok_idx, contrib)
    return out.reshape(b_l, s_l, d).to(xb.dtype)


def moe_capacity(t_local: int, experts_per_token: int, tp_size: int,
                 capacity_factor: float) -> int:
    """Slots per destination rank: ceil(T_local K / tp * capacity_factor)."""
    return max(1, int(math.ceil(t_local * experts_per_token / tp_size * capacity_factor)))


def apply_moe_shard_map(cfg, p: dict, x: torch.Tensor, mesh, *,
                        capacity_factor: float = 1.25) -> torch.Tensor:
    """Drop-in MoE FFN with explicit all-to-all scheduling (no aux loss).
    ``x`` and the experts of ``p`` are this rank's pieces (module doc), so
    ``repro``'s ``dp_axes``, which it needs to find the local token count
    in the whole x, is not needed here; the exchange runs over the
    ``"model"`` group alone."""
    b_l, s_l, _ = x.shape
    tp_size = mesh.shape.get(MODEL, 1)
    if cfg.num_experts % tp_size:
        raise ValueError(f"{cfg.num_experts} experts over {tp_size} ranks")
    capacity = moe_capacity(b_l * s_l, cfg.experts_per_token, tp_size, capacity_factor)
    return _local_moe(cfg, x, p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"],
                      tp_size=tp_size, capacity=capacity, group=mesh.group(MODEL))


def shard_moe_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (B/dp, S/tp, d) piece of a whole (B, S, d) input."""
    return shard(x, P((DATA,), MODEL, None), mesh)


def shard_moe_params(p: dict, mesh) -> dict:
    """An MoE block's params with the experts cut to this rank's E/tp
    (the router, and a shared expert if any, whole)."""
    out = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = shard(p[k], P(MODEL, None, None), mesh)
    return out
