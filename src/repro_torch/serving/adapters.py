"""Tenant adapter registry: a device-resident LoRA pool managed like the KV
page pool of ``paging.py`` — the port of ``repro.serving.adapters``.

Federated training emits one LoRA adapter per fleet or tenant; serving
them all from one engine turns the engine's adapter tree into a POOL: each
layer's leaves grow a leading adapter axis, (A, r, in) and (A, out, r)
(the port keeps one dict per layer, so there is no repeat axis), and each
serving slot carries an index into it (``engine._aslot``), read row by row
by the gather kernel of ``kernels.lora_matmul_gathered``.

* Host mirror: which tenant holds which pool slot is plain Python; every
  published adapter keeps a host copy (CPU tensors).
* LRU paging: when all ``pool_size`` slots are taken, ``acquire`` evicts
  the least recently used slot whose tenant is not pinned (pinned =
  tenants of live engine slots, which a running decode batch gathers
  from) and loads the cold tenant from its host copy.
* Hot swap: ``publish`` of a new version of a RESIDENT tenant overwrites
  its slot in place.
* Versions: ``version(tenant)`` counts publishes.

Every load and hot swap is a ``copy_`` into the pool slot, so each pool
tensor keeps its storage (``data_ptr``) for the registry's life: the eager
counterpart of ``repro``'s one compiled, donated loader, and what lets a
swap land between two decode steps without the engine noticing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..kernels.backend import resolve_device
from ..models import model as model_mod
from ..tree import tree_leaves, tree_map


def _structure(tree: Any) -> Any:
    """The container skeleton of a tree (keys and list lengths), leaves
    replaced by None, for a structure check."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


class AdapterRegistry:
    """``pool_size`` device-resident adapter slots for any number of
    tenants, with host paging and LRU eviction.

    ``rank``/``dtype`` fix the pool's leaf shapes: every tenant shares
    them (the uniform-fleet serving shape).  A tree of another structure
    or rank raises ``ValueError`` at publish, as ``repro``'s
    ``_check_tree`` does (its class docstring's "hetero ranks zero-pad at
    publish" is not what its code does).  ``device="cuda"`` without a card
    raises."""

    def __init__(self, cfg, pool_size: int, rank: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self.cfg = cfg
        self.pool_size = pool_size
        self.rank = rank or cfg.lora_rank
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        template = model_mod.init_lora_stack(cfg, torch.Generator().manual_seed(0),
                                             self.rank, dtype, "cpu")
        if not tree_leaves(template):
            raise ValueError("cfg.lora_targets produced an empty adapter tree — "
                             "nothing to serve per tenant")
        self._shapes = [tuple(t.shape) for t in tree_leaves(template)]
        self._skeleton = _structure(template)
        self.pool = tree_map(
            lambda t: torch.zeros((pool_size,) + tuple(t.shape), dtype=dtype, device=dev),
            template)

        # host-side mirrors: slot ownership, LRU clock, host copies, versions
        self._slot_tenant: List[Optional[int]] = [None] * pool_size
        self._tenant_slot: Dict[int, int] = {}
        self._host: Dict[int, List[torch.Tensor]] = {}
        self._version: Dict[int, int] = {}
        self._clock = 0
        self._last_used = [0] * pool_size
        self.stats = {"swaps": 0, "hot_swaps": 0, "evictions": 0}

    # ------------------------------------------------------------------
    def _check_tree(self, adapter) -> None:
        if _structure(adapter) != self._skeleton:
            raise ValueError(f"adapter tree mismatch: expected {self._skeleton}, "
                             f"got {_structure(adapter)}")
        for want, leaf in zip(self._shapes, tree_leaves(adapter)):
            if tuple(leaf.shape) != want:
                raise ValueError(f"adapter leaf shape {tuple(leaf.shape)} != pool slot "
                                 f"shape {want} (rank mismatch?)")

    def _load(self, slot: int, tenant: int) -> None:
        """Copy ``tenant``'s host copy into pool slot ``slot`` in place."""
        with torch.no_grad():
            for p, h in zip(tree_leaves(self.pool), self._host[tenant]):
                p[slot].copy_(h)

    def publish(self, tenant: int, adapter) -> int:
        """Install (a new version of) ``tenant``'s adapter: the host copy is
        always updated; a RESIDENT tenant is hot-swapped in place.  Returns
        the new version number."""
        self._check_tree(adapter)
        self._host[tenant] = [t.detach().to("cpu", copy=True) for t in tree_leaves(adapter)]
        self._version[tenant] = self._version.get(tenant, 0) + 1
        s = self._tenant_slot.get(tenant)
        if s is not None:
            self._load(s, tenant)
            self.stats["hot_swaps"] += 1
        return self._version[tenant]

    # ``register`` reads better at first install; same operation
    register = publish

    def version(self, tenant: int) -> int:
        return self._version.get(tenant, 0)

    def resident(self, tenant: int) -> bool:
        return tenant in self._tenant_slot

    def slot_of(self, tenant: int) -> Optional[int]:
        return self._tenant_slot.get(tenant)

    def tenants(self):
        return sorted(self._host)

    # ------------------------------------------------------------------
    def acquire(self, tenant: int, pinned=frozenset()) -> int:
        """The pool slot holding ``tenant``'s adapter, paged in from its
        host copy if cold.  ``pinned`` tenants (live engine slots) are
        never evicted; raises ``RuntimeError`` when every slot is pinned
        (the engine sizes ``pool_size >= max_slots`` so that only happens
        to callers that misuse it) and ``KeyError`` for a tenant never
        published."""
        if tenant not in self._host:
            raise KeyError(f"tenant {tenant} was never published")
        self._clock += 1
        s = self._tenant_slot.get(tenant)
        if s is not None:
            self._last_used[s] = self._clock
            return s
        free = [i for i, t in enumerate(self._slot_tenant) if t is None]
        if free:
            s = free[0]
        else:
            victims = [i for i, t in enumerate(self._slot_tenant) if t not in pinned]
            if not victims:
                raise RuntimeError(f"adapter pool exhausted: all {self.pool_size} "
                                   "slots pinned by live requests")
            s = min(victims, key=lambda i: self._last_used[i])
            del self._tenant_slot[self._slot_tenant[s]]
            self.stats["evictions"] += 1
        self._slot_tenant[s] = tenant
        self._tenant_slot[tenant] = s
        self._last_used[s] = self._clock
        self._load(s, tenant)
        self.stats["swaps"] += 1
        return s

    def load_compiles(self) -> int:
        """1, for ``repro``'s interface: every load and hot swap is the same
        in-place copy (``repro`` counts its one compiled loader here)."""
        return 1
