"""KV page allocator: a free-list stack held in int32 tensors on the
engine's device, with the semantics of ``repro.serving.paging``.

Page 0 is the NULL page: block tables are zero-initialised, dead slots
write their (garbage) KV there, and the allocator never hands it out —
``init_pager`` stacks pages [1, num_pages) over a sentinel 0 that ``head``
never reaches while the engine's reservation invariant holds.

Every operation is fixed-shape tensor code (no host round trip):

* ``alloc_pages``: vectorised multi-pop.  Requesters are ranked by a
  cumsum over the request mask and read ``free[head - 1 - rank]``;
  non-requesting lanes get the null page.  All-or-nothing: if the stack
  holds fewer pages than requested nobody allocates (``ok`` false).
* ``free_pages``: vectorised multi-push of every non-null page of the
  masked block-table rows.  Lanes that push nothing scatter into one
  extra slot past the stack, which is then cut off (JAX's ``mode="drop"``).
  The freed rows come back zeroed (all-null).
"""
from __future__ import annotations

import torch

from ..kernels.backend import resolve_device

NULL_PAGE = 0


def init_pager(num_pages: int, device="cuda") -> dict:
    """Free-list stack over pages [1, num_pages): ``free[:head]`` are the
    available page ids (top of stack at ``head - 1``)."""
    device = resolve_device(device)
    free = torch.cat([torch.arange(1, num_pages, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32)]).to(device)
    return {"free": free,
            "head": torch.tensor(num_pages - 1, dtype=torch.int32, device=device)}


def alloc_pages(pager: dict, need: torch.Tensor):
    """Pop one page per True lane of ``need`` (bool (B,)), all-or-nothing.

    Returns (pager, pages (B,) int32, ok 0-d bool) — non-requesting lanes
    (and every lane when ``ok`` is False) get NULL_PAGE."""
    free, head = pager["free"], pager["head"]
    need = need.to(torch.int32)
    n = need.sum(dtype=torch.int32)
    ok = n <= head
    take = need * ok.to(torch.int32)
    rank = torch.cumsum(take, 0, dtype=torch.int32) - take
    idx = torch.clamp(head - 1 - rank, 0, free.shape[0] - 1).long()
    pages = torch.where(take.bool(), free[idx], torch.zeros_like(take))
    head = head - n * ok.to(torch.int32)
    return {"free": free, "head": head}, pages.to(torch.int32), ok


def free_pages(pager: dict, block_tables: torch.Tensor, mask: torch.Tensor):
    """Push every non-null page of the masked rows back onto the stack.

    block_tables: (S, MP) int32; mask: bool (S,) — rows to free.  Returns
    (pager, block_tables) with the freed rows zeroed."""
    free, head = pager["free"], pager["head"]
    NP = free.shape[0]
    flat_p = block_tables.reshape(-1)
    flat_m = (mask[:, None] & (block_tables != NULL_PAGE)).reshape(-1)
    fm = flat_m.to(torch.int32)
    rank = torch.cumsum(fm, 0, dtype=torch.int32) - fm
    dest = torch.where(flat_m, torch.clamp(head + rank, max=NP),
                       torch.full_like(rank, NP))
    ext = torch.cat([free, free.new_zeros(1)]).scatter(0, dest.long(), flat_p)
    head = head + fm.sum(dtype=torch.int32)
    bt = torch.where(mask[:, None], torch.zeros_like(block_tables), block_tables)
    return {"free": ext[:NP], "head": head}, bt
