"""Continuous-batching serving engine — the port of the paged, slab and
naive paths of ``repro.serving.engine``, serving one adapter or, on the
paged path, many tenants' adapters at once.

``max_slots`` sequences decode together.  Where the KV lives:

* PAGED (the default where eligible: ``max_len % page_size == 0``): a
  global page pool ``(KH, num_pages, page_size, D)`` per layer, addressed
  through per-slot ``(max_pages,)`` block tables.  Pages allocate and
  free as tensor code (``serving.paging``); admission is reservation-based
  FIFO — the host mirrors a conservative free-page count and admits a
  request only when its worst-case demand ``ceil(min(P + max_new,
  max_len) / page_size)`` fits, so the on-device allocator never
  underflows (head-of-line backpressure otherwise).  Prefill is chunked:
  prompts stream through ``paged_prefill_chunk`` one page at a time.
* SLAB (``paged=False``, or a ``max_len`` that pages do not divide): one
  ``(max_slots, max_len, KH, D)`` cache per layer plus a ``(max_slots,
  max_len)`` position row.  Admission prefills the prompt into a
  power-of-two length bucket (``bucket_len``; exact length for prompts
  past the largest bucket) and writes the bucket's KV into slot ``s`` in
  place; the decode step runs ``decode_step`` on all slots at their own
  positions, the ``flash_decode`` kernel reading the cache in place.
  A Mamba2 layer keeps a fixed-size recurrent state per slot instead
  ({"ssm", "conv"}): prompts prefill at exact length (no buckets: a pad
  tail would run through the recurrence) and admission overwrites slot
  ``s``'s whole state.  A free slot keeps decoding on garbage state that
  nothing reads until the next admission replaces all of it.
* NAIVE (``fused=False``, slab only): ``repro``'s measured baseline —
  exact-length prefill into a full ``max_len`` cache that replaces the
  whole cache tree on admission (a copy, as JAX's non-donated update),
  and a per-slot decode at batch 1 with host-side bookkeeping.

The fused steps keep their state on the device: the decode, the sampling
and the per-slot bookkeeping run as tensor code, and one host read per
step brings back the (slots,) next tokens and done flags.  Token ``t`` of
request ``uid`` is sampled from a generator seeded by ``(seed, uid, t)``
alone, so outputs do not depend on arrival order, slot, page layout or
engine mode (``models.generate``).

MULTI-TENANT (``adapters=``, paged only): an ``AdapterRegistry``'s device
pool replaces the single adapter.  Admission pins the tenants of the live
slots and ``acquire``s the request's adapter (LRU paging from host
copies); every prefill chunk runs with that adapter sliced out of the pool
(the single-adapter ``lora_matmul``), and the decode step gathers each
slot's adapter by its pool index (``adapter_idx=self._aslot``: the gather
kernel on the card).  Sampling streams carry the tenant, and
``tenant_quota`` caps a tenant's live slots.

FAILURE HANDLING (paged engine only; the slab and naive paths are left as
they are, as in ``repro``): the decode step also takes per-slot eviction
flags, a per-slot residency deadline and a NaN-injection mask —

* preemption: under page pressure (``preempt=True``) the host flags a
  live victim of strictly lower priority than the stalled queue head; a
  victim (or a slot past its ``deadline_steps``) frees its pages in the
  step, before the page allocation, still runs through the batched decode
  against its zeroed block-table row (its KV write lands in the null
  page), is not sampled, and requeues for a chunked prefill of its prompt
  plus its delivered tokens, which resumes its own sampling stream — with
  greedy sampling the finished output equals an unpreempted run's;
* NaN/inf sentinel: a slot whose logits are not finite (a blow-up, or an
  injected poke) is quarantined — its pages freed, ``Request.error`` set
  — and the sampler sees zeros in its row, never the NaNs;
* ``check_consistency()`` audits the host reservation mirror against the
  pager when the engine drains and resyncs it (``stats["resyncs"]``).

All-false fault masks leave every token id as it was, and the step's
next tokens, done, victim and quarantine flags come back in one host
read.  ``faults.ServingFaults`` drives these hooks.
"""
from __future__ import annotations

import collections
import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..interop import tree_to
from ..kernels.backend import resolve_device
from ..models import model as model_mod
from ..models.generate import SampleConfig, sample_logits_per_key
from ..models.stack import Runtime, default_serve_runtime
from ..tree import tree_map
from . import paging


class AdmissionError(ValueError):
    """A request the engine can NEVER serve, rejected at ``submit()`` with
    a typed reason (``empty-prompt`` | ``prompt-too-long``)."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1
    priority: int = 0              # preemption: lower loses its slot first
    deadline_steps: Optional[int] = None   # max decode steps per residency
    tenant: int = 0                # adapter owner (multi-tenant serving)
    # filled by the engine
    output: List[int] = field(default_factory=list)
    done: bool = False
    preempted: int = 0             # times evicted and requeued
    error: Optional[str] = None    # quarantine reason (non-finite logits)


def bucket_len(n: int, max_len: int) -> int:
    """Smallest power of two >= n (floor 8), capped at the largest power
    of two <= max_len, so mixed prompt lengths run at most log2(max_len)
    prefill shapes.  A prompt past the cap (only under a non-power-of-two
    ``max_len``) has no bucket: the engine prefills it at exact length,
    and asking here raises."""
    b = 8
    while b < n:
        b *= 2
    b = min(b, 1 << (max_len.bit_length() - 1))
    if b < n:
        raise ValueError(f"prompt length {n} exceeds the largest bucket {b} for "
                         f"max_len={max_len}; gap prompts prefill at exact length")
    return b


class ServingEngine:
    """``params``/``lora`` are the port's trees (``models.init_params`` /
    ``init_lora_stack``, or ``interop.params_from_numpy``); they are moved
    to ``device`` and cast to ``dtype``, the dtype the KV is kept in too.
    ``paged=None`` picks the paged pool when the engine is fused, the
    pattern attention-only and unwindowed, and ``page_size`` divides
    ``max_len``, else the slab; ``paged=True`` raises where the pool does
    not apply.  ``fused=False`` is the naive slab loop.
    ``adapters`` (an ``AdapterRegistry`` on the engine's device) serves
    many tenants' adapters instead of ``lora``; it needs the paged engine
    and ``pool_size >= max_slots``.  ``tenant_quota`` caps each tenant's
    live slots (0 = no cap; only with ``adapters``).  ``preempt=True``
    (paged) lets a stalled higher-priority request evict a lower-priority
    one.  ``device="cuda"`` without a card raises.  A front-end arch
    (``cfg.frontend``: internvl2-2b, musicgen-large) raises
    ``NotImplementedError``, as ``repro``'s engine does; ``generate``
    serves those with their prefix."""

    def __init__(self, cfg, params, *, lora=None, rt: Optional[Runtime] = None,
                 max_slots: int = 4, max_len: int = 256,
                 sc: SampleConfig = SampleConfig(greedy=True), seed: int = 0,
                 fused: bool = True, prefill_buckets: bool = True,
                 paged: Optional[bool] = None, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda", dtype=torch.float32,
                 adapters=None, tenant_quota: int = 0, preempt: bool = False):
        if getattr(cfg, "frontend", None):
            # repro's refusal, before any other check: both engines
            raise NotImplementedError(
                "ServingEngine serves text-only requests; frontend archs "
                "need a frontend_emb-aware admission path")
        attn_only = all(p.mixer == "attention" for p in cfg.pattern)
        paged_ok = fused and attn_only and not cfg.attn_window
        if paged is None:
            paged = paged_ok and max_len % page_size == 0
        elif paged and not fused:
            raise ValueError("paged KV requires the fused engine (page alloc/free "
                             "run inside the fused step)")
        elif paged and not paged_ok:
            raise NotImplementedError(
                "paged KV requires an attention-only, non-windowed pattern")
        if paged and max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size} (chunk == page)")
        if adapters is not None:
            if lora is not None:
                raise ValueError("pass either lora= or adapters=, not both")
            if not paged:
                raise NotImplementedError(
                    "multi-tenant adapters require the paged engine "
                    "(fused, attention-only, max_len % page_size == 0)")
            if adapters.pool_size < max_slots:
                # with pool >= slots an admission can always pin the <=
                # max_slots - 1 live tenants and still find a victim slot
                raise ValueError(f"adapter pool_size={adapters.pool_size} must be >= "
                                 f"max_slots={max_slots}")
        elif tenant_quota:
            raise ValueError("tenant_quota needs adapters=")
        self.device = dev = resolve_device(device)
        if adapters is not None and adapters.device != dev:
            raise ValueError(f"the adapter pool is on {adapters.device}, the engine "
                             f"on {dev}")
        self.adapters, self.tenant_quota = adapters, tenant_quota
        self.cfg, self.sc, self.seed = cfg, sc, seed
        self.rt = rt if rt is not None else default_serve_runtime()
        self.params = tree_to(params, dev, dtype)
        self.lora = None if lora is None else tree_to(lora, dev, dtype)
        self.max_slots, self.max_len = max_slots, max_len
        self.paged, self.fused = paged, fused
        # right-padded bucket prefill masks the pad tail out of an
        # attention cache; a windowed ring and mamba state have no such tail
        self.prefill_buckets = prefill_buckets and attn_only and not cfg.attn_window

        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        B = max_slots
        i32 = dict(dtype=torch.int32, device=dev)
        self._last = torch.zeros(B, **i32)
        self._positions = torch.zeros(B, **i32)     # next write index
        self._live = torch.zeros(B, dtype=torch.bool, device=dev)
        self._ngen = torch.zeros(B, **i32)
        self._maxnew = torch.zeros(B, **i32)
        self._eos = torch.full((B,), -1, **i32)
        self._bidx = torch.arange(B, device=dev)
        # multi-tenant per-slot state: adapter pool slot (the decode step's
        # adapter_idx) and tenant id (repro's step folds it into its keys;
        # the port seeds each stream on the host from Request.tenant)
        self._aslot = torch.zeros(B, **i32)
        self._tenant = torch.zeros(B, **i32)
        # failure handling (paged): per-slot decode-step age against the
        # request's residency deadline (-1: none), and host-set eviction,
        # requeue-behind-the-head and NaN-injection flags, cleared each step
        self.preempt = preempt
        self._age = torch.zeros(B, **i32)
        self._deadline = torch.full((B,), -1, **i32)
        self._no_flags = torch.zeros(B, dtype=torch.bool, device=dev)
        self._evict_req = np.zeros(B, bool)
        self._evict_behind = np.zeros(B, bool)
        self._nan_poke = np.zeros(B, bool)
        self.reset_stats()
        if paged:
            self.page_size = page_size
            self.max_pages = max_len // page_size
            # default pool matches slab capacity exactly (+ the null page)
            self.num_pages = (num_pages if num_pages is not None
                              else max_slots * self.max_pages + 1)
            if self.num_pages < self.max_pages + 1:
                raise ValueError("num_pages too small for a single request")
            self.caches = model_mod.init_paged_cache(cfg, self.num_pages, page_size,
                                                     dtype, dev)
            self._bt = torch.zeros((B, self.max_pages), **i32)
            self._pager = paging.init_pager(self.num_pages, dev)
            # conservative host mirror of the on-device free count
            self._free_host = self.num_pages - 1
            self._reserved = [0] * B
        else:
            self.caches = model_mod.init_cache(cfg, B, max_len, dtype, dev)
            # prefill token lengths run so far (the shapes repro compiles)
            self._prefill_lens: set = set()
            # the naive loop's host-side mirrors of last token and position
            self._np_last = [0] * B
            self._np_pos = [0] * B

    def reset_stats(self) -> None:
        """Zero the counters.  Times are host-clock seconds around work that
        ends in a host read of its result (so the device work is inside the
        interval); ``tenant_tokens`` counts delivered tokens per tenant and
        ``adapter_swaps`` the registry's adapter loads (multi-tenant);
        ``preemptions`` (``deadline_preemptions`` of them by a residency
        deadline), ``quarantined``, ``recomputed_tokens`` (prefix tokens
        prefilled again) and ``resyncs`` count the failure handling."""
        self.stats = {"decode_steps": 0, "prefill_chunks": 0, "prefills": 0,
                      "decode_s": 0.0, "prefill_s": 0.0, "tenant_tokens": {},
                      "adapter_swaps": 0, "preemptions": 0, "deadline_preemptions": 0,
                      "quarantined": 0, "recomputed_tokens": 0, "resyncs": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise AdmissionError("empty-prompt", f"request {req.uid}: empty prompt")
        if len(req.prompt) >= self.max_len:
            raise AdmissionError(
                "prompt-too-long",
                f"request {req.uid}: prompt length {len(req.prompt)} leaves "
                f"no room to decode (max_len={self.max_len})")
        self.queue.append(req)

    def prefill_compiles(self) -> int:
        """Number of distinct prefill programs, for the JAX engine's
        interface.  Paged: always 1 — every chunk of every prompt runs the
        same fixed-shape ``paged_prefill_chunk``.  Slab: the number of
        distinct prefill lengths run so far (PyTorch runs eagerly, so this
        counts the shapes ``repro`` would compile: at most log2(max_len)
        buckets, plus exact-length gap prompts)."""
        if self.paged:
            return 1
        return len(self._prefill_lens)

    def pages_in_use(self) -> int:
        """Pages currently allocated out of the pool."""
        return self.num_pages - 1 - int(self._pager["head"])

    def check_consistency(self, resync: bool = True) -> bool:
        """Audit the host reservation mirror against the on-device free
        list: free + reserved must equal the pool, and the allocator can
        never have handed out more pages than were reserved.  On drift
        warn, rebuild the mirror from the live slots and count a resync.
        Returns True when the mirror was consistent (always, for the slab
        engine)."""
        if not self.paged:
            return True
        used = self.pages_in_use()
        reserved = sum(self._reserved)
        ok = (self._free_host == self.num_pages - 1 - reserved and used <= reserved)
        if not ok and resync:
            warnings.warn(
                f"page-accounting drift: free_host={self._free_host} "
                f"reserved={reserved} in_use={used} pool={self.num_pages - 1}; "
                "resyncing from live slots", RuntimeWarning, stacklevel=2)
            self._reserved = [self._worst_pages(r) if r is not None else 0
                              for r in self.slots]
            self._free_host = self.num_pages - 1 - sum(self._reserved)
            self.stats["resyncs"] += 1
        return ok

    def _worst_pages(self, req: Request) -> int:
        """Worst-case page demand: every position the request can ever
        write KV at is < min(P + max_new, max_len)."""
        toks = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return -(-toks // self.page_size)

    def _note_token(self, req: Request) -> None:
        """Per-tenant delivered-token accounting (multi-tenant only)."""
        if self.adapters is not None:
            tt = self.stats["tenant_tokens"]
            tt[req.tenant] = tt.get(req.tenant, 0) + 1

    def _stream(self, req: Request):
        """The sampling stream of ``req``'s next token: (uid, index), with
        the tenant under multi-tenant serving."""
        n = len(req.output)
        return (req.uid, n) if self.adapters is None else (req.uid, n, req.tenant)

    def _release(self, s: int) -> None:
        self._free_host += self._reserved[s]
        self._reserved[s] = 0

    def _claim(self, s: int, req: Request, tok: int, P: int) -> None:
        """Slot ``s`` decodes ``req`` from position P after token ``tok``
        (its ``len(req.output)``-th token)."""
        self.slots[s] = req
        if not self.fused:
            self._np_last[s], self._np_pos[s] = tok, P
            return
        self._last[s] = tok
        self._positions[s] = P
        self._live[s] = True
        self._ngen[s] = len(req.output)
        self._maxnew[s] = req.max_new_tokens
        self._eos[s] = req.eos_id
        if self.paged:
            self._age[s] = 0
            self._deadline[s] = -1 if req.deadline_steps is None else int(req.deadline_steps)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admit_one_paged(self, s: int, req: Request) -> bool:
        """Stream ``req``'s prefix through the chunk step (one page per
        chunk), sample its next token and claim slot ``s``.  The caller
        has reserved ``_worst_pages(req)``.  The prefix is the prompt plus
        the tokens already delivered: a preempted request prefills all it
        had (its delivered tokens are kept, never sampled again) and
        samples token ``len(req.output)`` from its own stream.  Under
        multi-tenant serving the request's adapter is acquired first (the
        live slots' tenants pinned) and every chunk runs with it sliced
        out of the pool.  Returns False when the request finished on this
        token (pages released, slot stays free)."""
        prefix = list(req.prompt) + list(req.output)
        P, PS, dev = len(prefix), self.page_size, self.device
        if req.preempted:
            self.stats["recomputed_tokens"] += P
        t0 = time.perf_counter()
        lora, aslot = self.lora, None
        if self.adapters is not None:
            # slot s is still free here, so at most max_slots - 1 tenants are
            # pinned and (pool_size >= max_slots) a victim always exists
            pinned = {r.tenant for r in self.slots if r is not None}
            aslot = self.adapters.acquire(req.tenant, pinned=pinned)
            self.stats["adapter_swaps"] = self.adapters.stats["swaps"]
            lora = tree_map(lambda v: v[aslot], self.adapters.pool)
        one = torch.ones(1, dtype=torch.bool, device=dev)
        logits = None
        for start in range(0, P, PS):
            m = min(PS, P - start)
            chunk = prefix[start:start + m] + [0] * (PS - m)
            tokens = torch.tensor([chunk], dtype=torch.int32, device=dev)
            self._pager, newp, _ = paging.alloc_pages(self._pager, one)
            self._bt[s, start // PS] = newp[0]
            li = min(max(P - 1 - start, 0), PS - 1)
            logits, self.caches = model_mod.paged_prefill_chunk(
                self.cfg, self.params, tokens, self.caches, self._bt[s], start, li,
                lora=lora, rt=self.rt)
            self.stats["prefill_chunks"] += 1
        tok = int(sample_logits_per_key(logits, [self._stream(req)], self.sc, self.seed)[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        req.output.append(tok)
        self._note_token(req)
        if tok == req.eos_id or len(req.output) >= req.max_new_tokens or P >= self.max_len:
            req.done = True
            self._pager, self._bt = paging.free_pages(self._pager, self._bt,
                                                      self._bidx == s)
            self._release(s)
            return False
        self._claim(s, req, tok, P)
        if aslot is not None:
            self._aslot[s] = aslot
            self._tenant[s] = req.tenant
        return True

    def _admit_one_slab(self, s: int, req: Request) -> bool:
        """Prefill ``req`` and claim slot ``s``.  Fused: into a
        power-of-two bucket (exact length past the largest one, or for a
        mamba pattern), whose KV is written into slot ``s`` in place, its
        position row's padded tail set to -1 (a Mamba2 layer's state
        replaces the slot's).  Naive: at exact length into a full ``max_len``
        cache that replaces the whole cache tree.  Returns False when the
        request finished on its first token (slot stays free)."""
        P, dev = len(req.prompt), self.device
        t0 = time.perf_counter()
        if self.fused:
            cap = 1 << (self.max_len.bit_length() - 1)
            Lb = (bucket_len(P, self.max_len) if self.prefill_buckets and P <= cap
                  else P)
            cache_len = Lb
        else:
            Lb, cache_len = P, self.max_len
        tokens = torch.tensor([req.prompt + [0] * (Lb - P)], dtype=torch.int32,
                              device=dev)
        logits, cache1 = model_mod.prefill(self.cfg, self.params, tokens, lora=self.lora,
                                           rt=self.rt, cache_len=cache_len,
                                           logit_index=P - 1)
        self._prefill_lens.add(Lb)
        self.stats["prefills"] += 1
        tok = int(sample_logits_per_key(logits, [self._stream(req)], self.sc, self.seed)[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        req.output.append(tok)
        if tok == req.eos_id or req.max_new_tokens <= 1:
            req.done = True
            return False
        if self.fused:
            for big, one in zip(self.caches, cache1):
                if "ssm" in one:
                    # a Mamba2 layer: slot s's whole recurrent state is the
                    # prompt's, so nothing of its last occupant survives
                    big["ssm"][s] = one["ssm"][0]
                    big["conv"][s] = one["conv"][0]
                    continue
                n = one["k"].shape[1]
                big["k"][s, :n] = one["k"][0]
                big["v"][s, :n] = one["v"][0]
                row = one["pos"][0]
                big["pos"][s] = -1
                big["pos"][s, :n] = torch.where(row < P, row, torch.full_like(row, -1))
        else:
            # the baseline's shape: a new cache tree per admission
            def put(big, one):
                new = big.clone()
                new[s] = one[0]
                return new
            self.caches = [{k: put(big[k], one[k]) for k in big}
                           for big, one in zip(self.caches, cache1)]
        self._claim(s, req, tok, P)
        return True

    def _request_preempt(self, head: Request) -> None:
        """Page pressure: flag a live victim of strictly lower priority
        than the stalled queue head (strictness prevents same-priority
        livelock) for eviction in the next step.  Ties: the victim holding
        the most pages, then the lowest slot.  The victim requeues behind
        the head it yields to, or the two would evict each other forever."""
        cand = [s for s, r in enumerate(self.slots)
                if r is not None and r.priority < head.priority and not self._evict_req[s]]
        if not cand:
            return
        victim = min(cand, key=lambda s: (self.slots[s].priority, -self._reserved[s], s))
        self._evict_req[victim] = True
        self._evict_behind[victim] = True

    def _admissible_index(self) -> int:
        """Index of the first queued request whose tenant is under
        ``tenant_quota`` live slots (-1 if none): one chatty tenant's
        backlog cannot hold the whole batch, and FIFO order holds within
        what the quota allows."""
        if self.adapters is None or not self.tenant_quota:
            return 0 if self.queue else -1
        livec = collections.Counter(r.tenant for r in self.slots if r is not None)
        for i, req in enumerate(self.queue):
            if livec[req.tenant] < self.tenant_quota:
                return i
        return -1

    def _admit(self) -> None:
        for s in range(self.max_slots):
            while self.slots[s] is None and self.queue:
                qi = self._admissible_index()
                if qi < 0:
                    return          # every queued tenant is at its quota
                if qi:
                    # promote the first under-quota request to the head, so
                    # the FIFO backpressure below holds for it
                    req = self.queue[qi]
                    del self.queue[qi]
                    self.queue.appendleft(req)
                if not self.paged:
                    if self._admit_one_slab(s, self.queue.popleft()):
                        break
                    continue
                worst = self._worst_pages(self.queue[0])
                if worst > self._free_host:
                    # FIFO backpressure: wait for pages; with preempt=True
                    # also evict a lower-priority slot so they free sooner
                    if self.preempt:
                        self._request_preempt(self.queue[0])
                    return
                self._free_host -= worst
                self._reserved[s] = worst
                if self._admit_one_paged(s, self.queue.popleft()):
                    break

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _finish(self, nxt, live, positions):
        """Sampling bookkeeping shared by the fused steps: returns done and
        advances the per-slot state."""
        nxt = torch.where(live, nxt, torch.zeros_like(nxt))
        ngen1 = self._ngen + live.to(torch.int32)
        done = live & ((nxt == self._eos) | (ngen1 >= self._maxnew)
                       | (positions + 1 >= self.max_len))
        self._last = torch.where(live, nxt, self._last)
        self._positions = positions + live.to(torch.int32)
        self._live = live & ~done
        self._ngen = ngen1
        return nxt, done

    def _streams(self):
        return [None if r is None else self._stream(r) for r in self.slots]

    def _flags(self, host: np.ndarray) -> torch.Tensor:
        """A host flag vector on the device; all false (the usual case)
        reuses a device tensor, so a fault-free step copies nothing."""
        if not host.any():
            return self._no_flags
        return torch.from_numpy(host.copy()).to(self.device)

    def _decode_paged(self, evict: np.ndarray, poke: np.ndarray):
        """Preempt + page alloc + decode + NaN sentinel + sample +
        bookkeeping + page free for all slots, as tensor code, in
        ``repro``'s order.  Returns (next tokens, done, victim, bad) on
        device."""
        PS, MP = self.page_size, self.max_pages
        live, positions = self._live, self._positions
        # a slot the host flagged, or past its residency deadline, gives
        # its pages back first; it still decodes (against the null page)
        # but is neither sampled nor advanced
        victim = live & (self._flags(evict)
                         | ((self._deadline >= 0) & (self._age >= self._deadline)))
        self._pager, self._bt = paging.free_pages(self._pager, self._bt, victim)
        ok = live & ~victim
        # a slot about to write at a page boundary needs a fresh page
        need = ok & (positions % PS == 0)
        self._pager, newp, _ = paging.alloc_pages(self._pager, need)
        page_idx = torch.clamp(positions // PS, max=MP - 1).long()
        cur = self._bt[self._bidx, page_idx]
        self._bt[self._bidx, page_idx] = torch.where(need, newp, cur)
        mt = self.adapters is not None     # the pool, gathered by each slot's index
        logits, self.caches = model_mod.paged_decode_step(
            self.cfg, self.params, self._last[:, None], self.caches, self._bt,
            positions, lora=self.adapters.pool if mt else self.lora, rt=self.rt,
            adapter_idx=self._aslot if mt else None)
        # the NaN/inf sentinel: a non-finite row quarantines its slot, and
        # the sampler sees zeros there, never NaN
        if poke.any():
            logits = logits.masked_fill(self._flags(poke)[:, None], float("nan"))
        finite = torch.isfinite(logits).all(dim=-1)
        bad = ok & ~finite
        ok = ok & finite
        safe = torch.where(finite[:, None], logits, torch.zeros_like(logits))
        nxt = sample_logits_per_key(safe, self._streams(), self.sc, self.seed)
        nxt, done = self._finish(nxt, ok, positions)
        self._pager, self._bt = paging.free_pages(self._pager, self._bt, done | bad)
        self._age = torch.where(self._live, self._age + 1, torch.zeros_like(self._age))
        return nxt, done, victim, bad

    def _decode_slab(self):
        """Decode every slot at its own position over the slab caches
        (written in place), sample and advance, as tensor code.  A free
        slot decodes too, at a position nothing reads: one that finished
        at ``max_len`` writes entry 0 and passes length max_len + 1, which
        the kernel clamps to the cache."""
        live, positions = self._live, self._positions
        logits, self.caches = model_mod.decode_step(
            self.cfg, self.params, self._last[:, None], self.caches, positions,
            lora=self.lora, rt=self.rt)
        nxt = sample_logits_per_key(logits, self._streams(), self.sc, self.seed)
        return self._finish(nxt, live, positions)

    def _step_naive(self, live: List[int]) -> None:
        """The baseline loop: each live slot decodes at batch 1 over its
        slice of the caches (written in place) at its host-side position,
        then host-side sampling and bookkeeping."""
        toks = torch.tensor(self._np_last, dtype=torch.int32, device=self.device)
        logits = []
        for s in live:
            cache_s = [{k: t[s:s + 1] for k, t in c.items()} for c in self.caches]
            lg, _ = model_mod.decode_step(self.cfg, self.params, toks[s:s + 1, None],
                                          cache_s, self._np_pos[s], lora=self.lora,
                                          rt=self.rt)
            logits.append(lg)
        streams = [(self.slots[s].uid, len(self.slots[s].output)) for s in live]
        nxt = sample_logits_per_key(torch.cat(logits), streams, self.sc,
                                    self.seed).tolist()
        for s, tok in zip(live, nxt):
            req = self.slots[s]
            req.output.append(tok)
            self._np_pos[s] += 1
            self._np_last[s] = tok
            if (tok == req.eos_id or len(req.output) >= req.max_new_tokens
                    or self._np_pos[s] >= self.max_len):
                req.done = True
                self.slots[s] = None

    def step(self) -> int:
        """Admit + one decode round for all live slots.  Returns the number
        of live sequences decoded this step."""
        self._admit()
        live = [s for s in range(self.max_slots) if self.slots[s] is not None]
        if not live:
            return 0
        t0 = time.perf_counter()
        if not self.fused:
            self._step_naive(live)
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            return len(live)
        if self.paged:
            evict, behind = self._evict_req.copy(), self._evict_behind.copy()
            out = self._decode_paged(evict, self._nan_poke.copy())
            self._evict_req[:] = False
            self._evict_behind[:] = False
            self._nan_poke[:] = False
        else:
            out = self._decode_slab()
        # the step's one host read: next tokens and flags in one transfer
        host = torch.stack([t.to(torch.int32) for t in out]).tolist()
        nxt_h, done_h = host[0], host[1]
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        front: List[Request] = []
        for s in live:
            req = self.slots[s]
            if self.paged and host[2][s]:
                # preempted: its pages went back this step; it requeues for
                # a prefill of its prefix (delivered tokens kept)
                req.preempted += 1
                self.slots[s] = None
                self._release(s)
                self.stats["preemptions"] += 1
                if not evict[s]:
                    self.stats["deadline_preemptions"] += 1
                if behind[s] and self.queue:
                    self.queue.insert(1, req)   # behind the head it yielded to
                else:
                    front.append(req)
                continue
            if self.paged and host[3][s]:
                # quarantined: non-finite logits fail the request
                req.error = "non-finite logits"
                req.done = True
                self.slots[s] = None
                self._release(s)
                self.stats["quarantined"] += 1
                continue
            req.output.append(nxt_h[s])
            self._note_token(req)
            if done_h[s]:
                req.done = True
                self.slots[s] = None
                if self.paged:
                    # pages went back on the device this same step
                    self._release(s)
        for req in reversed(front):      # oldest work back to the front
            self.queue.appendleft(req)
        return len(live)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                self.check_consistency()    # drained: all pages home
                return
            self.step()
