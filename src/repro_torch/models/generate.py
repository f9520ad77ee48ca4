"""Token sampling (greedy / temperature / top-k / top-p) and batched
autoregressive generation over the slab KV cache (``generate``).

A serving engine samples token ``t`` of request ``uid`` from its own
``torch.Generator`` seeded with ``stream_seed(seed, uid, t)``, a pure
function of the three.  That keeps the property of ``repro``'s
``fold_in(fold_in(key, uid), t)`` keys — a request's tokens depend on the
request alone, not on arrival order or which slot it landed in — but not
its bits: the two frameworks' generators differ.  A multi-tenant engine
mixes the request's tenant in first (``stream_seed(seed, uid, t,
tenant)``), as ``repro`` folds the tenant into its key first: a tenant's
stream does not depend on co-residency or adapter slot, and two tenants
with the same uid draw different streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import model as model_mod
from .stack import Runtime

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SampleConfig:
    temperature: float = 1.0
    top_k: int = 0                # 0 = off
    top_p: float = 1.0            # 1.0 = off
    greedy: bool = False
    eos_id: int = -1              # -1 = never stop early


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(seed: int, uid: int, token_index: int,
                tenant: Optional[int] = None) -> int:
    """Seed of request ``uid``'s generator for token ``token_index``; a
    ``tenant`` is mixed in before the uid (None: no mixing at all, so the
    single-adapter seeds are the same with and without the argument)."""
    z = _splitmix64(seed & _MASK64)
    if tenant is not None:
        z = _splitmix64(z ^ (tenant & _MASK64))
    z = _splitmix64(z ^ (uid & _MASK64))
    z = _splitmix64(z ^ (token_index & _MASK64))
    return z & ((1 << 63) - 1)


def _filtered(logits: torch.Tensor, sc: SampleConfig) -> torch.Tensor:
    logits = logits.float() / max(sc.temperature, 1e-6)
    if sc.top_k:
        kth = torch.topk(logits, sc.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < sc.top_p).sum(-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_logits(logits: torch.Tensor, gen: Optional[torch.Generator],
                  sc: SampleConfig) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,) int32; ``gen`` is unused when
    greedy."""
    if sc.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filtered(logits, sc), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def sample_logits_per_key(logits: torch.Tensor,
                          streams: Sequence[Optional[Tuple[int, ...]]],
                          sc: SampleConfig, seed: int = 0) -> torch.Tensor:
    """logits: (B, V); streams[b] = (uid, token_index) of row b, or (uid,
    token_index, tenant) under multi-tenant serving (``stream_seed``), or
    None for a row nobody reads (it gets 0 without drawing).  Returns
    (B,) int32."""
    if sc.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    out = torch.zeros(logits.shape[0], dtype=torch.int32, device=logits.device)
    for b, st in enumerate(streams):
        if st is None:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(stream_seed(seed, *st))
        out[b] = sample_logits(logits[b:b + 1], gen, sc)[0]
    return out


def generate(cfg, params: dict, tokens: torch.Tensor, *, lora=None,
             rt: Runtime = Runtime(), max_new_tokens: int = 32,
             sc: SampleConfig = SampleConfig(),
             gen: Optional[torch.Generator] = None,
             frontend_emb=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill + decode loop over slab caches of S + F + ``max_new_tokens``
    positions.  tokens: (B, S) int; ``frontend_emb`` (B, F, d) or None, the
    prefix the prompt follows (decode sees it only through the caches).
    Returns (generated (B,
    max_new_tokens) int32, done (B,) bool); rows that sampled ``sc.eos_id``
    stop (their later entries are 0) and the loop ends when every row has.

    Sampling draws from ``gen`` (a ``torch.Generator`` on tokens' device;
    one seeded with 0 when None): greedy ids equal ``repro``'s
    ``generate``, sampled ones follow this generator, not JAX's key
    splits.  One host read per step decides whether every row is done."""
    B, S = tokens.shape
    S += model_mod.prefix_len(frontend_emb)
    logits, caches = model_mod.prefill(cfg, params, tokens, lora=lora, rt=rt,
                                       cache_len=S + max_new_tokens,
                                       frontend_emb=frontend_emb)
    if gen is None and not sc.greedy:
        gen = torch.Generator(device=tokens.device).manual_seed(0)
    tok = sample_logits(logits, gen, sc)
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=tokens.device)
    out[:, 0] = tok
    done = (tok == sc.eos_id if sc.eos_id >= 0
            else torch.zeros(B, dtype=torch.bool, device=tokens.device))
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        logits, caches = model_mod.decode_step(cfg, params, tok[:, None], caches,
                                               S - 1 + i, lora=lora, rt=rt)
        nxt = torch.where(done, tok, sample_logits(logits, gen, sc))
        out[:, i] = torch.where(done, torch.zeros_like(nxt), nxt)
        if sc.eos_id >= 0:
            done = done | (nxt == sc.eos_id)
        tok = nxt
    return out, done
