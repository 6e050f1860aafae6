"""Paged KV cache: one preallocated arena shared by all in-flight sequences
(counterpart of ``repro/serve/cache.py``).

The arena is split into fixed-size pages of ``page_size`` token slots.  A
host-side :class:`PagePool` hands pages to sequences (all-or-nothing
allocation, explicit free, owner-level eviction for preemption) and a
per-sequence *block table* maps linear token positions to pages: token
``t`` of a sequence lives at ``(block_table[t // page_size],
t % page_size)``.

Device layout mirrors the model's cache tree: one ``{"k", "v"}`` arena of
shape ``(n_layers_in_group, num_pages + 1, page_size, n_kv, head_dim)``
per pattern position / remainder layer.  Row ``num_pages`` is a *trash
page*: masked writes (padding tokens, inactive slots) are routed there.
The arenas are written IN PLACE (``index_put_``) by
:func:`write_prompt_pages` and by ``Transformer.decode_step_paged`` --
where the reference donates the buffer to a functional update.

Only attention mixers are pageable; recurrent mixers (RWKV / RG-LRU)
carry O(1) state and need no paging.  ``paged_kinds`` validates a config
up front.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..models.config import ATTN, LOCAL, ModelConfig


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    page_size: int = 16
    num_pages: int = 256

    @property
    def trash_page(self) -> int:
        return self.num_pages

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` token slots."""
        return max(1, -(-n_tokens // self.page_size))


class PagePool:
    """Host-side free-list allocator over ``num_pages`` pages.

    Pages are owned by request ids.  ``alloc`` is atomic (all-or-nothing),
    ``free`` releases every page of an owner (the eviction primitive used
    for preemption), and ``check`` asserts the no-double-free / no-orphan
    invariants.
    """

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self._free: List[int] = list(range(cfg.num_pages - 1, -1, -1))
        self._owned: Dict[object, List[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def owners(self):
        return list(self._owned)

    def alloc(self, owner, n: int = 1) -> Optional[List[int]]:
        """Give ``owner`` ``n`` more pages, or None (and no change) if the
        pool cannot satisfy the request."""
        if n < 0:
            raise ValueError(f"alloc n={n}")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(got)
        return got

    def free(self, owner) -> int:
        """Release every page of ``owner``; returns the count.

        Raises KeyError if ``owner`` holds nothing (double free)."""
        if owner not in self._owned:
            raise KeyError(f"free of unknown owner {owner!r} (double free?)")
        pages = self._owned.pop(owner)
        self._free.extend(pages)
        return len(pages)

    def check(self):
        """Invariants: free + owned partition [0, num_pages); no dups."""
        owned = [p for ps in self._owned.values() for p in ps]
        seen = self._free + owned
        assert len(seen) == len(set(seen)), "duplicate page id"
        assert set(seen) == set(range(self.cfg.num_pages)), \
            "orphaned or out-of-range page"


# ---------------------------------------------------------------------------
# device arenas
# ---------------------------------------------------------------------------

def paged_kinds(cfg: ModelConfig) -> List[str]:
    """The model's mixer kinds, validated as pageable."""
    bad = sorted(set(k for k in cfg.pattern if k not in (ATTN, LOCAL)))
    if bad:
        raise NotImplementedError(
            f"paged serving supports attention mixers only; {cfg.name} "
            f"has {bad}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "paged serving stores the compute dtype; int8 paged pages are "
            "a future optimization")
    if cfg.embed_input != "tokens":
        raise NotImplementedError("paged serving needs a token frontend")
    return list(cfg.pattern)


def _arena(cfg: ModelConfig, n_layers: int, pc: PagedCacheConfig, device):
    shape = (n_layers, pc.num_pages + 1, pc.page_size, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def make_paged_arenas(cfg: ModelConfig, pc: PagedCacheConfig, device):
    """Arena tree mirroring ``Transformer.make_cache`` structure, on
    ``device``."""
    paged_kinds(cfg)
    n_full, n_rem = cfg.n_periods()
    return {
        "periods": [_arena(cfg, n_full, pc, device) for _ in cfg.pattern]
        if n_full else [],
        "remainder": [_arena(cfg, 1, pc, device) for _ in range(n_rem)],
    }


def write_prompt_pages(arenas, prefill_cache, bt_row, true_len: int,
                       pc: PagedCacheConfig):
    """Scatter a linear prefill cache into the paged arenas, in place.

    ``prefill_cache`` is the tree returned by ``Transformer.prefill(...,
    linear_cache=True)`` for a batch of ONE sequence: per layer group, k/v
    of shape ``(n_layers, 1, S, n_kv, hd)``.  Tokens ``t < true_len`` go
    to ``(bt_row[t // page_size], t % page_size)``; padding tokens go to
    the trash page.  Returns ``arenas``.
    """
    groups = prefill_cache["periods"] + prefill_cache["remainder"]
    if not groups:
        return arenas
    S = groups[0]["k"].shape[2]
    dev = groups[0]["k"].device
    t = torch.arange(S, device=dev)
    bt = torch.as_tensor(bt_row, device=dev).long()
    pidx = torch.where(t < int(true_len), bt[t // pc.page_size],
                       pc.trash_page)
    off = t % pc.page_size
    for arena_g, cache_g in zip(arenas["periods"] + arenas["remainder"],
                                groups):
        for name in ("k", "v"):
            arena = arena_g[name]
            arena[:, pidx, off] = cache_g[name][:, 0].to(arena.dtype)
    return arenas
