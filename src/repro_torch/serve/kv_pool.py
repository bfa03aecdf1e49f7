"""KV cache pools: whole-slot slabs and the paged block arena.

Port of the reference's ``serve/kv_pool.py``.  On a mesh of gloo ranks
(``launch.mesh.Mesh``) each rank holds its cut of the device caches
(``steps.cache_specs``, ``steps.paged_cache_specs``) and the whole of the
host bookkeeping (free lists, lengths, page tables, chain hashes,
refcounts, LRU), which every rank computes identically from the same
calls: the reference keeps one copy of it beside its global arrays.

``KVPool`` — fixed-capacity whole slots with FIFO recycling.  The
pool owns ONE cache tree of batch size ``n_slots`` (the decode batch),
laid out exactly like ``Model.cache_shapes``: each block kind's own cache
length (``kv_len`` for ``attn``, the ring's ``min(window, kv_len)`` for
``local``; an ``ssd``/``rec`` layer's fp32 state and conv history),
stacked over periods, and the ``rem`` layers' caches, each leaf in its
own dtype.  A
request occupies one slot for its lifetime:

  admit  -> ``alloc()`` hands out the oldest retired slot (FIFO recycling)
  prefill-> ``write_prefill`` copies the request's padded prefill caches
            into the slot (the FULL slot, so a recycled slot never leaks
            its previous occupant); on a mesh the rank whose rows hold the
            slot keeps its slice of the cache sequence, the others nothing
  decode -> the decode step updates all slots in place (inactive slots
            write their own slot's position 0, which the next prefill
            overwrites)
  retire -> ``free()`` zeroes the slot's length and recycles it

``PagedKVPool`` — a fixed arena of KV *pages* plus a per-slot page table.
A request pins only the pages its tokens occupy (reserved in full at
admission: ceil(min(prompt + max_new, kv_len) / page_size) pages, so no
allocation fails mid-generation), and full prompt pages are shared
across requests through a chain-hash prefix cache with refcounts and LRU
retention.  The page table is the only host-to-device traffic: the
paged step resolves the indirection (``models/attention.py``
``paged_insert``/``paged_attend``).  Its host bookkeeping (free lists,
tables, refcounts, hashes) is the reference's, line for line.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import steps


class KVPool:
    """Slot rows cut over ``batch_axes`` and each slot's cache sequence
    over ``kv_axes`` of ``mesh`` (none: the whole pool on this rank)."""

    def __init__(self, model, n_slots: int, kv_len: int,
                 dtype: torch.dtype = torch.bfloat16, *, mesh=None,
                 batch_axes: Sequence[str] = (),
                 kv_axes: Sequence[str] = ()):
        self.model = model
        self.mesh = mesh
        self.n_slots = n_slots
        self.kv_len = kv_len
        bw, self._b_rank, _ = steps.axes_group(mesh, batch_axes)
        if n_slots % bw:
            raise ValueError(f"n_slots={n_slots} must divide over batch "
                             f"axes {tuple(batch_axes)} (world {bw})")
        self._rows = n_slots // bw                   # slots on this rank
        kw, _, _ = steps.axes_group(mesh, kv_axes)
        self._kv_specs = steps.cache_specs(model, (), kv_axes)
        self.caches = model.init_caches(self._rows, kv_len, dtype, kw)
        self.lengths = np.zeros(n_slots, np.int32)   # valid tokens per slot
        self._free: Deque[int] = deque(range(n_slots))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """Oldest retired slot first — recycling is FIFO, so freed slots
        are provably reused."""
        return self._free.popleft() if self._free else None

    def free(self, slot: int) -> None:
        assert 0 <= slot < self.n_slots and slot not in self._free
        self.lengths[slot] = 0
        self._free.append(slot)

    def write_prefill(self, slot: int, prefill_caches: Any,
                      prompt_len: int) -> None:
        """Grow a request's batch=1 prefill caches (whole, as every rank
        computes them) to pool capacity and copy this rank's slice of
        their cache sequence into batch index ``slot`` (in place), if the
        slot's row is this rank's."""
        self.lengths[slot] = prompt_len
        row = slot - self._b_rank * self._rows
        if not 0 <= row < self._rows:
            return
        grown = steps.pad_prefill_caches(self.model, prefill_caches,
                                         self.kv_len)
        specs = self._kv_specs
        # every leaf of the slot: K/V, and an ssd/rec layer's state and
        # conv history, which a recycled slot must not keep
        for pool_c, new_c, sp in zip(self.caches["blocks"], grown["blocks"],
                                     specs["blocks"]):
            for key in pool_c:               # (n_periods, B, ...)
                pool_c[key][:, row] = steps.shard_cut(
                    new_c[key], sp[key], self.mesh)[:, 0]
        for pool_c, new_c, sp in zip(self.caches["rem"] or (),
                                     grown["rem"] or (), specs["rem"] or ()):
            for key in pool_c:               # (B, ...)
                pool_c[key][row] = steps.shard_cut(
                    new_c[key], sp[key], self.mesh)[0]


def _page_hash(prev: bytes, tokens: np.ndarray) -> bytes:
    """Chain hash of one full page of prompt tokens: page i's hash covers
    pages 0..i, so equal page CONTENT at different prompt offsets never
    aliases — a cached page is reusable only when the whole prefix leading
    to it matches."""
    return hashlib.blake2b(prev + tokens.astype(np.int64).tobytes(),
                           digest_size=16).digest()


class PagedKVPool:
    """Fixed page arena + per-slot page tables + prefix cache.

    Page lifecycle (every page is in exactly one of these states):

      free      -> on ``_free_pages``; content is garbage
      active    -> refcount >= 1: referenced by that many slot tables
      cached    -> refcount == 0 but REGISTERED in the prefix cache: parked
                   in ``_lru`` with its content, revivable by a prefix hit,
                   reclaimed oldest-first only under pool pressure

    Only FULL prompt pages are registered (a page decode will still write
    into is never shared), and a prefix match is capped at prompt_len - 1
    tokens so that at least one token runs through prefill to give the
    first-token logits.
    """

    def __init__(self, model, n_slots: int, kv_len: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 prefix_cache: bool = True, *, mesh=None,
                 kv_axes: Sequence[str] = ()):
        # a model that is not dense attn-only refuses init_paged_caches
        kw, _, _ = steps.axes_group(mesh, kv_axes)
        if page_size % kw:
            raise ValueError(f"page_size {page_size} must divide over the "
                             f"{kw}-way kv sharding {tuple(kv_axes)}")
        if kv_len % page_size:
            raise ValueError(f"kv_len {kv_len} % page_size {page_size} != 0")
        self.model = model
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.page_size = page_size
        self.pages_per_slot = kv_len // page_size
        self.n_pages = n_pages if n_pages is not None \
            else n_slots * self.pages_per_slot
        self.prefix_enabled = prefix_cache
        # the page dim whole, each page's tokens cut over kv_axes
        self.caches = model.init_paged_caches(self.n_pages, page_size, dtype,
                                              kw)

        self.table = np.full((n_slots, self.pages_per_slot), -1, np.int32)
        self.lengths = np.zeros(n_slots, np.int32)
        self.refcount = np.zeros(self.n_pages, np.int32)
        self._free_slots: Deque[int] = deque(range(n_slots))
        self._free_pages: Deque[int] = deque(range(self.n_pages))
        self._cache: Dict[bytes, int] = {}      # registered: hash -> page
        self._hash_of: Dict[int, bytes] = {}    # registered: page -> hash
        self._lru: "OrderedDict[bytes, int]" = OrderedDict()
        self.counters = {"prefix_hits": 0, "prefix_tokens_reused": 0,
                         "evicted": 0}

    # ------------------------------------------------------------ queries

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (free list + evictable LRU)."""
        return len(self._free_pages) + len(self._lru)

    def arena_bytes(self) -> int:
        """Device bytes of the page arena (every layer's K and V)."""
        return sum(t.numel() * t.element_size()
                   for group in (self.caches["blocks"],
                                 self.caches["rem"] or ())
                   for c in group for t in c.values())

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Table entries a request pins: every position it may ever write
        (prompt + generated, clipped to capacity), page-rounded."""
        hi = min(prompt_len + max_new, self.kv_len)
        return -(-hi // self.page_size)

    def match_prefix(self, prompt: Sequence[int], align: int = 1
                     ) -> Tuple[int, List[Tuple[bytes, int]]]:
        """Longest reusable prefix of ``prompt`` already resident as
        registered pages: (matched_tokens, [(hash, page), ...]).

        Full pages only; capped at prompt_len - 1 tokens; then truncated
        DOWN to a multiple of ``align`` (the engine passes its prefill
        chunk, so a hit's chunk boundaries are the cold run's: that is
        what makes the hit path bit-identical to the cold path)."""
        if not self.prefix_enabled:
            return 0, []
        toks = np.asarray(prompt, np.int64)
        limit = min((len(toks) - 1) // self.page_size,
                    self.pages_per_slot)
        pairs: List[Tuple[bytes, int]] = []
        h = b""
        for i in range(limit):
            h = _page_hash(h, toks[i * self.page_size:
                                   (i + 1) * self.page_size])
            pg = self._cache.get(h)
            if pg is None:
                break
            pairs.append((h, pg))
        matched = len(pairs) * self.page_size
        if align > 1:
            matched = (matched // align) * align
            pairs = pairs[: matched // self.page_size]
        return matched, pairs

    # ------------------------------------------------------- admit / free

    def _claim_page(self) -> int:
        if self._free_pages:
            return self._free_pages.popleft()
        h, pg = self._lru.popitem(last=False)      # oldest registered page
        del self._cache[h]
        del self._hash_of[pg]
        self.counters["evicted"] += 1
        return pg

    def alloc(self, prompt: Sequence[int], max_new: int, align: int = 1
              ) -> Optional[Tuple[int, int]]:
        """Admit one request: reserve a slot and its FULL page budget.

        Returns (slot, matched_prefix_tokens), or None (no slot, or too few
        claimable pages: all or nothing, a refused admission changes
        nothing).  Matched prefix pages are revived and refcounted, the
        rest claimed from the free list (evicting LRU pages if pressed).
        Writes past the budget (speculative overshoot) are dropped by
        ``paged_insert``."""
        if not self._free_slots:
            return None
        matched, pairs = self.match_prefix(prompt, align)
        need = self.pages_needed(len(prompt), max_new)
        in_lru = sum(1 for h, _ in pairs if h in self._lru)
        claimable = len(self._free_pages) + len(self._lru) - in_lru
        if need - len(pairs) > claimable:
            return None
        slot = self._free_slots.popleft()
        row = np.full(self.pages_per_slot, -1, np.int32)
        for i, (h, pg) in enumerate(pairs):
            if h in self._lru:
                del self._lru[h]                   # revive a parked page
            self.refcount[pg] += 1
            row[i] = pg
        for i in range(len(pairs), need):
            pg = self._claim_page()
            self.refcount[pg] = 1
            row[i] = pg
        self.table[slot] = row
        self.lengths[slot] = 0
        if matched:
            self.counters["prefix_hits"] += 1
            self.counters["prefix_tokens_reused"] += matched
        return slot, matched

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> None:
        """Publish ``slot``'s full prompt pages into the prefix cache, once
        prefill has written them.  Only pages all of whose tokens are
        PROMPT tokens are registered (decode writes from prompt_len on);
        pages already registered, or whose chain hash is published under
        another page, are skipped."""
        if not self.prefix_enabled:
            return
        toks = np.asarray(prompt, np.int64)
        h = b""
        for i in range(len(toks) // self.page_size):
            h = _page_hash(h, toks[i * self.page_size:
                                   (i + 1) * self.page_size])
            pg = int(self.table[slot, i])
            assert pg >= 0
            if pg in self._hash_of or h in self._cache:
                continue
            self._cache[h] = pg
            self._hash_of[pg] = h

    def free(self, slot: int) -> None:
        """Release a slot: unreference its pages.  A page reaching refcount
        0 parks in the LRU (content kept) if registered, else returns to
        the free list."""
        assert 0 <= slot < self.n_slots and slot not in self._free_slots
        for pg in self.table[slot]:
            pg = int(pg)
            if pg < 0:
                continue
            self.refcount[pg] -= 1
            assert self.refcount[pg] >= 0
            if self.refcount[pg] == 0:
                h = self._hash_of.get(pg)
                if h is not None:
                    self._lru[h] = pg
                else:
                    self._free_pages.append(pg)
        self.table[slot] = -1
        self.lengths[slot] = 0
        self._free_slots.append(slot)

    # ------------------------------------------------------------- stats

    def utilization(self) -> Dict[str, Any]:
        active = int(self.n_pages - len(self._free_pages) - len(self._lru))
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_active": active,
            "pages_cached": len(self._lru),
            "pages_free": len(self._free_pages),
            "utilization": active / max(1, self.n_pages),
            **self.counters,
        }
