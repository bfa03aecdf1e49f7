"""KV cache pool: fixed-capacity whole slots with FIFO recycling.

Port of the slab ``KVPool`` of the reference's ``serve/kv_pool.py``.  The
pool owns ONE cache tree of batch size ``n_slots`` (the decode batch),
laid out exactly like ``Model.cache_shapes``: each block kind's own cache
length (``kv_len`` for ``attn``, the ring's ``min(window, kv_len)`` for
``local``), stacked over periods, and the ``rem`` layers' caches.  A
request occupies one slot for its lifetime:

  admit  -> ``alloc()`` hands out the oldest retired slot (FIFO recycling)
  prefill-> ``write_prefill`` copies the request's padded prefill caches
            into the slot (the FULL slot, so a recycled slot never leaks
            its previous occupant)
  decode -> the decode step updates all slots in place (inactive slots
            write their own slot's position 0, which the next prefill
            overwrites)
  retire -> ``free()`` zeroes the slot's length and recycles it
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Optional

import numpy as np
import torch

from repro_torch.serve import steps


class KVPool:
    def __init__(self, model, n_slots: int, kv_len: int,
                 dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.caches = model.init_caches(n_slots, kv_len, dtype)
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
        """Grow a request's batch=1 prefill caches to pool capacity and copy
        them into batch index ``slot`` (in place)."""
        grown = steps.pad_prefill_caches(self.model, prefill_caches,
                                         self.kv_len)
        for pool_c, new_c in zip(self.caches["blocks"], grown["blocks"]):
            for key in ("k", "v"):           # (n_periods, B, S, K, hd)
                pool_c[key][:, slot] = new_c[key][:, 0]
        for pool_c, new_c in zip(self.caches["rem"] or (),
                                 grown["rem"] or ()):
            for key in ("k", "v"):           # (B, S, K, hd)
                pool_c[key][slot] = new_c[key][0]
        self.lengths[slot] = prompt_len
