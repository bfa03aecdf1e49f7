"""FIFO request queue with admission control (the port's own copy of the
reference's ``serve/scheduler.py``, which is torch- and JAX-free).

Admission is keyed on two things only (continuous batching keeps the rest
of the policy in the engine):

  * **free slots** — a request is admitted the moment the KV pool has a
    slot for it; ``admit(n_free)`` never returns more requests than slots.
  * **prompt-length buckets** — prompts are bucketed into a fixed ladder
    of padded lengths, so the number of distinct prefill shapes is
    bounded by ``len(buckets)`` no matter how many distinct prompt
    lengths the traffic carries.

Requests that can never run (prompt + one generated token exceeding the
pool's KV capacity) are rejected at ``submit`` with a clear error instead
of clogging the queue.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.  ``on_token`` streams (uid, token) as each
    token is sampled — before the request completes."""
    prompt: np.ndarray                      # (P,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0                # 0 -> greedy
    top_k: int = 0                          # 0 -> disabled
    top_p: float = 1.0                      # 1 -> disabled
    seed: int = 0
    eos_id: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None
    deadline: Optional[float] = None        # absolute engine-clock time
    uid: int = -1                           # assigned at submit


def default_buckets(kv_len: int, start: int = 8) -> Tuple[int, ...]:
    """Power-of-two ladder start, 2*start, ... capped at kv_len.

    ``start`` is clamped to ``kv_len // 2`` so the ladder always holds at
    least one bucket strictly below capacity — with ``start >= kv_len`` it
    used to degenerate to the single bucket ``(kv_len,)``, silently
    padding every short prompt to full KV capacity in prefill.  A ladder
    that cannot have a sub-capacity bucket (``kv_len < 2``) raises.
    """
    if start < 1:
        raise ValueError(f"bucket ladder start must be >= 1, got {start}")
    if kv_len < 2:
        raise ValueError(
            f"kv_len={kv_len} leaves a degenerate one-bucket ladder: every "
            f"prompt would prefill padded to full KV capacity")
    start = min(start, kv_len // 2)
    out = []
    b = start
    while b < kv_len:
        out.append(b)
        b *= 2
    out.append(kv_len)
    return tuple(out)


class FIFOScheduler:
    """First-in-first-out queue; admission keyed on free slots."""

    def __init__(self, kv_len: int,
                 buckets: Optional[Sequence[int]] = None):
        self.kv_len = kv_len
        self.buckets = tuple(sorted(set(buckets or default_buckets(kv_len))))
        if self.buckets[-1] > kv_len:
            raise ValueError(
                f"bucket {self.buckets[-1]} exceeds KV capacity {kv_len}")
        self._queue: Deque[Request] = deque()
        self._uids = itertools.count()

    def __len__(self) -> int:
        return len(self._queue)

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket holding the prompt; raises if none can."""
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.buckets[-1]} (KV capacity {self.kv_len})")

    def submit(self, req: Request) -> int:
        req.prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        plen = len(req.prompt)        # validate the FLAT length that runs
        if plen < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={req.max_new_tokens}: the engine always "
                f"emits at least one token (the prefill's first sample)")
        if plen + 1 > self.kv_len:
            raise ValueError(
                f"prompt length {plen} leaves no room to generate within "
                f"KV capacity {self.kv_len}")
        self.bucket_for(plen)                 # validates against the ladder
        req.uid = next(self._uids)
        self._queue.append(req)
        return req.uid

    def admit(self, n_free: int) -> List[Tuple[Request, int]]:
        """Pop up to ``n_free`` requests with their padded prompt lengths."""
        out: List[Tuple[Request, int]] = []
        while self._queue and len(out) < n_free:
            req = self._queue.popleft()
            out.append((req, self.bucket_for(len(req.prompt))))
        return out

    def peek(self) -> Optional[Request]:
        """Head of the queue without popping: the paged engine checks the
        head's page reservation before committing to a pop (strict FIFO
        under head-of-line blocking)."""
        return self._queue[0] if self._queue else None

    def pop(self) -> Request:
        return self._queue.popleft()

    def expire(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline has passed: a request that
        timed out waiting must never occupy a KV slot."""
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = {id(r) for r in expired}   # ndarray fields break ==
            self._queue = deque(r for r in self._queue
                                if id(r) not in dead)
        return expired
