"""Continuous-batching inference engine (slab KV pool).

Port of the slab branch of the reference's ``serve/engine.py``: requests
are admitted whenever the KV pool has a free slot, prefilled into that
slot, then decoded TOGETHER with every other in-flight request by one
batched decode step — the per-sequence ``cache_pos`` contract lets rows
sit at different positions.  Retired slots recycle to queued requests.

Step anatomy (``ServeEngine.step``):

  0. expire   — requests past their ``deadline`` (absolute ``clock()``
                time) end with status ``"timeout"``: active ones release
                their slot, queued ones leave the queue without one.
  1. admit    — FIFO admission while slots are free; each prompt is
                right-padded to its length bucket (an ``attn``-only stack;
                any other prefills at the prompt's exact length, since a
                ring cache would absorb the pad tokens), prefilled with
                batch=1
                (the per-sequence ``last_pos`` logits give the first token,
                streamed at once) and its caches copied into the slot.
  2. decode   — one batched step over ALL slots: tokens (n_slots, 1),
                cache_pos (n_slots,).  Inactive slots decode a dummy token
                at position 0 of their own slot; admission overwrites the
                whole slot, so nothing leaks across requests.
  3. retire   — EOS / max-new-tokens / KV capacity free the slot.

Weights stay in their flat ZeRO buffers and every layer group moves
through the qwZ INT8 gather on every step, as in the reference.
:meth:`ServeEngine.from_checkpoint` boots from a checkpoint (fp32 or
INT8, saved at any world) through the params-only bf16 load
(``train.state.load_serving_params``).  Paged mode, speculative decoding
and boot-time tuning come with later slices; the constructor refuses
them.  Models fed by a frontend stub (``embed_inputs``, ``mrope``) are
refused as in the reference: they serve through the raw ``serve.steps``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import platform
from repro_torch.obs.metrics import Histogram
from repro_torch.serve import steps
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.sampling import request_generator, sample_logits
from repro_torch.serve.scheduler import FIFOScheduler, Request


@dataclasses.dataclass
class _Active:
    """One in-flight request: ``pos`` is the cache position of the last
    sampled (not yet cache-written) token — the next decode's cache_pos."""
    req: Request
    slot: int
    pos: int
    n_gen: int
    last_token: int
    gen: torch.Generator


def _refuse_stub_inputs(cfg) -> None:
    """The engine feeds token ids: a model fed by a frontend stub
    (embeddings, M-RoPE positions) serves through the raw
    ``serve.steps`` prefill and decode steps only (the reference's
    refusal)."""
    if cfg.embed_inputs or cfg.mrope:
        raise ValueError(
            "ServeEngine drives token-in models; embed/M-RoPE frontends "
            "need their own input pipeline")


class ServeEngine:
    def __init__(self, model, params: Dict[str, torch.Tensor], *,
                 n_slots: int, kv_len: int,
                 scheduler: Optional[FIFOScheduler] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 device="cuda", pool: str = "slab", tune: str = "off",
                 draft: Optional[Tuple[Any, Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if pool != "slab" or draft is not None or (tune and tune != "off"):
            raise NotImplementedError(
                "the port's engine runs the slab KV pool only: paged mode, "
                "speculative decoding and tune= are not ported yet")
        dev = platform.resolve_device(device)
        if dev.type != model.device.type:
            raise ValueError(f"engine on {dev} but the model runs on "
                             f"{model.device}")
        cfg = model.cfg
        _refuse_stub_inputs(cfg)
        if "local" in model.period and kv_len < cfg.window:
            raise ValueError(
                f"kv_len={kv_len} below the sliding window {cfg.window}: "
                f"ring caches from prefill would not fit the pool")
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.scheduler = scheduler if scheduler is not None \
            else FIFOScheduler(kv_len=kv_len)
        self.pool = KVPool(model, n_slots, kv_len,
                           dtype=cache_dtype or model.zcfg.compute_dtype)
        self._prefill = steps.build_prefill_step(model, with_last_pos=True,
                                                 device=dev)
        self._decode = steps.build_decode_step(model, device=dev)
        # prompts right-padded to buckets are exact only when every layer
        # masks by position (full attention): a ring would hold the pads
        self._pad_ok = set(model.period) == {"attn"}
        self.clock = clock                       # injectable for tests
        self.slots: List[Optional[_Active]] = [None] * n_slots
        self.results: Dict[int, List[int]] = {}
        self.status: Dict[int, str] = {}   # uid -> queued/active/done/timeout
        self.slot_history: Dict[int, int] = {}   # uid -> slot
        self._counts = {"admitted": 0, "completed": 0, "expired": 0}
        self._submit_t: Dict[int, float] = {}     # uid -> clock() at submit
        self._ttft = Histogram("serve.ttft_ms", window=512)
        self._tok_lat = Histogram("serve.tok_latency_ms", window=512)
        self._decode_win: deque = deque(maxlen=256)  # (wall_s, toks) per tick
        self._tick = 0

    # ------------------------------------------------------------- boot

    @classmethod
    def from_checkpoint(cls, model, ckpt: str, *, dtype=torch.bfloat16,
                        **kw) -> "ServeEngine":
        """Boot from a checkpoint (per-shard fp32 or INT8, or a legacy
        npz; ``ckpt`` a checkpoint or a directory of them, the latest
        taken) via the params-only bf16 serving load, which refuses a
        checkpoint written for another arch.  ``kw``: the constructor's
        (``n_slots``, ``kv_len``, ...)."""
        from repro_torch.train.state import load_serving_params
        _refuse_stub_inputs(model.cfg)
        params = load_serving_params(model, ckpt, dtype=dtype,
                                     expect_arch=model.cfg.name)
        return cls(model, params, **kw)

    # ---------------------------------------------------------- requests

    def submit(self, prompt, **kw) -> int:
        """Queue a request; returns its uid.  Keyword args mirror
        ``scheduler.Request`` (max_new_tokens, temperature, top_k, top_p,
        seed, eos_id, on_token, deadline)."""
        req = Request(prompt=np.asarray(prompt, np.int32), **kw)
        uid = self.scheduler.submit(req)
        self.results[uid] = []
        self.status[uid] = "queued"
        self._submit_t[uid] = self.clock()
        return uid

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.slots)

    @property
    def done(self) -> bool:
        return not self.n_active and not len(self.scheduler)

    # ------------------------------------------------------------- steps

    def _sample(self, req: Request, logits_row: torch.Tensor,
                gen: torch.Generator) -> int:
        return int(sample_logits(logits_row, gen, req.temperature,
                                 req.top_k, req.top_p))

    def _emit(self, a: _Active, token: int) -> None:
        self.results[a.req.uid].append(token)
        if a.req.on_token is not None:
            a.req.on_token(a.req.uid, token)

    def _finished(self, a: _Active, token: int) -> bool:
        if a.req.eos_id is not None and token == a.req.eos_id:
            return True
        if a.n_gen >= a.req.max_new_tokens:
            return True
        return a.pos >= self.kv_len              # no slot left to write to

    def _retire(self, a: _Active, status: str = "done") -> None:
        self.slots[a.slot] = None
        self.pool.free(a.slot)
        self.status[a.req.uid] = status
        self._counts["completed" if status == "done" else "expired"] += 1

    def _expire(self, now: float) -> None:
        """Time out requests past their deadline: active ones release their
        KV slot, queued ones never take one."""
        for req in self.scheduler.expire(now):
            self.status[req.uid] = "timeout"
            self._counts["expired"] += 1
        for a in list(self.slots):
            if a is not None and a.req.deadline is not None \
                    and now >= a.req.deadline:
                self._retire(a, status="timeout")

    def _admit(self, emitted: List[Tuple[int, int]]) -> None:
        for req, bucket in self.scheduler.admit(self.pool.n_free):
            self.status[req.uid] = "active"
            self._counts["admitted"] += 1
            slot = self.pool.alloc()
            assert slot is not None
            P = len(req.prompt)
            toks = np.zeros((1, bucket if self._pad_ok else P), np.int64)
            toks[0, :P] = req.prompt
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            last = torch.full((1,), P - 1, dtype=torch.int64,
                              device=self.device)
            logits, caches = self._prefill.fn(self.params, batch, last)
            self.pool.write_prefill(slot, caches, P)
            self.slot_history[req.uid] = slot
            gen = request_generator(req.seed)
            tok = self._sample(req, logits[0, 0], gen)
            # TTFT on the engine clock: submit -> first generated token
            t0 = self._submit_t.get(req.uid)
            if t0 is not None:
                self._ttft.observe((self.clock() - t0) * 1e3)
            a = _Active(req=req, slot=slot, pos=P, n_gen=1, last_token=tok,
                        gen=gen)
            self._emit(a, tok)
            emitted.append((req.uid, tok))
            if self._finished(a, tok):
                self._retire(a)
            else:
                self.slots[slot] = a

    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: expire, admit waiting requests, then one
        batched decode over every occupied slot.  Returns the (uid, token)
        pairs emitted this step, in slot order."""
        emitted: List[Tuple[int, int]] = []
        self._tick += 1
        self._expire(self.clock())
        self._admit(emitted)
        active = [a for a in self.slots if a is not None]
        if not active:
            return emitted
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.zeros((self.n_slots,), np.int32)
        for a in active:
            tokens[a.slot, 0] = a.last_token
            pos[a.slot] = a.pos
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        pos_dev = torch.from_numpy(pos).to(self.device)
        t0 = time.perf_counter()
        logits, self.pool.caches = self._decode.fn(
            self.params, self.pool.caches, batch, pos_dev)
        n_tok = 0
        for a in active:
            tok = self._sample(a.req, logits[a.slot, 0], a.gen)
            a.n_gen += 1
            a.pos += 1
            self.pool.lengths[a.slot] += 1
            a.last_token = tok
            self._emit(a, tok)
            emitted.append((a.req.uid, tok))
            n_tok += 1
            if self._finished(a, tok):
                self._retire(a)
        # every active sequence gained one token this tick, so the tick's
        # wall time (decode + sampling, which waits for the device) IS its
        # per-token latency
        dur = time.perf_counter() - t0
        self._decode_win.append((dur, n_tok))
        self._tok_lat.observe(dur * 1e3)
        return emitted

    def stats(self) -> Dict[str, Any]:
        """Lifecycle counts, occupancy and sliding-window latency quantiles
        (TTFT and per-decode-tick latency, ms), plus decode tokens/s over
        the window."""
        win = list(self._decode_win)
        toks = sum(n for _, n in win)
        secs = sum(d for d, _ in win)
        return {
            "admitted": self._counts["admitted"],
            "completed": self._counts["completed"],
            "expired": self._counts["expired"],
            "queued": len(self.scheduler),
            "active": self.n_active,
            "occupancy": self.n_active / self.n_slots,
            "steps": self._tick,
            "ttft_ms": self._ttft.quantiles(),
            "tok_latency_ms": self._tok_lat.quantiles(),
            "tok_per_s": (toks / secs) if secs > 0 else None,
        }

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Drive until every submitted request retires; returns uid ->
        generated tokens (EOS included when hit)."""
        n = 0
        while not self.done:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps and not self.done:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps "
                    f"({self.n_active} active, {len(self.scheduler)} queued)")
        return self.results
