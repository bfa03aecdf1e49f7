"""Continuous-batching inference engine (slab and paged KV pools).

Port of the reference's ``serve/engine.py``: requests are admitted
whenever the KV pool has room, prefilled, then decoded TOGETHER with
every other in-flight request by one batched step — the per-sequence
position contract lets rows sit at different positions.  Retired slots
recycle to queued requests.

Step anatomy of the slab pool (``ServeEngine.step``):

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

Paged mode (``pool="paged"``) swaps the slab for a ``PagedKVPool``: a
page arena with per-slot page tables, resolved inside ONE paged step
(``steps.build_paged_step``) that serves batched decode (T = 1), chunked
prefill (B = 1, T = chunk) and speculative verify (T = spec_tokens + 1).
On the table ride the prefix cache (chain-hashed full prompt pages,
refcounted, LRU-retained), chunked prefill (every prompt ingests in
fixed chunks, one a tick, interleaved with decode ticks) and speculative
decoding (``draft=(model, params)``: the drafter proposes spec_tokens
greedily and the target verifies them in one multi-token step; greedy
output is the target's own, the drafter only sets how far each target
step advances).  Paged mode needs a dense attn-only stack (the model
refuses any other).

Weights stay in their flat ZeRO buffers and every layer group moves
through the qwZ INT8 gather on every step, as in the reference; the
layer loop's ring depth is the model's ``ZeroConfig.prefetch``.

Sharded serving (``mesh=``, a ``launch.mesh.Mesh`` of gloo ranks, one
process a rank, each holding its shard of every flat buffer): the slab
pool cuts its slots over ``batch_axes`` and each slot's cache sequence
over ``kv_axes``; the paged pool keeps the batch whole and cuts each
page's tokens over ``kv_axes``, every other axis a replica.  Prefill
runs replicated (batch 1, the whole prompt, as the reference's engine
builds it), each rank keeping its cut of the caches.  The reference's
global arrays keep its one host loop in step for free; here EVERY rank
runs the host loop, so every decision must come out the same on each:
every rank must be given the same requests in the same order
(``submit``), every model call's logits come back whole on every rank
(the decode step gathers its rows over the batch group), so each rank
samples the same tokens with the request's own seeded generator, and a
tick reads rank 0's clock, shared over the world, so deadlines expire
on the same tick everywhere.
``observer=`` sees every model call's logits (for checks that hold the
engine against a request run alone).
:meth:`ServeEngine.from_checkpoint` boots from a checkpoint (fp32 or
INT8, saved at any world) through the params-only bf16 load
(``train.state.load_serving_params``).  Boot-time tuning (``tune=
"static" | "probe"``, the reference's): the engine resolves a serve
policy through ``repro_torch.tune.resolve`` (``n_slots``, ``kv_len``, the
HBM ledger against ``hbm_gb`` GiB a rank, by default the card's memory
over the ranks sharing it), keeps it as ``self.policy`` and serves at its
ring depth (``Model.with_prefetch``); the depth changes no token.  Models fed by a
frontend stub (``embed_inputs``, ``mrope``) are refused as in the
reference: they serve through the raw ``serve.steps``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives as cl
from repro_torch.kernels import platform
from repro_torch.obs.metrics import Histogram
from repro_torch.serve import steps
from repro_torch.serve.kv_pool import KVPool, PagedKVPool
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


@dataclasses.dataclass(eq=False)        # identity equality: ndarray fields
class _Prefill:
    """A paged request mid-prefill: ``done``/``d_done`` are the next chunk
    start of the target / drafter (past a prefix-cache hit), and
    ``logits_row`` holds the target's last-prompt-token logits once its
    final chunk ran (the first token samples from it when BOTH models are
    done)."""
    req: Request
    slot: int
    done: int
    d_done: int
    logits_row: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Side:
    """One model of a paged engine, the target or the drafter: its paged
    step, its page pool and its params."""
    step: steps.ServeStep
    pool: PagedKVPool
    params: Dict[str, torch.Tensor]


# observer(kind, rows, logits): see ServeEngine
Observer = Callable[[str, List[Tuple[int, int, int]], torch.Tensor], None]


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
    """``observer(kind, rows, logits)``, when given, is called after every
    model call with its kind (``"prefill"`` or ``"decode"``; paged engines
    also ``"verify"``, and with a drafter ``"draft_prefill"`` and
    ``"draft"``), the requests it served as (uid, row, position) triples
    (``logits[row, j]`` is the output at the token in ``position + j``)
    and its (B, T, V) logits, which it must not modify (every row, on
    every rank of a mesh).

    ``mesh`` (default None: world 1) serves on a world of ranks, the
    model's world, with ``params`` this rank's shards
    (``train.state.load_serving_params(mesh=)``): slots cut over
    ``batch_axes`` (``n_slots`` must divide over them; the paged pool
    refuses any) and the cache sequence over ``kv_axes``.  ``tune`` and
    ``hbm_gb``: see the module docstring; ``self.policy`` is the resolved
    policy (None with ``tune="off"``)."""

    def __init__(self, model, params: Dict[str, torch.Tensor], *,
                 n_slots: int, kv_len: int, mesh=None,
                 batch_axes: Tuple[str, ...] = (),
                 kv_axes: Tuple[str, ...] = ("model",),
                 scheduler: Optional[FIFOScheduler] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 device="cuda", tune: str = "off",
                 hbm_gb: Optional[float] = None, pool: str = "slab",
                 page_size: int = 16, n_pages: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 prefix_cache: bool = True,
                 draft: Optional[Tuple[Any, Dict[str, torch.Tensor]]] = None,
                 spec_tokens: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 observer: Optional[Observer] = None):
        dev = platform.resolve_device(device)
        if dev.type != model.device.type:
            raise ValueError(f"engine on {dev} but the model runs on "
                             f"{model.device}")
        cfg = model.cfg
        self.policy = None
        if tune and tune != "off":
            # boot through the training's resolver (repro_torch.tune), serve
            # workload: the ledger charges the KV pool and the forward-only
            # ring, and the engine serves at the resolved ring depth
            from repro_torch.launch.mesh import Mesh
            from repro_torch.tune import GB, resolve
            from repro_torch.tune.memory import device_budget
            world_mesh = mesh if mesh is not None else Mesh((1, 1))
            budget = (int(hbm_gb * GB) if hbm_gb is not None
                      else device_budget(dev, world_mesh.world))
            self.policy = resolve(
                cfg, world_mesh.axes, "zeropp", mode=tune,
                mesh=world_mesh, hbm_budget_bytes=budget,
                workload="serve", n_slots=n_slots, kv_len=kv_len,
                device=dev)
            model = model.with_prefetch(self.policy.zcfg.prefetch)
        _refuse_stub_inputs(cfg)
        if "local" in model.period and kv_len < cfg.window:
            raise ValueError(
                f"kv_len={kv_len} below the sliding window {cfg.window}: "
                f"ring caches from prefill would not fit the pool")
        if pool not in ("slab", "paged"):
            raise ValueError(f"pool must be 'slab' or 'paged', got {pool!r}")
        if draft is not None and pool != "paged":
            raise ValueError("speculative decoding rides the paged step; "
                             "pass pool='paged'")
        if pool == "paged" and batch_axes:
            raise ValueError(
                "paged serving keeps the batch unsharded: the page arena is "
                "one global pool any slot may reference, incompatible with "
                f"batch_axes={tuple(batch_axes)}")
        self.world = 1 if mesh is None else mesh.world
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.pool_kind = pool
        cdtype = cache_dtype or model.zcfg.compute_dtype
        self.scheduler = scheduler if scheduler is not None \
            else FIFOScheduler(kv_len=kv_len)
        # prompts right-padded to buckets are exact only when every layer
        # masks by position (full attention): a ring would hold the pads
        self._pad_ok = set(model.period) == {"attn"}
        self.observer = observer
        self.draft_pool = None
        self._drafter: Optional[_Side] = None
        self._prefilling: List[_Prefill] = []
        if pool == "paged":
            self._chunk = chunk_size if chunk_size is not None \
                else min(kv_len, 2 * page_size)
            if self._chunk % page_size or self._chunk < 1:
                raise ValueError(f"chunk_size {self._chunk} must be a "
                                 f"positive multiple of page_size "
                                 f"{page_size}")
            self.pool = PagedKVPool(model, n_slots, kv_len,
                                    page_size=page_size, n_pages=n_pages,
                                    dtype=cdtype, prefix_cache=prefix_cache,
                                    mesh=mesh, kv_axes=kv_axes)
            # one step for every (B, T): (n_slots, 1) decode, (1, chunk)
            # prefill, (n_slots, g + 1) verify
            self._target = _Side(steps.build_paged_step(
                model, device=dev, mesh=mesh, kv_axes=kv_axes), self.pool,
                params)
            self._sides = [self._target]
            if draft is not None:
                dmodel, dparams = draft
                if dmodel.cfg.vocab != cfg.vocab:
                    raise ValueError(
                        f"drafter vocab {dmodel.cfg.vocab} != target vocab "
                        f"{cfg.vocab}")
                if spec_tokens < 2:
                    raise ValueError("spec_tokens must be >= 2 (one draft "
                                     "round must beat plain decode)")
                self.spec_tokens = spec_tokens
                # the drafter's arena stays at FULL page capacity (its
                # reservations then never fail while a slot is free), so
                # its slot ids always mirror the target pool's
                self.draft_pool = PagedKVPool(
                    dmodel, n_slots, kv_len, page_size=page_size,
                    dtype=cdtype, prefix_cache=prefix_cache, mesh=mesh,
                    kv_axes=kv_axes)
                self._drafter = _Side(
                    steps.build_paged_step(dmodel, device=dev, mesh=mesh,
                                           kv_axes=kv_axes),
                    self.draft_pool, dparams)
                self._sides.append(self._drafter)
                self._spec_hist = Histogram("serve.spec_accepted",
                                            window=512)
        else:
            self.pool = KVPool(model, n_slots, kv_len, dtype=cdtype,
                               mesh=mesh, batch_axes=batch_axes,
                               kv_axes=kv_axes)
            # prefill: batch 1, the whole prompt on every rank; decode: ONE
            # step for the whole pool, its rows over batch_axes
            self._prefill = steps.build_prefill_step(
                model, with_last_pos=True, device=dev, mesh=mesh)
            self._decode = steps.build_decode_step(
                model, device=dev, mesh=mesh, batch_axes=batch_axes,
                kv_axes=kv_axes)
        self.clock = clock                       # injectable for tests
        self.slots: List[Optional[_Active]] = [None] * n_slots
        self.results: Dict[int, List[int]] = {}
        self.status: Dict[int, str] = {}   # uid -> queued/active/done/timeout
        self.slot_history: Dict[int, int] = {}   # uid -> slot
        self._counts = {"admitted": 0, "completed": 0, "expired": 0,
                        "prefill_chunks": 0}
        self._submit_t: Dict[int, float] = {}     # uid -> clock() at submit
        self._ttft = Histogram("serve.ttft_ms", window=512)
        self._tok_lat = Histogram("serve.tok_latency_ms", window=512)
        self._decode_win: deque = deque(maxlen=256)  # (wall_s, toks) per tick
        self._tick = 0

    # ------------------------------------------------------------- boot

    @classmethod
    def from_checkpoint(cls, model, ckpt: str, *, dtype=torch.bfloat16,
                        mesh=None, **kw) -> "ServeEngine":
        """Boot from a checkpoint (per-shard fp32 or INT8 saved at any
        world, or a legacy npz; ``ckpt`` a checkpoint or a directory of
        them, the latest taken) via the params-only bf16 serving load,
        which refuses a checkpoint written for another arch; on a
        ``mesh`` each rank loads its shards.  ``kw``: the constructor's
        (``n_slots``, ``kv_len``, ``batch_axes``, ``pool``, ...)."""
        from repro_torch.train.state import load_serving_params
        _refuse_stub_inputs(model.cfg)
        params = load_serving_params(model, ckpt, dtype=dtype,
                                     expect_arch=model.cfg.name, mesh=mesh)
        return cls(model, params, mesh=mesh, **kw)

    # ---------------------------------------------------------- requests

    def submit(self, prompt, **kw) -> int:
        """Queue a request; returns its uid.  Keyword args mirror
        ``scheduler.Request`` (max_new_tokens, temperature, top_k, top_p,
        seed, eos_id, on_token, deadline).  On a mesh every rank must
        submit the same requests in the same order."""
        if self._drafter is not None and kw.get("temperature", 0.0) > 0:
            raise ValueError(
                "speculative decoding verifies greedily: temperature>0 "
                "requests are not token-identical under it")
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
        return not self.n_active and not self._prefilling \
            and not len(self.scheduler)

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

    def _release(self, slot: int) -> None:
        self.pool.free(slot)
        if self._drafter is not None:
            self.draft_pool.free(slot)

    def _observe(self, kind: str, rows: List[Tuple[int, int, int]],
                 logits: torch.Tensor) -> None:
        if self.observer is not None:
            self.observer(kind, rows, logits)

    @staticmethod
    def _rows(active: List[_Active], offset: int = 0
              ) -> List[Tuple[int, int, int]]:
        return [(a.req.uid, a.slot, a.pos + offset) for a in active]

    def _retire(self, a: _Active, status: str = "done") -> None:
        self.slots[a.slot] = None
        self._release(a.slot)
        self.status[a.req.uid] = status
        self._counts["completed" if status == "done" else "expired"] += 1

    def _expire(self, now: float) -> None:
        """Time out requests past their deadline: active and mid-prefill
        ones release their KV slot (and pages), queued ones never take
        one."""
        for req in self.scheduler.expire(now):
            self.status[req.uid] = "timeout"
            self._counts["expired"] += 1
        for a in list(self.slots):
            if a is not None and a.req.deadline is not None \
                    and now >= a.req.deadline:
                self._retire(a, status="timeout")
        for pf in list(self._prefilling):
            if pf.req.deadline is not None and now >= pf.req.deadline:
                self._prefilling.remove(pf)
                self._release(pf.slot)
                self.status[pf.req.uid] = "timeout"
                self._counts["expired"] += 1

    def _start(self, req: Request, slot: int, pos: int,
               logits_row: torch.Tensor,
               emitted: List[Tuple[int, int]]) -> None:
        """Sample a request's first token from its last prompt position's
        logits, stream it, and make the request active (or retire it)."""
        gen = request_generator(req.seed)
        tok = self._sample(req, logits_row, gen)
        # TTFT on the engine clock: submit -> first generated token
        t0 = self._submit_t.get(req.uid)
        if t0 is not None:
            self._ttft.observe((self.clock() - t0) * 1e3)
        a = _Active(req=req, slot=slot, pos=pos, n_gen=1, last_token=tok,
                    gen=gen)
        self._emit(a, tok)
        emitted.append((req.uid, tok))
        if self._finished(a, tok):
            self._retire(a)
        else:
            self.slots[slot] = a

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
            self._observe("prefill", [(req.uid, 0, P - 1)], logits)
            self.pool.write_prefill(slot, caches, P)
            self.slot_history[req.uid] = slot
            self._start(req, slot, P, logits[0, 0], emitted)

    def _decode_slab(self, active: List[_Active],
                     emitted: List[Tuple[int, int]]) -> None:
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
        self._observe("decode", self._rows(active), logits)
        self._commit(active, logits, emitted, t0)

    def _commit(self, active: List[_Active], logits: torch.Tensor,
                emitted: List[Tuple[int, int]], t0: float) -> None:
        """Sample each active row's next token from its (slot, 0) logits,
        advance it and stream the token; the tick's wall time from ``t0``
        (the step + sampling, which waits for the device) IS its
        per-token latency, since every active sequence gained one token."""
        n_tok = 0
        for a in active:
            tok = self._sample(a.req, logits[a.slot, 0], a.gen)
            a.n_gen += 1
            a.pos += 1
            self.pool.lengths[a.slot] = a.pos
            a.last_token = tok
            self._emit(a, tok)
            emitted.append((a.req.uid, tok))
            n_tok += 1
            if self._finished(a, tok):
                self._retire(a)
        self._observe_tick(t0, n_tok)

    def _observe_tick(self, t0: float, n_tok: int) -> None:
        dur = time.perf_counter() - t0
        self._decode_win.append((dur, n_tok))
        self._tok_lat.observe(dur * 1e3)

    # ------------------------------------------------------- paged engine

    def _run_paged(self, side: _Side, kind: str,
                   rows: List[Tuple[int, int, int]], tokens: np.ndarray,
                   table: np.ndarray, start: np.ndarray) -> torch.Tensor:
        """One paged step of ``side`` on the (B, T) tokens, (B, Pm) page
        table and (B,) start positions: advances its pool's arena in place
        and returns the (B, T, V) logits (``kind`` and ``rows`` are the
        observer's)."""
        batch = {"tokens": torch.from_numpy(
            np.asarray(tokens, np.int64)).to(self.device)}
        logits, side.pool.caches = side.step.fn(
            side.params, side.pool.caches, batch,
            np.asarray(table, np.int32), np.asarray(start, np.int32))
        self._observe(kind, rows, logits)
        return logits

    def _admit_paged(self) -> None:
        """Admit while a slot AND the full page reservation fit.  A head
        whose pages do not fit blocks the queue (strict FIFO): reservations
        are all or nothing, so a refused head changes nothing and retries
        next tick."""
        while self.pool.n_free:
            req = self.scheduler.peek()
            if req is None:
                break
            res = self.pool.alloc(req.prompt, req.max_new_tokens,
                                  align=self._chunk)
            if res is None:
                break
            slot, matched = res
            d_matched = matched
            if self._drafter is not None:
                # reserve the drafter's spec_tokens of lookahead too; its
                # full-capacity arena makes this infallible slot for slot
                dres = self.draft_pool.alloc(
                    req.prompt, req.max_new_tokens + self.spec_tokens,
                    align=self._chunk)
                assert dres is not None and dres[0] == slot, \
                    "drafter pool must mirror target slots"
                d_matched = dres[1]
            self.scheduler.pop()
            self.status[req.uid] = "active"
            self._counts["admitted"] += 1
            self.slot_history[req.uid] = slot
            self._prefilling.append(
                _Prefill(req=req, slot=slot, done=matched,
                         d_done=d_matched))

    def _prefill_chunk(self, side: _Side, kind: str, pf: _Prefill,
                       start: int) -> Tuple[torch.Tensor, int]:
        """Run ONE fixed-size prefill chunk of ``pf`` from ``start`` on
        ``side`` (zero-padded past the prompt; the pad's KV is causally
        masked and later overwritten by decode writes at those positions).
        Returns the logits and the next chunk's start."""
        prompt = pf.req.prompt
        end = min(start + self._chunk, len(prompt))
        toks = np.zeros((1, self._chunk), np.int64)
        toks[0, : end - start] = prompt[start:end]
        logits = self._run_paged(side, kind, [(pf.req.uid, 0, start)], toks,
                                 side.pool.table[pf.slot: pf.slot + 1],
                                 np.full((1,), start, np.int32))
        return logits, end

    def _prefill_tick(self, emitted: List[Tuple[int, int]]) -> None:
        """Advance every mid-prefill request by ONE chunk (target and, when
        drafting, drafter): the chunk quantum lets decode ticks interleave
        with long-prompt ingestion.  A request whose models have both
        finished samples its first token here."""
        for pf in list(self._prefilling):
            P = len(pf.req.prompt)
            if pf.done < P:
                s = pf.done
                logits, pf.done = self._prefill_chunk(self._target,
                                                      "prefill", pf, s)
                self._counts["prefill_chunks"] += 1
                if pf.done >= P:
                    # the final chunk: the row of the LAST prompt token
                    pf.logits_row = logits[0, (P - 1) - s]
            if self._drafter is not None and pf.d_done < P:
                _, pf.d_done = self._prefill_chunk(
                    self._drafter, "draft_prefill", pf, pf.d_done)
            if pf.done >= P and (self._drafter is None
                                 or pf.d_done >= P):
                self._finish_prefill(pf, emitted)

    def _finish_prefill(self, pf: _Prefill,
                        emitted: List[Tuple[int, int]]) -> None:
        req, slot = pf.req, pf.slot
        P = len(req.prompt)
        self._prefilling.remove(pf)
        for side in self._sides:
            side.pool.lengths[slot] = P
            side.pool.register_prefix(slot, req.prompt)
        self._start(req, slot, P, pf.logits_row, emitted)

    def _active_rows(self, active: List[_Active], width: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tokens, start, table) step inputs with NON-active rows fully
        masked: an all-(-1) table row writes nothing and attends to
        nothing, so idle and prefilling slots riding the batched step never
        touch pages they do not own (shared prefix pages included)."""
        tokens = np.zeros((self.n_slots, width), np.int64)
        start = np.zeros((self.n_slots,), np.int32)
        table = np.full_like(self.pool.table, -1)
        for a in active:
            tokens[a.slot, 0] = a.last_token
            start[a.slot] = a.pos
            table[a.slot] = self.pool.table[a.slot]
        return tokens, start, table

    def _decode_paged(self, active: List[_Active],
                      emitted: List[Tuple[int, int]]) -> None:
        tokens, start, table = self._active_rows(active, 1)
        t0 = time.perf_counter()
        logits = self._run_paged(self._target, "decode", self._rows(active),
                                 tokens, table, start)
        self._commit(active, logits, emitted, t0)

    def _spec_tick(self, active: List[_Active],
                   emitted: List[Tuple[int, int]]) -> None:
        """One speculative round: g greedy drafter steps propose x_1..x_g,
        ONE multi-token target step verifies positions p..p+g, and each row
        commits the longest draft prefix the target agrees with, plus one
        bonus token from the target's own logits.

        Acceptance is capped at g - 1 drafts (g emitted tokens): accepting
        all g would leave a hole at p + g in the drafter's cache (x_g was
        proposed but never written).  Rejected positions hold garbage KV in
        both caches; the next round's writes cover [p', p' + g], which
        holds that garbage, before anything reads it.  Every emitted token
        is a target argmax given the committed stream, so the output is
        target-only greedy decode's: the drafter only sets the stride."""
        g = self.spec_tokens
        tokens, start, ttable = self._active_rows(active, g + 1)
        dtable = np.full_like(self.draft_pool.table, -1)
        for a in active:
            dtable[a.slot] = self.draft_pool.table[a.slot]
        x = tokens                                    # x[:, 0] = pending
        t0 = time.perf_counter()
        for j in range(g):
            dlogits = self._run_paged(self._drafter, "draft",
                                      self._rows(active, j), x[:, j: j + 1],
                                      dtable, start + j)
            x[:, j + 1] = torch.argmax(dlogits[:, 0, :], dim=-1).cpu().numpy()
        vlogits = self._run_paged(self._target, "verify", self._rows(active),
                                  x, ttable, start)
        truth = torch.argmax(vlogits, dim=-1).cpu().numpy()
        n_tok = 0
        for a in active:
            p = a.pos
            m = 0
            while True:
                tok = int(truth[a.slot, m])
                a.n_gen += 1
                a.pos = p + m + 1
                a.last_token = tok
                for side in self._sides:
                    side.pool.lengths[a.slot] = a.pos
                self._emit(a, tok)
                emitted.append((a.req.uid, tok))
                n_tok += 1
                if self._finished(a, tok):
                    self._retire(a)
                    break
                if m >= g - 1 or int(x[a.slot, m + 1]) != tok:
                    break
                m += 1
            self._spec_hist.observe(m + 1)
        self._observe_tick(t0, n_tok)

    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: expire, admit waiting requests, then one
        batched decode over every occupied slot.  Returns the (uid, token)
        pairs emitted this step, in slot order.  Paged mode first runs one
        prefill chunk per mid-prefill request, then the decode (or
        speculative) tick."""
        emitted: List[Tuple[int, int]] = []
        self._tick += 1
        self._expire(self._now())
        if self.pool_kind == "paged":
            self._admit_paged()
            self._prefill_tick(emitted)
        else:
            self._admit(emitted)
        active = [a for a in self.slots if a is not None]
        if not active:
            return emitted
        if self.pool_kind == "slab":
            self._decode_slab(active, emitted)
        elif self._drafter is not None:
            self._spec_tick(active, emitted)
        else:
            self._decode_paged(active, emitted)
        return emitted

    def _now(self) -> float:
        """The tick's clock reading: rank 0's ``clock()`` on every rank of
        a mesh (a MAX all-reduce to which only rank 0 contributes), so
        that every rank expires the same requests at the same tick."""
        t = self.clock()
        if self.world == 1:
            return t
        x = torch.tensor([t if cl.flat_rank() == 0 else -float("inf")],
                         dtype=torch.float64)
        cl.all_reduce(x, op="max")
        return float(x[0])

    def stats(self) -> Dict[str, Any]:
        """Lifecycle counts, occupancy and sliding-window latency quantiles
        (TTFT and per-decode-tick latency, ms), plus decode tokens/s over
        the window.  Paged engines add the prefill chunks run, the requests
        mid-prefill and the pool's utilization and prefix-cache counters;
        speculative ones the accepted tokens per verify (with its mean)."""
        win = list(self._decode_win)
        toks = sum(n for _, n in win)
        secs = sum(d for d, _ in win)
        out = {
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
        if self.pool_kind == "paged":
            out["prefill_chunks"] = self._counts["prefill_chunks"]
            out["prefilling"] = len(self._prefilling)
            out["pool"] = self.pool.utilization()
            if self._drafter is not None:
                q = self._spec_hist.quantiles()
                q["mean"] = self._spec_hist.mean
                out["spec_accepted"] = q
        return out

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
