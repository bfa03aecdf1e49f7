"""Elastic fault-tolerant training runtime: the async checkpoint writer and
the supervisor.

Port of the reference's ``train/elastic.py``, with its names, counters,
events and ``[elastic]`` log lines:

  * :class:`AsyncCheckpointWriter` — snapshots (params, opt) on the device
    (the trainer updates both in place, so the snapshot must not alias
    them) and writes the per-shard checkpoint on a background thread,
    overlapped with the steps that follow.  Never more than ONE write in
    flight: a second ``submit`` blocks until the first commits
    (backpressure).  The write is ``ZeroState.save``'s staged commit
    (shards + fsync, manifest + fsync, atomic rename), so a crash at any
    point never leaves a checkpoint ``latest_checkpoint`` would select.
    An in-flight write can be abandoned (preemption past its grace): the
    staging dir is swept and no manifest is published.
  * :class:`Supervisor` — the preempt/reshard/resume state machine around
    the step loop: restore via ``ZeroState.restore_resilient``, restart
    from the newest committed checkpoint after a :class:`WorkerDeath`,
    drain or abandon the in-flight write on SIGTERM within a grace
    deadline (then a final synchronous checkpoint), and LIVE resharding
    onto another world mid-run through host memory only (no checkpoint
    file is read or written).

Where the port departs from the reference (one process per rank here,
every rank in one process there):

  * The supervisor lives in the launching process.  At world 1 it trains
    there; beyond, each segment of the run (from a start, a resume or a
    reshard to the next reshard step, a preemption, a death or the end)
    is one ``mesh.spawn`` of its world, whose ranks run the same step
    loop (:meth:`Supervisor._segment`) on copies of the fault plan, the
    reshard plan and the io hooks; rank 0's copies come back into the
    caller's objects when the world ends.  A restart spawns the world
    again, which restores from the newest committed checkpoint.
  * A live reshard hands the state over in shared memory: the old world's
    ranks write their shards into the launcher's global buffers (CPU
    tensors in ``/dev/shm``, which ``torch.multiprocessing`` passes to a
    process as a handle, not a copy), and the next world's ranks (or the
    launcher, at world 1) take their cut through ``ZeroState.place_global``.
  * An injected death is caught in each rank, which abandons and closes
    its writer and returns "died": the spawn returns and the launcher
    raises :class:`WorkerDeath`.  Any other exception fails the spawn.
  * At world > 1 the writer's collectives (``ZeroState.save``'s failure
    exchange and checksum gather) run on a gloo group of its own, made on
    the main thread in the same order on every rank, so that they never
    interleave with the step's; an abandoned write reaches the peers as
    ``SaveCancelled``, which every rank counts as abandoned.
  * A preemption request (SIGTERM to the launcher, which sets an
    ``mp.Event`` the ranks read, or an injected preempt) is agreed by one
    all-reduce of a flag at each step boundary, outside the wire
    counters, so every rank stops at the same step.
  * On the card, ``submit`` records an event after its device copy; the
    writer thread waits for it on a CUDA stream of its own and copies the
    snapshot to the host there, so the next step's kernels never queue
    behind the copy.

Fault injection lives in ``repro_torch.testing.faults``; this module only
defines the exception it raises, so production code never imports the
harness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.models.model import Model
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.policy import make_policy
from repro_torch.train.state import (CheckpointError, SaveCancelled,
                                     ZeroState, _call_hook, copy_rows,
                                     init_shards)

__all__ = ["WorkerDeath", "WriterStats", "AsyncCheckpointWriter",
           "ElasticConfig", "Supervisor"]


class WorkerDeath(RuntimeError):
    """A worker died mid-step (injected by the fault harness): whatever
    was in device memory is lost; the supervisor restores from the latest
    committed checkpoint and replays."""


class _Abandoned(SaveCancelled):
    """Internal: the in-flight write was cancelled between I/O stages."""


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    """The tensors of a tree, in :func:`_tree_map`'s order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# async checkpoint writer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WriterStats:
    submitted: int = 0
    completed: int = 0
    abandoned: int = 0
    failed: int = 0
    steps_overlapped: int = 0    # train steps finished while a write ran
    last_step: Optional[int] = None
    last_path: Optional[str] = None
    # seconds of each committed write (host copy + save) and of each
    # submit's stall of the loop (backpressure wait + device copy)
    write_s: List[float] = dataclasses.field(default_factory=list)
    submit_s: List[float] = dataclasses.field(default_factory=list)


class _CancellableHooks:
    """Wrap user io_hooks with a cancellation check at every stage, so an
    ``abandon()`` lands before the manifest commit even when the inner
    hook (e.g. a SlowIO sleep) is what's eating the time; and between the
    members of a shard file, so it need not wait for the whole file (a
    state of 5 GB takes seconds to write)."""

    def __init__(self, cancel: threading.Event, inner: Any):
        self._cancel = cancel
        self._inner = inner

    def _stage(self, name: str, *args) -> None:
        if self._cancel.is_set():
            raise _Abandoned(name)
        _call_hook(self._inner, name, *args)
        if self._cancel.is_set():
            raise _Abandoned(name)

    def mid_shard(self, path: str) -> None:
        self._stage("mid_shard", path)

    def post_shard(self, path: str) -> None:
        self._stage("post_shard", path)

    def pre_manifest(self, staging: str) -> None:
        self._stage("pre_manifest", staging)

    def pre_publish(self, staging: str, final: str) -> None:
        self._stage("pre_publish", staging, final)


class AsyncCheckpointWriter:
    """Background per-shard checkpoint writer, never more than one write
    in flight.

    ``submit`` copies (params, opt) on their device — required because
    the trainer updates them in place and would otherwise overwrite the
    snapshot mid-write — then hands it to a daemon thread that copies it
    to the host (on the card: on a stream of its own, after an event
    recorded at ``submit``, into pinned buffers the writer keeps from one
    write to the next: a pageable copy of the state stalls the steps
    beside it for its whole length) and runs ``ZeroState.save``.  ``note_step()``
    (called by the step loop after each completed step) counts overlap;
    ``drain()`` blocks until idle; ``abandon()`` cancels the in-flight
    write before its manifest commit.  Every rank of the world makes its
    writer at the same point (at world > 1 the constructor makes the
    writer's gloo group) and submits the same steps.
    """

    def __init__(self, model, mesh, ckpt_dir: str, *,
                 fmt: str = "fp32", io_hooks: Any = None,
                 retries: int = 0, backoff: float = 0.05,
                 on_commit: Optional[Callable[[int, str], None]] = None):
        self.model, self.mesh = model, mesh
        self.ckpt_dir, self.fmt = ckpt_dir, fmt
        self.retries, self.backoff = retries, backoff
        self.on_commit = on_commit
        self.stats = WriterStats()
        # the save's collectives on a group of their own (main thread,
        # same order on every rank): never interleaved with the step's
        self.group = dist.new_group(backend="gloo") if mesh.world > 1 \
            else None
        dev = model.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
        self._pinned: Optional[List[torch.Tensor]] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._cancel = threading.Event()
        self._hooks = _CancellableHooks(self._cancel, io_hooks)
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, name="ckpt-writer", daemon=True)
        self._thread.start()

    # -------------------------------------------------------- public API

    def in_flight(self) -> bool:
        return not self._idle.is_set()

    def note_step(self) -> None:
        with self._lock:
            if not self._idle.is_set():
                self.stats.steps_overlapped += 1

    def submit(self, step: int, params, opt,
               meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot on the device and enqueue the write.  Blocks while a
        previous write is still in flight (backpressure — bounded queue of
        one), never on the disk write itself; on the card not on the copy
        either (the next step is queued behind it on the same stream)."""
        t0 = time.perf_counter()
        self._idle.wait()
        self._raise_pending()
        snap = _tree_map(lambda t: t.detach().clone(), (params, opt))
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        with self._lock:
            self.stats.submitted += 1
            self.stats.submit_s.append(time.perf_counter() - t0)
            self._idle.clear()
        self._queue.put((int(step), snap, ready, dict(meta or {})))

    def drain(self, timeout: Optional[float] = None) -> Optional[str]:
        """Wait for the in-flight write (if any) to commit; re-raises a
        write failure.  Returns the last committed checkpoint path."""
        if not self._idle.wait(timeout):
            raise TimeoutError("async checkpoint write did not finish "
                               f"within {timeout}s")
        self._raise_pending()
        return self.stats.last_path

    def abandon(self) -> bool:
        """Cancel the in-flight write (no manifest is published; the
        staging dir is swept).  Returns True if a write was cancelled."""
        if self._idle.is_set():
            return False
        self._cancel.set()
        self._idle.wait()
        self._cancel.clear()
        return True

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=120)
        self._pinned = None

    # ---------------------------------------------------------- internal

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _to_host(self, snap, ready):
        """The snapshot on the host: on the card copied into the pinned
        buffers on the writer's stream once ``submit``'s event has passed
        (the copy leaves the default stream to the steps)."""
        if self._stream is None:
            return snap
        leaves = list(_leaves(snap))
        if self._pinned is None or [(p.shape, p.dtype) for p in
                                    self._pinned] != [(t.shape, t.dtype)
                                                      for t in leaves]:
            self._pinned = None
            self._pinned = [torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in leaves]
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for p, t in zip(self._pinned, leaves):
                p.copy_(t, non_blocking=True)
        self._stream.synchronize()
        bufs = iter(self._pinned)
        return _tree_map(lambda t: next(bufs), snap)

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, snap, ready, meta = item
            item = None
            try:
                t0 = time.monotonic()
                params, opt = self._to_host(snap, ready)
                snap = None              # the device copy goes back now
                st = ZeroState(self.model, self.mesh, params, opt, step=step)
                path = st.save(self.ckpt_dir, meta=meta, fmt=self.fmt,
                               io_hooks=self._hooks, retries=self.retries,
                               backoff=self.backoff, group=self.group)
                dt = time.monotonic() - t0
                get_registry().histogram("elastic.ckpt.write_ms").observe(
                    dt * 1e3)
                with self._lock:
                    self.stats.completed += 1
                    self.stats.last_step, self.stats.last_path = step, path
                    self.stats.write_s.append(dt)
                if self.on_commit is not None:
                    self.on_commit(step, path)
            except SaveCancelled:
                # this rank's abandon (_Abandoned) or a peer's, shared by
                # the save's failure exchange
                with self._lock:
                    self.stats.abandoned += 1
            except CheckpointError as e:
                # retries exhausted inside save() can surface a
                # cancellation as the root cause — classify it as such
                with self._lock:
                    if isinstance(e.__cause__, SaveCancelled):
                        self.stats.abandoned += 1
                    else:
                        self.stats.failed += 1
                        self._error = e
            except BaseException as e:   # surfaced on next submit/drain
                with self._lock:
                    self.stats.failed += 1
                    self._error = e
            finally:
                snap = params = opt = st = None
                self._idle.set()


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticConfig:
    """One elastic training run (mirrors ``launch/train`` CLI args).
    ``arch`` is a registered name or an ``ArchConfig`` (e.g. a depth-cut
    copy); ``device`` "cuda" (the card) or "cpu" (the kernels' plain
    versions, for tests); ``attn`` the attention route ("pallas": the
    flash kernels)."""
    arch: Union[str, ArchConfig] = "gpt-350m"
    reduced: bool = True
    mesh: Tuple[int, ...] = (4, 2)
    variant: str = "zeropp"
    steps: int = 10
    batch: int = 16
    seq: int = 64
    lr: float = 3e-3
    accum: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    ckpt_format: str = "fp32"
    async_ckpt: bool = True
    retries: int = 0
    backoff: float = 0.05
    grace: float = 30.0          # seconds between preempt signal and exit
    max_restarts: int = 3
    log: bool = True
    metrics_dir: Optional[str] = None   # jsonl event log
    device: str = "cuda"
    attn: str = "xla"


# what a segment's ranks take from the launcher and give back to it
_CARRY = ("faults", "reshard_plan", "io_hooks", "losses", "step_log",
          "writers", "restore_s", "recover_s", "reshard_s", "_t_death")


def _world(shape) -> int:
    return math.prod(int(s) for s in shape)


def _shm(shape, dtype) -> torch.Tensor:
    """An empty CPU tensor in shared memory (a process it is sent to maps
    the same pages), made in place: ``share_memory_()`` of a fresh tensor
    copies it into the segment page by page (12.7 s for a 5 GB state on the
    card's host, ``testing/ckpt_probe.py``)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    storage = torch.UntypedStorage._new_shared(nbytes)
    return torch.empty(0, dtype=dtype).set_(storage, 0, tuple(shape))


@contextlib.contextmanager
def _pinned(tensors, card: bool):
    """On the card, page-lock the host tensors (shared buffers) for a block
    of copies to or from it: the card's host maps a shared page on first
    touch at ≈ 2.4 s a GB, ``cudaHostRegister`` maps a 5 GB state in 1.1 s
    (0.4 s to release) and the copies then run at DMA speed, 0.1 s against
    0.8-2.9 s pageable (``testing/ckpt_probe.py``).  Elsewhere a no-op."""
    locked = []
    rt = torch.cuda.cudart() if card else None
    try:
        for t in tensors if card else ():
            n = t.numel() * t.element_size()
            if n >= 1 << 20:
                err = rt.cudaHostRegister(t.data_ptr(), n, 0)
                if err != rt.cudaError.success:
                    raise RuntimeError(f"cudaHostRegister failed: {err}")
                locked.append(t)
        yield
    finally:
        for t in locked:
            rt.cudaHostUnregister(t.data_ptr())


def _buffer_shapes(cfg: ElasticConfig, shape) -> Dict[str, Tuple[int, ...]]:
    """Every flat buffer's global (padded) shape on a world of ``shape``,
    as its ranks' model lays it out (the launcher has no process group to
    build that model with)."""
    arch = launch.resolve_arch(cfg.arch, cfg.reduced)
    z = make_policy(arch, mesh_lib.axes_of(tuple(shape)), cfg.variant).zcfg
    return Model(arch, z, world=_world(shape), device="cpu").param_shapes()


def _host_dtype(t: torch.Tensor) -> torch.dtype:
    """A state buffer's dtype in host memory: floats as fp32 (bf16 moments
    widen exactly, and ``place_global`` narrows them back; numpy, which
    reads the buffers, has no bf16)."""
    return torch.float32 if t.is_floating_point() else t.dtype


def _state_box(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Any]:
    """Shared global buffers for a state of ``shapes`` (fp32 params and
    moments, the int32 step count)."""
    def tree():
        return {k: _shm(s, torch.float32) for k, s in shapes.items()}
    return {"params": tree(),
            "opt": {"m": tree(), "v": tree(),
                    "count": _shm((), torch.int32)}}


def _adopt(mine: Any, theirs: Any) -> None:
    """Bring a rank's copy of a stateful object (a fault plan, io hooks)
    back into the caller's object."""
    if mine is not None and theirs is not None and mine is not theirs:
        vars(mine).update(vars(theirs))


def _world_rank(rank: int, world: int, cfg: ElasticConfig, shape,
                carry: Dict[str, Any], init: Optional[Dict[str, Any]],
                box: Optional[Dict[str, Any]], preempt) -> Dict[str, Any]:
    """One rank of a spawned segment: a rank-side supervisor (rank 0 logs
    and writes the event log) runs the step loop; an injected death
    abandons and closes the writer and is returned as "died"."""
    sub = dataclasses.replace(
        cfg, log=cfg.log and rank == 0,
        metrics_dir=cfg.metrics_dir if rank == 0 else None)
    sup = Supervisor(sub)
    for k in _CARRY:
        setattr(sup, k, carry[k])
    sup._shared = preempt
    try:
        try:
            out = sup._segment(shape, init, box)
        except WorkerDeath as e:
            sup._retire_writer(abandon=True)
            out = {"status": "died", "reason": str(e), "writer_stats": None}
    finally:
        if sup._own_tracer:
            sup.tracer.close()
    out["launches"] = sup._launches
    out["carry"] = {k: getattr(sup, k) for k in _CARRY}
    return out


class Supervisor:
    """Preempt/reshard/resume state machine around the train loop.

    ::

        RUN --WorkerDeath--> RESTORE (restore_resilient) --> RUN
        RUN --SIGTERM/preempt--> DRAIN|ABANDON --> final sync ckpt --> EXIT
        RUN --reshard@step--> host buffers -> rebuild -> place_global --> RUN

    ``reshard_plan`` maps step -> new mesh shape; the transition moves the
    global buffers through host memory only (``ZeroState.place_global``),
    never through a checkpoint file, so it works with ``ckpt_dir=None``.
    ``faults`` is a ``testing.faults.StepFaults`` plan (or None) and
    ``io_hooks`` plugs into every checkpoint write this supervisor makes.

    Step markers are printed with full float repr so a subprocess harness
    can compare post-resume losses bit-for-bit against an oracle run.

    Besides the reference's result, ``run`` returns what the card's
    measurements read: ``steps`` ((step, loss, wall s, whether a write was
    in flight at its end) for every step run, replays included; rank 0's
    at world > 1), ``writers``
    (every writer's stats, restarts included), ``restore_s``,
    ``recover_s`` (from a death to the end of the first replayed step),
    ``reshard_s`` (from the old world's stop at the reshard step to the
    state placed on the new one) and ``launches`` (kernel launches summed over every rank).
    """

    def __init__(self, cfg: ElasticConfig, *, faults: Any = None,
                 reshard_plan: Optional[Dict[int, Tuple[int, ...]]] = None,
                 io_hooks: Any = None):
        self.cfg = cfg
        self.faults = faults
        self.reshard_plan = dict(reshard_plan or {})
        self.io_hooks = io_hooks
        self.writer: Optional[AsyncCheckpointWriter] = None
        self.losses: Dict[int, float] = {}
        self.restarts = 0
        self.resharded: List[Tuple[int, int, int]] = []
        self.step_log: List[Tuple[int, float, float, bool]] = []
        self.writers: List[Dict[str, Any]] = []
        self.restore_s: List[float] = []
        self.recover_s: List[float] = []
        self.reshard_s: List[float] = []
        self._launches: Dict[str, int] = {}
        self._t_death: Optional[float] = None
        self._preempt = threading.Event()
        self._shared = None     # the mp.Event a spawned world's ranks read
        self._deadline: Optional[float] = None
        # Per-step counter records go to an append-mode jsonl log so a
        # restart EXTENDS the history; replay_counters dedupes re-emitted
        # steps (resume from an earlier checkpoint) per (name, step),
        # which is the telemetry-under-failure invariant the fault harness
        # asserts.  Without metrics_dir, the process tracer (usually the
        # disabled singleton) is used and owns its own life.
        if cfg.metrics_dir:
            self.tracer: Tracer = Tracer(
                os.path.join(cfg.metrics_dir, "events.jsonl"))
            self._own_tracer = True
        else:
            self.tracer = get_tracer()
            self._own_tracer = False

    # ------------------------------------------------------------ events

    def _log(self, msg: str) -> None:
        if self.cfg.log:
            print(f"[elastic] {msg}", flush=True)

    def request_preempt(self, grace: Optional[float] = None) -> None:
        if grace is not None:
            self._deadline = time.monotonic() + grace
        self._preempt.set()
        if self._shared is not None:
            self._shared.set()

    def install_signal_handlers(self) -> None:
        """Route SIGTERM into a graceful preemption (main thread only)."""
        def handler(signum, frame):
            self._log(f"signal {signum}: preemption requested "
                      f"(grace {self.cfg.grace}s)")
            self.request_preempt(self.cfg.grace)
        signal.signal(signal.SIGTERM, handler)

    def _on_commit(self, step: int, path: str) -> None:
        # runs on the writer thread: emit only (GIL-atomic list append);
        # the step loop's per-step flush carries it to disk
        self.tracer.event("elastic.ckpt.commit", step=step)
        self._log(f"committed step {step} -> {os.path.basename(path)}")

    def _make_writer(self, model, mesh) -> Optional[AsyncCheckpointWriter]:
        cfg = self.cfg
        if not (cfg.ckpt_dir and cfg.ckpt_every and cfg.async_ckpt):
            return None
        return AsyncCheckpointWriter(
            model, mesh, cfg.ckpt_dir, fmt=cfg.ckpt_format,
            io_hooks=self.io_hooks, retries=cfg.retries,
            backoff=cfg.backoff, on_commit=self._on_commit)

    def _retire_writer(self, abandon: bool = False
                       ) -> Optional[Dict[str, Any]]:
        """Close the writer (abandoning its write: the process "died"),
        keep its stats in ``writers`` and return them."""
        w, self.writer = self.writer, None
        if w is None:
            return None
        if abandon:
            w.abandon()
        w.close()
        stats = dataclasses.asdict(w.stats)
        self.writers.append(stats)
        return stats

    def _stop_requested(self, world: int) -> bool:
        """Whether to stop for a preemption at this step boundary: this
        process's request or the launcher's, agreed over the world by one
        all-reduce (not a counted collective: it moves no model bytes), so
        that every rank stops at the same step."""
        want = self._preempt.is_set() or (
            self._shared is not None and self._shared.is_set())
        if world > 1:
            flag = torch.tensor([int(want)], dtype=torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if flag.item() and not self._preempt.is_set():
                self.request_preempt(self.cfg.grace)   # the grace runs here
            return bool(flag.item())
        return want

    # ------------------------------------------------------------- drive

    def run_supervised(self) -> Dict[str, Any]:
        """:meth:`run` under the restart policy: a worker death tears the
        run down (abandoning any in-flight write — the process "died")
        and re-enters, which restores from the latest committed
        checkpoint."""
        attempt = 0
        while True:
            try:
                return self.run()
            except WorkerDeath as e:
                self._retire_writer(abandon=True)
                attempt += 1
                if attempt > self.cfg.max_restarts or not self.cfg.ckpt_dir:
                    raise
                self.restarts += 1
                get_registry().counter("elastic.restarts").inc()
                self.tracer.event("elastic.restart", attempt=attempt,
                                  reason=str(e))
                self.tracer.flush()
                self._log(f"restarting after worker death "
                          f"({attempt}/{self.cfg.max_restarts}): {e}")

    def run(self) -> Dict[str, Any]:
        """One attempt: segments of the run, each on its world (this
        process at world 1, a spawned world beyond), from the newest
        checkpoint (or the seed) to the end, a preemption or a death; a
        reshard step ends a segment and hands its state to the next."""
        shape = tuple(int(s) for s in self.cfg.mesh)
        init = None
        while True:
            if _world(shape) == 1:
                seg = self._segment(shape, init)
            else:
                seg = self._spawn(shape, init)
            if seg["status"] == "died":
                raise WorkerDeath(seg["reason"])
            if seg["status"] != "reshard":
                break
            get_registry().counter("elastic.reshards").inc()
            new = tuple(int(s) for s in seg["to"])
            self.resharded.append((seg["step"], _world(shape), _world(new)))
            init = {"step": seg["step"], "world": _world(shape),
                    "t_stop": seg["t_stop"], "hand_s": seg["hand_s"],
                    "params": seg["state"]["params"],
                    "opt": seg["state"]["opt"]}
            shape = new
        status, i, stats = seg["status"], seg["step"], seg["writer_stats"]
        reg = get_registry()
        if stats is not None and stats["submitted"]:
            reg.gauge("elastic.ckpt.overlap_fraction").set(
                stats["steps_overlapped"] / stats["submitted"])
        self.tracer.event("elastic.run_end", status=status, final_step=i)
        if self._own_tracer:
            self.tracer.close()   # append-mode: a restart re-opens cleanly
        else:
            self.tracer.flush()
        return {"status": status, "final_step": i,
                "losses": dict(self.losses), "restarts": self.restarts,
                "resharded": list(self.resharded), "writer_stats": stats,
                "fired": list(self.faults.fired) if self.faults else [],
                "steps": list(self.step_log), "writers": list(self.writers),
                "restore_s": list(self.restore_s),
                "recover_s": list(self.recover_s),
                "reshard_s": list(self.reshard_s),
                "launches": dict(self._launches)}

    def _spawn(self, shape, init) -> Dict[str, Any]:
        """One segment on a spawned world of ``shape``: the ranks take the
        carried state, the launcher's preempt event, the handed-over
        buffers and, where the plan may reshard, the shared buffers they
        leave their state in; rank 0's carry comes back here."""
        cfg = self.cfg
        if self._shared is None:
            self._shared = mp.get_context("spawn").Event()
            if self._preempt.is_set():
                self._shared.set()
        box = None
        if any(tuple(s) != shape for s in self.reshard_plan.values()):
            box = _state_box(_buffer_shapes(cfg, shape))
        carry = {k: getattr(self, k) for k in _CARRY}
        self.tracer.flush()      # rank 0 appends to the same log
        if cfg.device == "cuda":  # the ranks share this process's card
            gc.collect()
            torch.cuda.empty_cache()
        ranks = mesh_lib.spawn(_world_rank, _world(shape), cfg, shape,
                               carry, init, box, self._shared,
                               device=cfg.device, timeout=None)
        for r in ranks:
            for k, n in r["launches"].items():
                self._launches[k] = self._launches.get(k, 0) + n
        out = ranks[0]
        back = out.pop("carry")
        for k in _CARRY:
            if k in ("faults", "io_hooks"):
                _adopt(getattr(self, k), back[k])
            else:
                setattr(self, k, back[k])
        # the writers' seconds into this process's registry (at world 1
        # the writer observes them itself)
        hist = get_registry().histogram("elastic.ckpt.write_ms")
        for w in back["writers"][len(carry["writers"]):]:
            for s in w["write_s"]:
                hist.observe(s * 1e3)
        if out["status"] == "reshard":
            out["state"] = box
        return out

    def _segment(self, shape, init: Optional[Dict[str, Any]] = None,
                 box: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Train on this process's rank of a world of ``shape`` from
        ``init`` (a reshard's global buffers), else the newest checkpoint
        under ``ckpt_dir``, else the seed, until the end, a preemption or
        a reshard step of the plan (status "reshard": the state in
        ``box``'s shared buffers at world > 1, else in new ones).  An
        injected death raises :class:`WorkerDeath`."""
        cfg = self.cfg
        built = launch.build_everything(
            cfg.arch, shape, cfg.variant, cfg.reduced, cfg.batch, cfg.seq,
            cfg.lr, cfg.accum, device=cfg.device, attn_impl=cfg.attn)
        model, mesh = built.model, built.mesh
        md = built.opt_cfg.moments_dtype
        world = mesh.world
        if init is not None:
            t0 = time.monotonic()
            with _pinned(_leaves((init["params"], init["opt"])),
                         model.device.type == "cuda"):
                st = ZeroState(model, mesh, step=init["step"],
                               moments_dtype=md).place_global(
                    init["params"], init["opt"])
            start, params, opt = init["step"], st.params, st.opt
            t1 = time.monotonic()
            dt = t1 - init["t_stop"]
            self.reshard_s.append(dt)
            self.tracer.event("elastic.reshard", step=start,
                              old_world=init["world"], new_world=world)
            self._log(f"reshard step {start} world {init['world']}->{world}"
                      f" (in-memory, no disk): {dt:.3f} s (the old world's "
                      f"drain and hand-over {init['hand_s']:.3f} s, this "
                      f"one's start {dt - init['hand_s'] - (t1 - t0):.3f} s,"
                      f" placing {t1 - t0:.3f} s)")
        else:
            st = None
            if cfg.ckpt_dir:
                t0 = time.monotonic()
                st = ZeroState.restore_resilient(model, mesh, cfg.ckpt_dir,
                                                 moments_dtype=md)
            if st is not None:
                self.restore_s.append(time.monotonic() - t0)
                start, params, opt = int(st.step), st.params, st.opt
                self._log(f"resumed from step {start} "
                          f"(saved world={st.meta.get('world')}, "
                          f"now={world})")
            else:
                start = 0
                params = init_shards(model, cfg.seed)
                opt = init_opt_state(params, built.opt_cfg)
        del st, init
        writer = self.writer = self._make_writer(model, mesh)
        reg = get_registry()
        i, status, new_shape = start, "complete", None
        while i < cfg.steps:
            if self._stop_requested(world):
                status = "preempted"
                break
            new_shape = self.reshard_plan.pop(i, None)
            if new_shape is not None and tuple(new_shape) != tuple(shape):
                status, t_stop = "reshard", time.monotonic()
                break
            if self.faults is not None:
                action = self.faults.take(i)
                if action == "die":
                    self._log(f"injected worker death at step {i}")
                    self._t_death = time.monotonic()
                    raise WorkerDeath(f"injected death at step {i}")
                if action == "preempt":
                    self._log(f"injected preemption at step {i} "
                              f"(grace {cfg.grace}s)")
                    self.request_preempt(cfg.grace)
                    continue
            rec = launch.run_step(built, params, opt, i, cfg.batch,
                                  cfg.accum, self.tracer)
            for k, n in rec.launches.items():
                self._launches[k] = self._launches.get(k, 0) + n
            self.losses[i] = rec.loss
            self.step_log.append((i, rec.loss, rec.wall_s, writer is not None
                                  and writer.in_flight()))
            if writer is not None:
                writer.note_step()
            if self._t_death is not None:
                self.recover_s.append(time.monotonic() - self._t_death)
                self._t_death = None
            # stepped counter records: replay-safe across restarts (dedupe
            # per (name, step)); flushed+fsynced every step so a SIGKILL
            # loses at most the line it sheared
            self.tracer.counter("train.loss", rec.loss, step=i)
            launch.record_step(reg, self.tracer, i, rec.wall_s, rec.metrics,
                               rec.comm)
            self._log(f"step {i} loss {rec.loss!r}")
            i += 1
            if cfg.ckpt_dir and cfg.ckpt_every and i % cfg.ckpt_every == 0:
                meta = {"world": world, "arch": built.arch.name,
                        "data_cursor": i}
                if writer is not None:
                    self._log(f"snapshot step {i} submitted")
                    self.tracer.event("elastic.ckpt.submit", step=i)
                    writer.submit(i, params, opt, meta)
                else:
                    t0 = time.monotonic()
                    with self.tracer.span("elastic.ckpt.sync_write", step=i):
                        ZeroState(model, mesh, params, opt, step=i).save(
                            cfg.ckpt_dir, meta=meta, fmt=cfg.ckpt_format,
                            io_hooks=self.io_hooks, retries=cfg.retries,
                            backoff=cfg.backoff)
                    reg.histogram("elastic.ckpt.write_ms").observe(
                        (time.monotonic() - t0) * 1e3)
                    self._log(f"committed step {i} (sync)")

        out: Dict[str, Any] = {"status": status, "step": i}
        if status == "preempted":
            self._finish_preempt(writer, model, mesh, params, opt, i,
                                 built.arch)
        elif writer is not None:
            writer.drain()            # quiesce I/O (before a reshard too)
            if status == "complete":
                self._log(f"complete at step {i}")
        out["writer_stats"] = self._retire_writer()
        if status == "reshard":
            out["to"] = tuple(new_shape)
            out["state"] = self._hand_over(params, opt, world, box)
            out["t_stop"] = t_stop
            out["hand_s"] = time.monotonic() - t_stop
        return out

    def _hand_over(self, params, opt, world: int,
                   box: Optional[Dict[str, Any]]) -> Optional[Dict]:
        """The state for the next world: at world 1 new shared global
        buffers (the launcher's own state); beyond, this rank's shards
        written into ``box``'s global buffers (its cut of the trailing
        axis; rank 0 the step count)."""
        state = {"params": params, "opt": opt}
        card = params[next(iter(params))].is_cuda
        if world == 1:
            box = _tree_map(lambda t: _shm(t.shape, _host_dtype(t)), state)
            with _pinned(_leaves(box), card):
                for g, t in zip(_leaves(box), _leaves(state)):
                    g.copy_(t)
            return box
        rank = dist.get_rank()
        with _pinned(_leaves(box), card):
            for tree, mine in ((box["params"], params), (box["opt"]["m"],
                               opt["m"]), (box["opt"]["v"], opt["v"])):
                for k, t in mine.items():
                    g = tree[k]
                    per = t.shape[-1]
                    if g.shape[:-1] != t.shape[:-1] or \
                            g.shape[-1] != per * world or \
                            g.dtype != _host_dtype(t):
                        raise ValueError(
                            f"{k}: shard {tuple(t.shape)} {t.dtype} does not "
                            f"fit the global buffer {tuple(g.shape)} "
                            f"{g.dtype}")
                    copy_rows(g[..., rank * per:(rank + 1) * per], t)
            if rank == 0:
                box["opt"]["count"].copy_(opt["count"])
        return None

    def _finish_preempt(self, writer, model, mesh, params, opt, i,
                        arch) -> None:
        cfg = self.cfg
        remaining = math.inf if self._deadline is None \
            else self._deadline - time.monotonic()
        if writer is not None and writer.in_flight():
            if remaining > 1.0:
                writer.drain()
                self._log("preempt: drained in-flight write")
            else:
                writer.abandon()
                self._log("preempt: abandoned in-flight write "
                          "(grace expired)")
        if cfg.ckpt_dir:
            st = ZeroState(model, mesh, params, opt, step=i)
            path = st.save(cfg.ckpt_dir,
                           meta={"world": mesh.world, "arch": arch.name,
                                 "data_cursor": i, "preempted": True},
                           fmt=cfg.ckpt_format, io_hooks=self.io_hooks,
                           retries=cfg.retries, backoff=cfg.backoff,
                           group=writer.group if writer else None)
            self._log(f"preempted at step {i}: final checkpoint "
                      f"{os.path.basename(path)}")
        else:
            self._log(f"preempted at step {i} (no checkpoint dir)")
