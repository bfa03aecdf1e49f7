"""The world of a run: its axes, shape, groups and ranks.

Counterpart of the reference's ``launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over simulated or real devices in one process;
torch.distributed runs one process per rank, so a mesh here is a shape
over an initialised process group plus the groups of its axes:

  * ``(Y, X)`` over ``("data", "model")``, or ``(P, Y, X)`` over
    ``("pod", "data", "model")`` (the reference's multi-pod mesh); ranks
    are row-major with ``model`` fastest, so rank r's flat shard and batch
    rows are the r-th of the world (the reference's ``P(dp_axes)``);
  * :meth:`Mesh.group` gives this rank's group over the tuples of axes a
    run uses (``collectives.axis_group``): the intra group ``("model",)``
    (qgZ's first hop, hpZ's default secondary group: X consecutive
    ranks), the inter group (every axis but ``model``: qgZ's second hop,
    its ranks row-major over ``("pod", "data")``), the sequence axes of
    a layout (a suffix of the axes), one pod ``("data", "model")`` (a
    wider hpZ secondary group) and any other ``hpz_axes``.  Every group
    is created when the mesh is, so every rank creates them in the same
    order.

:func:`spawn` starts one process per rank, gives each an initialised
process group (ranks 0 … N-1, meeting at a ``TCPStore`` that the
launching process holds on localhost), calls
``fn(rank, world, *args)`` and returns every rank's result in rank order.
On the card every rank shares device 0 (NCCL puts no two ranks on one
device, so the card's world is gloo) and the kernels are built once, in
the launching process, before any rank starts: ranks that met a cold
``build/kernels/`` would race to write the same library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import queue as queue_lib
import signal
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as cl
from repro_torch.kernels import platform

AXES = ("data", "model")
AXES3 = ("pod", "data", "model")


def axes_of(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """The axis names of a mesh shape: ``AXES`` or ``AXES3``."""
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape {tuple(shape)}: two or three axes")
    return AXES if len(shape) == 2 else AXES3


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A world of ``shape`` over ``axes_of(shape)``: the whole ZeRO world
    is torch.distributed's default group (none at world 1); ``groups``
    maps the proper tuples of axes (in mesh order) that :func:`make_mesh`
    built to this rank's group over each (None at world 1)."""
    shape: Tuple[int, ...]
    groups: Optional[Dict[Tuple[str, ...], Any]] = None

    @property
    def axes(self) -> Tuple[str, ...]:
        return axes_of(self.shape)

    @property
    def intra(self) -> Any:
        """The fast tier, ``("model",)``: qgZ's first hop, hpZ's default
        secondary group."""
        return self.group(("model",))

    @property
    def inter(self) -> Any:
        """Every other axis: qgZ's second hop."""
        return self.group(self.axes[:-1])

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def group(self, axes: Tuple[str, ...]) -> Any:
        """This rank's group over ``axes`` (a tuple in mesh order): the
        default group object for every axis, None at world 1."""
        axes = tuple(axes)
        if [a for a in self.axes if a in axes] != list(axes) or not axes:
            raise ValueError(f"axes {axes}: a non-empty tuple of {self.axes} "
                             f"in mesh order")
        if self.world == 1:
            return None
        if axes == self.axes:
            return dist.group.WORLD
        if axes not in self.groups:
            raise ValueError(f"no group over {axes}: make_mesh builds "
                             f"{sorted(self.groups)} and its hpz_axes")
        return self.groups[axes]


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """``"4x2"`` -> (4, 2): Y ``data`` rows of X ``model`` ranks;
    ``"2x2x2"`` -> (2, 2, 2): P pods of Y x X."""
    try:
        shape = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh must read YxX or PxYxX, got {spec!r}")
    if min(shape) < 1:
        raise ValueError(f"mesh {spec!r}: every size must be >= 1")
    return shape


def make_mesh(shape: Tuple[int, ...],
              hpz_axes: Optional[Tuple[str, ...]] = None) -> Mesh:
    """The mesh of ``shape`` over the default process group, with the
    groups a run uses created (every rank must call this, in the same
    order): every proper suffix of the axes (``("model",)``, the
    sequence axes, one pod), every axis but ``model`` and, where given,
    ``hpz_axes`` (in mesh order).  Each group's axes, and the world's,
    are recorded for the tier counters (``collectives.group_axes``).  A
    world of 1 needs no process group."""
    shape = tuple(int(s) for s in shape)
    axes = axes_of(shape)
    subs = [axes[k:] for k in range(len(axes) - 1, 0, -1)] + [axes[:-1]]
    if hpz_axes:
        subs.append(tuple(a for a in axes if a in hpz_axes))
    world = 1
    for s in shape:
        world *= s
    if world == 1:
        return Mesh(shape)
    have = cl.world_size()
    if have != world:
        raise RuntimeError(
            f"mesh {'x'.join(map(str, shape))} needs a process group of "
            f"{world} ranks, found {have}: start the ranks with "
            f"repro_torch.launch.mesh.spawn")
    cl.set_world_axes(axes)
    groups: Dict[Tuple[str, ...], Any] = {}
    for sub in subs:
        if sub != axes and sub not in groups:
            groups[sub] = cl.axis_group(shape, axes, sub)
    return Mesh(shape, groups)


# ---------------------------------------------------------------- spawner

def _die_with_parent(parent: int) -> None:
    """Have the kernel SIGKILL this process when its parent dies
    (``prctl(PR_SET_PDEATHSIG)``; a no-op where libc has no prctl)."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return
    prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    prctl.restype = ctypes.c_int
    prctl(1, int(signal.SIGKILL), 0, 0, 0)          # 1: PR_SET_PDEATHSIG
    if os.getppid() != parent:    # it died before the request took hold
        os._exit(1)


def _rank_main(rank: int, world: int, port: int, backend: str, device: str,
               fn: Callable, args, queue, parent: int) -> None:
    _die_with_parent(parent)
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        else:           # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.TCPStore("localhost", port, is_master=False)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            out = (rank, True, fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                 # reported to the parent, not lost
        out = (rank, False, traceback.format_exc())
    queue.put(out)


def spawn(fn: Callable, world: int, *args, device: str = "cuda",
          backend: str = "gloo", timeout: Optional[float] = 240.0
          ) -> List[Any]:
    """``[fn(0, world, *args), …, fn(world-1, world, *args)]``, each
    computed in its own rank process of a ``backend`` group, on
    ``device`` ("cuda": every rank on device 0; or "cpu").  ``fn`` must be
    importable by the new processes (a module-level function).  A rank
    that raises or dies fails the whole run with its traceback; so does a
    run that outlasts ``timeout`` seconds (None: no limit)."""
    if device == "cuda":
        platform.resolve_device(device)
        platform.build()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    # the rendezvous store binds its port here and holds it for the run: a
    # port found free and released for rank 0 to bind could be taken first
    # by another world's sockets (a parallel test run opens many)
    store = dist.TCPStore("localhost", 0, is_master=True)
    port = store.port
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, fn, args,
                               queue, os.getpid()))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failed, errors = {}, set(), []
    deadline = time.monotonic() + (timeout or float("inf"))
    try:
        while len(results) + len(failed) < world:
            try:
                rank, ok, val = queue.get(timeout=1.0)
            except queue_lib.Empty:
                missing = [r for r in range(world)
                           if r not in results and r not in failed]
                if time.monotonic() > deadline:
                    errors.append(f"rank(s) {missing} still running, "
                                  f"stopped")
                    break
                dead = [r for r in missing
                        if procs[r].exitcode not in (None, 0)]
                if dead:
                    errors.append(f"rank(s) {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                    break
                continue
            if ok:
                results[rank] = val
            else:
                failed.add(rank)
                errors.append(f"rank {rank}:\n{val}")
                # the others wait on the failed rank's messages: give them a
                # moment to report their own errors, then stop them
                deadline = min(deadline, time.monotonic() + 30.0)
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
        del store
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]
