"""The ("data", "model") world of a run: its shape, groups and ranks.

Counterpart of the reference's ``launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over simulated or real devices in one process;
torch.distributed runs one process per rank, so a mesh here is a shape
``(Y, X)`` over an initialised process group plus its two tiers:

  * ranks are row-major over ``("data", "model")`` with ``model`` fastest,
    so rank r sits at (d, m) = divmod(r, X) and its flat shard and batch
    rows are the r-th of the world (the reference's ``P(("data",
    "model"))``);
  * the intra group (the fast tier: hpZ's secondary partition, qgZ's
    first hop) holds the X ranks of one ``data`` row, the inter group (qgZ's
    second hop) the Y ranks of one ``model`` column
    (``collectives.tier_groups``).

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

import dataclasses
import os
import queue as queue_lib
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as cl
from repro_torch.kernels import platform

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(Y, X)`` world over ``AXES``: the whole ZeRO world is
    torch.distributed's default group (none at world 1), ``intra`` and
    ``inter`` its tiers (None at world 1)."""
    shape: Tuple[int, int]
    intra: Any = None
    inter: Any = None

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1]


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"4x2"`` -> (4, 2): Y ``data`` rows of X ``model`` ranks."""
    try:
        y, x = (int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh must read YxX, got {spec!r}") from None
    if y < 1 or x < 1:
        raise ValueError(f"mesh {spec!r}: both sizes must be >= 1")
    return y, x


def make_mesh(shape: Tuple[int, int]) -> Mesh:
    """The mesh of shape ``(Y, X)`` over the default process group, its
    tier groups created (every rank must call this, in the same order).
    A world of 1 needs no process group."""
    y, x = shape
    if y * x == 1:
        return Mesh((1, 1))
    have = cl.world_size()
    if have != y * x:
        raise RuntimeError(
            f"mesh {y}x{x} needs a process group of {y * x} ranks, found "
            f"{have}: start the ranks with repro_torch.launch.mesh.spawn")
    intra, inter = cl.tier_groups(x)
    return Mesh((y, x), intra, inter)


# ---------------------------------------------------------------- spawner

def _rank_main(rank: int, world: int, port: int, backend: str, device: str,
               fn: Callable, args, queue) -> None:
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
                               queue))
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
