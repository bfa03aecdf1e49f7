"""Run a function on N ranks of a CPU gloo world, one process per rank.

The port's counterpart of the reference's ``testing/subproc.py``: the
reference simulates N host devices in one process; torch.distributed needs
one process per rank.  :func:`run` spawns them, gives each an initialised
gloo process group (``tcp://localhost:<free port>``, ranks 0 … N-1), calls
``fn(rank, world, *args)`` and returns every rank's result in rank order.
A rank that raises fails the whole run with its traceback.  ``fn`` must be
importable by the spawned processes (a module-level function).
"""
from __future__ import annotations

import socket
import traceback
from typing import Any, Callable, List

import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args,
               queue) -> None:
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out = (rank, True, fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                 # reported to the parent, not lost
        out = (rank, False, traceback.format_exc())
    queue.put(out)


def run(fn: Callable, world: int, *args, timeout: float = 240.0
        ) -> List[Any]:
    """``[fn(0, world, *args), …, fn(world-1, world, *args)]``, each
    computed in its own gloo rank."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, val = queue.get(timeout=timeout)
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]
