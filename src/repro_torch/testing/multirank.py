"""Run a function on N ranks of a CPU gloo world, one process per rank.

The port's counterpart of the reference's ``testing/subproc.py``: the
reference simulates N host devices in one process; torch.distributed needs
one process per rank.  :func:`run` is the launcher's spawner
(``repro_torch.launch.mesh.spawn``) on the CPU: each rank gets an
initialised gloo process group, ``fn(rank, world, *args)`` runs in it and
every rank's result comes back in rank order.  A rank that raises fails
the whole run with its traceback.  ``fn`` must be importable by the
spawned processes (a module-level function).
"""
from __future__ import annotations

from typing import Any, Callable, List

from repro_torch.launch import mesh


def run(fn: Callable, world: int, *args, timeout: float = 240.0
        ) -> List[Any]:
    """``[fn(0, world, *args), …, fn(world-1, world, *args)]``, each
    computed in its own gloo rank on the CPU."""
    return mesh.spawn(fn, world, *args, device="cpu", backend="gloo",
                      timeout=timeout)
