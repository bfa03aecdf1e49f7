"""On the card: what each part of an async checkpoint write costs the
training steps that run beside it.

qwen3-0.6b at full width cut to ``--layers`` (default 7), --attn pallas,
batch 8 x 2048 at world 1: a step's wall time (a synchronized start to a
synchronized end, as ``launch.train.run_step`` times it) alone, then
while a background thread does one part of a write of the whole state
(params, m, v) again and again for ``--seconds``:

  * ``d2h``: the snapshot copied to pageable host memory on a stream of
    its own;
  * ``d2h_pinned``: the same into pinned host buffers (what
    ``AsyncCheckpointWriter`` does);
  * ``npz``: ``np.savez`` of the host copy into a file, fsynced;
  * ``crc``: the crc32 read of that file;
  * ``python``: a pure-Python loop (holds the interpreter lock);
  * ``writer``: the writer itself, one ``submit`` of the state.

Prints the card's name and power limit, then the median step and the
number of steps beside each part.  Then the host transports a live
reshard can hand the state over by: a shared-memory
tensor's allocation (``share_memory_``), the state copied into it from
the card pageable, through the same buffer registered with CUDA
(``cudaHostRegister``), and through a pinned buffer; and back onto the
card from shared memory, pageable and registered (``--transport-only``:
these alone).  Run from the repository root:

    PYTHONPATH=src python -m repro_torch.testing.ckpt_probe [--layers 7] \
        [--transport-only]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as launch
from repro_torch.obs.trace import get_tracer
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.elastic import AsyncCheckpointWriter
from repro_torch.train.state import init_shards


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _timed(what: str, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"transport {what}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def transports(leaves) -> None:
    """Each way of handing the state over through host memory, timed."""
    cudart = torch.cuda.cudart()

    def shm():
        return [torch.empty(t.shape, dtype=t.dtype).share_memory_()
                for t in leaves]

    def register(bufs):
        for b in bufs:
            cudart.cudaHostRegister(b.data_ptr(),
                                    b.numel() * b.element_size(), 0)

    def unregister(bufs):
        for b in bufs:
            cudart.cudaHostUnregister(b.data_ptr())

    def down(bufs):
        for b, t in zip(bufs, leaves):
            b.copy_(t)

    def up(bufs):
        return [b.to("cuda") for b in bufs]

    a = _timed("share_memory_ allocation", shm)
    _timed("pageable copy into fresh shared memory", lambda: down(a))
    _timed("pageable copy into it again", lambda: down(a))
    _timed("card <- shared memory, pageable", lambda: up(a))
    b = shm()
    _timed("cudaHostRegister of fresh shared memory", lambda: register(b))
    _timed("copy into registered shared memory", lambda: down(b))
    _timed("card <- registered shared memory", lambda: up(b))
    _timed("cudaHostUnregister", lambda: unregister(b))
    p = _timed("pinned allocation", lambda: [
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        for t in leaves])
    _timed("copy into pinned", lambda: down(p))
    c = shm()
    _timed("pinned -> fresh shared memory", lambda: [
        x.copy_(y) for x, y in zip(c, p)])
    del a, b, c, p


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--transport-only", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    arch = dataclasses.replace(get_config("qwen3-0.6b"),
                               n_layers=args.layers)
    built = launch.build_everything(arch, (1, 1), batch=8, seq=2048,
                                    device="cuda", attn_impl="pallas")
    params = init_shards(built.model, 0)
    opt = init_opt_state(params)
    state = {"params": params, "opt": opt}
    tracer = get_tracer()
    step_i = [0]

    def step() -> float:
        rec = launch.run_step(built, params, opt, step_i[0], 8, 1, tracer)
        step_i[0] += 1
        return rec.wall_s

    for _ in range(2):          # warm up
        step()
    transports(list(_leaves(state)))
    if args.transport_only:
        return
    snap = [t.detach().clone() for t in _leaves(state)]
    side = torch.cuda.Stream()
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in snap]
    host = [t.cpu() for t in snap]
    tmp = tempfile.mkdtemp(prefix="ckpt_probe_")
    path = os.path.join(tmp, "state.npz")
    nbytes = sum(t.numel() * t.element_size() for t in snap)
    print(f"state {nbytes / 1e9:.3f} GB in {len(snap)} tensors", flush=True)

    def d2h():
        with torch.cuda.stream(side):
            for t in snap:
                t.to("cpu")

    def d2h_pinned():
        with torch.cuda.stream(side):
            for t, p in zip(snap, pinned):
                p.copy_(t, non_blocking=True)
        side.synchronize()

    def npz():
        with open(path, "wb") as f:
            np.savez(f, **{f"a{i}": h.numpy() for i, h in enumerate(host)})
            f.flush()
            os.fsync(f.fileno())

    def crc():
        c = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                c = zlib.crc32(chunk, c)

    def python():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            sum(range(10_000))

    def beside(name, part):
        stop = threading.Event()
        done = []

        def loop():
            while not stop.is_set():
                t0 = time.perf_counter()
                part()
                done.append(time.perf_counter() - t0)
        th = threading.Thread(target=loop, daemon=True)
        th.start()
        t0 = time.perf_counter()
        walls = []
        while time.perf_counter() - t0 < args.seconds or not walls:
            walls.append(step())
        stop.set()
        th.join()
        print(f"beside {name}: step p50 {statistics.median(walls) * 1e3:.1f}"
              f" ms over {len(walls)} steps; the part took "
              f"{[round(x, 2) for x in done]} s", flush=True)

    alone = [step() for _ in range(5)]
    print(f"alone: step p50 {statistics.median(alone) * 1e3:.1f} ms over 5 "
          f"steps", flush=True)
    npz()
    for name, part in (("d2h", d2h), ("d2h_pinned", d2h_pinned),
                       ("npz", npz), ("crc", crc), ("python", python)):
        beside(name, part)
    w = AsyncCheckpointWriter(built.model, built.mesh, tmp)
    w.submit(1, params, opt)
    walls = []
    while w.in_flight():
        walls.append(step())
    w.drain()
    w.close()
    print(f"beside writer: step p50 "
          f"{statistics.median(walls) * 1e3 if walls else 0:.1f} ms over "
          f"{len(walls)} steps; the write {w.stats.write_s} s", flush=True)
    alone = [step() for _ in range(5)]
    print(f"alone again: step p50 {statistics.median(alone) * 1e3:.1f} ms",
          flush=True)
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
