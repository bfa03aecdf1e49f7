"""The training ring's cost, two source trees side by side: the same
multi-rank run with each tree's ``repro_torch``, in the order given (e.g.
parent, change, change, parent), so that one call compares them on one
card.

The run is chip_smoke phase 6's ring run: qwen3-0.6b at full width on a
2 x 2 world (four rank processes sharing one card over gloo), full ZeRO++,
``--attn pallas``, batch 8 x 2048, ring depth ``--prefetch`` (1).  Per
tree it prints one JSON line:

  * ``step_ms``: every rank's host wall per step (the launcher's
    synchronized ``step_s``) after the first, and their median;
  * ``issue_ms`` / ``exposed_ms``: rank 0's host ms a step inside each
    collective label's issue ranges (``<label>``) and ``.wait`` ranges,
    over ``--profile-steps`` more steps under torch.profiler; sums, which
    any version of the ranges gives, however it pairs issues with waits.

    python src/repro_torch/testing/ring_ab.py --tree build/parent \\
        --tree . --tree . --tree build/parent

Each tree runs in a process of its own with its ``src`` first on the path
(its kernels build into its own ``build/kernels``).  ``--device cpu
--arch gpt-350m --reduced --seq 64`` runs the mechanics on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def _rank(rank: int, world: int, argv: list, profile_steps: int):
    """One rank: the launcher's loop, then ``profile_steps`` profiled
    steps (rank 0 records; the others make the same calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as tl

    args = tl.parser().parse_args(argv)
    res = tl.train_loop(args)
    built = res["built"]
    batch = tl.device_batch(built.arch, built.lm, args.steps, args.batch, 1,
                            built.model.device)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    def step():
        built.step.fn(res["params"], res["opt"], batch)

    step()
    sync()
    prof = profile(activities=[ProfilerActivity.CPU]) if rank == 0 \
        else contextlib.nullcontext()
    with prof:
        for _ in range(profile_steps):
            step()
        sync()
    out = {"step_s": res["step_s"]}
    if rank == 0:
        ranges: dict = {}
        for e in prof.events():
            label = e.name[:-len(".wait")] if e.name.endswith(".wait") \
                else e.name
            if label.startswith("zero.") or label == "other":
                ranges[e.name] = ranges.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / profile_steps
        out["ranges"] = ranges
    return out


def _one_tree(argv: list, world: int, device: str, profile_steps: int
              ) -> dict:
    """This process's tree: spawn the world and summarize it."""
    from repro_torch.launch import mesh as mesh_lib

    ranks = mesh_lib.spawn(_rank, world, argv, profile_steps, device=device,
                           timeout=900)
    steps = [s * 1e3 for r in ranks for s in r["step_s"][1:]]
    ranges = ranks[0]["ranges"]
    labels = sorted({k[:-len(".wait")] if k.endswith(".wait") else k
                     for k in ranges})
    import repro_torch
    return {"tree": str(Path(repro_torch.__file__).parents[2]),
            "step_ms_p50": statistics.median(steps),
            "step_ms": [round(s, 3) for s in steps],
            "issue_ms": {k: ranges.get(k, 0.0) for k in labels},
            "exposed_ms": {k: ranges.get(k + ".wait", 0.0) for k in labels}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a source tree (its src/ holds repro_torch); "
                         "repeat, in the order to run")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    argv = ["--arch", a.arch, "--batch", str(a.batch), "--seq", str(a.seq),
            "--steps", str(a.steps), "--lr", "3e-4", "--lr-schedule",
            "constant", "--device", a.device, "--mesh", a.mesh,
            "--prefetch", str(a.prefetch),
            "--attn", "pallas" if a.device == "cuda" else "xla",
            *(["--reduced"] if a.reduced else [])]
    world = 1
    for n in a.mesh.split("x"):
        world *= int(n)
    if a.one:
        print("RING_AB " + json.dumps(_one_tree(argv, world, a.device,
                                                a.profile_steps)),
              flush=True)
        return
    for tree in a.tree:
        src = str(Path(tree).resolve() / "src")
        env = dict(os.environ, PYTHONPATH=src)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               *sys.argv[1:]]
        got = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             cwd=tree)
        lines = [ln for ln in got.stdout.splitlines()
                 if ln.startswith("RING_AB ")]
        if got.returncode or not lines:
            sys.stderr.write(got.stdout[-4000:] + got.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {got.returncode}")
        print(lines[-1][len("RING_AB "):], flush=True)


if __name__ == "__main__":
    main()
