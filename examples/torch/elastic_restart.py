"""Elastic fault-tolerance demo on the PyTorch/CUDA port: the supervisor
runtime end to end.

Every phase drives ``repro_torch.launch.train --elastic``: the supervisor
of ``train/elastic.py`` with ASYNC background checkpoints (per-shard files
and a checksummed manifest, staged commit and atomic rename), restoring
through ``ZeroState.restore_resilient``, on a 4 x 2 world of gloo ranks
(all on the card, or on the CPU with ``--device cpu``).

Phase 1  worker death at step 6: the supervisor abandons the in-flight
         write, restores the latest committed async checkpoint and
         replays.
Phase 2  LIVE resharding mid-run: world 8 -> 4 at step 14 and back 4 -> 8
         at step 17, the state moving through host memory only: no
         checkpoint file is read.
Phase 3  graceful preemption (injected; a real SIGTERM takes the same
         path): the slowed in-flight write is drained within the grace
         window and a final checkpoint is cut before exit.
Phase 4  corrupt checkpoint on disk: bit-rot is injected into the newest
         checkpoint (``testing/faults.corrupt_shard``); the per-shard
         checksums catch it, the directory is quarantined aside
         (``.corrupt``) and the run falls back to the previous intact
         checkpoint.

  PYTHONPATH=src python examples/torch/elastic_restart.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch import train as train_mod      # noqa: E402


def phases(ckpt: str, device: str) -> list:
    """(title, launcher argv) of the four phases (the fourth's corruption
    happens between the third and it)."""
    common = ["--elastic", "--arch", "gpt-350m", "--reduced", "--batch",
              "16", "--seq", "64", "--ckpt-dir", ckpt, "--ckpt-every", "4",
              "--mesh", "4x2", "--device", device]
    return [
        ("phase 1: worker death at step 6 -> restore from the latest "
         "async checkpoint, replay",
         common + ["--steps", "12", "--fault-die-at", "6"]),
        ("phase 2: LIVE reshard 8 -> 4 -> 8 mid-run (in memory, no "
         "checkpoint read)",
         common + ["--steps", "20", "--reshard", "14:2x2,17:4x2"]),
        ("phase 3: graceful preemption at step 22: drain the slowed "
         "in-flight write, cut a final checkpoint",
         common + ["--steps", "26", "--fault-preempt-at", "22",
                   "--fault-slow-write", "1", "--grace", "30"]),
        ("phase 4: bit-rot in the newest checkpoint -> quarantine and "
         "fall back",
         common + ["--steps", "26"])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory, removed "
                         "at the end")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="zeropp_elastic_demo_")
    try:
        for i, (title, run) in enumerate(phases(ckpt, args.device)):
            if i == 3:
                from repro_torch.testing.faults import corrupt_shard
                from repro_torch.train.state import latest_checkpoint
                newest = latest_checkpoint(ckpt)
                print(f"corrupting {newest}", flush=True)
                corrupt_shard(newest)
            print(f"{'' if i == 0 else chr(10)}=== {title} ===", flush=True)
            train_mod.main(run)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
