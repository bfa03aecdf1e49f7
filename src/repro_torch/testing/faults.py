"""Deterministic fault injection for the elastic training runtime.

The port's copy of the reference's ``testing/faults.py``.  Two layers:

  * **In-process** — :class:`StepFaults` injects worker death / preemption
    at exact step numbers into ``train/elastic.Supervisor``, and the
    ``IOHooks`` implementations (:class:`FlakyIO`, :class:`SlowIO`,
    :class:`CrashBeforeManifest`) plug into ``ZeroState.save``'s commit
    protocol to simulate transient write errors, slow storage, and a crash
    between the shard write and the manifest commit.  File mutators
    (:func:`truncate_shard`, :func:`corrupt_shard`) damage a committed
    checkpoint the way real storage does.  At world > 1 each rank runs
    its own copy of a plan and of the hooks (every rank fails its own
    shard writes, dies or is preempted at the same step); rank 0's copies
    come back into the caller's objects when the world ends.
  * **Subprocess** — :func:`spawn_train` / :func:`kill_on_marker` run
    ``python -m repro_torch.launch.train --elastic`` (one process a rank
    beyond world 1, each dying with the launcher) and deliver REAL
    signals (SIGKILL mid slowed write, SIGTERM with a grace deadline) to
    the launcher, keyed on stdout markers, because an in-process "crash"
    cannot skip ``finally`` cleanup — only a real kill leaves genuine
    staging debris behind.  The caller gives ``--device`` (``cpu`` in the
    tests) among the arguments.

Everything here is test-only; production code never imports this module.
"""
from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

# the exception the supervisor handles is owned by the runtime, so
# production code never has to import this harness to catch it
from repro_torch.train.elastic import WorkerDeath  # noqa: F401

__all__ = [
    "WorkerDeath", "StepFaults", "FlakyIO", "SlowIO",
    "CrashBeforeManifest", "ChainedHooks", "truncate_file", "corrupt_file",
    "truncate_shard", "corrupt_shard", "make_stale_staging", "spawn_train",
    "run_train", "kill_on_marker", "parse_losses",
]


# ---------------------------------------------------------------------------
# step-boundary fault plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepFaults:
    """step -> action map consulted by the supervisor at each step
    boundary.  Actions: ``"die"`` (raise WorkerDeath), ``"preempt"``
    (request a graceful preemption).  Each fires exactly once."""

    actions: Dict[int, str]
    fired: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    def take(self, step: int) -> Optional[str]:
        action = self.actions.pop(step, None)
        if action is not None:
            self.fired.append((step, action))
        return action


# ---------------------------------------------------------------------------
# IOHooks implementations (the ZeroState.save seam)
# ---------------------------------------------------------------------------

class FlakyIO:
    """First ``n_failures`` shard writes raise OSError — a transient
    storage error the save path must absorb via retry-with-backoff."""

    def __init__(self, n_failures: int):
        self.remaining = int(n_failures)
        self.calls = 0

    def post_shard(self, path: str) -> None:
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise OSError(
                f"injected transient write error on {os.path.basename(path)}"
                f" ({self.remaining} more to come)")


class SlowIO:
    """Sleeps ``delay`` seconds after each shard write: a slow writer for
    overlap measurement and backpressure / abandon-window tests."""

    def __init__(self, delay: float):
        self.delay = float(delay)
        self.calls = 0

    def post_shard(self, path: str) -> None:
        self.calls += 1
        time.sleep(self.delay)


class CrashBeforeManifest:
    """Aborts every save between the shard write and the manifest commit —
    the staged shards exist but the checkpoint is never published."""

    def pre_manifest(self, staging: str) -> None:
        raise OSError("injected crash before manifest commit")


class ChainedHooks:
    """Compose several hook objects; each stage runs them in order."""

    def __init__(self, hooks):
        self.hooks = [h for h in hooks if h is not None]

    def _fan(self, name: str, *args) -> None:
        for h in self.hooks:
            fn = getattr(h, name, None)
            if fn is not None:
                fn(*args)

    def post_shard(self, path: str) -> None:
        self._fan("post_shard", path)

    def pre_manifest(self, staging: str) -> None:
        self._fan("pre_manifest", staging)

    def pre_publish(self, staging: str, final: str) -> None:
        self._fan("pre_publish", staging, final)


# ---------------------------------------------------------------------------
# on-disk damage to committed checkpoints
# ---------------------------------------------------------------------------

def truncate_file(path: str, frac: float = 0.5) -> str:
    """Cut a file to ``frac`` of its size — a write interrupted mid-way."""
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(1, int(size * frac)))
    return path

def corrupt_file(path: str, offset: Optional[int] = None,
                 nbytes: int = 16) -> str:
    """Flip bytes mid-file (silent bit-rot: size unchanged, crc breaks)."""
    size = os.path.getsize(path)
    if offset is None:
        offset = size // 2
    with open(path, "rb+") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def _first_shard(ckpt_path: str) -> str:
    names = sorted(n for n in os.listdir(ckpt_path)
                   if n.startswith("shard_") and n.endswith(".npz"))
    assert names, f"no shard files in {ckpt_path}"
    return os.path.join(ckpt_path, names[0])


def truncate_shard(ckpt_path: str, frac: float = 0.5) -> str:
    return truncate_file(_first_shard(ckpt_path), frac)


def corrupt_shard(ckpt_path: str) -> str:
    return corrupt_file(_first_shard(ckpt_path))


def make_stale_staging(ckpt_dir: str, step: int) -> str:
    """Fabricate the debris a crash mid-write leaves: a ``ckpt_<step>.tmp``
    staging dir holding a partial shard and no manifest."""
    staging = os.path.join(ckpt_dir, f"ckpt_{step}.tmp")
    os.makedirs(staging, exist_ok=True)
    with open(os.path.join(staging, "shard_00000.npz"), "wb") as f:
        f.write(b"PK\x03\x04 partial garbage")
    return staging


# ---------------------------------------------------------------------------
# subprocess harness: real processes, real signals
# ---------------------------------------------------------------------------

_LOSS_RE = re.compile(r"\[elastic\] step (\d+) loss ([-+0-9.eE]+)")


def _train_env() -> Dict[str, str]:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = os.path.join(root, "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn_train(args: List[str]) -> subprocess.Popen:
    """Launch ``python -m repro_torch.launch.train <args>`` with
    line-buffered merged stdout (the ranks it spawns share it)."""
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.train", *args],
        env=_train_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, bufsize=1)


def run_train(args: List[str], timeout: float = 600.0) -> List[str]:
    """Run a launch to completion; returns stdout lines, asserts rc 0."""
    proc = spawn_train(args)
    out, _ = proc.communicate(timeout=timeout)
    lines = out.splitlines()
    assert proc.returncode == 0, \
        f"train exited rc={proc.returncode}:\n" + "\n".join(lines[-40:])
    return lines


def kill_on_marker(args: List[str], marker: str,
                   sig: int = signal.SIGKILL, delay: float = 0.0,
                   timeout: float = 600.0) -> Tuple[int, List[str]]:
    """Launch a training subprocess, watch stdout for ``marker``, then
    (after ``delay`` seconds) deliver ``sig`` to the launcher (its ranks
    die with it).  Returns (rc, lines)."""
    proc = spawn_train(args)
    lines: List[str] = []
    seen = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if marker in line:
                seen.set()
        seen.set()   # EOF: stop waiting even if the marker never appeared

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    assert seen.wait(timeout), \
        f"marker {marker!r} never appeared:\n" + "\n".join(lines[-40:])
    if proc.poll() is None:
        if delay:
            time.sleep(delay)
        try:
            os.kill(proc.pid, sig)
        except ProcessLookupError:
            pass
    rc = proc.wait(timeout=timeout)
    t.join(timeout=30)
    assert marker in "\n".join(lines), \
        f"process exited before marker {marker!r}:\n" + "\n".join(lines[-40:])
    return rc, lines


def parse_losses(lines: List[str]) -> Dict[int, float]:
    """Per-step losses from supervisor markers; a later occurrence of the
    same step (post-resume recompute) overwrites the earlier one."""
    out: Dict[int, float] = {}
    for line in lines:
        m = _LOSS_RE.search(line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out
