"""Thin compat shim over the checkpoint format (see ``train/state.py``).

The port's copy of the reference's ``train/checkpoint.py``: checkpoint
I/O is owned by ``repro_torch.train.state`` (per-shard files + a
manifest, the INT8 format, elastic restore); this module keeps the
original API:

  * ``save``/``load`` — the legacy single-file GLOBAL npz format (every
    buffer on one host; O(model) host RAM — use
    ``ZeroState.save``/``ZeroState.restore`` for anything past toy scale);
    ``load`` also reads a per-shard checkpoint;
  * ``latest`` — checkpoint discovery: per-shard manifest dirs and legacy
    ``.npz`` files, foreign names skipped;
  * ``fit_to`` — elastic re-pad of a flat buffer (re-exported).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.train.state import (CheckpointCorruptError,  # noqa: F401
                                     CheckpointError, fit_to,
                                     latest_checkpoint, load_global,
                                     quarantine_checkpoint, save_legacy_npz)

__all__ = ["save", "load", "latest", "fit_to", "CheckpointError",
           "CheckpointCorruptError", "quarantine_checkpoint"]


def save(path: str, step: int, state: Dict[str, Any],
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic single-file save.  ``state`` is a tree of dicts of (global)
    tensors or arrays.  Legacy format — see module docstring."""
    return save_legacy_npz(path, step, state, meta)


def load(path: str) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Load either format (per-shard dir or legacy npz) into GLOBAL
    buffers; returns (step, state_tree, meta)."""
    return load_global(path)


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    return latest_checkpoint(directory, prefix)
