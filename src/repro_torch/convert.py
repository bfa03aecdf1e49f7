"""Carry the reference's flat buffers and AdamW state into the port, and
back.

The reference (``repro``) and the port lay out every flat ZeRO buffer
identically (``core/partition.py``), so conversion is a dtype-faithful
copy.  The buffers arrive as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in reference_params.items()}``; bf16 ones
have ``ml_dtypes``' bfloat16 dtype, which ``torch.from_numpy`` refuses, so
they cross as their 16-bit patterns.  Training state is the fp32 master
buffers (:func:`params_from_numpy`) and the optimizer's ``m``, ``v`` and
``count`` (:func:`opt_from_numpy`); :func:`to_numpy` brings either back
for comparison.  At a world of W ranks, rank r keeps its primary shard of
every global buffer (the trailing axis cut in W, the reference's
``param_specs``): pass ``rank=`` and ``world=``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.partition import shard_of


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(np_params: Mapping[str, np.ndarray], model,
                      device: Optional[torch.device] = None, rank: int = 0,
                      world: int = 1) -> Dict[str, torch.Tensor]:
    """The reference's GLOBAL flat buffers (``embed``, ``blocks``,
    ``head``, ``unemb``; ``rem`` where a model has one), checked against
    the model's ``param_shapes``, as rank ``rank``'s shards of a
    ``world``-rank world: the port's tensors on ``device`` (default: the
    model's)."""
    want = model.param_shapes()
    if set(np_params) != set(want):
        raise ValueError(f"buffers {sorted(np_params)} != the model's "
                         f"{sorted(want)}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(np_params[k])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{k}: shape {a.shape} != {shape}")
        out[k] = _tensor(shard_of(a, rank, world)).to(device or model.device)
    return out


def opt_from_numpy(np_opt: Mapping[str, Any], model,
                   device: Optional[torch.device] = None, rank: int = 0,
                   world: int = 1) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m": {...}, "v": {...}, "count"}``
    (numpy) as the port's, the moments checked and sharded like the
    parameters."""
    dev = device or model.device
    return {"m": params_from_numpy(np_opt["m"], model, dev, rank, world),
            "v": params_from_numpy(np_opt["v"], model, dev, rank, world),
            "count": torch.tensor(int(np.asarray(np_opt["count"])),
                                  dtype=torch.int32, device=dev)}


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts, nested) as numpy arrays on the host; bf16
    becomes float32 (exact)."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
