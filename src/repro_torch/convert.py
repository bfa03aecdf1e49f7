"""Load the reference's flat parameter buffers into the port.

The reference (``repro``) and the port lay out every flat ZeRO buffer
identically (``core/partition.py``), so conversion is a dtype-faithful
copy.  The buffers arrive as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in reference_params.items()}``; bf16 ones
have ``ml_dtypes``' bfloat16 dtype, which ``torch.from_numpy`` refuses, so
they cross as their 16-bit patterns.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(np_params: Mapping[str, np.ndarray], model,
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
    """The reference's flat buffers (``embed``, ``blocks``, ``head``,
    ``unemb``; ``rem`` where a model has one) as the port's tensors on
    ``device`` (default: the model's), checked against the model's
    ``param_shapes``."""
    want = model.param_shapes()
    if set(np_params) != set(want):
        raise ValueError(f"buffers {sorted(np_params)} != the model's "
                         f"{sorted(want)}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(np_params[k])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{k}: shape {a.shape} != {shape}")
        out[k] = _tensor(a).to(device or model.device)
    return out
