"""Shared neural building blocks (pure functions on explicit weights).

Port of the reference's ``models/layers.py`` (``rms_norm``, ``swiglu``
with its silu and gelu gates, ``rope_table``, ``apply_rope``) with its
dtype rules: norms compute in fp32 and cast back, rotary tables are fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred gain: ``x̂ · (1 + scale)``."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def swiglu(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
           act: str = "silu") -> torch.Tensor:
    """Gated MLP.  ``w_gate_up``: (d, 2*ff) fused gate|up; ``w_down``:
    (ff, d).  ``act`` is "silu" or "gelu" (the tanh approximation, the
    reference's ``jax.nn.gelu(approximate=True)``)."""
    g, u = torch.chunk(x @ w_gate_up, 2, dim=-1)
    if act == "silu":
        a = F.silu(g)
    elif act == "gelu":
        a = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return (a * u) @ w_down


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for rotary embedding.  positions: (..., S) int."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.unsqueeze(-1).to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).

    x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
