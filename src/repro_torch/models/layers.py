"""Shared neural building blocks (pure functions on explicit weights).

Port of the reference's ``models/layers.py`` (``rms_norm``, ``swiglu``
with its silu and gelu gates, ``rope_table``, ``mrope_tables``,
``apply_rope``, ``causal_conv1d``) with its dtype rules: norms compute in
fp32 and cast back, rotary tables are fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def mrope_tables(positions_thw: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[float, float, float] = (0.25, 0.375, 0.375)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL §3.1): the rotary half-dim is split into three
    sections driven by the temporal / height / width position streams,
    ``int(half * section)`` frequencies for t and h (truncated, as the
    reference does) and the rest for w.  Equal streams give
    :func:`rope_table`'s values.

    positions_thw: (3, B, S) int.  Returns (cos, sin): (B, S, half)."""
    half = head_dim // 2
    s_t = int(half * sections[0])
    s_h = int(half * sections[1])
    dev = positions_thw.device
    exps = torch.arange(half, dtype=torch.float32, device=dev) / half
    freqs = 1.0 / (theta ** exps)
    sec_of = torch.cat([torch.zeros(s_t, dtype=torch.long, device=dev),
                        torch.ones(s_h, dtype=torch.long, device=dev),
                        torch.full((half - s_t - s_h,), 2, dtype=torch.long,
                                   device=dev)])
    # the position stream of each frequency index: (B, S, half)
    p = positions_thw.to(torch.float32).movedim(0, -1)[..., sec_of]
    ang = p * freqs
    return torch.cos(ang), torch.sin(ang)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  carry: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal convolution (the Mamba / Griffin stem).

    x: (B, S, C); w: (W, C) taps, tap W - 1 on the current position.
    ``carry``: (B, W - 1, C), the inputs before x (the previous sequence
    shard's tail, or the decode history; zeros when None).  Returns (y,
    new carry: the last W - 1 inputs), the taps summed in order in x's
    dtype, as the reference does."""
    W = w.shape[0]
    B, S, C = x.shape
    if carry is None:
        carry = x.new_zeros((B, W - 1, C))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)        # (B, S + W - 1, C)
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return y, xp[:, S:, :]
