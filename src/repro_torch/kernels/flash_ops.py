"""The flash-attention kernels as one differentiable op.

Counterpart of the reference's ``kernels/flash_ops.py``: there a
``jax.custom_vjp`` whose forward runs ``flash_fwd_pallas`` and whose
backward runs ``flash_bwd_pallas``; here a ``torch.autograd.Function``
whose forward runs ``ops.flash_fwd`` (B6) and saves (q, k, v, out, m, l),
and whose backward runs ``ops.flash_bwd`` (B7).  Queries start at
position 0, as in the reference (no sequence-parallel offset).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class _FlashAttentionKernel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        cfg = dict(scale=scale, causal=causal, window=window,
                   softcap=softcap)
        out, m, l = ops.flash_fwd(q, k, v, **cfg)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = ops.flash_bwd(q, k, v, out, m, l, dout, **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, causal: bool, window: int,
                           softcap: float) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, S, K, hd) through the
    flash kernels, differentiable in q, k and v."""
    return _FlashAttentionKernel.apply(q, k, v, scale, causal, window,
                                       softcap)
