"""The seam between the hot path and the kernels.

Counterpart of the reference's ``kernels/ops.py`` (its
``quantize_blockwise``, ``dequantize_blockwise``, ``quantize_reordered``,
``dequant_reduce``, ``dequant_reduce_quant`` and ``dequant_matmul``),
plus the flash-attention pair that the reference calls from
``kernels/flash_ops.py``: every quantized byte on the port's serving and
training paths — the qwZ gathers and the qgZ reduce in
``core/collectives.py`` and the INT8 head in ``models/model.py`` — and the
attention of the training step under ``attn_impl="pallas"``
(``kernels/flash_ops.py``) go through here, with the reference's shapes
and dtypes.  N-D inputs are
flattened to 2-D rows (``_as2d``: a flat shard becomes ``(1, N)``), as the
reference does before its Pallas calls.

Stochastic rounding takes a pre-drawn uniform field ``u`` where the
reference takes a JAX key (the reference draws that field with
``core.quant.stochastic_uniform`` and feeds it to its kernels the same
way).

This module only reshapes.  The route is taken one layer down, in the
kernel wrappers (``kernels/quant_block.py``,
``kernels/fused_dequant_reduce_quant.py``, ``kernels/dequant_matmul.py``,
``kernels/flash_attention.py``):
a CUDA tensor launches the hand-written kernel, a CPU tensor takes the
plain PyTorch version.  There is no backend switch and no fallback from a
failed build or launch.  With telemetry on, each call counts its route
once, as the reference's seam does: ``kernels.dispatch.<op>.cuda`` or
``.torch`` (``obs.metrics.count_dispatch``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import dequant_matmul as _dm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_dequant_reduce_quant as _fq
from repro_torch.kernels import quant_block as _qb
from repro_torch.obs.metrics import count_dispatch


def _dispatch(op: str, x: torch.Tensor) -> None:
    """Count ``op``'s route: the wrapper launches the kernel for a CUDA
    tensor and takes the plain version for a CPU one."""
    count_dispatch(op, "cuda" if x.is_cuda else "torch")


def _as2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    lead = tuple(x.shape[:-1])
    n = 1
    for s in lead:
        n *= s
    return x.reshape(n, x.shape[-1]), lead


def quantize_blockwise(x: torch.Tensor, cfg: QuantConfig,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise quantize the trailing dim (the qwZ shard quantize).

    ``u`` is an optional pre-drawn uniform field (shape of ``x``) for
    stochastic rounding — the reference draws it from a JAX key
    (``core.quant.stochastic_uniform``); the port takes the field itself.
    """
    _dispatch("quantize_blockwise", x)
    x2, lead = _as2d(x)
    u2 = None if u is None else u.reshape(x2.shape)
    p, s = _qb.quantize(x2, cfg, u2)
    return p.reshape(*lead, p.shape[-1]), s.reshape(*lead, s.shape[-1])


def dequantize_blockwise(payload: torch.Tensor, scales: torch.Tensor,
                         cfg: QuantConfig,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`; writes ``out_dtype`` (the qwZ
    gather passes bf16) directly."""
    _dispatch("dequantize_blockwise", payload)
    p2, lead = _as2d(payload)
    s2, _ = _as2d(scales)
    x = _qb.dequantize(p2, s2, cfg, out_dtype)
    return x.reshape(*lead, x.shape[-1])


def quantize_reordered(x: torch.Tensor, cfg: QuantConfig,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Y, X, L) -> transpose to (X, Y, L), quantize the trailing dim — qgZ
    step 1, the remap folded into the kernel's load index.  ``u``: the
    uniform field on the transposed (X, Y, L) layout."""
    _dispatch("quantize_reordered", x)
    return _qb.quantize_reordered(x, cfg, u)


def dequant_reduce(payload: torch.Tensor, scales: torch.Tensor,
                   cfg: QuantConfig) -> torch.Tensor:
    """Sum N quantized contributions in fp32: (N, P), (N, NB) -> (C,)
    float32."""
    _dispatch("dequant_reduce", payload)
    return _fq.dequant_reduce(payload, scales, cfg)


def dequant_reduce_quant(payload: torch.Tensor, scales: torch.Tensor,
                         cfg_in: QuantConfig, cfg_out: QuantConfig,
                         u: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequant -> fp32 reduce -> requant (qgZ intra hop, §4.2).
    ``u``: optional (C,) uniform field for the requantization."""
    _dispatch("dequant_reduce_quant", payload)
    return _fq.dequant_reduce_quant(payload, scales, cfg_in, cfg_out, u)


def dequant_matmul(x: torch.Tensor, payload: torch.Tensor,
                   scales: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Fused INT8-weight x activation GEMM: ``x @ dequant(payload).T``.

    x: (T, K); payload: (N, K) int8 rows; scales: (N, NB) float32 with
    K % NB == 0.  Dequantized weights round through ``compute_dtype``
    before the product, accumulation is fp32; returns (T, N) float32.
    """
    _dispatch("dequant_matmul", x)
    return _dm.dequant_matmul(x, payload, scales, compute_dtype)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention forward: q (B, Sq, H, hd), k/v (B, S, K, hd) ->
    (out (B, Sq, H, hd), m, l (B, H, Sq) float32)."""
    _dispatch("flash_fwd", q)
    return _fa.flash_fwd(q, k, v, scale=scale, causal=causal, window=window,
                         softcap=softcap)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              dout: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward from the forward's (out, m, l): (dq, dk,
    dv)."""
    _dispatch("flash_bwd", q)
    return _fa.flash_bwd(q, k, v, out, m, l, dout, scale=scale,
                         causal=causal, window=window, softcap=softcap)
