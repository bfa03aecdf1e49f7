"""Plain PyTorch oracles for the port's kernels.

Counterpart of the reference's ``kernels/ref.py``.  The quantize and
dequantize definitions live in :mod:`repro_torch.core.quant`; the staged
INT8 GEMM and the qgZ operators (reorder-quantize, dequant-reduce and
dequant-reduce-requantize) live here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import (QuantConfig, quantize_blockwise,
                                    unpack_int4)


def dequant_matmul_ref(x: torch.Tensor, payload: torch.Tensor,
                       scales: torch.Tensor,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Staged oracle for the fused INT8 dequant-GEMM: dequantize the whole
    (N, K) weight matrix through ``compute_dtype`` rounding (fp32 scale
    multiply, then the cast), then one product accumulated in fp32.

    The product runs on fp32 copies with TF32 off: a bf16*bf16 product is
    exact in fp32, so this is the staged result up to summation order.
    Returns (T, N) float32.
    x: (T, K); payload: (N, K) int8; scales: (N, NB) with K % NB == 0.
    """
    N, K = payload.shape
    nb = scales.shape[-1]
    assert K % nb == 0, (K, nb)
    w = (payload.reshape(N, nb, K // nb).to(torch.float32)
         * scales.unsqueeze(-1)).reshape(N, K).to(compute_dtype)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = xf @ wf.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def quantize_reordered_ref(x: torch.Tensor, cfg: QuantConfig,
                           u: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ reorder + quantize: transpose the (Y, X, L) gradient slices to
    (X, Y, L) (paper Eq. (1) -> (2)), then quantize the trailing dim.
    ``u`` (optional) is the uniform field on the transposed (X, Y, L)
    layout.  Returns ((X, Y, L or L//2) int8, (X, Y, L//block) f32)."""
    return quantize_blockwise(x.transpose(0, 1), cfg, u)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add), for
    float32 inputs whose product is exact in float64 (24 + 24 bits).

    PyTorch has no FMA op, so the sum runs in float64 with the
    round-to-odd rule: ``s = p + c`` with its exact error ``e`` (Knuth's
    two-sum); where ``e != 0`` and ``s`` is even, ``s`` moves one ulp
    toward ``e``.  Rounding that to float32 (24 <= 53 - 2 bits) is the
    correctly rounded result, with no double-rounding error."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dequant_reduce_ref(payload: torch.Tensor, scales: torch.Tensor,
                       cfg: QuantConfig) -> torch.Tensor:
    """Dequantize N contributions (leading dim) and sum them in fp32:
    (N, P), (N, NB) -> (C,) float32.

    The sum is the fused multiply-add chain ``acc = fma(q_n, scale_n,
    acc)`` from +0 in index order n = 0 … N-1.  That is what the
    reference computes for ``sum(q * scale, axis=0)`` under XLA (the
    multiply and the add contract into one FMA), and what the kernel
    computes with ``__fmaf_rn``, so all three agree bit for bit."""
    q = unpack_int4(payload) if cfg.bits == 4 else payload
    N, C = q.shape
    sb = scales.repeat_interleave(cfg.block_size, dim=-1)
    acc = torch.zeros((C,), dtype=torch.float32, device=q.device)
    for n in range(N):
        acc = fma_f32(q[n].to(torch.float32), sb[n], acc)
    return acc


def dequant_reduce_quant_ref(payload: torch.Tensor, scales: torch.Tensor,
                             cfg_in: QuantConfig, cfg_out: QuantConfig,
                             u: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ between hops: dequantize N contributions, fp32 reduce,
    requantize the partial sums with ``cfg_out`` (``u``: optional (C,)
    uniform field).  Returns ((C or C//2,) int8, (C//block,) f32)."""
    acc = dequant_reduce_ref(payload, scales, cfg_in)
    return quantize_blockwise(acc, cfg_out, u)
