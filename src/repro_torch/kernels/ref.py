"""Plain PyTorch oracles for the port's kernels.

Counterpart of the reference's ``kernels/ref.py``.  The quantize and
dequantize definitions live in :mod:`repro_torch.core.quant`; the staged
INT8 GEMM lives here.
"""
from __future__ import annotations

import torch


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
