"""B8: fused INT8-weight x activation GEMM, on the card.

Counterpart of the reference's ``kernels/dequant_matmul.py``
(``dequant_matmul_pallas``): ``x @ dequant(W).T`` with the blockwise
scales applied inside the kernel, so the dequantized weight matrix is
never written.  The CUDA kernels live in ``csrc/dequant_matmul.cu`` (its
header note gives the design and what bounds it): bf16 x with weights
rounded to bf16, the serving path, goes to the tensor cores; fp32 x or
unrounded weights to an FFMA kernel.  The plain PyTorch version is the
staged ``ref.dequant_matmul_ref``.

Numerics: each weight is dequantized in fp32 and rounded through
``compute_dtype`` (bf16) exactly as the staged path does; products are
exact (bf16 x bf16) or fp32, and sums are fp32 in another order (on the
tensor cores, with their own internal rounding of a sum), so kernel and
plain version agree within an allclose, not bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import platform, ref

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_dequant_matmul": [ctypes.c_int, _P, ctypes.c_int, _P, _P, _P,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, _P,
                             ctypes.POINTER(ctypes.c_int)],
}


def dequant_matmul(x: torch.Tensor, payload: torch.Tensor,
                   scales: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """x (T, K) activations; payload (N, K) int8 rows; scales (N, NB)
    float32 with K % NB == 0.  Returns (T, N) float32."""
    T, K = x.shape
    N, Kw = payload.shape
    nb = scales.shape[-1]
    if Kw != K or tuple(scales.shape) != (N, nb) or K % nb:
        raise ValueError(f"x {tuple(x.shape)}, payload {tuple(payload.shape)}"
                         f", scales {tuple(scales.shape)}: need K % NB == 0")
    if x.device.type == "cpu":
        return ref.dequant_matmul_ref(x, payload, scales, compute_dtype)
    for t, what in ((x, "x"), (payload, "payload"), (scales, "scales")):
        if t.device.type != "cuda":
            raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if compute_dtype not in platform.DTYPE_CODES \
            or x.dtype not in platform.DTYPE_CODES:
        raise TypeError(f"x and compute_dtype must be float32/bfloat16, got "
                        f"{x.dtype}, {compute_dtype}")
    if payload.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("dequant_matmul takes int8 payload, float32 scales")
    if K % 16 or (K // nb) % 16:
        raise ValueError(f"kernel needs K % 16 == 0 and (K/NB) % 16 == 0, "
                         f"got K={K}, NB={nb}")
    x = platform.aligned(x)
    payload = platform.aligned(payload)
    scales = platform.aligned(scales)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    lib = platform.library("dequant_matmul", _ARGTYPES)
    launches = ctypes.c_int(0)
    err = lib.repro_dequant_matmul(
        x.device.index or 0, x.data_ptr(), platform.DTYPE_CODES[x.dtype],
        payload.data_ptr(), scales.data_ptr(), out.data_ptr(), T, N, K, nb,
        int(compute_dtype == torch.bfloat16), platform.stream_of(x),
        ctypes.byref(launches))
    platform.check(lib, err, "dequant_matmul kernel")
    # the tensor-core route launches once per 8 rows of x and per 1,024 of
    # K; the entry point says how many it made
    platform.LAUNCHES["dequant_matmul"] += launches.value
    return out
