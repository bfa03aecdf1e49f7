"""B1/B2/B3: blockwise quantize, dequantize and the qgZ reorder-quantize.

Counterpart of the reference's ``kernels/quant_block.py``
(``quantize_pallas``, ``dequantize_pallas``, ``quantize_reordered_pallas``).
The CUDA kernels live in ``csrc/quant_block.cu`` (its header note gives
the design and what bounds them); their plain PyTorch versions are
``repro_torch.core.quant``'s ``quantize_blockwise`` and
``dequantize_blockwise`` and ``ref.quantize_reordered_ref``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
There is no other route: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import platform, ref

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_quantize_blockwise": [ctypes.c_int, _P, ctypes.c_int, _P, _P, _P,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, _P],
    "repro_dequantize_blockwise": [ctypes.c_int, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, _P],
    "repro_quantize_reordered": [ctypes.c_int, _P, ctypes.c_int, _P, _P, _P,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, _P],
}
# B1: one warp per block (2..32 elements a lane); B3/B4: 32 elements a
# lane, block/32 lanes a block
_QUANT_BLOCKS = (64, 128, 256, 512, 1024)


def _lib() -> ctypes.CDLL:
    return platform.library("quant_block", _ARGTYPES)


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")


def quantize(x: torch.Tensor, cfg: QuantConfig,
             u: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise quantize the trailing dim of a 2-D array.

    x: (R, C) float32/bfloat16, C % cfg.block_size == 0.  u: optional
    (R, C) float32 uniform field for stochastic rounding.  Returns
    (payload int8 (R, C or C//2), scales float32 (R, C//block)).
    """
    R, C = x.shape
    block = cfg.block_size
    if C % block:
        raise ValueError(f"trailing dim {C} not a multiple of block {block}")
    if u is not None and tuple(u.shape) != (R, C):
        raise ValueError(f"u shape {tuple(u.shape)} != x shape {(R, C)}")
    if x.device.type == "cpu":
        return quant.quantize_blockwise(x, cfg, u)
    _check_cuda(x, "x")
    if x.dtype not in platform.DTYPE_CODES:
        raise TypeError(f"quantize takes float32/bfloat16, got {x.dtype}")
    if block not in _QUANT_BLOCKS:
        raise ValueError(f"kernel supports blocks {_QUANT_BLOCKS}, got {block}")
    x = platform.aligned(x)
    if u is not None:
        _check_cuda(u, "u")
        u = platform.aligned(u.to(torch.float32))
    payload = torch.empty((R, C // 2 if cfg.bits == 4 else C),
                          dtype=torch.int8, device=x.device)
    scales = torch.empty((R, C // block), dtype=torch.float32,
                         device=x.device)
    lib = _lib()
    err = lib.repro_quantize_blockwise(
        x.device.index or 0, x.data_ptr(), platform.DTYPE_CODES[x.dtype],
        None if u is None else u.data_ptr(), payload.data_ptr(),
        scales.data_ptr(), R * (C // block), block, cfg.bits,
        platform.stream_of(x))
    platform.check(lib, err, "quantize_blockwise kernel")
    platform.LAUNCHES["quantize_blockwise"] += 1
    return payload, scales


def dequantize(payload: torch.Tensor, scales: torch.Tensor, cfg: QuantConfig,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`.  payload (R, P) int8, scales (R, NB)
    float32 -> (R, C) ``out_dtype`` (float32 or bfloat16), written
    directly by the kernel."""
    R, P = payload.shape
    C = P * 2 if cfg.bits == 4 else P
    block = cfg.block_size
    if C % block or tuple(scales.shape) != (R, C // block):
        raise ValueError(f"payload {tuple(payload.shape)} / scales "
                         f"{tuple(scales.shape)} do not match block {block}")
    if payload.device.type == "cpu":
        return quant.dequantize_blockwise(payload, scales, cfg, out_dtype)
    _check_cuda(payload, "payload")
    _check_cuda(scales, "scales")
    if out_dtype not in platform.DTYPE_CODES:
        raise TypeError(f"dequantize writes float32/bfloat16, got {out_dtype}")
    if payload.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("dequantize takes int8 payload and float32 scales")
    if block % 16:
        raise ValueError(f"kernel needs block % 16 == 0, got {block}")
    payload = platform.aligned(payload)
    scales = platform.aligned(scales)
    out = torch.empty((R, C), dtype=out_dtype, device=payload.device)
    lib = _lib()
    err = lib.repro_dequantize_blockwise(
        payload.device.index or 0, payload.data_ptr(), scales.data_ptr(),
        out.data_ptr(), platform.DTYPE_CODES[out_dtype], R * C, block,
        cfg.bits, platform.stream_of(payload))
    platform.check(lib, err, "dequantize_blockwise kernel")
    platform.LAUNCHES["dequantize_blockwise"] += 1
    return out


def quantize_reordered(x: torch.Tensor, cfg: QuantConfig,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ step 1: read the (Y, X, L) gradient slices as (X, Y, L) and
    quantize the trailing dim, the transpose folded into the kernel's load
    index.  x: float32/bfloat16; u: optional (X, Y, L) float32 uniform
    field.  Returns (payload int8 (X, Y, L or L//2), scales float32
    (X, Y, L//block))."""
    Y, X, L = x.shape
    block = cfg.block_size
    if L % block:
        raise ValueError(f"slice length {L} not a multiple of block {block}")
    if u is not None and tuple(u.shape) != (X, Y, L):
        raise ValueError(f"u shape {tuple(u.shape)} != {(X, Y, L)}")
    if x.device.type == "cpu":
        return ref.quantize_reordered_ref(x, cfg, u)
    _check_cuda(x, "x")
    if x.dtype not in platform.DTYPE_CODES:
        raise TypeError(f"quantize_reordered takes float32/bfloat16, got "
                        f"{x.dtype}")
    if block not in _QUANT_BLOCKS:
        raise ValueError(f"kernel supports blocks {_QUANT_BLOCKS}, got {block}")
    x = platform.aligned(x)
    if u is not None:
        _check_cuda(u, "u")
        u = platform.aligned(u.to(torch.float32))
    payload = torch.empty((X, Y, L // 2 if cfg.bits == 4 else L),
                          dtype=torch.int8, device=x.device)
    scales = torch.empty((X, Y, L // block), dtype=torch.float32,
                         device=x.device)
    lib = _lib()
    err = lib.repro_quantize_reordered(
        x.device.index or 0, x.data_ptr(), platform.DTYPE_CODES[x.dtype],
        None if u is None else u.data_ptr(), payload.data_ptr(),
        scales.data_ptr(), Y, X, L, block, cfg.bits, platform.stream_of(x))
    platform.check(lib, err, "quantize_reordered kernel")
    platform.LAUNCHES["quantize_reordered"] += 1
    return payload, scales
