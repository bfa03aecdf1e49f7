"""B4/B5: fused dequantize -> fp32 reduce (-> requantize), on the card.

Counterpart of the reference's ``kernels/fused_dequant_reduce_quant.py``
(``dequant_reduce_quant_pallas``, ``dequant_reduce_pallas``): the qgZ
operators after each all-to-all hop.  The CUDA kernels live in
``csrc/fused_dequant_reduce_quant.cu`` (its header note gives the design
and what bounds them); their plain PyTorch versions are
``ref.dequant_reduce_quant_ref`` and ``ref.dequant_reduce_ref``, which sum
the N contributions in the kernels' order, so the two agree bit for bit.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
There is no other route: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import platform, ref
from repro_torch.kernels.quant_block import _QUANT_BLOCKS, _check_cuda

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_dequant_reduce": [ctypes.c_int, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             _P],
    "repro_dequant_reduce_quant": [ctypes.c_int, _P, _P, _P, _P, _P,
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _P],
}


def _lib() -> ctypes.CDLL:
    return platform.library("fused_dequant_reduce_quant", _ARGTYPES)


def _contributions(payload: torch.Tensor, scales: torch.Tensor,
                   cfg: QuantConfig) -> int:
    """Check an (N, P) payload against its (N, NB) scales; returns C."""
    N, P = payload.shape
    C = P * 2 if cfg.bits == 4 else P
    block = cfg.block_size
    if C % block or tuple(scales.shape) != (N, C // block):
        raise ValueError(f"payload {tuple(payload.shape)} / scales "
                         f"{tuple(scales.shape)} do not match block {block}")
    return C


def _cuda_inputs(payload, scales, cfg):
    _check_cuda(payload, "payload")
    _check_cuda(scales, "scales")
    if payload.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("takes int8 payload and float32 scales")
    if cfg.block_size not in _QUANT_BLOCKS:
        raise ValueError(f"kernel supports blocks {_QUANT_BLOCKS}, got "
                         f"{cfg.block_size}")
    return platform.aligned(payload), platform.aligned(scales)


def dequant_reduce(payload: torch.Tensor, scales: torch.Tensor,
                   cfg: QuantConfig) -> torch.Tensor:
    """Sum N quantized contributions in fp32: (N, P) int8, (N, NB) f32 ->
    (C,) float32 (the qgZ output)."""
    C = _contributions(payload, scales, cfg)
    if payload.device.type == "cpu":
        return ref.dequant_reduce_ref(payload, scales, cfg)
    payload, scales = _cuda_inputs(payload, scales, cfg)
    out = torch.empty((C,), dtype=torch.float32, device=payload.device)
    lib = _lib()
    err = lib.repro_dequant_reduce(
        payload.device.index or 0, payload.data_ptr(), scales.data_ptr(),
        out.data_ptr(), payload.shape[0], C // cfg.block_size,
        cfg.block_size, cfg.bits, platform.stream_of(payload))
    platform.check(lib, err, "dequant_reduce kernel")
    platform.LAUNCHES["dequant_reduce"] += 1
    return out


def dequant_reduce_quant(payload: torch.Tensor, scales: torch.Tensor,
                         cfg_in: QuantConfig, cfg_out: QuantConfig,
                         u: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ between hops: (N, P), (N, NB) -> the fp32 sum requantized with
    ``cfg_out`` (same block): ((C or C//2,) int8, (C//block,) f32).  ``u``
    is an optional (C,) float32 uniform field for stochastic rounding."""
    if cfg_in.block_size != cfg_out.block_size:
        raise ValueError("cfg_in and cfg_out must share block_size")
    C = _contributions(payload, scales, cfg_in)
    if u is not None and tuple(u.shape) != (C,):
        raise ValueError(f"u shape {tuple(u.shape)} != {(C,)}")
    if payload.device.type == "cpu":
        return ref.dequant_reduce_quant_ref(payload, scales, cfg_in, cfg_out,
                                            u)
    payload, scales = _cuda_inputs(payload, scales, cfg_in)
    if u is not None:
        _check_cuda(u, "u")
        u = platform.aligned(u.to(torch.float32))
    block = cfg_in.block_size
    out_p = torch.empty((C // 2 if cfg_out.bits == 4 else C,),
                        dtype=torch.int8, device=payload.device)
    out_s = torch.empty((C // block,), dtype=torch.float32,
                        device=payload.device)
    lib = _lib()
    err = lib.repro_dequant_reduce_quant(
        payload.device.index or 0, payload.data_ptr(), scales.data_ptr(),
        None if u is None else u.data_ptr(), out_p.data_ptr(),
        out_s.data_ptr(), payload.shape[0], C // block, block, cfg_in.bits,
        cfg_out.bits, platform.stream_of(payload))
    platform.check(lib, err, "dequant_reduce_quant kernel")
    platform.LAUNCHES["dequant_reduce_quant"] += 1
    return out_p, out_s
