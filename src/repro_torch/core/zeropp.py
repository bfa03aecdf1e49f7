"""The ZeRO++ gather engine, serving half.

Port of the reference's ``core/zeropp.py`` (``ZeroConfig``, ``fwd_gather``,
``fwd_gather_quant``, ``qwz_gemm_eligible``, ``zero_apply_inference``) and
of the synchronous body of ``core/schedule.py``'s ``zero_scan_inference``.
Every weight group is gathered right before the compute that needs it —
qwZ INT8-quantized when enabled — and dropped after.

The reference's depth-k prefetch ring is bit-exact with the synchronous
schedule at every depth, so the port runs the synchronous loop; the ring
comes with a later slice, as do the training primitives (``zero_apply``
with hpZ and qgZ).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.core.partition import alignment
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """Which serving-path optimizations are active.

    ``dp_axes`` names the ZeRO world as the reference's mesh axes do; an
    empty tuple is local (single-device, no collectives) mode.  A
    non-empty ``dp_axes`` is "distributed" even at world 1, where the
    gathers are identities but the qwZ quantize/dequantize still run —
    exactly the reference on a one-device ``("model",)`` mesh.  The
    collectives run over ``group`` (None = torch.distributed's default
    group, or world 1 when it is not initialised).
    """

    # qwZ (§3.1)
    qwz: bool = True
    qwz_bits: int = 8
    qwz_block: int = 256
    # serving head: feed the gathered INT8 payload straight to the fused
    # dequant-GEMM where the layout allows (see qwz_gemm_eligible)
    qwz_gemm: bool = True
    # qgZ block: the training-side gradient block, kept because it sets the
    # flat buffers' alignment (the reference's layout must load unchanged)
    qgz_block: int = 256
    dp_axes: Tuple[str, ...] = ("data", "model")
    group: Any = None
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def distributed(self) -> bool:
        return bool(self.dp_axes)

    @property
    def qwz_cfg(self) -> QuantConfig:
        return QuantConfig(bits=self.qwz_bits, block_size=self.qwz_block)

    def align(self, world: int) -> int:
        return alignment(world, self.qwz_block, self.qgz_block,
                         2)  # int4 packing needs even blocks


def fwd_gather(primary: torch.Tensor, z: ZeroConfig) -> torch.Tensor:
    """Forward weights all-gather over the full ZeRO world, returned in
    ``compute_dtype``: qwZ quantizes whatever it gets; the baseline casts
    to the wire dtype (param_dtype) before gathering."""
    if not z.distributed:
        return primary.to(z.compute_dtype)
    if z.qwz:
        return cl.qwz_all_gather(primary, z.group, z.qwz_cfg,
                                 out_dtype=z.compute_dtype)
    return cl.baseline_all_gather(primary.to(z.param_dtype), z.group,
                                  out_dtype=z.compute_dtype)


def fwd_gather_quant(primary: torch.Tensor, z: ZeroConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwZ forward gather that keeps the payload quantized: (payload_g
    int8, scales_g f32).  Caller must have checked qwz_gemm_eligible."""
    return cl.qwz_all_gather_quant(primary, z.group, z.qwz_cfg)


def qwz_gemm_eligible(z: ZeroConfig, rows: int, d: int) -> bool:
    """Can a (rows, d) weight chunk at flat offset 0 feed the fused INT8
    dequant-GEMM straight from its gathered qwZ payload?  Needs INT8 qwZ
    and a scale layout that maps onto per-row groups: each row holds whole
    blocks (d % block == 0) or each block holds whole rows (block % d ==
    0, rows % (block/d) == 0: the row's scale is a broadcast)."""
    if not (z.distributed and z.qwz and z.qwz_gemm and z.qwz_bits == 8):
        return False
    b = z.qwz_block
    if (rows * d) % b:
        return False
    return d % b == 0 or (b % d == 0 and rows % (b // d) == 0)


def zero_apply_inference(f: Callable, z: ZeroConfig) -> Callable:
    """Serving layer application: gather (qwZ if enabled), then apply."""
    def apply(primary, *args):
        return f(fwd_gather(primary, z), *args)
    return apply


def zero_scan_inference(f: Callable, z: ZeroConfig) -> Callable:
    """The layer loop of the serving path, synchronous schedule.

    ``f(W_full, h, x) -> (h_next, y)``; returns ``run(stacked, h0, xs) ->
    (h_final, ys)`` where ``stacked`` is (n, P) flat layer groups, ``xs``
    a sequence of n per-layer inputs (or None) and ``ys`` the list of the
    n per-layer outputs.  Each group is gathered right before its layer.
    """
    def run(stacked: torch.Tensor, h0, xs: Optional[Sequence] = None):
        h, ys = h0, []
        for i in range(stacked.shape[0]):
            W = fwd_gather(stacked[i], z)
            h, y = f(W, h, None if xs is None else xs[i])
            ys.append(y)
        return h, ys
    return run
