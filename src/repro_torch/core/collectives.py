"""ZeRO++ weight collectives on torch.distributed.

Port of the serving half of the reference's ``core/collectives.py``:

  * :func:`baseline_all_gather` — full-precision all-gather of a flat
    shard (ZeRO-3, paper Alg. 1);
  * :func:`qwz_all_gather` — blockwise-INT8 quantized all-gather (qwZ,
    §3.1): quantize the shard once, gather payload + scales, dequantize;
  * :func:`qwz_all_gather_quant` — the same gather that stays quantized,
    for a fused consumer (the INT8 head GEMM).

``group`` is a ``torch.distributed`` process group (None = the default
group).  With an initialised group of world > 1 the gathers are
``all_gather_into_tensor``; a world of 1 gathers exactly the shard itself
— the reference's semantics on a one-device mesh, not a fallback.  The
quantize and dequantize still run at world 1, as in the reference.  The
reference's non-blocked ablation, hpZ and qgZ come with the training
slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as _kops


def world_size(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _gather(shard: torch.Tensor, group=None) -> torch.Tensor:
    """Tiled all-gather of a 1-D shard along dim 0."""
    world = world_size(group)
    if world == 1:
        return shard
    out = torch.empty((world * shard.shape[0],), dtype=shard.dtype,
                      device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


def baseline_all_gather(shard: torch.Tensor, group=None,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Full-precision all-gather of a flat parameter shard (ZeRO-3)."""
    full = _gather(shard, group)
    return full if out_dtype is None else full.to(out_dtype)


def qwz_all_gather(shard: torch.Tensor, group, cfg: QuantConfig,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """All-gather a flat weight shard with in-flight blockwise
    quantization: 0.5·M payload + scales on the wire instead of M (bf16)."""
    payload_g, scales_g = qwz_all_gather_quant(shard, group, cfg)
    return _kops.dequantize_blockwise(payload_g, scales_g, cfg, out_dtype)


def qwz_all_gather_quant(shard: torch.Tensor, group, cfg: QuantConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwZ all-gather that STAYS quantized: (payload_g, scales_g).  Same
    wire traffic as :func:`qwz_all_gather`; the consumer applies the
    scales itself, so the gathered bf16 weights never exist."""
    n = shard.shape[0]
    if n % cfg.block_size:
        raise ValueError(f"shard len {n} % block {cfg.block_size} != 0")
    payload, scales = _kops.quantize_blockwise(shard, cfg)
    return _gather(payload, group), _gather(scales, group)
