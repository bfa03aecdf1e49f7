"""Blockwise symmetric quantization — the numerical core of qwZ.

Port of the reference's ``core/quant.py``: each contiguous block of
``block_size`` trailing elements gets its own scale ``absmax / qmax``
(paper §3.1).  INT8 is the qwZ weight format; INT4 packs two values per
int8 byte (low nibble from the even element).

These are the plain PyTorch definitions; the CUDA kernels in
``repro_torch.kernels`` compute the same bits and are held against them.

Op order, kept exactly: fp32 upcast, absmax over the block,
``scale = absmax * fl(1/qmax)``, ``inv = 1/scale`` (0 where scale is 0),
``x * inv``, round half to even, clip, int8.  The scale is a multiply by
the fp32 reciprocal of qmax because that is what the reference computes
wherever it runs under ``jit`` (XLA folds the division by a constant
into a multiply); the reference's un-jitted eager path divides instead
and can differ in the last bit of a scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_QMAX = {8: 127.0, 4: 7.0}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static description of a blockwise quantization scheme."""

    bits: int = 8              # 8 (qwZ default) or 4 (qgZ default)
    block_size: int = 256      # elements per scale block

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.block_size % 2:
            raise ValueError("block_size must be even (int4 packing)")

    @property
    def qmax(self) -> float:
        return _QMAX[self.bits]

    def payload_bytes(self, n: int) -> int:
        """Wire payload (the quantized values only) of n elements: INT4
        packs two a byte, an odd last element taking a whole byte."""
        return n if self.bits == 8 else (n + 1) // 2

    def wire_bytes(self, n: int, scale_bytes: int = 4) -> int:
        """Payload plus the fp32 block scales that travel with it (qwZ
        gathers them beside the payload, qgZ packs them into its
        message)."""
        nblocks = -(-n // self.block_size)
        return self.payload_bytes(n) + nblocks * scale_bytes


def quantize_blockwise(x: torch.Tensor, cfg: QuantConfig,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize the trailing dimension of ``x`` blockwise.

    ``u`` (optional, float32, shape of ``x``) is a pre-drawn uniform field
    for stochastic rounding: ``q = floor(s) + (u < s - floor(s))``.
    Returns (payload int8 — trailing length halved for INT4 —, scales f32
    of shape ``x.shape[:-1] + (n_blocks,)``).
    """
    n = x.shape[-1]
    if n % cfg.block_size:
        raise ValueError(f"trailing dim {n} not a multiple of block "
                         f"{cfg.block_size}")
    nblocks = n // cfg.block_size
    lead = x.shape[:-1]
    xb = x.reshape(*lead, nblocks, cfg.block_size).to(torch.float32)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    rq = torch.tensor(1.0 / cfg.qmax, dtype=torch.float32, device=x.device)
    scale = absmax * rq
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, 1.0), 0.0)
    s = xb * inv
    if u is None:
        q = torch.round(s)                  # half to even, like jnp.round
    else:
        lo = torch.floor(s)
        ub = u.reshape(s.shape).to(torch.float32)
        q = lo + (ub < s - lo).to(torch.float32)
    q = q.clamp(-cfg.qmax, cfg.qmax).to(torch.int8).reshape(*lead, n)
    if cfg.bits == 4:
        q = pack_int4(q)
    return q, scale.squeeze(-1)


def dequantize_blockwise(payload: torch.Tensor, scales: torch.Tensor,
                         cfg: QuantConfig,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: ``float(q) * scale``, then a
    round-to-nearest-even cast to ``out_dtype``."""
    q = unpack_int4(payload) if cfg.bits == 4 else payload
    n = q.shape[-1]
    lead = q.shape[:-1]
    qb = q.reshape(*lead, n // cfg.block_size, cfg.block_size)
    x = qb.to(torch.float32) * scales.unsqueeze(-1)
    return x.reshape(*lead, n).to(out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two-per-byte along the trailing dim."""
    lo = q[..., 0::2] & 0xF
    hi = (q[..., 1::2] & 0xF) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Unpack nibbles packed by :func:`pack_int4` (sign-extending)."""
    lo = (p << 4) >> 4   # arithmetic shifts on int8 sign-extend the low nibble
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)
