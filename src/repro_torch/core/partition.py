"""Flat parameter buffers: the ZeRO-3 "partitioned model state" layout.

Port of the reference's ``core/partition.py``.  Every logical weight group
lives in one flat 1-D buffer padded to a multiple of ``world × block``,
with entries in the same order and at the same offsets as the reference,
so a flat buffer the reference made loads here unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static layout of named tensors inside one flat buffer."""

    entries: Tuple[Tuple[str, Tuple[int, ...]], ...]  # (name, shape)
    align: int = 1  # pad total length to a multiple of this (world*block)

    @functools.cached_property
    def offsets(self) -> Dict[str, Tuple[int, int]]:
        off, out = 0, {}
        for name, shape in self.entries:
            n = int(np.prod(shape)) if shape else 1
            out[name] = (off, n)
            off += n
        return out

    @property
    def size(self) -> int:
        return sum(int(np.prod(s)) if s else 1 for _, s in self.entries)

    @property
    def padded_size(self) -> int:
        a = self.align
        return ((self.size + a - 1) // a) * a

    def unpack(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Slice a (padded) flat buffer into named, shaped views."""
        out = {}
        for name, shape in self.entries:
            off, n = self.offsets[name]
            out[name] = flat[off:off + n].view(shape)
        return out


def alignment(world: int, *blocks: int) -> int:
    """Padding alignment satisfying ZeRO sharding + every quant block: the
    per-shard length must be a multiple of every block, so the total is
    padded to world × lcm(blocks)."""
    a = 1
    for b in blocks:
        a = a * b // math.gcd(a, b)
    return world * a


def shard_of(flat, rank: int, world: int):
    """This rank's primary shard of a (padded) global flat buffer."""
    n = flat.shape[-1]
    assert n % world == 0
    per = n // world
    return flat[..., rank * per:(rank + 1) * per]
