"""Inputs that put the blockwise quantizer at its edges.

The qgZ kernels B3 and B4 round with an exact magic-number add and skip
the clip where it cannot act (``kernels/csrc/qgz_stream.cuh``).  Their
bit-identity holds are only as good as the inputs they see; these rows
make every launch meet an all-zero block, exact half-way points and their
float32 neighbours beside ordinary values.
"""
from __future__ import annotations

import torch


def edge_rows(g: torch.Generator, rows: int, n: int, block: int, bits: int,
              dtype: torch.dtype) -> torch.Tensor:
    """(rows, n) values on ``g``'s device whose first quant blocks hit the
    quantizer's edges: block 0 all zero; block 1 exact half-way points
    (x * inv = k + 1/2: values (k + 1/2) * 2^-3 with absmax qmax * 2^-3,
    whose scale is 2^-3); block 2, for fp32, their float32 neighbours, one
    ulp up or down in turn, with its absmax kept at qmax * 2^-3; the rest
    N(0, 9).  Blocks the row does not have are left out."""
    qmax = 7 if bits == 4 else 127
    dev = g.device
    x = torch.randn(rows, n, generator=g, device=dev) * 3
    nb = n // block
    if nb > 1:
        k = torch.randint(-qmax, qmax, (rows, block), generator=g,
                          device=dev).float() + 0.5
        k[:, 0] = qmax
        x[:, block:2 * block] = k * 2.0 ** -3
    if nb > 2 and dtype == torch.float32:
        toward = torch.where(torch.arange(block, device=dev) % 2 == 0,
                             torch.inf, -torch.inf)
        x[:, 2 * block:3 * block] = torch.nextafter(x[:, block:2 * block],
                                                    toward)
        x[:, 2 * block] = qmax * 2.0 ** -3
    x[:, :block] = 0
    return x.to(dtype)
