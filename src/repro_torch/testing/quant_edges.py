"""Inputs that put the blockwise quantizer and the INT8 dequant-GEMM at
their edges.

The qgZ kernels B3 and B4 round with an exact magic-number add and skip
the clip where it cannot act (``kernels/csrc/qgz_stream.cuh``).  Their
bit-identity holds are only as good as the inputs they see; these rows
make every launch meet an all-zero block, exact half-way points and their
float32 neighbours beside ordinary values.  B8 (``csrc/dequant_matmul.cu``)
rounds its weights to bf16 with integer operations and takes the
conversion instruction only where a scale is not finite;
:func:`dequant_matmul_edges` gives it rows and scales at both sides of
that line, and :func:`dequant_matmul_close` is the hold its card checks use.
"""
from __future__ import annotations

import math

import torch

# scales B8 meets in one group of a row each: +-0, a subnormal scale (its
# products subnormal), the smallest subnormal (products round to +-0 in
# bf16), one whose products overflow to +-inf in bf16, +inf and NaN
B8_EDGE_SCALES = (0.0, -0.0, 1e-41, 2.0 ** -149, 3.4e38, math.inf, math.nan)
# rows in a period of 16: 1-3 all -128, all 127, all -127 at a thousandth
# of the ordinary scales (their sums over a positive x row would otherwise
# set the tolerance, 1e-5 * max|out|, far above the random rows'); 4-10 one B8_EDGE_SCALES entry each in group row % NB; 12, 13, 14
# all -128 at 3.4e38 (every weight -inf), all 127 at +inf (+inf) and all
# -127 at 1e-41 (subnormal), in every group; the rest random
_B8_PERIOD = 16


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


def dequant_matmul_edges(g: torch.Generator, T: int, N: int, K: int,
                         NB: int, x_dtype: torch.dtype = torch.bfloat16,
                         scales=B8_EDGE_SCALES):
    """x (T, K) in ``x_dtype``, W (N, K) int8 and scales (N, NB) float32
    on ``g``'s device, for B8's holds: the rows of ``_B8_PERIOD`` (bytes
    -128 ... 127 elsewhere, ordinary scales in [0, 0.01)), with ``scales``
    as the special ones (each row 4 + i takes scales[i]; pass fewer to
    leave some out).  x row 0 is positive, so that a row of same-sign
    infinite weights sums to +-inf there rather than NaN."""
    dev = g.device
    x = torch.randn(T, K, generator=g, device=dev)
    x[0] = x[0].abs()
    w = torch.randint(-128, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, NB, generator=g, device=dev) * 0.01
    rows = torch.arange(N, device=dev)
    for r, v in ((1, -128), (2, 127), (3, -127), (12, -128), (13, 127),
                 (14, -127)):
        w[r::_B8_PERIOD] = v
    for r in (1, 2, 3):
        s[r::_B8_PERIOD] *= 1e-3
    for i, v in enumerate(scales):
        sel = rows[4 + i::_B8_PERIOD]
        s[sel, sel % NB] = v
    for r, v in ((12, 3.4e38), (13, math.inf), (14, 1e-41)):
        if v in scales:
            s[r::_B8_PERIOD] = v
    return x.to(x_dtype), w, s


def dequant_matmul_close(out: torch.Tensor, want: torch.Tensor):
    """B8's hold against its plain version: NaN in the same places, the
    same infinities in the same places, and the finite values within fp32
    rtol 1e-5, atol 1e-5 * max|finite want| (summation order only).
    Returns (holds, max abs error over the finite values, atol)."""
    fin = torch.isfinite(want)
    if not fin.any():
        return (torch.equal(torch.isnan(out), torch.isnan(want))
                and torch.equal(out[~torch.isnan(want)],
                                want[~torch.isnan(want)]), 0.0, 0.0)
    atol = 1e-5 * want[fin].abs().max().item()
    err = (out[fin] - want[fin]).abs().max().item()
    inf = torch.isinf(want)
    holds = (torch.equal(torch.isnan(out), torch.isnan(want))
             and torch.equal(torch.isinf(out), inf)
             and torch.equal(out[inf], want[inf])
             and torch.allclose(out[fin], want[fin], rtol=1e-5, atol=atol))
    return holds, err, atol


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit equal (NaNs included, which torch.equal never is)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))
