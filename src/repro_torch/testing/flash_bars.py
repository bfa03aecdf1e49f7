"""Per-element bars for the bf16 outputs of the flash pair B6/B7.

Two versions of the pair on the same bf16 inputs (the kernel and its plain
version, or the plain version and the reference's Pallas kernel) differ
only in fp32 summation order and in bf16 roundings.  These bars bound what
those can account for, element by element, so that a fault confined to
part of the output (a kv tile dropped or counted twice in some rows) is
not hidden under a bar scaled by the tensor's largest value.

Forward.  Each side rounds ``p_j = exp(s_j - m)`` to bf16 before the PV
product, with a relative error of at most 2^-8 against whatever running
max its tiling gives, so the two sides' weights of key j differ by at most
2^-7·p_j/l, and ``out`` before its own rounding by at most
2^-7·Σ_j p_j·|v_j|/l: the forward of |v| in fp32.  The two final bf16
roundings add at most one ulp of the element, 2^-7·|out|.  The 1 % margin
covers the fp32 differences of the logits (about 1e-6 relative).

Backward.  Both sides compute in fp32 from the same bf16 inputs and the
same saved (out, m, l).  Before the final rounding they differ by fp32
summation order, held to the reference's fp32 bar (rtol and atol 3e-5,
``tests/test_flash_kernels.py``); the roundings add one ulp, 2^-7·|grad|.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

_BF16_ULP = 2.0 ** -7       # one ulp of a bf16 value x is at most this·|x|
_MARGIN = 1.01


def out_bar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            want: torch.Tensor, **kw) -> torch.Tensor:
    """Bar on |out - want| for each element of a bf16 forward's ``out``;
    ``kw`` are the forward's scale/causal/window/softcap."""
    row = ref.flash_fwd_ref(q.float(), k.float(), v.float().abs(), **kw)[0]
    return _MARGIN * _BF16_ULP * (row + want.float().abs())


def grad_bar(want: torch.Tensor) -> torch.Tensor:
    """Bar on |grad - want| for each element of a bf16 dq, dk or dv."""
    w = want.float().abs()
    return _MARGIN * _BF16_ULP * w + 3e-5 * (1 + w)


def worst(got: torch.Tensor, want: torch.Tensor, bar: torch.Tensor
          ) -> tuple:
    """(max |got - want| / bar, max |got - want|), in fp32."""
    d = (got.float() - want.float()).abs()
    return (d / bar).max().item(), d.max().item()
