"""B6/B7: flash attention forward and backward, on the card.

Counterpart of the reference's ``kernels/flash_attention.py``
(``flash_fwd_pallas``, ``flash_bwd_pallas``): the tiled online-softmax
attention of the training step under ``attn_impl="pallas"``.  The CUDA
kernels are chosen by dtype:

  * bfloat16 (the training path): ``csrc/flash_attention_tc.cu``, every
    product on the tensor cores (``mma.sync`` bf16, fp32 accumulate), the
    backward's products with p and dl as bf16 hi + lo pairs;
  * float32: ``csrc/flash_attention.cu``, fp32 FFMA on the CUDA cores,
    which holds the reference's fp32 bars.

Each source's header note gives its design and what bounds it; the plain
PyTorch versions are ``ref.flash_fwd_ref`` and ``ref.flash_bwd_ref``.

A CUDA tensor launches the kernel of its dtype; a CPU tensor takes the
plain version.  There is no other route: a failed build or launch raises,
and so does a shape the kernel does not take.  The kernels tile by 64 × 64
and the plain version by the reference's default 512 × 512, so the two
agree to rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import platform, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TAIL = [_I, _I, _I, _I, _I, _F, _I, _I, _F, _P]   # B Sq S H K scale … stream
_FWD = [_I, _I] + [_P] * 7 + _TAIL                  # device hd q … strides
_BWD = [_I, _I] + [_P] * 11 + _TAIL
# dtype -> (library, suffix of its entry points)
_ROUTES = {torch.bfloat16: ("flash_attention_tc", "bf16"),
           torch.float32: ("flash_attention", "f32")}
HEAD_DIMS = (16, 64, 128, 256)  # qwen3-0.6b, gpt-350m, gemma3-4b, reduced
TILE = 64


def _entry(dtype: torch.dtype, which: str):
    """(library, its ``repro_flash_<which>_<suffix>`` function) of the
    kernels for ``dtype``."""
    name, sfx = _ROUTES[dtype]
    lib = platform.library(name, {f"repro_flash_fwd_{sfx}": _FWD,
                                  f"repro_flash_bwd_{sfx}": _BWD})
    return lib, getattr(lib, f"repro_flash_{which}_{sfx}")


def _shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, H, hd) and two "
                         f"(B, S, K, hd)")
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (same B and hd, H % K == 0)")
    return B, Sq, S, H, K, hd


def _check_cuda(ts, Sq: int, S: int, hd: int) -> None:
    dtype = ts[0].dtype
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError("flash attention: every tensor on one CUDA "
                             "device (or all on the CPU for the plain "
                             "version)")
        if t.dtype != dtype or dtype not in _ROUTES:
            raise TypeError(f"flash attention takes float32 or bfloat16 "
                            f"tensors of one dtype, got {t.dtype}")
    if hd not in HEAD_DIMS or Sq % TILE or S % TILE or Sq > S:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and Sq <= S, "
                         f"both multiples of {TILE}; got hd {hd}, Sq {Sq}, "
                         f"S {S}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dim and 16-byte aligned rows (the
    kernels' vector loads); copies only when it has neither."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % vec for s in t.stride()[:-1]):
        t = platform.aligned(t)
    return t


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, hd); k, v (B, S, K, hd) -> (out (B, Sq, H, hd) in q's
    dtype, m, l (B, H, Sq) float32, l clamped at 1e-30)."""
    B, Sq, S, H, K, hd = _shape(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_fwd_ref(q, k, v, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
    _check_cuda((q, k, v), Sq, S, hd)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib, fn = _entry(q.dtype, "fwd")
    err = fn(q.device.index or 0, hd, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
             _strides(q, k, v), B, Sq, S, H, K, scale, int(causal), window,
             softcap, platform.stream_of(q))
    platform.check(lib, err, "flash_fwd kernel")
    platform.LAUNCHES["flash_fwd"] += 1
    return out, m, l


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              dout: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_fwd`'s ``out`` against
    ``dout``, from its saved (out, m, l); dtypes of q, k, v.  On the card
    ``dsum = rowsum(dout·out)`` is a plain fp32 reduction (it is outside
    the reference's kernels too), laid out (B, H, Sq) as m and l are, then
    one dq kernel and one dk/dv kernel run."""
    B, Sq, S, H, K, hd = _shape(q, k, v)
    if tuple(out.shape) != tuple(q.shape) or out.shape != dout.shape or \
            tuple(m.shape) != (B, H, Sq) or m.shape != l.shape:
        raise ValueError("out/dout must be shaped as q, m/l as (B, H, Sq)")
    if q.device.type == "cpu":
        return ref.flash_bwd_ref(q, k, v, out, m, l, dout, scale=scale,
                                 causal=causal, window=window,
                                 softcap=softcap)
    _check_cuda((q, k, v, dout), Sq, S, hd)
    if m.dtype != torch.float32 or l.dtype != torch.float32:
        raise TypeError("m and l must be float32")
    q, k, v, dout = _rows(q), _rows(k), _rows(v), _rows(dout)
    m, l = platform.aligned(m), platform.aligned(l)
    dsum = torch.sum(dout.to(torch.float32) * out.to(torch.float32),
                     dim=-1).transpose(1, 2).contiguous()
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, K, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib, fn = _entry(q.dtype, "bwd")
    err = fn(q.device.index or 0, hd, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
             dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _strides(q, k, v, dout), B, Sq, S, H, K, scale, int(causal),
             window, softcap, platform.stream_of(q))
    platform.check(lib, err, "flash_bwd kernels")
    platform.LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv
