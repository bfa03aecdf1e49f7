"""Plain PyTorch oracles for the port's kernels.

Counterpart of the reference's ``kernels/ref.py``.  The quantize and
dequantize definitions live in :mod:`repro_torch.core.quant`; the staged
INT8 GEMM, the qgZ operators (reorder-quantize, dequant-reduce and
dequant-reduce-requantize) and the flash-attention forward and backward
(the reference's ``flash_fwd_pallas`` and ``flash_bwd_pallas``) live
here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import (QuantConfig, quantize_blockwise,
                                    unpack_int4)


def dequant_matmul_ref(x: torch.Tensor, payload: torch.Tensor,
                       scales: torch.Tensor,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Staged oracle for the fused INT8 dequant-GEMM: dequantize the whole
    (N, K) weight matrix through ``compute_dtype`` rounding (fp32 scale
    multiply, then the cast), then one product accumulated in fp32.

    The product runs on fp32 copies with TF32 off: a bf16*bf16 product is
    exact in fp32, so this is the staged result up to summation order.
    Returns (T, N) float32.
    x: (T, K); payload: (N, K) int8; scales: (N, NB) with K % NB == 0.
    """
    N, K = payload.shape
    nb = scales.shape[-1]
    assert K % nb == 0, (K, nb)
    w = (payload.reshape(N, nb, K // nb).to(torch.float32)
         * scales.unsqueeze(-1)).reshape(N, K).to(compute_dtype)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = xf @ wf.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def quantize_reordered_ref(x: torch.Tensor, cfg: QuantConfig,
                           u: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ reorder + quantize: transpose the (Y, X, L) gradient slices to
    (X, Y, L) (paper Eq. (1) -> (2)), then quantize the trailing dim.
    ``u`` (optional) is the uniform field on the transposed (X, Y, L)
    layout.  Returns ((X, Y, L or L//2) int8, (X, Y, L//block) f32)."""
    return quantize_blockwise(x.transpose(0, 1), cfg, u)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add), for
    float32 inputs whose product is exact in float64 (24 + 24 bits).

    PyTorch has no FMA op, so the sum runs in float64 with the
    round-to-odd rule: ``s = p + c`` with its exact error ``e`` (Knuth's
    two-sum); where ``e != 0`` and ``s`` is even, ``s`` moves one ulp
    toward ``e``.  Rounding that to float32 (24 <= 53 - 2 bits) is the
    correctly rounded result, with no double-rounding error."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dequant_reduce_ref(payload: torch.Tensor, scales: torch.Tensor,
                       cfg: QuantConfig,
                       init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize N contributions (leading dim) and sum them in fp32:
    (N, P), (N, NB) -> (C,) float32.

    The sum is the fused multiply-add chain ``acc = fma(q_n, scale_n,
    acc)`` from +0 (or from ``init``, (C,) float32) in index order n = 0
    … N-1.  That is what the reference computes for ``sum(q * scale,
    axis=0)`` and for its ring's ``dequantize(q, s) + mine`` under XLA
    (the multiply and the add contract into one FMA), and what the kernel
    computes with ``__fmaf_rn``, so all three agree bit for bit."""
    q = unpack_int4(payload) if cfg.bits == 4 else payload
    N, C = q.shape
    sb = scales.repeat_interleave(cfg.block_size, dim=-1)
    acc = (torch.zeros((C,), dtype=torch.float32, device=q.device)
           if init is None else init.to(torch.float32).reshape(C))
    for n in range(N):
        acc = fma_f32(q[n].to(torch.float32), sb[n], acc)
    return acc


def dequant_reduce_quant_ref(payload: torch.Tensor, scales: torch.Tensor,
                             cfg_in: QuantConfig, cfg_out: QuantConfig,
                             u: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qgZ between hops: dequantize N contributions, fp32 reduce,
    requantize the partial sums with ``cfg_out`` (``u``: optional (C,)
    uniform field).  Returns ((C or C//2,) int8, (C//block,) f32)."""
    acc = dequant_reduce_ref(payload, scales, cfg_in)
    return quantize_blockwise(acc, cfg_out, u)


# ------------------------------------------------------------ flash (B6, B7)

NEG_INF = -1e30


def _tile_logits(qt: torch.Tensor, kt: torch.Tensor, q0: int, k0: int,
                 scale: float, causal: bool, window: int, softcap: float
                 ) -> torch.Tensor:
    """(B, K, H//K, bq, bk) masked fp32 logits of a q tile (B, bq, H, hd)
    against a kv tile (B, bk, K, hd): the reference's ``_masked_logits``.
    The query heads are grouped as (K, H//K), so query head h meets KV head
    h // (H//K) with no repeat."""
    B, bq, H, hd = qt.shape
    bk, K = kt.shape[1], kt.shape[2]
    qg = qt.reshape(B, bq, K, H // K, hd).to(torch.float32)
    lg = torch.einsum("bqkrd,bskd->bkrqs", qg, kt.to(torch.float32)) * scale
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    qp = q0 + torch.arange(bq, device=qt.device)[:, None]
    kp = k0 + torch.arange(bk, device=qt.device)[None, :]
    ok = torch.ones((bq, bk), dtype=torch.bool, device=qt.device)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    return torch.where(ok, lg, NEG_INF)


def _fp32_matmuls(fn):
    """Run ``fn`` with TF32 off: the reference's products are fp32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, bq: int = 512, bk: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the reference's ``flash_fwd_pallas``.

    q (B, Sq, H, hd); k, v (B, S, K, hd).  Returns out (B, Sq, H, hd) in
    q's dtype and the fp32 row stats m, l (B, H, Sq), l clamped at 1e-30.
    The online softmax runs over bk-wide kv tiles in order, as the
    reference's grid does: fp32 logits times ``scale``, softcap
    ``tanh(x/c)*c``, ``NEG_INF`` in masked places, ``p`` cast to v's dtype
    before the fp32-accumulated PV product."""
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    bq, bk = min(bq, Sq), min(bk, S)
    assert Sq % bq == 0 and S % bk == 0, (Sq, S, bq, bk)
    r = H // K
    dev = q.device

    def run():
        outs, ms, ls = [], [], []
        for q0 in range(0, Sq, bq):
            qt = q[:, q0:q0 + bq]
            m = torch.full((B, K, r, bq), NEG_INF, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, K, r, bq), dtype=torch.float32, device=dev)
            acc = torch.zeros((B, K, r, bq, hd), dtype=torch.float32,
                              device=dev)
            for k0 in range(0, S, bk):
                lg = _tile_logits(qt, k[:, k0:k0 + bk], q0, k0, scale,
                                  causal, window, softcap)
                m_new = torch.maximum(m, lg.amax(dim=-1))
                p = torch.exp(lg - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                m = m_new
                pv = torch.einsum("bkrqs,bskd->bkrqd",
                                  p.to(v.dtype).to(torch.float32),
                                  v[:, k0:k0 + bk].to(torch.float32))
                acc = acc * corr[..., None] + pv
            l = torch.clamp(l, min=1e-30)
            out = (acc / l[..., None]).to(q.dtype)
            outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd))
            ms.append(m.reshape(B, H, bq))
            ls.append(l.reshape(B, H, bq))
        return (torch.cat(outs, dim=1), torch.cat(ms, dim=-1),
                torch.cat(ls, dim=-1))
    return _fp32_matmuls(run)


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  dout: torch.Tensor, *, scale: float, causal: bool = True,
                  window: int = 0, softcap: float = 0.0, bq: int = 512,
                  bk: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the reference's ``flash_bwd_pallas``: returns (dq,
    dk, dv) in the dtypes of q, k, v.

    Entirely fp32: ``dsum = rowsum(dO∘O)``, ``p = exp(logits - m) / l``
    rebuilt per tile, ``dl = p·(dO·Vᵀ − dsum)`` with the softcap chain
    ``1 − t²`` (zero on masked logits), dq accumulated over the kv tiles,
    dk and dv over the q tiles and the heads of each GQA group."""
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    bq, bk = min(bq, Sq), min(bk, S)
    assert Sq % bq == 0 and S % bk == 0, (Sq, S, bq, bk)
    r = H // K
    f32 = torch.float32

    def run():
        dsum = torch.sum(dout.to(f32) * out.to(f32), dim=-1)  # (B, Sq, H)
        dsum = dsum.permute(0, 2, 1).reshape(B, K, r, Sq)
        mg, lg_ = m.reshape(B, K, r, Sq), l.reshape(B, K, r, Sq)
        dq = torch.zeros((B, K, r, Sq, hd), dtype=f32, device=q.device)
        dk = torch.zeros((B, S, K, hd), dtype=f32, device=q.device)
        dv = torch.zeros_like(dk)
        for q0 in range(0, Sq, bq):
            qs = slice(q0, q0 + bq)
            qt = q[:, qs]
            qf = qt.to(f32).reshape(B, bq, K, r, hd)
            do = dout[:, qs].to(f32).reshape(B, bq, K, r, hd)
            mt, lt, dt = (x[..., qs, None] for x in (mg, lg_, dsum))
            for k0 in range(0, S, bk):
                ks = slice(k0, k0 + bk)
                logits = _tile_logits(qt, k[:, ks], q0, k0, scale, causal,
                                      window, softcap)
                p = torch.exp(logits - mt) / lt
                dp = torch.einsum("bqkrd,bskd->bkrqs", do, v[:, ks].to(f32))
                dl = p * (dp - dt)
                if softcap:
                    t = logits / softcap
                    dl = dl * torch.where(logits <= NEG_INF / 2, 0.0,
                                          1.0 - t * t)
                dq[..., qs, :] += torch.einsum(
                    "bkrqs,bskd->bkrqd", dl, k[:, ks].to(f32)) * scale
                dv[:, ks] += torch.einsum("bkrqs,bqkrd->bskd", p, do)
                dk[:, ks] += torch.einsum("bkrqs,bqkrd->bskd", dl,
                                          qf) * scale
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return _fp32_matmuls(run)
