"""GQA attention: training, prefill and decode.

Port of the reference's ``models/attention.py`` (``mha`` — dense, and the
chunked online-softmax ``flash_attention`` with its hand-written VJP —,
its sequence-parallel KV gather ``_gather_seq`` and ``seq_shard_offset``,
``per_seq_pos``, ``decode_attend`` with its ring-buffer slot positions,
``cache_insert``).  Every route takes the sliding ``window`` of
``local`` layers as the reference's mask ``q_pos - k_pos < window``.  Training may shard
the sequence over ``seq_axes`` (``RunSpec.seq_axes``, the ranks of
``seq_group``): queries stay local, K/V are all-gathered in global shard
order, and the backward reduce-scatters their cotangents.  Decode is not
sharded, so the reference's pmax/psum combines are left out.  Under the
default ``impl="xla"`` all of it is plain PyTorch, as the reference
computes it outside any Pallas kernel; the dense path is differentiated by
autograd.  Under ``impl="pallas"`` (the training step's
``RunSpec.attn_impl``), ``mha`` takes the reference's rule: an unsharded
sequence with S >= 512 and S, Sq multiples of 512 goes through the
hand-written flash kernels B6/B7
(``kernels/flash_ops.flash_attention_kernel``); other shapes and every
sharded sequence take the chunked or dense path as under ``"xla"``.
Serving never asks for it.

GQA: the reference repeats each KV head ``H // K`` times; here the query
heads are grouped as (K, H // K) instead, which pairs every query head
with the same KV head without materializing the repeat.  Logits are fp32
(bf16 products are exact in fp32), probabilities are cast to the query
dtype before the value product, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.kernels.flash_ops import flash_attention_kernel

NEG_INF = -1e30


class _GatherSeq(torch.autograd.Function):
    """All-gather (B, S_loc, ...) along dim 1 over ``group`` in rank order
    (the global shard order); the backward reduce-scatters the cotangent
    along dim 1, summed in its own dtype (the reference's
    ``psum_scatter``).  bf16 crosses as 2-byte lanes both ways: the gather
    as ``collectives.gather_bf16``'s int8 pairs, the reduce-scatter as
    bf16 itself.  Both are counted under ``collectives.OTHER``: they carry
    activations, not ZeRO parameter traffic."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w = cl.world_size(group)
        xt = x.movedim(1, 0).contiguous()                 # (S_loc, B, ...)
        full = cl.gather_bf16(xt.reshape(-1), group, cl.OTHER)
        return full.reshape((w * xt.shape[0],) + xt.shape[1:]).movedim(0, 1)

    @staticmethod
    def backward(ctx, g):
        w = cl.world_size(ctx.group)
        gt = g.movedim(1, 0).contiguous()                 # (S, B, ...)
        out = cl.baseline_reduce_scatter(gt.reshape(-1), ctx.group,
                                         label=cl.OTHER)
        out = out.reshape((gt.shape[0] // w,) + gt.shape[1:])
        return out.movedim(0, 1), None


def _gather_seq(x: torch.Tensor, seq_axes: Sequence[str],
                group: Any = None) -> torch.Tensor:
    """All-gather a (B, S_loc, ...) tensor along dim 1 over the sequence
    ranks (``seq_axes``, carried by ``group``), in global shard order.
    The reference gathers axis by axis, which puts the shards of a
    two-axis sequence in m·Y + d order; the port gathers the group at once
    in rank order d·X + m, the order of ``seq_shard_offset``."""
    if not seq_axes or cl.world_size(group) == 1:
        return x
    return _GatherSeq.apply(x, group)


def seq_shard_offset(s_local: int, seq_axes: Sequence[str],
                     group: Any = None) -> int:
    """Global position of this rank's first sequence element."""
    return cl.flat_rank(group) * s_local if seq_axes else 0


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, Sq, S) fp32 logits of q (B, Sq, H, hd) against k (B, S, K, hd)."""
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).to(torch.float32)
    lg = torch.einsum("bqkrd,bskd->bkrqs", qg, k.to(torch.float32))
    return lg.reshape(B, H, Sq, S) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, Sq, H, hd) = p (B, H, Sq, S) @ v (B, S, K, hd), in p's dtype."""
    B, H, Sq, S = p.shape
    K, hd = v.shape[2], v.shape[3]
    pg = p.reshape(B, K, H // K, Sq, S)
    out = torch.einsum("bkrqs,bskd->bqkrd", pg, v.to(p.dtype))
    return out.reshape(B, Sq, H, hd)


def _causal(q_pos: torch.Tensor, k_pos: torch.Tensor,
            window: int = 0) -> torch.Tensor:
    """(Sq, S) mask: causal, and within ``window`` positions when > 0
    (the reference's ``q_pos - k_pos < window``)."""
    mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        seq_axes: Sequence[str] = (), seq_group: Any = None,
        kv_chunk: int = 1024, impl: str = "xla",
        window: int = 0) -> torch.Tensor:
    """Causal attention for training and prefill (sliding-window when
    ``window`` > 0: query p sees keys p - window < k <= p).  q (B, Sq, H, hd) and k,
    v (B, Sq, K, hd) are this rank's shards of a sequence sharded over
    ``seq_axes`` (the ranks of ``seq_group``; none: the whole sequence):
    K/V are gathered to (B, S, K, hd) and the queries sit at
    ``seq_shard_offset`` + [0, Sq).  With ``impl="pallas"`` an unsharded
    sequence with S >= 512 and S, Sq multiples of 512 runs the flash
    kernels (the reference's ``attention.py:101`` rule).  Otherwise
    sequences longer than ``kv_chunk`` (and a multiple of it) take the
    chunked online-softmax path with its hand-written VJP, which keeps the
    working set at O(Sq·kv_chunk), and the rest the dense path — the
    reference's rules and arithmetic."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5
    k = _gather_seq(k, seq_axes, seq_group)
    v = _gather_seq(v, seq_axes, seq_group)
    S = k.shape[1]
    if impl == "pallas" and not seq_axes and S >= 512 and S % 512 == 0 \
            and Sq % 512 == 0:
        return flash_attention_kernel(q, k, v, scale, True, window, 0.0)
    q_pos = seq_shard_offset(Sq, seq_axes, seq_group) + torch.arange(
        Sq, device=q.device)
    if S > kv_chunk and S % kv_chunk == 0:
        return flash_attention(q, k, v, q_pos, scale, kv_chunk, window)
    logits = _logits(q, k, scale)
    mask = _causal(q_pos, torch.arange(S, device=q.device), window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return _pv(p, v)


def _chunk_logits(q, kc, k0, q_pos, scale, window):
    """(B, H, Sq, kc) masked fp32 logits for one KV chunk starting at k0."""
    logits = _logits(q, kc, scale)
    k_pos = k0 + torch.arange(kc.shape[1], device=q.device)
    return torch.where(_causal(q_pos, k_pos, window)[None, None], logits,
                       NEG_INF)


def _flash_forward(q, k, v, q_pos, scale, kv_chunk, window):
    """Chunked online-softmax forward (the reference's _flash_fwd_impl):
    returns out (B, Sq, H, hd) and the fp32 row stats m, l (B, H, Sq),
    l clamped at 1e-30."""
    B, Sq, H, hd = q.shape
    S = k.shape[1]
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, kv_chunk):
        kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
        logits = _chunk_logits(q, kc, k0, q_pos, scale, window)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _pv(p.to(q.dtype), vc).permute(0, 2, 1, 3)   # (B, H, Sq, hd)
        acc = acc * corr[..., None] + pv.to(torch.float32)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3), m, l


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: the backward
    rebuilds each chunk's probabilities from the saved row stats and
    accumulates dq over the chunks, dk/dv per chunk, all in fp32."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, scale, kv_chunk, window):
        out, m, l = _flash_forward(q, k, v, q_pos, scale, kv_chunk, window)
        ctx.save_for_backward(q, k, v, q_pos, out, m, l)
        ctx.scale, ctx.kv_chunk, ctx.window = scale, kv_chunk, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, out, m, l = ctx.saved_tensors
        scale, kv_chunk = ctx.scale, ctx.kv_chunk
        B, Sq, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        r = H // K
        do = dout.permute(0, 2, 1, 3).to(torch.float32)   # (B, H, Sq, hd)
        o = out.permute(0, 2, 1, 3).to(torch.float32)
        D = torch.sum(do * o, dim=-1)                     # (B, H, Sq)
        dog = do.reshape(B, K, r, Sq, hd)
        qf = q.to(torch.float32).reshape(B, Sq, K, r, hd)
        dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
        dk = torch.empty((B, S, K, hd), dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
        for k0 in range(0, S, kv_chunk):
            sl = slice(k0, k0 + kv_chunk)
            kc, vc = k[:, sl].to(torch.float32), v[:, sl].to(torch.float32)
            logits = _chunk_logits(q, k[:, sl], k0, q_pos, scale,
                                   ctx.window)
            p = torch.exp(logits - m[..., None]) / l[..., None]
            dp = torch.einsum("bkrqd,bskd->bkrqs", dog, vc)
            dl = p.reshape(B, K, r, Sq, -1) * (dp - D.reshape(B, K, r, Sq, 1))
            dq = dq + torch.einsum("bkrqs,bskd->bkrqd", dl, kc).reshape(
                B, H, Sq, hd) * scale
            dk[:, sl] = torch.einsum("bkrqs,bqkrd->bskd", dl, qf) * scale
            dv[:, sl] = torch.einsum("bkrqs,bkrqd->bskd",
                                     p.reshape(B, K, r, Sq, -1), dog)
        dq = dq.permute(0, 2, 1, 3).to(q.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, scale: float, kv_chunk: int,
                    window: int = 0) -> torch.Tensor:
    """Causal (sliding-window when ``window`` > 0) chunked online-softmax
    attention with the reference's hand-written VJP.  q (B, Sq, H, hd);
    k, v (B, S, K, hd) with S a multiple of ``kv_chunk``; q_pos (Sq,)
    absolute query positions."""
    return _FlashAttention.apply(q, k, v, q_pos, scale, kv_chunk, window)


def per_seq_pos(cache_pos, batch: int) -> torch.Tensor:
    """Normalize ``cache_pos`` to a per-sequence (B,) int32 vector (a
    scalar broadcasts): rows of a continuously batched decode sit at
    different positions."""
    p = torch.as_tensor(cache_pos, dtype=torch.int32)
    if p.dim() == 0:
        return p.expand(batch)
    assert tuple(p.shape) == (batch,), (tuple(p.shape), batch)
    return p


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_pos: torch.Tensor, *,
                  window: int = 0,
                  slot_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Exact decode attention of (B, 1, H, hd) queries over a (B, S, K, hd)
    cache.  Slot s holds position s, or ``slot_positions[b, s]`` (a ring
    buffer: a sliding-window layer's cache; negative = empty).  Each row
    attends to the slots whose position p satisfies 0 <= p <= its
    ``cache_pos`` t and, with a ``window``, p > t - window."""
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    cache_pos = per_seq_pos(cache_pos, B).to(q.device)
    logits = _logits(q, k_cache, hd ** -0.5)              # (B, H, 1, S)
    pos = torch.arange(S, device=q.device)[None, :] if slot_positions is None \
        else slot_positions.to(q.device).reshape(-1, S)   # (1 | B, S)
    t = cache_pos[:, None].to(pos.dtype)
    valid = (pos >= 0) & (pos <= t)
    if window:
        valid &= pos > t - window
    vmask = valid[:, None, None, :]                       # (B, 1, 1, S)
    logits = torch.where(vmask, logits, NEG_INF)
    m = logits.amax(dim=-1)                               # (B, H, 1)
    e = torch.where(vmask, torch.exp(logits - m[..., None]), 0.0)
    denom = e.sum(dim=-1)                                 # (B, H, 1)
    num = _pv(e.to(q.dtype), v_cache)                     # (B, 1, H, hd)
    out = num / denom.permute(0, 2, 1)[..., None].to(num.dtype)
    return out.to(q.dtype)


def cache_insert(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_pos: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write each sequence's new K/V (B, 1, K, hd) at its own slot
    ``cache_pos`` (a ring cache passes position mod capacity) of the (B,
    S, K, hd) caches.  Unlike the reference (immutable arrays, donated
    buffers) the write is IN PLACE; the caches are returned for symmetry.
    Rows whose position lies outside [0, S) are left untouched."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    pos = per_seq_pos(cache_pos, B).to(k_cache.device).long()
    idx = pos.clamp(0, S - 1)
    mine = ((pos >= 0) & (pos < S))[:, None, None]
    rows = torch.arange(B, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[rows, idx]
        cache[rows, idx] = torch.where(mine, new[:, 0].to(cache.dtype), cur)
    return k_cache, v_cache
