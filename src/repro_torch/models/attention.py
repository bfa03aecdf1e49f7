"""GQA attention: training, prefill and decode.

Port of the reference's ``models/attention.py`` (``mha`` — dense, and the
chunked online-softmax ``flash_attention`` with its hand-written VJP —,
its sequence-parallel KV gather ``_gather_seq`` and ``seq_shard_offset``,
``per_seq_pos``, ``decode_attend`` with its ring-buffer slot positions,
``cache_insert``, and the paged arena's ``paged_insert`` and
``paged_attend``, with the split-KV combine of both).  Every route takes
the sliding ``window`` of ``local`` layers as the reference's mask
``q_pos - k_pos < window``, and
the ``logit_softcap`` c as the reference's ``c·tanh(logits / c)`` on the
scaled logits before the mask (the chunked backward's chain factor
``1 - tanh²``).  Training may shard
the sequence over ``seq_axes`` (``RunSpec.seq_axes``, the ranks of
``seq_group``): queries stay local, K/V are all-gathered in global shard
order, and the backward reduce-scatters their cotangents.  Serving may
shard the cache's sequence over ``kv_axes`` (the ranks of ``kv_group``):
a decode cache's slots, a paged arena's offsets within a page.  Each rank
writes only the slots it owns and scores only its keys; the exact
two-pass combine is the reference's: a MAX all-reduce of the row
maxima, then a SUM all-reduce of the normaliser and the weighted values
(one message, in fp32; the reference psums the values in the query
dtype).  Under the
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


def _cap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    """``softcap·tanh(logits / softcap)``; the logits as they are when
    ``softcap`` is 0."""
    return torch.tanh(logits / softcap) * softcap if softcap else logits


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
        window: int = 0, logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention for training and prefill (sliding-window when
    ``window`` > 0: query p sees keys p - window < k <= p; logits capped
    at ±``logit_softcap`` when > 0).  q (B, Sq, H, hd) and k,
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
        return flash_attention_kernel(q, k, v, scale, True, window,
                                      logit_softcap)
    q_pos = seq_shard_offset(Sq, seq_axes, seq_group) + torch.arange(
        Sq, device=q.device)
    if S > kv_chunk and S % kv_chunk == 0:
        return flash_attention(q, k, v, q_pos, scale, kv_chunk, window,
                               logit_softcap)
    logits = _cap(_logits(q, k, scale), logit_softcap)
    mask = _causal(q_pos, torch.arange(S, device=q.device), window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return _pv(p, v)


def _chunk_logits(q, kc, k0, q_pos, scale, window, softcap):
    """(B, H, Sq, kc) masked fp32 logits for one KV chunk starting at k0."""
    logits = _cap(_logits(q, kc, scale), softcap)
    k_pos = k0 + torch.arange(kc.shape[1], device=q.device)
    return torch.where(_causal(q_pos, k_pos, window)[None, None], logits,
                       NEG_INF)


def _flash_forward(q, k, v, q_pos, scale, kv_chunk, window, softcap):
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
        logits = _chunk_logits(q, kc, k0, q_pos, scale, window, softcap)
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
    accumulates dq over the chunks, dk/dv per chunk, all in fp32; under a
    softcap the logit gradient takes the chain factor 1 - t² of t =
    capped / softcap (0 at masked positions, where the capped logit is
    NEG_INF)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, scale, kv_chunk, window, softcap):
        out, m, l = _flash_forward(q, k, v, q_pos, scale, kv_chunk, window,
                                   softcap)
        ctx.save_for_backward(q, k, v, q_pos, out, m, l)
        ctx.scale, ctx.kv_chunk, ctx.window = scale, kv_chunk, window
        ctx.softcap = softcap
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
                                   ctx.window, ctx.softcap)
            p = torch.exp(logits - m[..., None]) / l[..., None]
            dp = torch.einsum("bkrqd,bskd->bkrqs", dog, vc)
            dl = p.reshape(B, K, r, Sq, -1) * (dp - D.reshape(B, K, r, Sq, 1))
            if ctx.softcap:
                t = logits / ctx.softcap
                chain = torch.where(logits <= NEG_INF / 2, 0.0, 1.0 - t * t)
                dl = dl * chain.reshape(dl.shape)
            dq = dq + torch.einsum("bkrqs,bskd->bkrqd", dl, kc).reshape(
                B, H, Sq, hd) * scale
            dk[:, sl] = torch.einsum("bkrqs,bqkrd->bskd", dl, qf) * scale
            dv[:, sl] = torch.einsum("bkrqs,bkrqd->bskd",
                                     p.reshape(B, K, r, Sq, -1), dog)
        dq = dq.permute(0, 2, 1, 3).to(q.dtype)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, scale: float, kv_chunk: int,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal (sliding-window when ``window`` > 0, logits capped at
    ±``softcap`` when > 0) chunked online-softmax attention with the
    reference's hand-written VJP.  q (B, Sq, H, hd); k, v (B, S, K, hd)
    with S a multiple of ``kv_chunk``; q_pos (Sq,) absolute query
    positions."""
    return _FlashAttention.apply(q, k, v, q_pos, scale, kv_chunk, window,
                                 softcap)


def kv_shard(kv_axes: Sequence[str], kv_group: Any = None, *,
             n_loc: int = 0, n: int = 0) -> Tuple[int, int, int]:
    """(world, n_loc, offset) of this rank's block of the cache's sequence
    sharded over ``kv_axes`` (the ranks of ``kv_group``), given its local
    length ``n_loc`` or its global length ``n`` (cut ``world`` ways): rank
    r owns the global slots [r·n_loc, (r + 1)·n_loc), in the rank order
    of ``seq_shard_offset``.  Unsharded: (1, n_loc or n, 0)."""
    world, rank = (cl.world_size(kv_group), cl.flat_rank(kv_group)) \
        if kv_axes else (1, 0)
    n_loc = n // world if n else n_loc
    return world, n_loc, rank * n_loc


def _combine(logits: torch.Tensor, vmask: torch.Tensor, v: torch.Tensor,
             dtype: torch.dtype, kv_axes: Sequence[str], kv_group: Any,
             clamp: bool) -> torch.Tensor:
    """Softmax-weighted values of masked (B, H, T, S_loc) fp32 logits over
    this rank's keys v (B, S_loc, K, hd), combined exactly over the kv
    shards: the row maxima by a MAX all-reduce, then the normaliser and
    the weighted values by one SUM all-reduce (fp32).  ``clamp`` floors
    the normaliser at 1e-30 after the combine (a row with no key yields
    zeros)."""
    combine = kv_shard(kv_axes, kv_group)[0] > 1
    logits = torch.where(vmask, logits, NEG_INF)
    m = logits.amax(dim=-1)                               # (B, H, T)
    if combine:
        cl.all_reduce(m, kv_group, op="max")
    e = torch.where(vmask, torch.exp(logits - m[..., None]), 0.0)
    denom = e.sum(dim=-1)                                 # (B, H, T)
    num = _pv(e.to(dtype), v)                             # (B, T, H, hd)
    if combine:
        both = torch.cat([denom.reshape(-1),
                          num.to(torch.float32).reshape(-1)])
        cl.all_reduce(both, kv_group)
        n = denom.numel()
        denom = both[:n].reshape(denom.shape)
        num = both[n:].reshape(num.shape).to(num.dtype)
    if clamp:
        denom = torch.clamp(denom, min=1e-30)
    out = num / denom.permute(0, 2, 1)[..., None].to(num.dtype)
    return out.to(dtype)


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
                  window: int = 0, logit_softcap: float = 0.0,
                  slot_positions: Optional[torch.Tensor] = None,
                  kv_axes: Sequence[str] = (), kv_group: Any = None
                  ) -> torch.Tensor:
    """Exact decode attention of (B, 1, H, hd) queries over a (B, S_loc,
    K, hd) cache: this rank's shard of the cache's sequence over
    ``kv_axes`` (the whole cache when unsharded), combined over
    ``kv_group``.  Slot s holds position ``slot_positions[b, s]`` (global
    positions, which a sharded cache must pass; a ring buffer: a
    sliding-window layer's cache; negative = empty), or s.  Each row attends to the slots whose
    position p satisfies 0 <= p <= its ``cache_pos`` t and, with a
    ``window``, p > t - window; its logits are capped at
    ±``logit_softcap`` when > 0."""
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    cache_pos = per_seq_pos(cache_pos, B).to(q.device)
    logits = _cap(_logits(q, k_cache, hd ** -0.5),        # (B, H, 1, S)
                  logit_softcap)
    pos = torch.arange(S, device=q.device)[None, :] if slot_positions is None \
        else slot_positions.to(q.device).reshape(-1, S)   # (1 | B, S)
    t = cache_pos[:, None].to(pos.dtype)
    valid = (pos >= 0) & (pos <= t)
    if window:
        valid &= pos > t - window
    return _combine(logits, valid[:, None, None, :], v_cache, q.dtype,
                    kv_axes, kv_group, clamp=False)


def cache_insert(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_pos: torch.Tensor, offset: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write each sequence's new K/V (B, 1, K, hd) at its own global slot
    ``cache_pos`` (a ring cache passes position mod capacity) of the (B,
    S_loc, K, hd) caches, whose first slot is global slot ``offset`` (this
    rank's shard of a sharded cache sequence).  Unlike the reference
    (immutable arrays, donated buffers) the write is IN PLACE; the caches
    are returned for symmetry.  Rows whose slot lies outside [offset,
    offset + S_loc) are left untouched: another rank owns it."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    pos = per_seq_pos(cache_pos, B).to(k_cache.device).long() - offset
    idx = pos.clamp(0, S - 1)
    mine = ((pos >= 0) & (pos < S))[:, None, None]
    rows = torch.arange(B, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[rows, idx]
        cache[rows, idx] = torch.where(mine, new[:, 0].to(cache.dtype), cur)
    return k_cache, v_cache


def paged_write_plan(positions, table, page: int, d_off: int = 0,
                     page_loc: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The writes of a (B, T) chunk at ``positions`` through a (B, Pm)
    page table that land on this rank: (flat indices into B·T, their
    physical pages, their offsets within this rank's slice of the page),
    computed on the tensors' own device.  A page holds ``page`` tokens;
    this rank owns the offsets [d_off, d_off + page_loc) of each
    (``page_loc`` default: all of them).  A write is dropped where its
    logical page is negative, at or past Pm, or maps to -1 (an idle row,
    or a position past the reservation), or where its offset belongs to
    another rank."""
    page_loc = page if page_loc is None else page_loc
    positions = torch.as_tensor(positions).long()
    table = torch.as_tensor(table).long().to(positions.device)
    lp = torch.div(positions, page, rounding_mode="floor")      # (B, T)
    phys = torch.gather(table, 1, lp.clamp(0, table.shape[1] - 1))
    loc = torch.remainder(positions, page) - d_off
    ok = (phys >= 0) & (lp >= 0) & (lp < table.shape[1]) & (loc >= 0) \
        & (loc < page_loc)
    sel = ok.reshape(-1).nonzero().squeeze(1)
    return sel, phys.reshape(-1)[sel], loc.reshape(-1)[sel]


def paged_insert(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, positions,
                 table, plan: Optional[tuple] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V (B, T, K, hd) into a (N_pages, page_loc, K, hd)
    arena through per-row page tables (B, Pm), IN PLACE (the reference
    returns new arrays); the arena is returned for symmetry.  Token j of
    row b lands at position ``positions[b, j]``: page ``table[b, p //
    page]``, offset ``p % page``.  Writes that ``paged_write_plan`` drops
    are masked out of the scatter, so an idle row (an all-(-1) table row)
    or a speculative write past the reservation touches nothing, and a
    rank writes only the offsets it owns.  ``plan`` is that function's
    result for these positions and table, on the arena's device (the
    model computes it once per call for every layer; default: an
    unsharded arena, page = page_loc)."""
    B, T, K, hd = k_new.shape
    if plan is None:
        plan = paged_write_plan(positions, table, k_cache.shape[1])
    sel, rows, cols = (t.to(k_cache.device) for t in plan)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        flat = new.reshape(B * T, K, hd).index_select(0, sel)
        cache[rows, cols] = flat.to(cache.dtype)
    return k_cache, v_cache


def paged_attend(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, positions, table, *,
                 softmax_scale: Optional[float] = None,
                 logit_softcap: float = 0.0,
                 kv_axes: Sequence[str] = (), kv_group: Any = None
                 ) -> torch.Tensor:
    """Exact attention of (B, T, H, hd) queries at ``positions`` (B, T)
    over a paged arena (N_pages, page_loc, K, hd) through page tables (B,
    Pm).  The arena holds this rank's offsets [d_off, d_off + page_loc) of
    every page of page_loc · (kv world) tokens (the within-page dim
    sharded over ``kv_axes``; all of them unsharded), combined over
    ``kv_group``.

    Each row's pages are gathered into a (B, Pm·page_loc) view in logical
    order; a key's position is its logical page × page + d_off + its
    offset, -1 where the table holds -1.  The mask is causal per query
    (key position <= query position), so a multi-token row (chunked
    prefill, speculative verify) sees its own just-inserted keys up to
    itself.  The normaliser is clamped at 1e-30 after the combine: an
    all-(-1) row attends to nothing and yields zeros, not NaN."""
    B, T, H, hd = q.shape
    page_loc, K = k_cache.shape[1], k_cache.shape[2]
    world, _, d_off = kv_shard(kv_axes, kv_group, n_loc=page_loc)
    page = page_loc * world
    table = torch.as_tensor(table).long().to(q.device)
    positions = torch.as_tensor(positions).long().to(q.device)
    Pm = table.shape[1]
    S = Pm * page_loc
    safe = table.clamp(min=0)
    kk = k_cache[safe].reshape(B, S, K, hd)
    vv = v_cache[safe].reshape(B, S, K, hd)
    lpos = (torch.arange(Pm, device=q.device)[:, None] * page + d_off
            + torch.arange(page_loc, device=q.device)[None, :])  # (Pm, pl)
    kpos = torch.where((table >= 0)[:, :, None], lpos[None],
                       -1).reshape(B, S)
    logits = _cap(_logits(q, kk, softmax_scale or hd ** -0.5),
                  logit_softcap)                                # (B, H, T, S)
    valid = (kpos >= 0)[:, None, :] & \
        (kpos[:, None, :] <= positions[:, :, None])              # (B, T, S)
    return _combine(logits, valid[:, None], vv, q.dtype, kv_axes, kv_group,
                    clamp=True)
