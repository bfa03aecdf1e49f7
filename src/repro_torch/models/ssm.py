"""State-space sequence mixers: Mamba-2 (SSD) and RG-LRU (Griffin).

Port of the reference's ``models/ssm.py``: ``shard_prefix_state``,
``gather_conv_halo``, ``ssd_scan``, ``_total_prefix_decay``,
``ssd_step``, ``rglru_scan`` and ``rglru_step``.  Both mixers are
diagonal linear recurrences h_t = a_t ⊙ h_{t-1} + b_t.  Under a sequence
sharded over ``seq_axes`` (the ranks of ``seq_group``, in global shard
order) each rank scans its own shard from a zero state, then the ranks'
(total decay, final state) pairs are all-gathered and every rank folds
the prefix of the shards before it into its incoming state; the causal
conv's history is the previous shard's tail.  The gathers are
``attention._GatherSeq``: their backward reduce-scatters the cotangent,
so the gradients of a halo and of a prefix state reach the ranks that
produced them.  Every rank's output depends on every gathered value
(zero where unused, as the reference's ``where`` and index), so each
rank runs the same backward collectives.

Two departures, each computing the reference's function:

  * the inclusive scan.  The reference's ``lax.associative_scan`` has no
    torch counterpart; :class:`_LinearScan` is one autograd Function for
    h_t = a_t h_{t-1} + b_t whose forward is a log-depth (Hillis-Steele)
    scan with the reference's ``comb`` and whose backward is the reversed
    scan g_b,t = g_t + a_{t+1} g_b,t+1, g_a,t = g_b,t h_{t-1}; it saves
    only a and h.  The decays' running products are computed from their
    logarithms (a cumulative sum, then exp), which the ``ssd`` chunk
    decays and the RG-LRU's a_t = exp(log_a · r_t) give directly.
  * the masked segment sum.  ``ssd_scan``'s intra-chunk decay exp(cum_i −
    cum_j) is masked to −inf above the diagonal BEFORE the exp, so those
    entries are exactly 0 with a zero gradient.  The reference takes the
    exp over the whole block and masks after: once a chunk's decay span
    passes ~88 the upper triangle overflows to inf and the backward of
    its ``where`` multiplies 0 by inf (NaN gradients at chunk 128).

Everything here is plain PyTorch, as the reference computes it outside
any Pallas kernel.  States and scans are fp32; outputs are cast back to
the input dtype, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.models.attention import _GatherSeq

F32 = torch.float32


# ---------------------------------------------------------------------------
# the inclusive scan h_t = a_t h_{t-1} + b_t
# ---------------------------------------------------------------------------

def _scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive scan of (a, b) along ``dim`` by doubling: after the step
    of offset k every t holds comb over (t - 2k, t]; ``a`` may broadcast
    against ``b`` on every dim but ``dim``."""
    n = b.shape[dim]
    A, h = a, b
    k = 1
    while k < n:
        h = torch.cat([h.narrow(dim, 0, k),
                       h.narrow(dim, k, n - k)
                       + A.narrow(dim, k, n - k) * h.narrow(dim, 0, n - k)],
                      dim=dim)
        if 2 * k < n:
            A = torch.cat([A.narrow(dim, 0, k),
                           A.narrow(dim, k, n - k)
                           * A.narrow(dim, 0, n - k)], dim=dim)
        k *= 2
    return h


def _shift(x: torch.Tensor, dim: int, by: int) -> torch.Tensor:
    """``x`` moved ``by`` places along ``dim`` (+1: x_{t-1} at t, -1:
    x_{t+1} at t), zeros where nothing moves in."""
    n = x.shape[dim]
    z = x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])
    if by > 0:
        return torch.cat([z, x.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([x.narrow(dim, 1, n - 1), z], dim=dim)


class _LinearScan(torch.autograd.Function):
    """h_t = a_t · h_{t-1} + b_t along ``dim`` from h_{-1} = 0."""

    @staticmethod
    def forward(ctx, a, b, dim):
        h = _scan(a, b, dim)
        ctx.dim = dim
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        dim = ctx.dim
        # g_b,t = g_t + a_{t+1} g_b,t+1: the same scan, run backwards
        gb = _scan(_shift(a, dim, -1).flip(dim), g.flip(dim), dim).flip(dim)
        ga = (gb * _shift(h, dim, 1)).sum_to_size(a.shape)
        return ga, gb, None


# ---------------------------------------------------------------------------
# cross-shard prefix for diagonal linear recurrences
# ---------------------------------------------------------------------------

def _sharded(seq_axes: Sequence[str], seq_group: Any) -> bool:
    return bool(seq_axes) and cl.world_size(seq_group) > 1


def _gather_stack(x: torch.Tensor, group: Any) -> torch.Tensor:
    """(B, ...) of every rank of ``group`` -> (B, n, ...) in rank order."""
    return _GatherSeq.apply(x.unsqueeze(1).contiguous(), group)


def shard_prefix_state(decay_total: torch.Tensor, state_final: torch.Tensor,
                       seq_axes: Sequence[str] = (),
                       seq_group: Any = None) -> torch.Tensor:
    """Incoming state of this rank's shard: h_in = Σ_{r<me} (Π_{r<t<me}
    decay_t) state_r, from every rank's ``decay_total`` (the product of
    its shard's decays; (B, ...) broadcasting against the state) and
    ``state_final`` (its final state from a zero state)."""
    if not _sharded(seq_axes, seq_group):
        return torch.zeros_like(state_final)
    d = _gather_stack(decay_total, seq_group)
    s = _gather_stack(state_final, seq_group)
    # h_in(0) = 0; h_in(k) = d_{k-1} h_in(k-1) + s_{k-1}
    h_all = [torch.zeros_like(state_final)]
    for k in range(1, d.shape[1]):
        h_all.append(d[:, k - 1] * h_all[k - 1] + s[:, k - 1])
    return torch.stack(h_all)[cl.flat_rank(seq_group)]


def gather_conv_halo(x: torch.Tensor, taps: int,
                     seq_axes: Sequence[str] = (),
                     seq_group: Any = None) -> torch.Tensor:
    """History (B, taps, C) of a causal conv over this rank's shard x (B,
    S, C): the previous shard's last ``taps`` inputs, zeros on the first
    shard (and unsharded)."""
    B, S, C = x.shape
    if not _sharded(seq_axes, seq_group):
        return x.new_zeros((B, taps, C))
    t = _GatherSeq.apply(x[:, S - taps:, :].contiguous(), seq_group)
    rank = cl.flat_rank(seq_group)
    prev = max(rank - 1, 0)
    halo = t[:, prev * taps:(prev + 1) * taps]
    return torch.where(torch.tensor(rank > 0, device=x.device), halo,
                       torch.zeros_like(halo))


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None,
             seq_axes: Sequence[str] = (), seq_group: Any = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (arXiv:2405.21060 §6): returns (y, final state).

    y_t = C_t · h_t,  h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t, with x
    (B, S, nh, hp), dt (B, S, nh) (softplus'd, > 0), A (nh,) (< 0), Bm and
    Cm (B, S, G, N), h0 (B, nh, N, hp) the state carried in.  Within a
    chunk the quadratic (attention-like) form, across chunks the state
    recurrence (:class:`_LinearScan` over the chunks)."""
    Bsz, S, nh, hp = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not tile S={S}")
    nc, Q, hg = S // chunk, chunk, nh // G
    xc = x.reshape(Bsz, nc, Q, G, hg, hp).to(F32)
    dtc = dt.reshape(Bsz, nc, Q, nh).to(F32)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).to(F32)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).to(F32)

    cum = torch.cumsum(dtc * A.to(F32), dim=2)         # (B, nc, Q, nh) <= 0
    cum_last = cum[:, :, -1]                           # (B, nc, nh)

    # ---- intra-chunk: M[h, i, j] = C_i·B_j exp(cum_i - cum_j) dt_j, j <= i
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)    # (B, nc, G, Q, Q)
    cumT = cum.transpose(2, 3)                         # (B, nc, nh, Q)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = torch.exp((cumT[..., :, None] - cumT[..., None, :])
                    .masked_fill(~tri, float("-inf")))
    M = (seg.reshape(Bsz, nc, G, hg, Q, Q) * CB[:, :, :, None]
         * dtc.transpose(2, 3).reshape(Bsz, nc, G, hg, 1, Q))
    y_intra = torch.einsum("bcgrij,bcjgrp->bcigrp", M, xc)

    # ---- each chunk's state from a zero start: S_c = Σ_j w_j B_j ⊗ x_j
    w = torch.exp(cum_last[:, :, None] - cum) * dtc    # (B, nc, Q, nh)
    wx = w.reshape(Bsz, nc, Q, G, hg, 1) * xc
    S_state = torch.einsum("bcjgn,bcjgrp->bcgrnp", Bc, wx).reshape(
        Bsz, nc, nh, N, hp)

    # ---- inter-chunk recurrence over the chunks
    s_acc = _LinearScan.apply(torch.exp(cum_last)[..., None, None], S_state,
                              1)
    h_in = _shift(s_acc, 1, 1)          # the state entering each chunk
    state_dev = s_acc[:, -1]                           # (B, nh, N, hp)

    # ---- cross-shard / carried-in state
    h0_in = None
    if _sharded(seq_axes, seq_group) or h0 is not None:
        log_d = torch.cumsum(cum_last, dim=1)          # (B, nc, nh)
        decay_dev = torch.exp(log_d[:, -1])            # (B, nh)
        h0_in = shard_prefix_state(decay_dev[..., None, None], state_dev,
                                   seq_axes, seq_group)
        if h0 is not None:
            h0_in = h0_in + (_total_prefix_decay(decay_dev, seq_axes,
                                                 seq_group)[..., None, None]
                             * h0.to(F32))
        d_prefix = torch.exp(_shift(log_d, 1, 1))      # (B, nc, nh)
        h_in = h_in + d_prefix[..., None, None] * h0_in[:, None]

    # ---- inter-chunk output: C_i exp(cum_i) · h_in
    y_inter = torch.einsum("bcign,bcgrnp->bcigrp", Cc,
                           h_in.reshape(Bsz, nc, G, hg, N, hp))
    y_inter = y_inter * torch.exp(cum).reshape(Bsz, nc, Q, G, hg, 1)

    y = (y_intra + y_inter).reshape(Bsz, S, nh, hp)
    h_final = state_dev if h0_in is None \
        else decay_dev[..., None, None] * h0_in + state_dev
    return y.to(x.dtype), h_final


def _total_prefix_decay(decay_dev: torch.Tensor, seq_axes: Sequence[str] = (),
                        seq_group: Any = None) -> torch.Tensor:
    """Product of the decays over every shard strictly before this one."""
    if not _sharded(seq_axes, seq_group):
        return torch.ones_like(decay_dev)
    d = _gather_stack(decay_dev, seq_group)            # (B, n, ...)
    cum = torch.cumprod(d, dim=1)
    prefix = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    return prefix[:, cl.flat_rank(seq_group)]


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the SSD recurrence: x (B, nh, hp), dt (B, nh),
    Bm/Cm (B, G, N), h (B, nh, N, hp) fp32 -> (y (B, nh, hp), h_new)."""
    G = Bm.shape[1]
    hg = x.shape[1] // G
    dt32 = dt.to(F32)
    decay = torch.exp(dt32 * A.to(F32)[None])                   # (B, nh)
    Bh = torch.repeat_interleave(Bm, hg, dim=1).to(F32)         # (B, nh, N)
    Ch = torch.repeat_interleave(Cm, hg, dim=1).to(F32)
    upd = dt32[..., None, None] * Bh[..., None] * x.to(F32)[:, :, None, :]
    h_new = decay[..., None, None] * h + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def _rglru_terms(x, r, i, log_a) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(log a_t, a_t, b_t) of the RG-LRU: a_t = exp(log_a · r_t), b_t =
    sqrt(1 - a_t²) (i_t ⊙ x_t), in fp32."""
    log_at = log_a.to(F32) * r.to(F32)
    a = torch.exp(log_at)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), 0.0, 1.0)) \
        * (i.to(F32) * x.to(F32))
    return log_at, a, b


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_a: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
               seq_axes: Sequence[str] = (), seq_group: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i_t ⊙ x_t), a_t = exp(log_a ·
    r_t): x, r, i (B, S, D) (the post-conv activations and the gates in
    (0, 1)), log_a (D,) (<= 0), h0 (B, D).  Returns (every h_t in x's
    dtype, the final state in fp32)."""
    log_at, a, b = _rglru_terms(x, r, i, log_a)
    h = _LinearScan.apply(a, b, 1)                     # (B, S, D)
    h_final = h[:, -1]
    if _sharded(seq_axes, seq_group) or h0 is not None:
        a_acc = torch.exp(torch.cumsum(log_at, dim=1))  # Π_{s<=t} a_s
        decay_dev, state_dev = a_acc[:, -1], h[:, -1]
        h_in = shard_prefix_state(decay_dev, state_dev, seq_axes, seq_group)
        if h0 is not None:
            h_in = h_in + _total_prefix_decay(decay_dev, seq_axes,
                                              seq_group) * h0.to(F32)
        h = h + a_acc * h_in[:, None]
        h_final = decay_dev * h_in + state_dev
    return h.to(x.dtype), h_final


def rglru_step(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_a: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x, r, i (B, D); h (B, D) fp32 -> (y, h_new)."""
    _, a, b = _rglru_terms(x, r, i, log_a)
    h_new = a * h + b
    return h_new.to(x.dtype), h_new
