"""Fine-grained Mixture-of-Experts (DeepSeekMoE / Qwen3-MoE style).

Port of the reference's ``models/moe.py``: shared experts (always on) and
routed experts with top-k gating, dispatched by sorting (argsort tokens
by expert, capacity-bounded slot buffers) instead of a dense (T, E, C)
one-hot tensor.  Under ZeRO++ the expert weights are ordinary flat
parameter groups, gathered a chunk of experts at a time by the engine
(``core/schedule.py`` ``zero_chunk_scan``); no expert-parallel all-to-all
is needed.

Ties and order follow the reference exactly: top-k is a stable
descending sort (``lax.top_k`` puts the lower index first on a tie; the
order of ``torch.topk``'s ties is not promised), the dispatch sort is
``argsort(stable=True)``, the group starts ``searchsorted`` from the
left, and ``.at[idx].set(..., mode="drop")`` is a buffer with one
overflow row, sliced off.

Every backward sum is deterministic.  The one gather whose rows repeat,
``x[src_tok]`` (each token feeds its ``top_k`` slots), runs through
:func:`gather_pairs`, whose backward sums each token's ``top_k`` slot
gradients in a fixed order instead of scattering them with atomics; every
other gather reads each row at most once (the overflow row's reads carry
no gradient).  So a recompute gives the same bits as the forward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MoEOut(NamedTuple):
    y: torch.Tensor             # (T, d)
    aux_loss: torch.Tensor      # () switch-style load-balance loss
    dropped_frac: torch.Tensor  # () fraction of (token, expert) slots dropped


class Dispatch(NamedTuple):
    """Routing result: the token -> expert-slot assignment (indices only;
    each expert chunk rebuilds its slice of the slot buffer from the token
    activations inside its own gather, so a layer keeps (T, d), not the
    slot buffer).  Pairs are the T·k (token, choice) pairs in expert-sorted
    order."""
    cap: int                    # static slots per expert
    gates: torch.Tensor         # (T, k) fp32 combine weights
    keep: torch.Tensor          # (T*k,) bool  capacity survivors (sorted)
    dest: torch.Tensor          # (T*k,) long  slot index (E*cap = dropped)
    src_tok: torch.Tensor       # (T*k,) long  source token of each pair
    g_sorted: torch.Tensor      # (T*k,) fp32  gate of each sorted pair,
                                # applied INSIDE each expert chunk, so the
                                # router's gradient comes from the chunk's
                                # recompute and the combine is index-only
    inv: torch.Tensor           # (T*k,) long  inverse sort permutation
    aux_loss: torch.Tensor      # ()
    dropped_frac: torch.Tensor  # ()


class _GatherPairs(torch.autograd.Function):
    """``x[src_tok]`` whose backward sums each token's ``top_k`` pair
    gradients in choice order (pair j of token t sits at sorted position
    ``inv[t·k + j]``): no atomics, the same bits every time."""

    @staticmethod
    def forward(ctx, x, src_tok, inv, top_k):
        ctx.save_for_backward(inv)
        ctx.top_k, ctx.T = top_k, x.shape[0]
        return x[src_tok]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        dx = g[inv].reshape(ctx.T, ctx.top_k, -1).sum(dim=1)
        return dx, None, None, None


def gather_pairs(x: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """(T*k, d) rows of ``x`` (T, d) in the dispatch's sorted pair order."""
    return _GatherPairs.apply(x, disp.src_tok, disp.inv,
                              disp.gates.shape[1])


def route_topk(logits: torch.Tensor, top_k: int, norm_topk: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k routing (DeepSeek / Qwen convention).  Returns
    (gates (T, k) fp32, expert_idx (T, k) long); on a tie the lower expert
    index comes first, as ``lax.top_k`` orders it."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], idx[:, :top_k]
    if norm_topk:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, idx


def serve_capacity(T: int, top_k: int, E: int, cf: float = 2.0) -> int:
    """Inference capacity: exact (drop-free) for small token counts
    (decode), generously padded for prefill; a prefill's is set by its own
    length."""
    stat = -(-int(T * top_k * cf) // E)
    return int(min(T * top_k, max(stat, 8 * top_k)))


def moe_dispatch(x: torch.Tensor, logits: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25, norm_topk: bool = True,
                 capacity: Optional[int] = None) -> Dispatch:
    """Route tokens ``x`` (T, d) by router ``logits`` (T, E) into
    capacity-bounded per-expert slots."""
    T = x.shape[0]
    E = logits.shape[-1]
    dev = logits.device
    gates, eidx = route_topk(logits, top_k, norm_topk)

    # load-balance aux loss (Switch eq. 4)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)                            # mean router prob
    onehot = F.one_hot(eidx, E).to(torch.float32)     # (T, k, E)
    ce = onehot.sum(dim=1).mean(dim=0) / top_k        # token share
    aux = E * torch.sum(me * ce)

    # sort-based dispatch
    cap = capacity if capacity is not None \
        else int(max(1, (T * top_k * capacity_factor) // E))
    e_flat = eidx.reshape(-1)                         # (T*k,)
    tok_of = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    group_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    slot = torch.arange(T * top_k, device=dev) - group_start[e_sorted]
    keep = slot < cap
    dest = torch.where(keep, e_sorted * cap + slot,
                       torch.full_like(slot, E * cap))
    dropped = 1.0 - keep.to(torch.float32).mean()
    inv = torch.argsort(order)
    return Dispatch(cap, gates, keep, dest, tok_of[order],
                    gates.reshape(-1)[order], inv, aux, dropped)


def _chunk_index(dest: torch.Tensor, chunk_start_slot: int,
                 chunk_slots: int) -> torch.Tensor:
    """Each pair's slot within one chunk; ``chunk_slots`` (the overflow
    row) for pairs outside it."""
    local = dest - chunk_start_slot
    in_chunk = (local >= 0) & (local < chunk_slots)
    return torch.where(in_chunk, local, torch.full_like(local, chunk_slots))


def build_chunk_buf(x: torch.Tensor, disp: Dispatch, chunk_start_slot: int,
                    chunk_slots: int) -> torch.Tensor:
    """One expert chunk's slot buffer (chunk_slots, d) from the token
    activations ``x`` (T, d): slot ``dest - chunk_start_slot`` of each
    pair in the chunk holds its token's row, the rest are zeros."""
    idx = _chunk_index(disp.dest, chunk_start_slot, chunk_slots)
    buf = x.new_zeros((chunk_slots + 1, x.shape[-1]))
    buf = buf.index_put((idx,), gather_pairs(x, disp))
    return buf[:chunk_slots]


def build_chunk_gates(g_sorted: torch.Tensor, dest: torch.Tensor,
                      chunk_start_slot: int, chunk_slots: int
                      ) -> torch.Tensor:
    """(chunk_slots,) gate value per slot of one expert chunk."""
    idx = _chunk_index(dest, chunk_start_slot, chunk_slots)
    g = g_sorted.new_zeros((chunk_slots + 1,))
    return g.index_put((idx,), g_sorted)[:chunk_slots]


def expert_ffn(buf: torch.Tensor, w_gate_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Grouped expert GEMMs on a (chunk of the) slot buffer: buf (Ec, cap,
    d), w_gate_up (Ec, d, 2·ff), w_down (Ec, ff, d)."""
    g, u = torch.bmm(buf, w_gate_up).chunk(2, dim=-1)
    return torch.bmm(F.silu(g) * u, w_down)


def moe_combine(out: torch.Tensor, disp: Dispatch,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gather the (already gate-weighted) slot outputs ``out`` (E, cap, d)
    back to their tokens and sum each token's k choices: (T, d)."""
    E, cap, d = out.shape
    T, top_k = disp.gates.shape
    out_flat = torch.cat([out.reshape(E * cap, d), out.new_zeros((1, d))])
    dest = torch.where(disp.keep, disp.dest,
                       torch.full_like(disp.dest, E * cap))
    y_pairs = out_flat[dest][disp.inv].reshape(T, top_k, d)
    y = y_pairs.sum(dim=1)
    return y if out_dtype is None else y.to(out_dtype)


def moe_ffn_chunked(x: torch.Tensor, disp: Dispatch, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor) -> torch.Tensor:
    """Single-shot expert pass via the chunk primitives (all experts as
    one chunk)."""
    E = w_gate_up.shape[0]
    buf = build_chunk_buf(x, disp, 0, E * disp.cap).reshape(E, disp.cap, -1)
    out = expert_ffn(buf, w_gate_up, w_down)
    g = build_chunk_gates(disp.g_sorted, disp.dest, 0,
                          E * disp.cap).reshape(E, disp.cap, 1)
    return moe_combine(out * g.to(out.dtype), disp)


def shared_ffn(x: torch.Tensor, shared_gate_up: torch.Tensor,
               shared_down: torch.Tensor) -> torch.Tensor:
    """Always-on shared experts (DeepSeekMoE)."""
    gs, us = (x @ shared_gate_up).chunk(2, dim=-1)
    return (F.silu(gs) * us) @ shared_down


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate_up: torch.Tensor,
            w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, norm_topk: bool = True,
            shared_gate_up: Optional[torch.Tensor] = None,
            shared_down: Optional[torch.Tensor] = None) -> MoEOut:
    """Single-shot token-choice top-k MoE (dispatch, every expert,
    combine): the reference composition of the pieces above; the Model
    runs the chunked path so that expert gathers stay bounded."""
    logits = x @ router_w
    disp = moe_dispatch(x, logits, top_k=top_k,
                        capacity_factor=capacity_factor, norm_topk=norm_topk)
    y = moe_ffn_chunked(x, disp, w_gate_up, w_down)
    if shared_gate_up is not None:
        y = y + shared_ffn(x, shared_gate_up, shared_down)
    return MoEOut(y.to(x.dtype), disp.aux_loss, disp.dropped_frac)
