"""The training layer loop of the ZeRO++ engine, with the prefetch ring.

Port of the reference's ``core/schedule.py`` ``zero_apply_scan``.  At
``k = ZeroConfig.effective_prefetch(n) = 0`` (``prefetch=0``, local mode,
one layer) it is the synchronous schedule, a loop of per-layer
``zero_apply``: layer i's group is gathered, applied and, in the
backward pass, re-gathered and reduced right around its own compute.  At
k >= 1 it runs the reference's depth-k ring (its ``_prefetched`` custom
VJP) as one ``torch.autograd.Function`` over the whole stack:

  forward  : layer i+k's gather is issued before layer i's compute is
             enqueued, and waited for only when layer i+k needs it; each
             layer keeps its input and the hpZ secondary slice (or its
             primary shard), as ``zero_apply`` does;
  backward : in reverse, layer i-k's re-gather (hpZ, or the forward
             gather again) is issued before layer i's recompute and VJP;
             layer i's gradient reduce starts as soon as its VJP is
             enqueued, and each later hop of it (qgZ's second all-to-all,
             then its last reduce) runs k layers further down, after the
             VJP it was in flight under.

A collective on the card's tensors waits for the stream up to where it
was issued, so each one is issued before the compute it should hide
under is enqueued, and waited for after: nothing in between synchronizes
with the device.  The ring issues the same collectives on the same values
as the synchronous loop (only their places in time move), so its losses
and gradients equal the synchronous ones bit for bit at every depth.
Unlike the reference's scan it issues no wrap-around gathers and reduces
no zero gradients: the kernel launches per step are the synchronous
loop's.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.core import collectives as cl
from repro_torch.core.zeropp import (ZeroConfig, bwd_gather_hops,
                                     fwd_gather_hops, grad_reduce_hops, ring,
                                     saved_for_bwd, zero_apply)


class _Ring(torch.autograd.Function):
    """The depth-k ring over n layers (distributed, k >= 1).  Inputs: f, z,
    k, n, h0, the n primary shards, then the broadcast args; output: the
    last layer's h."""

    @staticmethod
    def forward(ctx, f, z, k, n, h0, *rest):
        shards, bargs = rest[:n], rest[n:]
        h, h_ins, saved = h0, [], []
        for i, W in enumerate(ring(shards, lambda p: fwd_gather_hops(p, z),
                                   k)):
            h_ins.append(h)
            h = f(W, h, *bargs)
            saved.append(saved_for_bwd(W, shards[i], z))
            del W
        ctx.f, ctx.z, ctx.k, ctx.n = f, z, k, n
        ctx.save_for_backward(*saved, *h_ins, *bargs)
        return h

    @staticmethod
    def backward(ctx, g_h):
        f, z, k, n = ctx.f, ctx.z, ctx.k, ctx.n
        saved = ctx.saved_tensors
        res, h_ins, bargs = saved[:n], saved[n:2 * n], saved[2 * n:]
        want_h = ctx.needs_input_grad[4]
        want_b = [ctx.needs_input_grad[5 + n + j] and b.is_floating_point()
                  for j, b in enumerate(bargs)]
        dbargs: List = [None] * len(bargs)
        dshards: List = [None] * n
        reduces: list = []          # [layer, hops, due iteration]
        gathers = ring(res[::-1], lambda r: bwd_gather_hops(r, z), k)
        for i, W in zip(range(n - 1, -1, -1), gathers):
            W = W.detach().requires_grad_(True)
            h = h_ins[i].detach().requires_grad_(i > 0 or want_h)
            bs = [b.detach().requires_grad_(w) for b, w in zip(bargs, want_b)]
            with torch.enable_grad():
                out = f(W, h, *bs)
            want = [W, h] + [b for b in bs if b.requires_grad]
            want = [t for t in want if t.requires_grad]
            grads = torch.autograd.grad(out, want, g_h, allow_unused=True)
            dW = grads[0] if grads[0] is not None else torch.zeros_like(W)
            del out, W
            # the hops in flight under this VJP are waited for after it
            for r in reduces:
                if r[2] >= i:
                    red = cl.advance(r[1])
                    if red is None:
                        r[2] -= k
                    else:
                        dshards[r[0]], r[1] = red, None
            reduces = [r for r in reduces if r[1] is not None]
            reduces.append([i, cl.begin(grad_reduce_hops(dW.reshape(-1), z)),
                            i - k])
            it = iter(grads[1:])
            g_h = next(it) if h.requires_grad else None
            for j, b in enumerate(bs):
                if b.requires_grad:
                    g = next(it)
                    if g is not None:
                        dbargs[j] = g if dbargs[j] is None else dbargs[j] + g
            del grads, dW
        for r in reduces:                       # oldest first
            dshards[r[0]] = cl.finish(r[1])
        return (None, None, None, None, g_h if want_h else None, *dshards,
                *dbargs)


def zero_apply_scan(f: Callable, z: ZeroConfig) -> Callable:
    """Loop ``f(W_full, h, *bargs) -> h_next`` over stacked per-layer
    primary shards.  Returns ``run(stacked, h0, *bargs) -> h_final``,
    differentiable with respect to every shard, ``h0`` and the float
    ``bargs``; ``stacked`` is an (n, P) tensor or a sequence of n (P,)
    shards (the trainer passes one gradient leaf per layer).  The schedule
    is the depth-k ring, k = ``z.effective_prefetch(n)`` (0: the
    synchronous loop)."""
    ap = zero_apply(f, z)

    def run(stacked: Sequence[torch.Tensor], h0: torch.Tensor, *bargs):
        n = len(stacked)
        k = z.effective_prefetch(n)
        if k < 1:
            h = h0
            for i in range(n):
                h = ap(stacked[i], h, *bargs)
            return h
        return _Ring.apply(f, z, k, n, h0, *stacked, *bargs)
    return run
