"""The training layer loop of the ZeRO++ engine, with the prefetch ring,
and the MoE expert-chunk pipeline.

Port of the reference's ``core/schedule.py``: ``zero_apply_scan`` and the
carry-less chunk pipeline (``zero_chunk_scan``, ``zero_chunk_scan_hpz``,
``zero_chunk_scan_inference``).  At ``k = ZeroConfig.effective_prefetch(n)
= 0`` (``prefetch=0``, local mode, one step) a loop is the synchronous
schedule, a loop of per-step ``zero_apply``: step i's group is gathered,
applied and, in the backward pass, re-gathered and reduced right around
its own compute.  At k >= 1 it runs the reference's depth-k ring (its
``_prefetched`` custom VJP) as one ``torch.autograd.Function`` over the
whole stack:

  forward  : step i+k's gather is issued before step i's compute is
             enqueued, and waited for only when step i+k needs it; each
             step keeps its input and the hpZ secondary slice (or its
             primary shard), as ``zero_apply`` does;
  backward : in reverse, step i-k's re-gather (hpZ, or the forward
             gather again) is issued before step i's recompute and VJP;
             step i's gradient reduce starts as soon as its VJP is
             enqueued, and each later hop of it (qgZ's second all-to-all,
             then its last reduce) runs k steps further down, after the
             VJP it was in flight under.  Two places differ at the end of
             the loop: step 0's reduce begins after the loop (the
             reference's epilogue; nothing runs in between), and in the
             last iteration a reduce with more than one hop left advances
             after the recompute, so its last hop flies under the last VJP
             instead of after the loop.  At k = 0 (the chunk ring under
             hpZ) each reduce runs to its end right after its VJP.

A collective on the card's tensors waits for the stream up to where it
was issued, so each one is issued before the compute it should hide
under is enqueued, and waited for after: nothing in between synchronizes
with the device.  The ring issues the same collectives on the same values
as the synchronous loop (only their places in time move), so its losses
and gradients equal the synchronous ones bit for bit at every depth.
Unlike the reference's scan it issues no wrap-around gathers and reduces
no zero gradients: the kernel launches per step are the synchronous
loop's.

MoE stacks use the machinery at two granularities.  The layer ring
carries each layer's expert-chunk shards as per-layer inputs ``xs`` (each
layer's chunk pipeline returns their reduced gradients, which the ring
returns as theirs) and the aux loss as per-layer outputs ``ys``; inside
each layer :func:`zero_chunk_scan` runs the chunk ring.  Two knobs, as in
the reference:

  * ``spec`` (routing-ahead dispatch): the layer ring gathers layer
    i+k's first expert chunk beside its group, and the layer's chunk
    ring starts from it (``W0``) instead of gathering chunk 0 after the
    router; ``bwd_spec`` is its mirror in the reverse ring (chunk 0's
    secondary re-gathered k layers ahead);
  * ``f_fwd`` / ``f_bwd`` (the hpZ nested recompute): the forward keeps
    each chunk's secondary slice (``zero_chunk_scan(collect_secondary)``,
    no communication) and the backward's recompute replays the chunk
    pipeline from them on the hpZ tier (:func:`zero_chunk_scan_hpz`)
    instead of gathering every chunk again on the qwZ tier.

Both move collectives, not values: every depth, with and without hpZ,
gives the same bits as the synchronous loop.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core import collectives as cl
from repro_torch.core.zeropp import (ZeroConfig, bwd_gather_hops,
                                     fwd_gather_hops, grad_reduce_hop_count,
                                     grad_reduce_hops, ring,
                                     saved_for_bwd, together, zero_apply,
                                     zero_scan_inference)


def _tensors(x) -> tuple:
    """The tensors of a per-step input: a tuple/list of them, else none."""
    if isinstance(x, (tuple, list)) and all(torch.is_tensor(t) for t in x):
        return tuple(x)
    return ()


class _Plan:
    """What one ring call needs besides its tensors.  ``f(W, h, x, *bargs)
    -> (h, y)`` (y None: no per-step output); ``xs`` the per-step inputs
    that are not tensors (a chunk index), or None when each step's input
    is a tuple of ``m`` tensors passed to the Function; ``carry``: h is a
    real carry (False: a dummy, the chunk pipeline's); ``fwd_src``: the
    forward gathers' sources when they are not the primary shards (the
    hpZ replay's secondary stack, hpZ-gathered and kept as the backward's
    sources); ``collect``: also return each step's secondary slice;
    ``name``: the loop's name for a step recorder ("layers" or "chunks":
    the forward ring ``<name>.fwd``, the reverse ring ``<name>.bwd``);
    ``bwd_ahead``: the backward follows the forward at once (a chunk ring
    in a recompute), so the forward begins its first re-gather."""

    def __init__(self, f, z, k, n, *, m=0, xs=None, nb=0, carry=True,
                 ys=False, has_w0=False, f_fwd=None, f_bwd=None, spec=None,
                 bwd_spec=None, fwd_src=None, collect=False,
                 name="layers", bwd_ahead=False):
        self.f, self.z, self.k, self.n = f, z, k, n
        self.name, self.bwd_ahead = name, bwd_ahead
        self.m, self.xs, self.nb = m, xs, nb
        self.carry, self.ys, self.has_w0 = carry, ys, has_w0
        self.f_fwd, self.f_bwd = f_fwd, f_bwd
        self.spec, self.bwd_spec = spec, bwd_spec
        self.fwd_src, self.collect = fwd_src, collect

    def step_xs(self, xt: Sequence[torch.Tensor]) -> List[Any]:
        if self.m:
            return [tuple(xt[i * self.m:(i + 1) * self.m])
                    for i in range(self.n)]
        return list(self.xs) if self.xs is not None else [None] * self.n

    def start(self, shards, xs):
        """The forward's collective for step i (with the speculative one
        beside it)."""
        z = self.z
        if self.fwd_src is not None:
            src = self.fwd_src
            gather = lambda i: cl.hpz_all_gather_hops(src[i], z.hpz_group)
        else:
            gather = lambda i: fwd_gather_hops(shards[i], z)
        if self.spec is None:
            return gather
        return lambda i: together(gather(i),
                                  fwd_gather_hops(self.spec(xs, i), z))


# The hand-over lists of the rings whose backward is running, innermost
# last: a nested ring (the chunk ring inside a layer's VJP) hands the
# reduces it still has in flight at its end to the ring around it, which
# waits for them under its own later compute.
_ADOPT: List[list] = []


class _Ring(torch.autograd.Function):
    """The depth-k ring over n steps (distributed).  Inputs: the plan, h0,
    the n primary shards, the n·m per-step input tensors, the broadcast
    args, then W0 where the plan has one; outputs: the last h (a real
    carry only), the n per-step outputs (``plan.ys``), the n secondary
    slices (``plan.collect``, not differentiable).

    With ``plan.bwd_ahead`` (a chunk ring built where its backward follows
    at once: a recompute) the forward begins the backward's first
    re-gather beside its last step's compute.  A ring whose backward runs
    inside another's (``_ADOPT``) ends by handing its reduces still in
    flight to that one instead of draining them: their gradients come
    back as zeros here, and the outer ring adds their results to what
    autograd gives its step inputs."""

    @staticmethod
    def forward(ctx, plan, h0, *rest):
        n, m, z = plan.n, plan.m, plan.z
        shards = rest[:n]
        xt = rest[n:n + n * m]
        bargs = rest[n + n * m:n + n * m + plan.nb]
        W0 = rest[-1] if plan.has_w0 else None
        xs = plan.step_xs(xt)
        h, h_ins, saved, ys, auxs = h0, [], [], [], []
        ctx.ahead = None
        for i, W in enumerate(ring(range(n), plan.start(shards, xs), plan.k,
                                   W0, name=plan.name + ".fwd")):
            Ws = None
            if plan.spec is not None:
                W, Ws = W
            h_ins.append(h)
            saved.append(plan.fwd_src[i] if plan.fwd_src is not None
                         else saved_for_bwd(W, shards[i], z))
            if plan.bwd_ahead and plan.k >= 1 and i == n - 1:
                ctx.ahead = cl.begin(bwd_gather_hops(saved[-1], z))
            if plan.f_fwd is not None:
                h, y, aux = plan.f_fwd(W, Ws, h, xs[i], *bargs)
                auxs.append(tuple(aux or ()))
            else:
                h, y = plan.f(W, h, xs[i], *bargs)
            ys.append(y)
            del W, Ws
        ctx.plan, ctx.na = plan, len(auxs[0]) if auxs else 0
        # the shards themselves, for a hand-over (weakly: the caller holds
        # them while the backward runs)
        ctx.shards = [weakref.ref(t) for t in shards]
        ctx.save_for_backward(*saved, *h_ins, *xt,
                              *[a for aux in auxs for a in aux], *bargs)
        out = ((h,) if plan.carry else ()) + (tuple(ys) if plan.ys else ())
        if plan.collect:
            ctx.mark_non_differentiable(*saved)
            out += tuple(saved)
        return out[0] if len(out) == 1 else out

    @staticmethod
    def backward(ctx, *gouts):
        adopted: list = []      # (shard ref, hops, hops left): a nested ring's
        _ADOPT.append(adopted)
        try:
            return _Ring._backward(ctx, adopted, *gouts)
        finally:
            _ADOPT.pop()

    @staticmethod
    def _backward(ctx, adopted, *gouts):
        plan, na = ctx.plan, ctx.na
        z, k, n, m, nb = plan.z, plan.k, plan.n, plan.m, plan.nb
        g_h = gouts[0] if plan.carry else None
        g_ys = gouts[int(plan.carry):int(plan.carry) + n] if plan.ys \
            else [None] * n
        saved = ctx.saved_tensors
        res, h_ins = saved[:n], saved[n:2 * n]
        xt = saved[2 * n:2 * n + n * m]
        aux_flat = saved[2 * n + n * m:2 * n + n * m + n * na]
        bargs = saved[2 * n + n * m + n * na:]
        auxs = [tuple(aux_flat[i * na:(i + 1) * na]) for i in range(n)]
        needs = ctx.needs_input_grad
        want_h = plan.carry and needs[1]
        want_x = [needs[2 + n + j] and t.is_floating_point()
                  for j, t in enumerate(xt)]
        want_b = [needs[2 + n + n * m + j] and b.is_floating_point()
                  for j, b in enumerate(bargs)]
        dbargs: List = [None] * nb
        dxt: List = [None] * (n * m)
        dshards: List = [None] * n
        # [where the result goes: a step (its shard) or ("x", j) (input
        # tensor j: a nested ring's reduce, added to its gradient), hops,
        # due iteration, hops left]
        reduces: list = []
        hops_per_reduce = grad_reduce_hop_count(z)

        def advance(r):
            red = cl.advance(r[1])
            r[3] -= 1
            if red is None:
                return
            r[1] = None
            if isinstance(r[0], int):
                dshards[r[0]] = red
            else:
                j = r[0][1]
                red = red.to(xt[j].dtype)
                dxt[j] = red if dxt[j] is None else dxt[j] + red

        def advance_due(i):
            for r in reduces:
                if r[1] is not None and r[2] >= i:
                    advance(r)
                    r[2] -= k
            return [r for r in reduces if r[1] is not None]

        if plan.bwd_spec is None:
            def start(i):
                return bwd_gather_hops(res[i], z)
        else:
            def start(i):
                return together(bwd_gather_hops(res[i], z),
                                bwd_gather_hops(plan.bwd_spec(auxs, i), z))
        xs_static = plan.step_xs(())
        last = None                 # step 0's reduce: the epilogue's
        # the ring first: it runs out (its loop closes) as this loop ends
        for W, i in zip(ring(range(n - 1, -1, -1), start, k,
                             name=plan.name + ".bwd", ahead=ctx.ahead),
                        range(n - 1, -1, -1)):
            W0 = None
            if plan.bwd_spec is not None:
                W, W0 = W
            W = W.detach().requires_grad_(True)
            h = h_ins[i].detach().requires_grad_(i > 0 or want_h) \
                if plan.carry else None
            xi = [xt[i * m + j].detach().requires_grad_(want_x[i * m + j])
                  for j in range(m)]
            x = tuple(xi) if m else xs_static[i]
            bs = [b.detach().requires_grad_(w) for b, w in zip(bargs, want_b)]
            with torch.enable_grad():
                if plan.f_bwd is not None:
                    kw = {} if plan.bwd_spec is None else {"W0": W0}
                    h2, y = plan.f_bwd(W, h, x, auxs[i], *bs, **kw)
                else:
                    h2, y = plan.f(W, h, x, *bs)
            if i == 0:
                # the tail: a reduce with hops after this one would wait
                # for its last after the loop, under nothing; it advances
                # now, and its last hop flies under the last VJP
                for r in reduces:
                    if r[1] is not None and r[3] > 1:
                        advance(r)
                        r[2] = -1               # waited after the loop
            outs, gs = [], []
            for o, g in ((h2, g_h), (y, g_ys[i])):
                if torch.is_tensor(o) and o.requires_grad and g is not None:
                    outs.append(o)
                    gs.append(g)
            want = [t for t in [W, h] + xi + bs
                    if t is not None and t.requires_grad]
            grads = torch.autograd.grad(outs, want, gs, allow_unused=True) \
                if outs else [None] * len(want)
            got = dict(zip(map(id, want), grads))
            dW = got[id(W)] if got[id(W)] is not None else torch.zeros_like(W)
            del outs, h2, y, W, W0
            # the hops in flight under this VJP are waited for after it
            reduces = advance_due(i)
            if k < 1:                           # synchronous: reduce now
                dshards[i] = cl.finish(grad_reduce_hops(dW.reshape(-1), z))
            elif i > 0:
                reduces.append([i, cl.begin(grad_reduce_hops(dW.reshape(-1),
                                                             z)),
                                i - k, hops_per_reduce])
            else:
                last = grad_reduce_hops(dW.reshape(-1), z)
            g_h = got.get(id(h)) if plan.carry and h.requires_grad else None
            for j, t in enumerate(xi):
                if t.requires_grad:
                    dxt[i * m + j] = got[id(t)]
            for j, b in enumerate(bs):
                g = got.get(id(b)) if b.requires_grad else None
                if g is not None:
                    dbargs[j] = g if dbargs[j] is None else dbargs[j] + g
            for ref, hops, left in adopted:     # a nested ring's reduces
                j = next((j for j, t in enumerate(xi) if t is ref()), None)
                if j is None:
                    raise RuntimeError("a nested ring handed over the "
                                       "reduce of a tensor that is not "
                                       "this step's input")
                reduces.append([("x", i * m + j), hops, i - k, left])
            adopted.clear()
            del grads, got, dW, xi
        if last is not None:                    # the epilogue
            reduces.append([0, cl.begin(last), None, hops_per_reduce])
        outer = _ADOPT[-2] if len(_ADOPT) > 1 else None
        if outer is not None:
            for r in reduces:
                if isinstance(r[0], int):       # the outer ring waits
                    shard = ctx.shards[r[0]]()
                    if shard is None:
                        raise RuntimeError("a reduce handed over for a "
                                           "shard no longer alive")
                    outer.append((ctx.shards[r[0]], r[1], r[3]))
                    dshards[r[0]] = torch.zeros_like(shard)
                    r[1] = None
        for r in reduces:                       # oldest first
            while r[1] is not None:
                advance(r)
        return (None, g_h if want_h else None, *dshards, *dxt, *dbargs,
                *((None,) if plan.has_w0 else ()))


def zero_apply_scan(f: Callable, z: ZeroConfig, *,
                    f_fwd: Optional[Callable] = None,
                    f_bwd: Optional[Callable] = None,
                    spec: Optional[Callable] = None,
                    bwd_spec: Optional[Callable] = None) -> Callable:
    """Loop ``f`` over stacked per-step primary shards, ZeRO++ style.

    Returns ``run(stacked, h0, *bargs, xs=None, W0=None)``; ``stacked`` is
    an (n, P) tensor or a sequence of n (P,) shards (the trainer passes
    one gradient leaf per layer).  Without ``xs``, ``f(W_full, h, *bargs)
    -> h_next`` and ``run`` returns the last h.  With ``xs`` (the
    reference's signature: a sequence of n per-step inputs, each a tuple
    of tensors, e.g. a layer's expert-chunk shards, or any other object),
    ``f(W_full, h, x, *bargs) -> (h_next, y)`` and ``run`` returns (h,
    [y_0, …, y_{n-1}]).  Differentiable with respect to every shard,
    ``h0``, the float tensors of ``xs`` and the float ``bargs``; ``f`` is
    recomputed in the backward pass (activation checkpointing), and the
    gradients the recompute gives a step's ``xs`` tensors (the reduced
    gradients of its nested chunk pipeline) are theirs.  The schedule is
    the depth-k ring, k = ``z.effective_prefetch(n)`` (0: the synchronous
    loop).  ``W0`` is step 0's group already gathered (the ring does not
    gather it).

    The knobs (ring only; the synchronous loop always runs ``f``), as the
    reference's: ``spec(xs, i) -> shard`` a speculative gather source (the
    ring gathers ``spec(xs, i+k)`` beside step i+k's group);
    ``f_fwd(W, W_spec, h, x, *bargs) -> (h, y, aux)`` the forward body
    (``aux`` a tuple of tensors kept for the backward); ``f_bwd(W, h, x,
    aux, *bargs[, W0=]) -> (h, y)`` the recompute body, given with
    ``bwd_spec(auxs, i) -> secondary shard`` the reverse ring's
    speculative buffer as ``W0``.  Each must give ``f``'s values."""
    if (spec is not None or f_bwd is not None) and f_fwd is None:
        raise ValueError("zero_apply_scan: spec/f_bwd require f_fwd")
    if bwd_spec is not None and f_bwd is None:
        raise ValueError("zero_apply_scan: bwd_spec requires f_bwd")
    ap = zero_apply(f, z)

    def run_dense(stacked, h0, *bargs):
        n = len(stacked)
        k = z.effective_prefetch(n)
        if k < 1:
            h = h0
            for i in range(n):
                h = ap(stacked[i], h, *bargs)
            return h
        plan = _Plan(lambda W, h, x, *b: (f(W, h, *b), None), z, k, n,
                     nb=len(bargs))
        return _Ring.apply(plan, h0, *stacked, *bargs)

    def run(stacked, h0, *bargs, xs=None, W0=None):
        if xs is None and W0 is None:
            return run_dense(stacked, h0, *bargs)
        n = len(stacked)
        k = z.effective_prefetch(n)
        xs = list(xs) if xs is not None else [None] * n
        m = len(_tensors(xs[0]))
        if k < 1:
            h, ys = h0, []
            for i in range(n):
                def fi(W, h, *rest, _x=xs[i]):
                    x = tuple(rest[:m]) if m else _x
                    return f(W, h, x, *rest[m:])
                h, y = zero_apply(fi, z)(stacked[i], h, *_tensors(xs[i]),
                                         *bargs)
                ys.append(y)
            return h, ys
        plan = _Plan(f, z, k, n, m=m, xs=None if m else xs, nb=len(bargs),
                     ys=True, has_w0=W0 is not None, f_fwd=f_fwd,
                     f_bwd=f_bwd, spec=spec, bwd_spec=bwd_spec)
        xt = [t for x in xs for t in _tensors(x)]
        out = _Ring.apply(plan, h0, *stacked, *xt, *bargs,
                          *(() if W0 is None else (W0,)))
        return out[0], list(out[1:])
    return run


# ---------------------------------------------------------------------------
# the carry-less chunk pipeline (MoE expert chunks)
# ---------------------------------------------------------------------------

def _chunk_ring(f: Callable, z: ZeroConfig, stacked, bargs, W0, *,
                fwd_src=None, collect: bool = False):
    """``f(W, c, *bargs) -> y`` over the chunks c of ``stacked`` through
    the ring Function (no carry).  Returns the list of ys (and the
    secondary slices with ``collect``)."""
    n = len(stacked)
    plan = _Plan(lambda W, h, c, *b: (h, f(W, c, *b)), z,
                 z.effective_prefetch(n), n, xs=range(n), nb=len(bargs),
                 carry=False, ys=True, has_w0=W0 is not None,
                 fwd_src=fwd_src, collect=collect, name="chunks",
                 bwd_ahead=torch.is_grad_enabled())
    out = _Ring.apply(plan, None, *stacked, *bargs,
                      *(() if W0 is None else (W0,)))
    out = (out,) if torch.is_tensor(out) else tuple(out)
    if collect:
        return list(out[:n]), list(out[n:])
    return list(out)


def zero_chunk_scan(f: Callable, z: ZeroConfig, *,
                    collect_secondary: bool = False) -> Callable:
    """Chunked-parameter pipeline: ``f(W_full, c, *bargs) -> y`` over the
    chunks c of stacked per-chunk primary shards with the depth-k ring of
    :func:`zero_apply_scan` (chunk c+k's gather issued under chunk c's
    compute; each chunk's qgZ reduce retired k chunks behind in the
    backward); k = ``z.effective_prefetch(n)``, 0: one ``zero_apply`` a
    chunk.  Chunks are independent (no carry).  Returns ``run(stacked,
    *bargs, W0=None) -> [y_0, …]``, differentiable with respect to every
    chunk shard and the float ``bargs``; ``W0`` is chunk 0 already
    gathered (the routing-ahead buffer; the synchronous schedule gathers
    it itself).  ``collect_secondary`` also returns the chunks' hpZ
    secondary slices (no communication; under distributed hpZ, else None)
    for :func:`zero_chunk_scan_hpz` to replay from."""
    def run(stacked, *bargs, W0: Optional[torch.Tensor] = None):
        n = len(stacked)
        collect = collect_secondary and z.distributed and z.hpz
        if collect or z.effective_prefetch(n) >= 1:
            out = _chunk_ring(f, z, stacked, bargs, W0, collect=collect)
        else:
            out = [zero_apply(lambda W, *b, c=c: f(W, c, *b), z)(
                stacked[c], *bargs) for c in range(n)]
        if not collect_secondary:
            return out
        return out if collect else (out, None)
    return run


def zero_chunk_scan_hpz(f: Callable, z: ZeroConfig) -> Callable:
    """The nested recompute's chunk pipeline, fed from saved secondary
    shards: ``run(stacked, sec, *bargs, W0=None) -> [y_0, …]``, the math of
    :func:`zero_chunk_scan`, but every chunk's full weights rebuilt by an
    hpZ all-gather of ``sec`` (the slices ``zero_chunk_scan(
    collect_secondary=True)`` kept) in the forward and again in the
    backward, instead of the primary qwZ gather.  The hpZ roundtrip
    rebuilds the forward's weights exactly, so the outputs and the
    reduced gradients of ``stacked`` are the primary pipeline's bits; only
    the tier the recompute's bytes ride changes.  ``sec`` takes no
    gradient; ``W0`` is chunk 0 already gathered (the reverse layer ring's
    ``bwd_spec`` slot).  Requires distributed hpZ."""
    if not (z.hpz and z.distributed):
        raise ValueError("zero_chunk_scan_hpz requires distributed hpZ")

    def run(stacked, sec, *bargs, W0: Optional[torch.Tensor] = None):
        return _chunk_ring(f, z, stacked, bargs, W0, fwd_src=list(sec))
    return run


def zero_chunk_scan_inference(f: Callable, z: ZeroConfig) -> Callable:
    """Serving-path :func:`zero_chunk_scan`: the same forward ring, no
    vjp.  ``run(stacked, *bargs, W0=None) -> [y_0, …]``."""
    def run(stacked, *bargs, W0: Optional[torch.Tensor] = None):
        _, ys = zero_scan_inference(
            lambda W, h, c: (h, f(W, c, *bargs)), z, name="chunks")(
            stacked, None, range(len(stacked)), W0=W0)
        return ys
    return run
