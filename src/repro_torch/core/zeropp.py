"""The ZeRO++ engine: gather-compute-reduce as one differentiable primitive.

Port of the reference's ``core/zeropp.py``: ``ZeroConfig``, ``fwd_gather``,
``fwd_gather_quant``, ``qwz_gemm_eligible``, ``grad_reduce``, the training
primitive ``zero_apply`` and the serving ``zero_apply_inference``, plus
the serving layer loop ``zero_scan_inference`` of the reference's
``core/schedule.py``, with its depth-k prefetch ring (:func:`ring`), and
the communication accounting (:func:`comm_volume_per_step`, the paper's
Table 1; :func:`step_wire_by_label`, the per-rank bytes that the
collectives count), with every knob of the reference's ``ZeroConfig``.

``zero_apply`` wraps each layer group's apply function ``f(W_full, *args)``
as a ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``):

  forward  : W = fwd-gather(primary shard)        [qwZ INT8 if enabled]
             out = f(W, *args), without autograd
             saved = (secondary shard of W if hpZ else primary, args)
  backward : W' = hpZ gather of the secondary shard over the secondary
                  group (intra-node unless ``hpz_axes`` widens it)
                  (or the forward gather again when hpZ is off)
             dW, dargs = autograd of f recomputed on W' [activation
                  checkpointing: f runs twice]
             dprimary = qgZ INT4 2-hop all-to-all reduce-scatter
                  (``qgz_bits``, ``qgz_2hop``; or the bf16 reduce-scatter
                  baseline), cast to ``grad_dtype``

The secondary copy is a slice of this iteration's forward gather, so hpZ's
temporal consistency (§3.2.1) holds by construction.  The layer loops run
the reference's depth-k prefetch ring (``ZeroConfig.prefetch``, default
1; ``core/schedule.py`` for training, :func:`zero_scan_inference` for
serving): layer i+k's gather is in flight under layer i's compute.  The
ring issues the same collectives on the same values as the synchronous
schedule (``prefetch=0``), so every depth gives the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.core.partition import alignment
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """Which of the paper's optimizations are active, and on which groups.

    The default is full ZeRO++ (qwZ + hpZ + qgZ); all three off is the
    ZeRO-3 baseline.  ``dp_axes`` names the ZeRO world as the reference's
    mesh axes do; an empty tuple is local (single-device, no collectives)
    mode.  A non-empty ``dp_axes`` is "distributed" even at world 1, where
    the gathers and all-to-alls are identities but every quantize, reduce
    and dequantize still runs — exactly the reference on a one-device
    mesh.  The axis names pick the branch (``inter_axes`` non-empty: qgZ
    takes its two hops) and size the wire accounting; the process groups
    carry the traffic: ``group`` the whole ZeRO world, ``intra_group`` the
    fast tier (``intra_axis``: qgZ's first hop), ``inter_group`` the
    slower tiers (``inter_axes``, one axis or several: qgZ's second hop),
    ``secondary_group`` hpZ's secondary group (``secondary_axes``; None:
    the intra group, which a wider ``hpz_axes`` beyond one rank refuses).
    None is torch.distributed's default group, or a world of 1 when no
    process group is initialised; at world > 1 the caller passes the
    groups (``launch.mesh.Mesh.group``), and :func:`grad_reduce` checks
    that the tiers tile the world.

    The paper's ablation knobs are the reference's: ``qwz_blocked=False``
    (one scale a shard, Fig. 2 / Fig. 14), ``hpz_axes`` (a wider
    secondary group, e.g. ``("data", "model")``: one pod), ``qgz_bits``
    (INT4 or INT8), ``qgz_2hop=False`` (the 1-hop all-to-all of §3.3.2)
    and ``grad_dtype`` (the optimizer-side gradients).
    """

    # qwZ (§3.1)
    qwz: bool = True
    qwz_bits: int = 8
    qwz_block: int = 256
    qwz_blocked: bool = True   # False: the paper's non-blocked ablation
    # serving head: feed the gathered INT8 payload straight to the fused
    # dequant-GEMM where the layout allows (see qwz_gemm_eligible)
    qwz_gemm: bool = True
    # hpZ (§3.2): the secondary partition lives on the intra group, or on
    # the group of ``hpz_axes`` where given (the paper's "multiple compute
    # nodes" secondary group)
    hpz: bool = True
    hpz_axes: Optional[Tuple[str, ...]] = None
    # qgZ (§3.3): INT4 blockwise gradients over the 2-hop all-to-all
    qgz: bool = True
    qgz_bits: int = 4
    qgz_block: int = 256
    qgz_2hop: bool = True      # False: the 1-hop all-to-all (§3.3.2)
    # ZeRO world
    dp_axes: Tuple[str, ...] = ("data", "model")
    intra_axis: str = "model"
    group: Any = None
    intra_group: Any = None
    inter_group: Any = None
    secondary_group: Any = None    # None: the intra group
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    grad_dtype: torch.dtype = torch.float32    # optimizer-side gradients
    reduce_dtype: torch.dtype = torch.bfloat16  # baseline reduce wire dtype
    # layer-loop schedule: 0 = synchronous (each collective on the
    # critical path); k >= 1 = a ring of k gathers in flight, layer i+k's
    # gather issued under layer i's compute, backward gathers mirrored and
    # each qgZ hop retired k layers behind.  Every depth gives the same
    # bits; depths beyond a loop's length clamp (effective_prefetch).
    prefetch: int = 1

    def __post_init__(self):
        if self.prefetch < 0:
            raise ValueError(
                f"ZeroConfig.prefetch must be >= 0 (ring depth), got "
                f"{self.prefetch}")
        if (self.distributed and self.secondary_group is None
                and self.secondary_axes != (self.intra_axis,)
                and cl.world_size(self.group) > 1):
            raise ValueError(
                f"hpz_axes {self.hpz_axes} needs its secondary_group "
                f"(launch.mesh.Mesh.group) beyond one rank: the intra "
                f"group would hold the secondary partition")

    def effective_prefetch(self, n: int) -> int:
        """Usable ring depth for an ``n``-step loop: at most n-1 (a deeper
        ring would gather a layer twice); 0 in local mode and for loops
        of one step."""
        if not self.distributed or n < 2:
            return 0
        return min(self.prefetch, n - 1)

    @property
    def distributed(self) -> bool:
        return bool(self.dp_axes)

    @property
    def inter_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp_axes if a != self.intra_axis)

    @property
    def secondary_axes(self) -> Tuple[str, ...]:
        """hpZ's secondary-partition axes."""
        return self.hpz_axes if self.hpz_axes else (self.intra_axis,)

    @property
    def hpz_group(self) -> Any:
        """The process group of ``secondary_axes`` (see ``__post_init__``)."""
        return (self.secondary_group if self.secondary_group is not None
                else self.intra_group)

    @property
    def qwz_cfg(self) -> QuantConfig:
        return QuantConfig(bits=self.qwz_bits, block_size=self.qwz_block)

    @property
    def qgz_cfg(self) -> QuantConfig:
        return QuantConfig(bits=self.qgz_bits, block_size=self.qgz_block)

    def align(self, world: int) -> int:
        return alignment(world, self.qwz_block, self.qgz_block,
                         2)  # int4 packing needs even blocks

    @classmethod
    def baseline(cls, **kw) -> "ZeroConfig":
        """Plain ZeRO-3 (the paper's baseline)."""
        return cls(qwz=False, hpz=False, qgz=False, **kw)

    @classmethod
    def local(cls, **kw) -> "ZeroConfig":
        """Single-device mode (no collectives, no quantization)."""
        kw.setdefault("dp_axes", ())
        kw.setdefault("intra_axis", "")
        return cls(**kw)


def fwd_gather_hops(primary: torch.Tensor, z: ZeroConfig) -> cl.Hops:
    """Forward weights all-gather over the full ZeRO world, returned in
    ``compute_dtype``: qwZ quantizes whatever it gets; the baseline casts
    to the wire dtype (param_dtype) before gathering.  One hop
    (``collectives.begin`` / ``finish``)."""
    if not z.distributed:
        yield
        return primary.to(z.compute_dtype)
    if z.qwz:
        return (yield from cl.qwz_all_gather_hops(
            primary, z.group, z.qwz_cfg, out_dtype=z.compute_dtype,
            blocked=z.qwz_blocked))
    return (yield from cl.baseline_all_gather_hops(
        primary.to(z.param_dtype), z.group, out_dtype=z.compute_dtype))


def fwd_gather(primary: torch.Tensor, z: ZeroConfig) -> torch.Tensor:
    return cl.finish(fwd_gather_hops(primary, z))


def bwd_gather_hops(res: torch.Tensor, z: ZeroConfig) -> cl.Hops:
    """The backward pass's re-gather of a layer's full weights from what
    its forward saved (:func:`saved_for_bwd`): hpZ's gather of the
    secondary shard over the secondary group, or the forward gather of the
    primary again."""
    if z.distributed and z.hpz:
        return cl.hpz_all_gather_hops(res, z.hpz_group)  # no slow tier
    return fwd_gather_hops(res, z)


def saved_for_bwd(W: torch.Tensor, primary: torch.Tensor,
                  z: ZeroConfig) -> torch.Tensor:
    """What a layer's forward keeps for :func:`bwd_gather_hops`: this
    rank's secondary shard of the gathered weights under hpZ (a slice, no
    communication), else the primary shard."""
    if z.distributed and z.hpz:
        return cl.slice_secondary(W, z.hpz_group)
    return primary


def _ready(t: torch.Tensor) -> cl.Hops:
    """A collective that has already finished: no hop, result ``t``."""
    yield
    return t


def together(*hops: cl.Hops) -> cl.Hops:
    """Several one-hop collectives as one: each issued when this begins,
    all waited for when it finishes; the result is the tuple of theirs."""
    hops = tuple(cl.begin(h) for h in hops)
    yield
    return tuple(cl.finish(h) for h in hops)


def ring(srcs: Sequence, start: Callable[[Any], cl.Hops], k: int,
         first: Optional[torch.Tensor] = None,
         name: str = "layers.fwd",
         ahead: Optional[cl.Hops] = None) -> Iterator[Any]:
    """The depth-k prefetch ring: yields ``finish(start(srcs[i]))`` for
    i = 0, 1, …, with item i+k's collective begun before item i's is
    finished (so it is in flight while the consumer computes with item
    i).  k = 0 is the synchronous schedule.  ``first``, where given, is
    item 0 already gathered (the routing-ahead buffer): its collective is
    not issued; ``ahead``, where given, is item 0's collective already
    begun.

    Iteration i runs from this generator's resumption for item i (item
    i+k's issue, item i's wait, then the consumer's compute with it) to
    its resumption for the next; the first k items' issues come before
    iteration 0, outside the loop (the reference's prologue).  A step
    recorder (``collectives.RECORDER``) sees the loop ``name`` enter,
    each iteration begin and the loop exit."""
    rec = cl.RECORDER
    if rec is not None:
        rec.loop_enter(name)

    def begun(j):
        if j == 0 and first is not None:
            return cl.begin(_ready(first))
        if j == 0 and ahead is not None:
            return ahead
        return cl.begin(start(srcs[j]))
    try:
        pending = deque(begun(j) for j in range(min(k, len(srcs))))
        for i in range(len(srcs)):
            if rec is not None:
                rec.loop_iter()
            if i + k < len(srcs):
                pending.append(begun(i + k))
            yield cl.finish(pending.popleft())
    finally:
        if rec is not None:
            rec.loop_exit()


def fwd_gather_quant(primary: torch.Tensor, z: ZeroConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwZ forward gather that keeps the payload quantized: (payload_g
    int8, scales_g f32).  Caller must have checked qwz_gemm_eligible."""
    return cl.qwz_all_gather_quant(primary, z.group, z.qwz_cfg)


def qwz_gemm_eligible(z: ZeroConfig, rows: int, d: int) -> bool:
    """Can a (rows, d) weight chunk at flat offset 0 feed the fused INT8
    dequant-GEMM straight from its gathered qwZ payload?  Needs INT8 qwZ
    blocked qwZ and a scale layout that maps onto per-row groups: each row
    holds whole blocks (d % block == 0) or each block holds whole rows
    (block % d == 0, rows % (block/d) == 0: the row's scale is a
    broadcast)."""
    if not (z.distributed and z.qwz and z.qwz_blocked and z.qwz_gemm
            and z.qwz_bits == 8):
        return False
    b = z.qwz_block
    if (rows * d) % b:
        return False
    return d % b == 0 or (b % d == 0 and rows % (b // d) == 0)


def grad_reduce_hops(dW: torch.Tensor, z: ZeroConfig) -> cl.Hops:
    """Gradient reduce-scatter over the whole ZeRO world (sums, not
    means), returned in ``grad_dtype`` for the optimizer.  qgZ takes two
    hops (one on a single tier; one with ``qgz_2hop=False``, the flat
    all-to-all), the baseline one."""
    if not z.distributed:
        yield
        return dW.to(z.grad_dtype)
    if z.qgz and not z.qgz_2hop:
        hops = cl.qgz_reduce_scatter_1hop_hops(dW, z.group, z.qgz_cfg)
    elif z.qgz:
        two_tier = bool(z.inter_axes)
        tiers = cl.world_size(z.intra_group) * (
            cl.world_size(z.inter_group) if two_tier else 1)
        if tiers != cl.world_size(z.group):
            raise ValueError(f"intra x inter groups hold {tiers} ranks, the "
                             f"ZeRO world {cl.world_size(z.group)}")
        hops = cl.qgz_reduce_scatter_hops(
            dW, z.intra_group, z.inter_group, z.qgz_cfg, two_tier=two_tier)
    else:
        hops = cl.baseline_reduce_scatter_hops(dW.to(z.reduce_dtype),
                                               z.group)
    # the hops hold what they need (qgZ quantizes the gradient and drops
    # it at its first hop): a reduce in flight does not keep it alive
    del dW
    red = yield from hops
    return red.to(z.grad_dtype)


def grad_reduce_hop_count(z: ZeroConfig) -> int:
    """The hops :func:`grad_reduce_hops` waits on: two for the two-tier
    qgZ, else one."""
    return 2 if (z.distributed and z.qgz and z.qgz_2hop
                 and bool(z.inter_axes)) else 1


def grad_reduce(dW: torch.Tensor, z: ZeroConfig) -> torch.Tensor:
    return cl.finish(grad_reduce_hops(dW, z))


class _ZeroApply(torch.autograd.Function):
    """``f(W, *args)`` with ZeRO++ collectives around it (see the module
    note).  Tensor args that are floating point and need a gradient get
    one; the others (tokens, targets, a chunk index) get None."""

    @staticmethod
    def forward(ctx, f, z, primary, *args):
        W = fwd_gather(primary, z)
        out = f(W, *args)
        res = saved_for_bwd(W, primary, z)
        ctx.f, ctx.z = f, z
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.others = [a for a in args if not torch.is_tensor(a)]
        ctx.save_for_backward(res, *[a for a in args if torch.is_tensor(a)])
        return out

    @staticmethod
    def backward(ctx, *gouts):
        z = ctx.z
        res, *tensors = ctx.saved_tensors
        W = cl.finish(bwd_gather_hops(res, z)).detach().requires_grad_(True)
        want = [W]
        args, it_t, it_o = [], iter(tensors), iter(ctx.others)
        for i, is_t in enumerate(ctx.is_tensor):
            if not is_t:
                args.append(next(it_o))
                continue
            a = next(it_t).detach()
            if ctx.needs_input_grad[3 + i] and a.is_floating_point():
                a.requires_grad_(True)
                want.append(a)
            args.append(a)
        with torch.enable_grad():
            out = ctx.f(W, *args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if torch.is_tensor(o) and o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    want, [g for _, g in pairs],
                                    allow_unused=True)
        dW = grads[0] if grads[0] is not None else torch.zeros_like(W)
        dprimary = grad_reduce(dW.reshape(-1), z)
        it_g = iter(grads[1:])
        dargs = [next(it_g) if a is not None and torch.is_tensor(a)
                 and a.requires_grad else None for a in args]
        return (None, None, dprimary, *dargs)


def zero_apply(f: Callable, z: ZeroConfig) -> Callable:
    """Wrap ``f(W_full, *args) -> out`` into a ZeRO++ layer application:
    ``g(primary_shard, *args) -> out``, differentiable with respect to the
    primary shard (through the paper's collectives) and the float tensor
    args.  ``f`` is recomputed in the backward pass (activation
    checkpointing), as in the reference; in local mode too."""
    def apply(primary, *args):
        return _ZeroApply.apply(f, z, primary, *args)
    return apply


def zero_apply_inference(f: Callable, z: ZeroConfig) -> Callable:
    """Serving layer application: gather (qwZ if enabled), then apply."""
    def apply(primary, *args):
        return f(fwd_gather(primary, z), *args)
    return apply


def zero_scan_inference(f: Callable, z: ZeroConfig, *,
                        spec: Optional[Callable] = None,
                        name: str = "layers") -> Callable:
    """The layer loop of the serving path, with the depth-k prefetch ring
    (the reference's ``core/schedule.py`` ``zero_scan_inference``).

    ``f(W_full, h, x) -> (h_next, y)``; returns ``run(stacked, h0, xs=None,
    W0=None) -> (h_final, ys)`` where ``stacked`` is (n, P) flat layer
    groups, ``xs`` a sequence of n per-layer inputs (or None) and ``ys``
    the list of the n per-layer outputs.  Layer i+k's gather is issued
    before layer i's compute (k = ``z.effective_prefetch(n)``; 0: each
    group gathered right before its layer).  ``W0`` is layer 0's group
    already gathered (its gather is not issued).  With ``spec(xs, i) ->
    shard`` (routing-ahead: an MoE layer's first expert chunk) the ring
    also gathers ``spec(xs, i + k)`` beside layer i+k's group and the body
    is called ``f(W, W_spec, h, x)`` (W_spec None on the synchronous
    schedule, where nothing is gathered ahead).  ``name`` names the loop
    for a step recorder (``<name>.fwd``: "layers", or the chunk
    pipeline's "chunks").
    """
    def run(stacked, h0, xs: Optional[Sequence] = None,
            W0: Optional[torch.Tensor] = None):
        h, ys = h0, []
        n = len(stacked)
        k = z.effective_prefetch(n)
        ahead = spec is not None and k >= 1
        if ahead:
            def start(i):
                return together(fwd_gather_hops(stacked[i], z),
                                fwd_gather_hops(spec(xs, i), z))
        else:
            def start(i):
                return fwd_gather_hops(stacked[i], z)
        for i, W in enumerate(ring(range(n), start, k,
                                   None if ahead else W0,
                                   name=name + ".fwd")):
            x = None if xs is None else xs[i]
            if spec is None:
                h, y = f(W, h, x)
            elif ahead:
                h, y = f(W[0], W[1], h, x)
            else:
                h, y = f(W, None, h, x)
            ys.append(y)
        return h, ys
    return run


# ---------------------------------------------------------------------------
# communication-volume accounting (paper Table 1)
# ---------------------------------------------------------------------------

def comm_volume_per_step(n_params: int, z: ZeroConfig,
                         elem_bytes: int = 2) -> dict:
    """Analytic slow-tier bytes per training step of a model with
    ``n_params`` parameters (the paper's Table 1).

    Baseline ZeRO-3: M (fwd AG) + M (bwd AG) + M (grad RS) = 3M.
    ZeRO++       : 0.5M        + 0          + 0.25M        = 0.75M.
    """
    M = n_params * elem_bytes
    qw = z.qwz_cfg.wire_bytes(n_params)
    fwd = qw if z.qwz else M
    bwd = 0 if z.hpz else fwd
    rs = z.qgz_cfg.wire_bytes(n_params) if z.qgz else M
    return {"fwd_allgather": fwd, "bwd_allgather": bwd, "grad_reduce": rs,
            "total": fwd + bwd + rs, "baseline_total": 3 * M,
            "reduction_factor": 3 * M / max(fwd + bwd + rs, 1)}


# ---------------------------------------------------------------------------
# per-rank wire accounting (the runtime counters' projection)
# ---------------------------------------------------------------------------
# The bytes one rank puts on the wire for one collective, by the rules
# ``core/collectives.py`` counts them with (all-gather out − in,
# reduce-scatter in − out, all-to-all in·(g−1)/g), fp32 scales included:
# qwZ gathers them beside its payload, qgZ packs them into its message.
# The labels are the ones the collectives count under; every knob of the
# reference's is here (non-blocked qwZ: one fp32 scale a shard; hpZ over
# ``secondary_axes``; qgZ at ``qgz_bits``, 1-hop under its own label),
# and every axis of the mesh: ``sizes`` may hold ("data", "model") or
# ("pod", "data", "model").  These are bytes a rank, summed over tiers:
# the 1-hop's total equals the 2-hop's at 2 x 2 and 2 x 2 x 2 (3n/4 and
# 7n/8 a rank), and what differs, the bytes that cross the slow tier, is
# not split here.

WIRE_LABELS = (cl.QWZ, cl.BASELINE_GATHER, cl.HPZ, cl.QGZ, cl.QGZ_1HOP,
               cl.BASELINE_REDUCE)

EVENT_KINDS = ("fwd_gather", "bwd_gather", "grad_reduce")


def _group(sizes: dict, axes) -> int:
    return math.prod(int(sizes[a]) for a in axes)


def wire_label(kind: str, z: ZeroConfig) -> str:
    """The label the collective for ``kind`` is counted under."""
    if kind == "fwd_gather":
        return cl.QWZ if z.qwz else cl.BASELINE_GATHER
    if kind == "bwd_gather":
        return cl.HPZ if z.hpz else wire_label("fwd_gather", z)
    if kind == "grad_reduce":
        if z.qgz:
            return cl.QGZ if z.qgz_2hop else cl.QGZ_1HOP
        return cl.BASELINE_REDUCE
    raise ValueError(f"unknown comm event kind {kind!r}")


def event_wire_bytes(kind: str, n_elems: int, z: ZeroConfig,
                     sizes: dict) -> float:
    """Per-rank wire bytes of ONE collective over a global flat buffer of
    ``n_elems`` elements; ``sizes`` maps each mesh axis to its size.  A
    world of 1 sends nothing (0 for every kind)."""
    if not z.distributed:
        return 0.0
    n = int(n_elems)
    if kind == "fwd_gather":
        w = _group(sizes, z.dp_axes)
        if z.qwz:
            pb, b = z.qwz_cfg.payload_bytes, z.qwz_block
            wire = float(pb(n) - pb(n // w))
            if z.qwz_blocked:
                wire += 4.0 * (n // b - (n // w) // b)
            else:
                wire += 4.0 * (w - 1)       # one fp32 scale a shard
            return wire
        eb = z.param_dtype.itemsize
        return float(eb * n - eb * (n // w))
    if kind == "bwd_gather":
        if z.hpz:
            xs = _group(sizes, z.secondary_axes)
            eb = z.compute_dtype.itemsize
            return float(eb * n - eb * (n // xs))
        return event_wire_bytes("fwd_gather", n, z, sizes)
    if kind == "grad_reduce":
        if z.qgz:
            pb, b = z.qgz_cfg.payload_bytes, z.qgz_block
            if not z.qgz_2hop:
                w = _group(sizes, z.dp_axes)
                return float((pb(n) + 4.0 * (n // b)) * (w - 1) / w)
            return float(sum(_qgz_2hop_bytes(n, z, sizes)))
        w = _group(sizes, z.dp_axes)
        eb = z.reduce_dtype.itemsize
        return float(eb * n - eb * (n // w))
    raise ValueError(f"unknown comm event kind {kind!r}")


def _qgz_2hop_bytes(n: int, z: ZeroConfig, sizes: dict) -> tuple:
    """The 2-hop qgZ's bytes a rank: (its intra all-to-all, its inter
    one), each INT4 payload with its fp32 scales."""
    pb, b = z.qgz_cfg.payload_bytes, z.qgz_block
    X = _group(sizes, (z.intra_axis,))
    Y = _group(sizes, z.inter_axes) if z.inter_axes else 1
    m = n // X
    return ((pb(n) + 4.0 * (n // b)) * (X - 1) / X,
            (pb(m) + 4.0 * (m // b)) * (Y - 1) / Y if Y > 1 else 0.0)


def event_wire_by_tier(kind: str, n_elems: int, z: ZeroConfig,
                       sizes: dict) -> dict:
    """:func:`event_wire_bytes` split by the interconnect tier each hop
    crosses (``obs.metrics.tier`` of its group's axes, as the counters
    attribute it): the gathers over the ZeRO world or hpZ's secondary
    axes, the 2-hop qgZ's first all-to-all on the intra axis and its
    second on the inter axes, every other reduce over the world."""
    from repro_torch.obs.metrics import tier
    if not z.distributed:
        return {}
    n = int(n_elems)
    if kind == "bwd_gather" and z.hpz:
        out = {tier(z.secondary_axes): event_wire_bytes(kind, n, z, sizes)}
    elif kind == "grad_reduce" and z.qgz and z.qgz_2hop:
        hop1, hop2 = _qgz_2hop_bytes(n, z, sizes)
        out = {tier((z.intra_axis,)): hop1}
        t2 = tier(z.inter_axes)
        out[t2] = out.get(t2, 0.0) + hop2
    else:
        out = {tier(z.dp_axes): event_wire_bytes(kind, n, z, sizes)}
    return {t: float(v) for t, v in out.items() if v}


def step_wire_by_tier(events, z: ZeroConfig, sizes: dict) -> dict:
    """Fold a comm-event list into per-tier, per-rank wire bytes: the
    projection of the ``comm.tier.<tier>.bytes`` counters (``other``
    aside)."""
    out: dict = {}
    for ev in events:
        for t, b in event_wire_by_tier(ev["kind"], ev["elems"], z,
                                       sizes).items():
            out[t] = out.get(t, 0.0) + b * ev.get("count", 1)
    return out


def step_wire_by_label(events, z: ZeroConfig, sizes: dict) -> dict:
    """Fold a comm-event list (``Model.comm_events()``) into per-label,
    per-rank wire bytes: the projection the measured counters are gated
    against (``obs.report.runtime_gate``)."""
    out: dict = {}
    for ev in events:
        lbl = wire_label(ev["kind"], z)
        wire = event_wire_bytes(ev["kind"], ev["elems"], z, sizes)
        out[lbl] = out.get(lbl, 0.0) + wire * ev.get("count", 1)
    return out
