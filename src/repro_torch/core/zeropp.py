"""The ZeRO++ engine: gather-compute-reduce as one differentiable primitive.

Port of the reference's ``core/zeropp.py``: ``ZeroConfig``, ``fwd_gather``,
``fwd_gather_quant``, ``qwz_gemm_eligible``, ``grad_reduce``, the training
primitive ``zero_apply`` and the serving ``zero_apply_inference``, plus
the serving layer loop ``zero_scan_inference`` of the reference's
``core/schedule.py``, with its depth-k prefetch ring (:func:`ring`), and
the communication accounting (:func:`comm_volume_per_step`, the paper's
Table 1; :func:`step_wire_by_label`, the per-rank bytes that the
collectives count).

``zero_apply`` wraps each layer group's apply function ``f(W_full, *args)``
as a ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``):

  forward  : W = fwd-gather(primary shard)        [qwZ INT8 if enabled]
             out = f(W, *args), without autograd
             saved = (secondary shard of W if hpZ else primary, args)
  backward : W' = hpZ intra-node gather of the secondary shard
                  (or the forward gather again when hpZ is off)
             dW, dargs = autograd of f recomputed on W' [activation
                  checkpointing: f runs twice]
             dprimary = qgZ INT4 2-hop all-to-all reduce-scatter
                  (or the bf16 reduce-scatter baseline)

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
    takes its two hops); the process groups carry the traffic: ``group``
    the whole ZeRO world, ``intra_group`` the fast tier (``intra_axis``:
    hpZ's secondary group and qgZ's first hop), ``inter_group`` the slow
    tier (qgZ's second hop).  None is torch.distributed's default group,
    or a world of 1 when no process group is initialised; at world > 1
    the caller passes the tiers (``collectives.tier_groups``), and
    :func:`grad_reduce` checks that they tile the world.
    """

    # qwZ (§3.1)
    qwz: bool = True
    qwz_bits: int = 8
    qwz_block: int = 256
    # serving head: feed the gathered INT8 payload straight to the fused
    # dequant-GEMM where the layout allows (see qwz_gemm_eligible)
    qwz_gemm: bool = True
    # hpZ (§3.2): the secondary partition lives on the intra group
    hpz: bool = True
    # qgZ (§3.3): INT4 blockwise gradients over the 2-hop all-to-all
    qgz: bool = True
    qgz_block: int = 256
    # ZeRO world
    dp_axes: Tuple[str, ...] = ("data", "model")
    intra_axis: str = "model"
    group: Any = None
    intra_group: Any = None
    inter_group: Any = None
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
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
    def qwz_cfg(self) -> QuantConfig:
        return QuantConfig(bits=self.qwz_bits, block_size=self.qwz_block)

    @property
    def qgz_cfg(self) -> QuantConfig:
        return QuantConfig(bits=4, block_size=self.qgz_block)

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
            primary, z.group, z.qwz_cfg, out_dtype=z.compute_dtype))
    return (yield from cl.baseline_all_gather_hops(
        primary.to(z.param_dtype), z.group, out_dtype=z.compute_dtype))


def fwd_gather(primary: torch.Tensor, z: ZeroConfig) -> torch.Tensor:
    return cl.finish(fwd_gather_hops(primary, z))


def bwd_gather_hops(res: torch.Tensor, z: ZeroConfig) -> cl.Hops:
    """The backward pass's re-gather of a layer's full weights from what
    its forward saved (:func:`saved_for_bwd`): hpZ's intra-group gather of
    the secondary shard, or the forward gather of the primary again."""
    if z.distributed and z.hpz:
        return cl.hpz_all_gather_hops(res, z.intra_group)  # fast tier only
    return fwd_gather_hops(res, z)


def saved_for_bwd(W: torch.Tensor, primary: torch.Tensor,
                  z: ZeroConfig) -> torch.Tensor:
    """What a layer's forward keeps for :func:`bwd_gather_hops`: this
    rank's secondary shard of the gathered weights under hpZ (a slice, no
    communication), else the primary shard."""
    if z.distributed and z.hpz:
        return cl.slice_secondary(W, z.intra_group)
    return primary


def ring(srcs: Sequence, start: Callable[[Any], cl.Hops], k: int
         ) -> Iterator[torch.Tensor]:
    """The depth-k prefetch ring: yields ``finish(start(srcs[i]))`` for
    i = 0, 1, …, with item i+k's collective begun before item i's is
    finished (so it is in flight while the consumer computes with item
    i).  k = 0 is the synchronous schedule."""
    pending = deque(cl.begin(start(srcs[j]))
                    for j in range(min(k, len(srcs))))
    for i in range(len(srcs)):
        if i + k < len(srcs):
            pending.append(cl.begin(start(srcs[i + k])))
        yield cl.finish(pending.popleft())


def fwd_gather_quant(primary: torch.Tensor, z: ZeroConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwZ forward gather that keeps the payload quantized: (payload_g
    int8, scales_g f32).  Caller must have checked qwz_gemm_eligible."""
    return cl.qwz_all_gather_quant(primary, z.group, z.qwz_cfg)


def qwz_gemm_eligible(z: ZeroConfig, rows: int, d: int) -> bool:
    """Can a (rows, d) weight chunk at flat offset 0 feed the fused INT8
    dequant-GEMM straight from its gathered qwZ payload?  Needs INT8 qwZ
    and a scale layout that maps onto per-row groups: each row holds whole
    blocks (d % block == 0) or each block holds whole rows (block % d ==
    0, rows % (block/d) == 0: the row's scale is a broadcast)."""
    if not (z.distributed and z.qwz and z.qwz_gemm and z.qwz_bits == 8):
        return False
    b = z.qwz_block
    if (rows * d) % b:
        return False
    return d % b == 0 or (b % d == 0 and rows % (b // d) == 0)


def grad_reduce_hops(dW: torch.Tensor, z: ZeroConfig) -> cl.Hops:
    """Gradient reduce-scatter over the whole ZeRO world (sums, not
    means), returned in float32 for the optimizer.  qgZ takes two hops
    (one on a single tier), the baseline one."""
    if not z.distributed:
        yield
        return dW.to(torch.float32)
    if z.qgz:
        two_tier = bool(z.inter_axes)
        tiers = cl.world_size(z.intra_group) * (
            cl.world_size(z.inter_group) if two_tier else 1)
        if tiers != cl.world_size(z.group):
            raise ValueError(f"intra x inter groups hold {tiers} ranks, the "
                             f"ZeRO world {cl.world_size(z.group)}")
        return (yield from cl.qgz_reduce_scatter_hops(
            dW, z.intra_group, z.inter_group, z.qgz_cfg, two_tier=two_tier))
    red = yield from cl.baseline_reduce_scatter_hops(dW.to(z.reduce_dtype),
                                                     z.group)
    return red.to(torch.float32)


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


def zero_scan_inference(f: Callable, z: ZeroConfig) -> Callable:
    """The layer loop of the serving path, with the depth-k prefetch ring
    (the reference's ``core/schedule.py`` ``zero_scan_inference``).

    ``f(W_full, h, x) -> (h_next, y)``; returns ``run(stacked, h0, xs) ->
    (h_final, ys)`` where ``stacked`` is (n, P) flat layer groups, ``xs``
    a sequence of n per-layer inputs (or None) and ``ys`` the list of the
    n per-layer outputs.  Layer i+k's gather is issued before layer i's
    compute (k = ``z.effective_prefetch(n)``; 0: each group gathered right
    before its layer).
    """
    def run(stacked: torch.Tensor, h0, xs: Optional[Sequence] = None):
        h, ys = h0, []
        k = z.effective_prefetch(stacked.shape[0])
        for i, W in enumerate(ring(stacked, lambda p: fwd_gather_hops(p, z),
                                   k)):
            h, y = f(W, h, None if xs is None else xs[i])
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
# The labels are the ones the collectives count under.  The knobs are the
# port's: blocked qwZ and 2-hop qgZ only (the reference's non-blocked qwZ
# and 1-hop qgZ, with the zero.qgz_reduce1hop label, come with their
# collectives).

WIRE_LABELS = (cl.QWZ, cl.BASELINE_GATHER, cl.HPZ, cl.QGZ,
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
        return cl.QGZ if z.qgz else cl.BASELINE_REDUCE
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
            return float(pb(n) - pb(n // w)
                         + 4.0 * (n // b - (n // w) // b))
        eb = z.param_dtype.itemsize
        return float(eb * n - eb * (n // w))
    if kind == "bwd_gather":
        if z.hpz:
            xs = _group(sizes, (z.intra_axis,))
            eb = z.compute_dtype.itemsize
            return float(eb * n - eb * (n // xs))
        return event_wire_bytes("fwd_gather", n, z, sizes)
    if kind == "grad_reduce":
        if z.qgz:
            pb, b = z.qgz_cfg.payload_bytes, z.qgz_block
            X = _group(sizes, (z.intra_axis,))
            Y = _group(sizes, z.inter_axes) if z.inter_axes else 1
            wire = (pb(n) + 4.0 * (n // b)) * (X - 1) / X
            if Y > 1:
                m = n // X
                wire += (pb(m) + 4.0 * (m // b)) * (Y - 1) / Y
            return float(wire)
        w = _group(sizes, z.dp_axes)
        eb = z.reduce_dtype.itemsize
        return float(eb * n - eb * (n // w))
    raise ValueError(f"unknown comm event kind {kind!r}")


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
