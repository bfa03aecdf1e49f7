"""Roofline inputs of one rank's step, read off a run on fake tensors.

Counterpart of the reference's ``launch/jaxpr_analysis.py``.  The
reference walks the jaxpr of its jitted step; the port has no program to
walk, so :func:`analyze_step` runs the step once, eagerly, on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage behind them) and counts what it does as it goes.  It returns the
dict of the reference's ``analyze_jaxpr``:

  * ``flops``      per rank, forward and backward, counted by
                   ``torch.utils.flop_counter.FlopCounterMode`` (its
                   formulas for the matmuls and attention; 2·M·N·K a
                   product, as the reference's ``_dot_flops``);
  * ``hbm_bytes``  the reference's fusion-blind traffic model: the inputs
                   and outputs of every matmul and collective, and twice the
                   output of every op that must materialise its result
                   (gathers, scatters, sorts, cumulative sums, concatenation,
                   padding; a scatter also reads its input), everything
                   elementwise assumed fused and free.  A slice is a view
                   here (the reference counts its ``dynamic_slice``);
  * ``collectives`` the step's collectives: ``per_tier_wire``,
                   ``per_tier_other`` (``other``'s share of each tier) and
                   ``wire_by_label`` as ``core/collectives.py`` counted them
                   where it issued them, read from the metrics registry,
                   not recomputed; ``per_op`` (count, operand and wire
                   bytes per kind: all_gather, reduce_scatter, all_to_all,
                   all_reduce, send) from the c10d ops seen here, each
                   credited with the wire bytes the registry gained before
                   the next one (``core/collectives.py`` counts a
                   collective right after issuing it); ``count``,
                   ``operand_bytes`` and ``wire_bytes``;
  * ``peak_bytes`` program-order liveness: every storage an op creates is
                   live from that op until Python frees its last tensor (a
                   finalizer on the fake storage), on top of the storages
                   handed in as ``state``; the most live at once;
  * ``overlap``    the reference's ``analyze_overlap`` dict, read from the
                   same run's issue, wait, compute and loop events
                   (``launch/overlap_analysis.py``), its wire invariant
                   held against the counters' growth.

Each call through the kernel seam (``kernels/ops.py``: B1-B8) counts as
one op, as the reference's walk counts a ``pallas_call``: its operands and
results cross HBM and its results are live from its return, while the
temporaries of the plain version that runs here (B4/B5's float64 FMA
chain, the flash versions' logit tiles) are neither traffic nor memory:
the kernel on the card holds none.  Its FLOPs are the plain version's.
``kernel_calls`` counts the calls a kernel.

The step's tensors must be fake tensors on ``device="cpu"``, so the
kernel seam takes the plain versions and no fake pointer reaches a
launch: this is analysis, not the main path.  Anything the step reads
back on the host raises under the fake mode (a data-dependent output).
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.platform import LAUNCHES
from repro_torch.obs.metrics import TIER_RANK, get_registry

aten = torch.ops.aten

# ops whose operands and result cross HBM whatever the fusion
_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.addbmm,
           aten.matmul, aten.dot, aten.mv}
# ops that necessarily materialize their result (the reference's
# ``_MATERIALIZING``); the scatters also read their input
_SCATTER = {aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
            aten.index_put, aten.index_put_, aten.index_add,
            aten.index_add_, aten.index_copy, aten.index_copy_,
            aten.slice_scatter, aten.select_scatter,
            aten.embedding_dense_backward}
_MATERIALIZING = _SCATTER | {
    aten.gather, aten.index, aten.index_select, aten.embedding,
    aten.sort, aten.argsort, aten.topk, aten.cumsum, aten.cumprod,
    aten.logcumsumexp, aten.cat, aten.stack, aten.constant_pad_nd}
# c10d op -> (the collective's kind, the position of what it reads); the
# receive of a send/receive pair is the send's other end
_C10D_KINDS = {"_allgather_base_": ("all_gather", 1),
               "_reduce_scatter_base_": ("reduce_scatter", 1),
               "alltoall_base_": ("all_to_all", 1),
               "allreduce_": ("all_reduce", 0),
               "send": ("send", 0)}


def tree_nbytes(tree: Any) -> int:
    """Bytes of the tensors among ``tree``'s leaves."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Liveness:
    """Bytes of the storages alive now and the most alive at once.

    :meth:`add` registers a tensor's storage (once) with a finalizer that
    takes it off when the storage is freed, i.e. when the last tensor on it
    dies: Python frees tensors at their last reference, so ``peak`` is the
    program-order liveness peak of everything added."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)


def wire_total() -> float:
    """Wire bytes the registry's tier counters hold now."""
    reg = get_registry()
    return sum(reg.counter(f"comm.tier.{t}.bytes").value for t in TIER_RANK)


class TraceCounter(TorchDispatchMode):
    """Counts, op by op, the fusion-blind HBM bytes of the module
    docstring, the liveness of every storage the ops create and the
    collectives by kind (``per_op``; :meth:`settle` credits the last one
    its wire bytes).  ``rec``, where given (an
    ``overlap_analysis.StepRecorder``), is handed every matmul op and
    every kernel-seam call outside another, its compute events."""

    def __init__(self, live: Optional[Liveness] = None, rec=None):
        super().__init__()
        self.live = live if live is not None else Liveness()
        self.rec = rec
        self.hbm_bytes = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.per_op: Dict[str, Dict[str, float]] = {}
        self._open: Optional[str] = None   # the last collective's kind
        self._wire_at = 0.0       # wire_total() when it was issued
        self._inside = 0          # > 0: within a kernel-seam call

    def settle(self) -> None:
        """Credit the last collective with the wire bytes counted since
        it was issued."""
        if self._open is not None:
            self.per_op[self._open]["wire_bytes"] += \
                wire_total() - self._wire_at
            self._open = None

    def _issue(self, name: str, args) -> None:
        kind, at = _C10D_KINDS[name]
        self.settle()
        o = self.per_op.setdefault(kind, {"count": 0.0, "operand_bytes": 0.0,
                                          "wire_bytes": 0.0})
        o["count"] += 1
        o["operand_bytes"] += tree_nbytes(args[at])
        self._open, self._wire_at = kind, wire_total()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        packet = func.overloadpacket
        if func.namespace == "c10d":
            # a collective's tensors are its arguments (input and output);
            # an all-reduce reads and writes the same one
            b = tree_nbytes((args, kwargs))
            self.hbm_bytes += 2 * b if packet.__name__ == "allreduce_" \
                else b
            if packet.__name__ in _C10D_KINDS:
                self._issue(packet.__name__, args)
        elif packet in _MATMUL:
            self.hbm_bytes += tree_nbytes((args, kwargs)) \
                + tree_nbytes(out)
            if self.rec is not None:
                self.rec.matmul(func, args, kwargs, out)
        elif packet in _MATERIALIZING:
            self.hbm_bytes += 2 * tree_nbytes(out)
            if packet in _SCATTER:
                self.hbm_bytes += tree_nbytes((args, kwargs))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.live.add(t)
        return out

    def kernel_call(self, name: str, fn: Callable) -> Callable:
        """``fn`` (a kernel-seam function) as one op of the trace."""
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self._inside += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._inside -= 1
            if not self._inside:
                res = [t for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)]
                self.hbm_bytes += tree_nbytes((args, kwargs)) \
                    + tree_nbytes(res)
                for t in res:
                    self.live.add(t)
                self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
                if self.rec is not None:
                    self.rec.seam(name, args, kwargs)
            return out
        return call

    @contextlib.contextmanager
    def kernels_as_calls(self) -> Iterator[None]:
        """Within: every kernel-seam function of ``kernels/ops.py`` (one
        per kernel of ``platform.LAUNCHES``) is :meth:`kernel_call`'d."""
        saved = {k: getattr(kernel_ops, k) for k in LAUNCHES}
        try:
            for k, fn in saved.items():
                setattr(kernel_ops, k, self.kernel_call(k, fn))
            yield
        finally:
            for k, fn in saved.items():
                setattr(kernel_ops, k, fn)


def counters() -> Dict[str, float]:
    """The wire counters of the registry (``comm.*``) as they stand."""
    return {k: v for k, v in get_registry().snapshot().items()
            if k.startswith("comm.")}


def collectives_since(before: Dict[str, float],
                      per_op: Dict[str, Dict[str, float]]) -> Dict[str, Any]:
    """The ``collectives`` dict of :func:`analyze_step` from the wire
    counters' growth since ``before`` (a :func:`counters`) and the
    trace's ``per_op``."""
    d = {k: v - before.get(k, 0) for k, v in counters().items()}
    labels: Dict[str, float] = {}
    tiers = dict.fromkeys(TIER_RANK, 0.0)
    other = dict.fromkeys(TIER_RANK, 0.0)
    for k, v in d.items():
        parts = k.split(".")
        if parts[1] == "tier":
            (other if parts[3] == "other" else tiers)[parts[2]] += v
        elif v:
            labels[".".join(parts[1:-1])] = v
    return {"per_op": per_op, "per_tier_wire": tiers,
            "per_tier_other": other, "wire_by_label": labels,
            "count": sum(o["count"] for o in per_op.values()),
            "operand_bytes": sum(o["operand_bytes"]
                                 for o in per_op.values()),
            "wire_bytes": sum(o["wire_bytes"] for o in per_op.values())}


def analyze_step(step: Callable, *args, state: Iterable = ()
                 ) -> Dict[str, Any]:
    """Run ``step(*args)`` once (its tensors fake, on the CPU, under the
    caller's ``FakeTensorMode``) and return the reference's
    ``analyze_jaxpr`` dict for it, with ``kernel_calls``.  ``state``: the
    tensors alive before the step and through it (params, optimizer
    state, batch, caches), counted live from the start."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import collectives as cl
    from repro_torch.launch.overlap_analysis import (StepRecorder,
                                                     analyze_overlap,
                                                     check_wire)

    live = Liveness()
    for t in tree_leaves(list(state)):
        if isinstance(t, torch.Tensor):
            live.add(t)
    before = counters()
    rec = StepRecorder()
    tc = TraceCounter(live, rec)
    with FlopCounterMode(display=False) as fc, tc, tc.kernels_as_calls(), \
            rec:
        step(*args)
    tc.settle()
    coll = collectives_since(before, tc.per_op)
    overlap = analyze_overlap(rec.events,
                              multi_pod="pod" in cl.group_axes(None))
    check_wire(overlap, sum(coll["wire_by_label"].values()))
    return {"flops": float(fc.get_total_flops()),
            "hbm_bytes": tc.hbm_bytes,
            "collectives": coll,
            "peak_bytes": float(live.peak),
            "kernel_calls": dict(tc.kernel_calls),
            "overlap": overlap}
