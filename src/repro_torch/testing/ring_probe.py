"""Live-buffer instrument of a layer loop's prefetch ring (test side).

The HBM ledger (``tune/memory.py``) charges a depth-k ring (k+1) live
gathered layer buffers and the backward k unreduced-gradient slots.
:class:`RingProbe` counts what the port's schedule really holds, by
wrapping the collectives the layer loops issue (``core.zeropp``'s and
``core.schedule``'s ``fwd_gather_hops``, ``bwd_gather_hops`` and
``grad_reduce_hops``) while it is entered:

  * a gathered buffer is live from its collective's issue until the next
    gather of the same pass is issued after it was handed out (the ring
    hands one out while k more are in flight; the synchronous loop has
    one at a time).  ``peak["fwd"]`` / ``peak["bwd"]`` are the most
    live at once in the forward loop and in the backward's re-gather
    loop;
  * a gradient reduce is in flight from its issue (its first hop) to its
    result.  Each time the backward hands a layer's weights to its VJP,
    the reduces in flight under that VJP are counted, in total and by
    the hop each is in: ``grad_peak`` and ``grad_peak_by_hop``.  (The
    port issues a layer's reduce as soon as its VJP is enqueued and
    retires each hop k layers later, so a two-hop qgZ reduce rides under
    2k VJPs: k in each hop.)

With ``memory`` (a function giving bytes, e.g.
``torch.cuda.memory_allocated``) the probe also reads it each time a
buffer is handed out: ``mem_peak["fwd"]``/``["bwd"]``, the most
allocated at a layer's compute in each pass (the allocator's view of
the ring beside the ledger's charge).

Only the layer loop's collectives count: forward gathers of a
``fwd_size``-element source (the layer group's primary shard), backward
ones of a ``bwd_size``-element source (its hpZ secondary shard, else the
primary) and reduces of a ``reduce_size``-element gradient (the whole
group); the caller checks that no other group shares those sizes.  The
probe counts: it changes no value and no schedule.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core import schedule, zeropp

_NAMES = ("fwd_gather_hops", "bwd_gather_hops", "grad_reduce_hops")


class _Counted:
    """A collective's hops (an iterator of ``cl.Hops``), reporting its
    issue, each later hop and its end to the probe."""

    def __init__(self, hops, probe: "RingProbe", kind: str, phase: str):
        self.hops, self.probe, self.kind, self.phase = hops, probe, kind, phase
        self.hop = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.hop == 0:
            self.probe._begin(self)
        self.hop += 1
        try:
            return next(self.hops)
        except StopIteration:
            self.probe._end(self)
            raise


class RingProbe:
    def __init__(self, fwd_size: int, bwd_size: int, reduce_size: int,
                 memory: Optional[Callable[[], int]] = None):
        self.sizes = {"fwd": int(fwd_size), "bwd": int(bwd_size)}
        self.reduce_size = int(reduce_size)
        self.memory = memory
        self.mem_peak = {"fwd": 0, "bwd": 0}
        self.live = {"fwd": 0, "bwd": 0}
        self.held = {"fwd": 0, "bwd": 0}
        self.peak = {"fwd": 0, "bwd": 0}
        self.reduces: List[_Counted] = []
        self.grad_peak = 0
        self.grad_peak_by_hop: Dict[int, int] = {}
        self._saved = {}

    # ------------------------------------------------------------ events

    def _begin(self, c: _Counted) -> None:
        if c.kind == "reduce":
            self.reduces.append(c)
            return
        self.held[c.phase] = 0
        self.live[c.phase] += 1
        self._note(c.phase)

    def _end(self, c: _Counted) -> None:
        if c.kind == "reduce":
            self.reduces.remove(c)
            return
        self.live[c.phase] -= 1
        self.held[c.phase] = 1
        self._note(c.phase)
        if self.memory is not None:
            self.mem_peak[c.phase] = max(self.mem_peak[c.phase],
                                         int(self.memory()))
        if c.phase == "bwd":     # handed to its layer's VJP
            self.grad_peak = max(self.grad_peak, len(self.reduces))
            by_hop: Dict[int, int] = {}
            for r in self.reduces:
                by_hop[r.hop] = by_hop.get(r.hop, 0) + 1
            for h, n in by_hop.items():
                self.grad_peak_by_hop[h] = max(
                    self.grad_peak_by_hop.get(h, 0), n)

    def _note(self, phase: str) -> None:
        self.peak[phase] = max(self.peak[phase],
                               self.live[phase] + self.held[phase])

    # ---------------------------------------------------------- wrapping

    def _wrap(self, name: str, orig):
        probe = self

        if name == "grad_reduce_hops":
            def wrapped(dW, z):
                hops = orig(dW, z)
                if dW.numel() != probe.reduce_size:
                    return hops
                return _Counted(hops, probe, "reduce", "bwd")
            return wrapped

        phase = "fwd" if name == "fwd_gather_hops" else "bwd"

        def wrapped(src, z):
            hops = orig(src, z)
            mine = src.numel() == probe.sizes[phase]
            if isinstance(hops, _Counted):   # bwd over the fwd gather
                if not mine:
                    return hops.hops
                hops.phase = phase
                return hops
            if not mine:
                return hops
            return _Counted(hops, probe, "gather", phase)
        return wrapped

    def __enter__(self) -> "RingProbe":
        for mod in (zeropp, schedule):
            for name in _NAMES:
                orig = getattr(mod, name)
                self._saved[(mod, name)] = orig
                setattr(mod, name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc) -> None:
        for (mod, name), orig in self._saved.items():
            setattr(mod, name, orig)
        self._saved.clear()

    def report(self) -> Dict:
        """The peaks: ``fwd``/``bwd`` live gathered buffers, ``grads``
        reduces in flight under a VJP and ``grads_by_hop`` by hop (hop 1:
        not reduced at all yet, the ledger's unreduced-gradient slots)."""
        return {"fwd": self.peak["fwd"], "bwd": self.peak["bwd"],
                "grads": self.grad_peak,
                "grads_by_hop": dict(sorted(self.grad_peak_by_hop.items()))}
