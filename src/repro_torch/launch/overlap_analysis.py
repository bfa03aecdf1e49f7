"""The overlap reading of one rank's step: which in-loop wire bytes can
hide under compute, read from the order in which the step issues its
collectives, waits on them and enqueues its compute.

Counterpart of the overlap half of the reference's
``launch/hlo_analysis.py``: :func:`analyze_overlap` (its
``analyze_overlap``), :func:`effective_overlap` (its
``effective_overlap``, the same arithmetic) and
:data:`RING_OPERATING_POINT` (its constant, at the card's cluster's
values).  The reference reads the structure off a compiled HLO schedule;
the port has none.  What it has is the order of one step's events, which
is deterministic and is the port's schedule:

  * **issue** of a collective (label, kind, wire bytes, tier), recorded
    where ``core/collectives.py`` counts it, with the ``Work`` it waits
    on;
  * **wait** on it (``collectives._wait``), matched to its issue by that
    ``Work``;
  * **compute**: every matmul op (``trace_analysis._MATMUL``) and every
    kernel-seam call of B6, B7 and B8 (``kernels/ops.py`` ``flash_fwd``,
    ``flash_bwd``, ``dequant_matmul``), with the FLOPs of
    ``torch.utils.flop_counter``'s formulas; B1-B5 are not compute, as
    the reference's ``_is_compute`` counts only dots;
  * **loop** enter, iteration and exit, from the ring generator every
    ring goes through (``core/zeropp.ring``): ``layers.fwd``,
    ``layers.bwd``, ``chunks.fwd``, ``chunks.bwd``; a loop entered inside
    another's iteration is keyed by its path, ``layers.fwd/chunks.fwd``.

:class:`StepRecorder` records them: installed as ``collectives.RECORDER``
it takes the issue, wait and loop hooks (with none installed each hook
costs one global read), and ``trace_analysis.TraceCounter``, the trace's
one dispatch mode and kernel-seam wrapper, hands it the compute.  The
definitions, the port's for the reference's:

  * **in a loop**: issued while an iteration of a loop is open (the
    innermost such loop owns it).  A gather issued before iteration 0 or
    a reduce drained after the last iteration is outside, as the
    reference's prologue and epilogue sit outside its while body;
  * **overlappable**: at least one compute event lies between its issue
    and its wait;
  * **slack_iters**: the iterations of its loop whose compute began
    between its issue and its wait (at least 1; 1 when exposed);
  * **trip_count** the iterations of one entry of the loop,
    **outer_mult** the number of entries (each once per iteration of the
    loop around it, or once per microbatch at the top: the reference's
    enclosing trip product), **flops_per_iter** the mean FLOPs of an
    iteration, nested loops counted in full (the reference's
    ``_body_flops``);
  * a loop's **colls** are its collectives grouped by (label, kind, tier,
    bytes, overlappable, slack): one entry for each role the step's
    collectives play in an iteration, ``wire_bytes`` the bytes of the
    role per iteration, so that Σ ``wire_bytes × trip_count ×
    outer_mult`` over a loop's colls is its ``wire_bytes``, and over all
    loops ``in_loop_wire_bytes`` (:func:`check_wire`: an accounting
    identity, both sides from the same counts, which catches an issue the
    reading dropped or counted twice and nothing of the schedule).

A recorder or a reading raises on a step whose waits do not match its
issues or whose loops do not close: it never returns a partial dict.

On the card the order is the same, and the time is read from a profile
instead: :func:`measured_overlap` sums each label's issue and ``.wait``
ranges.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils import flop_counter

from repro_torch.core import collectives as cl
from repro_torch.obs.metrics import TIER_RANK
from repro_torch.tune.probe import STATIC_PROFILE_PATH
from repro_torch.tune.ring_model import PEAK


def _slowest_tier_bw() -> float:
    """Bytes/s a rank of the static profile's slowest tier."""
    with open(STATIC_PROFILE_PATH) as f:
        tiers = json.load(f)["tiers"]
    return min(float(t["bandwidth_Bps"]) for t in tiers.values())


# The canonical low-bandwidth operating point (the reference's, at the
# card's cluster's values): the bf16 peak of ``tune/ring_model.py`` and
# every tier priced at the static profile's slowest, ``pod`` (25 GB/s),
# as the reference prices all tiers at its slow interconnect.
RING_OPERATING_POINT = {
    "peak_flops": PEAK,
    "tier_bw": dict.fromkeys(TIER_RANK, _slowest_tier_bw()),
    "coll_latency_s": 20e-6,
}


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _heads_first(t: torch.Tensor, heads: int) -> Tuple[int, ...]:
    """(B, S, ·, hd) as sdpa's (B, heads, S, hd)."""
    return (t.shape[0], heads, t.shape[1], t.shape[3])


def _flash_fwd_flops(q, k, v, **_) -> float:
    H = q.shape[2]
    return float(flop_counter.sdpa_flop_count(
        _heads_first(q, H), _heads_first(k, H), _heads_first(v, H)))


def _flash_bwd_flops(q, k, v, out, m, l, dout, **_) -> float:
    H = q.shape[2]
    return float(flop_counter.sdpa_backward_flop_count(
        _heads_first(dout, H), _heads_first(q, H), _heads_first(k, H),
        _heads_first(v, H)))


def _dequant_matmul_flops(x, payload, *_, **__) -> float:
    return float(flop_counter.mm_flop(tuple(x.shape),
                                      tuple(payload.shape[::-1])))


# the kernel-seam calls that are compute, with their FLOPs
_SEAM_FLOPS: Dict[str, Callable[..., float]] = {
    "flash_fwd": _flash_fwd_flops, "flash_bwd": _flash_bwd_flops,
    "dequant_matmul": _dequant_matmul_flops}


def _matmul_flops(func, args, kwargs, out) -> float:
    formula = flop_counter.flop_registry.get(func.overloadpacket)
    if formula is None:
        raise ValueError(f"no FLOP formula for {func}")
    return float(formula(*args, **kwargs, out_val=out))


class StepRecorder:
    """Records one step as an ordered list of events (the module note):

      ``("issue", id, label, kind, wire bytes, tier)``, ``("wait", id)``,
      ``("compute", flops, op)``, ``("enter", loop name)``, ``("iter",)``
      (the innermost loop's next iteration begins), ``("exit",)``.

    Within it, ``collectives.RECORDER`` is this recorder: the collectives
    and the ring call its issue, wait and loop hooks.  The compute comes
    from whoever dispatches the step's ops (``trace_analysis.TraceCounter``
    calls :meth:`matmul` for every matmul op and :meth:`seam` for every
    kernel-seam call outside another).  On the way out it raises if an
    issue was never waited for or a loop never closed."""

    def __init__(self):
        self.events: List[tuple] = []
        self._open: Dict[int, Tuple[int, Any]] = {}
        self._next = 0
        self._depth = 0

    # -- the hooks of core/collectives.py and core/zeropp.ring ------------
    def issue(self, label: str, kind: str, nbytes, tier: str, work) -> None:
        if work is None:
            raise ValueError(f"{label}: an issue without its Work")
        iid = self._next
        self._next += 1
        self._open[id(work)] = (iid, work)
        self.events.append(("issue", iid, label, kind, float(nbytes), tier))

    def wait(self, work) -> None:
        got = self._open.pop(id(work), None)
        if got is None:
            raise ValueError("a wait on a collective this step did not "
                             "issue (or waited on twice)")
        self.events.append(("wait", got[0]))

    def loop_enter(self, name: str) -> None:
        self._depth += 1
        self.events.append(("enter", name))

    def loop_iter(self) -> None:
        if not self._depth:
            raise ValueError("a loop iteration outside any loop")
        self.events.append(("iter",))

    def loop_exit(self) -> None:
        if not self._depth:
            raise ValueError("a loop exit outside any loop")
        self._depth -= 1
        self.events.append(("exit",))

    # -- compute -------------------------------------------------------------
    def matmul(self, func, args, kwargs, out) -> None:
        """A matmul op (``trace_analysis._MATMUL``) ran."""
        self.events.append(("compute", _matmul_flops(func, args, kwargs, out),
                            func.overloadpacket.__name__))

    def seam(self, name: str, args, kwargs) -> None:
        """Kernel-seam function ``name`` ran: compute if B6, B7 or B8."""
        flops = _SEAM_FLOPS.get(name)
        if flops is not None:
            self.events.append(("compute", flops(*args, **kwargs), name))

    def __enter__(self):
        if cl.RECORDER is not None:
            raise RuntimeError("a step recorder is already recording")
        cl.RECORDER = self
        return self

    def __exit__(self, exc_type, exc, tb):
        cl.RECORDER = None
        if exc_type is None:
            if self._open:
                raise ValueError(f"{len(self._open)} collectives issued "
                                 f"and never waited for")
            if self._depth:
                raise ValueError(f"{self._depth} loops never closed")
        return False


# ---------------------------------------------------------------------------
# the structural reading
# ---------------------------------------------------------------------------

class _Frame:
    """One entry of a loop: its key, iterations begun, the position of
    each iteration's first compute event (None: none yet)."""

    __slots__ = ("key", "iters", "first")

    def __init__(self, key: str):
        self.key, self.iters, self.first = key, 0, []


def _walk(events: Sequence[tuple]):
    """One pass over ``events``: (issues {id: [pos, label, kind, bytes,
    tier, owner frame or None]}, waits {id: pos}, compute positions,
    loops {key: [entries, iterations, flops]})."""
    stack: List[_Frame] = []
    issues: Dict[int, list] = {}
    waits: Dict[int, int] = {}
    compute: List[int] = []
    loops: Dict[str, List[float]] = {}
    for pos, ev in enumerate(events):
        tag = ev[0]
        if tag == "issue":
            owner = next((f for f in reversed(stack) if f.iters), None)
            issues[ev[1]] = [pos, ev[2], ev[3], ev[4], ev[5], owner]
        elif tag == "wait":
            if ev[1] not in issues or ev[1] in waits:
                raise ValueError(f"wait {ev[1]} matches no open issue")
            waits[ev[1]] = pos
        elif tag == "compute":
            compute.append(pos)
            for f in stack:
                if f.iters:
                    loops[f.key][2] += ev[1]
                    if f.first[-1] is None:
                        f.first[-1] = pos
        elif tag == "enter":
            key = ev[1] if not stack else stack[-1].key + "/" + ev[1]
            if stack and not stack[-1].iters:
                raise ValueError(f"loop {key} entered in its parent's "
                                 f"prologue")
            stack.append(_Frame(key))
            loops.setdefault(key, [0, 0, 0.0])[0] += 1
        elif tag == "iter":
            if not stack:
                raise ValueError("an iteration outside any loop")
            f = stack[-1]
            f.iters += 1
            f.first.append(None)
            loops[f.key][1] += 1
        elif tag == "exit":
            if not stack:
                raise ValueError("a loop exit outside any loop")
            stack.pop()
        else:
            raise ValueError(f"unknown event {ev!r}")
    if stack:
        raise ValueError(f"loops {[f.key for f in stack]} never closed")
    missing = set(issues) - set(waits)
    if missing:
        raise ValueError(f"{len(missing)} collectives issued and never "
                         f"waited for")
    return issues, waits, compute, loops


def analyze_overlap(events: Sequence[tuple], multi_pod: bool = False
                    ) -> Dict[str, Any]:
    """The reference's ``analyze_overlap`` dict of a recorded step (the
    module note has the port's definitions):

      in_loop_wire_bytes, overlapped_wire_bytes, overlap_fraction (0.0
      with no in-loop collective), in_loop_collectives and
      overlappable_collectives (colls entries), per_loop {loop:
      trip_count, outer_mult, collectives, overlappable, wire_bytes,
      overlapped_wire_bytes, has_compute, flops_per_iter,
      max_slack_iters, colls [{op, label, wire_bytes (a iteration),
      overlappable, tier, slack_iters}]}, async_pairs (every issue, an
      issue and its wait) and async_pairs_enclosing_compute;

    and the port's own: out_of_loop_wire_bytes and wire_bytes (every
    issue's).  ``multi_pod`` states the world: a
    ``pod`` tier on a world without one raises."""
    issues, waits, compute, loops = _walk(events)
    roles: Dict[str, Dict[tuple, int]] = {}
    out_of_loop = enclosing = 0.0
    total = 0.0
    for iid, (pos, label, kind, nbytes, tier, owner) in issues.items():
        if tier == "pod" and not multi_pod:
            raise ValueError(f"{label}: a pod-tier collective on a world "
                             f"of one pod")
        end = waits[iid]
        # compute events strictly between the issue and its wait
        lo = bisect.bisect_right(compute, pos)
        over = bisect.bisect_left(compute, end) > lo
        enclosing += over
        total += nbytes
        if owner is None:
            out_of_loop += nbytes
            continue
        slack = 1
        if over:
            slack = max(1, sum(1 for p in owner.first
                               if p is not None and pos < p < end))
        sig = (label, kind, tier, nbytes, over, slack)
        r = roles.setdefault(owner.key, {})
        r[sig] = r.get(sig, 0) + 1
    per_loop: Dict[str, Dict[str, Any]] = {}
    in_loop = overlapped = 0.0
    n_coll = n_over = 0
    for key, sigs in roles.items():
        entries, iters, flops = loops[key]
        trips = iters // entries if iters % entries == 0 else iters / entries
        colls = [{"op": kind, "label": label,
                  "wire_bytes": nbytes * n / iters, "overlappable": over,
                  "tier": tier, "slack_iters": slack}
                 for (label, kind, tier, nbytes, over, slack), n
                 in sorted(sigs.items())]
        wire = sum(s[3] * n for s, n in sigs.items())
        over_b = sum(s[3] * n for s, n in sigs.items() if s[4])
        per_loop[key] = {
            "trip_count": trips, "outer_mult": entries,
            "collectives": len(colls),
            "overlappable": sum(c["overlappable"] for c in colls),
            "wire_bytes": wire, "overlapped_wire_bytes": over_b,
            "has_compute": flops > 0, "flops_per_iter": flops / iters,
            "max_slack_iters": max(c["slack_iters"] for c in colls),
            "colls": colls}
        in_loop += wire
        overlapped += over_b
        n_coll += len(colls)
        n_over += per_loop[key]["overlappable"]
    return {
        "in_loop_wire_bytes": in_loop,
        "overlapped_wire_bytes": overlapped,
        "overlap_fraction": (overlapped / in_loop) if in_loop else 0.0,
        "in_loop_collectives": n_coll,
        "overlappable_collectives": n_over,
        "per_loop": per_loop,
        "async_pairs": len(issues),
        "async_pairs_enclosing_compute": int(enclosing),
        "out_of_loop_wire_bytes": out_of_loop,
        "wire_bytes": total,
    }


def check_wire(ov: Dict[str, Any], counted: float) -> None:
    """The wire invariant of an :func:`analyze_overlap` dict: Σ over loops
    and colls of ``wire_bytes × trip_count × outer_mult`` is
    ``in_loop_wire_bytes``, and that plus ``out_of_loop_wire_bytes`` is
    ``counted``, the step's growth of the ``comm.<label>.bytes`` counters
    (equal to rounding: relative 1e-9).  Raises ValueError if not.  Both
    sides come from the same ``collectives._count`` calls, so it holds by
    construction: it catches a reading that dropped or double-counted an
    issue, not a schedule that exposes one."""
    folded = sum(c["wire_bytes"] * loop["trip_count"] * loop["outer_mult"]
                 for loop in ov["per_loop"].values() for c in loop["colls"])
    pairs = (("the colls folded", folded, ov["in_loop_wire_bytes"]),
             ("in loop + out of loop",
              ov["in_loop_wire_bytes"] + ov["out_of_loop_wire_bytes"],
              counted))
    for what, got, want in pairs:
        if not math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-6):
            raise ValueError(f"overlap wire invariant: {what} {got!r} != "
                             f"{want!r}")


# ---------------------------------------------------------------------------
# depth-credited overlap at an operating point (the reference's arithmetic)
# ---------------------------------------------------------------------------

def effective_overlap(ov: Dict, *, peak_flops: float,
                      tier_bw: Dict[str, float],
                      coll_latency_s: float = 0.0) -> Dict:
    """Ring-depth-credited overlap fraction at an explicit operating point
    (the reference's ``effective_overlap``, line for line): a collective
    issued d iterations early (``slack_iters``) has d iterations of body
    compute to complete in,

        t_window = min(d, trips) · flops_per_iter / peak_flops
        t_comm   = coll_latency_s + wire / tier_bw[tier]
        hidden   = wire · min(1, t_window / t_comm)

    Exposed collectives hide nothing.  ``ov`` is an
    :func:`analyze_overlap` result."""
    total = hidden = 0.0
    for loop in ov["per_loop"].values():
        weight = loop["trip_count"] * loop["outer_mult"]
        t_iter = loop["flops_per_iter"] / peak_flops
        for c in loop["colls"]:
            wire = c["wire_bytes"] * weight
            total += wire
            if not c["overlappable"] or c["wire_bytes"] <= 0:
                continue
            bw = tier_bw.get(c["tier"], min(tier_bw.values()))
            t_comm = coll_latency_s + c["wire_bytes"] / bw
            window = min(c["slack_iters"], loop["trip_count"]) * t_iter
            hidden += wire * (1.0 if t_comm <= 0.0
                              else min(1.0, window / t_comm))
    return {
        "effective_overlap_fraction": (hidden / total) if total else 0.0,
        "hidden_wire_bytes": hidden,
        "in_loop_wire_bytes": total,
        "operating_point": {"peak_flops": peak_flops, "tier_bw": tier_bw,
                            "coll_latency_s": coll_latency_s},
    }


def summary_line(ov: Dict[str, Any]) -> str:
    """The reference's dry-run overlap line (``dryrun.py:658-666``)."""
    loops = ov.get("per_loop", {})
    nested = sum(1 for d in loops.values() if d.get("outer_mult", 1) > 1)
    slack = max((d.get("max_slack_iters", 1) for d in loops.values()),
                default=1)
    return (f"overlap: fraction={ov['overlap_fraction']:.3f} "
            f"({ov['overlappable_collectives']}/{ov['in_loop_collectives']}"
            f" in-loop collectives over {len(loops)} loops, {nested} "
            f"nested; max ring slack={slack} iters; "
            f"async pairs={ov['async_pairs']})")


# ---------------------------------------------------------------------------
# the card's reading: a profile's issue and wait ranges
# ---------------------------------------------------------------------------

def _is_label(name: str) -> bool:
    return name.startswith("zero.") or name == "other"


def measured_overlap(profiler_events: Iterable[Tuple[str, float, float]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per collective label (``zero.*`` and ``other``), from a profile's
    host ranges ``(name, start µs, end µs)`` (``obs.trace.annotate``'s
    ``<label>`` around each issue and ``<label>.wait`` around each wait):

      ``n`` issues, ``in_flight_ms`` (Σ over issues of the issue's start
      to its wait's end: Σ wait ends − Σ issue starts), ``exposed_ms``
      (Σ of the waits' lengths) and ``hidden_share`` = 1 − exposed / in
      flight.

    Both are sums, the same however issues and waits pair up, so no
    pairing is made.  Raises where a label's issues and waits differ in
    number or its i-th wait starts before its i-th issue (no order of the
    step gives that)."""
    spans: Dict[str, Tuple[list, list]] = {}
    for name, t0, t1 in profiler_events:
        wait = name.endswith(".wait")
        label = name[:-len(".wait")] if wait else name
        if _is_label(label):
            spans.setdefault(label, ([], []))[wait].append((t0, t1))
    out: Dict[str, Dict[str, float]] = {}
    for label, (iss, wts) in sorted(spans.items()):
        if len(iss) != len(wts):
            raise ValueError(f"{label}: {len(iss)} issues against "
                             f"{len(wts)} waits")
        for (a0, _), (w0, _) in zip(sorted(iss), sorted(wts)):
            if w0 < a0:
                raise ValueError(f"{label}: a wait at {w0} before its "
                                 f"issue at {a0}")
        flight = sum(w1 for _, w1 in wts) - sum(a0 for a0, _ in iss)
        exposed = sum(w1 - w0 for w0, w1 in wts)
        out[label] = {"n": len(iss), "in_flight_ms": flight / 1e3,
                      "exposed_ms": exposed / 1e3,
                      "hidden_share": 1.0 - exposed / flight if flight
                      else 0.0}
    return out
