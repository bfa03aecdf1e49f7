"""Span/event tracer with a host-side jsonl log, and collective labels.

The port's copy of the reference's ``obs/trace.py``:

* **Host spans/events** (``Tracer.span`` / ``.event`` / ``.counter``):
  context managers stamping ``time.monotonic_ns()``, buffered and flushed
  to an append-mode jsonl file at step boundaries (``flush()``).  They
  open no profiler range (the reference's ``profiler_annotations`` opens
  a ``jax.profiler.TraceAnnotation``): the launcher puts each step in an
  :func:`annotate` range of its own, on or off.
* **Collective labels** (:func:`annotate`): a ``record_function`` range
  around the issue and the wait of every collective in
  ``core/collectives.py`` (``zero.<op>`` and ``zero.<op>.wait``), so a
  torch.profiler trace shows the host time each label takes.  The
  reference's ``annotate`` is a ``jax.named_scope`` that its jaxpr walk
  reads; the port counts bytes where it issues a collective instead.

Replay: every flush ends in ``os.fsync``; a kill can at worst truncate
the last line, which :func:`read_events` skips.  Counter records carry
their step, and :func:`replay_counters` keeps the last record of each
``(name, step)``, so a log that re-emits steps replays to the same totals.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, IO, List, Optional, Tuple

import torch

_NULLCTX = contextlib.nullcontext()


def annotate(label: str):
    """A profiler range named ``label`` (``torch.profiler.record_function``:
    free unless a profiler is recording)."""
    return torch.profiler.record_function(label)


class _Span:
    """Enabled-path span: stamps monotonic ns, appends one record on exit."""

    __slots__ = ("_tracer", "_name", "_tags", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._tags = tags

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic_ns() - self._t0
        rec = {"kind": "span", "name": self._name,
               "t_ns": self._t0, "dur_ns": dur}
        if self._tags:
            rec.update(self._tags)
        self._tracer._emit(rec)
        return False


class Tracer:
    """Buffered jsonl tracer.  ``enabled=False`` makes every call a no-op
    (spans return one shared ``nullcontext``: no allocation)."""

    def __init__(self, path: Optional[str] = None, *, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self._buf: List[str] = []
        self._fh: Optional[IO[str]] = None

    def span(self, name: str, **tags):
        if not self.enabled:
            return _NULLCTX
        return _Span(self, name, tags)

    def event(self, name: str, **tags) -> None:
        if not self.enabled:
            return
        rec = {"kind": "event", "name": name, "t_ns": time.monotonic_ns()}
        rec.update(tags)
        self._emit(rec)

    def counter(self, name: str, value, step: Optional[int] = None,
                **tags) -> None:
        """A replayable counter sample: records with a step are deduped
        per (name, step) on replay, those without are summed."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"kind": "counter", "name": name,
                               "t_ns": time.monotonic_ns(), "value": value}
        if step is not None:
            rec["step"] = step
        rec.update(tags)
        self._emit(rec)

    def _emit(self, rec: Dict[str, Any]) -> None:
        self._buf.append(json.dumps(rec, sort_keys=True))

    def flush(self) -> None:
        """Step-boundary flush: one write and one fsync for everything
        buffered (with no path the buffer is dropped)."""
        if self.path is None:
            self._buf.clear()
            return
        if not self._buf:
            return
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write("\n".join(self._buf) + "\n")
        self._buf.clear()
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


_disabled = Tracer(enabled=False)
_current: Tracer = _disabled


def get_tracer() -> Tracer:
    return _current


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install the process tracer (None restores the disabled singleton);
    returns the previous one."""
    global _current
    old = _current
    _current = tracer if tracer is not None else _disabled
    return old


def read_events(path: str) -> List[Dict[str, Any]]:
    """All records in file order; a truncated last line is skipped."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def replay_counters(path: str, up_to_step: Optional[int] = None
                    ) -> Dict[str, float]:
    """The event log's counter totals: stepped records deduped per (name,
    step), the last occurrence winning, and only up to ``up_to_step``;
    unstepped records summed in file order."""
    stepped: Dict[Tuple[str, int], float] = {}
    flat: Dict[str, float] = {}
    for rec in read_events(path):
        if rec.get("kind") != "counter":
            continue
        name = rec["name"]
        step = rec.get("step")
        value = rec.get("value", 0)
        if step is None:
            flat[name] = flat.get(name, 0) + value
        elif up_to_step is None or step <= up_to_step:
            stepped[(name, step)] = value
    totals = dict(flat)
    for (name, _), value in stepped.items():
        totals[name] = totals.get(name, 0) + value
    return totals
