"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of the reference's ``obs/metrics.py`` (pure Python,
but the port imports nothing of the reference).  Stdlib only, so every
layer — ``kernels/ops.py`` and ``core/collectives.py`` included — can
count without an import cycle.  All instruments are host-side Python
objects: an increment is one dict lookup plus an add.

Names are dot-separated, ``<subsystem>.<noun>[.<qual>]``:

  train.step.wall_ms        histogram   per-step wall time
  train.steps / train.tokens  counter   monotone progress
  comm.<label>.bytes        counter     cumulative wire bytes per collective
                                        label (zero.qwz_gather, ..., other),
                                        counted where the collective is
                                        issued (``core/collectives.py``)
  comm.tier.<tier>.bytes    counter     the same bytes by interconnect tier
                                        (:func:`tier` of the group's axes:
                                        model, data or pod); the ``other``
                                        label's share of a tier also in
                                        ``comm.tier.<tier>.other.bytes``
  kernels.dispatch.<op>.<route>  counter  the kernel seam's routes
                                        (``kernels/ops.py``: cuda or torch),
                                        with telemetry on
  tune.<knob>               gauge       the run's ZeroConfig knobs
  serve.ttft_ms / serve.tok_latency_ms  histogram  sliding-window latency
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Sequence, Union

# The interconnect tiers, fastest first: a collective over several mesh
# axes crosses the slowest of them (the reference's
# ``launch/jaxpr_analysis.py`` ``_TIER_RANK``).
TIER_RANK = {"model": 0, "data": 1, "pod": 2}


def tier(axes: Sequence[str]) -> str:
    """The tier a collective over ``axes`` crosses: the slowest of them in
    the order ``model`` < ``data`` < ``pod`` (``model`` for no axis; an
    axis outside the table counts as ``model``), the reference's
    ``_tier``."""
    best = "model"
    for a in axes:
        if TIER_RANK.get(a, 0) > TIER_RANK[best]:
            best = a
    return best


class Counter:
    """Monotone counter; ``reset`` is the only way down."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, delta: Union[int, float] = 1) -> None:
        self.value += delta

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Union[int, float, None] = None

    def set(self, value: Union[int, float]) -> None:
        self.value = value


class Histogram:
    """Sliding-window histogram: the last ``window`` observations plus the
    lifetime count, sum, min and max; exact nearest-rank percentiles on
    demand."""

    __slots__ = ("name", "window", "samples", "count", "total",
                 "min", "max")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self.window = window
        self.samples: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        self.samples.append(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> Optional[float]:
        """Exact percentile over the current window (nearest-rank)."""
        if not self.samples:
            return None
        xs = sorted(self.samples)
        i = min(len(xs) - 1, max(0, int(round((p / 100.0) * (len(xs) - 1)))))
        return xs[i]

    def quantiles(self, ps: Sequence[float] = (50, 90, 99)
                  ) -> Dict[str, Optional[float]]:
        """{"p50": ..., "p90": ..., ..., "n": lifetime count} over the
        window (None when empty) — the shape ``ServeEngine.stats()``
        publishes."""
        if not self.samples:
            return {**{f"p{g:g}": None for g in ps}, "n": 0}
        xs = sorted(self.samples)
        n = len(xs)
        out: Dict[str, Optional[float]] = {}
        for p in ps:
            i = min(n - 1, max(0, int(round((p / 100.0) * (n - 1)))))
            out[f"p{p:g}"] = xs[i]
        out["n"] = self.count
        return out

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        return {"count": self.count, "mean": self.mean, "min": self.min,
                "max": self.max, "p50": self.percentile(50),
                "p90": self.percentile(90), "p99": self.percentile(99)}


class Registry:
    """Create-on-first-use instrument registry (thread-safe creation;
    updates are plain attribute writes)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, window: int = 512) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, window))
        return h

    def snapshot(self) -> Dict[str, object]:
        """Flat {name: value-or-summary} dict in a stable key order;
        histograms expand to their summary, unset gauges are left out."""
        out: Dict[str, object] = {}
        for n in sorted(self._counters):
            out[n] = self._counters[n].value
        for n in sorted(self._gauges):
            if self._gauges[n].value is not None:
                out[n] = self._gauges[n].value
        for n in sorted(self._hists):
            out[n] = self._hists[n].summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_process = Registry()
_default = _process


def get_registry() -> Registry:
    return _default


def set_registry(registry: Registry) -> Registry:
    """Swap the process default (tests); returns the previous one."""
    global _default
    old, _default = _default, registry
    return old


def count_dispatch(op: str, route: str) -> None:
    """The kernel seam's hook (``kernels/ops.py``): one counter per (op,
    route).  The port runs eagerly and calls this on every kernel call (the
    reference counts once per trace), so it counts only into a registry
    that telemetry (``--metrics-dir``) or a test installed with
    :func:`set_registry`: with telemetry off nothing reads these counters,
    and a call costs one comparison."""
    if _default is not _process:
        _default.counter(f"kernels.dispatch.{op}.{route}").inc()
