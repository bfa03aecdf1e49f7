"""Sliding-window histogram (the port's own copy of the reference's
``obs/metrics.Histogram``, which it cannot import: the reference's
``obs`` package pulls in JAX)."""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Sequence, Union


class Histogram:
    """Keeps the last ``window`` observations plus the lifetime count and
    computes exact nearest-rank percentiles on demand."""

    __slots__ = ("name", "window", "samples", "count")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self.window = window
        self.samples: deque = deque(maxlen=window)
        self.count = 0

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        self.samples.append(v)
        self.count += 1

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
