"""The ring step-time model the resolver picks a prefetch depth with.

The port's own copy of what ``resolve`` needs of the reference's
analytic throughput model (``benchmarks/throughput_model.py``:
``comm_bytes_per_step``, ``step_time_ring``, ``break_even_depth``), the
same arithmetic.  The reference imports these from its benchmarks tree
and falls back to depth 1 where that tree is missing; the port imports
nothing of it, so it always has this copy.

A depth-k ring gives each gather a window of k layers' compute to finish
in, so per layer the exposed residue is

    exposed_l = max(0, c_bw - t_layer, c_bw + n_coll·alpha - depth·t_layer)

(``c_bw`` the hideable bandwidth time of a layer): depth never beats the
per-layer bandwidth steady state, but it amortizes the per-collective
latency.  The resolver feeds the probe's measured (or the static
profile's) bandwidths and latency into ``slow_bw``, ``fast_bw`` and
``latency``; the constants below are only the defaults.
"""
from __future__ import annotations

from typing import Dict

# bf16 dense tensor-core peak of one NVIDIA H100 SXM, flop/s (the rate
# PERF.md's kernel bounds use)
PEAK = 989.4e12
# NVLink 4 per direction per H100 GPU (DGX H100): the fast-tier default
FAST_BW = 450e9
# the share of a step's collective bytes that the prefetched schedule
# hides under compute.  Not a rate: a fraction the reference measured from
# its own compiled step's HLO on the CPU (gpt-350m reduced, zeropp,
# prefetch 1; benchmarks/throughput_model.py MEASURED_OVERLAP).  The port
# has no reading of its own yet (a torch.profiler trace of the card's
# step would give one).
MEASURED_OVERLAP = 0.89
# per-collective fixed cost (launch + round trip), seconds: an assumed
# default; the resolver passes the profile's latency instead
COLL_LATENCY = 20e-6
# collectives issued per layer per step under full ZeRO++ (the qwZ
# gather, the hpZ gather and the qgZ hops)
COLLS_PER_LAYER = 4


def comm_bytes_per_step(n_params: int, variant: str) -> Dict[str, float]:
    """Slow/fast-tier wire bytes of one step, M = 2·n_params bf16 bytes
    (the paper's Table 1 accounting)."""
    M = 2.0 * n_params
    if variant == "baseline":
        return {"slow": 3.0 * M, "fast": 0.0}
    if variant == "qwz":
        return {"slow": 0.5 * M + 0.5 * M + M, "fast": 0.0}
    if variant == "hpz":
        return {"slow": 2.0 * M, "fast": M}
    if variant == "qgz":
        return {"slow": 2.0 * M + 0.25 * M, "fast": 0.25 * M}
    if variant == "zeropp":
        return {"slow": 0.5 * M + 0.25 * M, "fast": M + 0.25 * M}
    raise ValueError(variant)


def step_time_ring(n_params: int, tokens_dev: int, variant: str,
                   slow_bw: float, depth: int, n_layers: int = 48,
                   overlap: float = MEASURED_OVERLAP,
                   latency: float = COLL_LATENCY,
                   colls_per_layer: int = COLLS_PER_LAYER,
                   fast_bw: float = FAST_BW) -> float:
    """Step time under a depth-``depth`` prefetch ring (0: the synchronous
    schedule)."""
    c = 8.0 * n_params * tokens_dev / PEAK
    b = comm_bytes_per_step(n_params, variant)
    t_comm = b["slow"] / slow_bw + b["fast"] / fast_bw
    t_lat = colls_per_layer * latency * n_layers
    if depth < 1:
        return c + t_comm + t_lat
    t_layer = c / n_layers
    c_bw = overlap * t_comm / n_layers
    t_l = overlap * colls_per_layer * latency
    exposed_l = max(0.0, c_bw - t_layer, c_bw + t_l - depth * t_layer)
    return (c + n_layers * exposed_l
            + (1.0 - overlap) * (t_comm + t_lat))


def break_even_depth(n_params: int, tokens_dev: int, variant: str,
                     slow_bw: float, n_layers: int = 48,
                     overlap: float = MEASURED_OVERLAP,
                     latency: float = COLL_LATENCY,
                     colls_per_layer: int = COLLS_PER_LAYER,
                     fast_bw: float = FAST_BW) -> int:
    """Smallest ring depth after which deepening stops paying (capped at
    n_layers-1, the ring's clamp)."""
    d = 1
    while d < n_layers - 1:
        t_now = step_time_ring(n_params, tokens_dev, variant, slow_bw, d,
                               n_layers, overlap, latency, colls_per_layer,
                               fast_bw)
        t_next = step_time_ring(n_params, tokens_dev, variant, slow_bw,
                                d + 1, n_layers, overlap, latency,
                                colls_per_layer, fast_bw)
        if t_next >= t_now - 1e-12:
            return d
        d += 1
    return d
