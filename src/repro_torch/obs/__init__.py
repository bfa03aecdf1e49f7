"""Runtime telemetry: metrics, tracing, and measured-vs-projected reports.

The port's own copy of the reference's ``obs`` package, layered so that
the import graph stays acyclic:

  ``obs.metrics``  stdlib-only counters/gauges/histograms behind a process
                   registry (safe to import from ``kernels/ops.py`` and
                   ``core/collectives.py``).
  ``obs.trace``    span/event tracer with a host-side jsonl log, and
                   ``annotate()``, the ``torch.profiler`` range each
                   collective's issue and wait run under.
  ``obs.report``   BENCH snapshot export, ``bench_diff`` and the
                   measured-vs-projected gate.

Disabled, the tracer hands out one shared ``nullcontext``; the byte
counters cost one dict lookup and an add per collective.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     get_registry, set_registry)
from repro_torch.obs.trace import (Tracer, annotate, get_tracer, set_tracer,
                                   replay_counters)
from repro_torch.obs.report import (GateFailure, bench_diff, comm_gate,
                                    export_snapshot, overhead_gate,
                                    projected_wire_by_label, runtime_gate)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "get_registry", "set_registry",
    "Tracer", "annotate", "get_tracer", "set_tracer", "replay_counters",
    "GateFailure", "bench_diff", "comm_gate", "export_snapshot",
    "overhead_gate", "projected_wire_by_label", "runtime_gate",
]
