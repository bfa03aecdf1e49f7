"""BENCH snapshot export, snapshot diffing, and the measured-vs-projected
gate.  The port's copy of the reference's ``obs/report.py``.

* :func:`export_snapshot` — the metrics registry as one BENCH json
  section (``{section: {"metrics": {...}, **extra}}``), optionally
  written to disk.
* :func:`bench_diff` — leaf-by-leaf relative drift between two BENCH
  docs; also a CLI:
  ``python -m repro_torch.obs.report diff OLD.json NEW.json [--rel-tol
  0.05] [--fail-on-drift]``.
* The gate — :func:`comm_gate` holds measured per-step wire bytes per
  collective label against the analytic projection
  (:func:`projected_wire_by_label`: ``Model.comm_events`` folded through
  ``zeropp.step_wire_by_label``) at 1 %; :func:`overhead_gate` holds the
  telemetry-disabled step time against a plain one (medians of
  alternating samples); :func:`runtime_gate` joins them.  The port
  measures bytes where each collective is issued
  (``core/collectives.py``), the reference walks its jaxpr; both sides
  count the same program, so the bytes agree exactly and 1 % is slack.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Registry, get_registry

__all__ = ["export_snapshot", "bench_diff", "format_diff",
           "comm_gate", "overhead_gate", "runtime_gate",
           "projected_wire_by_label", "GateFailure"]


class GateFailure(AssertionError):
    """A measured-vs-projected check exceeded its tolerance."""


# ---------------------------------------------------------------------------
# snapshot export
# ---------------------------------------------------------------------------

def export_snapshot(path: Optional[str] = None, *,
                    registry: Optional[Registry] = None,
                    section: str = "runtime",
                    extra: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Registry -> ``{section: {"metrics": <flat snapshot>, **extra}}``,
    written to ``path`` when one is given."""
    reg = registry if registry is not None else get_registry()
    body: Dict[str, Any] = {"metrics": reg.snapshot()}
    if extra:
        body.update(extra)
    doc = {section: body}
    if path:
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return doc


# ---------------------------------------------------------------------------
# snapshot diff
# ---------------------------------------------------------------------------

def _leaves(doc: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(doc, dict):
        out: Dict[str, Any] = {}
        for k, v in doc.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: doc}


def _number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def bench_diff(old: Mapping[str, Any], new: Mapping[str, Any], *,
               rel_tol: float = 0.05
               ) -> List[Tuple[str, Any, Any, Optional[float]]]:
    """Rows ``(key, old, new, rel)`` for every leaf that drifted beyond
    ``rel_tol`` (numbers), changed (anything else), or exists on one side
    only (the missing side None, rel None)."""
    a, b = _leaves(dict(old)), _leaves(dict(new))
    rows: List[Tuple[str, Any, Any, Optional[float]]] = []
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        if key not in a or key not in b:
            rows.append((key, va, vb, None))
        elif _number(va) and _number(vb):
            rel = abs(va - vb) / max(abs(va), abs(vb), 1e-12)
            if rel > rel_tol:
                rows.append((key, va, vb, rel))
        elif va != vb:
            rows.append((key, va, vb, None))
    return rows


def format_diff(rows: Sequence[Tuple[str, Any, Any, Optional[float]]]) -> str:
    if not rows:
        return "no drift"
    lines = []
    for key, va, vb, rel in rows:
        tail = f"  rel={rel:.3f}" if rel is not None else ""
        lines.append(f"  {key}: {va!r} -> {vb!r}{tail}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# measured-vs-projected gate
# ---------------------------------------------------------------------------

def projected_wire_by_label(model: Any, sizes: Mapping[str, int],
                            accum: int = 1) -> Dict[str, float]:
    """Analytic per-step, per-rank wire bytes by collective label, from the
    schedule's events (``Model.comm_events``)."""
    from repro_torch.core.zeropp import step_wire_by_label
    return step_wire_by_label(model.comm_events(accum=accum), model.zcfg,
                              dict(sizes))


def comm_gate(measured: Mapping[str, float], projected: Mapping[str, float],
              *, tol: float = 0.01, ignore: Sequence[str] = ("other",)
              ) -> Dict[str, Any]:
    """Per-label relative comparison of measured and projected per-step
    wire bytes.  ``other`` (the collectives outside the ZeRO engine) is
    reported but not gated: the projection carries no such events."""
    rows: Dict[str, Dict[str, float]] = {}
    ok = True
    for lbl in sorted(set(measured) | set(projected)):
        m = float(measured.get(lbl, 0.0))
        p = float(projected.get(lbl, 0.0))
        rel = abs(m - p) / max(m, p, 1.0)
        passed = rel <= tol or lbl in ignore
        ok = ok and passed
        rows[lbl] = {"measured": m, "projected": p, "rel": rel,
                     "pass": passed}
    return {"ok": ok, "tol": tol, "labels": rows}


def _median(xs: Sequence[float]) -> float:
    if not xs:
        raise ValueError("no samples")
    ys = sorted(float(x) for x in xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


def overhead_gate(enabled_s: Sequence[float], disabled_s: Sequence[float],
                  *, tol: float = 0.02) -> Dict[str, Any]:
    """Median step time with telemetry DISABLED (``disabled_s``) against
    plain steps (``enabled_s``, the reference's name for them): within
    ``tol``, or faster.  The samples should alternate, so that machine
    noise lands on both sides."""
    med_e = _median(enabled_s)
    med_d = _median(disabled_s)
    rel = (med_d - med_e) / max(med_e, 1e-12)
    return {"ok": rel <= tol or med_d <= med_e, "tol": tol,
            "median_enabled_s": med_e, "median_disabled_s": med_d,
            "rel_overhead": rel}


def runtime_gate(*, measured: Mapping[str, float],
                 projected: Mapping[str, float],
                 enabled_s: Optional[Sequence[float]] = None,
                 disabled_s: Optional[Sequence[float]] = None,
                 comm_tol: float = 0.01, overhead_tol: float = 0.02,
                 strict: bool = False) -> Dict[str, Any]:
    """The combined gate report; ``strict=True`` raises
    :class:`GateFailure` listing every failing check instead of returning
    ``ok=False``."""
    report: Dict[str, Any] = {"comm": comm_gate(measured, projected,
                                                tol=comm_tol)}
    if enabled_s and disabled_s:
        report["overhead"] = overhead_gate(enabled_s, disabled_s,
                                           tol=overhead_tol)
    report["ok"] = all(sec["ok"] for sec in report.values()
                       if isinstance(sec, dict))
    if strict and not report["ok"]:
        bad = [f"comm[{lbl}]: measured={row['measured']:.0f} "
               f"projected={row['projected']:.0f} "
               f"rel={row['rel']:.4f} > {comm_tol}"
               for lbl, row in report["comm"]["labels"].items()
               if not row["pass"]]
        ov = report.get("overhead")
        if ov and not ov["ok"]:
            bad.append(f"overhead: disabled median "
                       f"{ov['median_disabled_s']:.6f}s vs baseline "
                       f"{ov['median_enabled_s']:.6f}s (rel "
                       f"{ov['rel_overhead']:.4f} > {overhead_tol})")
        raise GateFailure("measured-vs-projected gate failed:\n  "
                          + "\n  ".join(bad))
    return report


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.report")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff", help="compare two BENCH snapshots")
    d.add_argument("old")
    d.add_argument("new")
    d.add_argument("--rel-tol", type=float, default=0.05)
    d.add_argument("--fail-on-drift", action="store_true")
    args = ap.parse_args(argv)
    with open(args.old) as fh:
        old = json.load(fh)
    with open(args.new) as fh:
        new = json.load(fh)
    rows = bench_diff(old, new, rel_tol=args.rel_tol)
    print(format_diff(rows))
    return 1 if (rows and args.fail_on_drift) else 0


if __name__ == "__main__":
    sys.exit(main())
