"""Port vs reference: the telemetry modules (``obs/metrics``, ``obs/trace``,
``obs/report``) on the same inputs give the same results.

Each case of ``tests/test_obs.py`` that needs no JAX computation runs the
same calls on the port's module and on the reference's and requires
equal outputs (timestamps and durations aside), plus the reference's own
assertions; a log written by either tracer is replayed by both.  The
kernel seam's dispatch count runs through the port's ``kernels/ops.py``
on the CPU, where every op takes the plain version (route ``torch``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json                                                  # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch import obs as tobs                          # noqa: E402
from repro_torch.obs import metrics as tmetrics              # noqa: E402
from repro_torch.obs import report as treport                # noqa: E402
from repro_torch.obs import trace as ttrace                  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    """The reference's three modules."""
    from repro.obs import metrics, report, trace
    return dict(metrics=metrics, report=report, trace=trace)


def _both(ref):
    return (("port", tmetrics, ttrace, treport),
            ("ref", ref["metrics"], ref["trace"], ref["report"]))


def _untimed(recs):
    return [{k: v for k, v in r.items() if k not in ("t_ns", "dur_ns")}
            for r in recs]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_gauge_basics(ref):
    seen = []
    for _, m, _, _ in _both(ref):
        c = m.Counter("x")
        c.inc()
        c.inc(2.5)
        v = c.value
        c.reset()
        g = m.Gauge("y")
        unset = g.value
        g.set(1)
        g.set(7)
        seen.append((v, c.value, unset, g.value))
    assert seen[0] == seen[1] == (3.5, 0, None, 7)


@pytest.mark.parametrize("window", (1, 4, 512))
def test_histogram_window_and_percentiles(ref, window):
    rng = np.random.default_rng(window)
    xs = [1, 2, 3, 4, 100] + list(rng.standard_normal(37))
    out = []
    for _, m, _, _ in _both(ref):
        h = m.Histogram("h", window=window)
        for v in xs:
            h.observe(v)
        out.append((h.summary(), [h.percentile(p) for p in (0, 37.5, 50,
                                                            99, 100)],
                    h.quantiles((50, 90, 99.9)), h.mean, h.count))
        assert m.Histogram("e").percentile(50) is None
        assert m.Histogram("e").mean is None
    assert out[0] == out[1]
    h4 = tmetrics.Histogram("h", window=4)
    for v in (1, 2, 3, 4, 100):
        h4.observe(v)
    assert h4.count == 5 and h4.min == 1 and h4.max == 100
    assert h4.percentile(50) == 4 and h4.percentile(0) == 2
    assert h4.summary()["p99"] == 100


def test_histogram_quantiles_match_numpy(ref):
    rng = np.random.default_rng(3)
    xs = rng.permutation(101).astype(float)
    qs = []
    for _, m, _, _ in _both(ref):
        h = m.Histogram("q", window=256)
        for v in xs:
            h.observe(v)
        q = h.quantiles((50, 90, 99))
        assert q["n"] == 101
        for p in (50, 90, 99):
            assert q[f"p{p}"] == np.percentile(xs, p, method="nearest")
        assert set(m.Histogram("e").quantiles()) == {"p50", "p90", "p99",
                                                     "n"}
        qs.append(q)
    assert qs[0] == qs[1]


def test_registry_create_on_use_and_snapshot(ref):
    snaps = []
    for _, m, _, _ in _both(ref):
        r = m.Registry()
        r.counter("a.n").inc(3)
        r.gauge("b.g").set(1.5)
        r.gauge("b.unset")
        r.histogram("c.h").observe(2.0)
        snaps.append(r.snapshot())
        assert r.counter("a.n") is r.counter("a.n")
        r.reset()
        assert r.snapshot() == {}
    assert snaps[0] == snaps[1]
    assert snaps[0]["a.n"] == 3 and "b.unset" not in snaps[0]
    assert snaps[0]["c.h"]["count"] == 1 and snaps[0]["c.h"]["p50"] == 2.0


def test_set_registry_swaps_process_default():
    mine = tmetrics.Registry()
    old = tmetrics.set_registry(mine)
    try:
        tmetrics.count_dispatch("op", "torch")
        assert mine.counter("kernels.dispatch.op.torch").value == 1
        assert tmetrics.get_registry() is mine
        assert tobs.get_registry() is mine
    finally:
        tmetrics.set_registry(old)
    assert tmetrics.get_registry() is old


def test_kernel_dispatch_counts_routing():
    """The seam counts each call's route once: ``torch`` for a CPU tensor
    (the plain version)."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops
    mine = tmetrics.Registry()
    old = tmetrics.set_registry(mine)
    try:
        cfg = QuantConfig(bits=8, block_size=64)
        p, s = ops.quantize_blockwise(torch.ones(256), cfg)
        ops.dequantize_blockwise(p, s, cfg)
        c4 = QuantConfig(bits=4, block_size=64)
        p4, s4 = ops.quantize_reordered(torch.ones(2, 2, 64), c4)
        ops.dequant_reduce(p4.reshape(2, -1), s4.reshape(2, -1), c4)
        ops.dequant_reduce(p4.reshape(2, -1), s4.reshape(2, -1), c4)
        snap = mine.snapshot()
    finally:
        tmetrics.set_registry(old)
    assert snap == {"kernels.dispatch.dequant_reduce.torch": 2,
                    "kernels.dispatch.dequantize_blockwise.torch": 1,
                    "kernels.dispatch.quantize_blockwise.torch": 1,
                    "kernels.dispatch.quantize_reordered.torch": 1}


def test_dispatch_is_counted_only_into_an_installed_registry():
    """With telemetry off (the process's own registry) the seam counts no
    route: nothing reads those counters, and the port calls the seam on
    every kernel call."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops
    before = tmetrics.get_registry().snapshot()
    ops.quantize_blockwise(torch.ones(256), QuantConfig(bits=8,
                                                        block_size=64))
    tmetrics.count_dispatch("op", "torch")
    assert tmetrics.get_registry().snapshot() == before
    assert not any(k.startswith("kernels.dispatch.") for k in before)


# ---------------------------------------------------------------------------
# tracer + replay
# ---------------------------------------------------------------------------

def _roundtrip_log(trace_mod, path):
    tr = trace_mod.Tracer(path)
    with tr.span("train.step", step=0, layer=3):
        pass
    tr.event("elastic.restart", attempt=1)
    tr.counter("train.steps", 1, step=0)
    tr.counter("bytes", 10)
    tr.counter("bytes", 5)
    tr.flush()
    tr.close()


def test_tracer_roundtrip(ref, tmp_path):
    logs = {}
    for name, _, tr, _ in _both(ref):
        p = str(tmp_path / f"{name}.jsonl")
        _roundtrip_log(tr, p)
        logs[name] = p
    # each log read and replayed by both sides
    for p in logs.values():
        recs = [tr.read_events(p) for _, _, tr, _ in _both(ref)]
        assert recs[0] == recs[1]
        assert [r["kind"] for r in recs[0]] == ["span", "event", "counter",
                                                "counter", "counter"]
        assert recs[0][0]["layer"] == 3 and recs[0][0]["dur_ns"] >= 0
        assert [tr.replay_counters(p) for _, _, tr, _ in _both(ref)] == \
            [{"train.steps": 1, "bytes": 15}] * 2
    assert _untimed(ttrace.read_events(logs["port"])) == \
        _untimed(ttrace.read_events(logs["ref"]))


def test_tracer_disabled_is_noop(tmp_path):
    p = str(tmp_path / "never.jsonl")
    tr = ttrace.Tracer(p, enabled=False)
    s1, s2 = tr.span("a"), tr.span("b", step=1)
    assert s1 is s2
    with s1:
        pass
    tr.event("x")
    tr.counter("c", 1, step=0)
    tr.flush()
    tr.close()
    assert not os.path.exists(p)
    assert ttrace.get_tracer().span("y") is s1


def test_tracer_append_mode_extends(ref, tmp_path):
    for name, _, tr, _ in _both(ref):
        p = str(tmp_path / f"{name}.jsonl")
        t1 = tr.Tracer(p)
        t1.counter("train.steps", 1, step=0)
        t1.close()
        t2 = tr.Tracer(p)
        t2.counter("train.steps", 1, step=0)
        t2.counter("train.steps", 1, step=1)
        t2.close()
        assert len(tr.read_events(p)) == 3
        assert tr.replay_counters(p) == {"train.steps": 2}


def test_read_events_skips_truncated_line(ref, tmp_path):
    p = str(tmp_path / "ev.jsonl")
    tr = ttrace.Tracer(p)
    tr.counter("n", 1, step=0)
    tr.close()
    with open(p, "a") as fh:
        fh.write('{"kind": "counter", "name": "n", "val')
    for _, _, t, _ in _both(ref):
        assert len(t.read_events(p)) == 1
        assert t.replay_counters(p) == {"n": 1}


@pytest.mark.parametrize("up_to", (None, 0, 1, 2))
def test_replay_counters_semantics(ref, tmp_path, up_to):
    p = str(tmp_path / "ev.jsonl")
    tr = ttrace.Tracer(p)
    tr.counter("loss", 5.0, step=0)
    tr.counter("loss", 4.0, step=1)
    tr.counter("loss", 9.9, step=1)
    tr.counter("loss", 3.0, step=2)
    tr.counter("flat", 2.0)
    tr.close()
    got = [t.replay_counters(p, up_to_step=up_to) for _, _, t, _ in
           _both(ref)]
    assert got[0] == got[1]
    want = {None: 5.0 + 9.9 + 3.0, 0: 5.0, 1: 5.0 + 9.9, 2: 5.0 + 9.9 + 3.0}
    assert got[0] == {"loss": want[up_to], "flat": 2.0}


def test_set_tracer_restores_disabled():
    tr = ttrace.Tracer(enabled=True)
    old = ttrace.set_tracer(tr)
    assert ttrace.get_tracer() is tr
    ttrace.set_tracer(None)
    assert not ttrace.get_tracer().enabled
    ttrace.set_tracer(old)


def test_span_opens_a_profiler_range_when_asked():
    """A range is asked for with ``annotate`` (the launcher's step, every
    collective's issue and wait) and shows by name in a torch.profiler
    trace; a tracer span is host-only and opens none."""
    from torch.profiler import profile
    tr = ttrace.Tracer()
    with profile() as prof:
        with ttrace.annotate("train.step"), tr.span("host.only", step=0):
            with ttrace.annotate("zero.qwz_gather"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"train.step", "zero.qwz_gather"} <= names
    assert "host.only" not in names
    assert [json.loads(x)["name"] for x in tr._buf] == ["host.only"]


# ---------------------------------------------------------------------------
# report: export, diff, gate
# ---------------------------------------------------------------------------

def test_export_snapshot_schema(ref, tmp_path):
    docs = []
    for name, m, _, rp in _both(ref):
        r = m.Registry()
        r.counter("train.steps").inc(4)
        r.histogram("train.step.wall_ms").observe(10.0)
        r.gauge("tune.prefetch").set(1)
        p = str(tmp_path / f"{name}.json")
        doc = rp.export_snapshot(p, registry=r,
                                 extra={"config": {"mesh": [4, 2]}})
        assert json.load(open(p)) == doc
        docs.append((doc, open(p).read()))
    assert docs[0] == docs[1]
    assert docs[0][0]["runtime"]["metrics"]["train.steps"] == 4
    assert docs[0][0]["runtime"]["config"]["mesh"] == [4, 2]


DIFF_CASES = {
    "drift": ({"runtime": {"metrics": {"a": 100.0, "b": 1.0, "gone": 5}}},
              {"runtime": {"metrics": {"a": 103.0, "b": 2.0, "added": 7}}}),
    "types": ({"r": {"flag": True, "name": "x", "n": 0, "z": 0.0}},
              {"r": {"flag": False, "name": "y", "n": 1e-13, "z": 0.0}}),
}


@pytest.mark.parametrize("rel_tol", (0.0, 0.02, 0.05, 1.0))
@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_bench_diff_and_cli(ref, tmp_path, capsys, case, rel_tol):
    old, new = DIFF_CASES[case]
    rows = [rp.bench_diff(old, new, rel_tol=rel_tol)
            for _, _, _, rp in _both(ref)]
    assert rows[0] == rows[1]
    assert [rp.format_diff(rows[0]) for _, _, _, rp in _both(ref)] == \
        [ref["report"].format_diff(rows[1])] * 2
    assert treport.format_diff(treport.bench_diff(old, old)) == "no drift"
    po, pn = str(tmp_path / "o.json"), str(tmp_path / "n.json")
    json.dump(old, open(po, "w"))
    json.dump(new, open(pn, "w"))
    for argv in (["diff", po, pn, "--rel-tol", str(rel_tol)],
                 ["diff", po, pn, "--rel-tol", str(rel_tol),
                  "--fail-on-drift"]):
        codes, outs = [], []
        for _, _, _, rp in _both(ref):
            codes.append(rp.main(argv))
            outs.append(capsys.readouterr().out)
        assert codes[0] == codes[1] and outs[0] == outs[1]
    if case == "drift" and rel_tol == 0.05:
        keys = [r[0] for r in rows[0]]
        assert "runtime.metrics.a" not in keys
        assert {"runtime.metrics.b", "runtime.metrics.gone",
                "runtime.metrics.added"} <= set(keys)


GATE_CASES = {
    "within": ({"zero.qwz_gather": 1000.0}, {"zero.qwz_gather": 1005.0}),
    "beyond": ({"zero.qwz_gather": 1000.0}, {"zero.qwz_gather": 1100.0}),
    "other": ({"other": 999.0}, {}),
    "missing": ({}, {"zero.qgz_reduce": 5000.0}),
    "zeros": ({}, {"zero.qwz_gather": 0.0, "zero.hpz_gather": 0.0}),
    "many": ({"zero.qwz_gather": 7.0, "zero.hpz_gather": 3.0, "other": 1.0},
             {"zero.qwz_gather": 7.0, "zero.hpz_gather": 3.5}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_comm_gate_tolerance(ref, case):
    measured, projected = GATE_CASES[case]
    got = [rp.comm_gate(measured, projected) for _, _, _, rp in _both(ref)]
    assert got[0] == got[1]
    want_ok = {"within": True, "beyond": False, "other": True,
               "missing": False, "zeros": True, "many": False}[case]
    assert got[0]["ok"] is want_ok
    if case == "other":
        assert not got[0]["labels"]["other"]["rel"] <= 0.01


def test_overhead_gate_and_runtime_gate_strict(ref):
    samples = (([1.0, 1.0, 1.0], [1.01, 1.01, 1.01]), ([1.0], [0.9]),
               ([1.0], [1.5]), ([3.0, 1.0, 2.0, 4.0], [2.0, 2.5, 9.0, 1.0]))
    for e, d in samples:
        got = [rp.overhead_gate(e, d, tol=0.02) for _, _, _, rp in _both(ref)]
        assert got[0] == got[1]
    ok = treport.overhead_gate([1.0, 1.0, 1.0], [1.01, 1.01, 1.01])
    assert ok["ok"] and abs(ok["rel_overhead"] - 0.01) < 1e-9
    assert not treport.overhead_gate([1.0], [1.5])["ok"]
    msgs = []
    for _, _, _, rp in _both(ref):
        with pytest.raises(rp.GateFailure) as ei:
            rp.runtime_gate(measured={"zero.qwz_gather": 1.0},
                            projected={"zero.qwz_gather": 2.0},
                            enabled_s=[1.0], disabled_s=[2.0], strict=True)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "zero.qwz_gather" in msgs[0]
    reps = [rp.runtime_gate(measured={"zero.qwz_gather": 1.0},
                            projected={"zero.qwz_gather": 1.0},
                            enabled_s=[1.0, 1.0], disabled_s=[1.0, 1.0],
                            strict=True) for _, _, _, rp in _both(ref)]
    assert reps[0] == reps[1] and reps[0]["ok"] and reps[0]["overhead"]["ok"]


def test_package_exports_the_references_names(ref):
    import repro.obs as robs
    assert tobs.__all__ == robs.__all__
