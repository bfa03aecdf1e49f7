"""The overlap reading (``launch/overlap_analysis.py``) against the
reference's overlap checks and its ``effective_overlap``.

The port's readings come from one rank's train step on fake tensors over a
fake 4 x 2 world (``dryrun.fake_world``, ``dryrun.trace_cell``), at the
reference's setup (``repro/testing/checks.py:733-783``): gpt-350m reduced
(2 layers) and deepseek-moe-16b reduced, batch 16 x 64, full ZeRO++.

  (a) ``check_prefetch_overlap_fraction``: at ring depth 0 nothing hides
      (fraction 0.0, no overlappable collective); at depth 1 the fraction
      is over 0.8 with at least 5 overlappable collectives (the qwZ
      payload and scales, the hpZ re-gather, both qgZ hops);
  (b) ``check_moe_prefetch_overlap_fraction``: the MoE stack at depth 1
      over 0.7 with at least 2 loops, every loop holding compute; depth 0
      hides nothing;
  (c) ``check_ring_overlap_depth``: 4-layer stacks, dense and MoE, depths
      1 and 2: the effective fraction at the port's
      ``RING_OPERATING_POINT`` strictly grows, f2 > f1 > 0, the structural
      one does not fall, ring slack 2 shows, every loop holds compute; the
      MoE depth-1 fraction over 0.7;
  (d) the wire invariant on every cell: the colls folded by their trips
      are the in-loop bytes, and with the out-of-loop bytes the counters'
      growth;
  (e) the port's ``effective_overlap`` equals the reference's
      (``repro.launch.hlo_analysis``: numpy and ``re`` only, no compile)
      on the port's dicts and on a hand-built one, at both operating
      points;
  (f) ``measured_overlap`` on hand-built ranges (its sums are the same
      for any pairing of issues with waits), and the recorder and the
      reading raise on unmatched waits and unclosed loops.
"""
import pytest

from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import overlap_analysis as oa

MESH, B, S = (4, 2), 16, 64
# (arch, layers (0: the reduced default), ring depth)
CELLS = [("gpt-350m", 0, 0), ("gpt-350m", 0, 1),
         ("deepseek-moe-16b", 0, 0), ("deepseek-moe-16b", 0, 1),
         ("gpt-350m", 4, 1), ("gpt-350m", 4, 2),
         ("deepseek-moe-16b", 4, 1), ("deepseek-moe-16b", 4, 2)]


@pytest.fixture(scope="module")
def cells():
    """{cell: (its overlap dict, the counters' growth)}."""
    out = {}
    for name, layers, depth in CELLS:
        arch = get_config(name).reduced(
            **({"n_layers": layers} if layers else {}))
        with dr.fake_world(MESH) as mesh:
            trace, _ = dr.trace_cell(arch, mesh, "train", B, S,
                                     overrides={"prefetch": depth})
        out[name, layers, depth] = (
            trace["overlap"],
            sum(trace["collectives"]["wire_by_label"].values()))
    return out


def test_depth_0_hides_nothing_and_depth_1_hides_most(cells):
    ov0, ov1 = cells["gpt-350m", 0, 0][0], cells["gpt-350m", 0, 1][0]
    assert ov1["overlap_fraction"] > 0.8, ov1
    assert ov1["overlappable_collectives"] >= 5, ov1
    assert ov0["overlap_fraction"] == 0.0, ov0
    assert ov0["overlappable_collectives"] == 0, ov0


def test_moe_chunk_and_layer_rings_hide_most(cells):
    ov0 = cells["deepseek-moe-16b", 0, 0][0]
    ov1 = cells["deepseek-moe-16b", 0, 1][0]
    assert ov1["overlap_fraction"] > 0.7, ov1
    # the layer rings and the chunk rings nested in them
    assert len(ov1["per_loop"]) >= 2, ov1["per_loop"]
    assert any(l["outer_mult"] > 1 for l in ov1["per_loop"].values())
    for name, loop in ov1["per_loop"].items():
        assert loop["has_compute"], (name, loop)
    assert ov0["overlap_fraction"] == 0.0, ov0
    assert ov0["overlappable_collectives"] == 0, ov0


@pytest.mark.parametrize("arch", ["gpt-350m", "deepseek-moe-16b"])
def test_a_deeper_ring_hides_more(cells, arch):
    ov = {d: cells[arch, 4, d][0] for d in (1, 2)}
    assert ov[2]["overlap_fraction"] >= ov[1]["overlap_fraction"], \
        (ov[1]["overlap_fraction"], ov[2]["overlap_fraction"])
    f1, f2 = (oa.effective_overlap(ov[d], **oa.RING_OPERATING_POINT)
              ["effective_overlap_fraction"] for d in (1, 2))
    assert f2 > f1 > 0.0, (f1, f2)
    assert max(l["max_slack_iters"] for l in ov[2]["per_loop"].values()) \
        >= 2
    for d in (1, 2):
        for name, loop in ov[d]["per_loop"].items():
            assert loop["has_compute"], (d, name, loop)
    if arch == "deepseek-moe-16b":
        assert ov[1]["overlap_fraction"] > 0.7, ov[1]["overlap_fraction"]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_the_wire_invariant_holds(cells, cell):
    ov, counted = cells[cell]
    oa.check_wire(ov, counted)
    assert ov["wire_bytes"] == pytest.approx(counted, rel=1e-12)
    with pytest.raises(ValueError, match="invariant"):
        oa.check_wire(ov, counted + 1.0)


def _hand_built():
    """Two loops, one nested: overlappable and exposed colls, a zero-byte
    one, a tier missing from the bandwidths, a trip count below the
    slack."""
    return {"per_loop": {
        "a": {"trip_count": 4, "outer_mult": 1, "flops_per_iter": 3.0e9,
              "colls": [
                  {"wire_bytes": 1.5e6, "overlappable": True,
                   "tier": "data", "slack_iters": 2},
                  {"wire_bytes": 2.0e5, "overlappable": False,
                   "tier": "model", "slack_iters": 1},
                  {"wire_bytes": 0.0, "overlappable": True,
                   "tier": "model", "slack_iters": 1}]},
        "a/b": {"trip_count": 1, "outer_mult": 4, "flops_per_iter": 5.0e8,
                "colls": [
                    {"wire_bytes": 7.0e6, "overlappable": True,
                     "tier": "elsewhere", "slack_iters": 3},
                    {"wire_bytes": 3.0e4, "overlappable": True,
                     "tier": "pod", "slack_iters": 1}]}}}


@pytest.mark.parametrize("point", ["reference", "port"])
def test_effective_overlap_is_the_references(cells, point):
    op = ref_hlo.RING_OPERATING_POINT if point == "reference" \
        else oa.RING_OPERATING_POINT
    dicts = [ov for ov, _ in cells.values()] + [_hand_built()]
    for ov in dicts:
        assert oa.effective_overlap(ov, **op) == \
            ref_hlo.effective_overlap(ov, **op)
    hb = _hand_built()
    op0 = dict(op, coll_latency_s=0.0)
    assert oa.effective_overlap(hb, **op0) == \
        ref_hlo.effective_overlap(hb, **op0)


def test_the_card_cluster_operating_point():
    op = oa.RING_OPERATING_POINT
    assert op["peak_flops"] == 989.4e12
    assert op["tier_bw"] == {"model": 25e9, "data": 25e9, "pod": 25e9}
    assert op["coll_latency_s"] == 20e-6
    assert set(op) == set(ref_hlo.RING_OPERATING_POINT)


def test_measured_overlap_sums_issue_and_wait_ranges():
    # zero.qgz_reduce: two hops in flight at once
    spans = [("zero.qgz_reduce", 0.0, 10.0),
             ("zero.qgz_reduce", 100.0, 110.0),
             ("aten::mm", 10.0, 500.0),
             ("zero.qgz_reduce.wait", 600.0, 700.0),
             ("zero.qgz_reduce.wait", 700.0, 750.0),
             ("other", 800.0, 801.0), ("other.wait", 801.0, 900.0),
             ("gloo:all_to_all", 0.0, 1.0)]
    got = oa.measured_overlap(spans)
    assert set(got) == {"zero.qgz_reduce", "other"}
    q = got["zero.qgz_reduce"]
    # in flight (700 - 0) + (750 - 100) µs, exposed 100 + 50 µs
    assert q["n"] == 2
    assert q["in_flight_ms"] == pytest.approx(1.35)
    assert q["exposed_ms"] == pytest.approx(0.15)
    assert q["hidden_share"] == pytest.approx(1 - 0.15 / 1.35)
    assert got["other"]["hidden_share"] == pytest.approx(1 - 99 / 100)
    with pytest.raises(ValueError, match="issues against"):
        oa.measured_overlap(spans[:4] + spans[5:])
    with pytest.raises(ValueError, match="before its issue"):
        oa.measured_overlap([("zero.qwz_gather", 5.0, 6.0),
                             ("zero.qwz_gather.wait", 1.0, 2.0)])


def test_the_recorder_and_the_reading_raise_on_a_broken_step():
    w1, w2 = object(), object()
    with pytest.raises(ValueError, match="did not issue"):
        with oa.StepRecorder() as rec:
            rec.wait(w1)
    with pytest.raises(ValueError, match="never waited"):
        with oa.StepRecorder() as rec:
            rec.issue("zero.qwz_gather", "all_gather", 8, "data", w2)
    with pytest.raises(ValueError, match="never closed"):
        with oa.StepRecorder() as rec:
            rec.loop_enter("layers.fwd")
    ok = [("enter", "layers.fwd"), ("iter",),
          ("issue", 0, "zero.qwz_gather", "all_gather", 8.0, "data"),
          ("compute", 2.0, "mm"), ("iter",), ("wait", 0), ("exit",)]
    ov = oa.analyze_overlap(ok)
    assert ov["overlap_fraction"] == 1.0
    assert ov["per_loop"]["layers.fwd"]["colls"][0]["slack_iters"] == 1
    with pytest.raises(ValueError, match="never closed"):
        oa.analyze_overlap(ok[:-1])
    with pytest.raises(ValueError, match="never waited"):
        oa.analyze_overlap(ok[:5] + ok[6:])
    with pytest.raises(ValueError, match="pod-tier"):
        oa.analyze_overlap([("issue", 0, "zero.qgz_reduce", "all_to_all",
                             8.0, "pod"), ("wait", 0)])
