"""Port vs reference: the dry run (``launch/dryrun.py``,
``launch/trace_analysis.py``).

The reference's numbers come from one subprocess a module: 8 simulated
host devices, ``jax.make_jaxpr`` of the reference's train, prefill and
decode steps, then ``repro.launch.jaxpr_analysis.analyze_jaxpr`` (no
compile).  The port's come from one rank's step on fake tensors over a
fake 8-rank world.  The cell is ``check_dryrun_smoke_cell``'s
(``repro/testing/checks.py``): qwen3-0.6b reduced, 2 x 2 x 2, batch 8,
seq 32, zeropp.

  (a) wire bytes: every ``zero.*`` label and every tier (less ``other``'s
      share: the port counts its scalar all-reduces, the logits-row
      gathers and the split-KV combines, the reference's walk does not)
      equal the reference's to the byte at prefetch 0, zeropp and
      baseline; at the default depth the port's bytes are the reference's
      depth-0 bytes (its ring moves no wrap-around traffic);
  (b) FLOPs of train, prefill and decode equal the reference's (the bar
      is 1 %; the two programs do the same products);
  (c) the reference's own assertions on the cell, through ``analyze``,
      and the kernels its step calls (B1-B5 once a flat group);
  (d) the liveness counter's peak on a hand-built run of allocations;
  (e) no default process group is left after a cell, nor after a failed
      one;
  (f) a production cell cut in depth (qwen3-0.6b, 2 of 28 layers,
      train_4k on 2 x 32 x 8: 512 fake ranks): its bytes by label and by
      tier are ``zeropp.step_wire_by_label`` and ``step_wire_by_tier``,
      and its overlap reading holds its wire invariant;
  (g) every traced cell has an ``overlap`` dict (``analyze``) whose wire
      invariant holds against the counters' growth: nothing overlaps at
      prefetch 0, the default ring overlaps;
  and the CLI writes a cell's JSON (``summary`` printing the overlap
  line, ``--table`` its column) and skips what the reference skips.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import zeropp as tz
from repro_torch.launch import dryrun as dr
from repro_torch.launch.overlap_analysis import check_wire
from repro_torch.launch.trace_analysis import Liveness, TraceCounter
from repro_torch.models.model import Model
from repro_torch.train.policy import make_policy

ROOT = Path(__file__).resolve().parents[1]
SHAPE, B, S = (2, 2, 2), 8, 32
AXES3 = ("pod", "data", "model")

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.jaxpr_analysis import analyze_jaxpr
from repro.launch.mesh import make_test_mesh
from repro.models.model import Model
from repro.optim.adamw import AdamWConfig
from repro.testing.checks import _abstract_tree
from repro.train import serve as serve_lib
from repro.train import state as state_lib
from repro.train import trainer as trainer_lib
from repro.train.policy import make_policy
B, S = 8, 32
mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
axes = tuple(mesh.axis_names)
sizes = dict(mesh.shape)
arch = get_config("qwen3-0.6b").reduced()
def walk(fn, *args):
    r = analyze_jaxpr(jax.make_jaxpr(fn)(*args), sizes)
    c = r["collectives"]
    return {"flops": r["flops"], "labels": c["wire_by_label"],
            "tiers": c["per_tier_wire"]}
def toks(rows, seq):
    return {"tokens": jax.ShapeDtypeStruct((rows, seq), jnp.int32)}
out = {}
for variant in ("zeropp", "baseline"):
    pol = make_policy(arch, axes, variant, prefetch=0)
    model = Model(arch, pol.zcfg, world=8)
    opt_cfg = AdamWConfig(moments_dtype=pol.moments_dtype)
    ts = trainer_lib.build_train_step(model, mesh, opt_cfg, donate=False,
                                      global_batch=B)
    p_sh, o_sh = trainer_lib.state_shapes(model, opt_cfg)
    bsh = dict(toks(B, S), targets=jax.ShapeDtypeStruct((B, S), jnp.int32))
    out["train-" + variant] = walk(
        ts.fn, _abstract_tree(p_sh, mesh, ts.in_specs[0]),
        _abstract_tree(o_sh, mesh, ts.in_specs[1]),
        _abstract_tree(bsh, mesh, ts.in_specs[2]))
pol = make_policy(arch, axes, "zeropp", prefetch=0)
model = Model(arch, pol.zcfg, world=8)
p_sh = state_lib.abstract_params(model, jnp.bfloat16)
ps = serve_lib.build_prefill_step(model, mesh, ("pod", "data"), ("model",))
out["prefill"] = walk(ps.fn, _abstract_tree(p_sh, mesh, ps.in_specs[0]),
                      _abstract_tree(toks(B, S), mesh, ps.in_specs[1]))
bax, kax = serve_lib.serve_shape_policy("decode_32k", axes)
ds = serve_lib.build_decode_step(model, mesh, bax, kax, donate=False)
out["decode"] = walk(
    ds.fn, _abstract_tree(p_sh, mesh, ds.in_specs[0]),
    _abstract_tree(model.cache_shapes(B, S), mesh, ds.in_specs[1]),
    _abstract_tree(toks(B, 1), mesh, ds.in_specs[2]),
    jax.ShapeDtypeStruct((B,), jnp.int32))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's jaxpr walk of the cell's four steps."""
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _cell(kind, variant="zeropp", **over):
    arch = get_config("qwen3-0.6b").reduced()
    with dr.fake_world(SHAPE) as mesh:
        return dr.trace_cell(arch, mesh, kind, B, S, variant,
                             overrides=over)


@pytest.fixture(scope="module")
def cells():
    """The port's traces: train under both variants at prefetch 0 and
    zeropp at the default depth, prefill and decode at prefetch 0."""
    return {"train-zeropp": _cell("train", prefetch=0),
            "train-baseline": _cell("train", "baseline", prefetch=0),
            "train-zeropp-default": _cell("train"),
            "prefill": _cell("prefill", prefetch=0),
            "decode": _cell("decode", prefetch=0)}


def _zero(labels):
    return {k: v for k, v in labels.items() if k.startswith("zero.")}


@pytest.mark.parametrize("name", ["train-zeropp", "train-baseline",
                                  "train-zeropp-default", "prefill",
                                  "decode"])
def test_wire_bytes_by_label_and_tier_are_the_references(ref, cells, name):
    c = cells[name][0]["collectives"]
    want = ref[name.replace("-default", "")]
    assert _zero(c["wire_by_label"]) == _zero(want["labels"])
    tiers = dict(want["tiers"])
    if name == "prefill":
        # the reference's ``other`` here is the K/V sequence gather over
        # model, which the port counts under ``other`` as well
        tiers["model"] -= want["labels"]["other"]
        assert c["per_tier_other"]["model"] >= want["labels"]["other"] > 0
    else:
        assert want["labels"].get("other", 0) == 0
    assert {t: b - c["per_tier_other"][t]
            for t, b in c["per_tier_wire"].items()} == tiers
    # the tiers hold every label's bytes, ``other``'s too
    assert sum(c["per_tier_wire"].values()) == \
        sum(c["wire_by_label"].values()) == c["wire_bytes"]
    assert c["wire_by_label"].get("other", 0) == \
        sum(c["per_tier_other"].values())


@pytest.mark.parametrize("name", ["train-zeropp", "prefill", "decode"])
def test_flops_are_the_references(ref, cells, name):
    got, want = cells[name][0]["flops"], ref[name]["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # no difference by construction: the same products on both sides
    assert got == want


def test_the_references_own_assertions_hold(cells):
    trace, info = cells["train-zeropp"]
    info = dr.analyze(dict(trace), dict(info))
    mem, coll, r = info["memory"], info["collectives"], info["roofline"]
    assert mem["peak_bytes_per_device"] > 0
    assert coll["count"] > 0 and coll["wire_bytes"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    floor = 2 * info["n_active"] * (B * S) / info["world"]
    assert info["cost"]["flops"] >= floor
    lines = info["ledger"]["lines"]
    assert mem["peak_bytes_per_device"] >= \
        lines["master_params"] + lines["adam_moments"]
    assert set(coll["per_op"]) == {"all_gather", "all_to_all",
                                   "all_reduce"}
    # each kind's wire bytes are the registry's, credited issue by issue
    assert coll["wire_bytes"] == sum(coll["per_tier_wire"].values())
    assert mem["fits_hbm"] and r["step_time_s"] == max(
        r["compute_s"], r["memory_s"], r["collective_s"])
    # B1-B5 once a flat group (blocks x 2, embed, head, unemb x 2), as a
    # step on the card launches them
    assert info["kernel_calls"] == dict.fromkeys(
        ("quantize_blockwise", "dequantize_blockwise", "quantize_reordered",
         "dequant_reduce_quant", "dequant_reduce"), 6)


@pytest.mark.parametrize("name", ["train-zeropp", "train-baseline",
                                  "train-zeropp-default", "prefill",
                                  "decode"])
def test_every_cell_reads_its_overlap(cells, name):
    trace, info = cells[name]
    ov = dr.analyze(dict(trace), dict(info))["overlap"]
    check_wire(ov, sum(trace["collectives"]["wire_by_label"].values()))
    if name == "train-zeropp-default":
        assert ov["overlap_fraction"] > 0.8, ov
        assert set(ov["per_loop"]) == {"layers.fwd", "layers.bwd"}
        assert all(l["has_compute"] for l in ov["per_loop"].values())
    else:
        assert ov["overlap_fraction"] == 0.0, ov
        assert ov["overlappable_collectives"] == 0, ov


def test_liveness_peak_is_exact_on_a_hand_built_run():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        state = torch.empty(10, dtype=torch.float32)          # 40 B
        live = Liveness()
        live.add(state)
        with TraceCounter(live) as tc:
            a = torch.empty(100, dtype=torch.float32)         # +400
            b = torch.empty(200, dtype=torch.float32)         # +800
            v = b.view(20, 10)                                # a view
            del a                                             # -400
            c = torch.empty(1000, dtype=torch.float32)        # +4000
            assert live.live == 40 + 800 + 4000
            del b, c                                          # v keeps b
            assert live.live == 40 + 800
            d = v.float() @ torch.empty(10, 3)                # +120 +120
            del v, d
    assert live.peak == 40 + 800 + 4000
    assert live.live == 40
    # a matmul's operands and result cross HBM: (20·10 + 10·3 + 20·3)·4
    assert tc.hbm_bytes == (200 + 30 + 60) * 4


def test_no_process_group_is_left_after_a_cell():
    assert not dist.is_initialized()
    _cell("decode", prefetch=0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with dr.fake_world(SHAPE):
            assert dist.is_initialized()
            raise ValueError("a failed cell")
    assert not dist.is_initialized()


def test_a_production_cell_cut_in_depth_holds_the_projection():
    """qwen3-0.6b at 2 of its 28 layers, train_4k on 2 x 32 x 8: the
    rows over (pod, data), the sequence over model."""
    arch = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    sh = SHAPES["train_4k"]
    with dr.fake_world((2, 32, 8)) as mesh:
        trace, info = dr.trace_cell(arch, mesh, "train", sh.global_batch,
                                    sh.seq_len)
    assert info["world"] == 512
    c = trace["collectives"]
    z = make_policy(arch, AXES3).zcfg
    events = Model(arch, z, world=512, device="cpu").comm_events()
    sizes = dict(zip(AXES3, (2, 32, 8)))
    assert _zero(c["wire_by_label"]) == tz.step_wire_by_label(events, z,
                                                               sizes)
    want = tz.step_wire_by_tier(events, z, sizes)
    assert {t: b - c["per_tier_other"][t]
            for t, b in c["per_tier_wire"].items() if b} == want
    # the sequence's K/V gathers ride the model tier as ``other``
    assert c["per_tier_other"]["model"] > 0
    check_wire(trace["overlap"], sum(c["wire_by_label"].values()))
    assert trace["overlap"]["overlap_fraction"] > 0


def test_cli_writes_a_cell_and_skips_what_the_reference_skips(tmp_path):
    info = dr.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                    "--multi-pod", "--meshes", "2x2x2", "--out",
                    str(tmp_path)])
    doc = json.loads((tmp_path / "qwen3-0.6b__decode_32k__2x2x2__zeropp"
                      ".json").read_text())
    assert doc["memory"]["peak_bytes_per_device"] == \
        info["memory"]["peak_bytes_per_device"] > 0
    assert isinstance(doc["memory"]["fits_hbm"], bool)
    assert doc["cost"]["flops"] > 0
    assert set(doc["collectives"]["per_tier_wire"]) == {"model", "data",
                                                        "pod"}
    assert doc["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert doc["overlap"]["overlap_fraction"] == \
        info["overlap"]["overlap_fraction"]
    line = [x for x in dr.summary(info).splitlines() if "overlap:" in x]
    assert len(line) == 1 and line[0].strip().startswith(
        "overlap: fraction=")
    skip = dr.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                    "--out", str(tmp_path)])
    assert skip["skipped"] and "500k" in skip["why"]
    rows = dr.table(str(tmp_path)).splitlines()
    assert len(rows) == 4 and rows[2].startswith(
        "| qwen3-0.6b | decode_32k | 2x2x2 | ")
    cols = [c.strip() for c in rows[0].strip("|").split("|")]
    at = cols.index("overlap")
    assert rows[2].strip("|").split("|")[at].strip() == \
        f"{info['overlap']['overlap_fraction']:.3f}"
    assert "sub-quadratic" in rows[3]
    with pytest.raises(SystemExit):
        dr.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                 "--multi-pod", "--meshes", "32x8"])
