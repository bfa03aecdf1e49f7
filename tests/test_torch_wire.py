"""Port vs reference: wire-byte accounting and the measured-vs-projected gate.

  (a) the arithmetic: ``comm_volume_per_step``, ``event_wire_bytes`` and
      ``step_wire_by_label`` of the port equal the reference's to the byte
      on the reference's own event list (``Model.comm_events()`` at depth
      0), for qwen3-0.6b at full width, gpt-350m reduced and gemma3-4b
      reduced to 8 layers (a ``rem`` site), under ``zeropp`` and
      ``baseline``, at 1 x 1, 2 x 2, 4 x 2 and 2 x 2 x 2; the port's
      ``Model.comm_events()`` equals the reference's at depth 0 event for
      event, and at depths 1 and 2 the reference's minus k events per
      block phase (the reference's scan ring issues n + k, the port's n);
      qwen3-0.6b at 2 x 2 reproduces the MiB a rank of the reference's
      projection;
  (b) the counters: 8 CPU gloo ranks at 4 x 2 (gpt-350m reduced to 4
      layers, batch 16, seq 64, the reference's ``_prefetch_env``) under
      ``zeropp`` and ``baseline`` at prefetch 0, 1 and 2, and at accum 2:
      every rank's bytes per label at every step equal the port's
      projection exactly (``runtime_gate(strict=True)``), the ranks agree,
      and ``other`` is the two scalar all-reduces of a step (AdamW's grad
      norm, 4 bytes, and the trainer's metrics, 12 bytes: 2·16·(W−1)/W);
      at depth 0 the measured ``zero.*`` bytes equal the reference's
      jaxpr-measured ``wire_by_label`` (a subprocess on 8 simulated
      devices, as ``check_obs_comm_crosscheck`` traces it) to the byte;
  (c) 4 ranks at 2 x 2: the sequence-parallel step (batch 2, the sequence
      over ``model``) counts the same ``zero.*`` bytes as batch 8, and its
      ``other`` adds the K/V all-gathers and their reduce-scatters; a
      profiled step shows each label's issue and wait ranges.  ``other``
      departs from the reference's, whose jaxpr walk measures 0 there on
      (b)'s configuration: the port counts every collective it issues,
      the scalar all-reduces included (the gate reports ``other`` and does
      not hold it);
  (d) the launcher: ``launch.train --mesh 2x2 --steps 3 --metrics-dir D
      --obs-gate`` writes a passing ``BENCH_runtime.json`` whose
      ``comm.zero.*.bytes`` are 3 × the projection, and an
      ``events.jsonl`` that replays to 3 steps.

The reference is imported inside the tests only: every spawned rank
imports this module.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json                                                  # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core import zeropp as tz                    # noqa: E402
from repro_torch.data.synthetic import SyntheticLM           # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.obs.report import (projected_wire_by_label,  # noqa: E402
                                    runtime_gate)
from repro_torch.obs.trace import replay_counters            # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402
from repro_torch.train.trainer import build_train_step       # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
AXES3 = ("pod", "data", "model")
SIZES = {"1x1": (1, 1), "2x2": (2, 2), "4x2": (4, 2), "2x2x2": (2, 2, 2)}
# name -> (config, overrides of .reduced(); None: full width)
ARCHS = {"qwen3-0.6b": ("qwen3-0.6b", None),
         "gpt-350m-reduced": ("gpt-350m", {}),
         # one (5 local, 1 attn) period and a rem group of 2 local layers
         "gemma3-4b-reduced": ("gemma3-4b", {"n_layers": 8})}
VARIANTS = ("zeropp", "baseline")
# (b): the reference's _prefetch_env: gpt-350m reduced to 4 layers on 4 x 2
N_LAYERS = 4
MESH = (4, 2)
BATCH, SEQ, STEPS = 16, 64, 2
CASES = [(v, pf, 1) for v in VARIANTS for pf in (0, 1, 2)] + [
    ("zeropp", 1, 2)]
# (c): 2 x 2, batch 8 (pure data parallel) and batch 2 (sequence-parallel)
SP_MESH, SP_BATCHES = (2, 2), (8, 2)
# the MiB a rank that the reference's projection gives qwen3-0.6b at 2 x 2
# (depth 0: the port's ring at every depth)
QWEN_2X2_MIB = {"zeropp": {"zero.qwz_gather": 546.025,
                           "zero.hpz_gather": 716.833,
                           "zero.qgz_reduce": 277.213},
                "baseline": {"zero.baseline_gather": 2150.499,
                             "zero.baseline_reduce": 1075.250}}

_REF_SNIPPET = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.launch.jaxpr_analysis import analyze_jaxpr
from repro.testing.checks import _abstract_tree, _prefetch_env
from repro.train import trainer as trainer_lib
out = {}
for variant in ("zeropp", "baseline"):
    mesh, arch, model, opt_cfg, ts, lm = _prefetch_env(
        0, variant=variant, arch_name="gpt-350m", n_layers=4)
    p_sh, o_sh = trainer_lib.state_shapes(model, opt_cfg)
    params = _abstract_tree(p_sh, mesh, ts.in_specs[0])
    opt = _abstract_tree(o_sh, mesh, ts.in_specs[1])
    bsh = {"tokens": jax.ShapeDtypeStruct((16, 64), jnp.int32),
           "targets": jax.ShapeDtypeStruct((16, 64), jnp.int32)}
    batch = _abstract_tree(bsh, mesh, ts.in_specs[2])
    cj = jax.make_jaxpr(ts.fn)(params, opt, batch)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out[variant] = analyze_jaxpr(cj, sizes)["collectives"]["wire_by_label"]
json.dump(out, open(sys.argv[1], "w"))
"""


def _arch(get, name, reduced):
    arch = get(name)
    return arch if reduced is None else arch.reduced(**reduced)


def _ref_model(name, reduced, variant, world, prefetch=0, axes=AXES):
    """The reference's Model (specs only: nothing is allocated)."""
    from repro.configs import get_config as rget
    from repro.models.model import Model as RModel
    from repro.train.policy import make_policy as rpolicy
    arch = _arch(rget, name, reduced)
    return RModel(arch, rpolicy(arch, axes, variant,
                                prefetch=prefetch).zcfg, world=world)


def _port_model(name, reduced, variant, world, prefetch=1, axes=AXES):
    arch = _arch(get_config, name, reduced)
    return Model(arch, make_policy(arch, axes, variant,
                                   prefetch=prefetch).zcfg,
                 world=world, device="cpu")


def _axes(shape):
    return AXES if len(shape) == 2 else AXES3


def _sizes(shape):
    return dict(zip(_axes(shape), shape))


# ---------------------------------------------------------------------------
# (a) the arithmetic against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_wire_arithmetic_equals_the_reference(arch_name, variant, size):
    """At ring depth 0 the events are the reference's one for one (with a
    ``rem`` group: its site's three, 15 events in all); at depth 1 the
    reference's less its k wrap-around events per block phase (none when
    the loop has one step: gemma3-4b reduced, one period)."""
    from repro.core import zeropp as rz
    shape = SIZES[size]
    world, sizes, axes = int(np.prod(shape)), _sizes(shape), _axes(shape)
    rm = _ref_model(*ARCHS[arch_name], variant, world, axes=axes)
    pm = _port_model(*ARCHS[arch_name], variant, world, axes=axes)
    ev = rm.comm_events()
    assert pm.comm_events() == ev
    assert len(ev) == (15 if rm.rem_spec else 12)
    assert ("rem" in {e["site"] for e in ev}) == (pm.rem_spec is not None)
    deep = _ref_model(*ARCHS[arch_name], variant, world, 1, axes)
    k = pm.zcfg.effective_prefetch(pm.n_periods)
    assert pm.comm_events() == [
        dict(e, count=e["count"] - (k if e["site"].startswith("blocks.")
                                    else 0)) for e in deep.comm_events()]
    for e in ev:
        assert tz.wire_label(e["kind"], pm.zcfg) == \
            rz.wire_label(e["kind"], rm.zcfg)
        assert tz.event_wire_bytes(e["kind"], e["elems"], pm.zcfg, sizes) \
            == rz.event_wire_bytes(e["kind"], e["elems"], rm.zcfg, sizes)
    got = tz.step_wire_by_label(ev, pm.zcfg, sizes)
    assert got == rz.step_wire_by_label(ev, rm.zcfg, sizes)
    assert set(got) <= set(tz.WIRE_LABELS)
    if world == 1:
        assert set(got.values()) == {0.0}
    assert tz.comm_volume_per_step(pm.n_params(), pm.zcfg) == \
        rz.comm_volume_per_step(rm.n_params(), rm.zcfg)
    assert tz.EVENT_KINDS == rz.EVENT_KINDS
    assert tz.WIRE_LABELS == rz.WIRE_LABELS


@pytest.mark.parametrize("prefetch", (1, 2))
@pytest.mark.parametrize("variant", VARIANTS)
def test_comm_events_are_the_references_less_the_ring_wrap(variant,
                                                           prefetch):
    """At depth k the reference's scan issues n + k of each block event;
    the port's ring issues n (its bytes are its depth-0 bytes)."""
    deep = {"n_layers": N_LAYERS}
    ref = _ref_model("gpt-350m", deep, variant, 8, prefetch).comm_events()
    pm = _port_model("gpt-350m", deep, variant, 8, prefetch)
    assert pm.zcfg.effective_prefetch(N_LAYERS) == prefetch
    mine = pm.comm_events()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        wrap = prefetch if b["site"].startswith("blocks.") else 0
        assert a == dict(b, count=b["count"] - wrap), (a, b)
    assert mine == _port_model("gpt-350m", deep, variant, 8,
                               0).comm_events()


def test_comm_events_scale_with_accum_and_vanish_in_local_mode():
    pm = _port_model("gpt-350m", {}, "zeropp", 4)
    two = pm.comm_events(accum=2)
    assert [e["count"] for e in two] == \
        [2 * e["count"] for e in pm.comm_events()]
    local = Model(pm.cfg, tz.ZeroConfig.local(), device="cpu")
    assert local.comm_events() == []
    assert tz.event_wire_bytes("fwd_gather", 1024, local.zcfg, {}) == 0.0
    with pytest.raises(ValueError, match="kind"):
        tz.wire_label("all_gather", pm.zcfg)


@pytest.mark.parametrize("variant", VARIANTS)
def test_qwen3_at_2x2_projects_the_references_mib(variant):
    pm = _port_model("qwen3-0.6b", None, variant, 4)
    got = projected_wire_by_label(pm, _sizes((2, 2)))
    assert {k: round(v / 2 ** 20, 3) for k, v in got.items()} == \
        QWEN_2X2_MIB[variant]


def test_table1_volume_reduction_is_four():
    """The paper's Table 1: 3M for ZeRO-3, 0.5M + 0 + 0.25M for ZeRO++
    (plus the fp32 block scales)."""
    n = _port_model("qwen3-0.6b", None, "zeropp", 4).n_params()
    v = tz.comm_volume_per_step(n, tz.ZeroConfig())
    b = tz.comm_volume_per_step(n, tz.ZeroConfig.baseline())
    assert b["total"] == 3 * 2 * n and v["bwd_allgather"] == 0
    assert v["fwd_allgather"] == n + 4 * -(-n // 256)
    assert v["grad_reduce"] == n // 2 + 4 * -(-n // 256)
    assert 3.9 < v["reduction_factor"] < 4.0


# ---------------------------------------------------------------------------
# (b), (c) the counters on gloo ranks
# ---------------------------------------------------------------------------

def _measure(model, step, batch_rows, accum, steps=STEPS):
    """Each step's counted bytes per label on this rank."""
    params = tlaunch.init_shards(model, 0)
    opt = init_opt_state(params)
    lm = SyntheticLM(vocab=model.cfg.vocab, seq_len=SEQ, seed=7)
    out = []
    for i in range(steps):
        batch = tlaunch.device_batch(model.cfg, lm, i, batch_rows * accum,
                                     accum, "cpu")
        before = tlaunch.comm_bytes()
        step.fn(params, opt, batch)
        out.append(tlaunch.comm_since(before))
    return out


def _grid_rank(rank, world):
    """(b): every case of CASES at 4 x 2."""
    mesh = mesh_lib.make_mesh(MESH)
    arch = get_config("gpt-350m").reduced(n_layers=N_LAYERS)
    out = {}
    for variant, pf, accum in CASES:
        pol = make_policy(arch, mesh_lib.AXES, variant, mesh=mesh,
                          prefetch=pf)
        model = Model(arch, pol.zcfg, world=world, device="cpu")
        step = build_train_step(model, AdamWConfig(lr=3e-3), accum=accum,
                                device="cpu", global_batch=BATCH, mesh=mesh)
        out[(variant, pf, accum)] = _measure(model, step, BATCH, accum)
    return out


def _sp_rank(rank, world):
    """(c): 2 x 2 at batch 8 and batch 2, and one profiled batch-2 step's
    range names."""
    from torch.profiler import profile
    mesh = mesh_lib.make_mesh(SP_MESH)
    arch = get_config("gpt-350m").reduced(n_layers=N_LAYERS)
    model = Model(arch, make_policy(arch, mesh_lib.AXES, mesh=mesh).zcfg,
                  world=world, device="cpu")
    out = {}
    for rows in SP_BATCHES:
        step = build_train_step(model, AdamWConfig(lr=3e-3), device="cpu",
                                global_batch=rows, mesh=mesh)
        out[rows] = _measure(model, step, rows, 1)
        out[("seq_axes", rows)] = step.run_spec.seq_axes
    with profile() as prof:
        _measure(model, step, SP_BATCHES[-1], 1, steps=1)
    out["ranges"] = sorted({e.name for e in prof.events()
                            if e.name.startswith(("zero.", "other"))})
    return out


def _other_scalars(world):
    """AdamW's grad-norm all-reduce (one fp32) and the trainer's metrics
    all-reduce (three fp32): 2·in·(W−1)/W each."""
    return 2 * (4 + 12) * (world - 1) / world


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(d / "ref.json")], env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            ranks = mesh_lib.spawn(_grid_rank, MESH[0] * MESH[1],
                                   device="cpu")
            sp = mesh_lib.spawn(_sp_rank, SP_MESH[0] * SP_MESH[1],
                                device="cpu")
            ref.wait(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (d / "ref.log").read_text()
    return dict(ranks=ranks, sp=sp, ref=json.loads((d / "ref.json").read_text()))


def _projection(variant, pf, accum, shape):
    pm = _port_model("gpt-350m", {"n_layers": N_LAYERS}, variant,
                     shape[0] * shape[1], pf)
    return projected_wire_by_label(pm, _sizes(shape), accum=accum)


def _zero(c):
    return {k: v for k, v in c.items() if k != "other"}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-pf%d-accum%d" % c)
def test_counted_bytes_equal_the_projection_on_every_rank(grid, case):
    variant, pf, accum = case
    projected = _projection(variant, pf, accum, MESH)
    per_rank = [r[case] for r in grid["ranks"]]
    assert all(steps == per_rank[0] for steps in per_rank), \
        "the ranks counted different bytes"
    for c in per_rank[0]:
        assert _zero(c) == projected
        runtime_gate(measured=c, projected=projected, strict=True)
        assert c["other"] == _other_scalars(8)
    if accum == 2:
        once = _projection(variant, pf, 1, MESH)
        assert projected == {k: 2 * v for k, v in once.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_counted_bytes_at_depth0_equal_the_references_jaxpr(grid, variant):
    """The reference's own measurement (its jaxpr walk) against the port's
    counters, to the byte; its ``other`` is 0, the port's is not (see the
    module note)."""
    ref = grid["ref"][variant]
    assert ref.get("other", 0.0) == 0.0
    want = {k: v for k, v in ref.items() if k != "other"}
    for r in grid["ranks"]:
        for c in r[(variant, 0, 1)]:
            assert _zero(c) == want


def test_sequence_parallel_counts_its_kv_traffic_under_other(grid):
    arch = get_config("gpt-350m").reduced(n_layers=N_LAYERS)
    y, x = SP_MESH
    projected = _projection("zeropp", 1, 1, SP_MESH)
    sp = grid["sp"]
    for rows in SP_BATCHES:
        assert all(r[rows] == sp[0][rows] for r in sp), rows
    assert sp[0][("seq_axes", 2)] == ("model",)
    assert sp[0][("seq_axes", 8)] == ()
    # the K/V of one rank's tile: 1 row x SEQ / X positions, bf16
    kv = 1 * (SEQ // x) * arch.n_kv_heads * arch.head_dim * 2
    # a layer gathers K and V in the forward and again in its recompute,
    # and reduce-scatters both cotangents: 6 messages of kv·(X−1) bytes
    kv_other = N_LAYERS * 6 * kv * (x - 1)
    for r in sp:
        for c8, c2 in zip(r[8], r[2]):
            assert _zero(c8) == _zero(c2) == projected
            assert c8["other"] == _other_scalars(y * x)
            assert c2["other"] == _other_scalars(y * x) + kv_other


def test_profiled_step_shows_every_labels_issue_and_wait(grid):
    want = set()
    for lbl in ("zero.qwz_gather", "zero.hpz_gather", "zero.qgz_reduce",
                "other"):
        want |= {lbl, lbl + ".wait"}
    assert want <= set(grid["sp"][0]["ranges"]), grid["sp"][0]["ranges"]


# ---------------------------------------------------------------------------
# (d) the launcher's telemetry
# ---------------------------------------------------------------------------

def test_launcher_writes_a_passing_bench_and_a_replayable_log(tmp_path):
    d = tmp_path / "m"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--mesh", "2x2", "--steps", "3", "--metrics-dir",
         str(d), "--obs-gate", "--log-every", "0"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads((d / "BENCH_runtime.json").read_text())["runtime"]
    pm = _port_model("qwen3-0.6b", {}, "zeropp", 4)
    projected = projected_wire_by_label(pm, _sizes((2, 2)))
    assert doc["gate"]["ok"] and doc["ranks_agree"]
    m = doc["metrics"]
    for lbl, b in projected.items():
        assert m[f"comm.{lbl}.bytes"] == 3 * b
    assert m["train.steps"] == 3 and m["train.step.wall_ms"]["count"] == 3
    assert m["tune.qwz"] == m["tune.hpz"] == m["tune.qgz"] == 1
    assert doc["config"]["mesh"] == [2, 2]
    tot = replay_counters(str(d / "events.jsonl"))
    assert tot["train.steps"] == 3
    for lbl, b in projected.items():
        assert tot[f"comm.{lbl}.bytes"] == 3 * b


def test_launcher_telemetry_at_world1_counts_nothing(tmp_path):
    """World 1 sends nothing and passes the gate; every step is in a
    profiler range."""
    from torch.profiler import profile
    args = tlaunch.parser().parse_args([
        "--reduced", "--device", "cpu", "--batch", "2", "--seq", "64",
        "--steps", "2", "--log-every", "0", "--metrics-dir",
        str(tmp_path), "--obs-gate"])
    with profile() as prof:
        out = tlaunch.train_loop(args)
    assert [e.name for e in prof.events()].count("train.step") == 2
    assert out["comm_steps"] == [{}, {}]
    assert out["gate"]["ok"] and out["ranks_agree"]
    assert set(out["gate"]["comm"]["labels"]) == {
        "zero.qwz_gather", "zero.hpz_gather", "zero.qgz_reduce"}
    doc = json.loads((tmp_path / "BENCH_runtime.json").read_text())
    assert doc["runtime"]["metrics"]["train.steps"] == 2
    assert not any(k.startswith("comm.") for k in doc["runtime"]["metrics"])


def test_telemetry_off_keeps_the_disabled_tracer():
    """Telemetry off: no gate, the disabled tracer, and the step's
    profiler range all the same."""
    from torch.profiler import profile
    from repro_torch.obs.trace import get_tracer
    args = tlaunch.parser().parse_args([
        "--reduced", "--device", "cpu", "--batch", "2", "--seq", "64",
        "--steps", "1", "--log-every", "0"])
    with profile() as prof:
        out = tlaunch.train_loop(args)
    assert out["gate"] is None and out["ranks_agree"] is None
    assert not get_tracer().enabled
    assert out["comm_steps"] == [{}]
    assert [e.name for e in prof.events()].count("train.step") == 1
