"""Port vs reference: the three-axis ("pod", "data", "model") world, 2 × 2 × 2
on 8 gloo ranks.

  (a) the mesh: ``parse_mesh("2x2x2")``, and each rank's groups (intra
      = ``("model",)``: 2 consecutive ranks; inter = ``("pod", "data")``:
      the 4 ranks at one ``model`` coordinate in the reference's order
      pod·Y + data; one pod = ``("data", "model")``: 4 consecutive ranks);
      ``choose_batch_seq_axes`` on three axes is the reference's; the flat
      cut of ``params_from_numpy`` at world 8 glues back to the global
      buffers;
  (b) the collectives on 8 ranks, bit for bit against the reference's
      output on the same global input (8 simulated devices, a (2, 2, 2)
      mesh) and within the reference check's own bar against the fp32
      oracle: 2-hop qgZ with two inter axes (``check_qgz_multipod``:
      INT4, block 64, 512 elements a rank; and INT8, block 32), the 1-hop
      and the quantized ring (``check_qgz_1hop_and_ring``'s INT8, block 32
      at world 8) and the non-blocked qwZ gather;
  (c) one training step of gpt-350m reduced (2 layers, d 64, vocab 128,
      seq 64) at 2 × 2 × 2, batch 8 (one row a rank), fp32 compute,
      against the reference's step on a (2, 2, 2) mesh from the same
      global fp32 state, with the bars of ``test_torch_train_multirank``
      (a): qgZ off, the loss within 1e-5 and gradients, m and v within
      rtol 1e-5 / atol 1e-6; full ZeRO++ and ``hpz_axes=("data",
      "model")`` (one pod), the qgZ path-step bars of
      ``test_torch_ablations`` with ``step_bars.far_share((2, 2, 2))``
      (12 quantizations an element: 6 in 1,000); every rank's counted
      bytes per label equal to the projection to the byte;
  (d) batch 4 at 2 × 2 × 2: rows over ("pod", "data"), the sequence over
      ``model``, the step-1 loss within 1e-5 of the port's world-1 loss
      on the same rows (qgZ off, fp32);
  (e) the launcher's loop at ``--mesh 2x2x2`` (bf16, 2 steps, the
      ``--obs-gate`` on): every rank passes the gate, the ranks agree, and
      the step-1 loss is within 1e-3 of ``--mesh 1x1``'s (the card
      phases' bar).

One spawn of 8 ranks runs every case, while the reference's subprocess
runs beside it.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
import types                                                 # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import collectives as cl               # noqa: E402
from repro_torch.core import quant as tq                     # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.obs.report import projected_wire_by_label   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train import trainer                        # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, LR, SEQ = "gpt-350m", 3e-3, 64
MESH, BATCH, SEQ_BATCH = (2, 2, 2), 8, 4
WORLD = 8
TF32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
            reduce_dtype=torch.float32)
STEPS = {"qgz_off": dict(qgz=False), "zeropp": {},
         "hpz_pod": dict(hpz_axes=("data", "model"))}
# (b): 2-hop (name, bits, block, elements a rank)
MP_CASES = (("int4", 4, 64, 64 * 8), ("int8", 8, 32, 32 * 8))
RING_N = WORLD * 32              # check_qgz_1hop_and_ring: world·32·world
GATHER_N = 1024
LAUNCH_ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
               str(BATCH), "--seq", str(SEQ), "--steps", "2", "--lr",
               str(LR), "--log-every", "0"]


def _inputs():
    rng = np.random.default_rng(5)
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch).zcfg, world=WORLD, device="cpu")
    d = {"p." + k: v for k, v in step_bars.global_params(model, 3).items()}
    lm = tsyn.SyntheticLM(arch.vocab, SEQ, seed=7)
    for pre, rows in (("b.", BATCH), ("s.", SEQ_BATCH)):
        d.update({pre + k: v for k, v in tsyn.make_batch(
            arch, lm, 0, rows).items()})
    for name, _, _, n in MP_CASES:
        d["mp." + name] = rng.normal(size=(WORLD * n,)).astype(np.float32)
    d["ring"] = rng.normal(size=(WORLD * RING_N,)).astype(np.float32)
    x = (rng.normal(size=(WORLD * GATHER_N,)) * 0.02).astype(np.float32)
    x[::97] *= 40
    d["ag"] = x
    d["lr"] = np.float32(LR)
    return d


_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core import collectives as cl
from repro.core.compat import make_mesh, shard_map
from repro.core.quant import QuantConfig
from repro.models.model import Model
from repro.models.transformer import RunSpec
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.train import trainer
from repro.train.policy import make_policy
from repro.train.state import param_specs
d = dict(np.load(sys.argv[1]))
AXES = ("pod", "data", "model")
mesh = make_mesh((2, 2, 2), AXES)
spec = P(AXES)
out = {}
def sm(f):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec))
for name, bits, block in (("int4", 4, 64), ("int8", 8, 32)):
    cfg = QuantConfig(bits=bits, block_size=block)
    out["mp." + name] = np.asarray(sm(lambda x: cl.qgz_reduce_scatter(
        x, "model", ("pod", "data"), cfg))(jnp.asarray(d["mp." + name])))
cfg = QuantConfig(bits=8, block_size=32)
g = jnp.asarray(d["ring"])
out["1hop"] = np.asarray(sm(lambda x: cl.qgz_reduce_scatter_1hop(
    x, AXES, cfg))(g))
out["ring"] = np.asarray(sm(lambda x: cl.qgz_quantized_ring_reduce_scatter(
    x, AXES, cfg))(g))
out["ag"] = np.asarray(sm(lambda s: cl.qwz_all_gather(
    s, AXES, QuantConfig(8, 256), out_dtype=jnp.float32, blocked=False))(
    jnp.asarray(d["ag"])))
def tree(prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in d.items()
            if k.startswith(prefix)}
def put(prefix, t):
    for k, v in t.items():
        out[prefix + k] = np.asarray(v)
arch = get_config("gpt-350m").reduced()
batch = {k[2:]: d[k] for k in d if k.startswith("b.")}
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           reduce_dtype=jnp.float32)
rs = RunSpec(mode="train", seq_axes=(), attn_impl="xla")
for name, over in (("qgz_off", dict(qgz=False)), ("zeropp", {}),
                   ("hpz_pod", dict(hpz_axes=("data", "model")))):
    m = Model(arch, make_policy(arch, AXES, "zeropp", **over, **F32).zcfg,
              world=8)
    specs = param_specs(m, AXES)
    p = tree("p.")
    def lg(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: m.loss_fn(p, b, rs, 8), has_aux=True)(p)
        return jax.lax.psum(loss, AXES), g
    f = jax.jit(shard_map(lg, mesh=mesh,
                          in_specs=(specs, {k: P(AXES, None) for k in batch}),
                          out_specs=(P(), specs), check_vma=False))
    loss, g = f(p, batch)
    out[name + ".loss"] = np.asarray(loss)
    put(name + ".g.", g)
    cfg = AdamWConfig(lr=float(d["lr"]))
    ts = trainer.build_train_step(m, mesh, cfg, donate=False,
                                  global_batch=len(batch["tokens"]))
    p, o, met = ts.fn(p, init_opt_state(p, cfg),
                      trainer.place_batch(batch, mesh, ts.in_specs[2]))
    put(name + ".p.", p)
    put(name + ".m.", o["m"])
    put(name + ".v.", o["v"])
    put(name + ".met.", met)
np.savez(sys.argv[2], **out)
"""


def _shard(x, rank):
    n = x.shape[0] // WORLD
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _rank(rank, world, d, metrics_dir):
    mesh = mesh_lib.make_mesh(MESH)
    out = {"groups": {
        "intra": dist.get_process_group_ranks(mesh.intra),
        "inter": dist.get_process_group_ranks(mesh.inter),
        "pod": dist.get_process_group_ranks(mesh.group(("data", "model"))),
        "world": cl.world_size(mesh.group(mesh.axes)),
        "built": sorted(mesh.groups)}}
    try:
        mesh.group(("pod", "model"))
        out["groups"]["unbuilt"] = "accepted"
    except ValueError as e:
        out["groups"]["unbuilt"] = str(e)
    wide = mesh_lib.make_mesh(MESH, hpz_axes=("pod", "model"))
    out["groups"]["pod_model"] = dist.get_process_group_ranks(
        wide.group(("pod", "model")))
    coll = {}
    for name, bits, block, _ in MP_CASES:
        coll["mp." + name] = cl.qgz_reduce_scatter(
            _shard(d["mp." + name], rank), mesh.intra, mesh.inter,
            tq.QuantConfig(bits=bits, block_size=block)).numpy()
    cfg = tq.QuantConfig(bits=8, block_size=32)
    g = _shard(d["ring"], rank)
    coll["1hop"] = cl.qgz_reduce_scatter_1hop(g, None, cfg).numpy()
    coll["ring"] = cl.qgz_quantized_ring_reduce_scatter(g, None, cfg).numpy()
    coll["ag"] = cl.qwz_all_gather(_shard(d["ag"], rank), None,
                                   tq.QuantConfig(8, 256),
                                   out_dtype=torch.float32,
                                   blocked=False).numpy()
    out["coll"] = coll
    arch = get_config(ARCH).reduced()
    p = {k[2:]: v for k, v in d.items() if k.startswith("p.")}
    tb = {k[2:]: torch.from_numpy(v).long() for k, v in d.items()
          if k.startswith("b.")}
    steps = {}
    for name, over in STEPS.items():
        pol = make_policy(arch, mesh.axes, "zeropp", mesh=mesh, **over,
                          **TF32)
        model = Model(arch, pol.zcfg, world=world, device="cpu")
        step = trainer.build_train_step(model, AdamWConfig(lr=LR),
                                        device="cpu", global_batch=BATCH,
                                        mesh=mesh)
        params = params_from_numpy(p, model, rank=rank, world=world)
        opt = init_opt_state(params)
        scales = {}
        with step_bars.recording(scales):
            loss, mets, grads = step.loss_and_grads(params, tb)
        sent = tlaunch.comm_bytes()
        m = step.fn(params, opt, tb)
        steps[name] = dict(
            loss=float(loss), scales=scales, grads=to_numpy(grads),
            params=to_numpy(params), opt=to_numpy(opt),
            met={k: float(v) for k, v in m.items()},
            comm=tlaunch.comm_since(sent),
            projected=projected_wire_by_label(model, mesh.sizes),
            hpz_ranks=dist.get_process_group_ranks(pol.zcfg.hpz_group),
            seq_axes=step.run_spec.seq_axes)
    out["steps"] = steps
    # (d) the sequence over model at batch 4
    model = Model(arch, make_policy(arch, mesh.axes, "zeropp", mesh=mesh,
                                    qgz=False, **TF32).zcfg,
                  world=world, device="cpu")
    step = trainer.build_train_step(model, AdamWConfig(lr=LR), device="cpu",
                                    global_batch=SEQ_BATCH, mesh=mesh)
    sb = {k[2:]: torch.from_numpy(v).long() for k, v in d.items()
          if k.startswith("s.")}
    loss, _, _ = step.loss_and_grads(
        params_from_numpy(p, model, rank=rank, world=world), sb)
    out["seq"] = dict(loss=float(loss), seq_axes=step.run_spec.seq_axes,
                      seq_ranks=dist.get_process_group_ranks(
                          step.run_spec.seq_group))
    # (e) the launcher's loop
    args = tlaunch.parser().parse_args(LAUNCH_ARGV + [
        "--mesh", "2x2x2", "--metrics-dir", metrics_dir, "--obs-gate"])
    res = tlaunch.train_loop(args)
    out["launch"] = dict(losses=res["losses"], gate=res["gate"]["ok"],
                         agree=res["ranks_agree"], comm=res["comm_steps"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(tmp / "in.npz"), str(tmp / "out.npz")],
                               env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            ranks = mesh_lib.spawn(_rank, WORLD, d, str(tmp / "obs"),
                                   device="cpu", timeout=400)
            ref.wait(timeout=400)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (tmp / "ref.log").read_text()
    return dict(ranks=ranks, d=d, ref=dict(np.load(tmp / "out.npz")),
                obs=tmp / "obs")


# ---------------------------------------------------------------------------
# (a) the mesh, the layout and the flat cut
# ---------------------------------------------------------------------------

def test_mesh_parses_three_axes():
    assert mesh_lib.parse_mesh("2x2x2") == (2, 2, 2)
    assert mesh_lib.Mesh((2, 2, 2)).axes == ("pod", "data", "model")
    assert mesh_lib.Mesh((2, 2, 2)).world == 8
    assert mesh_lib.Mesh((2, 4)).axes == ("data", "model")
    for bad in ("2x2x2x2", "2x0x2"):
        with pytest.raises(ValueError, match="mesh"):
            mesh_lib.parse_mesh(bad)
    with pytest.raises(RuntimeError, match="process group of 8"):
        mesh_lib.make_mesh((2, 2, 2))


def test_groups_are_the_references(runs):
    for r, out in enumerate(runs["ranks"]):
        p, dd, m = r // 4, r // 2 % 2, r % 2
        g = out["groups"]
        assert g["intra"] == [r - m, r - m + 1]
        # the reference's flattening of ("pod", "data"): pod·Y + data
        assert g["inter"] == [(pp * 2 + yy) * 2 + m
                              for pp in range(2) for yy in range(2)]
        assert g["pod"] == [p * 4 + j for j in range(4)], (r, dd)
        assert g["world"] == WORLD
        # only the groups a run uses: the suffixes of the axes, every axis
        # but model, and hpz_axes where asked for
        assert g["built"] == [("data", "model"), ("model",),
                              ("pod", "data")]
        assert "no group over ('pod', 'model')" in g["unbuilt"]
        assert g["pod_model"] == [p * 4 + dd * 2 + mm for p in range(2)
                                  for mm in range(2)]
        assert out["steps"]["hpz_pod"]["hpz_ranks"] == g["pod"]
        assert out["steps"]["zeropp"]["hpz_ranks"] == g["intra"]


@pytest.mark.parametrize("batch,shape", [
    (8, (2, 2, 2)), (4, (2, 2, 2)), (2, (2, 2, 2)), (1, (2, 2, 2)),
    (6, (2, 2, 2)), (16, (2, 4, 2)), (4, (1, 4, 2))])
def test_choose_batch_seq_axes_on_three_axes_matches_reference(batch, shape):
    from repro.train import trainer as jtrainer
    axes = mesh_lib.AXES3
    mesh = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))
    assert trainer.choose_batch_seq_axes(batch, shape, axes) == \
        jtrainer.choose_batch_seq_axes(batch, mesh)


def test_params_from_numpy_cuts_world8_flat():
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch, mesh_lib.AXES3).zcfg, world=WORLD,
                  device="cpu")
    p = step_bars.global_params(model, 0)
    shards = [to_numpy(params_from_numpy(p, model, rank=r, world=WORLD))
              for r in range(WORLD)]
    for k, v in p.items():
        glued = np.concatenate([s[k] for s in shards], axis=-1)
        np.testing.assert_array_equal(glued, v)
        assert shards[0][k].shape[-1] * WORLD == v.shape[-1]


# ---------------------------------------------------------------------------
# (b) the collectives on 8 ranks
# ---------------------------------------------------------------------------

def _glued(runs, key):
    return np.concatenate([r["coll"][key] for r in runs["ranks"]])


def _oracle(g):
    return g.reshape(WORLD, -1).astype(np.float64).sum(0).astype(np.float32)


@pytest.mark.parametrize("case", MP_CASES, ids=lambda c: c[0])
def test_two_hop_qgz_with_two_inter_axes_matches_reference(runs, case):
    name, bits, _, _ = case
    g = runs["d"]["mp." + name]
    got = _glued(runs, "mp." + name)
    np.testing.assert_array_equal(got, runs["ref"]["mp." + name])
    # checks._qgz_vs_oracle at X = 2, Y = 4
    X, Y = 2, 4
    amax, qmax = np.abs(g).max(), 7.0 if bits == 4 else 127.0
    bound = X * (amax / qmax) / 2 + Y * (X * amax / qmax) / 2
    want = _oracle(g)
    assert np.abs(got - want).max() <= bound * 1.1 + 1e-6
    assert np.corrcoef(got, want)[0, 1] > 0.97


def test_one_hop_and_ring_at_world8_match_reference(runs):
    g = runs["d"]["ring"]
    got1, gotr = _glued(runs, "1hop"), _glued(runs, "ring")
    np.testing.assert_array_equal(got1, runs["ref"]["1hop"])
    np.testing.assert_array_equal(gotr, runs["ref"]["ring"])
    want, amax = _oracle(g), np.abs(g).max()
    e1, er = np.abs(got1 - want).max(), np.abs(gotr - want).max()
    assert e1 < WORLD * amax / 127, e1
    assert np.corrcoef(gotr, want)[0, 1] > 0.99
    assert er >= e1 * 0.5, (er, e1)


def test_nonblocked_gather_at_world8_matches_reference(runs):
    np.testing.assert_array_equal(_glued(runs, "ag"), runs["ref"]["ag"])


# ---------------------------------------------------------------------------
# (c), (d), (e) the training step
# ---------------------------------------------------------------------------

def _ref_tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _stitched(ranks, name, part):
    return {k: np.concatenate([r["steps"][name][part][k] for r in ranks],
                              axis=-1)
            for k in ranks[0]["steps"][name][part]}


def test_step_at_2x2x2_matches_reference_with_qgz_off(runs):
    ranks, ref = runs["ranks"], runs["ref"]
    loss = sum(r["steps"]["qgz_off"]["loss"] for r in ranks)
    assert abs(loss - float(ref["qgz_off.loss"])) <= 1e-5
    assert all(r["steps"]["qgz_off"]["seq_axes"] == () for r in ranks)
    tg, jg = _stitched(ranks, "qgz_off", "grads"), _ref_tree(ref,
                                                           "qgz_off.g.")
    met = ranks[0]["steps"]["qgz_off"]["met"]
    jn = float(ref["qgz_off.met.grad_norm"])
    np.testing.assert_allclose(met["grad_norm"], jn, rtol=1e-5)
    for k in tg:
        step_bars.close(tg[k], jg[k], f"grad {k}")
        for mv in ("m", "v"):
            got = np.concatenate([r["steps"]["qgz_off"]["opt"][mv][k]
                                  for r in ranks], axis=-1)
            step_bars.close(got, ref[f"qgz_off.{mv}.{k}"], f"{mv} {k}")
    tp = _stitched(ranks, "qgz_off", "params")
    step_bars.params_near(
        tp, _ref_tree(ref, "qgz_off.p."),
        {k: step_bars.first_step_dir(tg[k], met["grad_norm"]) for k in tp},
        {k: step_bars.first_step_dir(jg[k], jn) for k in tp}, LR)
    for r in ranks:
        s = r["steps"]["qgz_off"]
        assert {k: v for k, v in s["comm"].items() if k != "other"} == \
            s["projected"]


@pytest.mark.parametrize("name", ("zeropp", "hpz_pod"))
def test_step_at_2x2x2_matches_reference(runs, name):
    step_bars.hold_qgz_step([r["steps"][name] for r in runs["ranks"]],
                            runs["ref"], name, MESH, LR)


def test_sequence_on_model_at_batch4_matches_world1(runs):
    ranks = runs["ranks"]
    for r, out in enumerate(ranks):
        assert out["seq"]["seq_axes"] == ("model",)
        assert out["seq"]["seq_ranks"] == [r - r % 2, r - r % 2 + 1]
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch, qgz=False, **TF32).zcfg,
                  device="cpu")
    p1 = {}
    for k, n in model.param_shapes().items():
        a = runs["d"]["p." + k]
        assert not a[..., n[-1]:].any()
        p1[k] = a[..., :n[-1]]
    st = trainer.build_train_step(model, AdamWConfig(lr=LR), device="cpu")
    sb = {k[2:]: torch.from_numpy(v).long() for k, v in runs["d"].items()
          if k.startswith("s.")}
    loss1, _, _ = st.loss_and_grads(params_from_numpy(p1, model), sb)
    loss8 = sum(out["seq"]["loss"] for out in ranks)
    assert abs(float(loss1) - loss8) <= 1e-5, (float(loss1), loss8)


def test_launcher_trains_at_2x2x2_under_its_gate(runs):
    ranks = runs["ranks"]
    first = ranks[0]["launch"]
    assert all(r["launch"]["losses"] == first["losses"] for r in ranks)
    assert all(r["launch"]["gate"] and r["launch"]["agree"] for r in ranks)
    assert all(np.isfinite(first["losses"]))
    assert (runs["obs"] / "BENCH_runtime.json").exists()
    assert set(first["comm"][0]) == {"zero.qwz_gather", "zero.hpz_gather",
                                     "zero.qgz_reduce", "other"}
    one = tlaunch.run(tlaunch.parser().parse_args(LAUNCH_ARGV))
    assert abs(first["losses"][0] - one["losses"][0]) <= 1e-3, \
        (first["losses"], one["losses"])
