"""Port vs reference: the sequence-parallel layout of the training step.

Where the global batch does not cover the world the reference shards the
sequence over the axes the batch leaves (``choose_batch_seq_axes``), and
with no ``global_batch`` it always shards it over ``model``; ``mha``
all-gathers K/V over those axes and reduce-scatters their cotangents.
The port's ranks are CPU gloo processes (one spawn per world), the
reference runs in a subprocess on 8 simulated host devices beside them.
Model: gpt-350m reduced (2 layers, d 64, vocab 128), seq 64, fp32
compute, parameter and reduce dtypes, the global buffers of
``tests/test_torch_train_multirank.py``'s ``_init``.

  (a) ``mha`` with the sequence on 2 ranks against the reference's ``mha``
      in a ``shard_map`` over ``("model",)``: output and q/k/v gradients
      within 1e-5, on the dense route and the chunked route
      (``kv_chunk=16``);
  (b) one step at 2 × 2, batch 2 (rows over ``data``, the sequence over
      ``model``) against the reference's ``build_train_step(global_batch
      =2)``: qgZ off at ``step_bars``' fp32 bars, full ZeRO++ at the
      one-INT4-step bar;
  (c) batch 1 at 2 × 2 (the sequence over both axes) against the port's
      own world-1 step (qgZ off, 1e-5), and the gathered sequence in
      global order.  The reference is not the bar here: its
      ``_gather_seq`` gathers axis by axis, putting the shards in m·Y + d
      order while its positions count d·X + m (ROADMAP Queue C);
  (d) with no ``global_batch`` the port picks the reference's forced
      layout (the sequence over ``model``), at world 4 against the
      reference's step without ``global_batch``; at world 1 the size-1
      ``model`` axis carries no sequence, so the flash kernels stay in
      (the reference names the axis and drops them).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import contextlib                                            # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train import trainer                        # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

from test_torch_train_multirank import (ARCH, LR, SEQ, TF32,  # noqa: E402
                                        _batch, _glued, _init, _port_model,
                                        _ref_tree)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
# attention shapes of (a): (B, S, H, K, hd), each rank holding S / 2
ATTN = (2, 64, 4, 2, 16)
CHUNKS = {"dense": 1024, "chunked": 16}
VARIANTS = {"qgz_off": dict(qgz=False), "zeropp": {}}
FORCE_BATCH = 4

_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.core.compat import make_mesh, shard_map
from repro.models.attention import mha
from repro.models.model import Model
from repro.models.transformer import RunSpec
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.train import trainer
from repro.train.policy import make_policy
from repro.train.state import param_specs
d = dict(np.load(sys.argv[1]))
LR, AXES = float(d["lr"]), ("data", "model")
out = {}
def put(prefix, t):
    for k, v in t.items():
        out[prefix + k] = np.asarray(v)
# (a) mha with the sequence on 2 devices
mesh2 = Mesh(np.array(jax.devices()[:2]), ("model",))
sp = P(None, "model")
for name, chunk in (("dense", 1024), ("chunked", 16)):
    def fn(q, k, v, ct, chunk=chunk):
        o, vjp = jax.vjp(lambda q, k, v: mha(q, k, v, seq_axes=("model",),
                                             kv_chunk=chunk), q, k, v)
        return (o,) + vjp(ct)
    f = jax.jit(shard_map(fn, mesh=mesh2, in_specs=(sp,) * 4,
                          out_specs=(sp,) * 4, check_vma=False))
    res = f(*(jnp.asarray(d["a." + x]) for x in ("q", "k", "v", "ct")))
    for x, r in zip(("out", "dq", "dk", "dv"), res):
        out[f"a.{name}.{x}"] = np.asarray(r)
out["a.cpus"] = np.int64(len(os.sched_getaffinity(0)))
# (b) one step at 2 x 2, batch 2; (d) batch 4 with no global_batch
arch = get_config("gpt-350m").reduced()
mesh = make_mesh((2, 2), AXES, devices=jax.devices()[:4])
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           reduce_dtype=jnp.float32)
p4 = {k[3:]: jnp.asarray(v) for k, v in d.items() if k.startswith("p4.")}
b2 = {k[3:]: d[k] for k in d if k.startswith("b2.")}
b4 = {k[3:]: d[k] for k in d if k.startswith("b4.")}
cfg = AdamWConfig(lr=LR)
for name, over in (("qgz_off", dict(qgz=False)), ("zeropp", {})):
    m = Model(arch, make_policy(arch, AXES, "zeropp", **over, **F32).zcfg,
              world=4)
    specs = param_specs(m, AXES)
    rs = RunSpec(mode="train", seq_axes=("model",), attn_impl="xla")
    bspec = trainer.batch_specs(m, AXES, ("data",), ("model",))
    def lg(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: m.loss_fn(p, b, rs, 4), has_aux=True)(p)
        return jax.lax.psum(loss, AXES), g
    f = jax.jit(shard_map(lg, mesh=mesh, in_specs=(specs, bspec),
                          out_specs=(P(), specs), check_vma=False))
    loss, g = f(p4, b2)
    out[name + ".loss"] = np.asarray(loss)
    put(name + ".g.", g)
    ts = trainer.build_train_step(m, mesh, cfg, donate=False, global_batch=2)
    assert ts.run_spec.seq_axes == ("model",), ts.run_spec
    p, o, met = ts.fn(p4, init_opt_state(p4, cfg),
                      trainer.place_batch(b2, mesh, ts.in_specs[2]))
    put(name + ".p.", p)
    put(name + ".m.", o["m"])
    put(name + ".v.", o["v"])
    put(name + ".met.", met)
    if name == "qgz_off":
        ts = trainer.build_train_step(m, mesh, cfg, donate=False)
        assert ts.run_spec.seq_axes == ("model",), ts.run_spec
        p, o, met = ts.fn(p4, init_opt_state(p4, cfg),
                          trainer.place_batch(b4, mesh, ts.in_specs[2]))
        put("force.m.", o["m"])
        put("force.met.", met)
np.savez(sys.argv[2], **out)
"""


def _attn_inputs():
    B, S, H, K, hd = ATTN
    rng = np.random.default_rng(3)
    return {"q": rng.standard_normal((B, S, H, hd)).astype(np.float32),
            "k": rng.standard_normal((B, S, K, hd)).astype(np.float32),
            "v": rng.standard_normal((B, S, K, hd)).astype(np.float32),
            "ct": rng.standard_normal((B, S, H, hd)).astype(np.float32)}


def _mha_rank(rank, world, inputs):
    """(a): this rank's output and q/k/v gradients for each route."""
    s = ATTN[1] // world
    loc = {k: torch.from_numpy(v[:, rank * s:(rank + 1) * s].copy())
           for k, v in inputs.items()}
    out = {}
    for name, chunk in CHUNKS.items():
        q, k, v = (loc[x].clone().requires_grad_(True) for x in "qkv")
        o = tattn.mha(q, k, v, seq_axes=("model",), kv_chunk=chunk)
        o.backward(loc["ct"])
        out[name] = {"out": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    out["env"] = {"threads": torch.get_num_threads(),
                  "cpus": len(os.sched_getaffinity(0)),
                  "isa": torch.backends.cpu.get_cpu_capability()}
    return out


def _attn64(a):
    """Causal GQA attention's output and q/k/v gradients in float64 on the
    whole sequence: the oracle that says which side moved when the port
    and the reference disagree."""
    q, k, v = (torch.from_numpy(a[x]).double().requires_grad_(True)
               for x in "qkv")
    rep = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    S = q.shape[1]
    lg = torch.einsum("bqhd,bshd->bhqs", q, kk) * q.shape[-1] ** -0.5
    lg = lg.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                        float("-inf"))
    o = torch.einsum("bhqs,bshd->bqhd", lg.softmax(-1), vv)
    o.backward(torch.from_numpy(a["ct"]).double())
    return {"out": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            info = {k.strip(): v.strip() for k, v in
                    (line.split(":", 1) for line in fh if ":" in line)}
    except OSError:
        return "unknown"
    return (f"{info.get('model name')}, family {info.get('cpu family')} "
            f"model {info.get('model')}")


def _step(model, params, batch, scales=None, **kw):
    """One ``loss_and_grads`` and one step from ``params``; with a dict
    ``scales``, the scales B4 and B5 read in the first (call order)."""
    step = trainer.build_train_step(model, AdamWConfig(lr=LR), device="cpu",
                                    **kw)
    opt = init_opt_state(params)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with contextlib.ExitStack() as stack:
        if scales is not None:
            stack.enter_context(_recording(scales))
        loss, mets, grads = step.loss_and_grads(params, tb)
    m = step.fn(params, opt, tb)
    return dict(loss=float(loss), tokens=mets["tokens"],
                grads=to_numpy(grads), params=to_numpy(params),
                opt=to_numpy(opt), met={k: float(v) for k, v in m.items()},
                seq_axes=step.run_spec.seq_axes, scales=scales)


@contextlib.contextmanager
def _recording(scales):
    """Record the scales B4 (``dequant_reduce_quant``) and B5
    (``dequant_reduce``) read, per call, into ``scales["b4"]``/``["b5"]``."""
    real = {"b4": tops.dequant_reduce_quant, "b5": tops.dequant_reduce}
    names = {"b4": "dequant_reduce_quant", "b5": "dequant_reduce"}

    def rec(key):
        def f(payload, sc, *a, **kw):
            scales.setdefault(key, []).append(sc.numpy().copy())
            return real[key](payload, sc, *a, **kw)
        return f
    for key, name in names.items():
        setattr(tops, name, rec(key))
    try:
        yield
    finally:
        for key, name in names.items():
            setattr(tops, name, real[key])


def _world4_rank(rank, world, p4, b1, b2, b4):
    """(b), (c), (d) at world 4 (2 × 2)."""
    arch = get_config(ARCH).reduced()
    mesh = mesh_lib.make_mesh(MESH)
    out = {}
    for name, over in VARIANTS.items():
        pol = make_policy(arch, mesh_lib.AXES, "zeropp", mesh=mesh, **over,
                          **TF32)
        model = Model(arch, pol.zcfg, world=world, device="cpu")
        fresh = lambda: params_from_numpy(p4, model, rank=rank,  # noqa: E731
                                          world=world)
        out[name] = _step(model, fresh(), b2, global_batch=2,
                          scales={} if name == "zeropp" else None)
        if name == "qgz_off":
            out["batch1"] = _step(model, fresh(), b1, global_batch=1)
            out["force"] = _step(model, fresh(), b4)
            out["auto4"] = _step(model, fresh(), b4, global_batch=FORCE_BATCH)
    # the sequence the gather returns: every rank's positions, global order
    S = SEQ
    s = S // world
    off = tattn.seq_shard_offset(s, ("data", "model"))
    pos = (off + torch.arange(s, dtype=torch.float32)).reshape(1, s, 1, 1)
    out["gathered"] = tattn._gather_seq(pos, ("data", "model")).reshape(
        -1).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqpar")
    p4 = _init(_port_model(4), 1)
    b1, b2, b4 = _batch(1), _batch(2), _batch(FORCE_BATCH)
    a = _attn_inputs()
    arrays = {"lr": np.float32(LR)}
    arrays.update({"p4." + k: v for k, v in p4.items()})
    arrays.update({"b2." + k: v for k, v in b2.items()})
    arrays.update({"b4." + k: v for k, v in b4.items()})
    arrays.update({"a." + k: v for k, v in a.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(d / "in.npz"), str(d / "out.npz")],
                               env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            attn = mesh_lib.spawn(_mha_rank, 2, a, device="cpu")
            w4 = mesh_lib.spawn(_world4_rank, 4, p4, b1, b2, b4,
                                device="cpu")
            ref.wait(timeout=300)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (d / "ref.log").read_text()
    return dict(attn=attn, w4=w4, p4=p4, b1=b1,
                ref=dict(np.load(d / "out.npz")))


@pytest.mark.parametrize("route", sorted(CHUNKS))
def test_mha_with_the_sequence_on_two_ranks_matches_reference(runs, route):
    ref = runs["ref"]
    got = {x: np.concatenate([r[route][x] for r in runs["attn"]], axis=1)
           for x in ("out", "dq", "dk", "dv")}
    why = _diagnosis(got, ref, route, runs["attn"])
    for x, g in got.items():
        np.testing.assert_allclose(g, ref[f"a.{route}.{x}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{route} {x}\n{why}")


def _diagnosis(got, ref, route, ranks) -> str:
    """What a failure of the test above needs to name its cause: for each
    tensor the elements over the bar, the largest |port − reference| and
    where it lies (a 16-key chunk boundary or not), each side's distance
    from the float64 oracle, and the machine both sides ran on."""
    exact = _attn64(_attn_inputs())
    lines = []
    for x, g in got.items():
        want = ref[f"a.{route}.{x}"]
        diff = np.abs(g - want)
        over = ~(diff <= 1e-5 + 1e-5 * np.abs(want))
        worst = np.unravel_index(np.nanargmax(diff), diff.shape)
        lines.append(
            f"  {x}: {int(over.sum())} of {diff.size} over the bar; max "
            f"|port - ref| {np.nanmax(diff):.4e} at (b, s, h, d) "
            f"{tuple(int(i) for i in worst)}; max |port - f64| "
            f"{np.nanmax(np.abs(g - exact[x])):.4e}, |ref - f64| "
            f"{np.nanmax(np.abs(want - exact[x])):.4e}")
    envs = [r["env"] for r in ranks]
    lines.append(f"  port ranks {envs}; reference CPUs {int(ref['a.cpus'])}"
                 f"; host {_cpu_model()}")
    return "\n".join(lines)


def _hold_metrics(ranks, ref, name, rows):
    """Summed loss, tokens and the step's metrics of ``name`` against the
    reference's; returns the ranks' tiles."""
    tiles = [r[name] for r in ranks]
    assert all(t["seq_axes"] == ("model",) for t in tiles)
    assert [t["tokens"] for t in tiles] == [rows * SEQ / 4] * 4
    mets = [t["met"] for t in tiles]
    assert all(m == mets[0] for m in mets), "ranks disagree on the metrics"
    jm = _ref_tree(ref, name + ".met.")
    assert abs(mets[0]["loss"] - float(jm["loss"])) <= 1e-5
    assert mets[0]["tokens"] == float(jm["tokens"]) == rows * SEQ
    np.testing.assert_allclose(mets[0]["nll"], jm["nll"], rtol=1e-5)
    return tiles, mets[0]


def test_batch2_step_at_2x2_matches_reference_with_qgz_off(runs):
    ref = runs["ref"]
    tiles, met = _hold_metrics(runs["w4"], ref, "qgz_off", 2)
    assert abs(sum(t["loss"] for t in tiles) - float(ref["qgz_off.loss"])) \
        <= 1e-5
    tg, jg = _glued([t["grads"] for t in tiles]), _ref_tree(ref, "qgz_off.g.")
    tm = _glued([t["opt"]["m"] for t in tiles])
    tv = _glued([t["opt"]["v"] for t in tiles])
    for k in jg:
        step_bars.close(tg[k], jg[k], f"grad {k}")
        step_bars.close(tm[k], ref["qgz_off.m." + k], f"m {k}")
        step_bars.close(tv[k], ref["qgz_off.v." + k], f"v {k}")
    jn = float(ref["qgz_off.met.grad_norm"])
    np.testing.assert_allclose(met["grad_norm"], jn, rtol=1e-5)
    tp = _glued([t["params"] for t in tiles])
    step_bars.params_near(
        tp, _ref_tree(ref, "qgz_off.p."),
        {k: step_bars.first_step_dir(tg[k], met["grad_norm"]) for k in tp},
        {k: step_bars.first_step_dir(jg[k], jn) for k in tp}, LR)


def _path_steps(tiles, grads):
    """Each gradient block's bar (``step_bars.qgz_path_steps``) from the
    scales every rank's B4 and B5 read, (rows, blocks) per buffer.  The
    reduces run in the backward's order: the groups stacked in rows (the
    layers, the unembedding chunks) last row first."""
    by_nb = {}
    for b4, b5 in zip(zip(*(t["scales"]["b4"] for t in tiles)),
                      zip(*(t["scales"]["b5"] for t in tiles))):
        by_nb.setdefault(b5[0].shape[-1], []).append(
            step_bars.qgz_path_steps(b4, b5, MESH))
    out = {}
    for k, g in grads.items():
        rows = g.reshape(-1, g.shape[-1])
        nb = rows.shape[1] // 4 // step_bars.BLOCK
        got = by_nb.pop(nb)
        assert len(got) == rows.shape[0], (k, len(got))
        out[k] = np.stack(got[::-1])
    assert not by_nb, sorted(by_nb)
    return out


def test_batch2_step_at_2x2_matches_reference_with_full_zeropp(runs):
    ref = runs["ref"]
    tiles, met = _hold_metrics(runs["w4"], ref, "zeropp", 2)
    assert abs(sum(t["loss"] for t in tiles) - float(ref["zeropp.loss"])) \
        <= 1e-5
    tg, jg = _glued([t["grads"] for t in tiles]), _ref_tree(ref, "zeropp.g.")
    far = step_bars.far_share(MESH)
    steps = _path_steps(tiles, jg)
    step_bars.grads_within_int4(tg, jg, far, steps)
    gdiff = np.sqrt(sum(np.sum((tg[k].astype(np.float64) - jg[k]) ** 2)
                        for k in tg))
    jn = float(ref["zeropp.met.grad_norm"])
    assert abs(met["grad_norm"] - jn) <= gdiff + 1e-5 * jn
    to = {mv: _glued([t["opt"][mv] for t in tiles]) for mv in ("m", "v")}
    jo = {mv: _ref_tree(ref, f"zeropp.{mv}.") for mv in ("m", "v")}
    clip = min(1.0, 1.0 / (jn + 1e-12))
    step_bars.moments_within_int4(to, jo, far,
                                  g_steps={k: v * clip
                                           for k, v in steps.items()})
    tp = _glued([t["params"] for t in tiles])
    step_bars.params_near(tp, _ref_tree(ref, "zeropp.p."),
                          {k: step_bars.moment_dir(to, k) for k in tp},
                          {k: step_bars.moment_dir(jo, k) for k in tp}, LR,
                          far)


def _world1(p4):
    """The world-4 buffers re-fit onto the world-1 layout (the same entries
    at the same offsets; only the zero padding is shorter), and that
    model (qgZ off, fp32)."""
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch, qgz=False, **TF32).zcfg,
                  device="cpu")
    p1 = {}
    for k, n in model.param_shapes().items():
        assert not p4[k][..., n[-1]:].any()
        p1[k] = p4[k][..., :n[-1]]
    return model, p1


def test_batch1_step_at_2x2_matches_world1(runs):
    """(c): the sequence over both axes, against the port's world 1."""
    tiles = [r["batch1"] for r in runs["w4"]]
    assert all(t["seq_axes"] == ("data", "model") for t in tiles)
    assert [t["tokens"] for t in tiles] == [SEQ / 4] * 4
    model, p1 = _world1(runs["p4"])
    one = _step(model, params_from_numpy(p1, model), runs["b1"],
                global_batch=1)
    assert one["seq_axes"] == ()
    assert abs(sum(t["loss"] for t in tiles) - one["loss"]) <= 1e-5
    g4 = _glued([t["grads"] for t in tiles])
    for k, g in one["grads"].items():
        assert not g4[k][..., g.shape[-1]:].any()
        step_bars.close(g4[k][..., :g.shape[-1]], g, f"grad {k}")
    assert abs(tiles[0]["met"]["loss"] - one["met"]["loss"]) <= 1e-5
    np.testing.assert_allclose(tiles[0]["met"]["grad_norm"],
                               one["met"]["grad_norm"], rtol=1e-5)


def test_gathered_sequence_is_in_global_order(runs):
    """(c): ``_gather_seq`` over ("data", "model") returns every rank's
    positions in global order, 0 … S-1, on every rank (the reference's
    gives [0..15, 32..47, 16..31, 48..63] here)."""
    for r in runs["w4"]:
        np.testing.assert_array_equal(r["gathered"], np.arange(SEQ))


def test_no_global_batch_forces_the_reference_layout(runs):
    """(d) at 2 × 2: batch 4 over ``data``, the sequence over ``model``,
    against the reference's step built without ``global_batch``; and the
    same loss as the pure data-parallel layout that ``global_batch=4``
    picks."""
    ref = runs["ref"]
    tiles, met = _hold_metrics(runs["w4"], ref, "force", FORCE_BATCH)
    tm = _glued([t["opt"]["m"] for t in tiles])
    for k, v in _ref_tree(ref, "force.m.").items():
        step_bars.close(tm[k], v, f"m {k}")
    np.testing.assert_allclose(met["grad_norm"],
                               float(ref["force.met.grad_norm"]), rtol=1e-5)
    auto = [r["auto4"] for r in runs["w4"]]
    assert all(t["seq_axes"] == () for t in auto)
    assert abs(auto[0]["met"]["loss"] - met["loss"]) <= 1e-5


def test_no_global_batch_forces_the_sequence_layout_at_world1():
    """(d) at world 1: the forced layout puts the sequence on ``model``,
    which has size 1 there and so carries nothing.  The port leaves it out
    (the reference names it, and its ``mha`` drops the flash kernels), so
    a step under ``attn_impl="pallas"`` keeps the flash kernels with or
    without ``global_batch``."""
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch).zcfg, device="cpu")
    for gb in (None, 1):
        st = trainer.build_train_step(model, AdamWConfig(), device="cpu",
                                      attn_impl="pallas", global_batch=gb)
        assert st.run_spec.seq_axes == ()
        assert st.run_spec.seq_group is None
        assert st.run_spec.attn_impl == "pallas"


def test_mha_keeps_the_flash_kernels_out_of_a_sharded_sequence(monkeypatch):
    """The reference's rule (``attention.py:101``): the flash kernels need
    an unsharded sequence; a named sequence axis takes the chunked route
    even where its world is 1."""
    called = []
    monkeypatch.setattr(tattn, "flash_attention_kernel",
                        lambda *a: called.append(1) or a[0])
    q = torch.randn(1, 1024, 2, 16)
    k = v = torch.randn(1, 1024, 1, 16)
    tattn.mha(q, k, v, impl="pallas")
    assert called == [1]
    out = tattn.mha(q, k, v, seq_axes=("model",), impl="pallas",
                    kv_chunk=512)
    assert called == [1]
    torch.testing.assert_close(out, tattn.mha(q, k, v, kv_chunk=512),
                               rtol=0, atol=0)


def test_spawn_runs_on_the_card_unless_asked():
    """``mesh.spawn`` defaults to the card: without one it raises before
    any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.spawn(_mha_rank, 2, _attn_inputs())
