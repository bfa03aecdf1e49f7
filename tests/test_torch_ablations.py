"""Port vs reference: the paper's ablation knobs and their collectives at
world 4 (2 × 2), on gloo ranks.

  (a) ``quant.quantize_global`` / ``dequantize_global`` (the non-blocked
      scheme of Fig. 2) bit for bit against the reference's under
      ``jax.jit`` at INT8 and INT4, fp32 and bf16 inputs, and the port's
      copy of ``tests/test_quant.py``'s "blocked beats global on
      outliers" (3x);
  (b) the wire arithmetic: ``wire_label``, ``event_wire_bytes`` and
      ``step_wire_by_label`` equal the reference's for every knob
      (``qwz_blocked``, ``hpz_axes``, ``qgz_bits``, ``qgz_2hop``) at 2 × 2,
      4 × 2 and 2 × 2 × 2, on qwen3-0.6b at full width and gpt-350m
      reduced, and qwen3-0.6b's MiB a rank at 2 × 2 are the reference
      projection's;
  (c) the collectives on 4 ranks, each bit for bit against the
      reference's output on the same global input (4 simulated devices,
      a (2, 2) mesh) and within the reference check's own bar against the
      fp32 oracle: the 1-hop and the quantized ring
      (``check_qgz_1hop_and_ring``'s sizes: INT8, block 32; and INT4,
      block 64), the non-blocked qwZ gather (fp32 INT8 and bf16 INT4) and
      INT8 2-hop qgZ (``check_qgz_matches_reduce_scatter``'s INT8 case);
      the misaligned 1-hop raises ``ValueError`` (``checks.py:1080``);
  (d) one training step of gpt-350m reduced (2 layers, d 64, vocab 128,
      seq 64, batch 8: two rows a rank) at 2 × 2 under each knob, fp32
      compute (and one with ``grad_dtype=bfloat16``, the optimizer-side
      gradients), against the reference's step with the same override on
      the same global fp32 state: the loss within 1e-5; gradients, m and v
      within what the rounding flips on each element's qgZ path can move
      it by (``step_bars.path_steps``, from the scales every rank's B4
      and B5 read: at Y > 1 a flip moves an element by a step of the
      block that flipped, not of the final sum) and beyond the tight bar
      (rtol 1e-5 / atol 1e-6) in at most ``step_bars.far_share`` of the
      elements (3 in 1,000; 2 in 1,000 on the 1-hop, which quantizes each
      value once); the parameters within the first step's direction bar;
      and every rank's counted bytes per label equal to the projection to
      the byte.

Every rank runs all of its cases in one spawn, while the reference's
subprocess runs beside it.  The module imports the reference only inside
the tests: each spawned rank imports this module.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import collectives as cl               # noqa: E402
from repro_torch.core import quant as tq                     # noqa: E402
from repro_torch.core import zeropp as tz                    # noqa: E402
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
MESH, BATCH = (2, 2), 8
TF32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
            reduce_dtype=torch.float32)
# the knobs, as make_policy keywords (the reference's names and values)
KNOBS = {"qwz_nonblocked": dict(qwz_blocked=False),
         "qgz_int8": dict(qgz_bits=8),
         "qgz_1hop": dict(qgz_2hop=False),
         "hpz_world": dict(hpz_axes=("data", "model"))}
# (d) also steps with bf16 optimizer-side gradients, which move no wire byte
STEP_KNOBS = dict(KNOBS, grad_bf16=dict(grad_dtype=torch.bfloat16))
# (c): (name, bits, block, elements a rank)
RS_CASES = (("int8", 8, 32, 4 * 32 * 4), ("int4", 4, 64, 4 * 64 * 4))
GATHER_CASES = (("f32_int8", 8, "float32", 1024), ("bf16_int4", 4,
                                                   "bfloat16", 1024))
QGZ8 = (8, 32, 32 * 8)      # check_qgz_matches_reduce_scatter's INT8 case
# qwen3-0.6b at prefetch 0, MiB a rank a step (the reference's
# step_wire_by_label)
QWEN_MIB = {
    ("2x2", ""): {"zero.qwz_gather": 546.025, "zero.hpz_gather": 716.833,
                  "zero.qgz_reduce": 277.213},
    ("2x2", "qwz_nonblocked"): {"zero.qwz_gather": 537.625,
                                "zero.hpz_gather": 716.833,
                                "zero.qgz_reduce": 277.213},
    ("2x2", "qgz_int8"): {"zero.qwz_gather": 546.025,
                          "zero.hpz_gather": 716.833,
                          "zero.qgz_reduce": 546.025},
    ("2x2", "qgz_1hop"): {"zero.qwz_gather": 546.025,
                          "zero.hpz_gather": 716.833,
                          "zero.qgz_reduce1hop": 277.213},
    ("2x2", "hpz_world"): {"zero.qwz_gather": 546.025,
                           "zero.hpz_gather": 1075.25,
                           "zero.qgz_reduce": 277.213},
    ("2x2x2", ""): {"zero.qwz_gather": 637.055, "zero.hpz_gather": 716.861,
                    "zero.qgz_reduce": 323.428},
    ("2x2x2", "hpz_world"): {"zero.qwz_gather": 637.055,
                             "zero.hpz_gather": 1075.292,
                             "zero.qgz_reduce": 323.428},
}


def _inputs():
    """Every global input of (c) and (d), drawn with numpy."""
    rng = np.random.default_rng(2)
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch).zcfg, world=4, device="cpu")
    d = {"p." + k: v for k, v in step_bars.global_params(model, 1).items()}
    d.update({"b." + k: v for k, v in tsyn.make_batch(
        arch, tsyn.SyntheticLM(arch.vocab, SEQ, seed=7), 0, BATCH).items()})
    for name, _, _, n in RS_CASES:
        d["rs." + name] = rng.normal(size=(4 * n,)).astype(np.float32)
    for name, _, _, n in GATHER_CASES:
        x = (rng.normal(size=(4 * n,)) * 0.02).astype(np.float32)
        x[::97] *= 40                                  # outliers per shard
        d["ag." + name] = x
    d["q8"] = rng.normal(size=(4 * QGZ8[2],)).astype(np.float32)
    d["lr"] = np.float32(LR)
    return d


_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
AXES = ("data", "model")
mesh = make_mesh((2, 2), AXES)
spec = P(AXES)
out = {}
def sm(f):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec))
for name, bits, block in (("int8", 8, 32), ("int4", 4, 64)):
    cfg = QuantConfig(bits=bits, block_size=block)
    g = jnp.asarray(d["rs." + name])
    out["1hop." + name] = np.asarray(sm(
        lambda x: cl.qgz_reduce_scatter_1hop(x, AXES, cfg))(g))
    out["ring." + name] = np.asarray(sm(
        lambda x: cl.qgz_quantized_ring_reduce_scatter(x, AXES, cfg))(g))
for name, bits, dt in (("f32_int8", 8, jnp.float32),
                       ("bf16_int4", 4, jnp.bfloat16)):
    cfg = QuantConfig(bits=bits, block_size=256)
    x = jnp.asarray(d["ag." + name]).astype(dt)
    out["ag." + name] = np.asarray(sm(lambda s: cl.qwz_all_gather(
        s, AXES, cfg, out_dtype=jnp.float32, blocked=False))(x))
cfg = QuantConfig(bits=8, block_size=32)
out["q8"] = np.asarray(sm(lambda x: cl.qgz_reduce_scatter(
    x, "model", ("data",), cfg))(jnp.asarray(d["q8"])))
def tree(prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in d.items()
            if k.startswith(prefix)}
def put(prefix, t):
    for k, v in t.items():     # bf16 (grad_dtype) as float32: exact
        out[prefix + k] = np.asarray(jnp.asarray(v, jnp.float32)
                                     if v.dtype == jnp.bfloat16 else v)
arch = get_config("gpt-350m").reduced()
batch = {k[2:]: d[k] for k in d if k.startswith("b.")}
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           reduce_dtype=jnp.float32)
rs = RunSpec(mode="train", seq_axes=(), attn_impl="xla")
KNOBS = {"qwz_nonblocked": dict(qwz_blocked=False),
         "qgz_int8": dict(qgz_bits=8), "qgz_1hop": dict(qgz_2hop=False),
         "hpz_world": dict(hpz_axes=("data", "model")),
         "grad_bf16": dict(grad_dtype=jnp.bfloat16)}
for name, over in KNOBS.items():
    m = Model(arch, make_policy(arch, AXES, "zeropp", **over, **F32).zcfg,
              world=4)
    specs = param_specs(m, AXES)
    p = tree("p.")
    def lg(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: m.loss_fn(p, b, rs, 4), has_aux=True)(p)
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


def _shard(x, rank, world):
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _collectives(rank, world, d, mesh):
    """(c): this rank's output of every collective case."""
    out = {}
    for name, bits, block, _ in RS_CASES:
        cfg = tq.QuantConfig(bits=bits, block_size=block)
        g = _shard(d["rs." + name], rank, world)
        out["1hop." + name] = cl.qgz_reduce_scatter_1hop(g, None,
                                                         cfg).numpy()
        out["ring." + name] = cl.qgz_quantized_ring_reduce_scatter(
            g, None, cfg).numpy()
    for name, bits, dt, _ in GATHER_CASES:
        cfg = tq.QuantConfig(bits=bits, block_size=256)
        x = _shard(d["ag." + name], rank, world).to(getattr(torch, dt))
        out["ag." + name] = cl.qwz_all_gather(
            x, None, cfg, out_dtype=torch.float32, blocked=False).numpy()
    bits, block, _ = QGZ8
    out["q8"] = cl.qgz_reduce_scatter(
        _shard(d["q8"], rank, world), mesh.intra, mesh.inter,
        tq.QuantConfig(bits=bits, block_size=block)).numpy()
    # the reference's misaligned input (checks.py:1080): world·32 + 8 a rank
    try:
        cl.qgz_reduce_scatter_1hop(torch.ones(world * 32 + 8), None,
                                   tq.QuantConfig(bits=8, block_size=32))
        out["misaligned"] = "accepted"
    except ValueError as e:
        out["misaligned"] = str(e)
    # a wider hpz_axes without its group must not fall back to the intra
    # group; hpz_axes of the intra axis alone may
    for name, kw in (("zcfg", dict(intra_group=mesh.intra,
                                   inter_group=mesh.inter)),
                     ("policy", None)):
        try:
            if kw is None:
                make_policy(get_config(ARCH).reduced(), mesh.axes,
                            hpz_axes=("data", "model"))
            else:
                tz.ZeroConfig(hpz_axes=("data", "model"), **kw)
            out["hpz_no_group." + name] = "accepted"
        except ValueError as e:
            out["hpz_no_group." + name] = str(e)
    out["hpz_intra"] = cl.world_size(tz.ZeroConfig(
        hpz_axes=("model",), intra_group=mesh.intra).hpz_group)
    return out


def _steps(rank, world, d, mesh):
    """(d): each knob's loss and gradient shards, one step's metrics,
    parameter and moment shards, and the bytes the step counted."""
    out = {}
    arch = get_config(ARCH).reduced()
    p = {k[2:]: v for k, v in d.items() if k.startswith("p.")}
    tb = {k[2:]: torch.from_numpy(v).long() for k, v in d.items()
          if k.startswith("b.")}
    for name, over in STEP_KNOBS.items():
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
        out[name] = dict(
            loss=float(loss), scales=scales, grads=to_numpy(grads),
            params=to_numpy(params),
            opt=to_numpy(opt), met={k: float(v) for k, v in m.items()},
            comm=tlaunch.comm_since(sent),
            projected=projected_wire_by_label(model, mesh.sizes),
            hpz_world=cl.world_size(pol.zcfg.hpz_group),
            grads_bf16=all(torch.equal(v, v.bfloat16().to(v.dtype))
                           for v in grads.values()))
    try:        # beyond one rank the step needs its mesh
        trainer.build_train_step(model, AdamWConfig(), device="cpu")
        out["no_mesh"] = "accepted"
    except ValueError as e:
        out["no_mesh"] = str(e)
    return out


def _rank(rank, world, d):
    mesh = mesh_lib.make_mesh(MESH)
    return dict(coll=_collectives(rank, world, d, mesh),
                steps=_steps(rank, world, d, mesh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ablations")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(tmp / "in.npz"), str(tmp / "out.npz")],
                               env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            ranks = mesh_lib.spawn(_rank, 4, d, device="cpu")
            ref.wait(timeout=400)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (tmp / "ref.log").read_text()
    return dict(ranks=ranks, d=d, ref=dict(np.load(tmp / "out.npz")))


# ---------------------------------------------------------------------------
# (a) the non-blocked scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bits", (8, 4))
def test_quantize_global_matches_the_jitted_reference(bits, dtype):
    import jax
    import jax.numpy as jnp
    from repro.core import quant as jq
    q_jit = jax.jit(jq.quantize_global, static_argnums=1)
    dq_jit = jax.jit(jq.dequantize_global, static_argnums=(2, 3))
    for seed in range(8):
        x = np.random.default_rng(seed).normal(size=(4096,)).astype(
            np.float32) * (3.0 if seed % 2 else 0.02)
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        jp, js = q_jit(xj, bits)
        xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
            getattr(torch, dtype))
        tp, ts = tq.quantize_global(xt, bits)
        assert tp.dtype == torch.int8 and tuple(ts.shape) == ()
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert np.float32(ts.item()).tobytes() == \
            np.asarray(js, np.float32).tobytes()
        jd = dq_jit(jp, js, bits, jnp.float32)
        np.testing.assert_array_equal(
            tq.dequantize_global(tp, ts, bits).numpy(), np.asarray(jd))
    zp, zs = tq.quantize_global(torch.zeros(64), bits)
    assert zs.item() == 0.0 and not zp.any()


def test_blocked_beats_global_on_outliers():
    """The port's copy of ``tests/test_quant.py``'s Fig. 2 check: block
    quantization cuts the mean error at least 3x on weights with an
    outlier channel."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4096,)) * 0.02).astype(np.float32)
    x[:16] = 3.0
    xt = torch.from_numpy(x)
    cfg = tq.QuantConfig(bits=8, block_size=64)
    qb, sb = tq.quantize_blockwise(xt, cfg)
    e_block = float((tq.dequantize_blockwise(qb, sb, cfg) - xt).abs().mean())
    qg, sg = tq.quantize_global(xt, 8)
    e_glob = float((tq.dequantize_global(qg, sg, 8) - xt).abs().mean())
    assert e_block < e_glob / 3


# ---------------------------------------------------------------------------
# (b) the wire arithmetic of every knob
# ---------------------------------------------------------------------------

ARCHS = {"qwen3-0.6b": None, "gpt-350m-reduced": {}}
SHAPES = {"2x2": (2, 2), "4x2": (4, 2), "2x2x2": (2, 2, 2)}


def _models(arch_name, shape, over):
    from repro.configs import get_config as rget
    from repro.models.model import Model as RModel
    from repro.train.policy import make_policy as rpolicy
    name = arch_name.split("-reduced")[0]
    red = ARCHS[arch_name]
    arch, rarch = get_config(name), rget(name)
    if red is not None:
        arch, rarch = arch.reduced(**red), rarch.reduced(**red)
    axes = mesh_lib.axes_of(shape)
    world = int(np.prod(shape))
    rm = RModel(rarch, rpolicy(rarch, axes, "zeropp", prefetch=0,
                               **over).zcfg, world=world)
    pm = Model(arch, make_policy(arch, axes, "zeropp", **over).zcfg,
               world=world, device="cpu")
    return rm, pm, dict(zip(axes, shape))


@pytest.mark.parametrize("knob", [""] + sorted(KNOBS))
@pytest.mark.parametrize("size", sorted(SHAPES))
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_knob_wire_arithmetic_equals_the_reference(arch_name, size, knob):
    from repro.core import zeropp as rz
    rm, pm, sizes = _models(arch_name, SHAPES[size], KNOBS.get(knob, {}))
    ev = rm.comm_events()
    assert pm.comm_events() == ev
    for e in ev:
        assert tz.wire_label(e["kind"], pm.zcfg) == \
            rz.wire_label(e["kind"], rm.zcfg)
        assert tz.event_wire_bytes(e["kind"], e["elems"], pm.zcfg, sizes) \
            == rz.event_wire_bytes(e["kind"], e["elems"], rm.zcfg, sizes)
    got = tz.step_wire_by_label(ev, pm.zcfg, sizes)
    assert got == rz.step_wire_by_label(ev, rm.zcfg, sizes)
    assert got == projected_wire_by_label(pm, sizes)
    assert set(got) <= set(tz.WIRE_LABELS)
    assert pm.zcfg.secondary_axes == rm.zcfg.secondary_axes
    assert pm.zcfg.qgz_cfg.bits == rm.zcfg.qgz_cfg.bits


@pytest.mark.parametrize("case", sorted(QWEN_MIB), ids="-".join)
def test_qwen3_projects_the_references_mib(case):
    size, knob = case
    rm, pm, sizes = _models("qwen3-0.6b", SHAPES[size], KNOBS.get(knob, {}))
    got = projected_wire_by_label(pm, sizes)
    assert {k: round(v / 2 ** 20, 3) for k, v in got.items()} == \
        QWEN_MIB[case]


def test_one_hop_sends_the_two_hops_bytes_a_rank():
    """At 2 x 2 and 2 x 2 x 2 the 1-hop's bytes a rank equal the 2-hop's
    (3n/4, 7n/8 of the packed message): the totals do not show the slow
    tier's blow-up, which a per-tier split would."""
    for shape in ((2, 2), (2, 2, 2)):
        sizes = dict(zip(mesh_lib.axes_of(shape), shape))
        two = tz.ZeroConfig(dp_axes=tuple(sizes))
        one = tz.ZeroConfig(dp_axes=tuple(sizes), qgz_2hop=False)
        n = 1 << 20
        assert tz.event_wire_bytes("grad_reduce", n, one, sizes) == \
            tz.event_wire_bytes("grad_reduce", n, two, sizes)


def test_knob_fields_are_the_references():
    import dataclasses
    from repro.core.zeropp import ZeroConfig as RZ
    mine = {f.name: f.default for f in dataclasses.fields(tz.ZeroConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(RZ)}
    # the port's process groups have no counterpart in a jax mesh
    groups = {"group", "intra_group", "inter_group", "secondary_group"}
    assert set(ref) <= set(mine) and set(mine) - set(ref) == groups
    for k in ("qwz_blocked", "hpz_axes", "qgz_bits", "qgz_2hop"):
        assert mine[k] == ref[k], k
    assert mine["grad_dtype"] == torch.float32
    z = tz.ZeroConfig(qwz_blocked=False)
    assert not tz.qwz_gemm_eligible(z, 256, 1024)
    assert tz.qwz_gemm_eligible(tz.ZeroConfig(), 256, 1024)
    assert tz.ZeroConfig(hpz_axes=("data", "model")).secondary_axes == \
        ("data", "model")
    assert tz.ZeroConfig().secondary_axes == ("model",)
    assert tz.ZeroConfig(qgz_bits=8).qgz_cfg.bits == 8


# ---------------------------------------------------------------------------
# (c) the collectives on 4 ranks
# ---------------------------------------------------------------------------

def _glued(runs, key):
    return np.concatenate([r["coll"][key] for r in runs["ranks"]])


def _oracle(g, world):
    """The fp32 reduce-scatter: rank r's slice r of the sum of the ranks'
    gradients."""
    return g.reshape(world, -1).astype(np.float64).sum(0).astype(np.float32)


@pytest.mark.parametrize("case", RS_CASES, ids=lambda c: c[0])
def test_one_hop_and_ring_match_reference(runs, case):
    name, bits, _, _ = case
    g = runs["d"]["rs." + name]
    got1, gotr = _glued(runs, "1hop." + name), _glued(runs, "ring." + name)
    np.testing.assert_array_equal(got1, runs["ref"]["1hop." + name])
    np.testing.assert_array_equal(gotr, runs["ref"]["ring." + name])
    # check_qgz_1hop_and_ring's bars against the oracle
    want, qmax = _oracle(g, 4), 7.0 if bits == 4 else 127.0
    amax = np.abs(g).max()
    e1, er = np.abs(got1 - want).max(), np.abs(gotr - want).max()
    assert e1 < 4 * amax / qmax, e1
    assert np.corrcoef(gotr, want)[0, 1] > 0.99
    assert er >= e1 * 0.5, (er, e1)


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: c[0])
def test_nonblocked_gather_matches_reference(runs, case):
    name, bits, dt, n = case
    got = _glued(runs, "ag." + name)
    np.testing.assert_array_equal(got, runs["ref"]["ag." + name])
    # every rank holds the whole buffer, each shard on its own scale
    x = torch.from_numpy(runs["d"]["ag." + name]).to(getattr(torch, dt))
    parts = [tq.dequantize_global(*tq.quantize_global(s, bits), bits)
             for s in x.reshape(4, n)]
    np.testing.assert_array_equal(got.reshape(4, -1)[0],
                                  torch.cat(parts).numpy())


def test_int8_two_hop_qgz_matches_reference(runs):
    g = runs["d"]["q8"]
    got = _glued(runs, "q8")
    np.testing.assert_array_equal(got, runs["ref"]["q8"])
    # checks._qgz_vs_oracle's bar at X = Y = 2, INT8
    X = Y = 2
    amax, qmax = np.abs(g).max(), 127.0
    bound = X * (amax / qmax) / 2 + Y * (X * amax / qmax) / 2
    want = _oracle(g, 4)
    assert np.abs(got - want).max() <= bound * 1.1 + 1e-6
    assert np.corrcoef(got, want)[0, 1] > 0.97


def test_misaligned_one_hop_raises(runs):
    for r in runs["ranks"]:
        assert "multiple of world*block" in r["coll"]["misaligned"]


def test_step_beyond_one_rank_needs_its_mesh(runs):
    for r in runs["ranks"]:
        assert "needs its mesh" in r["steps"]["no_mesh"]


def test_wider_hpz_axes_without_their_group_raise(runs):
    """At world 4 a ``hpz_axes`` wider than ``model`` with no
    ``secondary_group`` (a ZeroConfig, or make_policy with no mesh) is
    refused rather than run over the intra pair."""
    for r in runs["ranks"]:
        for name in ("zcfg", "policy"):
            assert "needs its secondary_group" in \
                r["coll"]["hpz_no_group." + name], name
        assert r["coll"]["hpz_intra"] == 2


# ---------------------------------------------------------------------------
# (d) one training step under each knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STEP_KNOBS))
def test_knob_step_matches_reference(runs, name):
    ranks = runs["ranks"]
    step_bars.hold_qgz_step([r["steps"][name] for r in ranks], runs["ref"],
                            name, MESH, LR, two_hop=name != "qgz_1hop")
    s = ranks[0]["steps"][name]
    label = "zero.qgz_reduce1hop" if name == "qgz_1hop" else \
        "zero.qgz_reduce"
    assert label in s["comm"]
    assert s["hpz_world"] == (4 if name == "hpz_world" else 2)
    assert s["grads_bf16"] == (name == "grad_bf16")
