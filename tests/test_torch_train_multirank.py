"""Port vs reference: the ZeRO++ training step at world > 1, on gloo ranks.

The port's step runs one CPU gloo rank per mesh position
(``repro_torch.launch.mesh.spawn``), ranks row-major over ``("data",
"model")``; the reference runs its jitted ``shard_map`` step on simulated
host devices in a subprocess (8 of them, a 2 × 2 mesh on the first 4).
Model: gpt-350m reduced (2 layers, d 64, vocab 128 in 2 unembedding
chunks), seq 64.  Both sides start from the same GLOBAL fp32 buffers,
drawn here with numpy at the reference's per-name scales; each port rank
loads its shard through ``repro_torch.convert`` (``rank=``, ``world=``)
and reads its rows of the same global ``SyntheticLM`` batch.

  (a) one step at world 4 (2 × 2, batch 8: two rows a rank), fp32
      compute, parameter and reduce dtypes: with qgZ off the loss within
      1e-5, the gradients, m and v of every rank's shard within rtol 1e-5
      / atol 1e-6 and the parameters within the same bar plus the first
      step's direction term (``repro_torch.testing.step_bars``); with full
      ZeRO++ the one-INT4-step bar of ``tests/test_torch_train.py``, every
      element within one INT4 step of its block, with the share beyond the
      tight bar scaled by the quantizations an element passes through
      (``step_bars.far_share``: 6 at 2 × 2 against 2 at world 1, so 3 in
      1,000);
  (b) the reference's trainer checks (``checks.py:353-400``) on 8 ranks
      (4 × 2), batch 16, lr 3e-3 (warmup-cosine), bf16 compute as
      ``_train_setup`` builds them: the ZeRO++ loss falls by 10 % in 8
      steps, tracks the ZeRO-3 baseline within 5 %, and accumulating two
      microbatches of 8 tracks the batch of 16 within 2 %; each port curve
      is held against the reference's curve of the same run within the
      same bar (5 % for the two variants' curves, 2 % for accumulation);
  (c) at world 4 with qgZ off the port's step-1 loss equals its own world-1
      loss on the same global parameters within 1e-5 (qwZ blocks never
      straddle a shard, so the gathered weights are the same bits);
  (d) ``choose_batch_seq_axes`` and the flat layout at W ranks are the
      reference's (the batches that do not cover the world, which shard
      the sequence, are ``tests/test_torch_seq_parallel.py``'s);
  (e) one full-ZeRO++ step of gemma3-4b reduced to 8 layers (one period
      of 5 ``local`` and 1 ``attn`` layers and a ``rem`` group of 2
      ``local`` ones, window 8, gelu) at world 4, at (a)'s full-ZeRO++
      bar: the ``rem`` group under qgZ.

Every rank runs all of its variants in one spawn (one for world 4, one for
world 8), while the reference's subprocess runs beside them.  The module
imports the reference only inside the tests that call it: each spawned
rank imports this module, and JAX would cost every rank its import time.
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
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import attention as tattn           # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train import trainer                        # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gpt-350m"
LR = 3e-3
SEQ = 64
STEP_MESH, STEP_BATCH = (2, 2), 8          # (a), (c)
CURVE_MESH, CURVE_BATCH = (4, 2), 16       # (b), as checks._train_setup
TF32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
            reduce_dtype=torch.float32)
STEP_VARIANTS = {"qgz_off": dict(qgz=False), "zeropp": {}}
# (name, variant, accum, steps) of checks.py:353-400
CURVES = (("baseline", "baseline", 1, 8), ("zeropp", "zeropp", 1, 8),
          ("accum2", "baseline", 2, 4))


# GLOBAL fp32 buffers of a model's layout, numpy normal draws at the
# reference's per-name scales (norms and padding zero)
_init = step_bars.global_params


def _port_model(world, arch=None):
    arch = arch or get_config(ARCH).reduced()
    return Model(arch, make_policy(arch).zcfg, world=world, device="cpu")


def _gemma3():
    """(e): one (5 local, 1 attn) period and a rem group of 2 local layers,
    window 8, gelu; vocab 128 as gpt-350m reduced, so the same batch."""
    return get_config("gemma3-4b").reduced(n_layers=8)


def _batch(rows, step=0):
    """The global ``SyntheticLM`` batch (the reference's draws:
    ``tests/test_torch_train.py``)."""
    arch = get_config(ARCH).reduced()
    return tsyn.make_batch(arch, tsyn.SyntheticLM(arch.vocab, SEQ, seed=7),
                           step, rows)


_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core.compat import make_mesh, shard_map
from repro.data.synthetic import make_batch
from repro.launch.train import build_everything
from repro.models.model import Model
from repro.models.transformer import RunSpec
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.train import trainer
from repro.train.policy import make_policy
from repro.train.state import param_specs
d = dict(np.load(sys.argv[1]))
LR, AXES = float(d["lr"]), ("data", "model")
def tree(prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in d.items()
            if k.startswith(prefix)}
out = {}
def put(prefix, t):
    for k, v in t.items():
        out[prefix + k] = np.asarray(v)
# (a) one step at world 4 (2 x 2), fp32
arch = get_config("gpt-350m").reduced()
mesh = make_mesh((2, 2), AXES, devices=jax.devices()[:4])
batch = {k[2:]: d[k] for k in d if k.startswith("b.")}
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           reduce_dtype=jnp.float32)
rs = RunSpec(mode="train", seq_axes=(), attn_impl="xla")
garch = get_config("gemma3-4b").reduced(n_layers=8)
for name, arch, over, pre in (("qgz_off", arch, dict(qgz=False), "p4."),
                              ("zeropp", arch, {}, "p4."),
                              ("gemma3", garch, {}, "g4.")):
    m = Model(arch, make_policy(arch, AXES, "zeropp", **over, **F32).zcfg,
              world=4)
    specs = param_specs(m, AXES)
    p = tree(pre)
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
    cfg = AdamWConfig(lr=LR)
    ts = trainer.build_train_step(m, mesh, cfg, donate=False,
                                  global_batch=len(batch["tokens"]))
    p, o, met = ts.fn(p, init_opt_state(p, cfg),
                      trainer.place_batch(batch, mesh, ts.in_specs[2]))
    put(name + ".p.", p)
    put(name + ".m.", o["m"])
    put(name + ".v.", o["v"])
    put(name + ".met.", met)
# (b) the trainer checks' curves on 8 devices (4 x 2), as _train_setup
for name, variant, accum, steps in (("baseline", "baseline", 1, 8),
                                    ("zeropp", "zeropp", 1, 8),
                                    ("accum2", "baseline", 2, 4)):
    b = build_everything("gpt-350m", (4, 2), variant, True, 16, 64, LR)
    ts = b.step if accum == 1 else trainer.build_train_step(
        b.model, b.mesh, b.opt_cfg, accum=accum, global_batch=16 // accum)
    p = tree("p8.")
    o = init_opt_state(p, b.opt_cfg)
    losses = []
    for i in range(steps):
        host = make_batch(b.arch, b.lm, i, 16)
        if accum > 1:
            host = {k: v.reshape((accum, -1) + v.shape[1:])
                    for k, v in host.items()}
        p, o, met = ts.fn(p, o, trainer.place_batch(host, b.mesh,
                                                    ts.in_specs[2]))
        losses.append(float(met["loss"]))
    out["curve." + name] = np.array(losses)
np.savez(sys.argv[2], **out)
"""


def _step_rank(rank, world, p4, batch, g4):
    """(a), (c) at world 4: each variant's loss and gradient shards from
    ``loss_and_grads``, then one step's metrics, parameter and moment
    shards; (e) the same of the reduced gemma3-4b under full ZeRO++."""
    out = {}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    mesh = mesh_lib.make_mesh(STEP_MESH)
    runs = [(name, get_config(ARCH).reduced(), over, p4)
            for name, over in STEP_VARIANTS.items()]
    runs.append(("gemma3", _gemma3(), {}, g4))
    for name, arch, over, p in runs:
        pol = make_policy(arch, mesh_lib.AXES, "zeropp", mesh=mesh, **over,
                          **TF32)
        model = Model(arch, pol.zcfg, world=world, device="cpu")
        step = trainer.build_train_step(model, AdamWConfig(lr=LR),
                                        device="cpu", global_batch=STEP_BATCH,
                                        mesh=mesh)
        params = params_from_numpy(p, model, rank=rank, world=world)
        opt = init_opt_state(params)
        loss, mets, grads = step.loss_and_grads(params, tb)
        m = step.fn(params, opt, tb)
        out[name] = dict(loss=float(loss), tokens=mets["tokens"],
                         grads=to_numpy(grads), params=to_numpy(params),
                         opt=to_numpy(opt),
                         met={k: float(v) for k, v in m.items()})
    return out


def _curve_rank(rank, world, p8):
    """(b) at world 8: each check's loss curve (summed over the world)."""
    out = {}
    for name, variant, accum, steps in CURVES:
        b = tlaunch.build_everything(ARCH, CURVE_MESH, variant, True,
                                     CURVE_BATCH, SEQ, LR, accum=accum,
                                     device="cpu")
        params = params_from_numpy(p8, b.model, rank=rank, world=world)
        opt = init_opt_state(params)
        out[name] = [float(b.step.fn(params, opt, tlaunch.device_batch(
            b.arch, b.lm, i, CURVE_BATCH, accum, "cpu"))["loss"])
            for i in range(steps)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank")
    p4, p8 = _init(_port_model(4), 1), _init(_port_model(8), 2)
    g4 = _init(_port_model(4, _gemma3()), 3)
    batch = _batch(STEP_BATCH)
    arrays = {"lr": np.float32(LR)}
    arrays.update({"p4." + k: v for k, v in p4.items()})
    arrays.update({"g4." + k: v for k, v in g4.items()})
    arrays.update({"p8." + k: v for k, v in p8.items()})
    arrays.update({"b." + k: v for k, v in batch.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    # the reference runs beside the port's ranks; its output goes to a
    # file, so that no pipe fills while nobody reads it
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(d / "in.npz"), str(d / "out.npz")],
                               env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            step = mesh_lib.spawn(_step_rank, 4, p4, batch, g4,
                                  device="cpu")
            curve = mesh_lib.spawn(_curve_rank, 8, p8, device="cpu")
            ref.wait(timeout=300)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (d / "ref.log").read_text()
    return dict(step=step, curve=curve, p4=p4, batch=batch,
                ref=dict(np.load(d / "out.npz")))


def _glued(parts):
    """Global arrays from every rank's {buffer: shard} dict, the shards
    joined on the trailing axis in rank order."""
    return {k: np.concatenate([p[k] for p in parts], axis=-1)
            for k in parts[0]}


def _ref_tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _hold_step(runs, name):
    """The world-4 step of variant ``name``: loss, tokens and metrics; then
    returns (port, reference) global gradients, params and opt states."""
    ranks, ref = runs["step"], runs["ref"]
    loss = sum(r[name]["loss"] for r in ranks)
    assert abs(loss - float(ref[name + ".loss"])) <= 1e-5, \
        (loss, ref[name + ".loss"])
    assert [r[name]["tokens"] for r in ranks] == [2.0 * SEQ] * 4
    mets = [r[name]["met"] for r in ranks]
    assert all(m == mets[0] for m in mets), "ranks disagree on the metrics"
    jm = _ref_tree(ref, name + ".met.")
    assert abs(mets[0]["loss"] - float(jm["loss"])) <= 1e-5
    assert mets[0]["tokens"] == float(jm["tokens"]) == STEP_BATCH * SEQ
    np.testing.assert_allclose(mets[0]["lr"], jm["lr"], rtol=1e-7)
    np.testing.assert_allclose(mets[0]["nll"], jm["nll"], rtol=1e-5)
    to = {mv: _glued([r[name]["opt"][mv] for r in ranks])
          for mv in ("m", "v")}
    jo = {mv: _ref_tree(ref, f"{name}.{mv}.") for mv in ("m", "v")}
    assert all(int(r[name]["opt"]["count"]) == 1 for r in ranks)
    return (_glued([r[name]["grads"] for r in ranks]),
            _ref_tree(ref, name + ".g."),
            _glued([r[name]["params"] for r in ranks]),
            _ref_tree(ref, name + ".p."),
            to, jo, mets[0]["grad_norm"], float(jm["grad_norm"]))


def test_world4_step_matches_reference_with_qgz_off(runs):
    tg, jg, tp, jp, to, jo, t_norm, j_norm = _hold_step(runs, "qgz_off")
    assert set(tg) == set(jg) == {"embed", "blocks", "head", "unemb"}
    for k in tg:
        assert tg[k].shape == jg[k].shape
        step_bars.close(tg[k], jg[k], f"grad {k}")
        step_bars.close(to["m"][k], jo["m"][k], f"m {k}")
        step_bars.close(to["v"][k], jo["v"][k], f"v {k}")
    np.testing.assert_allclose(t_norm, j_norm, rtol=1e-5)
    step_bars.params_near(
        tp, jp, {k: step_bars.first_step_dir(tg[k], t_norm) for k in tp},
        {k: step_bars.first_step_dir(jg[k], j_norm) for k in tp}, LR)


def test_world4_step_matches_reference_with_full_zeropp(runs):
    tg, jg, tp, jp, to, jo, t_norm, j_norm = _hold_step(runs, "zeropp")
    far = step_bars.far_share(STEP_MESH)
    step_bars.grads_within_int4(tg, jg, far)
    gdiff = np.sqrt(sum(np.sum((tg[k].astype(np.float64) - jg[k]) ** 2)
                        for k in tg))
    assert abs(t_norm - j_norm) <= gdiff + 1e-5 * j_norm
    step_bars.moments_within_int4(to, jo, far)
    step_bars.params_near(tp, jp,
                          {k: step_bars.moment_dir(to, k) for k in tp},
                          {k: step_bars.moment_dir(jo, k) for k in tp}, LR,
                          far)
    # qgZ really quantized: the qgZ-off gradients of the same state differ
    off = _glued([r["qgz_off"]["grads"] for r in runs["step"]])
    assert not np.allclose(tg["blocks"], off["blocks"], rtol=1e-3, atol=1e-5)


def test_world4_gemma3_step_matches_reference_with_full_zeropp(runs):
    """(e): the reduced gemma3-4b on 2 x 2 under full ZeRO++, its ``rem``
    group a flat group of its own, sharded, qgZ-reduced and updated as
    the reference does, at the full-ZeRO++ bar above.  The grad norm
    (above 1 here) clips both sides' first step, each by its own 1 /
    norm, and the norms differ by the gradients' INT4 steps: an m element
    whose gradient sits one INT4 step off would then miss its block's
    step by that ratio.  So m and v are held as (1 - b1)·g and
    (1 - b2)·g², each side's clip divided out of its own moments."""
    tg, jg, tp, jp, to, jo, t_norm, j_norm = _hold_step(runs, "gemma3")
    assert set(tg) == set(jg) == {"embed", "blocks", "rem", "head", "unemb"}
    far = step_bars.far_share(STEP_MESH)
    step_bars.grads_within_int4(tg, jg, far)
    gdiff = np.sqrt(sum(np.sum((tg[k].astype(np.float64) - jg[k]) ** 2)
                        for k in tg))
    assert abs(t_norm - j_norm) <= gdiff + 1e-5 * j_norm

    def unclipped(o, norm):
        c = min(1.0, 1.0 / (norm + 1e-12))
        return {"m": {k: v / c for k, v in o["m"].items()},
                "v": {k: v / c ** 2 for k, v in o["v"].items()}}
    step_bars.moments_within_int4(unclipped(to, t_norm),
                                  unclipped(jo, j_norm), far)
    step_bars.params_near(tp, jp,
                          {k: step_bars.moment_dir(to, k) for k in tp},
                          {k: step_bars.moment_dir(jo, k) for k in tp}, LR,
                          far)


def test_world4_loss_equals_world1_loss(runs):
    """(c): the world-4 buffers re-fit onto the world-1 layout (the same
    entries at the same offsets; only the zero padding is shorter)."""
    arch = get_config(ARCH).reduced()
    model = Model(arch, make_policy(arch, qgz=False, **TF32).zcfg,
                  device="cpu")
    p1 = {}
    for k, n in model.param_shapes().items():
        a = runs["p4"][k]
        assert not a[..., n[-1]:].any()
        p1[k] = a[..., :n[-1]]
    st = trainer.build_train_step(model, AdamWConfig(lr=LR), device="cpu")
    loss1, _, _ = st.loss_and_grads(
        params_from_numpy(p1, model),
        {k: torch.from_numpy(v).long() for k, v in runs["batch"].items()})
    loss4 = sum(r["qgz_off"]["loss"] for r in runs["step"])
    assert abs(float(loss1) - loss4) <= 1e-5, (float(loss1), loss4)


def _curves(runs):
    ranks = runs["curve"]
    assert all(r == ranks[0] for r in ranks), "ranks disagree on the losses"
    return ranks[0], {name: runs["ref"]["curve." + name]
                      for name, *_ in CURVES}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.abs(b)


def test_trainer_loss_decreases_on_8_ranks(runs):
    """checks.check_trainer_loss_decreases, and the curve against the
    reference's."""
    port, ref = _curves(runs)
    losses = port["zeropp"]
    assert all(np.isfinite(losses)) and len(losses) == 8
    assert losses[-1] < losses[0] * 0.9, losses
    assert _rel(losses, ref["zeropp"]).max() < 0.05, (losses, ref["zeropp"])


def test_trainer_zeropp_tracks_baseline_on_8_ranks(runs):
    """checks.check_trainer_zeropp_tracks_baseline (5 %), and the baseline
    curve against the reference's."""
    port, ref = _curves(runs)
    assert _rel(port["zeropp"], port["baseline"]).max() < 0.05, port
    assert _rel(port["baseline"], ref["baseline"]).max() < 0.05, \
        (port["baseline"], ref["baseline"])


def test_trainer_grad_accumulation_on_8_ranks(runs):
    """checks.check_trainer_grad_accumulation (2 %): two microbatches of 8
    against the batch of 16, and against the reference's accumulation."""
    port, ref = _curves(runs)
    assert _rel(port["accum2"], port["baseline"][:4]).max() < 0.02, port
    assert _rel(port["accum2"], ref["accum2"]).max() < 0.02, \
        (port["accum2"], ref["accum2"])


@pytest.mark.parametrize("batch,shape", [
    (16, (4, 2)), (8, (4, 2)), (4, (4, 2)), (6, (4, 2)), (2, (2, 2)),
    (1, (1, 1)), (3, (1, 3)), (12, (2, 4))])
def test_choose_batch_seq_axes_matches_reference(batch, shape):
    from repro.train import trainer as jtrainer
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=dict(zip(("data", "model"), shape)))
    assert trainer.choose_batch_seq_axes(batch, shape) == \
        jtrainer.choose_batch_seq_axes(batch, mesh)


@pytest.mark.parametrize("arch_name,reduced", [
    ("qwen3-0.6b", False), ("gpt-350m", False), ("gpt-350m", True)])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_flat_layout_at_world_matches_reference(arch_name, reduced, world):
    """``param_shapes`` at W ranks (the unembedding's chunk count and every
    buffer's padding), each shard a whole number of quant blocks."""
    from repro.configs import get_config as jax_get_config
    from repro.models.model import Model as JaxModel
    from repro.train.policy import make_policy as jax_policy
    arch, jarch = get_config(arch_name), jax_get_config(arch_name)
    if reduced:
        arch, jarch = arch.reduced(), jarch.reduced()
    model = Model(arch, make_policy(arch).zcfg, world=world, device="cpu")
    jm = JaxModel(jarch, jax_policy(jarch, ("data", "model"), "zeropp").zcfg,
                  world=world)
    assert model.param_shapes() == jm.param_shapes()
    align = ZeroConfig().align(world)
    for shape in model.param_shapes().values():
        assert shape[-1] % align == 0
        assert (shape[-1] // world) % 256 == 0


def test_mesh_parses_and_needs_its_process_group():
    assert mesh_lib.parse_mesh("4x2") == (4, 2)
    assert mesh_lib.make_mesh((1, 1)) == mesh_lib.Mesh((1, 1))
    assert mesh_lib.Mesh((4, 2)).world == 8
    for bad in ("4", "0x2", "ax2"):
        with pytest.raises(ValueError, match="mesh"):
            mesh_lib.parse_mesh(bad)
    with pytest.raises(RuntimeError, match="process group of 8"):
        mesh_lib.make_mesh((4, 2))


def test_launcher_spawns_the_mesh():
    """``--mesh 2x2`` through the launcher's own entry (``run``): four
    rank processes, one summed loss curve, the same step-1 loss as
    ``--mesh 1x1`` from the same seed (bf16 compute: within 1e-3, the card
    phase's bar)."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "8",
            "--seq", str(SEQ), "--steps", "2", "--lr", str(LR),
            "--log-every", "0"]
    one = tlaunch.run(tlaunch.parser().parse_args(argv))
    four = tlaunch.run(tlaunch.parser().parse_args(argv + ["--mesh", "2x2"]))
    assert len(four["ranks"]) == 4
    assert all(r["losses"] == four["losses"] for r in four["ranks"])
    assert all(np.isfinite(four["losses"]))
    assert abs(four["losses"][0] - one["losses"][0]) <= 1e-3, \
        (four["losses"], one["losses"])


def _card_rank(rank, world):
    """The gloo calls the port makes, on the card's tensors: the gathers'
    and all-to-alls' int8 lanes, the baseline reduce-scatter and AdamW's
    norm all-reduce in fp32, and the sequence gather's backward: a bf16
    reduce-scatter (returned as fp32 with its dtype)."""
    dev = "cuda"
    g = cl._gather(torch.full((4,), rank + 1, dtype=torch.int8, device=dev))
    a = cl._all_to_all(torch.arange(2 * world, dtype=torch.int8,
                                    device=dev) + 10 * rank)
    r = cl.baseline_reduce_scatter(torch.arange(2 * world, dtype=torch.float32,
                                                device=dev) * (rank + 1))
    t = torch.tensor(rank + 1.0, device=dev)
    dist.all_reduce(t)
    x = torch.zeros(1, 2, 1, 2, dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    kv = tattn._gather_seq(x, ("data", "model"), None)
    kv.backward(torch.arange(4 * world, dtype=torch.bfloat16, device=dev
                             ).reshape(kv.shape) * (rank + 1))
    assert all(v.is_cuda for v in (g, a, r, t, x.grad))
    return (g.cpu().numpy(), a.cpu().numpy(), r.cpu().numpy(), float(t),
            str(x.grad.dtype), x.grad.float().cpu().numpy().ravel())


def test_gloo_takes_card_tensors():
    """On the card the ranks share device 0 over gloo, and the collectives
    hand gloo CUDA tensors (no host staging in the port): each call's
    result on 4 ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (gloo with the card's tensors)")
    world = 4
    out = mesh_lib.spawn(_card_rank, world, device="cuda")
    tot = sum(range(1, world + 1))
    for rank, (g, a, r, t, sdt, sg) in enumerate(out):
        np.testing.assert_array_equal(g, np.repeat(np.arange(1, world + 1),
                                                   4))
        np.testing.assert_array_equal(
            a, [2 * rank + j % 2 + 10 * (j // 2) for j in range(2 * world)])
        np.testing.assert_array_equal(
            r, np.arange(2 * rank, 2 * rank + 2) * sum(range(1, world + 1)))
        assert t == tot
        assert sdt == "torch.bfloat16"
        np.testing.assert_array_equal(
            sg, np.arange(4 * rank, 4 * rank + 4) * tot)
