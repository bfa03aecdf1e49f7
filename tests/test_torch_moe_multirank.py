"""Port vs reference: MoE on CPU gloo ranks (one process a rank).

deepseek-moe-16b reduced (d 64, 8 experts top-2 in 2 chunks, 1 shared
expert, vocab 128), seq 32, the global ``SyntheticLM`` batch; every rank
holds its shard of the same GLOBAL buffers (``step_bars.global_params``,
numpy draws from a seed).

  (c) the counterparts of ``check_moe_prefetch_matches_sync`` and
      ``check_moe_prefetch_depth_sweep`` (``checks.py:1031``, ``:981``) on
      2 × 2 ranks, a 4-layer stack, bf16 compute: ``loss_and_grads`` at
      ring depths 1, 2, 3 and 8 (beyond the layers: it clamps) gives the
      loss, the aux loss and every rank's gradients of every group
      ``torch.equal`` to depth 0, with hpZ (the nested recompute replays
      the chunks from their saved secondary slices, the reverse ring's
      ``bwd_spec`` seeds chunk 0: its 4·2 chunk gathers leave the qwZ
      tier, so B1, B2 and the all-gathers run that many times fewer, each
      qwZ gather's two all-gathers one hpZ all-gather) and without (the
      recompute gathers them again on the qwZ tier: the same calls of
      every kernel wrapper and every collective as depth 0); the serving prefill and decode
      logits at every depth equal depth 0's.  Step 1 against the
      reference's on 4 simulated devices (2 layers, fp32, its ring at
      depth 1): the loss and metrics (``moe_aux`` among them) within
      1e-5, gradients, moments and parameters at
      ``step_bars.hold_qgz_step``'s bars (the parameters' unstable-
      direction share at ``tests/test_torch_moe.py``'s MoE allowance);
  (d) every rank's counted bytes per ``zero.*`` label equal the port's
      projection (``comm_events`` folded by ``step_wire_by_label``) and per
      tier its ``step_wire_by_tier`` at every depth, with and without hpZ;
      at depth 0 the labels equal the reference's projection (its
      ``comm_events`` folded by its ``step_wire_by_label``) to the byte;
      at depth k the chunk recompute's bytes move from the qwZ tier
      (``data``) to hpZ's (``model``);
  (e) the counterpart of ``check_serve_consistency_moe`` (``:680``) on a
      (1, 2) world, fp32: prefill(14) and two decode steps (the cache
      sequence over ``model``) against prefill(16), relative 2e-2 and the
      same argmax, every rank the same logits;
  and a checkpoint of the (1, 2) world (every rank its shard file)
  restores at world 1 to the world-1 init of the same seed.
The reference's subprocess runs beside the ranks; the module imports the
reference only inside the tests (every spawned rank imports it).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core.zeropp import step_wire_by_tier        # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.obs.report import projected_wire_by_label   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa
from repro_torch.serve import steps                          # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train import trainer                        # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-moe-16b"
DEPTHS = (0, 1, 2, 3, 8)
VARIANTS = {"hpz": {}, "nohpz": {"hpz": False}}
SEQ, ROWS, LR = 32, 8, 3e-3
SIZES = {"data": 2, "model": 2}
TF32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
            reduce_dtype=torch.float32)
KERNELS = ("quantize_blockwise", "dequantize_blockwise", "quantize_reordered",
           "dequant_reduce_quant", "dequant_reduce", "dequant_matmul")
COLLECTIVES = ("all_gather_into_tensor", "all_to_all_single",
               "reduce_scatter_tensor")
PROMPT, DECODE = 14, 2
# the parameters' unstable first-step share (tests/test_torch_moe.py)
MOE_FAR_PARAMS = 1e-2


def _arch(n_layers=4):
    return get_config(ARCH).reduced(n_layers=n_layers)


def _batch():
    arch = _arch()
    return tsyn.make_batch(arch, tsyn.SyntheticLM(arch.vocab, SEQ, seed=7),
                           0, ROWS)


class _Counts:
    """Counts the calls of every kernel wrapper and collective, while
    open."""

    def __init__(self):
        self.n = {}
        self.real = [(tops, k, getattr(tops, k)) for k in KERNELS] + \
            [(dist, k, getattr(dist, k)) for k in COLLECTIVES]

    def __enter__(self):
        for mod, name, fn in self.real:
            setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def f(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return f

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def _serve(model, params, mesh):
    """Prefill logits of a (2, PROMPT) prompt on this world, then DECODE
    greedy decode steps' logits (rows over ``data``, the prompt and the
    caches' sequence over ``model``)."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, PROMPT + 2))).long()
    ps = steps.build_prefill_step(model, device="cpu", mesh=mesh,
                                  batch_axes=("data",), seq_axes=("model",))
    ds = steps.build_decode_step(model, device="cpu", mesh=mesh,
                                 batch_axes=("data",), kv_axes=("model",))
    logits, caches = ps.fn(params, {"tokens": toks[:, :PROMPT]})
    caches = steps.pad_prefill_caches(model, caches, PROMPT + 2, mesh,
                                      ("model",), ("model",))
    out = [logits.numpy()]
    for t in range(DECODE):
        logits, caches = ds.fn(params, caches,
                               {"tokens": toks[:, PROMPT + t:PROMPT + t + 1]},
                               torch.full((2,), PROMPT + t))
        out.append(logits.numpy())
    return out, toks


def _world4_rank(rank, world, g4, g2, batch):
    mesh = mesh_lib.make_mesh((2, 2))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    out = {}
    for vname, over in VARIANTS.items():
        for depth in DEPTHS:
            pol = make_policy(_arch(), mesh_lib.AXES, "zeropp", mesh=mesh,
                              prefetch=depth, **over)
            model = Model(_arch(), pol.zcfg, world=world, device="cpu")
            step = trainer.build_train_step(model, AdamWConfig(),
                                            device="cpu", global_batch=ROWS,
                                            mesh=mesh)
            params = params_from_numpy(g4, model, rank=rank, world=world)
            sent, sent_t = tlaunch.comm_bytes(), tlaunch.tier_bytes()
            with _Counts() as c:
                loss, mets, grads = step.loss_and_grads(params, tb)
            res = dict(loss=float(loss), aux=float(mets["moe_aux"]),
                       grads=to_numpy(grads), counts=c.n,
                       comm=tlaunch.comm_since(sent),
                       tiers=tlaunch.tier_since(sent_t),
                       projected=projected_wire_by_label(model, SIZES),
                       proj_tiers=step_wire_by_tier(model.comm_events(),
                                                    model.zcfg, SIZES))
            if vname == "hpz":
                serve = {k: v.to(torch.bfloat16) for k, v in params.items()}
                with torch.no_grad():
                    res["serve"] = _serve(model, serve, mesh)[0]
            out[(vname, depth)] = res
    # step 1 in fp32 against the reference (2 layers, depth 1)
    pol = make_policy(_arch(2), mesh_lib.AXES, "zeropp", mesh=mesh, **TF32)
    model = Model(_arch(2), pol.zcfg, world=world, device="cpu")
    step = trainer.build_train_step(model, AdamWConfig(lr=LR), device="cpu",
                                    global_batch=ROWS, mesh=mesh)
    params = params_from_numpy(g2, model, rank=rank, world=world)
    opt = init_opt_state(params)
    scales = {}
    with step_bars.recording(scales):
        loss, _, grads = step.loss_and_grads(params, tb)
    sent = tlaunch.comm_bytes()
    met = step.fn(params, opt, tb)
    out["ref_step"] = dict(loss=float(loss), scales=scales,
                           grads=to_numpy(grads), params=to_numpy(params),
                           opt=to_numpy(opt),
                           met={k: float(v) for k, v in met.items()},
                           comm=tlaunch.comm_since(sent),
                           projected=projected_wire_by_label(model, SIZES))
    return out


def _world2_rank(rank, world, g2, ckpt):
    """(e) on (1, 2) in fp32, and the world's checkpoint."""
    mesh = mesh_lib.make_mesh((1, 2))
    arch = _arch(2)
    pol = make_policy(arch, mesh_lib.AXES, "zeropp", mesh=mesh, **TF32)
    model = Model(arch, pol.zcfg, world=world, device="cpu")
    params = params_from_numpy(g2, model, rank=rank, world=world)
    with torch.no_grad():
        got, toks = _serve(model, params, mesh)
        ps = steps.build_prefill_step(model, device="cpu", mesh=mesh,
                                      batch_axes=("data",),
                                      seq_axes=("model",))
        ref = ps.fn(params, {"tokens": toks})[0].numpy()
    ts.ZeroState(model, mesh).init(3).save(ckpt, step=1)
    return {"decode": got[-1], "prefill": ref}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    g4 = step_bars.global_params(Model(_arch(), make_policy(_arch()).zcfg,
                                       world=4, device="cpu"), 1)
    g2, g2w2 = (step_bars.global_params(Model(
        _arch(2), make_policy(_arch(2)).zcfg, world=w, device="cpu"), 2)
        for w in (4, 2))
    batch = _batch()
    arrays = {"lr": np.float32(LR)}
    arrays.update({"p." + k: v for k, v in g2.items()})
    arrays.update({"b." + k: v for k, v in batch.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET,
                                str(d / "in.npz"), str(d / "out.npz")],
                               env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            w4 = mesh_lib.spawn(_world4_rank, 4, g4, g2, batch, device="cpu",
                                timeout=600)
            ckpt = str(d / "ckpt")
            w2 = mesh_lib.spawn(_world2_rank, 2, g2w2, ckpt, device="cpu")
            ref.wait(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (d / "ref.log").read_text()
    return dict(w4=w4, w2=w2, ckpt=ckpt, ref=dict(np.load(d / "out.npz")))


_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core.compat import make_mesh, shard_map
from repro.core.zeropp import step_wire_by_label
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
sizes = {"data": 2, "model": 2}
# (d) the projection at depth 0, 4 layers, bf16, with and without hpZ
arch4 = get_config("deepseek-moe-16b").reduced(n_layers=4)
for name, over in (("hpz", {}), ("nohpz", {"hpz": False})):
    m = Model(arch4, make_policy(arch4, AXES, "zeropp", prefetch=0,
                                 **over).zcfg, world=4)
    put("proj." + name + ".", step_wire_by_label(m.comm_events(), m.zcfg,
                                                 sizes))
# (c) step 1 at 2 x 2, 2 layers, fp32, the reference's ring at depth 1
arch = get_config("deepseek-moe-16b").reduced()
mesh = make_mesh((2, 2), AXES)
batch = {k[2:]: d[k] for k in d if k.startswith("b.")}
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           reduce_dtype=jnp.float32)
m = Model(arch, make_policy(arch, AXES, "zeropp", **F32).zcfg, world=4)
specs = param_specs(m, AXES)
p = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("p.")}
rs = RunSpec(mode="train", seq_axes=(), attn_impl="xla")
def lg(p, b):
    (loss, _), g = jax.value_and_grad(
        lambda p: m.loss_fn(p, b, rs, 4), has_aux=True)(p)
    return jax.lax.psum(loss, AXES), g
f = jax.jit(shard_map(lg, mesh=mesh,
                      in_specs=(specs, {k: P(AXES, None) for k in batch}),
                      out_specs=(P(), specs), check_vma=False))
loss, g = f(p, batch)
out["step.loss"] = np.asarray(loss)
put("step.g.", g)
cfg = AdamWConfig(lr=LR)
ts = trainer.build_train_step(m, mesh, cfg, donate=False,
                              global_batch=len(batch["tokens"]))
p, o, met = ts.fn(p, init_opt_state(p, cfg),
                  trainer.place_batch(batch, mesh, ts.in_specs[2]))
put("step.p.", p)
put("step.m.", o["m"])
put("step.v.", o["v"])
put("step.met.", met)
np.savez(sys.argv[2], **out)
"""


@pytest.mark.parametrize("depth", DEPTHS[1:])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_at_every_depth_equals_the_synchronous_step(runs, variant,
                                                         depth):
    """(c): loss, aux and every rank's gradients of every group (experts
    among them) bit-identical to depth 0, the same kernel and collective
    calls; the serving logits too."""
    for r in runs["w4"]:
        sync, ring = r[(variant, 0)], r[(variant, depth)]
        assert ring["loss"] == sync["loss"] and ring["aux"] == sync["aux"]
        assert sync["grads"].keys() == ring["grads"].keys()
        assert "experts" in sync["grads"]
        for k, g in sync["grads"].items():
            np.testing.assert_array_equal(ring["grads"][k], g,
                                          err_msg=f"{variant} {depth} {k}")
        want = dict(sync["counts"])
        if variant == "hpz":
            # the recompute's n·nc chunk gathers move from the qwZ tier
            # (B1, B2 and two all-gathers each) to the hpZ one (one each)
            for k in ("quantize_blockwise", "dequantize_blockwise",
                      "all_gather_into_tensor"):
                want[k] -= 4 * 2
        assert ring["counts"] == want, (variant, depth)
        if variant == "hpz":
            for a, b in zip(sync["serve"], ring["serve"]):
                np.testing.assert_array_equal(a, b)
    # qgZ ran once per flat group: embed, 4 layers, 8 expert chunks, head,
    # 2 unembedding chunks
    counts = runs["w4"][0][(variant, depth)]["counts"]
    assert all(counts[k] == 1 + 4 + 8 + 1 + 2 for k in KERNELS[2:5]), counts


def test_step1_matches_the_reference_on_4_devices(runs):
    per_rank = [r["ref_step"] for r in runs["w4"]]
    ref = runs["ref"]
    np.testing.assert_allclose(per_rank[0]["met"]["moe_aux"],
                               float(ref["step.met.moe_aux"]), rtol=1e-5)
    real = step_bars.params_near

    def near(*a, **kw):        # the MoE allowance for unstable directions
        return real(*a[:5], MOE_FAR_PARAMS)
    step_bars.params_near = near
    try:
        step_bars.hold_qgz_step(per_rank, ref, "step", (2, 2), LR)
    finally:
        step_bars.params_near = real


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wire_bytes_equal_the_projection(runs, variant, depth):
    """(d): every rank's bytes per label and per tier equal the port's
    projection; at depth 0 the labels equal the reference's."""
    ref = {k[len(f"proj.{variant}."):]: float(v)
           for k, v in runs["ref"].items()
           if k.startswith(f"proj.{variant}.")}
    for r in runs["w4"]:
        res = r[(variant, depth)]
        zero = {k: v for k, v in res["comm"].items() if k != "other"}
        assert zero == res["projected"], (variant, depth)
        tiers = {k: b - res["tiers"].get(k + ".other", 0)
                 for k, b in res["tiers"].items() if "." not in k}
        assert {k: b for k, b in tiers.items() if b} == res["proj_tiers"]
        if depth == 0:
            assert zero == ref, (zero, ref)
    if variant == "hpz":
        t0 = runs["w4"][0][(variant, 0)]["proj_tiers"]
        t1 = runs["w4"][0][(variant, max(depth, 1))]["proj_tiers"]
        if depth:
            assert t1["data"] < t0["data"] and t1["model"] > t0["model"]


def test_serve_consistency_on_a_1x2_world(runs):
    """(e): prefill(P) + decode == prefill(P + n), the cache sequence over
    ``model``; every rank the same logits."""
    a, b = runs["w2"]
    for k in ("decode", "prefill"):
        np.testing.assert_array_equal(a[k], b[k])
    got, want = a["decode"][:, -1], a["prefill"][:, -1]
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < 2e-2, err
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_a_2_rank_checkpoint_restores_at_world1(runs):
    arch = _arch(2)
    model = Model(arch, make_policy(arch).zcfg, world=1, device="cpu")
    mesh = mesh_lib.make_mesh((1, 1))
    st = ts.ZeroState.restore(model, mesh, runs["ckpt"])
    assert st is not None and st.step == 1
    want = ts.ZeroState(model, mesh).init(3)
    assert set(st.params) == set(want.params) and "experts" in st.params
    for k, v in want.params.items():
        assert torch.equal(st.params[k], v), k
    manifest = ts.read_manifest(ts.latest_checkpoint(runs["ckpt"]))
    assert manifest["param_layout"]["experts"]["entries"] == [
        [n, list(s)] for n, s in model.expert_spec.entries]
