"""Port vs reference: checkpoints across ranks and world sizes, on CPU gloo
ranks (one process a rank) and the reference on 8 simulated devices.

The reference's ``_train_setup``: gpt-350m reduced, batch 16, seq 64, lr
3e-3 (warmup-cosine), full ZeRO++.

  (a) per-rank files: at 4 x 2 every rank writes ``shard_<rank>.npz``
      holding only its ``key@rank`` members (rank 0 also the replicated
      ``opt::count``), rank 0 the manifest (``num_processes`` 8, every
      file's crc32), and no staging debris is left; at 2 x 2 x 2 rank r's
      file holds the r-th cut of every global buffer, row-major over
      ("pod", "data", "model"), as the reference's ``key@r``;
  (b) ``check_state_elastic_restore`` (``checks.py:447``): save at 4 x 2
      after 3 steps, restore at 2 x 2 and at 1 x 2; the restored buffers
      equal the saved state bit for bit over the logical region (zero
      padding beyond); one step from the checkpoint is bit-identical to
      one from ``place_global`` of the same host state (no files); the
      losses are within 2 % of the uninterrupted 4 x 2 curve;
  (c) ``check_state_quantized_roundtrip`` (``:515``): the INT8 save of the
      same state restored at 2 x 2 is inside the per-block bound
      ``absmax/127 · 0.6 + 1e-8``, its files under 0.35 of the fp32 ones,
      and its next two losses within 5 % of the fp32 restore's;
  (d) ``check_state_serving_load`` (``:574``) at the port's serving world
      of 1: a params-only INT8 checkpoint saved at 4 x 2 gives
      ``load_serving_params`` and ``ServeEngine.from_checkpoint`` the bf16
      bits of ``fit_to`` of the dequantized global buffers;
  (e) ``check_checkpoint_elastic_restart`` (``:401``) through the
      launcher's loop: ``--mesh 4x2 --ckpt-dir D --ckpt-every 3 --steps 3``
      then ``--mesh 2x2 --ckpt-dir D --steps 5``; the second run starts at
      step 3 with ``meta.world == 8`` and its losses are within 2 % of the
      uninterrupted 4 x 2 run's;
  (f) interop: the reference's fp32 and INT8 checkpoints (saved on 8
      simulated devices at (4, 2), one file) restore in the port at 2 x 2
      and at world 1 equal to the reference's own ``load_global`` over the
      logical region; the port's 8-file checkpoints read in the reference
      (``load_global``, and ``ZeroState.restore`` at (2, 2)) equal the
      state the port saved; the port's INT8 save (4 x 2) of the state it
      restored from the reference's fp32 checkpoint is the reference's
      INT8 save of that state, member for member, byte for byte.

One spawn each of 8 (4 x 2, then 2 x 2 x 2 in the same ranks), 4 and 2
ranks; the reference's subprocess runs beside them, each side waiting for
the other's published checkpoints.  The reference is imported inside the
tests only: every spawned rank imports this module.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
import time                                                  # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core.partition import shard_of              # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import ServeEngine                    # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, LR = "gpt-350m", 16, 64, 3e-3
SAVE_AT, STEPS = 3, 5
WAIT_S = 400.0

_REF_SNIPPET = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
from repro.testing.checks import _run_steps, _train_setup
from repro.train.state import ZeroState, flatten_state, load_global
R, P = sys.argv[1], sys.argv[2]
def dump(name, tree):
    np.savez(os.path.join(R, name + ".npz"),
             **{k: np.asarray(v) for k, v in flatten_state(tree).items()})
def wait(path):
    deadline = time.monotonic() + float(sys.argv[3])
    while not os.path.exists(os.path.join(path, "manifest.json")):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)
    return path
mesh8, arch, model8, opt_cfg, ts8, lm = _train_setup(mesh_shape=(4, 2))
p8, o8, _ = _run_steps(mesh8, arch, model8, opt_cfg, ts8, lm, 3, 16)
st = ZeroState(model8, mesh8, opt_cfg, params=p8, opt=o8)
meta = {"world": 8, "arch": arch.name}
st.save(os.path.join(R, "q8"), 3, fmt="int8", meta=meta)
st.save(os.path.join(R, "f32"), 3, meta=meta)
for name in ("f32", "q8"):
    dump(name, load_global(os.path.join(R, name, "ckpt_3"))[1])
mesh4, arch4, model4, opt_cfg4, ts4, lm4 = _train_setup(mesh_shape=(2, 2))
for name, step in (("el", 3), ("q8", 3), ("pod", 0)):
    path = wait(os.path.join(P, name, f"ckpt_{step}"))
    dump("port_" + name, load_global(path)[1])
    st4 = ZeroState.restore(model4, mesh4, opt_cfg4, path)
    dump("port_" + name + "_at_2x2",
         jax.device_get({"params": st4.params, "opt": st4.opt}))
"""


def _setup(shape):
    return tlaunch.build_everything(ARCH, shape, "zeropp", True, BATCH, SEQ,
                                    LR, device="cpu")


def _batch(built, i):
    return tlaunch.device_batch(built.arch, built.lm, i, BATCH, 1, "cpu")


def _shards(st):
    """This rank's state as numpy: {"params::embed": ..., "opt::count"}."""
    return {k: v.numpy().copy() for k, v in ts.flatten_state(
        {"params": st.params, "opt": st.opt}).items() if v is not None}


def _step(built, st, i):
    return float(built.step.fn(st.params, st.opt, _batch(built, i))["loss"])


def _wait(path):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(os.path.join(path, ts.MANIFEST)):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)
    return path


def _launch_args(mesh, *extra):
    return tlaunch.parser().parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", mesh,
        "--batch", str(BATCH), "--seq", str(SEQ), "--lr", str(LR),
        "--log-every", "0", *extra])


def _rank_a(rank, world, d, r):
    """8 ranks at 4 x 2: the run, its fp32 and INT8 saves at step 3, the
    uninterrupted steps 4-5, a params-only INT8 save, the launcher's 4 x 2
    run, the reference's fp32 checkpoint restored and saved again as INT8;
    then 2 x 2 x 2: the seeded init saved at step 0."""
    built = _setup((4, 2))
    st = ts.ZeroState(built.model, built.mesh).init(0)
    out = {"losses": [_step(built, st, i) for i in range(SAVE_AT)]}
    st.step = SAVE_AT
    meta = {"world": world, "arch": built.arch.name}
    st.save(os.path.join(d, "el"), meta=meta)
    st.save(os.path.join(d, "q8"), fmt="int8", meta=meta)
    out["oracle"] = _shards(st)
    out["losses"] += [_step(built, st, i) for i in range(SAVE_AT, STEPS)]
    ts.ZeroState(built.model, built.mesh, params=ts.init_shards(
        built.model, 5)).save(os.path.join(d, "serve"), 0, fmt="int8",
                              meta={"arch": built.arch.name})
    res = tlaunch.train_loop(_launch_args(
        "4x2", "--ckpt-dir", os.path.join(d, "run"), "--ckpt-every",
        str(SAVE_AT), "--steps", str(SAVE_AT)))
    out["launch"] = {k: res[k] for k in ("losses", "start", "save_s")}
    ref = ts.ZeroState.restore(built.model, built.mesh,
                               _wait(os.path.join(r, "f32", "ckpt_3")))
    ref.save(os.path.join(d, "interop"), meta=ref.meta, fmt="int8")
    pod = _setup((2, 2, 2))
    ts.ZeroState(pod.model, pod.mesh).init(0).save(os.path.join(d, "pod"))
    return out


def _restored_step(built, d, host, i):
    """(the restored shards, whether one step from the checkpoint equals
    one from ``place_global`` of ``host`` bit for bit (loss and every
    buffer), the losses of steps i and i + 1 from the checkpoint)."""
    st = ts.ZeroState.restore(built.model, built.mesh,
                              os.path.join(d, "el"))
    got = _shards(st)
    oracle = ts.ZeroState(built.model, built.mesh).place_global(
        host["params"], host["opt"])
    la, lb = _step(built, st, i), _step(built, oracle, i)
    same = la == lb and all(
        torch.equal(a, b) for a, b in zip(
            ts.flatten_state({"p": st.params, "o": st.opt}).values(),
            ts.flatten_state({"p": oracle.params, "o": oracle.opt}).values()))
    return got, same, [la, _step(built, st, i + 1)], st


def _rank_b(rank, world, d, r, host):
    """4 ranks at 2 x 2: the elastic restore, the INT8 restore against the
    fp32 one, the reference's checkpoints, the launcher's restart."""
    built = _setup((2, 2))
    out = {}
    out["restored"], out["same"], out["losses"], st = _restored_step(
        built, d, host, SAVE_AT)
    st.step = SAVE_AT
    stq = ts.ZeroState.restore(built.model, built.mesh,
                               os.path.join(d, "q8"))
    out["q8"] = _shards(stq)
    out["q8_losses"] = [_step(built, stq, i) for i in (SAVE_AT, SAVE_AT + 1)]
    stf = ts.ZeroState.restore(built.model, built.mesh,
                               os.path.join(d, "el"))
    out["f32_losses"] = [_step(built, stf, i) for i in (SAVE_AT, SAVE_AT + 1)]
    for name in ("f32", "q8"):
        out["ref_" + name] = _shards(ts.ZeroState.restore(
            built.model, built.mesh, os.path.join(r, name)))
    res = tlaunch.train_loop(_launch_args(
        "2x2", "--ckpt-dir", os.path.join(d, "run"), "--steps", str(STEPS)))
    out["launch"] = {k: res[k] for k in ("losses", "start", "restored")}
    return out


def _rank_c(rank, world, d, host):
    """2 ranks at 1 x 2: the elastic restore."""
    built = _setup((1, 2))
    out = {}
    out["restored"], out["same"], out["losses"], _ = _restored_step(
        built, d, host, SAVE_AT)
    return out


def _glue(ranks, key=None):
    """Every rank's shards (``ranks[i][key]`` or ``ranks[i]``) as global
    buffers: the trailing axes concatenated in rank order (0-d: rank
    0's)."""
    parts = [r[key] if key else r for r in ranks]
    return {k: (parts[0][k] if parts[0][k].ndim == 0 else
                np.concatenate([p[k] for p in parts], axis=-1))
            for k in parts[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port"))
    r = str(tmp_path_factory.mktemp("ref"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    log_path = os.path.join(r, "ref.log")
    with open(log_path, "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET, r, d,
                                str(WAIT_S)], env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            a = mesh_lib.spawn(_rank_a, 8, d, r, device="cpu",
                               timeout=WAIT_S)
            oracle = _glue(a, "oracle")
            host = ts.unflatten_state(oracle)
            b = mesh_lib.spawn(_rank_b, 4, d, r, host, device="cpu")
            c = mesh_lib.spawn(_rank_c, 2, d, host, device="cpu")
            ref.wait(timeout=WAIT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, Path(log_path).read_text()[-5000:]

    def load(name):
        with np.load(os.path.join(r, name + ".npz")) as z:
            return {k: z[k] for k in z.files}
    refs = {n: load(n) for n in ("f32", "q8", "port_el", "port_q8",
                                 "port_pod", "port_el_at_2x2",
                                 "port_q8_at_2x2")}
    return dict(d=d, r=r, a=a, b=b, c=c, oracle=oracle, host=host, ref=refs)


def _logical_equal(got, want):
    """Bit-exact over the common trailing prefix; anything past it must be
    zero padding on both sides (the reference's ``_logical_equal``,
    ``checks.py:435``); a 0-d buffer (``opt::count``) equal."""
    if want.ndim == 0:
        assert got.shape == () and got.dtype == want.dtype and got == want
        return
    n = min(got.shape[-1], want.shape[-1])
    np.testing.assert_array_equal(got[..., :n], want[..., :n])
    assert got.dtype == want.dtype
    if got.shape[-1] > n:
        assert not np.asarray(got[..., n:]).any()
    if want.shape[-1] > n:
        assert not np.asarray(want[..., n:]).any()


def _all_logical_equal(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert set(keys) <= set(got)
    for k in keys:
        _logical_equal(np.asarray(got[k]), np.asarray(want[k]))


def _world1_model():
    arch = get_config(ARCH).reduced()
    return Model(arch, make_policy(arch).zcfg, world=1, device="cpu")


# ---------------------------------------------------------------------------
# (a) per-rank files
# ---------------------------------------------------------------------------

def test_every_rank_writes_its_own_shard_file(world):
    path = os.path.join(world["d"], "el", f"ckpt_{SAVE_AT}")
    files = [f"shard_{i:05d}.npz" for i in range(8)]
    assert sorted(os.listdir(path)) == sorted(files + [ts.MANIFEST])
    assert sorted(os.listdir(os.path.dirname(path))) == [f"ckpt_{SAVE_AT}"]
    man = ts.read_manifest(path)
    assert man["world"] == man["num_processes"] == 8
    assert man["shard_files"] == files and sorted(man["checksums"]) == files
    assert man["mesh"] == {"data": 4, "model": 2}
    assert man["step"] == SAVE_AT and man["format"] == "fp32"
    assert man["meta"] == {"world": 8, "arch": "gpt-350m-reduced"}
    for rank, f in enumerate(files):
        assert man["checksums"][f] == ts._crc32_file(os.path.join(path, f))
        with np.load(os.path.join(path, f)) as z:
            names = set(z.files)
        want = {f"{k}@{rank}" for k, info in man["layout"].items()
                if not info["replicated"]}
        assert names == want | ({"opt::count"} if rank == 0 else set())
    ranks = [r["oracle"] for r in world["a"]]
    with np.load(os.path.join(path, files[5])) as z:
        for k, v in ranks[5].items():
            if v.ndim:
                np.testing.assert_array_equal(z[f"{k}@5"], v)


def test_rank_r_holds_the_rth_cut_at_2x2x2(world):
    """At 2 x 2 x 2 the seeded init: rank r's file holds the r-th cut of
    the global init (rank order row-major over pod, data, model, the
    reference's ``key@r``); the reference's ``load_global`` glues the
    files back to it."""
    path = os.path.join(world["d"], "pod", "ckpt_0")
    man = ts.read_manifest(path)
    assert man["mesh"] == {"pod": 2, "data": 2, "model": 2}
    model = Model(get_config(ARCH).reduced(), make_policy(
        get_config(ARCH).reduced(), mesh_lib.AXES3).zcfg, world=8,
        device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init = {k: v.numpy() for k, v in model.init_params(
        gen, dtype=torch.float32).items()}
    for rank in range(8):
        with np.load(os.path.join(path, f"shard_{rank:05d}.npz")) as z:
            for k, v in init.items():
                np.testing.assert_array_equal(
                    z[f"params::{k}@{rank}"], shard_of(v, rank, 8))
    got = world["ref"]["port_pod"]
    for k, v in init.items():
        np.testing.assert_array_equal(got[f"params::{k}"], v)


# ---------------------------------------------------------------------------
# (b) check_state_elastic_restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("at", ("2x2", "1x2"))
def test_elastic_restore(world, at):
    ranks = world["b"] if at == "2x2" else world["c"]
    _all_logical_equal(_glue(ranks, "restored"), world["oracle"])
    assert all(r["same"] for r in ranks), \
        "a step from the checkpoint differs from one from place_global"
    l_ref = np.array(world["a"][0]["losses"][SAVE_AT:])
    l_new = np.array(ranks[0]["losses"])
    assert np.abs(l_new - l_ref).max() / np.abs(l_ref).min() < 0.02, \
        (l_ref, l_new)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


# ---------------------------------------------------------------------------
# (c) check_state_quantized_roundtrip
# ---------------------------------------------------------------------------

def test_quantized_roundtrip(world):
    path = os.path.join(world["d"], "q8", f"ckpt_{SAVE_AT}")
    man = ts.read_manifest(path)
    block = man["quant_block"]
    assert man["format"] == ts.FORMAT_INT8 and block == 256
    assert all(v["quantized"] for v in man["layout"].values()
               if not v["replicated"])

    def size(p):
        return sum(os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))
    fp32 = os.path.join(world["d"], "el", f"ckpt_{SAVE_AT}")
    assert size(path) < 0.35 * size(fp32), (size(path), size(fp32))
    got_all = _glue(world["b"], "q8")
    for k, want in world["oracle"].items():
        if not k.startswith("params::"):
            continue
        got = got_all[k]
        n = min(got.shape[-1], want.shape[-1])
        assert n % block == 0, (k, n, block)
        wb = want[..., :n].reshape(*want.shape[:-1], n // block, block)
        bound = np.abs(wb).max(axis=-1, keepdims=True) / 127.0 * 0.6 + 1e-8
        err = np.abs(got[..., :n].reshape(wb.shape) - wb)
        assert (err <= bound).all(), (k, float(err.max()))
    lq = np.array(world["b"][0]["q8_losses"])
    lf = np.array(world["b"][0]["f32_losses"])
    assert (np.abs(lq - lf) / np.abs(lf)).max() < 0.05, (lq, lf)
    assert list(lf) == world["b"][0]["losses"]


# ---------------------------------------------------------------------------
# (d) check_state_serving_load
# ---------------------------------------------------------------------------

def test_serving_load(world):
    from repro.train import state as rs
    d = os.path.join(world["d"], "serve")
    model = _world1_model()
    params = ts.load_serving_params(model, d)
    eng = ServeEngine.from_checkpoint(model, d, n_slots=1, kv_len=64,
                                      device="cpu")
    _, tree, _ = ts.load_global(os.path.join(d, "ckpt_0"))
    _, rtree, _ = rs.load_global(os.path.join(d, "ckpt_0"))
    shapes = model.param_shapes()
    assert set(params) == set(shapes) == set(tree["params"])
    for k, v in params.items():
        np.testing.assert_array_equal(tree["params"][k], rtree["params"][k])
        want = rs.fit_to(rtree["params"][k], shapes[k]).astype(
            rs._BF16).view(np.uint16)
        assert v.dtype == torch.bfloat16 and tuple(v.shape) == shapes[k]
        np.testing.assert_array_equal(
            v.view(torch.int16).numpy().view(np.uint16), want)
        assert torch.equal(eng.params[k], v)


# ---------------------------------------------------------------------------
# (e) check_checkpoint_elastic_restart, through the launcher's loop
# ---------------------------------------------------------------------------

def test_launcher_elastic_restart(world):
    first = world["a"][0]["launch"]
    assert first["start"] == 0 and len(first["save_s"]) == 1
    # the launcher's 4 x 2 run is the uninterrupted run's first steps
    assert first["losses"] == world["a"][0]["losses"][:SAVE_AT]
    second = world["b"][0]["launch"]
    assert second["start"] == SAVE_AT
    assert second["restored"]["world"] == 8
    assert second["restored"]["data_cursor"] == SAVE_AT
    l_ref = np.array(world["a"][0]["losses"][SAVE_AT:])
    rel = np.abs(np.array(second["losses"]) - l_ref) / np.abs(l_ref)
    assert len(second["losses"]) == STEPS - SAVE_AT and rel.max() < 0.02, \
        (l_ref, second["losses"])


# ---------------------------------------------------------------------------
# (f) interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ("f32", "q8"))
def test_references_checkpoint_restores_in_the_port(world, fmt):
    want = world["ref"][fmt]
    _all_logical_equal(_glue(world["b"], "ref_" + fmt), want)
    st = ts.ZeroState.restore(_world1_model(), mesh_lib.make_mesh((1, 1)),
                              os.path.join(world["r"], fmt))
    assert st.step == 3 and st.meta["world"] == 8
    _all_logical_equal(_shards(st), want)


@pytest.mark.parametrize("fmt", ("el", "q8"))
def test_ports_checkpoint_restores_in_the_reference(world, fmt):
    """The reference's ``load_global`` of the port's 8 files, and its
    ``ZeroState.restore`` at (2, 2): the saved state itself (fp32), the
    port's own dequantized load (INT8)."""
    if fmt == "el":
        want = world["oracle"]
    else:
        _, tree, _ = ts.load_global(os.path.join(world["d"], "q8",
                                                 f"ckpt_{SAVE_AT}"))
        want = ts.flatten_state(tree)
    ref = world["ref"]
    assert set(ref["port_" + fmt]) == set(want)
    for k in want:
        np.testing.assert_array_equal(ref["port_" + fmt][k], want[k])
    _all_logical_equal(ref[f"port_{fmt}_at_2x2"], want)


def test_int8_payload_is_the_references_byte_for_byte(world):
    """The port's 4 x 2 INT8 save of the state it restored from the
    reference's fp32 checkpoint against the reference's INT8 save of that
    state: every ``key@r`` payload and ``#scales`` member of the
    reference's one file equals the port's rank-r file's."""
    mine = os.path.join(world["d"], "interop", f"ckpt_{SAVE_AT}")
    theirs = os.path.join(world["r"], "q8", f"ckpt_{SAVE_AT}")
    ma, mb = ts.read_manifest(mine), ts.read_manifest(theirs)
    assert ma["layout"] == mb["layout"] and ma["meta"] == mb["meta"]
    assert mb["num_processes"] == 1 and ma["num_processes"] == 8
    with np.load(os.path.join(theirs, "shard_00000.npz")) as z:
        ref = {k: z[k] for k in z.files}
    seen = set()
    for rank in range(8):
        with np.load(os.path.join(mine, f"shard_{rank:05d}.npz")) as z:
            for k in z.files:
                a, b = z[k], ref[k]
                assert a.dtype == b.dtype and a.shape == b.shape, k
                assert a.tobytes() == b.tobytes(), k
                seen.add(k)
    assert seen == set(ref)
    assert any(k.endswith("#scales") for k in seen)
