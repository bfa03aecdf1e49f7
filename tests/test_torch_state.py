"""Port vs reference: the checkpoint format (``repro_torch.train.state``),
in one process.

  (a) the format's numpy, bit for bit against the reference's
      ``train/state.py`` on seeded inputs: ``_fp16_scale`` (both
      roundings), ``quantize_shard``/``dequantize_shard`` and the
      sqrt-domain pair (payload, scale bits, shapes), with a block of
      zeros, subnormal and huge absmax (the scale's flush and inf clamps),
      an outlier block and negative ``v`` (clipped to 0); ``fit_to``
      truncating, extending and keeping; a trailing dim that
      ``quant_block`` does not divide is stored raw by both sides;
  (b) the reference's fast ``tests/test_state.py`` cases on the port:
      discovery skips foreign files and ignores ``.tmp``/``.corrupt``, the
      roundtrip bound, sqrt never underestimates, the world-1 roundtrip
      in both formats, legacy npz compat, the corrupt-checkpoint fallback
      and a truncated shard exhausting to None (the reference's fault
      helpers damage the port's files);
  (c) world-1 interop: the same host state saved by both sides gives the
      same npz members byte for byte (fp32 and INT8) and the same
      manifest but for checksums; each side restores the other's
      checkpoint exactly; bf16 goes to disk as its uint16 bits (no
      ``ml_dtypes`` on the port's side) and loads widened to float32,
      bit-exact against the reference's bfloat16;
  (d) the commit protocol's seam: an ``IOHooks`` OSError is retried, its
      exhaustion raises ``CheckpointError``, any other exception
      propagates; no staging debris either way;
  (e) the launcher's ``--ckpt-dir/--ckpt-every/--ckpt-format`` at world 1
      (a restart continues at the saved step, bit for bit with the
      uninterrupted run) and ``ServeEngine.from_checkpoint`` (bf16 params
      equal to bf16 of ``fit_to`` of the loaded global buffers; another
      arch's checkpoint refused).

The multi-rank side (per-rank shard files, elastic restore, the
reference reading the port's 8-file checkpoints) is
``test_torch_state_multirank.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json                                                  # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import ServeEngine                    # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

BLOCK = 64
# The sqrt encoder's ``v_hat >= v`` holds to one fp32 ulp: ``ceil(u *
# fl(1/s))`` and ``(q·s)²`` round, and about 2 elements in a million land
# under v by < 2^-23 relative, on both sides (the reference's own test
# draws none).
_ULP = 2.0 ** -23


def _ref():
    from repro.train import state as rs
    return rs


def _same(a, b):
    """Equal dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# (a) the format's numpy against the reference's
# ---------------------------------------------------------------------------

def _inputs():
    """name -> float32 (rows, 6 * BLOCK) input, seeded."""
    rng = np.random.default_rng(0)
    base = (rng.normal(size=(3, 6 * BLOCK)) * 0.05).astype(np.float32)
    zeros = base.copy()
    zeros[:, BLOCK:2 * BLOCK] = 0.0                     # a block of zeros
    zeros[1] = 0.0                                      # a row of them
    sub = base.copy()
    sub[0, :BLOCK] = 1e-10                 # absmax/127 below fp16's range
    sub[1, :BLOCK] *= 1e-30
    sub[2, BLOCK:2 * BLOCK] = 1.2e-7 * 127             # fp16 subnormal
    huge = base.copy()
    huge[0, :BLOCK] = 3e38                             # scale past fp16 max
    huge[1, 2 * BLOCK] = -1e12
    huge[2, :BLOCK] = 65504.0 * 127
    out = base.copy()
    out[0, :BLOCK] *= 100.0                            # outlier block
    return {"normal": base, "zeros": zeros, "subnormal": sub, "huge": huge,
            "outlier": out}


@pytest.mark.parametrize("round_up", (False, True))
def test_fp16_scale_is_the_references(round_up):
    rng = np.random.default_rng(1)
    s = np.concatenate([
        rng.uniform(0, 1, 64), 10.0 ** rng.uniform(-12, 6, 64),
        [0.0, 1e-30, 5.9e-8, 6e-8, 6.1e-8, 1e-7, 65504.0, 65519.0, 65520.0,
         7e4, 3e38, np.inf]]).astype(np.float32)
    got = ts._fp16_scale(s, round_up)
    _same(got, _ref()._fp16_scale(s, round_up))
    assert np.isfinite(got).all() and (got[s > 0] > 0).all()


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_quantize_shard_is_the_references(name):
    rs = _ref()
    x = _inputs()[name]
    q, s = ts.quantize_shard(x, BLOCK)
    rq, rsc = rs.quantize_shard(x, BLOCK)
    _same(q, rq)
    _same(s, rsc)
    assert q.dtype == np.int8 and s.dtype == np.float16
    assert s.shape == (3, 6)
    _same(ts.dequantize_shard(q, s, BLOCK), rs.dequantize_shard(rq, rsc,
                                                                 BLOCK))
    _same(ts.dequantize_shard(q, s, BLOCK, np.float16),
          rs.dequantize_shard(rq, rsc, BLOCK, np.float16))


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_quantize_shard_sqrt_is_the_references(name):
    """The second moment's encoder; the inputs' negative entries (half of
    them) are clipped to 0 on both sides."""
    rs = _ref()
    v = _inputs()[name]
    assert (v < 0).any()
    q, s = ts.quantize_shard_sqrt(v, BLOCK)
    rq, rsc = rs.quantize_shard_sqrt(v, BLOCK)
    _same(q, rq)
    _same(s, rsc)
    assert q.dtype == np.uint8
    back = ts.dequantize_shard_sqrt(q, s, BLOCK)
    _same(back, rs.dequantize_shard_sqrt(rq, rsc, BLOCK))
    # v_hat >= v (to _ULP) wherever the scale did not hit fp16's max (the
    # inf clamp caps it at 65504 on both sides: a block of 3e38 cannot be
    # covered)
    fits = np.repeat(s.astype(np.float32) < 65504, BLOCK, axis=-1)
    assert (back >= np.maximum(v, 0) * (1 - _ULP))[fits].all()
    assert fits.all() == (name != "huge")


@pytest.mark.parametrize("shape,target", [
    ((3, 1000), (3, 1024)), ((3, 1024), (3, 1000)), ((1024,), (1024,)),
    ((512,), (2048,)), ((2, 4, 96), (2, 4, 64))])
def test_fit_to_is_the_references(shape, target):
    rng = np.random.default_rng(2)
    a = rng.normal(size=shape).astype(np.float32)
    _same(ts.fit_to(a, target), _ref().fit_to(a, target))
    with pytest.raises(AssertionError):
        ts.fit_to(a, (7,) + tuple(target))


# ---------------------------------------------------------------------------
# (b) the reference's fast test_state.py cases
# ---------------------------------------------------------------------------

def test_latest_skips_foreign_files(tmp_path):
    d = tmp_path / "ckpts"
    d.mkdir()
    for name in ("ckpt_final.npz", "ckpt_.npz", "ckpt_12abc.npz",
                 "notes.txt", "ckpt_5.tmp"):
        (d / name).write_bytes(b"x")
    (d / "ckpt_3.npz").write_bytes(b"x")
    (d / "ckpt_10.npz").write_bytes(b"x")
    assert tckpt.latest(str(d)) == str(d / "ckpt_10.npz")
    (d / "ckpt_11").mkdir()
    assert tckpt.latest(str(d)) == str(d / "ckpt_10.npz")
    (d / "ckpt_11" / "manifest.json").write_text("{}")
    assert tckpt.latest(str(d)) == str(d / "ckpt_11")
    assert tckpt.latest(str(tmp_path / "missing")) is None


def test_latest_ignores_staging_and_quarantine(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    good = d / "ckpt_4"
    good.mkdir()
    (good / "manifest.json").write_text("{}")
    staging = d / "ckpt_9.tmp"            # crash-left, manifest included
    staging.mkdir()
    (staging / "shard_00000.npz").write_bytes(b"x")
    (staging / "manifest.json").write_text("{}")
    quarantined = d / "ckpt_12.corrupt"
    quarantined.mkdir()
    (quarantined / "manifest.json").write_text("{}")
    assert tckpt.latest(str(d)) == str(good)


def test_quantize_shard_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 8 * BLOCK)) * 0.05).astype(np.float32)
    x[0, :BLOCK] *= 100.0          # outlier block must not poison others
    q, s = ts.quantize_shard(x, BLOCK)
    assert q.shape == x.shape and s.shape == (3, 8)
    back = ts.dequantize_shard(q, s, BLOCK)
    xb = x.reshape(3, 8, BLOCK)
    bound = np.abs(xb).max(axis=-1, keepdims=True) / 127.0 * 0.6 + 1e-8
    assert (np.abs(back.reshape(xb.shape) - xb) <= bound).all()
    q0, s0 = ts.quantize_shard(np.zeros((2 * BLOCK,), np.float32), BLOCK)
    assert not q0.any() and not s0.astype(np.float32).any()
    assert not ts.dequantize_shard(q0, s0, BLOCK).any()


def test_quantize_shard_sqrt_never_underestimates():
    rng = np.random.default_rng(1)
    for mag in (1.0, 1e-4, 1e-8, 1e-12, 1e-16):
        v = (rng.uniform(0, 1, size=(4 * BLOCK,)) * mag).astype(np.float32)
        q, s = ts.quantize_shard_sqrt(v, BLOCK)
        back = ts.dequantize_shard_sqrt(q, s, BLOCK)
        assert (back >= v).all(), (mag, float((v - back).max()))
        assert back[v > 0].min() > 0, mag   # no flush-to-zero
    x = (rng.normal(size=(2 * BLOCK,)) * 1e-7).astype(np.float32)
    q, s = ts.quantize_shard(x, BLOCK)
    assert s.astype(np.float32).min() > 0
    back = ts.dequantize_shard(q, s, BLOCK)
    assert np.isfinite(back).all()
    s32 = np.repeat(s.astype(np.float32), BLOCK)
    assert (np.abs(back - x) <= s32 / 2 + 1e-12).all()


def _tiny(seed=0, arch_name="gpt-350m"):
    """A world-1 state of ``arch_name`` reduced on the CPU."""
    arch = get_config(arch_name).reduced()
    model = Model(arch, make_policy(arch).zcfg, world=1, device="cpu")
    mesh = mesh_lib.make_mesh((1, 1))
    return model, mesh, ts.ZeroState(model, mesh).init(seed)


def _host_params(st):
    return {k: v.numpy().copy() for k, v in st.params.items()}


def test_zero_state_roundtrip_single_device(tmp_path):
    model, mesh, st = _tiny()
    gen = torch.Generator().manual_seed(8)
    st.opt["m"] = {k: torch.randn(v.shape, generator=gen)
                   for k, v in st.params.items()}
    st.opt["v"] = {k: torch.rand(v.shape, generator=gen)
                   for k, v in st.params.items()}
    p_host = _host_params(st)
    path = st.save(str(tmp_path), 7, meta={"arch": "tiny"})
    assert os.path.basename(path) == "ckpt_7"
    man = ts.read_manifest(path)
    assert man["world"] == 1 and man["step"] == 7
    assert man["num_processes"] == 1
    assert man["shard_files"] == ["shard_00000.npz"]
    assert man["meta"]["arch"] == "tiny"
    assert set(man["param_layout"]) >= {"blocks", "head", "unemb"}
    assert sorted(os.listdir(tmp_path)) == ["ckpt_7"]

    st2 = ts.ZeroState.restore(model, mesh, str(tmp_path))
    assert st2 is not None and st2.step == 7
    for k, v in st2.params.items():
        np.testing.assert_array_equal(v.numpy(), p_host[k])
    for mom in ("m", "v"):
        for k, v in st2.opt[mom].items():
            assert torch.equal(v, st.opt[mom][k])
    assert int(st2.opt["count"]) == 0 and st2.opt["count"].dtype == \
        torch.int32

    path8 = st.save(str(tmp_path / "q"), 7, fmt="int8")
    st3 = ts.ZeroState.restore(model, mesh, str(tmp_path / "q"))
    for k, v in st3.params.items():
        want = p_host[k]
        err = np.abs(v.numpy() - want).max()
        assert err <= np.abs(want).max() / 127.0 * 0.6 + 1e-8, (k, err)
    for k, v in st3.opt["v"].items():       # v_hat >= v, see _ULP
        assert (v >= st.opt["v"][k] * (1 - _ULP)).all()

    def size(p):
        return sum(os.path.getsize(os.path.join(p, f))
                   for f in os.listdir(p) if f != ts.MANIFEST)
    assert size(path8) < 0.35 * size(path)


def test_legacy_npz_compat(tmp_path):
    model, mesh, st = _tiny()
    p_host = _host_params(st)
    path = str(tmp_path / "ckpt_4.npz")
    tckpt.save(path, 4, {"params": st.params, "opt": st.opt}, {"world": 1})
    step, tree, meta = tckpt.load(path)
    assert step == 4 and meta["world"] == 1
    st2 = ts.ZeroState.restore(model, mesh, str(tmp_path))
    assert st2 is not None and st2.step == 4
    for k, v in st2.params.items():
        np.testing.assert_array_equal(v.numpy(), p_host[k])
    # the reference reads the port's legacy file
    rstep, rtree, rmeta = _ref().load_legacy_npz(path)
    assert rstep == 4 and rmeta == {"world": 1}
    for k, v in rtree["params"].items():
        _same(v, p_host[k])


def test_restore_corrupt_checkpoint_fallback(tmp_path):
    from repro.testing.faults import corrupt_shard
    model, mesh, st = _tiny()
    p_host = _host_params(st)
    st.save(str(tmp_path), 1)
    st.save(str(tmp_path), 2)
    corrupt_shard(str(tmp_path / "ckpt_2"))
    with pytest.raises(ts.CheckpointCorruptError, match="checksum mismatch"):
        ts.load_global(str(tmp_path / "ckpt_2"))
    st2 = ts.ZeroState.restore_resilient(model, mesh, str(tmp_path))
    assert st2 is not None and st2.step == 1
    assert (tmp_path / "ckpt_2.corrupt").is_dir()
    for k, v in st2.params.items():
        np.testing.assert_array_equal(v.numpy(), p_host[k])


def test_restore_truncated_shard_exhausts_to_none(tmp_path):
    from repro.testing.faults import truncate_shard
    model, mesh, st = _tiny()
    st.save(str(tmp_path), 3)
    truncate_shard(str(tmp_path / "ckpt_3"))
    with pytest.raises(ts.CheckpointCorruptError):
        ts.load_global(str(tmp_path / "ckpt_3"))
    assert ts.ZeroState.restore_resilient(model, mesh, str(tmp_path)) is None
    assert (tmp_path / "ckpt_3.corrupt").is_dir()
    assert ts.ZeroState.restore(model, mesh, str(tmp_path)) is None


def test_bad_manifest_and_missing_shard_are_corrupt(tmp_path):
    model, mesh, st = _tiny()
    path = st.save(str(tmp_path), 1)
    (tmp_path / "ckpt_1" / "manifest.json").write_text("{not json")
    with pytest.raises(ts.CheckpointCorruptError, match="not valid JSON"):
        ts.load_global(path)
    path = st.save(str(tmp_path), 2)
    os.remove(os.path.join(path, "shard_00000.npz"))
    with pytest.raises(ts.CheckpointCorruptError, match="missing shard"):
        ts.load_global(path)
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        st.save(str(tmp_path), 3, fmt="int4")


# ---------------------------------------------------------------------------
# (c) world-1 interop
# ---------------------------------------------------------------------------

def _ref_tiny(arch_name="gpt-350m"):
    """The reference's world-1 state of ``arch_name`` reduced, and its
    global host buffers (any ``bq``/``bk``/``bv`` bias drawn nonzero)."""
    import jax
    from repro.configs import get_config as rget
    from repro.core.compat import auto_axis_types, make_mesh
    from repro.models.model import Model as RModel
    from repro.optim.adamw import AdamWConfig
    from repro.train.policy import make_policy as rpolicy
    rmesh = make_mesh((1, 1), ("data", "model"),
                      axis_types=auto_axis_types(2))
    arch = rget(arch_name).reduced()
    rmodel = RModel(arch, rpolicy(arch, ("data", "model")).zcfg, world=1)
    cfg = AdamWConfig()
    st = _ref().ZeroState(rmodel, rmesh, cfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    host = jax.device_get({"params": st.params, "opt": st.opt})
    host = {"params": {k: np.array(v) for k, v in host["params"].items()},
            "opt": {"m": {k: rng.normal(size=v.shape).astype(np.float32)
                          for k, v in host["params"].items()},
                    "v": {k: rng.uniform(size=v.shape).astype(np.float32)
                          for k, v in host["params"].items()},
                    "count": np.asarray(5, np.int32)}}
    blocks = host["params"]["blocks"]
    for name, _ in rmodel.period_spec.entries:
        if name.split(".")[-1] in ("bq", "bk", "bv"):
            off, n = rmodel.period_spec.offsets[name]
            blocks[:, off:off + n] = rng.normal(size=(blocks.shape[0], n))
    st.place_global(host["params"], host["opt"])
    return rmodel, rmesh, cfg, st, host


def _npz(path):
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("fmt", ("fp32", "int8"))
def test_world1_checkpoints_cross_both_ways(tmp_path, fmt):
    _cross_both_ways(tmp_path, fmt, "gpt-350m")


@pytest.mark.parametrize("fmt", ("fp32", "int8"))
def test_world1_qwen2_vl_checkpoints_cross_both_ways(tmp_path, fmt):
    """qwen2-vl-72b reduced: no ``embed`` group, the ``bq``/``bk``/``bv``
    entries in the layer groups (seeded nonzero)."""
    path = _cross_both_ways(tmp_path, fmt, "qwen2-vl-72b")
    layout = ts.read_manifest(path)["param_layout"]
    assert "embed" not in layout
    names = [n for n, _ in layout["blocks"]["entries"]]
    assert names.index("0.bq") == names.index("0.wo") + 1


def _cross_both_ways(tmp_path, fmt, arch_name):
    """The same host state saved by both sides, the same bytes; each side
    restores the other's.  Returns the port's checkpoint path."""
    rs = _ref()
    rmodel, rmesh, cfg, rst, host = _ref_tiny(arch_name)
    rpath = rst.save(str(tmp_path / "ref"), 5, fmt=fmt, meta={"world": 1})
    model, mesh, _ = _tiny(arch_name=arch_name)
    st = ts.ZeroState(model, mesh, step=5).place_global(host["params"],
                                                        host["opt"])
    path = st.save(str(tmp_path / "port"), fmt=fmt, meta={"world": 1})
    # the same host state: the same members, byte for byte
    a, b = _npz(path), _npz(rpath)
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k])
    ma, mb = ts.read_manifest(path), ts.read_manifest(rpath)
    assert set(ma) == set(mb)
    assert {k: v for k, v in ma.items() if k != "checksums"} == \
        {k: v for k, v in mb.items() if k != "checksums"}
    # each side restores the other's
    _, rtree, _ = rs.load_global(rpath)
    back = ts.ZeroState.restore(model, mesh, rpath)
    assert back.step == 5 and int(back.opt["count"]) == 5
    for k, v in back.params.items():
        _same(v.numpy(), rtree["params"][k])
    for mom in ("m", "v"):
        for k, v in back.opt[mom].items():
            _same(v.numpy(), rtree["opt"][mom][k])
    rback = rs.ZeroState.restore(rmodel, rmesh, cfg, path)
    for k, v in rback.params.items():
        _same(np.asarray(v), back.params[k].numpy())
    if fmt == "fp32":
        for k, v in back.params.items():
            _same(v.numpy(), host["params"][k])
    return path


def test_a_trailing_dim_the_block_does_not_divide_is_stored_raw(tmp_path):
    """Both sides store a shard raw under the INT8 format when its trailing
    dim is not a multiple of ``quant_block``."""
    rs = _ref()
    rmodel, rmesh, cfg, _, _ = _ref_tiny()
    model, mesh, _ = _tiny()
    rng = np.random.default_rng(6)
    params = {"embed": rng.normal(size=(1000,)).astype(np.float32),
              "head": rng.normal(size=(2, 512)).astype(np.float32)}
    rpath = rs.ZeroState(rmodel, rmesh, cfg, params=params).save(
        str(tmp_path / "ref"), 1, fmt="int8", quant_block=256)
    path = ts.ZeroState(model, mesh, step=1, params={
        k: torch.from_numpy(v) for k, v in params.items()}).save(
        str(tmp_path / "port"), fmt="int8", quant_block=256)
    lay = ts.read_manifest(path)["layout"]
    assert lay["params::embed"]["encoding"] == "raw"
    assert lay["params::head"]["encoding"] == "int8_blockwise"
    assert lay == ts.read_manifest(rpath)["layout"]
    a, b = _npz(path), _npz(rpath)
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k])


def test_bf16_goes_to_disk_as_its_bits(tmp_path):
    """A bf16 buffer is stored as uint16 under layout dtype "bfloat16"
    (the reference's encoding), read by the reference as its bfloat16 and
    by the port widened to float32, both bit-exact."""
    rs = _ref()
    model, mesh, _ = _tiny()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    x[0, :4] = torch.tensor([0.0, -0.0, float("inf"), 1e-40])
    xb = x.to(torch.bfloat16)
    for fmt in ("fp32", "int8"):
        path = ts.ZeroState(model, mesh, step=1, params={"head": xb}).save(
            str(tmp_path / fmt), fmt=fmt)
        lay = ts.read_manifest(path)["layout"]["params::head"]
        assert lay["dtype"] == "bfloat16" and lay["encoding"] == "raw"
        assert _npz(path)["params::head@0"].dtype == np.uint16
        _, tree, _ = ts.load_global(path)
        got = tree["params"]["head"]
        assert got.dtype == np.float32
        _same(got, xb.to(torch.float32).numpy())
        _, rtree, _ = rs.load_global(path)
        want = rtree["params"]["head"]
        assert want.dtype.name == "bfloat16"
        _same(want.view(np.uint16),
              xb.view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------------------
# (d) the commit protocol's seam
# ---------------------------------------------------------------------------

class _Flaky(ts.IOHooks):
    def __init__(self, n, exc=OSError):
        self.n, self.exc, self.calls = n, exc, 0

    def pre_publish(self, staging, final):
        self.calls += 1
        assert os.path.exists(os.path.join(staging, ts.MANIFEST))
        if self.calls <= self.n:
            raise self.exc("injected")


def test_io_hooks_retry_exhaust_and_propagate(tmp_path):
    model, mesh, st = _tiny()
    hooks = _Flaky(2)
    path = st.save(str(tmp_path), 1, io_hooks=hooks, retries=2,
                   backoff=0.0)
    assert hooks.calls == 3 and ts.load_global(path)[0] == 1
    with pytest.raises(ts.CheckpointError, match="after 2 attempt"):
        st.save(str(tmp_path), 2, io_hooks=_Flaky(5), retries=1,
                backoff=0.0)
    with pytest.raises(RuntimeError, match="injected"):
        st.save(str(tmp_path), 3, io_hooks=_Flaky(1, RuntimeError),
                retries=3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1"]


# ---------------------------------------------------------------------------
# (e) the launcher and the engine
# ---------------------------------------------------------------------------

def _args(*extra):
    return tlaunch.parser().parse_args([
        "--arch", "gpt-350m", "--reduced", "--device", "cpu", "--batch", "4",
        "--seq", "64", "--lr", "3e-3", "--log-every", "0", *extra])


def test_launcher_restarts_where_it_saved(tmp_path):
    """``--ckpt-every 2`` saves at steps 2 and 4; a restart with
    ``--ckpt-dir`` takes the latest and continues at its step, bit for
    bit with the uninterrupted run (the same batches, the LR schedule from
    the restored count); an INT8 checkpoint restarts within 5 %."""
    full = tlaunch.train_loop(_args("--steps", "6"))
    d = str(tmp_path / "ck")
    first = tlaunch.train_loop(_args("--steps", "4", "--ckpt-dir", d,
                                     "--ckpt-every", "2"))
    assert first["start"] == 0 and first["restored"] is None
    assert len(first["save_s"]) == 2
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4"]
    assert first["losses"] == full["losses"][:4]
    meta = ts.read_manifest(os.path.join(d, "ckpt_4"))["meta"]
    assert meta == {"world": 1, "arch": "gpt-350m-reduced",
                    "data_cursor": 4}
    again = tlaunch.train_loop(_args("--steps", "6", "--ckpt-dir", d))
    assert again["start"] == 4 and again["restored"]["world"] == 1
    assert again["losses"] == full["losses"][4:]
    for k, v in again["params"].items():
        assert torch.equal(v, full["params"][k])
    q = str(tmp_path / "q")
    tlaunch.train_loop(_args("--steps", "4", "--ckpt-dir", q,
                             "--ckpt-every", "4", "--ckpt-format", "int8"))
    assert ts.read_manifest(os.path.join(q, "ckpt_4"))["format"] == \
        ts.FORMAT_INT8
    lq = tlaunch.train_loop(_args("--steps", "6", "--ckpt-dir", q))["losses"]
    rel = np.abs(np.array(lq) - full["losses"][4:]) / np.abs(
        full["losses"][4:])
    assert rel.max() < 0.05, (lq, full["losses"][4:])


def test_engine_boots_from_a_checkpoint(tmp_path):
    """``from_checkpoint`` through ``load_serving_params``: bf16 bits of
    ``fit_to`` of the loaded global params (INT8: dequantized), greedy
    tokens equal to an engine given those params, and a paged engine
    booted from the same checkpoint serves the same tokens; another
    arch's checkpoint and a missing one raise."""
    arch = get_config("gpt-350m").reduced()
    model, mesh, st = _tiny(seed=5)
    d = str(tmp_path / "q")
    ts.ZeroState(model, mesh, params=st.params).save(
        d, 0, fmt="int8", meta={"arch": arch.name})
    serve = Model(arch, make_policy(arch).zcfg, world=1, device="cpu")
    eng = ServeEngine.from_checkpoint(serve, d, n_slots=2, kv_len=64,
                                      device="cpu")
    _, tree, _ = ts.load_global(os.path.join(d, "ckpt_0"))
    want = {k: torch.from_numpy(ts.fit_to(v, serve.param_shapes()[k])).to(
        torch.bfloat16) for k, v in tree["params"].items()}
    assert set(eng.params) == set(want)
    for k, v in eng.params.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, want[k]), k
    plain = ServeEngine(serve, want, n_slots=2, kv_len=64, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, n) for n in (5, 11)]
    toks = []
    for e in (eng, plain):
        uids = [e.submit(p, max_new_tokens=4) for p in prompts]
        res = e.run(max_steps=100)
        toks.append([res[u] for u in uids])
    assert toks[0] == toks[1] and all(len(t) == 4 for t in toks[0])
    other = Model(get_config("qwen3-0.6b").reduced(),
                  make_policy(arch).zcfg, world=1, device="cpu")
    with pytest.raises(ValueError, match="written for arch"):
        ServeEngine.from_checkpoint(other, d, n_slots=1, kv_len=64,
                                    device="cpu")
    paged = ServeEngine.from_checkpoint(serve, d, n_slots=2, kv_len=64,
                                        device="cpu", pool="paged")
    uids = [paged.submit(p, max_new_tokens=4) for p in prompts]
    res = paged.run(max_steps=100)
    assert [res[u] for u in uids] == toks[1]
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_checkpoint(serve, str(tmp_path / "none"),
                                    n_slots=1, kv_len=64, device="cpu")


def test_manifest_is_json_with_the_references_keys(tmp_path):
    _, _, st = _tiny()
    path = st.save(str(tmp_path), 2, fmt="int8")
    with open(os.path.join(path, ts.MANIFEST)) as f:
        man = json.load(f)
    assert set(man) == {"version", "step", "world", "mesh", "format",
                        "quant_block", "scale_dtype", "num_processes",
                        "shard_files", "checksums", "layout",
                        "param_layout", "meta"}
    assert man["quant_block"] == 256 and man["scale_dtype"] == "float16"
    assert man["mesh"] == {"data": 1, "model": 1}
    assert man["layout"]["opt::count"] == {
        "shape": [], "dtype": "int32", "replicated": True,
        "quantized": False, "encoding": "raw"}
    assert man["layout"]["opt::v::blocks"]["encoding"] == \
        "uint8_sqrt_blockwise"
