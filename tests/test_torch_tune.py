"""Port vs reference: boot-time tuning (``repro_torch.tune``), analytic, in
one process.

  (a) ``resolve`` against the reference's on the same profile (the
      reference's committed static profile loaded into both), the same
      budgets and tokens, with the port's ring model at the reference's
      peak: seven configs, the five variants, both axis sets, modes "off"
      and "static", training and serving; every ``ZeroConfig`` field but
      the groups, the moments' dtype, ``n_params``, ``train_accum``,
      ``note``, the decisions but the backend line, and the ledger;
  (b) the reference's analytic ``tests/test_tune.py`` cases on the port:
      determinism, overrides win, the depth monotone in the budget, the
      walk-down to 0, the profile round trip and ``for_mesh``, the ring
      ledger against a hand count, every training line charged, the paged
      serve ledger, the MoE expert ring, and ``_fit`` bit for bit against
      the reference's on the same points;
  (c) the large-model preset: ``make_policy`` of qwen1.5-110b and
      qwen3-moe-235b-a22b on both axis sets equals the reference's, and
      counting their parameters allocates nothing;
  (d) bf16 Adam moments: three updates against the reference's (params
      at ``step_bars.close``; m and v equal, or one bf16 ulp apart where
      the fp32 values differ), and a bf16-moment checkpoint each side
      writes read by the other bit for bit;
  (e) the committed H100 profile: its numbers and their sources.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses                                           # noqa: E402
import json                                                  # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, apply_update,  # noqa: E402
                                     init_opt_state)
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402
from repro_torch.tune import (GB, ProbeProfile, ring_lines,  # noqa: E402
                              serve_ledger, static_profile, train_ledger)
from repro_torch.tune import memory as tmem                  # noqa: E402
from repro_torch.tune import probe as tprobe                 # noqa: E402
from repro_torch.tune import resolve as tresolve             # noqa: E402
from repro_torch.tune import ring_model                      # noqa: E402

AXES2 = ("data", "model")
AXES3 = ("pod", "data", "model")
SIZES = {AXES2: {"data": 16, "model": 16},
         AXES3: {"pod": 2, "data": 16, "model": 16}}
VARIANTS = ("zeropp", "baseline", "qwz", "hpz", "qgz")
BUDGETS_GB = (32, 16, 8, 2, 1)
TOKENS = 2048
# (name, reduced): the grid of configs
GRID = (("gpt-350m", True), ("qwen3-0.6b", False), ("gemma3-4b", False),
        ("deepseek-moe-16b", True), ("mamba2-130m", False),
        ("qwen1.5-110b", False), ("qwen3-moe-235b-a22b", False))
LARGE = ("qwen1.5-110b", "qwen3-moe-235b-a22b")
_GROUPS = ("group", "intra_group", "inter_group", "secondary_group")


def _arch():
    return get_config("gpt-350m").reduced()


def _ref_configs(name, reduced):
    from repro.configs import get_config as rget
    j, t = rget(name), get_config(name)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _zcfg_fields(z) -> dict:
    """Every ZeroConfig field but the groups, dtypes by name."""
    out = {}
    for f in dataclasses.fields(z):
        if f.name in _GROUPS:
            continue
        v = getattr(z, f.name)
        out[f.name] = _dtype_name(v) if "dtype" in f.name else v
    return out


def _summary(rp) -> dict:
    return {"zcfg": _zcfg_fields(rp.zcfg),
            "moments": _dtype_name(rp.moments_dtype),
            "n_params": rp.n_params, "train_accum": rp.train_accum,
            "note": rp.note, "mode": rp.mode,
            "decisions": [d for d in rp.decisions
                          if not d.startswith("kernel_backend=")],
            "ledger": rp.ledger.as_dict() if rp.ledger else None}


@pytest.fixture
def ref_peak(monkeypatch):
    """The port's ring model at the reference's peak (the only constant
    the two models do not share)."""
    import benchmarks.throughput_model as tm
    monkeypatch.setattr(ring_model, "PEAK", tm.PEAK)
    return tm


# ---------------------------------------------------------------------------
# (a) resolve against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", (AXES2, AXES3), ids=("2axes", "3axes"))
@pytest.mark.parametrize("name,reduced", GRID, ids=[g[0] for g in GRID])
def test_resolve_matches_reference(name, reduced, axes, ref_peak):
    from repro.tune import resolve as rresolve
    from repro.tune.probe import STATIC_PROFILE_PATH
    from repro.tune.probe import ProbeProfile as RProfile
    jarch, arch = _ref_configs(name, reduced)
    jprof = RProfile.load(STATIC_PROFILE_PATH)
    prof = ProbeProfile.load(STATIC_PROFILE_PATH)
    sizes = SIZES[axes]
    n = 0
    for variant in VARIANTS:
        for workload in ("train", "serve"):
            cells = [dict(mode="off")] + [
                dict(mode="static", mesh_sizes=sizes,
                     hbm_budget_bytes=b * GB, tokens_per_device=TOKENS)
                for b in BUDGETS_GB]
            for kw in cells:
                kw = dict(kw, workload=workload, n_slots=8, kv_len=2048)
                j = rresolve(jarch, axes, variant,
                             profile=jprof if kw["mode"] != "off" else None,
                             **kw)
                t = tresolve(arch, axes, variant,
                             profile=prof if kw["mode"] != "off" else None,
                             device="cpu", **kw)
                assert _summary(t) == _summary(j), (name, axes, variant, kw)
                assert t.kernel_backend == "plain"
                n += 1
    assert n == len(VARIANTS) * 2 * (1 + len(BUDGETS_GB))


@pytest.mark.parametrize("n_layers", (1, 2, 6, 48))
def test_ring_model_matches_reference(n_layers, ref_peak):
    """``step_time_ring`` and ``break_even_depth`` equal the reference's
    on the same inputs."""
    tm = ref_peak
    for variant in VARIANTS:
        for slow in (1e9, 12.5e9, 50e9, 1e15):
            for lat in (0.0, 5e-6, 2e-4):
                kw = dict(n_layers=n_layers, latency=lat, fast_bw=300e9)
                assert ring_model.break_even_depth(
                    3_000_000, 4096, variant, slow, **kw) == \
                    tm.break_even_depth(3_000_000, 4096, variant, slow, **kw)
                for d in range(4):
                    assert ring_model.step_time_ring(
                        3_000_000, 4096, variant, slow, d, **kw) == \
                        tm.step_time_ring(3_000_000, 4096, variant, slow, d,
                                          **kw)
    assert ring_model.comm_bytes_per_step(10, "zeropp") == \
        tm.comm_bytes_per_step(10, "zeropp")


def test_serve_ledger_paged_matches_reference():
    """The paged and slab serve ledgers, with and without kv axes, equal
    the reference's (gpt-350m reduced and recurrentgemma-2b's ring and
    state leaves)."""
    from repro.core.zeropp import ZeroConfig as RZ
    from repro.models.model import Model as RModel
    from repro.tune import serve_ledger as rserve
    for name in ("gpt-350m", "recurrentgemma-2b"):
        jarch, arch = _ref_configs(name, True)
        jm = RModel(jarch, RZ(dp_axes=AXES2), world=8)
        tm_ = Model(arch, ZeroConfig(dp_axes=AXES2), world=8, device="cpu")
        sizes = {"data": 4, "model": 2}
        for kw in (dict(), dict(page_size=16), dict(page_size=16, n_pages=5),
                   dict(page_size=16, kv_axes=("model",))):
            kw["budget_bytes"] = 16 * GB
            a = rserve(jm, sizes, n_slots=4, kv_len=64, **kw)
            b = serve_ledger(tm_, sizes, n_slots=4, kv_len=64, **kw)
            assert a.as_dict() == b.as_dict(), (name, kw)
            assert [l.detail for l in a.lines] == [l.detail for l in b.lines]


# ---------------------------------------------------------------------------
# (b) the reference's analytic tests on the port
# ---------------------------------------------------------------------------

def test_resolve_deterministic_under_static_profile():
    kw = dict(mode="static", mesh_sizes={"data": 4, "model": 2},
              hbm_budget_bytes=16 * GB, tokens_per_device=128, device="cpu")
    a = tresolve(_arch(), AXES2, "zeropp", **kw)
    b = tresolve(_arch(), AXES2, "zeropp", **kw)
    assert a == b
    assert a.zcfg == b.zcfg and a.decisions == b.decisions
    assert a.ledger.as_dict() == b.ledger.as_dict()
    assert a.profile.source == "static"


def test_resolve_off_matches_make_policy():
    arch = _arch()
    for variant in VARIANTS:
        for axes in (AXES2, AXES3):
            rp = tresolve(arch, axes, variant, mode="off")
            pol = make_policy(arch, axes, variant)
            assert rp.zcfg == pol.zcfg, (variant, axes)
            assert rp.moments_dtype == pol.moments_dtype
            assert rp.n_params == pol.n_params
            assert rp.note == pol.note
            assert rp.train_accum == pol.train_accum


def test_resolve_overrides_win():
    rp = tresolve(_arch(), AXES2, "zeropp", mode="static",
                  mesh_sizes={"data": 4, "model": 2},
                  overrides={"prefetch": 3, "qwz_block": 512})
    assert rp.zcfg.prefetch == 3
    assert rp.zcfg.qwz_block == 512
    assert any("overrides" in d for d in rp.decisions)
    with pytest.raises(ValueError, match="mode"):
        tresolve(_arch(), AXES2, mode="fast")
    with pytest.raises(ValueError, match="live mesh"):
        tresolve(_arch(), AXES2, mode="probe")


def test_prefetch_monotone_in_budget():
    sizes = {"data": 4, "model": 2}
    depths = []
    for budget_gb in BUDGETS_GB:
        rp = tresolve(_arch(), AXES2, "zeropp", mode="static",
                      mesh_sizes=sizes, hbm_budget_bytes=budget_gb * GB,
                      tokens_per_device=2048)
        depths.append(rp.zcfg.prefetch)
    assert depths == sorted(depths, reverse=True), depths
    rp = tresolve(_arch(), AXES2, "zeropp", mode="static", mesh_sizes=sizes,
                  hbm_budget_bytes=32 * GB)
    assert rp.ledger.fits


def test_ledger_walkdown_hits_zero_on_tiny_budget():
    rp = tresolve(_arch(), AXES2, "zeropp", mode="static",
                  mesh_sizes={"data": 4, "model": 2},
                  hbm_budget_bytes=1 << 20)
    assert rp.zcfg.prefetch == 0
    assert not rp.ledger.fits
    assert any("walk-down" in d for d in rp.decisions)


def test_static_profile_roundtrip(tmp_path):
    prof = static_profile(AXES3, (2, 16, 16))
    assert prof.source == "static"
    p = tmp_path / "prof.json"
    prof.save(str(p))
    back = ProbeProfile.load(str(p))
    assert back == prof
    assert back.fast_bw("model") == prof.fast_bw("model")
    assert back.slow_bw(("pod",)) == prof.slow_bw(("pod",))


def test_profile_for_mesh_rekeys_axes():
    prof = static_profile(AXES3, (2, 16, 16))
    two = prof.for_mesh(AXES2, (16, 16))
    assert set(two.tiers) == {"data", "model"}
    assert two.tiers["model"] == prof.tiers["model"]
    assert two.tiers["data"] == prof.tiers["data"]
    one = prof.for_mesh(AXES2, (1, 1))
    assert all(t == tprobe.TierProfile(0.0, tprobe._MAX_BW)
               for t in one.tiers.values())
    odd = prof.for_mesh(("x", "model"), (4, 2))
    assert odd.tiers["x"] == prof.tiers["data"]


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_ring_ledger_matches_hand_count(k):
    """(k_eff + 1) gathered layer buffers, k_eff gradient slots, bf16,
    k_eff = min(k, n_periods - 1)."""
    z = ZeroConfig(dp_axes=AXES2, prefetch=k)
    model = Model(_arch(), z, world=8, device="cpu")
    lines, rings = ring_lines(model)
    by_name = {l.name: l.bytes for l in lines}
    k_eff = min(k, model.n_periods - 1)
    P = model.period_spec.padded_size
    assert by_name["ring_weights_layers"] == (k_eff + 1) * 2 * P
    assert by_name.get("ring_grads_bwd", 0) == k_eff * 2 * P
    assert dict(rings)["layers"] == k_eff + 1
    assert model.with_prefetch(k).zcfg.prefetch == k
    assert model.with_prefetch(k).period_spec is model.period_spec


def test_train_ledger_charges_every_line():
    sizes = {"data": 4, "model": 2}
    z = ZeroConfig(dp_axes=AXES2, hpz=True, hpz_axes=("model",), prefetch=1)
    model = Model(_arch(), z, world=8, device="cpu")
    led = train_ledger(model, sizes, moments_itemsize=4,
                       tokens_per_device=128, budget_bytes=16 * GB)
    N = model.n_params()
    assert led.line("master_params") == 4 * N // 8
    assert led.line("adam_moments") == 8 * N // 8
    assert led.line("grad_shards") == 4 * N // 8
    assert led.line("hpz_secondary") == 2 * N // 2
    assert led.line("ring_weights_layers") > 0
    assert led.line("activations") > 0
    assert led.total == sum(l.bytes for l in led.lines)
    assert led.fits and led.headroom == 16 * GB - led.total
    bf = train_ledger(model, sizes, moments_itemsize=2,
                      tokens_per_device=128, budget_bytes=16 * GB)
    assert bf.line("adam_moments") * 2 == led.line("adam_moments")


def test_serve_ledger_paged_matches_hand_count():
    arch = _arch()
    model = Model(arch, ZeroConfig(dp_axes=AXES2), world=8, device="cpu")
    sizes = {"data": 4, "model": 2}
    n_slots, kv_len, page = 8, 64, 16
    pm = kv_len // page
    page_bytes = 2 * arch.n_layers * page * arch.n_kv_heads * arch.d_head * 2
    table = n_slots * pm * 4
    led = serve_ledger(model, sizes, n_slots=n_slots, kv_len=kv_len,
                       page_size=page, n_pages=12, kv_axes=("model",),
                       budget_bytes=16 * GB)
    assert led.line("kv_pool") == 12 * page_bytes // 2 + table
    slab = serve_ledger(model, sizes, n_slots=n_slots, kv_len=kv_len,
                        budget_bytes=16 * GB)
    full = serve_ledger(model, sizes, n_slots=n_slots, kv_len=kv_len,
                        page_size=page, kv_axes=AXES2, budget_bytes=16 * GB)
    assert full.line("kv_pool") == slab.line("kv_pool") + table
    assert "ring_grads_bwd" not in full.as_dict()["lines"]
    with pytest.raises(ValueError):
        serve_ledger(model, sizes, n_slots=n_slots, kv_len=kv_len,
                     page_size=24)


def test_moe_ledger_has_expert_ring():
    arch = get_config("deepseek-moe-16b").reduced()
    assert arch.n_experts > 0
    z = ZeroConfig(dp_axes=AXES2, prefetch=2)
    model = Model(arch, z, world=8, device="cpu")
    lines, rings = ring_lines(model)
    assert "ring_weights_experts" in {l.name for l in lines}
    assert "expert_chunks" in dict(rings)
    kc = z.effective_prefetch(arch.expert_chunks)
    E = model.expert_spec.padded_size
    by_name = {l.name: l.bytes for l in lines}
    assert by_name["ring_weights_experts"] == (kc + 1) * 2 * E
    assert by_name.get("ring_grads_experts_bwd", 0) == kc * 2 * E


_FIT_POINTS = (
    [(b, 20e-6 + b / 50e9) for b in (1 << 13, 1 << 15, 1 << 17)],
    [(4096, 1e-5), (4096, 1e-5), (4096, 1e-5)],          # zero variance
    [(1e3, 5e-4), (1e5, 1e-4), (1e6, 2e-5)],             # negative slope
    [(2.0 * n, 1e-4 + 3e-9 * n + 1e-6 * (i % 3))
     for i, n in enumerate((8192, 8192, 32768, 32768, 131072, 131072))],
)


@pytest.mark.parametrize("pts", range(len(_FIT_POINTS)))
def test_fit_matches_reference_bit_for_bit(pts):
    from repro.tune.probe import _fit as rfit
    got, want = tprobe._fit(_FIT_POINTS[pts]), rfit(_FIT_POINTS[pts])
    assert got == want
    lat, bw = got
    assert tprobe._MIN_BW <= bw <= tprobe._MAX_BW and lat >= 0.0


def test_fit_recovers_alpha_beta():
    lat, bps = tprobe._fit(_FIT_POINTS[0])
    assert abs(bps - 50e9) / 50e9 < 1e-6
    assert abs(lat - 20e-6) < 1e-9


# ---------------------------------------------------------------------------
# (c) the large-model preset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", (AXES2, AXES3), ids=("2axes", "3axes"))
@pytest.mark.parametrize("name", LARGE)
def test_large_model_policy_is_the_references(name, axes):
    from repro.configs import get_config as rget
    from repro.train.policy import make_policy as rpolicy
    j = rpolicy(rget(name), axes)
    t = make_policy(get_config(name), axes)
    assert _zcfg_fields(t.zcfg) == _zcfg_fields(j.zcfg)
    assert _dtype_name(t.moments_dtype) == _dtype_name(j.moments_dtype) \
        == "bfloat16"
    assert (t.n_params, t.note, t.train_accum) == \
        (j.n_params, j.note, j.train_accum)
    assert t.zcfg.hpz == (axes == AXES3)
    assert t.zcfg.hpz_axes == (("data", "model") if axes == AXES3 else None)


def test_counting_large_models_allocates_nothing():
    """The analytic count builds specs only: no tensor storage."""
    import tracemalloc
    for name in LARGE:
        arch = get_config(name)
        tracemalloc.start()
        n = tresolve(arch, AXES3, mode="static",
                     mesh_sizes=SIZES[AXES3]).n_params
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert n > 32e9 and peak < 64 << 20, (name, n, peak)


# ---------------------------------------------------------------------------
# (d) bf16 moments
# ---------------------------------------------------------------------------

def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 values that are bf16 (exact widenings) as their 16 bits."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32)
            >> 16).astype(np.int64)


def test_bf16_moment_update_matches_reference():
    """Three steps, each from the reference's state of the step before
    (params, and m and v in bf16), on the same gradients: the params at
    ``step_bars.close``, m and v equal or one bf16 ulp apart (the fp32
    sums before the rounding may differ in their last bit: XLA contracts
    them into FMAs)."""
    import jax
    import jax.numpy as jnp
    from repro.optim.adamw import AdamWConfig as RAdamW
    from repro.optim.adamw import apply_update as rapply
    from repro.optim.adamw import init_opt_state as rinit
    rng = np.random.default_rng(5)
    shapes = {"blocks": (3, 1024), "head": (256,)}
    rcfg = RAdamW(lr=3e-3, moments_dtype=jnp.bfloat16)
    cfg = AdamWConfig(lr=3e-3, moments_dtype=torch.bfloat16)
    jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    jo = rinit(jp, rcfg)
    assert all(m.dtype == torch.bfloat16 for m in init_opt_state(
        {k: torch.zeros(s) for k, s in shapes.items()}, cfg)["m"].values())
    rstep = jax.jit(lambda g, p, o: rapply(g, p, o, rcfg))

    def port_copy(x):        # f32 as is, bf16 from its bits
        a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
        return torch.from_numpy(a.copy()).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)

    differ = 0
    for step in range(3):
        g = {k: (rng.standard_normal(s) * 10.0 ** -step).astype(np.float32)
             for k, s in shapes.items()}
        tp = {k: port_copy(v) for k, v in jp.items()}
        to = {"m": {k: port_copy(v) for k, v in jo["m"].items()},
              "v": {k: port_copy(v) for k, v in jo["v"].items()},
              "count": torch.tensor(int(jo["count"]), dtype=torch.int32)}
        jp, jo, _ = rstep(g, jp, jo)
        apply_update({k: torch.from_numpy(v) for k, v in g.items()}, tp, to,
                     cfg)
        assert int(to["count"]) == int(jo["count"]) == step + 1
        for k in shapes:
            step_bars.close(tp[k].numpy(), np.asarray(jp[k]), f"param {k}")
            for mom in ("m", "v"):
                assert to[mom][k].dtype == torch.bfloat16
                got = _bf16_bits(to[mom][k].float().numpy())
                want = _bf16_bits(np.asarray(jo[mom][k], np.float32))
                ulps = np.abs(got - want)
                assert ulps.max() <= 1, (step, k, mom, ulps.max())
                differ += int((ulps > 0).sum())
    print(f"bf16 moments: {differ} elements one ulp apart over 3 steps")


def _state_pair(tmp_path):
    """A world-1 gpt-350m reduced state with bf16 moments on each side,
    from the same host buffers."""
    import jax
    from repro.configs import get_config as rget
    from repro.core.compat import auto_axis_types, make_mesh
    from repro.models.model import Model as RModel
    from repro.optim.adamw import AdamWConfig as RAdamW
    from repro.train import state as rs
    from repro.train.policy import make_policy as rpolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import state as ts
    import jax.numpy as jnp
    rmesh = make_mesh((1, 1), AXES2, axis_types=auto_axis_types(2))
    jarch = rget("gpt-350m").reduced()
    rmodel = RModel(jarch, rpolicy(jarch, AXES2).zcfg, world=1)
    rcfg = RAdamW(moments_dtype=jnp.bfloat16)
    rst = rs.ZeroState(rmodel, rmesh, rcfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(8)
    params = {k: np.array(v) for k, v in jax.device_get(rst.params).items()}
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    host = {"m": {k: bf(rng.normal(size=v.shape)) for k, v in params.items()},
            "v": {k: bf(rng.uniform(size=v.shape)) for k, v in params.items()},
            "count": np.asarray(4, np.int32)}
    rst.place_global(params, host)
    arch = get_config("gpt-350m").reduced()
    model = Model(arch, make_policy(arch).zcfg, world=1, device="cpu")
    mesh = mesh_lib.make_mesh((1, 1))
    return rs, ts, (rmodel, rmesh, rcfg, rst), (model, mesh), params, host


@pytest.mark.parametrize("fmt", ("fp32", "int8"))
@pytest.mark.parametrize("writer", ("reference", "port"))
def test_bf16_moment_checkpoint_crosses(tmp_path, writer, fmt):
    """A bf16-moment ``ZeroState`` written by one side is read by the other
    bit for bit, in both formats: the moments go to disk as bf16 bits (raw
    under INT8 too, on both sides) and come back as bf16 (the port widens
    on load and narrows into its moments' dtype); INT8 params restore as
    the writer's own restore gives them."""
    rs, ts, (rmodel, rmesh, rcfg, rst), (model, mesh), params, host = \
        _state_pair(tmp_path)
    st = ts.ZeroState(model, mesh, step=4,
                      moments_dtype=torch.bfloat16).place_global(
        params, {"m": {k: np.asarray(v, np.float32)
                       for k, v in host["m"].items()},
                 "v": {k: np.asarray(v, np.float32)
                       for k, v in host["v"].items()},
                 "count": host["count"]})
    assert st.opt["m"]["blocks"].dtype == torch.bfloat16
    rpath = rst.save(str(tmp_path / "ref"), 4, meta={"world": 1}, fmt=fmt)
    path = st.save(str(tmp_path / "port"), meta={"world": 1}, fmt=fmt)
    lay = ts.read_manifest(path)["layout"]
    assert lay == ts.read_manifest(rpath)["layout"]
    assert lay["opt::m::blocks"]["dtype"] == "bfloat16"
    assert lay["opt::m::blocks"]["encoding"] == "raw"
    assert lay["params::blocks"]["encoding"] == (
        "int8_blockwise" if fmt == "int8" else "raw")
    if writer == "reference":
        back = ts.ZeroState.restore(model, mesh, rpath,
                                    moments_dtype=torch.bfloat16)
        mine = rs.ZeroState.restore(rmodel, rmesh, rcfg, rpath)
        assert back.step == 4 and int(back.opt["count"]) == 4
        for mom in ("m", "v"):
            for k, t in back.opt[mom].items():
                assert t.dtype == torch.bfloat16
                want = np.asarray(host[mom][k]).view(np.uint16)
                assert np.array_equal(
                    t.view(torch.int16).numpy().view(np.uint16), want), k
        for k, t in back.params.items():
            assert np.array_equal(t.numpy(), np.asarray(mine.params[k]))
    else:
        back = rs.ZeroState.restore(rmodel, rmesh, rcfg, path)
        mine = ts.ZeroState.restore(model, mesh, path,
                                    moments_dtype=torch.bfloat16)
        for mom in ("m", "v"):
            for k, v in back.opt[mom].items():
                got = np.asarray(v)
                assert got.dtype == host[mom][k].dtype
                assert got.tobytes() == host[mom][k].tobytes(), (mom, k)
        for k, v in back.params.items():
            assert np.array_equal(np.asarray(v), mine.params[k].numpy())


# ---------------------------------------------------------------------------
# (e) the committed profile
# ---------------------------------------------------------------------------

def test_static_profile_is_a_dgx_h100s():
    with open(tprobe.STATIC_PROFILE_PATH) as f:
        raw = json.load(f)
    assert os.path.basename(tprobe.STATIC_PROFILE_PATH) == "static_h100.json"
    assert "H100" in raw["description"] and "NVLink" in raw["description"]
    prof = static_profile(AXES3, (2, 32, 8))
    assert prof.fast_bw("model") == 450e9        # NVLink 4, per direction
    assert prof.tiers["data"].bandwidth_Bps == 50e9   # 400 Gb/s NDR port
    assert prof.slow_bw(("pod",)) < prof.slow_bw(("data",))
    assert ring_model.PEAK == 989.4e12
    assert tmem.HBM_BYTES == 80 * GB
    assert tmem.device_budget("cpu", 4) == 20 * GB
