"""Boot-time tuning on one gloo world of 8 CPU ranks (4 x 2), spawned once
for the whole file.

  (a) the static boot (the counterpart of the reference's
      ``check_tune_static_resolve_boot``, ``checks.py:1844``): gpt-350m
      reduced, batch 16, seq 64, ``build_everything(tune="static")``; on
      every rank the policy equals a direct ``resolve`` call on the same
      inputs (the groups aside: the boot's are the mesh's), its ledger
      fits and counts the effective depth + 1 ring buffers, the AdamW
      config takes its moments' dtype, and two steps give finite losses;
  (b) the probe: ``probe_mesh`` of the 4 x 2 world gives the same profile
      on every rank (each point maxed over the world), and of the same
      ranks as a 1 x 4 x 2 world gives the size-1 pod axis the free tier;
      ``tune="probe"`` then resolves the same policy on every rank and
      trains two finite steps;
  (c) the live buffers (the counterpart of
      ``check_tune_ledger_live_buffers``, ``checks.py:1802``): at prefetch
      0..3 on 6 layers, ``testing.ring_probe`` counts the layer loop's
      live gathered buffers in the forward and in the backward's re-gather
      loop, each equal to the ledger's ``ring_buffers`` (k+1), and the
      reduces in flight under each VJP: k in their first hop (the
      ledger's k unreduced-gradient slots), at most k more in the second.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as tlaunch
from repro_torch.obs.trace import get_tracer
from repro_torch.optim.adamw import init_opt_state
from repro_torch.testing import multirank
from repro_torch.testing.ring_probe import RingProbe
from repro_torch.train.state import init_shards
from repro_torch.tune import GB, probe_mesh, resolve, train_ledger

MESH = (4, 2)
WORLD = 8
AXES = ("data", "model")
BATCH, SEQ, LR = 16, 64, 3e-3
DEPTHS = (0, 1, 2, 3)
_GROUPS = ("group", "intra_group", "inter_group", "secondary_group")


def _summary(pol) -> dict:
    z = {f.name: getattr(pol.zcfg, f.name)
         for f in dataclasses.fields(pol.zcfg) if f.name not in _GROUPS}
    return dict(pol.as_dict(), zcfg=repr(z), note=pol.note)


def _steps(built, n: int) -> list:
    params = init_shards(built.model, 0)
    opt = init_opt_state(params, built.opt_cfg)
    return [tlaunch.run_step(built, params, opt, i, BATCH, 1,
                             get_tracer()).loss for i in range(n)]


def _build(**kw):
    return tlaunch.build_everything("gpt-350m", MESH, "zeropp", True, BATCH,
                                    SEQ, LR, device="cpu", **kw)


def _live_buffers(pf: int) -> dict:
    built = _build(layers=6, prefetch=pf)
    model, mesh = built.model, built.mesh
    P = model.period_spec.padded_size
    X = mesh.sizes["model"]          # hpZ's secondary group
    others = [s[-1] for k, s in model.param_shapes().items() if k != "blocks"]
    for d in (WORLD, X):             # the forward's sources, the backward's
        assert P // d not in [n // d for n in others], (P, others)
    params = init_shards(model, 0)
    opt = init_opt_state(params, built.opt_cfg)
    data = tlaunch.device_batch(built.arch, built.lm, 0, BATCH, 1,
                                model.device)
    with RingProbe(P // WORLD, P // X, P) as probe:
        built.step.fn(params, opt, data)
    led = train_ledger(model, mesh.sizes)
    return {"k": model.zcfg.effective_prefetch(model.n_periods),
            "probe": probe.report(), "ring": dict(led.ring_buffers),
            "grads_line": led.line("ring_grads_bwd"), "P": P}


def _rank(rank: int, world: int) -> dict:
    out = {}
    # (a) the static boot
    built = _build(tune="static", hbm_gb=16.0)
    pol = built.policy
    again = resolve(built.arch, AXES, "zeropp", mode="static",
                    mesh_sizes={"data": 4, "model": 2},
                    hbm_budget_bytes=16 * GB,
                    tokens_per_device=BATCH * SEQ // WORLD, device="cpu")
    z = pol.zcfg
    out["static"] = {
        "same": _summary(pol) == _summary(again),
        "groups": (z.intra_group is built.mesh.intra
                   and z.inter_group is built.mesh.inter),
        "mode": pol.mode, "fits": pol.ledger.fits,
        "ring": dict(pol.ledger.ring_buffers)["layers"],
        "k_eff": z.effective_prefetch(built.model.n_periods),
        "moments": built.opt_cfg.moments_dtype == pol.moments_dtype,
        "policy": _summary(pol),
        "losses": _steps(built, 2)}
    # (c) the live buffers at each depth
    out["live"] = {pf: _live_buffers(pf) for pf in DEPTHS}
    # (b) the probe, then a probed boot
    out["profile"] = probe_mesh(built.mesh, iters=2).to_json()
    probed = _build(tune="probe", hbm_gb=16.0)
    out["probed"] = {"policy": _summary(probed.policy),
                     "profile": probed.policy.profile.to_json(),
                     "losses": _steps(probed, 2)}
    # the same ranks as a 1 x 4 x 2 world (last: it re-labels the world)
    out["profile3"] = probe_mesh(
        mesh_lib.make_mesh((1, 4, 2), axis_groups=True), iters=1).to_json()
    return out


@pytest.fixture(scope="module")
def ranks():
    return multirank.run(_rank, WORLD, timeout=300)


def test_static_boot_resolves_the_same_policy_on_every_rank(ranks):
    for r in ranks:
        s = r["static"]
        assert s["same"] and s["groups"] and s["moments"], s
        assert s["mode"] == "static" and s["fits"]
        assert s["ring"] == s["k_eff"] + 1
        assert s["policy"] == ranks[0]["static"]["policy"]
        assert np.isfinite(s["losses"]).all(), s["losses"]
    assert ranks[0]["static"]["losses"] == ranks[-1]["static"]["losses"]


def test_probe_profiles_are_identical_on_every_rank(ranks):
    prof = ranks[0]["profile"]
    assert prof["source"] == "probe" and prof["mesh_shape"] == [4, 2]
    for r in ranks:
        assert r["profile"] == prof
        assert r["profile3"] == ranks[0]["profile3"]
    for t in prof["tiers"].values():
        assert t["bandwidth_Bps"] > 0 and t["latency_s"] >= 0
    pod = ranks[0]["profile3"]["tiers"]["pod"]
    assert pod == {"latency_s": 0.0, "bandwidth_Bps": 1e15}
    assert ranks[0]["profile3"]["tiers"]["data"]["bandwidth_Bps"] < 1e15


def test_probed_boot_trains_on_every_rank(ranks):
    want = ranks[0]["probed"]
    assert want["profile"]["source"] == "probe"
    for r in ranks:
        assert r["probed"]["policy"] == want["policy"]
        assert r["probed"]["profile"] == want["profile"]
        assert np.isfinite(r["probed"]["losses"]).all()


@pytest.mark.parametrize("pf", DEPTHS)
def test_live_gathered_buffers_are_the_ledgers(ranks, pf):
    for r in ranks:
        live = r["live"][pf]
        k, p = live["k"], live["probe"]
        assert k == pf
        assert p["fwd"] == p["bwd"] == live["ring"]["layers"] == k + 1, live
        # the first hop's reduces are the ledger's unreduced gradients
        assert p["grads_by_hop"].get(1, 0) == k, live
        assert p["grads_by_hop"].get(2, 0) <= k and p["grads"] <= 2 * k
        assert live["grads_line"] == k * 2 * live["P"]
