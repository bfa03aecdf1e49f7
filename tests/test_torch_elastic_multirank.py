"""Port vs reference: the elastic runtime on 8 CPU gloo ranks (4 x 2), and
the reference's elastic checks on 8 simulated devices in a subprocess.

The reference's ``ElasticConfig``: gpt-350m reduced, batch 16, seq 64,
lr 3e-3 (warmup-cosine), full ZeRO++.  The supervisor runs in this
process; each segment of a run is one spawn of its world.

  (a) ``check_elastic_async_overlap`` (``checks.py:1292``): every write
      slowed, steps still complete while one is in flight; four snapshots
      submitted and committed, the last manifest (step 8, eight shard
      files) carries checksums.  This is the uninterrupted 9-step run the
      other checks compare with: its writes do not touch training ((c)'s
      run saves nothing and its first three steps are this run's, bit for
      bit);
  (b) ``check_elastic_kill_resume`` (``:1318``): a death at step 5 with a
      checkpoint every 2; one restart from the newest committed
      checkpoint, and every loss of steps 0-7, replays included,
      bit-identical to the uninterrupted run's;
  (c) ``check_elastic_live_reshard`` (``:1339``): 8 -> 4 -> 8 at steps 3
      and 6 with no checkpoint dir; steps 0-2 bit-identical to the fixed
      world's, every loss within rel 2e-2;
  (d) ``check_elastic_corrupt_fallback`` (``:1436``) on (b)'s checkpoints:
      with the two newest damaged (bit-rot, truncation) a run quarantines
      both, in one process, and every rank resumes from the third (its
      step bit-identical to the uninterrupted run's); with every one
      damaged the run starts from the seed;
  (e) ``check_elastic_flaky_io_retry`` (``:1465``): each rank's first two
      shard writes fail, the save retries them together, and every
      snapshot commits;
  (f) the failure-replay half of ``check_obs_telemetry_failure_replay``
      (``:1633``): (b)'s append-mode event log re-emits steps 4-5 yet
      replays to the uninterrupted run's totals, and to its prefix at
      step 4; one ``elastic.restart`` event;
  (g) what one process per rank adds: a write one rank abandons while the
      other drains counts as abandoned on both (the writer's own gloo
      group carries the exchange), and a preempt requested on one rank
      stops every rank at the same step boundary;
  (h) against the reference: its 9-step oracle and its death at step 5,
      both resuming from a ``ckpt_0`` the port writes of its seeded init
      (the two seeded inits draw different numbers): the same restarts,
      fired faults and reshard records, the same ``train.steps`` replay
      totals, step 0's loss within rtol 1e-3 and every loss within rel
      2e-2 (bf16 compute, as ``test_torch_elastic.py`` (c)).

One uninterrupted 9-step run serves (a), (b), (c), (d) and (f): the data
and the LR depend only on the step, so its first 8 losses are an 8-step
run's.  The reference is imported inside the tests only: every spawned
rank imports this module.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as tlaunch
from repro_torch.obs.trace import read_events, replay_counters
from repro_torch.testing import faults as fl
from repro_torch.testing import multirank
from repro_torch.train import elastic as el
from repro_torch.train import state as ts

ROOT = Path(__file__).resolve().parents[1]
STEPS, DIE = 8, 5
LOSS0_RTOL, LOSS_REL = 1e-3, 2e-2      # bf16 compute
REF_TIMEOUT = 400.0

_REF_SNIPPET = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.obs.trace import replay_counters
from repro.testing.faults import StepFaults
from repro.train.elastic import ElasticConfig, Supervisor
R = sys.argv[1]
def run(name, steps, every=0, **kw):
    out = Supervisor(ElasticConfig(steps=steps, log=False, ckpt_every=every,
                                   ckpt_dir=os.path.join(R, name + "_ck"),
                                   metrics_dir=os.path.join(R, name)),
                     **kw).run_supervised()
    return {"losses": {str(k): v for k, v in out["losses"].items()},
            "restarts": out["restarts"], "fired": out["fired"],
            "resharded": out["resharded"], "status": out["status"],
            "replay": replay_counters(os.path.join(R, name,
                                                   "events.jsonl"))}
res = {"oracle": run("oracle", 9),
       "died": run("died", 8, 2, faults=StepFaults({5: "die"}))}
with open(os.path.join(R, "ref.json"), "w") as f:
    json.dump(res, f)
"""


def _cfg(**kw) -> el.ElasticConfig:
    return el.ElasticConfig(device="cpu", log=False, **kw)


def _run(cfg, **kw):
    return el.Supervisor(cfg, **kw).run_supervised()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs, in a subprocess started first: both resume
    from the port's seeded init saved as ``ckpt_0`` (world 1)."""
    d = tmp_path_factory.mktemp("ref")
    built = tlaunch.build_everything("gpt-350m", (1, 1), "zeropp", True, 16,
                                     64, 3e-3, device="cpu")
    st = ts.ZeroState(built.model, built.mesh).init(0)
    for name in ("oracle", "died"):
        st.save(str(d / f"{name}_ck"), 0, meta={"world": 1,
                                                "arch": "gpt-350m"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REF_SNIPPET, str(d)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def oracle(ref, tmp_path_factory):
    """The uninterrupted run, its writes slowed: (result, its event log's
    dir, its checkpoint dir, the SlowIO hooks)."""
    d = tmp_path_factory.mktemp("oracle")
    ck = tmp_path_factory.mktemp("oracle_ck")
    slow = fl.SlowIO(1.0)
    out = _run(_cfg(steps=9, metrics_dir=str(d), ckpt_dir=str(ck),
                    ckpt_every=2), io_hooks=slow)
    return out, d, ck, slow


@pytest.fixture(scope="module")
def died(ref, tmp_path_factory):
    ck = tmp_path_factory.mktemp("died_ck")
    d = tmp_path_factory.mktemp("died")
    out = _run(_cfg(steps=STEPS, ckpt_dir=str(ck), ckpt_every=2,
                    metrics_dir=str(d)), faults=fl.StepFaults({DIE: "die"}))
    return out, ck, d


def test_async_overlap(oracle):
    out, _, ck, slow = oracle
    ws = out["writer_stats"]
    assert out["status"] == "complete" and out["final_step"] == 9
    assert ws["submitted"] == 4 and ws["completed"] == 4, ws
    assert ws["failed"] == 0 and ws["abandoned"] == 0, ws
    assert ws["steps_overlapped"] > 0, ws     # steps ran during writes
    assert slow.calls == 4                    # rank 0's hooks, adopted
    assert any(over for _, _, _, over in out["steps"])
    path = ts.latest_checkpoint(str(ck))
    assert path is not None and os.path.basename(path) == "ckpt_8"
    man = ts.read_manifest(path)
    assert man["step"] == 8 and man["num_processes"] == 8
    assert sorted(man["checksums"]) == [f"shard_{r:05d}.npz"
                                        for r in range(8)]
    assert sorted(os.listdir(path)) == sorted(man["shard_files"]
                                              + [ts.MANIFEST])


def test_kill_resume_bit_identical(oracle, died):
    o, (out, ck, _) = oracle[0], died
    assert out["status"] == "complete" and out["final_step"] == STEPS
    assert out["restarts"] == 1 and out["fired"] == [(DIE, "die")]
    assert len(out["restore_s"]) == 1 and len(out["recover_s"]) == 1
    assert set(out["losses"]) == set(range(STEPS))
    for i in range(STEPS):        # includes the replayed steps: bit-exact
        assert out["losses"][i] == o["losses"][i], \
            (i, out["losses"][i], o["losses"][i])
    assert os.path.basename(ts.latest_checkpoint(str(ck))) == "ckpt_8"
    assert ts.read_manifest(os.path.join(ck, "ckpt_8"))["world"] == 8


def test_live_reshard(oracle, tmp_path, monkeypatch):
    o = oracle[0]
    monkeypatch.chdir(tmp_path)         # nothing may land on disk
    out = _run(_cfg(steps=9), reshard_plan={3: (2, 2), 6: (4, 2)})
    assert os.listdir(tmp_path) == []
    assert out["resharded"] == [(3, 8, 4), (6, 4, 8)], out["resharded"]
    assert len(out["reshard_s"]) == 2
    for i in range(3):                  # same world so far: bit-exact
        assert out["losses"][i] == o["losses"][i], i
    l_ref = np.array([o["losses"][i] for i in range(9)])
    l_new = np.array([out["losses"][i] for i in range(9)])
    rel = np.abs(l_ref - l_new) / np.abs(l_ref)
    assert rel.max() < LOSS_REL, (l_ref, l_new)


def test_corrupt_fallback_quarantines_once(oracle, died, tmp_path, capfd):
    o, (_, ck, _) = oracle[0], died
    d = str(tmp_path / "ck")
    shutil.copytree(ck, d)
    fl.corrupt_shard(os.path.join(d, "ckpt_8"))     # crc catches bit-rot
    fl.truncate_shard(os.path.join(d, "ckpt_6"))    # short read
    capfd.readouterr()
    out = _run(_cfg(steps=5, ckpt_dir=d))
    said = capfd.readouterr().out
    assert said.count("corrupt checkpoint quarantined") == 2, said
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4", "ckpt_6.corrupt",
                                     "ckpt_8.corrupt"]
    assert out["status"] == "complete" and list(out["losses"]) == [4]
    assert out["losses"][4] == o["losses"][4]       # every rank: ckpt_4
    fl.corrupt_shard(os.path.join(d, "ckpt_4"))
    fl.truncate_shard(os.path.join(d, "ckpt_2"))
    out = _run(_cfg(steps=2, ckpt_dir=d, ckpt_every=2))
    assert out["status"] == "complete" and out["restore_s"] == []
    assert out["losses"] == {0: o["losses"][0], 1: o["losses"][1]}
    assert sorted(os.listdir(d)) == [
        "ckpt_2", "ckpt_2.corrupt", "ckpt_4.corrupt", "ckpt_6.corrupt",
        "ckpt_8.corrupt"]


def test_flaky_io_retry(ref, tmp_path):
    flaky = fl.FlakyIO(2)
    out = _run(_cfg(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                    retries=3, backoff=0.01), io_hooks=flaky)
    ws = out["writer_stats"]
    assert out["status"] == "complete"
    assert ws["completed"] == 2 and ws["failed"] == 0, ws
    assert flaky.remaining == 0 and flaky.calls >= 3   # 2 fails + retries
    assert os.path.basename(ts.latest_checkpoint(str(tmp_path))) == "ckpt_4"


def test_failure_replay(oracle, died):
    log_o = os.path.join(oracle[1], "events.jsonl")
    log_i = os.path.join(died[2], "events.jsonl")
    tot_o = replay_counters(log_o, up_to_step=STEPS - 1)
    tot_i = replay_counters(log_i)
    assert tot_o["train.steps"] == STEPS and replay_counters(
        log_o)["train.steps"] == 9
    raw = [r for r in read_events(log_i) if r.get("kind") == "counter"
           and r["name"] == "train.steps"]
    assert len(raw) > STEPS, len(raw)     # steps 4, 5 emitted twice
    for key in ("train.steps", "train.tokens", "train.loss"):
        assert tot_i[key] == tot_o[key], (key, tot_i[key], tot_o[key])
        pre_i = replay_counters(log_i, up_to_step=4)
        pre_o = replay_counters(log_o, up_to_step=4)
        assert pre_i[key] == pre_o[key], (key, pre_i, pre_o)
    evs = [r["name"] for r in read_events(log_i) if r.get("kind") == "event"]
    assert evs.count("elastic.restart") == 1, evs
    assert evs.count("elastic.run_end") == 1 and \
        evs.count("elastic.ckpt.commit") >= 2, evs
    spans = [r for r in read_events(log_o) if r.get("kind") == "span"]
    assert [r["step"] for r in spans if r["name"] == "train.step"] == \
        list(range(9))


def _peer_rank(rank, world, d):
    """A write that rank 1 abandons while rank 0 drains it; then the
    preempt flag, raised on rank 0 alone."""
    built = tlaunch.build_everything("gpt-350m", (1, world), "zeropp", True,
                                     16, 64, 3e-3, device="cpu")
    st = ts.ZeroState(built.model, built.mesh).init(0)
    w = el.AsyncCheckpointWriter(built.model, built.mesh, d,
                                 io_hooks=fl.SlowIO(1.0))
    own = w.group is not None and w.group is not torch.distributed.group.WORLD
    w.submit(2, st.params, st.opt)
    if rank == 1:
        w.abandon()
    else:
        w.drain()
    w.close()
    sup = el.Supervisor(el.ElasticConfig(log=False, device="cpu"))
    quiet = sup._stop_requested(world)
    if rank == 0:
        sup.request_preempt()
    return {"stats": (w.stats.completed, w.stats.abandoned, w.stats.failed),
            "own_group": own, "stop": (quiet, sup._stop_requested(world)),
            "deadline": sup._deadline is not None}


def test_peer_abandon_and_preempt_agreement(ref, tmp_path):
    out = multirank.run(_peer_rank, 2, str(tmp_path))
    assert [r["stats"] for r in out] == [(0, 1, 0)] * 2, out
    assert all(r["own_group"] for r in out)
    assert ts.latest_checkpoint(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []
    assert [r["stop"] for r in out] == [(False, True)] * 2
    # rank 1 learned of the preempt from the all-reduce: its grace runs
    assert [r["deadline"] for r in out] == [False, True]


def test_against_reference(ref, oracle, died):
    proc, d = ref
    text, _ = proc.communicate(timeout=REF_TIMEOUT)
    assert proc.returncode == 0, text[-3000:]
    res = json.loads((d / "ref.json").read_text())
    port = {"oracle": oracle[0], "died": died[0]}
    for name, want in res.items():
        got = port[name]
        assert got["status"] == want["status"] == "complete"
        assert got["restarts"] == want["restarts"], name
        assert [tuple(f) for f in want["fired"]] == got["fired"], name
        assert [tuple(r) for r in want["resharded"]] == got["resharded"]
        run_dir = oracle[1] if name == "oracle" else died[2]
        assert replay_counters(os.path.join(run_dir, "events.jsonl"))[
            "train.steps"] == want["replay"]["train.steps"], name
        losses = {int(k): v for k, v in want["losses"].items()}
        assert sorted(losses) == sorted(got["losses"]), name
        np.testing.assert_allclose(got["losses"][0], losses[0],
                                   rtol=LOSS0_RTOL)
        rel = max(abs(got["losses"][i] - v) / abs(v)
                  for i, v in losses.items())
        assert rel < LOSS_REL, (name, rel)
