"""Port vs reference: the elastic runtime at world 1, in this process
(``repro_torch.train.elastic``, ``repro_torch.testing.faults``).

  (a) the reference's seven fast tests of ``tests/test_elastic.py`` on the
      port: the async writer overlaps and its snapshot is isolated (here
      the live buffers are also changed in place after ``submit``, as the
      next step would), one write in flight (backpressure), an abandoned
      write publishes nothing, the save's retries, retry exhaustion
      sweeping its debris, a stale staging dir swept by the re-save, and a
      crash before the manifest never selectable;
  (b) the reference's ``load_global`` reads the port's async-written
      checkpoint as the state the port submitted;
  (c) the reference's ``Supervisor`` and the port's on
      ``ElasticConfig(mesh=(1, 1), steps=6, ckpt_every=2)`` with a death
      at step 3, both on the CPU and both resuming from the same ``ckpt_0``
      (the port's seeded init, saved by the port: the two seeded inits
      draw different numbers), the first write held in ``post_shard``
      until the death abandons it on both sides (so neither side's writer
      counts hang on a race between the step and the write): the same
      status,
      final step, restarts, fired faults and writer counts; step 0's loss
      within rtol 1e-3 and every loss within rel 2e-2.  Both build the
      default config, which computes in bf16: there the two sides' step 0
      differs by 1.1e-4 relative (before any update, so it is the forward
      alone; at fp32 compute ``test_torch_train.py`` holds it at 1e-5), and
      1e-3 is the repo's bf16 bar for one loss (``test_torch_train_
      multirank.py`` (c)); measured at most 4.4e-4 over the six steps (step
      4).

The multi-rank side is ``test_torch_elastic_multirank.py``; real processes
and real signals are ``test_torch_elastic_signals.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import time                                                  # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.testing import faults as fl                 # noqa: E402
from repro_torch.train import elastic as el                  # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

REF_STEPS, REF_DIE = 6, 3
LOSS0_RTOL, LOSS_REL = 1e-3, 2e-2   # bf16 compute (see (c))


def _tiny_state():
    """gpt-350m reduced at world 1 on the CPU, the seeded init (the
    reference's ``_tiny_state``)."""
    mesh = mesh_lib.make_mesh((1, 1))
    arch = get_config("gpt-350m").reduced()
    model = Model(arch, make_policy(arch, mesh.axes).zcfg, world=1,
                  device="cpu")
    return mesh, model, ts.ZeroState(model, mesh).init(0)


def _host(tree):
    return {k: v.clone() for k, v in tree.items()}


# ---------------------------------------------------------------------------
# (a) the async writer and the save's seams
# ---------------------------------------------------------------------------

def test_async_writer_overlap_and_snapshot_isolation(tmp_path):
    """The write runs on the background thread (the loop's steps count as
    overlapped) and commits the submitted state, though the live buffers
    change in place right after ``submit``."""
    mesh, model, st = _tiny_state()
    want = _host(st.params)
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path),
                                 io_hooks=fl.SlowIO(0.3))
    w.submit(1, st.params, st.opt, {"world": 1})
    for v in st.params.values():       # the next step updates in place
        v.add_(1.0)
    while w.in_flight():
        w.note_step()
        time.sleep(0.02)
    path = w.drain()
    w.close()
    assert w.stats.completed == 1 and w.stats.failed == 0
    assert w.stats.steps_overlapped > 0
    assert len(w.stats.write_s) == 1 and w.stats.write_s[0] >= 0.3
    man = ts.read_manifest(path)
    assert man["step"] == 1 and man["checksums"]
    st2 = ts.ZeroState.restore(model, mesh, str(tmp_path))
    for k, v in st2.params.items():
        assert torch.equal(v, want[k]), k


def test_async_writer_backpressure_single_flight(tmp_path):
    """Never more than one write in flight: a second submit blocks until
    the first (slowed) write commits."""
    mesh, model, st = _tiny_state()
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path),
                                 io_hooks=fl.SlowIO(0.6))
    w.submit(1, st.params, st.opt)
    t0 = time.monotonic()
    w.submit(2, st.params, st.opt)    # must wait out write #1
    assert time.monotonic() - t0 > 0.4
    assert w.stats.submit_s[1] > 0.4  # the stall is what the loop saw
    w.drain()
    w.close()
    assert w.stats.submitted == 2 and w.stats.completed == 2


def test_async_writer_abandon_publishes_nothing(tmp_path):
    """Abandoning an in-flight write (grace expired) cancels it before
    the manifest commit: no checkpoint is ever published."""
    mesh, model, st = _tiny_state()
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path),
                                 io_hooks=fl.SlowIO(1.0))
    w.submit(1, st.params, st.opt)
    assert w.abandon() is True
    w.close()
    assert w.stats.abandoned == 1 and w.stats.completed == 0
    assert w.stats.failed == 0
    assert ts.latest_checkpoint(str(tmp_path)) is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # abandoning while idle is a no-op
    assert w.abandon() is False


class _SlowMembers:
    """io hooks that take 0.2 s between the members of a shard file."""

    def __init__(self):
        self.members, self.shards = 0, 0

    def mid_shard(self, path):
        self.members += 1
        time.sleep(0.2)

    def post_shard(self, path):
        self.shards += 1


def test_abandon_lands_between_the_members_of_a_shard(tmp_path):
    """The writer's cancellation is checked between the members of a shard
    file too (a port addition: the reference checks at the stages), so an
    abandon does not wait for the whole file."""
    mesh, model, st = _tiny_state()
    slow = _SlowMembers()
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path), io_hooks=slow)
    w.submit(1, st.params, st.opt)
    time.sleep(0.3)
    t0 = time.monotonic()
    assert w.abandon() is True
    waited = time.monotonic() - t0
    w.close()
    n = len(ts.flatten_state({"params": st.params, "opt": st.opt}))
    assert w.stats.abandoned == 1 and slow.shards == 0
    assert 1 <= slow.members < n - 1 and waited < 0.5, (slow.members, waited)
    assert os.listdir(tmp_path) == []


def test_save_retries_transient_errors(tmp_path):
    mesh, model, st = _tiny_state()
    flaky = fl.FlakyIO(2)
    path = st.save(str(tmp_path), 1, io_hooks=flaky, retries=3,
                   backoff=0.01)
    assert flaky.calls == 3 and flaky.remaining == 0   # 2 fails + 1 ok
    assert os.path.basename(ts.latest_checkpoint(str(tmp_path))) == "ckpt_1"
    assert ts.read_manifest(path)["checksums"]


def test_save_retry_exhaustion_raises_and_sweeps(tmp_path):
    mesh, model, st = _tiny_state()
    st.save(str(tmp_path), 1)                       # a good one to keep
    with pytest.raises(ts.CheckpointError, match="injected transient"):
        st.save(str(tmp_path), 2, io_hooks=fl.FlakyIO(5), retries=1,
                backoff=0.01)
    # the failed attempt left no debris and the good checkpoint survives
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert os.path.basename(ts.latest_checkpoint(str(tmp_path))) == "ckpt_1"


def test_save_sweeps_stale_staging(tmp_path):
    """A crash-left staging dir for the SAME step must not poison the
    re-save after resume."""
    mesh, model, st = _tiny_state()
    staging = fl.make_stale_staging(str(tmp_path), 5)
    assert os.path.isdir(staging)
    path = st.save(str(tmp_path), 5)
    assert not os.path.isdir(staging)
    assert os.path.basename(ts.latest_checkpoint(str(tmp_path))) == "ckpt_5"
    assert ts.read_manifest(path)["step"] == 5


def test_crash_before_manifest_never_selectable(tmp_path):
    """The commit-protocol invariant from the I/O side: failing between
    the shard write and the manifest commit publishes nothing."""
    mesh, model, st = _tiny_state()
    with pytest.raises(ts.CheckpointError):
        st.save(str(tmp_path), 3, io_hooks=fl.CrashBeforeManifest())
    assert ts.latest_checkpoint(str(tmp_path)) is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


# ---------------------------------------------------------------------------
# (b) interop: the reference reads the port's async checkpoint
# ---------------------------------------------------------------------------

def test_reference_reads_the_async_checkpoint(tmp_path):
    from repro.train import state as rs
    mesh, model, st = _tiny_state()
    want = ts.flatten_state({"params": _host(st.params),
                             "opt": {"m": _host(st.opt["m"]),
                                     "v": _host(st.opt["v"]),
                                     "count": st.opt["count"].clone()}})
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path),
                                 io_hooks=fl.SlowIO(0.1))
    w.submit(4, st.params, st.opt, {"world": 1, "arch": "gpt-350m"})
    for v in st.opt["m"].values():
        v.add_(1.0)
    path = w.drain()
    w.close()
    step, tree, meta = rs.load_global(path)
    assert step == 4 and meta == {"world": 1, "arch": "gpt-350m"}
    got = rs.flatten_state(tree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# (c) the supervisor against the reference's
# ---------------------------------------------------------------------------

class _HeldFirstWrite:
    """io hooks whose first ``post_shard`` returns only once the
    supervisor's writer has been told to abandon that write (both sides'
    writers cancel through ``_cancel``)."""

    def __init__(self):
        self.sup, self.calls = None, 0

    def post_shard(self, path):
        self.calls += 1
        if self.calls == 1:
            writer = self.sup.writer      # the death retires it from sup
            while not writer._cancel.is_set():
                time.sleep(0.005)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """Both supervisors' runs of the same config and fault plan."""
    from repro.testing import faults as rf
    from repro.train import elastic as re_

    def cfg(mod, name, **kw):
        d = tmp_path_factory.mktemp(name)
        st.save(str(d), 0, meta={"world": 1, "arch": "gpt-350m"})
        return mod.ElasticConfig(mesh=(1, 1), steps=REF_STEPS, ckpt_every=2,
                                 ckpt_dir=str(d), log=False, **kw)
    st = _tiny_state()[2]
    out = []
    for mod, faults, name, kw in ((re_, rf, "ref", {}),
                                  (el, fl, "port", {"device": "cpu"})):
        held = _HeldFirstWrite()
        held.sup = mod.Supervisor(cfg(mod, name, **kw),
                                  faults=faults.StepFaults({REF_DIE: "die"}),
                                  io_hooks=held)
        out.append(held.sup.run_supervised())
        assert held.calls == 4        # the held write, then 2, 4 and 6
    return tuple(out)


def test_supervisor_records_match_the_reference(supervised):
    ref, port = supervised
    for key in ("status", "final_step", "restarts", "fired", "resharded"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert port["status"] == "complete" and port["restarts"] == 1
    counts = ("submitted", "completed", "abandoned", "failed", "last_step")
    assert {k: port["writer_stats"][k] for k in counts} == \
        {k: ref["writer_stats"][k] for k in counts}
    # the first attempt's writer lost its in-flight write to the death,
    # and both attempts resumed from ckpt_0
    assert [w["abandoned"] for w in port["writers"]] == [1, 0]
    assert len(port["recover_s"]) == 1 and len(port["restore_s"]) == 2


def test_supervisor_losses_match_the_reference(supervised):
    ref, port = supervised
    assert sorted(port["losses"]) == sorted(ref["losses"]) == \
        list(range(REF_STEPS))
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0],
                               rtol=LOSS0_RTOL)
    rel = [abs(port["losses"][i] - ref["losses"][i]) / abs(ref["losses"][i])
           for i in range(REF_STEPS)]
    print(f"port vs reference, relative: {[f'{r:.2e}' for r in rel]}")
    assert max(rel) < LOSS_REL, rel


def test_replayed_losses_are_the_uninterrupted_runs(tmp_path):
    """The restarted run's losses are an uninterrupted run's, bit for bit
    (batches from the step index, LR from the restored count)."""
    cfg = el.ElasticConfig(mesh=(1, 1), steps=REF_STEPS, log=False,
                           device="cpu")
    oracle = el.Supervisor(cfg).run_supervised()
    died = el.Supervisor(
        el.ElasticConfig(mesh=(1, 1), steps=REF_STEPS, ckpt_every=2,
                         ckpt_dir=str(tmp_path), log=False, device="cpu"),
        faults=fl.StepFaults({5: "die"})).run_supervised()
    assert died["restarts"] == 1 and died["fired"] == [(5, "die")]
    assert died["losses"] == oracle["losses"]
    assert len(died["restore_s"]) == 1     # resumed from a checkpoint


@pytest.mark.parametrize("cur,new,world", [(24, 24, 4), (24, 16, 4),
                                           (24, 32, 4), (20, 32, 8),
                                           (7, 16, 2)])
def test_fit_shard_is_the_shard_of_the_refit_buffer(cur, new, world):
    """``place_global`` cuts each rank's shard straight from the handed
    buffer: the same values as re-fitting the whole buffer first."""
    from repro_torch.core.partition import shard_of
    arr = np.random.default_rng(cur * new).normal(
        size=(3, cur)).astype(np.float32)
    for rank in range(world):
        got = ts.fit_shard(arr, (3, new), rank, world)
        want = shard_of(ts.fit_to(arr, (3, new)), rank, world)
        np.testing.assert_array_equal(got, want)
