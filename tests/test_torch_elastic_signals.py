"""The elastic launcher under REAL signals, in real processes:
``python -m repro_torch.launch.train --elastic --device cpu`` on 8 gloo
ranks (4 x 2) of gpt-350m reduced, batch 16, seq 64, lr 3e-3, through
``repro_torch.testing.faults.kill_on_marker``/``run_train``.

  (a) ``check_elastic_crash_during_write`` (``checks.py:1360``): a SIGKILL
      to the launcher in the middle of a slowed async write (its ranks die
      with it) leaves ``ckpt_4.tmp`` with shards and no manifest, so the
      newest checkpoint is still ``ckpt_2``; the relaunch resumes from step
      2, completes, and its re-save of step 4 sweeps the debris;
  (b) ``check_elastic_sigterm_grace`` (``:1395``): a SIGTERM to the
      launcher mid-run reaches every rank (the launcher's event, agreed by
      an all-reduce), which drain the in-flight write, cut a final
      checkpoint at one step and exit 0; the relaunch resumes there; and
      an injected preempt at step 5 (the supervisor in this process) stops
      at step 5 with ``ckpt_5``, from which a second run completes.
"""
import os
import signal

from repro_torch.testing import faults as fl
from repro_torch.train import elastic as el
from repro_torch.train import state as ts


def _args(d, steps, *extra):
    return ["--elastic", "--device", "cpu", "--reduced", "--arch",
            "gpt-350m", "--mesh", "4x2", "--batch", "16", "--seq", "64",
            "--lr", "3e-3", "--steps", str(steps), "--ckpt-dir", d,
            "--ckpt-every", "2", *extra]


def test_crash_during_write(tmp_path):
    d = str(tmp_path)
    rc, lines = fl.kill_on_marker(_args(d, 8, "--fault-slow-write", "5"),
                                  "committed step 2", sig=signal.SIGKILL,
                                  delay=1.5)
    assert rc != 0
    staging = os.path.join(d, "ckpt_4.tmp")
    assert os.path.isdir(staging), os.listdir(d)      # genuine debris
    assert [n for n in os.listdir(staging) if n.startswith("shard_")]
    assert not os.path.exists(os.path.join(staging, ts.MANIFEST))
    latest = ts.latest_checkpoint(d)
    assert latest is not None and os.path.basename(latest) == "ckpt_2", \
        os.listdir(d)

    txt = "\n".join(fl.run_train(_args(d, 8)))
    assert "resumed from step 2" in txt, txt[-2000:]
    assert "status=complete" in txt and "final_step=8" in txt
    assert os.path.basename(ts.latest_checkpoint(d)) == "ckpt_8"
    assert not os.path.isdir(staging)       # re-save swept the stale dir
    assert fl.parse_losses(txt.splitlines()).keys() == set(range(2, 8))


def test_sigterm_grace(tmp_path):
    d = str(tmp_path / "term")
    rc, lines = fl.kill_on_marker(_args(d, 12, "--grace", "30"),
                                  "step 4 loss", sig=signal.SIGTERM)
    txt = "\n".join(lines)
    assert rc == 0, txt[-2000:]
    assert "preemption requested" in txt and "preempted at step" in txt
    assert "status=preempted" in txt
    path = ts.latest_checkpoint(d)
    assert path is not None
    man = ts.read_manifest(path)
    stop = man["step"]
    assert 4 < stop < 12                   # stopped early, but checkpointed
    assert man["meta"]["preempted"] and man["num_processes"] == 8
    txt2 = "\n".join(fl.run_train(_args(d, 12)))
    assert f"resumed from step {stop}" in txt2, txt2[-2000:]
    assert "status=complete" in txt2 and "final_step=12" in txt2

    # injected preempt, the supervisor in this process
    d2 = str(tmp_path / "injected")
    cfg = el.ElasticConfig(steps=12, ckpt_dir=d2, ckpt_every=2,
                           device="cpu", log=False)
    out = el.Supervisor(cfg, faults=fl.StepFaults(
        {5: "preempt"})).run_supervised()
    assert out["status"] == "preempted" and out["final_step"] == 5
    assert out["fired"] == [(5, "preempt")]
    assert os.path.basename(ts.latest_checkpoint(d2)) == "ckpt_5"
    out2 = el.Supervisor(cfg).run_supervised()
    assert out2["status"] == "complete" and out2["final_step"] == 12
    assert min(out2["losses"]) == 5
