"""The port's examples (``examples/torch/``) on the CPU.

  * quickstart on a 1 x 2 world of gloo ranks (``--device cpu``), 2
    steps: finite losses, printed with the entropy bound;
  * serve_decode on qwen3-0.6b reduced at world 1: booted from its INT8
    and fp32 checkpoints (``--from-ckpt``) it serves the tokens it serves
    without one; without ``--device cpu`` it asks for the card and raises;
  * the launcher command lines of train_gpt_zeropp (``--tiny`` or not)
    and of elastic_restart's four phases parse under
    ``repro_torch.launch.train.parser()``.
"""
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as tlaunch

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples" / "torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EX / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(EX / "quickstart.py"),
                        "--device", "cpu", "--mesh", "1x2", "--steps", "2"],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(x) for x in re.findall(r"step \d+: loss (\S+)", r.stdout)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert "on 1x2 ranks (cpu)" in r.stdout
    assert "entropy bound" in r.stdout


def test_serve_decode_from_a_checkpoint_serves_the_same_tokens():
    ex = _load("serve_decode")
    base = ["--device", "cpu", "--mesh", "1x1", "--reduced"]
    plain = ex.main(base)
    assert [len(t) for t in plain] == [8, 8, 8]
    for fmt in ("int8", "fp32"):
        assert ex.main(base + ["--from-ckpt", "--ckpt-format", fmt]) == \
            plain, fmt


def test_examples_ask_for_the_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("serve_decode").main(["--mesh", "1x1", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        _load("quickstart").main(["--mesh", "1x1", "--steps", "1"])


def test_train_and_elastic_examples_parse_under_the_launcher():
    gpt = _load("train_gpt_zeropp")
    for extra in ([], ["--tiny", "--ckpt-format", "int8"]):
        args = gpt.parser().parse_args(extra)
        a = tlaunch.parser().parse_args(gpt.launcher_argv(args))
        assert a.arch == "gpt-100m" and a.mesh == "4x2"
        assert a.device == "cuda" and a.ckpt_every == 50
        assert a.reduced == ("--tiny" in extra)
        assert a.steps == (20 if "--tiny" in extra else 200)
        assert a.ckpt_format == args.ckpt_format
    # importing the example registers nothing (running it does)
    from repro_torch.configs import list_archs
    assert "gpt-100m" not in list_archs() and gpt.GPT_100M.n_layers == 12
    el = _load("elastic_restart")
    runs = [tlaunch.parser().parse_args(argv)
            for _, argv in el.phases("D", "cpu")]
    assert all(a.elastic and a.mesh == "4x2" and a.device == "cpu"
               and a.ckpt_dir == "D" for a in runs)
    assert runs[0].fault_die_at == 6
    assert runs[1].reshard == "14:2x2,17:4x2"
    assert runs[2].fault_preempt_at == 22 and runs[2].fault_slow_write == 1
    assert [a.steps for a in runs] == [12, 20, 26, 26]
