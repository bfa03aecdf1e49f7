"""The port stands alone: no JAX, nothing of the reference package.

``repro_torch`` and ``chip_smoke.py`` import torch, numpy and the standard
library only (the card's machine has no JAX), and the entry points run on
the card unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    assert "repro_torch.models.moe" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def _forbidden(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((path.name, node.lineno, n))
    return bad


def test_no_jax_or_reference_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(f.is_file() for f in files)
    bad = [b for f in files for b in _forbidden(f)]
    assert bad == [], bad


def test_entry_points_default_to_cuda():
    """Without ``device="cpu"`` the model, ``build_prefill_step``/``build_decode_step`` and the engine
    ask for the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    from repro_torch.configs import get_config
    from repro_torch.core.zeropp import ZeroConfig
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, steps

    cfg, z = get_config("qwen3-0.6b").reduced(), ZeroConfig(dp_axes=("model",))
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg, z)
    model = Model(cfg, z, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    for build in (lambda: steps.build_prefill_step(model),
                  lambda: steps.build_decode_step(model),
                  lambda: ServeEngine(model, params, n_slots=1, kv_len=16)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    eng = ServeEngine(model, params, n_slots=1, kv_len=16, device="cpu")
    uid = eng.submit(np.arange(3), max_new_tokens=2)
    assert len(eng.run(max_steps=10)[uid]) == 2


def test_engine_refuses_later_slices():
    """``tune=`` boots through the resolver (``self.policy``; an unknown
    mode raises); the paged pool and the speculative drafter construct."""
    from repro_torch.configs import get_config
    from repro_torch.core.zeropp import ZeroConfig
    from repro_torch.models.model import Model
    from repro_torch.serve import PagedKVPool, ServeEngine

    model = Model(get_config("qwen3-0.6b").reduced(),
                  ZeroConfig(dp_axes=("model",)), device="cpu")
    eng = ServeEngine(model, {}, n_slots=1, kv_len=16, device="cpu",
                      tune="static")
    assert eng.policy.mode == "static" and eng.policy.ledger is not None
    assert eng.model.zcfg.prefetch == eng.policy.zcfg.prefetch
    assert ServeEngine(model, {}, n_slots=1, kv_len=16,
                       device="cpu").policy is None
    with pytest.raises(ValueError, match="mode"):
        ServeEngine(model, {}, n_slots=1, kv_len=16, device="cpu",
                    tune="fast")
    for kw in ({"pool": "paged"},
               {"pool": "paged", "draft": (model, {})}):
        eng = ServeEngine(model, {}, n_slots=1, kv_len=16, device="cpu",
                          **kw)
        assert isinstance(eng.pool, PagedKVPool)
        assert (eng.draft_pool is not None) == ("draft" in kw)



def test_sharded_serving_entry_points_default_to_cuda():
    """The paged step and the mesh-taking builders ask for the card
    without ``device="cpu"``; at world 1 (``mesh=None``) the layouts are
    the whole caches (no cut) and a model of another world is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    from repro_torch.configs import get_config
    from repro_torch.core.zeropp import ZeroConfig
    from repro_torch.models.model import Model
    from repro_torch.serve import steps

    cfg, z = get_config("qwen3-0.6b").reduced(), ZeroConfig(dp_axes=("model",))
    model = Model(cfg, z, device="cpu")
    for build in (lambda: steps.build_paged_step(model),
                  lambda: steps.build_decode_step(model, kv_axes=("model",)),
                  lambda: steps.build_prefill_step(model,
                                                   seq_axes=("model",))):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    spec = steps.cache_specs(model, ("data",), ("model",))["blocks"][0]["k"]
    assert spec == (None, ("data",), ("model",), None, None)
    assert steps.paged_cache_specs(model, ("model",))["blocks"][0]["v"] == \
        (None, None, ("model",), None, None)
    assert steps.shard_cut(x, spec[1:], None) is x
    with pytest.raises(ValueError, match="world 2"):
        steps.build_decode_step(Model(cfg, z, world=2, device="cpu"),
                                device="cpu")


def test_elastic_entry_points_default_to_cuda(tmp_path):
    """``ElasticConfig()`` runs on the card: its supervisor (in this
    process at world 1, in spawned ranks at its default 4 x 2) and an
    async writer for a model on the card ask for cuda and raise; the
    launcher's ``--elastic`` keeps ``--device cuda``.  With
    ``device="cpu"`` they run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    import types
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import elastic as el
    from repro_torch.train.state import ZeroState

    cfg = el.ElasticConfig()
    assert cfg.device == "cuda" and cfg.mesh == (4, 2)
    for c in (cfg, el.ElasticConfig(mesh=(1, 1))):
        with pytest.raises(RuntimeError, match="cuda"):
            el.Supervisor(c).run_supervised()
    mesh = mesh_lib.make_mesh((1, 1))
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        el.AsyncCheckpointWriter(on_card, mesh, str(tmp_path))
    args = tlaunch.parser().parse_args(["--elastic"])
    assert args.elastic and args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.run_elastic(tlaunch.parser().parse_args(
            ["--elastic", "--reduced", "--mesh", "1x1", "--steps", "1"]))

    out = el.Supervisor(el.ElasticConfig(mesh=(1, 1), steps=1, device="cpu",
                                         log=False)).run_supervised()
    assert out["status"] == "complete" and list(out["losses"]) == [0]
    model = tlaunch.build_everything("gpt-350m", (1, 1), reduced=True,
                                     device="cpu").model
    st = ZeroState(model, mesh).init(0)
    w = el.AsyncCheckpointWriter(model, mesh, str(tmp_path))
    w.submit(1, st.params, st.opt)
    assert w.drain().endswith("ckpt_1")
    w.close()


def test_tune_imports_no_jax_and_its_flags_default():
    """``repro_torch.tune`` loads neither JAX nor the reference (nor the
    reference's benchmarks); the launcher's ``--tune`` defaults to the
    static preset ("off") and ``--hbm-gb`` to None: the card's memory over
    the ranks that share it."""
    code = ("import sys\n"
            "import repro_torch.tune, repro_torch.tune.ring_model\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
    for f in (PKG / "tune").rglob("*.py"):
        assert _forbidden(f) == [], f
        tree = ast.parse(f.read_text(), str(f))
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)
                                     and n.module]
        assert not [m for m in mods if m.split(".")[0] == "benchmarks"], f
    from repro_torch.launch import train as tlaunch
    from repro_torch.tune.memory import device_budget, HBM_BYTES
    args = tlaunch.parser().parse_args([])
    assert args.tune == "off" and args.hbm_gb is None
    assert tlaunch.parser().parse_args(
        ["--tune", "probe", "--hbm-gb", "12.5"]).hbm_gb == 12.5
    with pytest.raises(SystemExit):
        tlaunch.parser().parse_args(["--tune", "fast"])
    assert device_budget("cpu", 4) == HBM_BYTES // 4


def test_dryrun_and_examples_import_no_jax():
    """``launch.dryrun`` and ``launch.trace_analysis`` load neither JAX nor
    the reference (nor the reference's benchmarks), and the port's four
    examples (``examples/torch/``) import neither; the dry run's output
    defaults under the gitignored ``results/``."""
    code = ("import sys\n"
            "import repro_torch.launch.dryrun\n"
            "import repro_torch.launch.trace_analysis\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert [f.stem for f in examples] == [
        "elastic_restart", "quickstart", "serve_decode", "train_gpt_zeropp"]
    assert [b for f in examples for b in _forbidden(f)] == []
    from repro_torch.launch import dryrun
    out = dryrun.parser().parse_args(["--arch", "qwen3-0.6b"]).out
    assert out.startswith("results/")
