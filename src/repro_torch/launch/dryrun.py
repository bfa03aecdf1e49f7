"""Dry run: one rank's step of every (arch × shape × mesh) cell, on fake
tensors over a fake world, with its memory, FLOPs, wire bytes by tier and
an H100 roofline.

Counterpart of the reference's ``launch/dryrun.py``.  A cell starts a
``fake`` process group of its mesh's world (no rank process and no
message: torch's ``FakeProcessGroup``), rank 0 the traced rank, builds the
mesh's groups, then builds the model and this rank's state and runs the
real step once under ``FakeTensorMode``, so nothing is allocated even at
qwen1.5-110b: the train step (forward, backward and AdamW,
``train/trainer.build_train_step``) for ``train_*`` shapes, the raw
serving steps (``serve/steps.py`` prefill or decode) for the others.
``launch/trace_analysis.py`` counts what the step does; this module
turns that into one JSON per cell:

  * ``memory``: the liveness peak a rank (params, optimizer state or
    caches included; the port updates them in place, so nothing is
    donated twice), ``fits_hbm`` against the card's 80 GiB, and the HBM
    ledger's bill (``tune/memory.py``) beside it;
  * ``cost``: FLOPs and fusion-blind HBM bytes a rank;
  * ``collectives``: the wire bytes a rank by kind, tier and label, as
    ``core/collectives.py`` counted them at issue;
  * ``roofline``: compute at ``tune/ring_model.PEAK``, memory at the card's
    HBM rate, each tier's bytes at its bandwidth in
    ``tune/profiles/static_h100.json``; the dominant term, the projected
    step and the MFU bound;
  * ``overlap``: the reference's ``analyze_overlap`` dict of the same run
    (``launch/overlap_analysis.py``): which in-loop wire bytes the ring
    schedules under compute, read from the step's issue, wait and compute
    order.

These are projections from stated constants, not measurements.  The
traced tensors are fake tensors on the CPU, so the kernel seam takes each
kernel's plain version (this is analysis, not the main path): the FLOPs
of ``--attn pallas`` are the plain flash versions' for the same function.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        [--multi-pod] [--variant zeropp] [--meshes 32x8,2x32x8] \\
        [--attn xla|pallas] [--accum N] [--serve-bits 8|4] [--out DIR]
    python -m repro_torch.launch.dryrun --all [--arch A] [--shape S]
    python -m repro_torch.launch.dryrun --table [--out DIR]

``--all`` runs the (arch × shape × mesh) matrix, one subprocess a cell,
skipping cells whose JSON exists (resumable); a failed cell leaves
``<cell>.FAILED`` with its output; ``--table`` prints every cell under
``--out`` as a markdown table (its ``overlap`` column the structural
overlap fraction).  The default meshes are a DGX H100
cluster's, 32 × 8 and 2 × 32 × 8 (``launch.mesh.PRODUCTION``);
``--meshes 16x16,2x16x16`` runs the reference's TPU meshes like for like.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ArchConfig, shape_supported
from repro_torch.core import collectives as cl
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.overlap_analysis import summary_line
from repro_torch.launch.trace_analysis import analyze_step, tree_nbytes
from repro_torch.launch.train import micro_cut
from repro_torch.models.model import Model
from repro_torch.obs.metrics import TIER_RANK
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.serve import steps as serve_steps
from repro_torch.train.state import init_shards
from repro_torch.train.trainer import build_train_step, choose_batch_seq_axes
from repro_torch.tune import resolve
from repro_torch.tune.memory import HBM_BYTES, serve_ledger, train_ledger
from repro_torch.tune.probe import STATIC_PROFILE_PATH
from repro_torch.tune.ring_model import PEAK as PEAK_FLOPS

# ---------------------------------------------------------------------------
# hardware model (one H100 SXM5 80GB of a DGX H100 cluster)
# ---------------------------------------------------------------------------

HBM_BW = 3.35e12   # bytes/s: HBM3 of the H100 SXM5 80GB (NVIDIA datasheet)
MESHES = tuple("x".join(map(str, s)) for s in mesh_lib.PRODUCTION.values())


def tier_bandwidths() -> Dict[str, float]:
    """{tier: wire bytes/s a rank} of the static profile (NVLink 4, one NDR
    port a GPU, the cross-pod spine)."""
    with open(STATIC_PROFILE_PATH) as f:
        tiers = json.load(f)["tiers"]
    return {t: float(tiers[t]["bandwidth_Bps"]) for t in TIER_RANK}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(shape: Tuple[int, ...]) -> Iterator[mesh_lib.Mesh]:
    """The mesh of ``shape`` over a ``fake`` process group of its world in
    this process, this process its rank 0 (world 1: no group).  The
    default group is destroyed on the way out, whatever happened."""
    shape = tuple(int(s) for s in shape)
    world = mesh_lib.Mesh(shape).world
    if world == 1:
        yield mesh_lib.make_mesh(shape)
        return
    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own (fake) world: a process "
                           "group is already initialised")
    # registers the "fake" backend (torch's FakeProcessGroup)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    prev = cl.group_axes(None)
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        # each single axis too: a prefill whose rows cover the pod axis
        # alone cuts them over ("pod",)
        yield mesh_lib.make_mesh(shape, axis_groups=True)
    finally:
        dist.destroy_process_group()
        cl.set_world_axes(prev)


def parse_meshes(spec: str) -> Dict[bool, Tuple[int, ...]]:
    """{multi_pod: shape} of a ``--meshes`` list (one two-axis and/or one
    three-axis mesh)."""
    out: Dict[bool, Tuple[int, ...]] = {}
    for part in spec.split(","):
        shape = mesh_lib.parse_mesh(part)
        out[len(shape) == 3] = shape
    return out


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def _batch(arch: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    """A GLOBAL batch of ``B`` × ``S`` (fake under the caller's mode): the
    launcher's dtypes (``launch.train.device_batch``)."""
    out = {}
    if arch.embed_inputs:
        out["embeds"] = torch.empty((B, S, arch.d_model),
                                    dtype=torch.float32)
    else:
        out["tokens"] = torch.zeros((B, S), dtype=torch.long)
    if arch.mrope:
        out["positions"] = torch.zeros((3, B, S), dtype=torch.long)
    return out


def trace_cell(arch: ArchConfig, mesh: mesh_lib.Mesh, kind: str, batch: int,
               seq: int, variant: str = "zeropp", tune: str = "off",
               attn_impl: str = "xla", accum: int = 0, serve_bits: int = 8,
               budget_bytes: int = HBM_BYTES, shape_name: str = "",
               overrides: Optional[Dict[str, Any]] = None
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Trace one step of ``arch`` on ``mesh`` (its process group already
    up): ``kind`` train (global ``batch`` × ``seq``), prefill (the same) or
    decode (``batch`` slots of a ``seq``-long cache, one token each).
    The policy is ``tune.resolve(mode=tune)`` ("off": the preset, the
    reference's choice) with ``overrides`` (``ZeroConfig`` fields; serving
    at ``serve_bits`` 4 adds INT4 qwZ in blocks of 128); ``accum`` 0 takes
    the policy's.  ``shape_name`` picks a decode's layout
    (``serve_shape_policy``).  Returns (the ``analyze_step`` dict, info)."""
    axes, sizes, world = mesh.axes, mesh.sizes, mesh.world
    overrides = dict(overrides or {})
    if kind != "train" and serve_bits == 4:
        overrides.update(qwz_bits=4, qwz_block=128)
    tokens_dev = max(batch * seq // world, 1)
    pol = resolve(arch, axes, variant, mode=tune, mesh=mesh,
                  hbm_budget_bytes=budget_bytes,
                  tokens_per_device=tokens_dev,
                  workload="train" if kind == "train" else "serve",
                  n_slots=batch, kv_len=seq, overrides=overrides,
                  device="cpu")
    info: Dict[str, Any] = {
        "skipped": False, "world": world, "axes": axes, "kind": kind,
        "policy_note": pol.note, "variant": variant, "tune": tune,
        "hpz_axes": pol.zcfg.secondary_axes if pol.zcfg.hpz else None,
        "prefetch": pol.zcfg.prefetch}
    if accum == 0 and kind == "train":
        accum = pol.train_accum
    accum = max(accum, 1)
    info["accum_used"] = accum
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        model = Model(arch, pol.zcfg, world=world, device="cpu")
        info.update(n_params=model.n_params(),
                    n_active=model.n_active_params())
        eff = {"layers": pol.zcfg.effective_prefetch(model.n_periods)}
        if model.is_moe:
            eff["expert_chunks"] = pol.zcfg.effective_prefetch(
                arch.expert_chunks)
        info["prefetch_effective"] = eff
        if kind == "train":
            led = train_ledger(
                model, sizes,
                moments_itemsize=torch.empty(
                    (), dtype=pol.moments_dtype).element_size(),
                tokens_per_device=max(tokens_dev // accum, 1), accum=accum,
                budget_bytes=budget_bytes)
            opt_cfg = AdamWConfig(moments_dtype=pol.moments_dtype)
            params = init_shards(model, 0)
            opt = init_opt_state(params, opt_cfg)
            step = build_train_step(model, opt_cfg, accum=accum,
                                    device="cpu", attn_impl=attn_impl,
                                    global_batch=batch // accum, mesh=mesh)
            data = _batch(arch, batch, seq)
            data["targets"] = torch.zeros((batch, seq), dtype=torch.long)
            data = {k: micro_cut(k, v, accum) for k, v in data.items()}
            info["tokens_per_step"] = batch * seq
            info["state_bytes"] = tree_nbytes((params, opt))
            trace = analyze_step(step.fn, params, opt, data,
                                 state=(params, opt, data))
        else:
            led = serve_ledger(model, sizes, n_slots=batch, kv_len=seq,
                               budget_bytes=budget_bytes)
            params = {k: v.to(torch.bfloat16)
                      for k, v in init_shards(model, 0).items()}
            if kind == "prefill":
                # the reference's layout (rows over every axis but model,
                # the sequence over model) wherever its rows divide; else
                # the rows over the slowest axes they cover
                batch_axes, seq_axes = axes[:-1], axes[-1:]
                if batch % serve_steps.axes_group(mesh, batch_axes)[0]:
                    batch_axes, seq_axes = choose_batch_seq_axes(
                        batch, mesh.shape, axes)
                step = serve_steps.build_prefill_step(
                    model, device="cpu", mesh=mesh, batch_axes=batch_axes,
                    seq_axes=seq_axes)
                data = _batch(arch, batch, seq)
                info["tokens_per_step"] = batch * seq
                info["state_bytes"] = tree_nbytes(params)
                trace = analyze_step(step.fn, params, data,
                                     state=(params, data))
            else:
                batch_axes, kv_axes = serve_steps.serve_shape_policy(
                    shape_name or "decode_32k", axes)
                bw = serve_steps.axes_group(mesh, batch_axes)[0]
                kw = serve_steps.axes_group(mesh, kv_axes)[0]
                caches = model.init_caches(batch // bw, seq, kv_world=kw)
                step = serve_steps.build_decode_step(
                    model, device="cpu", mesh=mesh, batch_axes=batch_axes,
                    kv_axes=kv_axes)
                data = _batch(arch, batch, 1)
                pos = torch.full((batch,), seq - 1, dtype=torch.int32)
                info["tokens_per_step"] = batch
                info["state_bytes"] = tree_nbytes((params, caches))
                trace = analyze_step(step.fn, params, caches, data, pos,
                                     state=(params, caches, data))
    info["ledger"] = led.as_dict()
    return trace, info


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool,
               variant: str = "zeropp", attn_impl: str = "xla",
               accum: int = 0, serve_bits: int = 8,
               meshes: Optional[Dict[bool, Tuple[int, ...]]] = None
               ) -> Tuple[Optional[Dict[str, Any]], Dict[str, Any]]:
    """Trace one cell of the matrix on its production mesh
    (``meshes[multi_pod]``, default ``launch.mesh.PRODUCTION``): (the
    trace, info), or (None, {"skipped": True, "why": ...}) for a shape the
    arch does not run."""
    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_supported(arch, shape_name)
    if not ok:
        return None, {"skipped": True, "why": why}
    mshape = (meshes or mesh_lib.PRODUCTION)[multi_pod]
    t0 = time.perf_counter()
    with fake_world(mshape) as mesh:
        trace, info = trace_cell(
            arch, mesh, shape.kind, shape.global_batch, shape.seq_len,
            variant, attn_impl=attn_impl, accum=accum,
            serve_bits=serve_bits, shape_name=shape_name)
    info["trace_s"] = round(time.perf_counter() - t0, 1)
    info["mesh"] = "x".join(map(str, mshape))
    return trace, info


def analyze(trace: Dict[str, Any], info: Dict[str, Any]) -> Dict[str, Any]:
    """Fold a trace into ``info``: memory, cost, collectives, roofline,
    overlap."""
    world = info["world"]
    peak = int(trace["peak_bytes"])
    mem = {"peak_bytes_per_device": peak,
           "state_bytes": int(info.pop("state_bytes", 0)),
           "fits_hbm": bool(peak <= HBM_BYTES), "hbm_bytes": HBM_BYTES}
    led = info.get("ledger")
    if led:
        mem["ledger_total_bytes"] = int(led["total_bytes"])
        mem["ledger_fits"] = bool(led["fits"])
        mem["ledger_ring_bytes"] = int(sum(
            b for name, b in led["lines"].items() if name.startswith("ring_")))
    info["memory"] = mem
    cost = {"flops": trace["flops"], "bytes_accessed": trace["hbm_bytes"]}
    coll = trace["collectives"]
    info["cost"] = cost
    info["collectives"] = coll
    # the kernels the step calls, each a launch on the card
    info["kernel_calls"] = trace["kernel_calls"]
    info["overlap"] = trace["overlap"]

    bw = tier_bandwidths()
    tier_s = {t: coll["per_tier_wire"][t] / bw[t] for t in TIER_RANK}
    compute_s = cost["flops"] / PEAK_FLOPS
    memory_s = cost["bytes_accessed"] / HBM_BW
    collective_s = sum(tier_s.values())
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "collective_ici_s": tier_s["model"] + tier_s["data"],
             "collective_dci_s": tier_s["pod"],
             **{f"collective_{t}_s": s for t, s in tier_s.items()}}
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    # train: fwd 2ND + bwd 4ND; prefill/decode: fwd only (2ND)
    per_tok = 6.0 if info["kind"] == "train" else 2.0
    model_flops = per_tok * info["n_active"] * info["tokens_per_step"]
    flops_global = cost["flops"] * world
    step_s = max(compute_s, memory_s, collective_s)
    info["roofline"] = {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dominant, "model_flops": model_flops,
        "trace_flops_global": flops_global,
        "useful_flops_ratio":
            model_flops / flops_global if flops_global else 0.0,
        "step_time_s": step_s,
        "mfu_bound": (model_flops / world / PEAK_FLOPS) / max(step_s, 1e-30),
        "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "tier_bw": bw}
    return info


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_one(arch: str, shape: str, multi_pod: bool, variant: str,
            out_dir: Optional[str], attn_impl: str = "xla", accum: int = 0,
            tag: str = "", serve_bits: int = 8,
            meshes: Optional[Dict[bool, Tuple[int, ...]]] = None
            ) -> Dict[str, Any]:
    trace, info = lower_cell(arch, shape, multi_pod, variant,
                             attn_impl=attn_impl, accum=accum,
                             serve_bits=serve_bits, meshes=meshes)
    mshape = (meshes or mesh_lib.PRODUCTION)[multi_pod]
    info.update({"arch": arch, "shape": shape, "attn_impl": attn_impl,
                 "accum": accum, "tag": tag, "variant": variant,
                 "mesh": "x".join(map(str, mshape))})
    if not info.get("skipped"):
        info = analyze(trace, info)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape}__{info['mesh']}__{variant}"
        if tag:
            name += "__" + tag
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(info, f, indent=1, default=str)
    return info


def run_matrix(archs, shapes, meshes, variant: str, out_dir: str,
               timeout: int = 3600) -> None:
    """One subprocess a cell (resumable: a cell whose JSON exists is
    skipped); a failed cell leaves ``<cell>.FAILED``."""
    todo = []
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                tag = f"{arch}__{shape}__{m}__{variant}"
                if os.path.exists(os.path.join(out_dir, tag + ".json")):
                    print(f"SKIP (cached) {tag}")
                    continue
                todo.append((arch, shape, m, tag))
    print(f"{len(todo)} cells to run")
    os.makedirs(out_dir, exist_ok=True)
    for i, (arch, shape, m, tag) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--variant", variant,
               "--out", out_dir, "--meshes", m]
        if len(mesh_lib.parse_mesh(m)) == 3:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout)
            status = "ok" if r.returncode == 0 else f"rc={r.returncode}"
            if r.returncode != 0:
                err = (r.stdout + r.stderr).strip().splitlines()
                with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
                    f.write(r.stdout + r.stderr)
                status += " :: " + (err[-1][:200] if err else "?")
        except subprocess.TimeoutExpired:
            status = "TIMEOUT"
        print(f"[{i + 1}/{len(todo)}] {tag}: {status} "
              f"({time.time() - t0:.0f}s)", flush=True)


def table(out_dir: str) -> str:
    """The markdown table of every cell under ``out_dir``, one row an
    (arch, shape), its meshes side by side (``a / b``, fewest ranks
    first): peak GiB a rank, ``fits_hbm``, the dominant term, the
    projected step, the MFU bound, the structural overlap fraction and the
    trace seconds; a failed cell gives its error, a skipped one its
    reason."""
    cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for f in sorted(os.listdir(out_dir)):
        name, ext = os.path.splitext(f)
        if ext not in (".json", ".FAILED"):
            continue
        arch, shape, mesh, _, *tag = name.split("__")
        shape += "".join(f" ({t})" for t in tag)
        with open(os.path.join(out_dir, f)) as fh:
            if ext == ".json":
                info = json.load(fh)
            else:
                err = [x for x in fh.read().splitlines() if x.strip()][-1]
                info = {"failed": err.split("]: ")[-1]}
        cells.setdefault((arch, shape), {})[mesh] = info

    def col(infos, fn):
        return " / ".join(fn(i) if "memory" in i else "–" for i in infos)

    def peak(i):
        return f"{i['memory']['peak_bytes_per_device'] / 2 ** 30:.2f}"

    def step(i):
        return f"{i['roofline']['step_time_s']:.4g}"

    rows = ["| arch | shape | meshes | peak GiB / rank | fits_hbm | "
            "dominant | step s | mfu_bound | overlap | trace s |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for (arch, shape), by_mesh in sorted(cells.items()):
        meshes = sorted(by_mesh, key=lambda m: mesh_lib.Mesh(
            mesh_lib.parse_mesh(m)).world)
        infos = [by_mesh[m] for m in meshes]
        head = f"| {arch} | {shape} | {' / '.join(meshes)} |"
        bad = [i for i in infos if "failed" in i or i.get("skipped")]
        if len(bad) == len(infos):
            why = bad[0].get("why") or f"failed: `{bad[0]['failed'][:110]}`"
            rows.append(f"{head} {why} | | | | | | |")
            continue
        rows.append(" | ".join([
            head[:-2], col(infos, peak),
            col(infos, lambda i: str(i["memory"]["fits_hbm"])),
            col(infos, lambda i: i["roofline"]["dominant"][:-2]),
            col(infos, step),
            col(infos, lambda i: f"{i['roofline']['mfu_bound']:.3f}"),
            col(infos, lambda i: f"{i['overlap']['overlap_fraction']:.3f}"),
            col(infos, lambda i: str(i["trace_s"]))]) + " |")
    return "\n".join(rows)


def summary(info: Dict[str, Any]) -> str:
    """The CLI's lines for one traced cell."""
    r, m, c = info["roofline"], info["memory"], info["collectives"]
    tiers = ", ".join(f"{t} {b / 2 ** 20:.1f}"
                      for t, b in c["per_tier_wire"].items())
    return "\n".join([
        f"CELL {info['arch']} {info['shape']} mesh={info['mesh']} "
        f"variant={info['variant']}",
        f"  params={info['n_params'] / 1e9:.2f}B "
        f"active={info['n_active'] / 1e9:.2f}B world={info['world']} "
        f"accum={info['accum_used']} trace={info.get('trace_s')}s",
        f"  memory: peak/dev={m['peak_bytes_per_device'] / 2 ** 30:.2f} GiB "
        f"fits_hbm={m['fits_hbm']}; ledger "
        f"{m['ledger_total_bytes'] / 2 ** 30:.2f} GiB (ring "
        f"{m['ledger_ring_bytes'] / 2 ** 30:.2f} GiB) "
        f"fits={m['ledger_fits']}",
        f"  wire MiB a rank by tier: {tiers}",
        f"  roofline: compute={r['compute_s'] * 1e3:.2f}ms "
        f"memory={r['memory_s'] * 1e3:.2f}ms "
        f"collective={r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}",
        f"  useful_flops_ratio={r['useful_flops_ratio']:.3f} "
        f"mfu_bound={r['mfu_bound']:.3f}",
        f"  schedule: prefetch={info['prefetch']} "
        f"effective={info['prefetch_effective']}",
        "  " + summary_line(info["overlap"])])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the three-axis mesh of --meshes")
    ap.add_argument("--variant", default="zeropp",
                    choices=["zeropp", "baseline", "qwz", "hpz", "qgz"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="the (arch x shape x mesh) matrix, one subprocess "
                         "a cell")
    ap.add_argument("--meshes", default=",".join(MESHES),
                    help="YxX and/or PxYxX (default: a DGX H100 cluster's)")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--attn", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--accum", type=int, default=0,
                    help="microbatches (0: the policy's)")
    ap.add_argument("--serve-bits", type=int, default=8, choices=[4, 8])
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the cells under "
                         "--out and exit")
    return ap


def main(argv=None) -> Union[None, Dict[str, Any]]:
    args = parser().parse_args(argv)
    if args.table:
        print(table(args.out))
        return None
    if args.all:
        archs = [args.arch] if args.arch else [
            a for a in list_archs() if not a.startswith("gpt-")]
        shapes = [args.shape] if args.shape else list(SHAPES)
        run_matrix(archs, shapes, args.meshes.split(","), args.variant,
                   args.out, args.timeout)
        return None
    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all)")
    meshes = parse_meshes(args.meshes)
    if args.multi_pod not in meshes:
        raise SystemExit(f"--meshes {args.meshes} has no "
                         f"{'three' if args.multi_pod else 'two'}-axis mesh")
    info = run_one(args.arch, args.shape, args.multi_pod, args.variant,
                   args.out, attn_impl=args.attn, accum=args.accum,
                   tag=args.tag, serve_bits=args.serve_bits, meshes=meshes)
    if info.get("skipped"):
        print(f"SKIP {args.arch} {args.shape}: {info['why']}")
    else:
        print(summary(info))
    return info


if __name__ == "__main__":
    main()
