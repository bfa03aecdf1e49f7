"""Training entry point: synthetic data -> ZeRO++ train step -> metrics.

Port of the reference's ``launch/train.build_everything`` and
``train_loop`` on a ``(Y, X)`` ``("data", "model")`` or ``(P, Y, X)``
``("pod", "data", "model")`` world, one process per rank (no checkpoints,
no elastic runtime yet).  Runs on the card by default:

    python -m repro_torch.launch.train --arch qwen3-0.6b --batch 8 \\
        --seq 2048 --steps 8 [--variant zeropp] [--attn xla|pallas] \\
        [--mesh YxX|PxYxX] [--prefetch K] [--device cuda|cpu]

(``--arch``: qwen3-0.6b, gpt-350m or gemma3-4b; no flag cuts the depth,
as in the reference: ``train_loop`` takes an ``ArchConfig`` for
``args.arch`` as well as a name.)

``--mesh 1x1`` (the default) trains in this process; a larger mesh spawns
one rank process per position over a gloo group (``launch/mesh.py``; on
the card all of them share device 0).  The paper's ablation knobs
(``qwz_blocked``, ``hpz_axes``, ``qgz_bits``, ``qgz_2hop``) have no flag,
as in the reference: ``build_everything`` and ``train_loop`` take them
as ``ZeroConfig`` overrides.  A ``--batch`` that does not cover the world
shards the sequence over the axes it leaves (``trainer.build_train_step``).
``--prefetch`` is the layer loop's ring depth (default: the policy's, 1;
0 is the synchronous schedule).  ``--device cpu`` runs the plain PyTorch
versions of the kernels and is meant for tests at ``--reduced`` size.

Telemetry (the reference's ``--metrics-dir``/``--obs-gate``):
``--metrics-dir D`` records the run's knobs (``tune.*`` gauges), a
``train.step`` span, the ``train.steps``/``train.tokens`` counters and a
``train.step.wall_ms`` histogram, and each step's wire bytes per
collective label — the delta of the ``comm.<label>.bytes`` counters that
``core/collectives.py`` bumps where it issues each collective — and gates
them against ``obs.report.projected_wire_by_label`` (1 %; every rank its
own bytes, the projection is per rank); rank 0 writes ``D/events.jsonl``
and ``D/BENCH_runtime.json``.  ``--obs-gate`` makes a failing gate raise.
Without ``--metrics-dir`` the tracer is the disabled no-op.  Every step
runs in a ``train.step`` profiler range (``obs.trace.annotate``, free
unless a profiler records), as every collective's issue and wait do.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as cl
from repro_torch.core.partition import shard_of
from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.kernels import platform
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import Model
from repro_torch.obs.metrics import Registry, get_registry, set_registry
from repro_torch.obs.report import (export_snapshot, projected_wire_by_label,
                                    runtime_gate)
from repro_torch.obs.trace import Tracer, annotate, get_tracer
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.train.policy import VARIANTS, make_policy
from repro_torch.train.trainer import build_train_step


@dataclasses.dataclass
class Built:
    mesh: mesh_lib.Mesh
    arch: Any
    model: Model
    step: Any
    lm: SyntheticLM


def build_everything(arch_name: Union[str, ArchConfig],
                     mesh_shape: Tuple[int, ...] = (1, 1),
                     variant: str = "zeropp", reduced: bool = False,
                     batch: int = 8, seq: int = 2048, lr: float = 3e-4,
                     accum: int = 1, lr_schedule: str = "warmup_cosine",
                     device="cuda", attn_impl: str = "xla",
                     prefetch: Optional[int] = None, **overrides) -> Built:
    """Construct (mesh, arch, model, train step, data) for this rank of a
    ``mesh_shape`` world, for ``arch_name`` (a registered name, or an
    ``ArchConfig`` such as a depth-cut copy of one), ``(Y, X)`` or ``(P, Y, X)`` (a process group of
    that size must exist beyond one rank).  ``batch`` is the global batch
    (rows per microbatch); ``lr_schedule`` is the reference's
    ``warmup_cosine(lr, 10, 10_000)`` or ``constant``; ``attn_impl`` the
    attention route ("pallas": the flash kernels); ``prefetch`` the ring
    depth (None: the policy's); ``overrides`` further ``ZeroConfig``
    fields (the paper's knobs)."""
    arch = arch_name if isinstance(arch_name, ArchConfig) \
        else get_config(arch_name)
    if reduced:
        arch = arch.reduced()
    mesh = mesh_lib.make_mesh(mesh_shape, overrides.get("hpz_axes"))
    over = dict(overrides)
    if prefetch is not None:
        over["prefetch"] = prefetch
    pol = make_policy(arch, mesh.axes, variant, mesh=mesh, **over)
    model = Model(arch, pol.zcfg, world=mesh.world, device=device)
    if lr_schedule == "warmup_cosine":
        sched = warmup_cosine(lr, 10, 10_000)
    elif lr_schedule == "constant":
        sched = constant(lr)
    else:
        raise ValueError(f"unknown lr schedule {lr_schedule!r}")
    opt_cfg = AdamWConfig(lr=sched)
    step = build_train_step(model, opt_cfg, accum=accum, device=device,
                            attn_impl=attn_impl, global_batch=batch // accum,
                            mesh=mesh)
    lm = SyntheticLM(vocab=arch.vocab, seq_len=seq, seed=7)
    return Built(mesh, arch, model, step, lm)


def device_batch(arch, lm: SyntheticLM, step_i: int, batch: int,
                 accum: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step_i``'s batch as long tensors on ``device``; with accum >
    1 a leading microbatch axis (accum, batch/accum, S)."""
    host = make_batch(arch, lm, step_i, batch)
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(v).long()
        if accum > 1:
            t = t.reshape((accum, -1) + tuple(t.shape[1:]))
        out[k] = t.to(device)
    return out


def init_shards(model: Model, seed: int) -> Dict[str, torch.Tensor]:
    """This rank's fp32 master shards: the GLOBAL buffers drawn from a
    generator seeded with ``seed`` (so every world starts from the same
    global parameters), then this rank's primary shard of each, cut on
    the trailing axis."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init_params(gen, dtype=torch.float32)
    if model.world == 1:
        return params
    rank = cl.flat_rank(model.zcfg.group)
    return {k: shard_of(v, rank, model.world).clone()
            for k, v in params.items()}


def comm_bytes() -> Dict[str, float]:
    """{label: wire bytes counted so far} from the ``comm.<label>.bytes``
    counters."""
    return {k[len("comm."):-len(".bytes")]: v
            for k, v in get_registry().snapshot().items()
            if k.startswith("comm.") and k.endswith(".bytes")}


def comm_since(sent: Dict[str, float]) -> Dict[str, float]:
    """The labels' bytes counted since ``sent`` (a :func:`comm_bytes`),
    the labels that sent nothing left out."""
    now = comm_bytes()
    return {lbl: b - sent.get(lbl, 0) for lbl, b in now.items()
            if b != sent.get(lbl, 0)}


def _ranks_agree(comm_steps, labels, group, dev) -> bool:
    """Whether every rank of ``group`` counted the same bytes per label at
    every step (one all-gather, counted under ``other``)."""
    if cl.world_size(group) == 1:
        return True
    mine = torch.tensor([[c.get(lbl, 0.0) for lbl in labels]
                         for c in comm_steps], dtype=torch.float64,
                        device=dev).reshape(-1)
    every = cl._gather(mine, group).reshape(-1, mine.shape[0])
    return bool((every == every[0]).all())


def record_step(reg: Registry, tracer: Tracer, i: int, wall_s: float,
                metrics: Dict[str, Any], comm: Dict[str, float]) -> None:
    """What ``--metrics-dir`` records of step ``i``: its wall time in the
    ``train.step.wall_ms`` histogram, the ``train.steps``/``train.tokens``
    counters (in the registry and as replayable tracer records, with each
    label's wire bytes ``comm``), then one flush of the tracer."""
    tokens = float(metrics["tokens"])
    reg.histogram("train.step.wall_ms").observe(wall_s * 1e3)
    reg.counter("train.steps").inc()
    reg.counter("train.tokens").inc(tokens)
    tracer.counter("train.steps", 1, step=i)
    tracer.counter("train.tokens", tokens, step=i)
    for lbl, b in comm.items():
        tracer.counter(f"comm.{lbl}.bytes", b, step=i)
    tracer.flush()


def train_loop(args, on_step: Optional[Callable] = None,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run ``args.steps`` steps from a seeded fp32 init on this rank of an
    ``args.mesh`` world (``overrides``: ``ZeroConfig`` fields, the paper's
    knobs).  Returns the losses (summed over the world),
    per-step wall seconds (synchronized), per-step kernel launches, each
    step's wire bytes per collective label on this rank (``comm_steps``),
    the peak device memory (0 on the CPU), the data's entropy bound, the
    gate report and whether every rank counted the same bytes
    (``gate``/``ranks_agree``, None without ``--metrics-dir``), and the
    built run with this rank's final params/opt.  ``on_step(i, metrics)`` is called after
    each step; only rank 0 prints and writes telemetry."""
    built = build_everything(args.arch, mesh_lib.parse_mesh(args.mesh),
                             args.variant, args.reduced, args.batch,
                             args.seq, args.lr, args.accum, args.lr_schedule,
                             args.device, args.attn, args.prefetch,
                             **(overrides or {}))
    model = built.model
    z = model.zcfg
    dev = model.device
    params = init_shards(model, args.seed)
    opt = init_opt_state(params)
    rank0 = cl.flat_rank(z.group) == 0
    log = args.log_every and rank0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    telemetry = bool(args.metrics_dir)
    old_reg = set_registry(Registry()) if telemetry else None
    reg = get_registry()
    tracer = get_tracer()
    if telemetry and rank0:
        tracer = Tracer(os.path.join(args.metrics_dir, "events.jsonl"))
    if telemetry:
        for knob in ("prefetch", "qwz", "hpz", "qgz", "qwz_block",
                     "qgz_block", "qwz_blocked", "qgz_bits", "qgz_2hop"):
            reg.gauge(f"tune.{knob}").set(int(getattr(z, knob)))
    losses, step_s, launches, comm_steps = [], [], [], []
    try:
        for i in range(args.steps):
            batch = device_batch(built.arch, built.lm, i, args.batch,
                                 args.accum, dev)
            sync()
            before = dict(platform.LAUNCHES)
            sent = comm_bytes()
            t0 = time.perf_counter()
            with annotate("train.step"), tracer.span("train.step", step=i):
                metrics = built.step.fn(params, opt, batch)
                loss = float(metrics["loss"])
                sync()
            step_s.append(time.perf_counter() - t0)
            launches.append({k: platform.LAUNCHES[k] - before[k]
                             for k in before})
            comm_steps.append(comm_since(sent))
            losses.append(loss)
            if telemetry:
                record_step(reg, tracer, i, step_s[-1], metrics,
                            comm_steps[-1])
            if on_step is not None:
                on_step(i, metrics)
            if log and (i % args.log_every == 0 or i == args.steps - 1):
                print(f"[train] step {i} loss {loss:.4f} gnorm "
                      f"{float(metrics['grad_norm']):.3f} lr "
                      f"{float(metrics['lr']):.2e} {step_s[-1]:.3f} s "
                      f"{metrics['tokens'] / step_s[-1]:,.0f} tok/s",
                      flush=True)
        gate = agree = None
        if telemetry:
            gate, agree = _obs_gate(args, built, comm_steps, rank0,
                                    overrides or {})
    finally:
        if telemetry:
            tracer.close()
            set_registry(old_reg)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"losses": losses, "step_s": step_s, "launches": launches,
            "comm_steps": comm_steps, "peak_bytes": peak,
            "entropy_bound": built.lm.entropy_bound, "gate": gate,
            "ranks_agree": agree, "built": built, "params": params, "opt": opt}


def _obs_gate(args, built: Built, comm_steps, rank0: bool,
              overrides: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """Gate every step's measured bytes per label against the projection
    (strict under ``--obs-gate``: a failing rank raises), check that the
    ranks agree, and on rank 0 export ``BENCH_runtime.json``.  Returns the
    gate report of the first failing step, else of the last, and whether
    the ranks agree."""
    model, mesh = built.model, built.mesh
    projected = projected_wire_by_label(model, mesh.sizes, accum=args.accum)
    reports = [runtime_gate(measured=c, projected=projected,
                            strict=args.obs_gate) for c in comm_steps]
    gate = next((r for r in reports if not r["ok"]), reports[-1])
    labels = sorted(set(projected).union(*comm_steps))
    agree = _ranks_agree(comm_steps, labels, model.zcfg.group, model.device)
    if args.obs_gate and not agree:
        raise AssertionError("the ranks counted different wire bytes")
    if rank0:
        export_snapshot(
            os.path.join(args.metrics_dir, "BENCH_runtime.json"),
            extra={"gate": gate, "ranks_agree": agree,
                   "comm_per_step": comm_steps,
                   "config": {"arch": built.arch.name,
                              "variant": args.variant,
                              "overrides": {k: repr(v) for k, v in
                                            overrides.items()},
                              "mesh": list(mesh.shape),
                              "prefetch": model.zcfg.prefetch,
                              "steps": args.steps, "batch": args.batch,
                              "seq": args.seq, "accum": args.accum,
                              "attn": args.attn, "device": args.device}})
        print(f"[train] obs gate {'PASS' if gate['ok'] else 'FAIL'} on "
              f"every step, ranks {'agree' if agree else 'DISAGREE'}: "
              f"labels {labels} vs the analytic projection (BENCH -> "
              f"{args.metrics_dir}/BENCH_runtime.json)", flush=True)
    return gate, agree


def _rank_loop(rank: int, world: int, args) -> Dict[str, Any]:
    """``train_loop`` in one rank of a spawned world: what a host process
    can receive (the run's params stay in the rank)."""
    out = train_loop(args)
    return {k: out[k] for k in ("losses", "step_s", "launches", "comm_steps",
                                "peak_bytes", "entropy_bound", "gate",
                                "ranks_agree")}


def run(args):
    """``train_loop(args)`` on a world of one; beyond, one spawned rank
    process per mesh position.  Returns rank 0's result and, at world >
    1, every rank's as ``ranks``."""
    world = mesh_lib.Mesh(mesh_lib.parse_mesh(args.mesh)).world
    if world == 1:
        return train_loop(args)
    ranks = mesh_lib.spawn(_rank_loop, world, args, device=args.device,
                           timeout=None)
    return dict(ranks[0], ranks=ranks)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--variant", default="zeropp", choices=VARIANTS)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny test shape (CPU runs)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-schedule", default="warmup_cosine",
                    choices=("warmup_cosine", "constant"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--attn", default="xla", choices=("xla", "pallas"),
                    help="attention route: plain, or the flash kernels")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1",
                    help="YxX world: Y 'data' rows of X 'model' ranks, or "
                         "PxYxX: P 'pod's of those; one process a rank "
                         "(gloo)")
    ap.add_argument("--prefetch", type=int, default=None,
                    help="layer-loop ring depth (default: the policy's, 1; "
                         "0: synchronous)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics-dir", default=None,
                    help="enable telemetry: rank 0 writes events.jsonl and "
                         "BENCH_runtime.json here (default: the disabled "
                         "no-op tracer)")
    ap.add_argument("--obs-gate", action="store_true",
                    help="raise when a step's wire bytes per label miss "
                         "the analytic projection by more than 1%% (with "
                         "--metrics-dir)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = run(args)
    print(f"[train] losses {[round(x, 4) for x in out['losses']]}; entropy "
          f"bound {out['entropy_bound']:.4f}")
    if len(out["step_s"]) > 1:
        p50 = statistics.median(out["step_s"][1:])
        print(f"[train] rank 0: step p50 (steps 2-{len(out['step_s'])}) "
              f"{p50 * 1e3:.1f} ms, peak memory "
              f"{out['peak_bytes'] / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    main()
