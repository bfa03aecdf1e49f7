"""Training entry point: synthetic data -> ZeRO++ train step -> metrics.

Port of the reference's ``launch/train.build_everything`` and
``train_loop`` on a ``(Y, X)`` ``("data", "model")`` or ``(P, Y, X)``
``("pod", "data", "model")`` world, one process per rank, with periodic
per-shard checkpoints and restart from the latest onto any world (no
elastic supervisor yet).  Runs on the card by default:

    python -m repro_torch.launch.train --arch qwen3-0.6b --batch 8 \\
        --seq 2048 --steps 8 [--variant zeropp] [--attn xla|pallas] \\
        [--mesh YxX|PxYxX] [--prefetch K] [--device cuda|cpu] \\
        [--ckpt-dir D [--ckpt-every N] [--ckpt-format fp32|int8]]

(``--arch``: any name of ``repro_torch.configs.list_archs()``:
deepseek-moe-16b, gemma3-4b, gpt-18b, gpt-350m, mamba2-130m,
musicgen-large, qwen1.5-110b, qwen2-vl-72b, qwen3-0.6b,
qwen3-moe-235b-a22b, recurrentgemma-2b or starcoder2-3b; musicgen-large
and qwen2-vl-72b train on the frontend stub's embeddings, qwen2-vl-72b
with its M-RoPE positions (accum 1 only).  ``--moe-chunks N`` regroups
an MoE config's experts into N chunks, as the reference's flag does.
``--layers N`` cuts the config to its first N layers at full width, e.g.
recurrentgemma-2b at 8 of its 26 (two periods and the rem group), which
is what fits the card at world 1; the reference has no such flag, and
``train_loop`` also takes an ``ArchConfig`` for ``args.arch``.)

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

Checkpoints (the reference's flags; ``train/state.py``): with
``--ckpt-dir D`` the loop restores the latest checkpoint under D (or D
itself, a checkpoint), whatever world wrote it, and continues at its
step (the batches and the LR schedule, driven by the restored
``opt["count"]``, pick up where the saved run stopped); ``--ckpt-every
N`` saves ``D/ckpt_<step>`` after every N-th step, every rank its own
shard file, in ``--ckpt-format`` fp32 (exact) or int8 (blockwise, ~4x
smaller), with meta ``world``, ``arch`` and ``data_cursor``.

Telemetry (the reference's ``--metrics-dir``/``--obs-gate``):
``--metrics-dir D`` records the run's knobs (``tune.*`` gauges), a
``train.step`` span, the ``train.steps``/``train.tokens`` counters and a
``train.step.wall_ms`` histogram, and each step's wire bytes per
collective label — the delta of the ``comm.<label>.bytes`` counters that
``core/collectives.py`` bumps where it issues each collective — and gates
them against ``obs.report.projected_wire_by_label`` (1 %; every rank its
own bytes, the projection is per rank), and the same bytes by
interconnect tier (the ``comm.tier.<tier>.bytes`` counters, which must
sum to the labels' on every rank at every step); rank 0 writes
``D/events.jsonl`` and ``D/BENCH_runtime.json`` (``comm_per_step``,
``comm_per_tier_per_step``).  ``--obs-gate`` makes a failing gate raise.
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
from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.kernels import platform
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import Model
from repro_torch.obs.metrics import (TIER_RANK, Registry, get_registry,
                                     set_registry)
from repro_torch.obs.report import (export_snapshot, projected_wire_by_label,
                                    runtime_gate)
from repro_torch.obs.trace import Tracer, annotate, get_tracer
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.train.policy import VARIANTS, make_policy
from repro_torch.train.state import ZeroState, init_shards
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
                     prefetch: Optional[int] = None, moe_chunks: int = 0,
                     layers: int = 0, **overrides) -> Built:
    """Construct (mesh, arch, model, train step, data) for this rank of a
    ``mesh_shape`` world, for ``arch_name`` (a registered name, or an
    ``ArchConfig`` such as a depth-cut copy of one), ``(Y, X)`` or ``(P, Y, X)`` (a process group of
    that size must exist beyond one rank).  ``batch`` is the global batch
    (rows per microbatch); ``lr_schedule`` is the reference's
    ``warmup_cosine(lr, 10, 10_000)`` or ``constant``; ``attn_impl`` the
    attention route ("pallas": the flash kernels); ``prefetch`` the ring
    depth (None: the policy's); ``moe_chunks`` (> 0) an MoE model's
    expert chunks; ``layers`` (> 0) the depth, the config cut to its
    first ``layers`` layers; ``overrides`` further ``ZeroConfig`` fields
    (the paper's knobs)."""
    arch = arch_name if isinstance(arch_name, ArchConfig) \
        else get_config(arch_name)
    if reduced:
        arch = arch.reduced()
    if moe_chunks:
        arch = dataclasses.replace(arch, expert_chunks=moe_chunks)
    if layers:
        arch = dataclasses.replace(arch, n_layers=layers)
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
    """Step ``step_i``'s batch on ``device``: tokens, targets and M-RoPE
    positions as long, the stub's embeds as float32; with accum > 1 a
    leading microbatch axis (accum, batch/accum, ...) on every leaf, as
    the reference's launcher cuts it (the step refuses accum > 1 for an
    M-RoPE model, whose positions are (3, B, S))."""
    host = make_batch(arch, lm, step_i, batch)
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(v)
        t = t.float() if k == "embeds" else t.long()
        if accum > 1:
            t = t.reshape((accum, -1) + tuple(t.shape[1:]))
        out[k] = t.to(device)
    return out


def _counted(head: str) -> Dict[str, float]:
    """{name: value} of the ``<head><name>.bytes`` counters."""
    return {k[len(head):-len(".bytes")]: v
            for k, v in get_registry().snapshot().items()
            if k.startswith(head) and k.endswith(".bytes")}


def comm_bytes() -> Dict[str, float]:
    """{label: wire bytes counted so far} from the ``comm.<label>.bytes``
    counters."""
    return {k: v for k, v in _counted("comm.").items()
            if not k.startswith("tier.")}


def tier_bytes() -> Dict[str, float]:
    """{tier: wire bytes counted so far} from the ``comm.tier.<tier>.bytes``
    counters, and ``<tier>.other``: the ``other`` label's share of it."""
    return _counted("comm.tier.")


def _since(now: Dict[str, float], sent: Dict[str, float]
           ) -> Dict[str, float]:
    return {k: b - sent.get(k, 0) for k, b in now.items()
            if b != sent.get(k, 0)}


def comm_since(sent: Dict[str, float]) -> Dict[str, float]:
    """The labels' bytes counted since ``sent`` (a :func:`comm_bytes`),
    the labels that sent nothing left out."""
    return _since(comm_bytes(), sent)


def tier_since(sent: Dict[str, float]) -> Dict[str, float]:
    """The tiers' bytes counted since ``sent`` (a :func:`tier_bytes`), as
    :func:`comm_since`."""
    return _since(tier_bytes(), sent)


def tier_total(tiers: Dict[str, float]) -> float:
    """A :func:`tier_since` record's bytes over every tier (``other``'s
    shares are in them already)."""
    return sum(b for k, b in tiers.items() if "." not in k)


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
    """Train to step ``args.steps`` on this rank of an ``args.mesh`` world
    (``overrides``: ``ZeroConfig`` fields, the paper's knobs): from the
    latest checkpoint under ``args.ckpt_dir`` where there is one (its step
    is ``start``), else from a seeded fp32 init (``start`` 0), saving one
    every ``args.ckpt_every`` steps.  Returns the losses of the steps run
    (summed over the world), per-step wall seconds (synchronized), per-step
    kernel launches, each step's wire bytes per collective label on this
    rank (``comm_steps``) and per tier (``tier_steps``: tier ->
    bytes, ``<tier>.other`` the ``other`` label's share), the peak device
    memory (0 on the CPU), the data's entropy bound, the gate report and
    whether every rank counted the same bytes (``gate``/``ranks_agree``,
    None without ``--metrics-dir``), the wall seconds of each save
    (``save_s``), the restored checkpoint's meta (``restored``, None), and
    the built run with this rank's final params/opt.  ``on_step(i,
    metrics)`` is called after each step; only rank 0 prints and writes
    telemetry.  An MoE model's steps also give ``moe_aux`` (its
    load-balance loss per layer, averaged over the world)."""
    built = build_everything(args.arch, mesh_lib.parse_mesh(args.mesh),
                             args.variant, args.reduced, args.batch,
                             args.seq, args.lr, args.accum, args.lr_schedule,
                             args.device, args.attn, args.prefetch,
                             args.moe_chunks, args.layers,
                             **(overrides or {}))
    model = built.model
    z = model.zcfg
    dev = model.device
    rank0 = cl.flat_rank(z.group) == 0
    ckpt_dir = args.ckpt_dir
    st = ZeroState.restore(model, built.mesh, ckpt_dir) if ckpt_dir else None
    if st is None:
        start, restored = 0, None
        params = init_shards(model, args.seed)
        opt = init_opt_state(params)
    else:
        start, restored, params, opt = st.step, st.meta, st.params, st.opt
        if rank0:
            print(f"[train] restored step {start} from {ckpt_dir} (saved "
                  f"world={st.meta.get('world')}, now={model.world})",
                  flush=True)
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
    losses, step_s, launches, comm_steps, tier_steps = [], [], [], [], []
    moe_aux = []
    save_s = []
    try:
        for i in range(start, args.steps):
            batch = device_batch(built.arch, built.lm, i, args.batch,
                                 args.accum, dev)
            sync()
            before = dict(platform.LAUNCHES)
            sent, sent_t = comm_bytes(), tier_bytes()
            t0 = time.perf_counter()
            with annotate("train.step"), tracer.span("train.step", step=i):
                metrics = built.step.fn(params, opt, batch)
                loss = float(metrics["loss"])
                sync()
            step_s.append(time.perf_counter() - t0)
            launches.append({k: platform.LAUNCHES[k] - before[k]
                             for k in before})
            comm_steps.append(comm_since(sent))
            tier_steps.append(tier_since(sent_t))
            losses.append(loss)
            if "moe_aux" in metrics:
                moe_aux.append(float(metrics["moe_aux"]))
            if telemetry:
                record_step(reg, tracer, i, step_s[-1], metrics,
                            comm_steps[-1])
            if on_step is not None:
                on_step(i, metrics)
            if log and (i % args.log_every == 0 or i == args.steps - 1):
                aux = (f" moe_aux {float(metrics['moe_aux']):.4f}"
                       if "moe_aux" in metrics else "")
                print(f"[train] step {i} loss {loss:.4f}{aux} gnorm "
                      f"{float(metrics['grad_norm']):.3f} lr "
                      f"{float(metrics['lr']):.2e} {step_s[-1]:.3f} s "
                      f"{metrics['tokens'] / step_s[-1]:,.0f} tok/s",
                      flush=True)
            if ckpt_dir and args.ckpt_every and \
                    (i + 1) % args.ckpt_every == 0:
                t0 = time.perf_counter()
                ZeroState(model, built.mesh, params, opt, step=i + 1).save(
                    ckpt_dir, meta={"world": model.world,
                                    "arch": built.arch.name,
                                    "data_cursor": i + 1},
                    fmt=args.ckpt_format)
                save_s.append(time.perf_counter() - t0)
        gate = agree = None
        if telemetry and comm_steps:
            gate, agree = _obs_gate(args, built, comm_steps, tier_steps,
                                    rank0, overrides or {})
    finally:
        if telemetry:
            tracer.close()
            set_registry(old_reg)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"losses": losses, "moe_aux": moe_aux, "step_s": step_s,
            "launches": launches,
            "comm_steps": comm_steps, "tier_steps": tier_steps,
            "start": start, "restored": restored, "save_s": save_s,
            "peak_bytes": peak,
            "entropy_bound": built.lm.entropy_bound, "gate": gate,
            "ranks_agree": agree, "built": built, "params": params, "opt": opt}


def _obs_gate(args, built: Built, comm_steps, tier_steps, rank0: bool,
              overrides: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """Gate every step's measured bytes per label against the projection
    (strict under ``--obs-gate``: a failing rank raises), check that the
    ranks agree and that every step's tiers sum to its labels, and on rank
    0 export ``BENCH_runtime.json`` and print the report line (with the
    last step's bytes by tier).  Returns the gate report of the first
    failing step, else of the last, and whether the ranks agree."""
    model, mesh = built.model, built.mesh
    projected = projected_wire_by_label(model, mesh.sizes, accum=args.accum)
    reports = [runtime_gate(measured=c, projected=projected,
                            strict=args.obs_gate) for c in comm_steps]
    gate = next((r for r in reports if not r["ok"]), reports[-1])
    labels = sorted(set(projected).union(*comm_steps))
    agree = _ranks_agree(comm_steps, labels, model.zcfg.group, model.device)
    if args.obs_gate and not agree:
        raise AssertionError("the ranks counted different wire bytes")
    split = [tier_total(t) == sum(c.values())
             for c, t in zip(comm_steps, tier_steps)]
    if not all(split):
        raise AssertionError(f"the tiers' bytes do not sum to the labels' at "
                             f"steps {[i for i, ok in enumerate(split) if not ok]}")
    if rank0:
        export_snapshot(
            os.path.join(args.metrics_dir, "BENCH_runtime.json"),
            extra={"gate": gate, "ranks_agree": agree,
                   "comm_per_step": comm_steps,
                   "comm_per_tier_per_step": tier_steps,
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
              f"{args.metrics_dir}/BENCH_runtime.json); the last step by "
              f"tier: {_tier_line(tier_steps[-1])}", flush=True)
    return gate, agree


def _tier_line(tiers: Dict[str, float]) -> str:
    """A :func:`tier_since` record as MiB a tier (``other``'s share in
    brackets), fastest tier first."""
    names = sorted((k for k in tiers if "." not in k), key=TIER_RANK.get)
    return ", ".join(
        f"{t} {tiers[t] / 2 ** 20:.3f} MiB (other "
        f"{tiers.get(t + '.other', 0):,.0f} B)" for t in names) or "none"


def _rank_loop(rank: int, world: int, args) -> Dict[str, Any]:
    """``train_loop`` in one rank of a spawned world: what a host process
    can receive (the run's params stay in the rank)."""
    out = train_loop(args)
    return {k: out[k] for k in ("losses", "moe_aux", "step_s", "launches",
                                "comm_steps",
                                "tier_steps", "start", "restored", "save_s",
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
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="a registered config (configs.list_archs())")
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
    ap.add_argument("--moe-chunks", type=int, default=0,
                    help="an MoE config's expert chunks (0: the config's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers (0: its "
                         "own depth)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics-dir", default=None,
                    help="enable telemetry: rank 0 writes events.jsonl and "
                         "BENCH_runtime.json here (default: the disabled "
                         "no-op tracer)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the latest checkpoint here (any world) "
                         "and save here with --ckpt-every")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint after every N-th step (0: "
                         "never)")
    ap.add_argument("--ckpt-format", default="fp32", choices=("fp32", "int8"),
                    help="fp32 (exact) or int8 (blockwise, ~4x smaller)")
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
