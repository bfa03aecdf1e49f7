"""Training entry point: synthetic data -> ZeRO++ train step -> metrics.

Port of the reference's ``launch/train.build_everything`` and
``train_loop`` on a ``(Y, X)`` ``("data", "model")`` or ``(P, Y, X)``
``("pod", "data", "model")`` world, one process per rank, with periodic
per-shard checkpoints and restart from the latest onto any world, and of
its ``run_elastic`` (``--elastic``: the supervisor of
``train/elastic.py``).  Runs on the card by default:

    python -m repro_torch.launch.train --arch qwen3-0.6b --batch 8 \\
        --seq 2048 --steps 8 [--variant zeropp] [--attn xla|pallas] \\
        [--mesh YxX|PxYxX] [--prefetch K] [--device cuda|cpu] \\
        [--ckpt-dir D [--ckpt-every N] [--ckpt-format fp32|int8]]

(``--arch``: any name of ``repro_torch.configs.list_archs()``:
deepseek-moe-16b, gemma3-4b, gpt-18b, gpt-350m, mamba2-130m,
musicgen-large, qwen1.5-110b, qwen2-vl-72b, qwen3-0.6b,
qwen3-moe-235b-a22b, recurrentgemma-2b or starcoder2-3b; musicgen-large
and qwen2-vl-72b train on the frontend stub's embeddings, qwen2-vl-72b
with its M-RoPE positions (under ``--accum N`` cut (N, 3, B/N, S)).  ``--moe-chunks N`` regroups
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

Restarts (the reference's ``--simulate-failure-at``/``--max-restarts``):
the loop fails at the given step and the launcher starts it again, up to
``--max-restarts`` times, from the latest checkpoint under ``--ckpt-dir``
(from the seed without one).

Elastic (the reference's flags): ``--elastic`` runs the step loop under
``train/elastic.Supervisor``: async background checkpoints every
``--ckpt-every`` steps (``--sync-ckpt``: blocking ones; ``--ckpt-retries``
and ``--ckpt-backoff`` retry a failed write), restart from the newest
committed checkpoint after a worker death, a SIGTERM drained within
``--grace`` seconds into a final checkpoint, and live resharding onto
other worlds (``--reshard "3:2x2,6:4x2"``: at step 3 onto 2 x 2, at 6
onto 4 x 2; the state moves through host memory).  Beyond world 1 the
supervisor stays in this process and each segment of the run is one
spawn of its world.  ``--fault-die-at``, ``--fault-preempt-at``,
``--fault-slow-write S`` and ``--fault-flaky-writes N`` inject the
failures of ``testing/faults.py``.  It takes the reference's knobs
(arch, depth, world, batch, lr, checkpoints, ``--attn``, ``--device``)
and its warmup-cosine schedule; e.g. on the CPU:

    python -m repro_torch.launch.train --device cpu --reduced \
        --arch gpt-350m --mesh 4x2 --batch 16 --seq 64 --lr 3e-3 \
        --elastic --ckpt-dir D --ckpt-every 2 --fault-die-at 5

Boot-time tuning (the reference's ``--tune``/``--hbm-gb``): ``--tune
static`` resolves the policy (hpZ placement, qwZ/qgZ blocks, the ring
depth, the moments' dtype) through ``repro_torch.tune.resolve`` from the
committed DGX H100 profile, ``--tune probe`` from collectives timed on
the live world at boot; the HBM ledger walks the ring depth down into
``--hbm-gb`` GiB a rank (default: the card's memory over the ranks that
share it).  Rank 0 prints the policy's ``explain()``.

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
from repro_torch.tune import GB, MODES as TUNE_MODES, resolve
from repro_torch.tune.memory import device_budget


@dataclasses.dataclass
class Built:
    mesh: mesh_lib.Mesh
    arch: Any
    model: Model
    step: Any
    lm: SyntheticLM
    opt_cfg: AdamWConfig = AdamWConfig()
    policy: Any = None      # train.policy.Policy (tune off) or ResolvedPolicy


def resolve_arch(arch_name: Union[str, ArchConfig], reduced: bool = False,
                 moe_chunks: int = 0, layers: int = 0) -> ArchConfig:
    """The config a run trains: ``arch_name`` (a registered name or an
    ``ArchConfig``), reduced, regrouped into ``moe_chunks`` expert chunks
    and cut to its first ``layers`` layers where asked."""
    arch = arch_name if isinstance(arch_name, ArchConfig) \
        else get_config(arch_name)
    if reduced:
        arch = arch.reduced()
    if moe_chunks:
        arch = dataclasses.replace(arch, expert_chunks=moe_chunks)
    if layers:
        arch = dataclasses.replace(arch, n_layers=layers)
    return arch


def build_everything(arch_name: Union[str, ArchConfig],
                     mesh_shape: Tuple[int, ...] = (1, 1),
                     variant: str = "zeropp", reduced: bool = False,
                     batch: int = 8, seq: int = 2048, lr: float = 3e-4,
                     accum: int = 1, lr_schedule: str = "warmup_cosine",
                     device="cuda", attn_impl: str = "xla",
                     prefetch: Optional[int] = None, moe_chunks: int = 0,
                     layers: int = 0, tune: str = "off",
                     hbm_gb: Optional[float] = None, **overrides) -> Built:
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
    (the paper's knobs).  ``tune``: "off" keeps the static preset
    (``train/policy.make_policy``); "static" and "probe" resolve the
    policy through ``repro_torch.tune.resolve`` (the committed profile, or
    a probe of the live world's collectives), with the HBM ledger charged
    against ``hbm_gb`` GiB a rank (None: the card's memory over the ranks
    sharing it, ``tune.memory.device_budget``) and ``batch·seq // world``
    tokens a rank.  The AdamW moments take the policy's dtype."""
    arch = resolve_arch(arch_name, reduced, moe_chunks, layers)
    over = dict(overrides)
    if prefetch is not None:
        over["prefetch"] = prefetch
    # the mesh holds every group the policy can use (a suffix of the axes
    # is one pod: the large-model hpZ group) and, for the probe, each axis
    mesh = mesh_lib.make_mesh(mesh_shape, overrides.get("hpz_axes"),
                              axis_groups=tune == "probe")
    if tune and tune != "off":
        world = mesh.world
        budget = (int(hbm_gb * GB) if hbm_gb is not None
                  else device_budget(device, world))
        pol = resolve(arch, mesh.axes, variant, mode=tune, mesh=mesh,
                      hbm_budget_bytes=budget,
                      tokens_per_device=max(batch * seq // world, 1),
                      overrides=over, device=device)
    else:
        pol = make_policy(arch, mesh.axes, variant, mesh=mesh, **over)
    model = Model(arch, pol.zcfg, world=mesh.world, device=device)
    if lr_schedule == "warmup_cosine":
        sched = warmup_cosine(lr, 10, 10_000)
    elif lr_schedule == "constant":
        sched = constant(lr)
    else:
        raise ValueError(f"unknown lr schedule {lr_schedule!r}")
    opt_cfg = AdamWConfig(lr=sched, moments_dtype=pol.moments_dtype)
    step = build_train_step(model, opt_cfg, accum=accum, device=device,
                            attn_impl=attn_impl, global_batch=batch // accum,
                            mesh=mesh)
    lm = SyntheticLM(vocab=arch.vocab, seq_len=seq, seed=7)
    return Built(mesh, arch, model, step, lm, opt_cfg, pol)


def device_batch(arch, lm: SyntheticLM, step_i: int, batch: int,
                 accum: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step_i``'s batch on ``device``: tokens, targets and M-RoPE
    positions as long, the stub's embeds as float32; with accum > 1 a
    leading microbatch axis on every leaf, microbatch i the rows [i·b,
    (i+1)·b) of b = batch/accum: (accum, b, ...), and M-RoPE positions
    (3, B, S) cut on their rows into (accum, 3, b, S), as the reference's
    trainer and dry run take them."""
    host = make_batch(arch, lm, step_i, batch)
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(v)
        t = t.float() if k == "embeds" else t.long()
        out[k] = micro_cut(k, t, accum).to(device)
    return out


def micro_cut(key: str, t: torch.Tensor, accum: int) -> torch.Tensor:
    """Batch leaf ``key`` cut into ``accum`` microbatches of consecutive
    rows on a new leading axis: (B, ...) -> (accum, B/accum, ...), and
    M-RoPE ``positions`` (3, B, S) -> (accum, 3, B/accum, S).  accum 1
    leaves it as it is."""
    if accum <= 1:
        return t
    if key == "positions":
        return t.reshape((t.shape[0], accum, -1) + tuple(t.shape[2:])
                         ).movedim(1, 0).contiguous()
    return t.reshape((accum, -1) + tuple(t.shape[1:]))


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


@dataclasses.dataclass
class StepRecord:
    """One timed training step: its loss (summed over the world) and
    metrics, wall seconds (synchronized), kernel launches, and this rank's
    wire bytes per collective label (``comm``) and per tier (``tiers``)."""
    loss: float
    metrics: Dict[str, Any]
    wall_s: float
    launches: Dict[str, int]
    comm: Dict[str, float]
    tiers: Dict[str, float]


def run_step(built: Built, params, opt, i: int, batch: int, accum: int,
             tracer: Tracer) -> StepRecord:
    """Step ``i`` of a run, in place on (``params``, ``opt``): its batch
    (``device_batch``), then the step in a ``train.step`` profiler range
    and tracer span, timed from a synchronized start to a synchronized
    end; the launches and the wire bytes are the counters' deltas."""
    dev = built.model.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data = device_batch(built.arch, built.lm, i, batch, accum, dev)
    sync()
    before = dict(platform.LAUNCHES)
    sent, sent_t = comm_bytes(), tier_bytes()
    t0 = time.perf_counter()
    with annotate("train.step"), tracer.span("train.step", step=i):
        metrics = built.step.fn(params, opt, data)
        loss = float(metrics["loss"])
        sync()
    wall = time.perf_counter() - t0
    return StepRecord(loss, metrics, wall,
                      {k: platform.LAUNCHES[k] - before[k] for k in before},
                      comm_since(sent), tier_since(sent_t))


class SimulatedFailure(RuntimeError):
    """``--simulate-failure-at``: the loop's injected node failure, which
    the launcher's restart loop answers by starting again from the latest
    checkpoint (``--max-restarts``)."""


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
                             tune=args.tune, hbm_gb=args.hbm_gb,
                             **(overrides or {}))
    model = built.model
    z = model.zcfg
    dev = model.device
    rank0 = cl.flat_rank(z.group) == 0
    if args.tune != "off" and rank0:
        print(f"[tune] {built.policy.explain()}", flush=True)
    ckpt_dir = args.ckpt_dir
    md = built.opt_cfg.moments_dtype
    st = ZeroState.restore(model, built.mesh, ckpt_dir, moments_dtype=md) \
        if ckpt_dir else None
    if st is None:
        start, restored = 0, None
        params = init_shards(model, args.seed)
        opt = init_opt_state(params, built.opt_cfg)
    else:
        start, restored, params, opt = st.step, st.meta, st.params, st.opt
        if rank0:
            print(f"[train] restored step {start} from {ckpt_dir} (saved "
                  f"world={st.meta.get('world')}, now={model.world})",
                  flush=True)
    log = args.log_every and rank0
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
        reg.gauge("tune.mode").set(TUNE_MODES.index(args.tune))
    losses, step_s, launches, comm_steps, tier_steps = [], [], [], [], []
    moe_aux = []
    save_s = []
    try:
        for i in range(start, args.steps):
            if args.simulate_failure_at is not None \
                    and i == args.simulate_failure_at:
                raise SimulatedFailure(f"simulated node failure at step {i}")
            rec = run_step(built, params, opt, i, args.batch, args.accum,
                           tracer)
            metrics, loss = rec.metrics, rec.loss
            step_s.append(rec.wall_s)
            launches.append(rec.launches)
            comm_steps.append(rec.comm)
            tier_steps.append(rec.tiers)
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
                ZeroState(model, built.mesh, params, opt, step=i + 1,
                          moments_dtype=md).save(
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
    can receive (the run's params stay in the rank), or the message of a
    simulated failure (every rank fails at the same step)."""
    try:
        out = train_loop(args)
    except SimulatedFailure as e:
        return {"failure": str(e)}
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
    if "failure" in ranks[0]:
        raise SimulatedFailure(ranks[0]["failure"])
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
    ap.add_argument("--tune", default="off", choices=TUNE_MODES,
                    help="policy resolution (repro_torch.tune): off = the "
                         "static preset; static = the committed H100 "
                         "profile; probe = time real collectives on the "
                         "live world at boot")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-rank HBM budget in GiB the tune ledger "
                         "charges the (k+1) ring buffers against (default: "
                         "the card's memory over the ranks sharing it)")
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
    ap.add_argument("--simulate-failure-at", type=int, default=None,
                    help="fail the run at this step (the restart loop then "
                         "starts again from the latest checkpoint)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="restarts after a failure before giving up")
    # the elastic supervisor (train/elastic.py) and its fault injection
    ap.add_argument("--elastic", action="store_true",
                    help="run under the elastic supervisor: async "
                         "checkpoints, SIGTERM grace drain, restart on "
                         "worker death, live resharding")
    ap.add_argument("--sync-ckpt", action="store_true",
                    help="elastic mode: blocking in-loop saves instead of "
                         "the async background writer")
    ap.add_argument("--grace", type=float, default=30.0,
                    help="seconds between preemption signal and exit")
    ap.add_argument("--ckpt-retries", type=int, default=0)
    ap.add_argument("--ckpt-backoff", type=float, default=0.05)
    ap.add_argument("--reshard", default=None,
                    help="live reshard plan, e.g. '3:2x2,6:4x2'")
    ap.add_argument("--fault-die-at", type=int, default=None,
                    help="inject a worker death at this step")
    ap.add_argument("--fault-preempt-at", type=int, default=None,
                    help="inject a graceful preemption at this step")
    ap.add_argument("--fault-slow-write", type=float, default=None,
                    help="sleep this long inside every shard write")
    ap.add_argument("--fault-flaky-writes", type=int, default=None,
                    help="fail the first N shard writes with OSError")
    return ap


def run_elastic(args) -> Dict[str, Any]:
    """Drive one run under the elastic supervisor (``train/elastic.py``),
    translating the fault and reshard flags into the injection harness
    (``testing/faults.py``, imported only when a fault flag is given)."""
    from repro_torch.train.elastic import ElasticConfig, Supervisor

    plan = {}
    if args.fault_die_at is not None:
        plan[args.fault_die_at] = "die"
    if args.fault_preempt_at is not None:
        plan[args.fault_preempt_at] = "preempt"
    hooks = []
    faults = io_hooks = None
    if plan or args.fault_slow_write or args.fault_flaky_writes:
        from repro_torch.testing import faults as fl
        faults = fl.StepFaults(plan) if plan else None
        if args.fault_slow_write:
            hooks.append(fl.SlowIO(args.fault_slow_write))
        if args.fault_flaky_writes:
            hooks.append(fl.FlakyIO(args.fault_flaky_writes))
        if hooks:
            io_hooks = hooks[0] if len(hooks) == 1 else fl.ChainedHooks(hooks)
    reshard_plan = None
    if args.reshard:
        reshard_plan = {}
        for part in args.reshard.split(","):
            step_s, shape_s = part.split(":")
            reshard_plan[int(step_s)] = mesh_lib.parse_mesh(shape_s)
    arch = args.arch
    if args.layers:
        arch = dataclasses.replace(get_config(arch), n_layers=args.layers)
    cfg = ElasticConfig(
        arch=arch, reduced=args.reduced, mesh=mesh_lib.parse_mesh(args.mesh),
        variant=args.variant, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, accum=args.accum, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        ckpt_format=args.ckpt_format, async_ckpt=not args.sync_ckpt,
        retries=args.ckpt_retries, backoff=args.ckpt_backoff,
        grace=args.grace, max_restarts=args.max_restarts,
        metrics_dir=args.metrics_dir, device=args.device, attn=args.attn)
    sup = Supervisor(cfg, faults=faults, reshard_plan=reshard_plan,
                     io_hooks=io_hooks)
    sup.install_signal_handlers()
    out = sup.run_supervised()
    last = out["losses"].get(out["final_step"] - 1)
    print(f"[elastic] done: status={out['status']} "
          f"final_step={out['final_step']} restarts={out['restarts']} "
          f"resharded={out['resharded']} "
          f"last_loss={last if last is None else f'{last:.4f}'}",
          flush=True)
    return out


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.elastic:
        run_elastic(args)
        return
    # the launcher's restart loop: start again from the latest checkpoint
    restarts = 0
    while True:
        try:
            out = run(args)
            break
        except SimulatedFailure as e:
            if restarts >= args.max_restarts:
                raise
            restarts += 1
            args.simulate_failure_at = None
            print(f"[train] {e} -> restarting from checkpoint "
                  f"({restarts}/{args.max_restarts})", flush=True)
    print(f"[train] losses {[round(x, 4) for x in out['losses']]}; entropy "
          f"bound {out['entropy_bound']:.4f}; restarts {restarts}")
    if len(out["step_s"]) > 1:
        p50 = statistics.median(out["step_s"][1:])
        print(f"[train] rank 0: step p50 (steps 2-{len(out['step_s'])}) "
              f"{p50 * 1e3:.1f} ms, peak memory "
              f"{out['peak_bytes'] / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    main()
