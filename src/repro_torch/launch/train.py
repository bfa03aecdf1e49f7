"""Training entry point: synthetic data -> ZeRO++ train step -> metrics.

Port of the reference's ``launch/train.build_everything`` and
``train_loop`` for a one-rank ``("data", "model")`` world (no checkpoints,
no elastic runtime yet).  Runs on the card by default:

    python -m repro_torch.launch.train --arch qwen3-0.6b --batch 8 \\
        --seq 2048 --steps 8 [--variant zeropp] [--attn xla|pallas] \\
        [--device cuda|cpu]

``--device cpu`` runs the plain PyTorch versions of the kernels and is
meant for tests at ``--reduced`` size.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.kernels import platform
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.train.policy import VARIANTS, make_policy
from repro_torch.train.trainer import build_train_step


@dataclasses.dataclass
class Built:
    arch: Any
    model: Model
    step: Any
    lm: SyntheticLM


def build_everything(arch_name: str, variant: str = "zeropp",
                     reduced: bool = False, batch: int = 8, seq: int = 2048,
                     lr: float = 3e-4, accum: int = 1,
                     lr_schedule: str = "warmup_cosine",
                     device="cuda", attn_impl: str = "xla") -> Built:
    """Construct (arch, model, train step, data) for a run.
    ``lr_schedule`` is the reference's ``warmup_cosine(lr, 10, 10_000)`` or
    ``constant``; ``attn_impl`` the attention route ("pallas": the flash
    kernels)."""
    arch = get_config(arch_name)
    if reduced:
        arch = arch.reduced()
    pol = make_policy(arch, ("data", "model"), variant)
    model = Model(arch, pol.zcfg, world=1, device=device)
    if lr_schedule == "warmup_cosine":
        sched = warmup_cosine(lr, 10, 10_000)
    elif lr_schedule == "constant":
        sched = constant(lr)
    else:
        raise ValueError(f"unknown lr schedule {lr_schedule!r}")
    opt_cfg = AdamWConfig(lr=sched)
    step = build_train_step(model, opt_cfg, accum=accum, device=device,
                            attn_impl=attn_impl)
    lm = SyntheticLM(vocab=arch.vocab, seq_len=seq, seed=7)
    return Built(arch, model, step, lm)


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


def train_loop(args, on_step: Optional[Callable] = None) -> Dict[str, Any]:
    """Run ``args.steps`` steps from a seeded fp32 init.  Returns losses,
    per-step wall seconds (synchronized), per-step kernel launches, the
    data's entropy bound, and the built run with its final params/opt.
    ``on_step(i, metrics)`` is called after each step."""
    built = build_everything(args.arch, args.variant, args.reduced,
                             args.batch, args.seq, args.lr, args.accum,
                             args.lr_schedule, args.device, args.attn)
    model = built.model
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init_params(gen, dtype=torch.float32)
    opt = init_opt_state(params)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, step_s, launches = [], [], []
    for i in range(args.steps):
        batch = device_batch(built.arch, built.lm, i, args.batch, args.accum,
                             dev)
        sync()
        before = dict(platform.LAUNCHES)
        t0 = time.perf_counter()
        metrics = built.step.fn(params, opt, batch)
        loss = float(metrics["loss"])
        sync()
        step_s.append(time.perf_counter() - t0)
        launches.append({k: platform.LAUNCHES[k] - before[k]
                         for k in before})
        losses.append(loss)
        if on_step is not None:
            on_step(i, metrics)
        if args.log_every and (i % args.log_every == 0
                               or i == args.steps - 1):
            print(f"[train] step {i} loss {loss:.4f} gnorm "
                  f"{float(metrics['grad_norm']):.3f} lr "
                  f"{float(metrics['lr']):.2e} {step_s[-1]:.3f} s "
                  f"{metrics['tokens'] / step_s[-1]:,.0f} tok/s", flush=True)
    return {"losses": losses, "step_s": step_s, "launches": launches,
            "entropy_bound": built.lm.entropy_bound, "built": built,
            "params": params, "opt": opt}


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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--log-every", type=int, default=1)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = train_loop(args)
    print(f"[train] losses {[round(x, 4) for x in out['losses']]}; entropy "
          f"bound {out['entropy_bound']:.4f}")


if __name__ == "__main__":
    main()
