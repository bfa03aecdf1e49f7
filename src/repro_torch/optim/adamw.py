"""Sharded AdamW: the ZeRO-3 partitioned optimizer.

Port of the reference's ``optim/adamw.py``.  Every optimizer tensor lives
on the primary parameter shard only; gradients arrive as fp32 primary
shards, already summed over the world by qgZ or the reduce-scatter, so
global-norm clipping needs one scalar all-reduce over the ZeRO group.
There is no separate bf16 parameter copy: the fp32 master IS the
parameter buffer, and the forward gather quantizes (qwZ) or casts straight
from it.  ``AdamWConfig.moments_dtype`` is the moments' storage: fp32
(8 B a parameter, the preset below ``LARGE_PARAMS``) or bf16 (4 B, the
large-model preset); the update's arithmetic is fp32 either way, and the
new moments are stored rounded to their dtype (the reference's
``astype``, round to nearest even).

Unlike the reference (immutable arrays), :func:`apply_update` updates the
parameters and moments IN PLACE: at full width it saves a second copy of
the 12 bytes per parameter of master and moments.  A buffer stacked over
layer groups, expert chunks or unembedding chunks is updated one row at
a time (the same elementwise arithmetic), so the update's fp32
temporaries are a row's, not the stack's: 3.5 GB each, not 7 GB, for
qwen2-vl-72b's 2-layer stack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Union

import torch

from repro_torch.core import collectives as cl

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: torch.dtype = torch.float32   # fp32 | bf16 (large models)


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: AdamWConfig = AdamWConfig()) -> Dict:
    """Zero moments in ``cfg.moments_dtype`` beside the fp32 master
    buffers, and a step count."""
    dev = next(iter(params.values())).device
    dt = cfg.moments_dtype
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=dev)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=dev)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_grad_norm(grads: Mapping[str, torch.Tensor],
                     group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every shard, buffers in key order
    (the reference's pytree order); one all-reduce over the ZeRO group
    (the shards are disjoint, so the sum is the global one)."""
    local = sum(torch.sum(grads[k].to(torch.float32) ** 2)
                for k in sorted(grads))
    cl.all_reduce(local, group)
    return torch.sqrt(local)


def apply_update(grads: Mapping[str, torch.Tensor], params: Tensors,
                 opt: Dict, cfg: AdamWConfig, group=None
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step on the primary shards, in place on ``params`` and
    ``opt``.  Returns {"grad_norm", "lr"}."""
    count = opt["count"] + 1
    lr = cfg.lr(count) if callable(cfg.lr) else \
        torch.tensor(cfg.lr, dtype=torch.float32, device=count.device)
    gnorm = global_grad_norm(grads, group)
    if cfg.grad_clip:
        scale = torch.where(gnorm > cfg.grad_clip,
                            cfg.grad_clip / (gnorm + 1e-12), 1.0)
    else:
        scale = torch.tensor(1.0, device=gnorm.device)
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    for k in sorted(grads):
        rows = zip(*(t.reshape(-1, t.shape[-1]).unbind(0) if t.dim() > 1
                     else (t,) for t in (params[k], opt["m"][k],
                                         opt["v"][k], grads[k])))
        for w, m, v, g in rows:
            g = g.to(torch.float32) * scale
            m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
            del g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps) \
                + cfg.weight_decay * w
            w.sub_(lr * step)
            del step
            m.copy_(m32)
            v.copy_(v32)
    opt["count"] = count
    return {"grad_norm": gnorm, "lr": lr}
