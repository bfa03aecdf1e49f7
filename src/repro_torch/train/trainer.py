"""The ZeRO++ training step around the Model.

Port of the reference's ``train/trainer.build_train_step``.  The reference
jits one ``shard_map`` over the mesh around loss, backward and optimizer;
here the step runs eagerly on the model's device, and every ZeRO++
collective (qwZ gathers, hpZ secondary gathers, qgZ reduce) happens inside
the model's ``zero_apply`` groups, per layer group, exactly where the
reference issues it.  The step is split in two so that tests can read the
gradients: :func:`TrainStep.loss_and_grads` (forward and backward, with
gradient accumulation over ``accum`` microbatches) and the AdamW update.

Training runs on a one-rank ``("data", "model")`` world for now: the
collectives are held at 4 gloo ranks by the tests, but the multi-rank
step (one process per rank, each on its own card) is ROADMAP Queue A
item 7's remainder, and :func:`build_train_step` raises at world > 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.kernels import platform
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunSpec
from repro_torch.optim.adamw import AdamWConfig, apply_update

Tensors = Dict[str, torch.Tensor]
_ROWS = ("blocks", "unemb")    # buffers stacked over layer groups / chunks


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """A built train step.  ``fn(params, opt, batch) -> metrics`` updates
    ``params`` and ``opt`` in place; ``loss_and_grads(params, batch) ->
    (loss, {"nll_sum", "tokens"}, grads)`` is its first half."""
    fn: Callable
    loss_and_grads: Callable


def _leaves(params: Tensors) -> Dict[str, Any]:
    """Gradient leaves sharing storage with ``params``: one per layer group
    and per unembedding chunk, so each group's reduced gradient lands in
    its own tensor (no full-buffer scatter per group)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k in _ROWS:
            out[k] = [v[i].detach().requires_grad_(True)
                      for i in range(v.shape[0])]
        else:
            out[k] = v.detach().requires_grad_(True)
    return out


def build_train_step(model: Model, opt_cfg: AdamWConfig, accum: int = 1,
                     device="cuda", attn_impl: str = "xla") -> TrainStep:
    """Build the ZeRO++ train step of ``model`` (which must run on
    ``device``: "cuda" unless the caller asks for "cpu").  With ``accum >
    1`` every batch leaf carries a leading microbatch axis (accum, B, S)
    and the gradients of the microbatches are summed, then divided by
    ``accum``, as in the reference.  ``attn_impl`` is the reference's
    switch: "xla" (plain attention) or "pallas" (the flash kernels where
    ``mha``'s rule allows)."""
    dev = platform.resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"step built for {dev} but the model runs on "
                         f"{model.device}")
    z = model.zcfg
    world = cl.world_size(z.group) if z.distributed else 1
    if world > 1:
        raise NotImplementedError(
            f"training at world {world}: the multi-rank train step is "
            f"ROADMAP Queue A item 7 (one process per rank); this slice "
            f"trains on a one-rank ('data', 'model') world")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    rs = RunSpec(mode="train", attn_impl=attn_impl)

    def one(params: Tensors, batch: Tensors
            ) -> Tuple[torch.Tensor, Dict[str, Any], Tensors]:
        leaves = _leaves(params)
        loss, mets = model.loss_fn(leaves, batch, rs, world)
        keys = sorted(leaves)
        flat: List[torch.Tensor] = []
        for k in keys:
            flat += leaves[k] if k in _ROWS else [leaves[k]]
        gs = list(torch.autograd.grad(loss, flat))
        del flat, leaves
        grads: Tensors = {}
        for k in keys:
            if k in _ROWS:
                n = params[k].shape[0]
                grads[k] = torch.stack(gs[:n])
                del gs[:n]
            else:
                grads[k] = gs.pop(0)
        return loss.detach(), mets, grads

    def loss_and_grads(params: Tensors, batch: Tensors):
        if accum == 1:
            return one(params, batch)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        nll = torch.zeros((), dtype=torch.float32, device=model.device)
        toks = 0.0
        grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device) for k, v in params.items()}
        for i in range(accum):
            l, m, g = one(params, {k: v[i] for k, v in batch.items()})
            for k in grads:
                grads[k].add_(g[k])
            del g
            loss = loss + l
            nll = nll + m["nll_sum"]
            toks += m["tokens"]
        for g in grads.values():
            g.div_(accum)
        return loss / accum, {"nll_sum": nll, "tokens": toks}, grads

    def fn(params: Tensors, opt: Dict, batch: Tensors) -> Dict[str, Any]:
        loss, mets, grads = loss_and_grads(params, batch)
        stats = apply_update(grads, params, opt, opt_cfg, z.group)
        return {"loss": loss, "nll": mets["nll_sum"] / mets["tokens"],
                "tokens": mets["tokens"], "grad_norm": stats["grad_norm"],
                "lr": stats["lr"]}

    return TrainStep(fn=fn, loss_and_grads=loss_and_grads)
