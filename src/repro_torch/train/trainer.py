"""The ZeRO++ training step around the Model.

Port of the reference's ``train/trainer.build_train_step``.  The reference
jits one ``shard_map`` over the mesh around loss, backward and optimizer;
here each rank runs the step eagerly on the model's device, and every
ZeRO++ collective (qwZ gathers, hpZ secondary gathers, qgZ reduce)
happens inside the model's ``zero_apply`` groups, per layer group, exactly
where the reference issues it.  The step is split in two so that tests can
read the gradients: :func:`TrainStep.loss_and_grads` (forward and
backward, with gradient accumulation over ``accum`` microbatches) and the
AdamW update.

A rank holds its primary shard of every flat buffer (the trailing axis,
the reference's ``param_specs``) and takes the GLOBAL batch, of which it
reads its own tile, in the reference's activation layout: the batch over
the axes ``choose_batch_seq_axes`` gives it (a prefix of the mesh's axes,
``("data", "model")`` or ``("pod", "data", "model")``), the sequence over
the rest, where ``mha`` gathers K/V (``RunSpec.seq_axes``, over the
mesh's group of those axes).  Pure data parallel whenever the global
batch covers the world: rank r (row-major, ``model`` fastest) reads rows
[r·B/W, (r+1)·B/W).  With no ``global_batch`` the reference always
shards the sequence over ``model``, and so does the port; unlike the
reference, an axis of size 1 carries no sequence, so the flash kernels
stay in at world 1.  The layer
loop's schedule is the model's ``ZeroConfig.prefetch`` ring
(``core/schedule.py``).  Loss, NLL and tokens are summed over the world
after the update, as the reference's ``lax.psum``s do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import collectives as cl
from repro_torch.kernels import platform
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunSpec
from repro_torch.optim.adamw import AdamWConfig, apply_update

Tensors = Dict[str, torch.Tensor]
_ROWS = ("blocks", "unemb")    # buffers stacked over layer groups / chunks
AXES = ("data", "model")       # the world's axes, slowest first


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """A built train step.  ``fn(params, opt, batch) -> metrics`` updates
    ``params`` and ``opt`` in place; ``loss_and_grads(params, batch) ->
    (loss, {"nll_sum", "tokens"}, grads)`` is its first half.
    ``run_spec.seq_axes`` are the axes that carry the sequence."""
    fn: Callable
    loss_and_grads: Callable
    run_spec: RunSpec


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


def choose_batch_seq_axes(global_batch: int, shape: Tuple[int, ...],
                          axes: Tuple[str, ...] = AXES
                          ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The reference's greedy activation layout: shard the batch over as
    many (slowest-first) axes as it divides into; the remaining axes carry
    the sequence.  Pure data parallel (no sequence axis) whenever the
    global batch covers the world."""
    batch_axes, rem = [], global_batch
    for ax, n in zip(axes, shape):
        if rem % n == 0 and rem >= n:
            batch_axes.append(ax)
            rem //= n
        else:
            break
    return tuple(batch_axes), tuple(a for a in axes if a not in batch_axes)


def _layout(world: int, mesh: Optional[Mesh]):
    """(axes, {axis: size}, group of a tuple of axes) of the step's world:
    the mesh's, which a world of more than one rank needs."""
    if mesh is None:
        if world > 1:
            raise ValueError(f"a ZeRO world of {world} ranks needs its mesh "
                             f"(build_train_step(mesh=))")
        return AXES, dict.fromkeys(AXES, 1), lambda axes: None
    if mesh.world != world:
        raise ValueError(f"mesh {mesh.shape} for a ZeRO world of {world}")
    return mesh.axes, mesh.sizes, mesh.group


def build_train_step(model: Model, opt_cfg: AdamWConfig, accum: int = 1,
                     device="cuda", attn_impl: str = "xla",
                     global_batch: Optional[int] = None,
                     mesh: Optional[Mesh] = None) -> TrainStep:
    """Build the ZeRO++ train step of ``model`` (which must run on
    ``device``: "cuda" unless the caller asks for "cpu") for this rank of
    the model's ZeRO world (``zcfg.group``, tiers ``intra_group`` and
    ``inter_group``; world ``model.world``).  The step takes this rank's
    primary shards and the GLOBAL batch; with ``accum > 1`` every batch
    leaf carries a leading microbatch axis (accum, B, S), the tiles are
    cut on the next two axes, and the gradients of the microbatches are
    summed, then divided by ``accum``, as in the reference.  The layout is
    the reference's: ``global_batch`` (rows per microbatch) takes
    ``choose_batch_seq_axes``; without it the batch goes over ``data`` and
    the sequence over ``model``.  A sequence axis of size 1 is left out
    (the reference keeps it, and its ``mha`` then drops the flash
    kernels).  ``attn_impl`` is the reference's switch: "xla" (plain
    attention) or "pallas" (the flash kernels where ``mha``'s rule
    allows: no sequence axis).  ``mesh`` is the world's
    ``launch.mesh.Mesh`` (its axes, sizes and groups), required beyond
    one rank."""
    dev = platform.resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"step built for {dev} but the model runs on "
                         f"{model.device}")
    z = model.zcfg
    world = cl.world_size(z.group) if z.distributed else 1
    if world != model.world:
        raise ValueError(f"the model's flat layout is for world "
                         f"{model.world}, its ZeRO group holds {world} ranks")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    rank = cl.flat_rank(z.group) if world > 1 else 0
    axes, sizes, group_of = _layout(world, mesh)
    if global_batch is not None:
        batch_axes, seq_axes = choose_batch_seq_axes(
            global_batch, tuple(sizes[a] for a in axes), axes)
    else:
        batch_axes, seq_axes = axes[:-1], axes[-1:]
    # the batch axes are a prefix of the mesh's axes, so rank r's tile is
    # row block r // ns of nb and sequence block r % ns of ns; the
    # sequence ranks are the group of the remaining axes, in rank order
    nb = 1
    for a in batch_axes:
        nb *= sizes[a]
    ns = world // nb
    seq_group = group_of(axes[len(batch_axes):]) if ns > 1 else None
    seq_axes = tuple(a for a in seq_axes if sizes[a] > 1)
    rs = RunSpec(mode="train", seq_axes=seq_axes,
                 seq_group=seq_group if seq_axes else None,
                 attn_impl=attn_impl)

    def tile(batch: Tensors) -> Tensors:
        """This rank's rows and sequence slice of the global batch (views)."""
        if world == 1:
            return batch
        ax = 1 if accum > 1 else 0
        b, s = batch["tokens"].shape[ax:ax + 2]
        if b % nb or s % ns:
            raise ValueError(
                f"a batch of {b} x {s} does not tile the "
                f"{'x'.join(str(sizes[a]) for a in axes)} world as rows "
                f"over {batch_axes} and the sequence over {seq_axes}")
        rb, sb = b // nb, s // ns
        return {k: v.narrow(ax, rank // ns * rb, rb).narrow(
            ax + 1, rank % ns * sb, sb) for k, v in batch.items()}

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
        batch = tile(batch)
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
        nll, toks = mets["nll_sum"], mets["tokens"]
        if world > 1:       # the reference's psums, as one message
            tot = torch.stack([loss, nll, torch.tensor(
                toks, dtype=torch.float32, device=loss.device)])
            cl.all_reduce(tot, z.group)
            loss, nll, toks = tot[0], tot[1], float(tot[2])
        return {"loss": loss, "nll": nll / toks, "tokens": toks,
                "grad_norm": stats["grad_norm"], "lr": stats["lr"]}

    return TrainStep(fn=fn, loss_and_grads=loss_and_grads, run_spec=rs)
