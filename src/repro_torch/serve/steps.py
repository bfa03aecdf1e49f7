"""Serving steps: prefill, decode and the paged step, and their layouts.

Port of the reference's ``train/serve.py``: ``build_prefill_step``,
``build_decode_step``, ``build_paged_step``, ``cache_specs``,
``paged_cache_specs``, ``pad_prefill_caches`` and ``serve_shape_policy``.
The reference wraps ``Model.prefill_fn``/``decode_fn``/``paged_fn`` in
shard_map and jit over a mesh; here a step is the model call itself, run
eagerly on this rank, and ``build_*_step`` fixes the run mode and the
layout.  Parameters stay in their flat ZeRO buffers (this rank's shards
beyond one rank) and every layer group goes through the qwZ gather over
the whole world, as in the reference.

With ``mesh=None`` (or a world of 1) a step is the world-1 step.  On a
``launch.mesh.Mesh`` of gloo ranks every rank calls the step with the
same GLOBAL batch, positions and page tables, as the reference's host
passes global arrays: the step cuts this rank's rows over ``batch_axes``
(and, in prefill, its slice of the sequence over ``seq_axes``), and
returns the GLOBAL logits, its rows gathered over the batch group, so
every rank holds what the reference's host reads.  Caches are this
rank's: its rows and its slice of the cache sequence over ``kv_axes``
(``cache_specs``), the paged arena unsharded over pages and cut within
each page over ``kv_axes`` (``paged_cache_specs``).  A prefill's caches
keep its activations' layout (kv_axes == seq_axes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SHAPES
from repro_torch.core import collectives as cl
from repro_torch.kernels import platform
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunSpec

# a cache leaf's layout: per dim, the mesh axes it is cut over (None:
# whole), the reference's PartitionSpec
Spec = Tuple[Optional[Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Callable
    run_spec: RunSpec


def _check_device(model: Model, device) -> None:
    dev = platform.resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"step built for {dev} but the model runs on "
                         f"{model.device}")


def axes_group(mesh: Optional[Mesh], axes: Sequence[str]
               ) -> Tuple[int, int, Any]:
    """(world, rank, group) of this rank over ``axes`` of ``mesh`` (in
    mesh order); (1, 0, None) for no axes, no mesh or a world of 1."""
    axes = tuple(axes)
    if mesh is None or not axes or mesh.world == 1:
        return 1, 0, None
    g = mesh.group(axes)
    return cl.world_size(g), cl.flat_rank(g), g


def _check_world(model: Model, mesh: Optional[Mesh]) -> None:
    w = 1 if mesh is None else mesh.world
    if model.world != w:
        raise ValueError(f"the model's flat layout is for world "
                         f"{model.world}, the mesh holds {w} ranks")


def _rows(x: torch.Tensor, world: int, rank: int, dim: int = 0
          ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` cut ``world`` ways (rank r
    the r-th, the rule of ``attention.kv_shard``)."""
    if world == 1:
        return x
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    return x.narrow(dim, rank * (n // world), n // world)


def _cut_batch(batch: Dict[str, torch.Tensor], bw: int, br: int,
               sw: int = 1, sr: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's rows (and sequence slice) of every batch leaf; M-RoPE
    ``positions`` (3, B, S) on dims (1, 2), the reference's ``P(None, b,
    s)``."""
    out = {}
    for k, v in batch.items():
        a = 1 if k == "positions" else 0
        out[k] = _rows(_rows(v, bw, br, a), sw, sr, a + 1)
    return out


def _whole(logits: torch.Tensor, group: Any) -> torch.Tensor:
    """The logits of every row: this rank's rows gathered over the batch
    group (None: the batch is not sharded)."""
    return logits if group is None else cl.gather_rows(logits, group)


def build_prefill_step(model: Model, with_last_pos: bool = False,
                       device="cuda", mesh: Optional[Mesh] = None,
                       batch_axes: Sequence[str] = (),
                       seq_axes: Sequence[str] = ()) -> ServeStep:
    """Prompt ingestion: (params, batch) -> (last-token logits, caches).

    With ``with_last_pos`` the step takes an extra (B,) int argument
    selecting each sequence's logits position — the last REAL token of a
    right-padded prompt (the engine's prompt-length buckets).  On a
    ``mesh`` the rows shard over ``batch_axes`` and the prompt's sequence
    over ``seq_axes``; the caches inherit that layout (kv_axes ==
    seq_axes) and the (B, 1, V) logits come back whole on every rank."""
    _check_device(model, device)
    _check_world(model, mesh)
    bw, br, bg = axes_group(mesh, batch_axes)
    sw, sr, sg = axes_group(mesh, seq_axes)
    seq = tuple(seq_axes) if sg is not None else ()
    rs = RunSpec(mode="prefill", seq_axes=seq, seq_group=sg, kv_axes=seq,
                 kv_group=sg)

    def fn(params, batch, last_pos=None):
        mine = _cut_batch(batch, bw, br, sw, sr)
        if last_pos is not None:
            last_pos = _rows(torch.as_tensor(last_pos), bw, br)
        logits, caches = model.prefill_fn(params, mine, rs,
                                          last_pos=last_pos)
        return _whole(logits, bg), caches

    if not with_last_pos:
        def step(params, batch):
            return fn(params, batch)
    else:
        step = fn
    return ServeStep(fn=step, run_spec=rs)


def build_decode_step(model: Model, device="cuda",
                      mesh: Optional[Mesh] = None,
                      batch_axes: Sequence[str] = (),
                      kv_axes: Sequence[str] = ()) -> ServeStep:
    """One-token decode: (params, caches, batch, cache_pos) -> (logits,
    caches).  ``cache_pos`` is a PER-SEQUENCE (B,) vector, so one step
    serves any mix of in-flight requests.  The caches (this rank's rows
    over ``batch_axes`` and slice of the cache sequence over ``kv_axes``)
    are updated in place; the batch and positions are global and the
    (B, 1, V) logits come back whole on every rank."""
    _check_device(model, device)
    _check_world(model, mesh)
    bw, br, bg = axes_group(mesh, batch_axes)
    _, _, kg = axes_group(mesh, kv_axes)
    rs = RunSpec(mode="decode",
                 kv_axes=tuple(kv_axes) if kg is not None else (),
                 kv_group=kg)

    def fn(params, caches, batch, cache_pos):
        B = (batch["embeds"] if "embeds" in batch else batch["tokens"]
             ).shape[0]
        pos = attn.per_seq_pos(cache_pos, B)
        logits, caches = model.decode_fn(
            params, caches, _cut_batch(batch, bw, br), _rows(pos, bw, br), rs)
        return _whole(logits, bg), caches
    return ServeStep(fn=fn, run_spec=rs)


def build_paged_step(model: Model, device="cuda",
                     mesh: Optional[Mesh] = None,
                     kv_axes: Sequence[str] = ()) -> ServeStep:
    """Paged multi-token step: (params, arena, batch, page_table,
    start_pos) -> ((B, T, V) logits, arena).  One step serves every paged
    workload: T = 1 batched decode, T = g + 1 speculative verify and
    B = 1, T = chunk chunked prefill.  The arena (``init_paged_caches``)
    is updated in place; the (B, Pm) page table and (B,) start positions
    may be host arrays (the engine's), read once a call.  The batch stays
    unsharded (any row may reference any page); on a ``mesh`` each page's
    tokens are cut over ``kv_axes`` and every other axis holds a replica
    that runs the same step on the same inputs."""
    _check_device(model, device)
    _check_world(model, mesh)
    _, _, kg = axes_group(mesh, kv_axes)
    rs = RunSpec(mode="paged",
                 kv_axes=tuple(kv_axes) if kg is not None else (),
                 kv_group=kg)

    def fn(params, caches, batch, page_table, start_pos):
        return model.paged_fn(params, caches, batch, page_table, start_pos,
                              rs)
    return ServeStep(fn=fn, run_spec=rs)


# ------------------------------------------------------------------ layouts

def _opt(axes: Sequence[str]) -> Optional[Tuple[str, ...]]:
    t = tuple(axes)
    return t or None


def cache_specs(model: Model, batch_axes: Sequence[str],
                kv_axes: Sequence[str]) -> Dict[str, Any]:
    """Layout tree matching ``model.cache_shapes``: per leaf the axes
    each dim is cut over, rows over ``batch_axes`` and a K/V cache's
    sequence over ``kv_axes``; an ``ssd``/``rec`` layer's state and conv
    history are cut over the rows only and whole on every kv rank (the
    reference's ``cache_specs``)."""
    b, kv = _opt(batch_axes), _opt(kv_axes)

    def per(kind: str, stacked: bool) -> Dict[str, Spec]:
        L = (None,) if stacked else ()
        if kind == "ssd":
            return {"h": L + (b, None, None, None),
                    "conv": L + (b, None, None)}
        if kind == "rec":
            return {"h": L + (b, None), "conv": L + (b, None, None)}
        s = L + (b, kv, None, None)
        return {"k": s, "v": s}

    blocks = tuple(per(kind, True) for kind in model.period)
    rem = tuple(per(kind, False) for kind in model.rem_kinds) \
        if model.rem_spec else None
    return {"blocks": blocks, "rem": rem}


def paged_cache_specs(model: Model, kv_axes: Sequence[str]
                      ) -> Dict[str, Any]:
    """Layout tree matching ``model.paged_cache_shapes``: the page dim
    whole (any slot's table may point at any page), the within-page token
    dim cut over ``kv_axes``; every other axis holds a replica (the
    reference's ``paged_cache_specs``)."""
    kv = _opt(kv_axes)
    if set(model.period) != {"attn"}:
        raise ValueError(f"paged caches are attn-only, got {model.period}")
    s: Spec = (None, None, kv, None, None)
    blocks = tuple({"k": s, "v": s} for _ in model.period)
    rem = tuple({"k": s[1:], "v": s[1:]} for _ in model.rem_kinds) \
        if model.rem_spec else None
    return {"blocks": blocks, "rem": rem}


def shard_cut(x: torch.Tensor, spec: Spec, mesh: Optional[Mesh]
              ) -> torch.Tensor:
    """This rank's block (a view) of a global ``x`` laid out by
    ``spec``: each dim cut into equal slices over its axes' group, in
    rank order."""
    for d, axes in enumerate(spec):
        w, r, _ = axes_group(mesh, axes or ())
        x = _rows(x, w, r, d)
    return x


def _relayout(x: torch.Tensor, dim: int, src: Any, length: int,
              dst_world: int, dst_rank: int) -> torch.Tensor:
    """``x`` cut along ``dim`` over the group ``src`` (None: whole)
    gathered in rank order, zero-padded to ``length`` and cut
    ``dst_world`` ways: this rank's ``dst_rank``-th slice."""
    if src is not None and cl.world_size(src) > 1:
        x = cl.gather_rows(x.movedim(dim, 0), src).movedim(0, dim)
    pad = length - x.shape[dim]
    if pad > 0:
        widths = [0, 0] * (x.dim() - dim)
        widths[-1] = pad
        x = F.pad(x, widths)
    return _rows(x, dst_world, dst_rank, dim).contiguous()


def pad_prefill_caches(model: Model, caches, kv_len: int,
                       mesh: Optional[Mesh] = None,
                       seq_axes: Sequence[str] = (),
                       kv_axes: Sequence[str] = ()):
    """Grow prefill KV caches (length = prompt) to decode capacity.

    Full-attention (``attn``, ``moe``) caches use slot == position, so
    zero-padding the sequence dim to ``kv_len`` is exact: padded slots are
    masked out by decode_attend's position-validity test.  Ring buffers
    (``local`` layers) are already capacity-sized, and an ``ssd``/``rec``
    layer's state and conv history are left as they are (every sequence
    rank holds the last shard's, the decode layout).  On a ``mesh`` the
    caches arrive cut over ``seq_axes`` (the prefill's layout) and leave
    cut over ``kv_axes`` (the decode step's): the slices are gathered over
    the sequence group and re-cut (the reference re-places its global
    arrays); rows stay as they are."""
    _, _, sg = axes_group(mesh, seq_axes)
    kw, kr, kg = axes_group(mesh, kv_axes)
    same = (tuple(seq_axes) if sg is not None else ()) == \
        (tuple(kv_axes) if kg is not None else ())

    def grow(kind, cache, axis):
        if kind in ("ssd", "rec") or (kind == "local" and same):
            return cache
        n = model.cfg.window if kind == "local" else kv_len
        return {key: _relayout(cache[key], axis, sg, n, kw, kr)
                for key in ("k", "v")}

    blocks = tuple(grow(kind, c, 2)              # (n_periods, B, S, K, hd)
                   for kind, c in zip(model.period, caches["blocks"]))
    rem = caches.get("rem")
    if rem is not None:
        rem = tuple(grow(kind, c, 1)             # (B, S, K, hd)
                    for kind, c in zip(model.rem_kinds, rem))
    return {"blocks": blocks, "rem": rem}


def serve_shape_policy(shape_name: str, mesh_axes: Sequence[str]
                       ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(batch_axes, kv_axes) for a named inference shape.

    Validates both inputs instead of silently falling through to the
    default layout: the shape must be a known *serving* shape from
    ``configs.base.SHAPES`` and the mesh must carry the fast ``model``
    axis the KV layout is keyed on."""
    serving = {n for n, s in SHAPES.items() if s.kind in ("prefill",
                                                          "decode")}
    if shape_name not in SHAPES:
        raise ValueError(
            f"unknown inference shape {shape_name!r}; known serving shapes: "
            f"{sorted(serving)}")
    if shape_name not in serving:
        raise ValueError(
            f"shape {shape_name!r} is a {SHAPES[shape_name].kind} shape, "
            f"not a serving one; expected one of {sorted(serving)}")
    axes = tuple(mesh_axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate mesh axis names: {axes}")
    if "model" not in axes:
        raise ValueError(
            f"serving layouts shard the KV cache over the fast 'model' "
            f"axis, absent from mesh axes {axes}")
    fast = ("model",)
    slow = tuple(a for a in axes if a != "model")
    if shape_name == "long_500k":
        return (), axes                  # B=1: shard the cache everywhere
    return slow, fast
