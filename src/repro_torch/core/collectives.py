"""ZeRO++ collectives on torch.distributed.

Port of the reference's ``core/collectives.py``:

  * :func:`baseline_all_gather` / :func:`baseline_reduce_scatter` —
    full-precision all-gather of a flat shard and reduce-scatter of a flat
    gradient (ZeRO-3, paper Alg. 1);
  * :func:`qwz_all_gather` — blockwise-INT8 quantized all-gather (qwZ,
    §3.1): quantize the shard once, gather payload + scales, dequantize;
    ``blocked=False`` is the paper's non-blocked ablation (Fig. 2 /
    Fig. 14: one scale a shard, ``quant.quantize_global``);
  * :func:`qwz_all_gather_quant` — the same gather that stays quantized,
    for a fused consumer (the INT8 head GEMM);
  * :func:`slice_secondary` / :func:`hpz_all_gather` — hpZ (§3.2): cut
    the gathered weights into this rank's secondary shard, and gather it
    back over the secondary group only (the fast intra-node group, or a
    wider one such as a whole pod);
  * :func:`qgz_reduce_scatter` — qgZ (§3.3): the INT4 (or INT8)
    hierarchical 2-hop all-to-all gradient reduce-scatter with slice
    reordering and fp32 reductions, each hop one message with the scales
    packed in;
  * :func:`qgz_reduce_scatter_1hop` — §3.3.2's intermediate design: one
    flat all-to-all over the whole world, one quantization;
  * :func:`qgz_quantized_ring_reduce_scatter` — the naive quantized ring
    (Fig. 5 left), W − 1 quantize-send-dequantize-add hops; used by no
    training path.

``group`` arguments are ``torch.distributed`` process groups (None = the
default group).  Ranks are row-major over the reference's mesh axes
(``("data", "model")`` or ``("pod", "data", "model")``) with ``model``
fastest; :func:`axis_group` gives this rank's group over any tuple of
axes (the ranks that agree on every other coordinate, row-major over
the tuple), which is what the reference's collectives over a tuple of
axis names reach.  A world of 1 (no initialised group, or a group of one)
makes every gather and all-to-all the identity — the reference's
semantics on a one-device mesh, not a fallback — while the quantize,
reduce and dequantize still run, as in the reference.

The sums of the 1-hop and of each ring hop follow what the reference
computes under XLA: its ``sum(dequantize(q, s), axis=0)`` and its ``recv
+ mine`` contract into the fused multiply-add chain ``acc = fma(q_n,
s_n, acc)``, so both reach B5 (``dequant_reduce``; the ring with its
``init``, the chain starting from ``mine``), not B2 and a separate sum.

The collectives that the prefetch ring (``core/schedule.py``) keeps in
flight also come split at their wire hops (``*_hops``): a generator whose
each step runs up to issuing the next hop (``async_op=True``) and returns
before anything waits on it; the step after ``Work.wait()``s for that hop
before reading what it brought.  :func:`begin` runs the first step,
:func:`advance` the next, :func:`finish` the rest, returning the result.
The synchronous functions are ``finish`` of their hops.

Every collective is counted where it is issued: its wire bytes per rank
(all-gather out − in, reduce-scatter in − out, all-to-all in·(g−1)/g,
all-reduce 2·in·(g−1)/g, a ring hop the bytes it sends — the
reference's ``launch/jaxpr_analysis.py`` rules) go to the metrics
registry as ``comm.<label>.bytes``, and its issue and its wait run under
the profiler ranges ``<label>`` and ``<label>.wait``
(``obs.trace.annotate``).  Each ``*_hops`` function passes its label
down explicitly — ``zero.qwz_gather``, ``zero.baseline_gather``,
``zero.hpz_gather``, ``zero.qgz_reduce``, ``zero.qgz_reduce1hop``,
``zero.baseline_reduce`` (``zeropp.WIRE_LABELS``) — because the ring
advances a collective's hops while other collectives are in flight: no
label can be "current" then.  The quantized ring counts under
``zero.qgz_ring``, the reference's name for it; collectives outside the
ZeRO engine (the sequence gather, the metric and norm all-reduces) take
:data:`OTHER`.  A world of 1 issues nothing and counts nothing.
"""
from __future__ import annotations

from typing import Generator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quant import (QuantConfig, dequantize_global,
                                    quantize_global)
from repro_torch.kernels import ops as _kops
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import annotate

# The labels the collectives count under (``zeropp.wire_label`` projects
# by the same names): the ZeRO engine's six, the quantized ring (no
# training path runs it, so nothing projects it), and every collective
# outside the engine.
QWZ = "zero.qwz_gather"
BASELINE_GATHER = "zero.baseline_gather"
HPZ = "zero.hpz_gather"
QGZ = "zero.qgz_reduce"
QGZ_1HOP = "zero.qgz_reduce1hop"
BASELINE_REDUCE = "zero.baseline_reduce"
QGZ_RING = "zero.qgz_ring"
OTHER = "other"


def world_size(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def flat_rank(group=None) -> int:
    """This rank's index within ``group`` (row-major over its axes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


# A collective split at its wire hops: each step issues the next hop and
# returns; the generator's return value is the result.
Hops = Generator[None, None, torch.Tensor]


def begin(hops: Hops) -> Hops:
    """Run ``hops`` up to its first hop in flight; returns it."""
    next(hops)
    return hops


def advance(hops: Hops) -> Optional[torch.Tensor]:
    """Wait for the hop in flight and run up to issuing the next one: the
    result when no hop is left, else None."""
    try:
        next(hops)
    except StopIteration as stop:
        return stop.value
    return None


def finish(hops: Hops) -> torch.Tensor:
    """Run the rest of ``hops`` (begun or not) and return its result."""
    while True:
        out = advance(hops)
        if out is not None:
            return out


def _count(label: str, nbytes) -> None:
    """Add a collective's wire bytes per rank to ``comm.<label>.bytes``."""
    get_registry().counter(f"comm.{label}.bytes").inc(nbytes)


def _wait(label: str, *works) -> None:
    """Wait for ``works`` (None: nothing was issued) under the profiler
    range ``<label>.wait``."""
    works = [w for w in works if w is not None]
    if works:
        with annotate(label + ".wait"):
            for w in works:
                w.wait()


def _gather_start(shard: torch.Tensor, group, label: str):
    """Issue the tiled all-gather of a 1-D shard along dim 0: (out, work),
    ``out`` not to be read before ``work`` is waited on (None: world 1,
    ``out`` is the shard).  Counts out − in bytes under ``label``."""
    world = world_size(group)
    if world == 1:
        return shard, None
    shard = shard.contiguous()
    out = torch.empty((world * shard.shape[0],), dtype=shard.dtype,
                      device=shard.device)
    with annotate(label):
        work = dist.all_gather_into_tensor(out, shard, group=group,
                                           async_op=True)
    _count(label, out.nbytes - shard.nbytes)
    return out, work


def _gather(shard: torch.Tensor, group=None, label: str = OTHER
            ) -> torch.Tensor:
    """Tiled all-gather of a 1-D shard along dim 0."""
    out, work = _gather_start(shard, group, label)
    _wait(label, work)
    return out


def all_reduce(x: torch.Tensor, group=None, label: str = OTHER) -> None:
    """In-place sum of ``x`` over ``group``, counted as 2·in·(g−1)/g
    bytes (a ring all-reduce; the reference's psum rule)."""
    world = world_size(group)
    if world == 1:
        return
    with annotate(label):
        dist.all_reduce(x, group=group)
    _count(label, 2 * x.nbytes * (world - 1) / world)


def axis_group(shape: Sequence[int], names: Sequence[str],
               axes: Sequence[str]):
    """This rank's process group over the mesh axes ``axes`` of a world of
    ``shape`` (axis ``names``, ranks row-major, the last axis fastest):
    the ranks that agree with it on every coordinate outside ``axes``,
    ordered row-major over ``axes`` in the order given (the reference's
    flattening of a tuple of axis names).  Every rank must call this with
    the same arguments, in the same order: it creates the group of every
    such set of ranks (``new_subgroups_by_enumeration``)."""
    names, axes = tuple(names), tuple(axes)
    if len(shape) != len(names) or len(set(axes)) != len(axes) or \
            not set(axes) <= set(names):
        raise ValueError(f"axes {axes} of a mesh {tuple(shape)} over "
                         f"{names}")
    world = 1
    for s in shape:
        world *= int(s)
    if world != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {world} ranks, the "
                         f"process group holds {dist.get_world_size()}")
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    size = 1
    for i in inner:
        size *= int(shape[i])
    ranks = torch.arange(world).reshape(tuple(int(s) for s in shape))
    enum = ranks.permute(*outer, *inner).reshape(-1, size).tolist()
    group, _ = dist.new_subgroups_by_enumeration(enum)
    return group


def tier_groups(intra_size: int):
    """(intra, inter) process groups of the default world read as (Y, X)
    over ``("data", "model")``: intra groups are runs of ``intra_size``
    consecutive ranks, inter groups every ``intra_size``-th rank.  Every
    rank must call this, in the same order."""
    world = dist.get_world_size()
    if world % intra_size:
        raise ValueError(f"world {world} is not a multiple of {intra_size}")
    shape, names = (world // intra_size, intra_size), ("data", "model")
    return (axis_group(shape, names, ("model",)),
            axis_group(shape, names, ("data",)))


def gather_bf16_hops(shard: torch.Tensor, group, label: str) -> Hops:
    """All-gather that moves 2-byte lanes: bf16 crosses as its raw bytes
    (an int8 view, bit-level identity, which every backend takes), other
    dtypes as themselves.  One hop, counted under the caller's
    ``label``."""
    bf16 = shard.dtype == torch.bfloat16
    out, work = _gather_start(
        shard.contiguous().view(torch.int8) if bf16 else shard, group, label)
    yield
    _wait(label, work)
    return out.view(torch.bfloat16) if bf16 else out


def gather_bf16(shard: torch.Tensor, group, label: str) -> torch.Tensor:
    return finish(gather_bf16_hops(shard, group, label))


def baseline_all_gather_hops(shard: torch.Tensor, group=None,
                             out_dtype: Optional[torch.dtype] = None,
                             label: str = BASELINE_GATHER) -> Hops:
    """Full-precision all-gather of a flat parameter shard (ZeRO-3)."""
    full = yield from gather_bf16_hops(shard, group, label)
    return full if out_dtype is None else full.to(out_dtype)


def baseline_all_gather(shard: torch.Tensor, group=None,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    return finish(baseline_all_gather_hops(shard, group, out_dtype))


def baseline_reduce_scatter_hops(grad: torch.Tensor, group=None,
                                 label: str = BASELINE_REDUCE) -> Hops:
    """Full-precision reduce-scatter of a flat local gradient (ZeRO-3):
    this rank's shard of the sum over the group, counted in − out bytes
    under ``label``.  One hop."""
    world = world_size(group)
    out, work = grad, None
    if world > 1:
        grad = grad.contiguous()
        out = torch.empty((grad.shape[0] // world,), dtype=grad.dtype,
                          device=grad.device)
        with annotate(label):
            work = dist.reduce_scatter_tensor(out, grad, group=group,
                                              async_op=True)
        _count(label, grad.nbytes - out.nbytes)
    yield
    _wait(label, work)
    return out


def baseline_reduce_scatter(grad: torch.Tensor, group=None,
                            label: str = BASELINE_REDUCE) -> torch.Tensor:
    return finish(baseline_reduce_scatter_hops(grad, group, label))


def _quantize_shard(shard: torch.Tensor, cfg: QuantConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = shard.shape[0]
    if n % cfg.block_size:
        raise ValueError(f"shard len {n} % block {cfg.block_size} != 0")
    return _kops.quantize_blockwise(shard, cfg)


def qwz_all_gather_hops(shard: torch.Tensor, group, cfg: QuantConfig,
                        out_dtype: torch.dtype = torch.bfloat16,
                        blocked: bool = True) -> Hops:
    """All-gather a flat weight shard with in-flight blockwise
    quantization: 0.5·M payload + scales on the wire instead of M (bf16).
    One hop: B1, the payload's and the scales' gathers issued; then B2.

    ``blocked=False`` is the paper's non-blocked ablation (Fig. 2 /
    Fig. 14): one fp32 scale a shard (``quant.quantize_global``, plain
    PyTorch as in the reference), the (world,) scales gathered beside the
    payload, each shard dequantized with its own scale."""
    if not blocked:
        payload, scale = quantize_global(shard, cfg.bits)
        payload_g, w1 = _gather_start(payload, group, QWZ)
        scales_g, w2 = _gather_start(scale.reshape(1), group, QWZ)
        yield
        _wait(QWZ, w1, w2)
        world = world_size(group)
        return dequantize_global(payload_g.reshape(world, -1),
                                 scales_g.reshape(world, 1), cfg.bits,
                                 out_dtype).reshape(-1)
    payload, scales = _quantize_shard(shard, cfg)
    payload_g, w1 = _gather_start(payload, group, QWZ)
    scales_g, w2 = _gather_start(scales, group, QWZ)
    yield
    _wait(QWZ, w1, w2)
    return _kops.dequantize_blockwise(payload_g, scales_g, cfg, out_dtype)


def qwz_all_gather(shard: torch.Tensor, group, cfg: QuantConfig,
                   out_dtype: torch.dtype = torch.bfloat16,
                   blocked: bool = True) -> torch.Tensor:
    return finish(qwz_all_gather_hops(shard, group, cfg, out_dtype, blocked))


def qwz_all_gather_quant(shard: torch.Tensor, group, cfg: QuantConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwZ all-gather that STAYS quantized: (payload_g, scales_g).  Same
    wire traffic as :func:`qwz_all_gather`; the consumer applies the
    scales itself, so the gathered bf16 weights never exist."""
    payload, scales = _quantize_shard(shard, cfg)
    return _gather(payload, group, QWZ), _gather(scales, group, QWZ)


# ---------------------------------------------------------------------------
# hpZ — hierarchical (secondary) partition all-gather (§3.2)
# ---------------------------------------------------------------------------

def slice_secondary(full: torch.Tensor, group=None) -> torch.Tensor:
    """Re-partition gathered weights into this rank's secondary shard over
    the secondary group (paper §3.2.1: once consumed in the forward pass,
    the weights are partitioned by the secondary partition).  A slice of the
    gathered tensor: no communication.  At world 1 it is the whole
    tensor."""
    x = world_size(group)
    if x == 1:
        return full
    n = full.shape[0] // x
    i = flat_rank(group)
    return full[i * n:(i + 1) * n].clone()


def hpz_all_gather_hops(secondary: torch.Tensor, group=None) -> Hops:
    """Backward all-gather over the secondary group only (the fast
    intra-node group; or a wider one, such as a whole pod — the paper's
    "multiple compute nodes" secondary group): the secondary partition
    replicates the full weights within each such group, so no byte
    crosses the tiers outside it."""
    return gather_bf16_hops(secondary, group, HPZ)


def hpz_all_gather(secondary: torch.Tensor, group=None) -> torch.Tensor:
    return finish(hpz_all_gather_hops(secondary, group))


# ---------------------------------------------------------------------------
# qgZ — quantized hierarchical all-to-all gradient reduce-scatter (§3.3)
# ---------------------------------------------------------------------------

def _pack_scales(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Append the fp32 block scales to the int8 payload on the trailing
    dim, each scale as its 4 bytes (lossless), so ONE all-to-all moves
    both.  The byte layout is the reference's ``_pack_scales``
    (``bitcast_convert_type`` to int8 lanes)."""
    sb = scales.contiguous().view(torch.int8)
    return torch.cat([payload, sb], dim=-1)


def _unpack_scales(msg: torch.Tensor, payload_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a :func:`_pack_scales` message back into (payload, scales)."""
    payload = msg[..., :payload_len]
    scales = msg[..., payload_len:].contiguous().view(torch.float32)
    return payload, scales


def _all_to_all_start(x: torch.Tensor, group, label: str):
    """Issue the all-to-all along dim 0: chunk j goes to group rank j, and
    the received chunks are concatenated in source-rank order (the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``).  Returns
    (out, work) as :func:`_gather_start`; counts in·(g−1)/g bytes (the
    chunk that stays is not sent)."""
    world = world_size(group)
    if world == 1:
        return x, None
    x = x.contiguous()
    out = torch.empty_like(x)
    with annotate(label):
        work = dist.all_to_all_single(out, x, group=group, async_op=True)
    _count(label, x.nbytes * (world - 1) // world)
    return out, work


def _all_to_all(x: torch.Tensor, group=None, label: str = OTHER
                ) -> torch.Tensor:
    out, work = _all_to_all_start(x, group, label)
    _wait(label, work)
    return out


def qgz_reduce_scatter_hops(grad: torch.Tensor, intra_group, inter_group,
                            cfg: QuantConfig, two_tier: bool = True,
                            u1: Optional[torch.Tensor] = None,
                            u2: Optional[torch.Tensor] = None) -> Hops:
    """Replacement for the gradient reduce-scatter (paper §3.3, Figs. 5-9).

    For a world of Y (inter) × X (intra) ranks and a flat local gradient
    of n = world·L elements:

      1. view it as slices (Y, X, L) — slice (y, x) is bound for the rank
         at inter coordinate y, intra coordinate x — and quantize it read
         as (X, Y, L) (B3: the reorder of Eq. (1) -> (2) lives in the
         kernel's load index);
      2. all-to-all over the intra group (payload and scales in one
         message), then dequantize, reduce in fp32 over the X
         contributions and requantize (B4);
      3. all-to-all over the inter group, dequantize and reduce over the
         Y contributions (B5).

    ``two_tier`` is the reference's "inter axes non-empty": False is the
    single-tier world, where step 2 ends with the final reduce (B5).  The
    inter group may span several axes (``("pod", "data")``: Y is their
    product, its ranks in row-major order).  ``cfg`` carries the bits
    (INT4 by default, ``ZeroConfig.qgz_bits``) of both quantizations.
    ``u1`` ((X, Y, L)) and ``u2`` ((Y·L,)) are optional uniform fields
    for stochastic rounding of the two quantizations.  Returns this rank's
    fully reduced gradient shard, float32 of length L, summed (not
    averaged) over the world.  Two hops (one without ``two_tier``): B3 and
    the first all-to-all issued; then B4 and the second; then B5.
    """
    X = world_size(intra_group)
    Y = world_size(inter_group) if two_tier else 1
    world = X * Y
    n = grad.shape[0]
    if n % (world * cfg.block_size):
        raise ValueError(f"grad len {n} must be a multiple of world*block "
                         f"({world}*{cfg.block_size})")
    L = n // world
    payload, scales = _kops.quantize_reordered(grad.reshape(Y, X, L), cfg, u1)
    del grad
    msg, work = _all_to_all_start(_pack_scales(payload, scales), intra_group,
                                  QGZ)
    yield
    _wait(QGZ, work)
    payload, scales = _unpack_scales(msg, payload.shape[-1])
    # payload[x'] is peer x''s contribution to this rank's (Y, L) slices
    if not two_tier:
        out = _kops.dequant_reduce(payload.reshape(X, -1),
                                   scales.reshape(X, -1), cfg)
        return out.reshape(Y, L)[0]
    payload2, scales2 = _kops.dequant_reduce_quant(
        payload.reshape(X, -1), scales.reshape(X, -1), cfg, cfg, u2)
    payload2 = payload2.reshape(Y, -1)
    scales2 = scales2.reshape(Y, -1)
    msg2, work = _all_to_all_start(_pack_scales(payload2, scales2),
                                   inter_group, QGZ)
    yield
    _wait(QGZ, work)
    payload2, scales2 = _unpack_scales(msg2, payload2.shape[-1])
    return _kops.dequant_reduce(payload2, scales2, cfg)


def qgz_reduce_scatter(grad: torch.Tensor, intra_group, inter_group,
                       cfg: QuantConfig, two_tier: bool = True,
                       u1: Optional[torch.Tensor] = None,
                       u2: Optional[torch.Tensor] = None) -> torch.Tensor:
    return finish(qgz_reduce_scatter_hops(grad, intra_group, inter_group,
                                          cfg, two_tier, u1, u2))


def qgz_reduce_scatter_1hop_hops(grad: torch.Tensor, group,
                                 cfg: QuantConfig) -> Hops:
    """The paper's intermediate design (§3.3.2, Fig. 5 right / Fig. 6):
    one flat all-to-all over the whole ZeRO world ``group`` of W ranks.
    The local gradient of n = W·L elements is cut into (W, L) slices,
    slice j bound for rank j, quantized by B1; one all-to-all moves
    payload and scales; B5 sums the
    W contributions in fp32 (the reference's ``sum(dequantize(...),
    axis=0)``, which XLA contracts into B5's FMA chain).  One quantization
    touches a value, but every slice crosses every tier.  Returns this
    rank's float32 shard of length L, summed over the world, counted under
    ``zero.qgz_reduce1hop``.  One hop."""
    world = world_size(group)
    n = grad.shape[0]
    if n % (world * cfg.block_size):
        raise ValueError(f"grad len {n} must be a multiple of world*block "
                         f"({world}*{cfg.block_size})")
    payload, scales = _kops.quantize_blockwise(
        grad.reshape(world, n // world), cfg)
    del grad
    msg, work = _all_to_all_start(_pack_scales(payload, scales), group,
                                  QGZ_1HOP)
    yield
    _wait(QGZ_1HOP, work)
    payload, scales = _unpack_scales(msg, payload.shape[-1])
    return _kops.dequant_reduce(payload, scales, cfg)


def qgz_reduce_scatter_1hop(grad: torch.Tensor, group, cfg: QuantConfig
                            ) -> torch.Tensor:
    return finish(qgz_reduce_scatter_1hop_hops(grad, group, cfg))


def qgz_quantized_ring_reduce_scatter(grad: torch.Tensor, group,
                                      cfg: QuantConfig) -> torch.Tensor:
    """The naive quantized ring reduce-scatter (paper Fig. 5 left), over
    ``group``'s W ranks in rank order: this rank starts from its slice
    (r − 1) mod W in fp32; each of W − 1 hops quantizes the partial sum
    (B1), sends it to rank r + 1 and receives rank r − 1's (payload and
    scales in one message), and adds its own slice (r − 2 − i) mod W to
    what it received — dequantize and add in one FMA, as the reference's
    ``recv + mine`` compiles (B5 with the chain started at ``mine``).
    The error compounds once a hop; the reference keeps it for its
    accuracy argument and its convergence benchmark, never for training.
    Returns this rank's float32 slice r of length n // W, summed over the
    world; each hop counts the bytes it sends under ``zero.qgz_ring``."""
    world, rank = world_size(group), flat_rank(group)
    L = grad.shape[0] // world

    def chunk(i: int) -> torch.Tensor:
        j = i % world
        return grad[j * L:(j + 1) * L].to(torch.float32)

    acc = chunk(rank - 1)
    # the neighbours' ranks in the default group, which P2POp takes
    nxt, prv = ((r if group is None else dist.get_global_rank(group, r))
                for r in ((rank + 1) % world, (rank - 1) % world))
    for i in range(world - 1):
        payload, scales = _kops.quantize_blockwise(acc, cfg)
        msg = _pack_scales(payload, scales)
        got = torch.empty_like(msg)
        with annotate(QGZ_RING):
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, msg, nxt, group),
                dist.P2POp(dist.irecv, got, prv, group)])
        _count(QGZ_RING, msg.nbytes)
        _wait(QGZ_RING, *works)
        payload, scales = _unpack_scales(got, payload.shape[-1])
        acc = _kops.dequant_reduce(payload[None], scales[None], cfg,
                                   init=chunk(rank - 2 - i))
    return acc
