"""The training layer loop of the ZeRO++ engine, synchronous schedule.

Port of the synchronous path of the reference's ``core/schedule.py``
``zero_apply_scan`` (``ZeroConfig.prefetch = 0``, a scan over per-layer
``zero_apply``): layer *i*'s group is gathered, applied and, in the
backward pass, re-gathered and reduced right around its own compute.  The
reference's depth-k prefetch ring issues the same collectives on the same
values in the same per-layer order, so it is bit-exact with this loop at
every depth (DESIGN.md §3); the ring itself is later work.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.zeropp import ZeroConfig, zero_apply


def zero_apply_scan(f: Callable, z: ZeroConfig) -> Callable:
    """Loop ``f(W_full, h, *bargs) -> h_next`` over stacked per-layer
    primary shards.  Returns ``run(stacked, h0, *bargs) -> h_final``,
    differentiable with respect to every shard, ``h0`` and the float
    ``bargs``; ``stacked`` is an (n, P) tensor or a sequence of n (P,)
    shards (the trainer passes one gradient leaf per layer)."""
    ap = zero_apply(f, z)

    def run(stacked: Sequence[torch.Tensor], h0: torch.Tensor, *bargs):
        h = h0
        for i in range(len(stacked)):
            h = ap(stacked[i], h, *bargs)
        return h
    return run
