"""Serving steps: prefill and decode.

Port of the reference's ``train/serve.py`` ``build_prefill_step`` and
``build_decode_step`` for one device.
The reference wraps ``Model.prefill_fn``/``decode_fn`` in shard_map and
jit; here a step is the model call itself, run eagerly on the model's
device, and ``build_*_step`` fixes the run mode.  Parameters stay in their
flat ZeRO buffers and every layer group goes through the qwZ gather,
exactly as in the reference on a one-device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import platform
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunSpec


@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Callable
    run_spec: RunSpec


def _check_device(model: Model, device) -> None:
    dev = platform.resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"step built for {dev} but the model runs on "
                         f"{model.device}")


def build_prefill_step(model: Model, with_last_pos: bool = False,
                       device="cuda") -> ServeStep:
    """Prompt ingestion: (params, batch) -> (last-token logits, caches).

    With ``with_last_pos`` the step takes an extra (B,) int argument
    selecting each sequence's logits position — the last REAL token of a
    right-padded prompt (the engine's prompt-length buckets)."""
    _check_device(model, device)
    rs = RunSpec(mode="prefill")
    if with_last_pos:
        def fn(params, batch, last_pos):
            return model.prefill_fn(params, batch, rs, last_pos=last_pos)
    else:
        def fn(params, batch):
            return model.prefill_fn(params, batch, rs)
    return ServeStep(fn=fn, run_spec=rs)


def build_decode_step(model: Model, device="cuda") -> ServeStep:
    """One-token decode: (params, caches, batch, cache_pos) -> (logits,
    caches).  ``cache_pos`` is a PER-SEQUENCE (B,) vector, so one step
    serves any mix of in-flight requests.  The caches are updated in
    place."""
    _check_device(model, device)
    rs = RunSpec(mode="decode")

    def fn(params, caches, batch, cache_pos):
        return model.decode_fn(params, caches, batch, cache_pos, rs)
    return ServeStep(fn=fn, run_spec=rs)


def pad_prefill_caches(model: Model, caches, kv_len: int):
    """Grow prefill KV caches (length = prompt) to decode capacity.

    Full-attention (``attn``) caches use slot == position, so
    zero-padding the sequence dim to ``kv_len`` is exact: padded slots are
    masked out by decode_attend's position-validity test.  Ring buffers
    (``local`` layers) are already capacity-sized and stay as they are."""
    def grow(kind, cache, axis):
        if kind != "attn":
            return cache
        out = {}
        for key in ("k", "v"):
            arr = cache[key]
            pad = kv_len - arr.shape[axis]
            if pad > 0:
                widths = [0, 0] * (arr.dim() - axis)
                widths[-1] = pad
                arr = F.pad(arr, widths)
            out[key] = arr
        return out

    blocks = tuple(grow(kind, c, 2)              # (n_periods, B, S, K, hd)
                   for kind, c in zip(model.period, caches["blocks"]))
    rem = caches.get("rem")
    if rem is not None:
        rem = tuple(grow(kind, c, 1)             # (B, S, K, hd)
                    for kind, c in zip(model.rem_kinds, rem))
    return {"blocks": blocks, "rem": rem}
