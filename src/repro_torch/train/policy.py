"""Per-(architecture × mesh) ZeRO++ policy: a thin preset over ``tune``.

Port of the reference's ``train/policy.make_policy``: the decision logic
lives in ``repro_torch.tune.resolve`` (the one owner of ZeRO++
configuration); :func:`make_policy` runs it in ``mode="off"`` (the static
preset table: no probe, no ledger) and wraps the result in
:class:`Policy`.  The preset rules:

  * models under ``LARGE_PARAMS``: full ZeRO++ with the secondary
    partition on the fast ``model`` axis (the paper's per-node group),
    fp32 Adam moments, no accumulation;
  * large models: on a ``("pod", "data", "model")`` mesh the secondary
    group widens to one pod (``("data", "model")``), on one pod hpZ is
    off; the Adam moments are stored bf16 (the update's arithmetic stays
    fp32); models with >= 70B active parameters take 2 microbatches
    (``train_accum``, reported: the launcher's ``--accum`` sets the run's).

``variant`` selects the paper's ablations (Fig. 13): "baseline" is plain
ZeRO-3, "qwz"/"hpz"/"qgz" enable exactly one technique.  Keyword
overrides of ``ZeroConfig`` fields win (the paper's knobs
``qwz_blocked``, ``hpz_axes``, ``qgz_bits``, ``qgz_2hop``, tests, the
ring depth ``prefetch``).  ``mesh`` (``repro_torch.launch.mesh.Mesh``),
the port's addition, is the run's world: its groups become the config's
``intra_group`` (``model``), ``inter_group`` (every other axis) and,
where hpZ's axes are wider than ``model``, ``secondary_group`` (none at
world 1); ``group``, the whole world, stays the default group.

For measurement-driven resolution (``--tune static|probe``) call
``repro_torch.tune.resolve`` directly: it returns a ``ResolvedPolicy``
with these fields and the profile, the HBM ledger and ``explain()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.zeropp import ZeroConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.tune.resolve import LARGE_PARAMS, count_params, resolve

__all__ = ["LARGE_PARAMS", "VARIANTS", "Policy", "count_params",
           "make_policy"]

VARIANTS = ("zeropp", "baseline", "qwz", "hpz", "qgz")


@dataclasses.dataclass(frozen=True)
class Policy:
    zcfg: ZeroConfig
    n_params: int
    moments_dtype: torch.dtype = torch.float32
    note: str = ""
    train_accum: int = 1   # gradient-accumulation microbatches (memory knob)


def make_policy(arch: ArchConfig,
                mesh_axes: Tuple[str, ...] = ("data", "model"),
                variant: str = "zeropp", mesh: Optional[Mesh] = None,
                **overrides) -> Policy:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    rp = resolve(arch, tuple(mesh_axes), variant, mode="off", mesh=mesh,
                 overrides=overrides)
    return Policy(zcfg=rp.zcfg, n_params=rp.n_params,
                  moments_dtype=rp.moments_dtype, note=rp.note,
                  train_accum=rp.train_accum)
