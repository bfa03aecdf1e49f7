"""Per-(architecture × mesh) ZeRO++ policy: the reference's static preset.

Port of the reference's ``train/policy.make_policy`` (its resolver
``tune/resolve.py`` in mode ``"off"``) for models under ``LARGE_PARAMS``
on a ``("data", "model")`` or ``("pod", "data", "model")`` mesh: full
ZeRO++ over every axis, with the secondary partition on the fast
``model`` axis (the paper's per-node group; the reference widens it to a
pod only for large models); Adam moments are fp32 (``optim/adamw.py``)
and there is no gradient accumulation.  ``mesh``
(``repro_torch.launch.mesh.Mesh``) is the run's world: its groups become
the config's ``intra_group`` (``model``), ``inter_group`` (every other
axis) and, where ``hpz_axes`` is given, ``secondary_group`` (none at
world 1); ``group``, the whole world, stays the default group.
``variant`` selects the paper's ablations (Fig. 13): "baseline" is plain
ZeRO-3, "qwz"/"hpz"/"qgz" enable exactly one technique.  Keyword
overrides of ``ZeroConfig`` fields win (the paper's knobs
``qwz_blocked``, ``hpz_axes``, ``qgz_bits``, ``qgz_2hop``, tests, the
ring depth ``prefetch``: ``ZeroConfig``'s default 1 otherwise), as the
reference's convergence benchmark passes them.  The reference's
large-model rules (hpZ placement, bf16 moments, accumulation) and
``tune/`` are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.zeropp import ZeroConfig
from repro_torch.launch.mesh import Mesh

LARGE_PARAMS = 32e9
VARIANTS = ("zeropp", "baseline", "qwz", "hpz", "qgz")


@dataclasses.dataclass(frozen=True)
class Policy:
    zcfg: ZeroConfig
    n_params: int


def count_params(arch: ArchConfig) -> int:
    """Analytic parameter count (no devices touched)."""
    from repro_torch.models.model import Model
    return Model(arch, ZeroConfig.local(), device="cpu").n_params()


def make_policy(arch: ArchConfig,
                mesh_axes: Tuple[str, ...] = ("data", "model"),
                variant: str = "zeropp", mesh: Optional[Mesh] = None,
                **overrides) -> Policy:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    n = count_params(arch)
    if n >= LARGE_PARAMS:
        raise NotImplementedError(
            f"{n / 1e9:.0f}B params: the large-model preset (hpZ placement, "
            f"bf16 moments, accumulation) is not ported")
    kw = dict(qwz=variant in ("zeropp", "qwz"),
              hpz=variant in ("zeropp", "hpz"),
              qgz=variant in ("zeropp", "qgz"),
              dp_axes=tuple(mesh_axes), intra_axis="model")
    if mesh is not None:
        kw.update(intra_group=mesh.intra, inter_group=mesh.inter)
    kw.update(overrides)
    if mesh is not None and kw.get("hpz_axes") \
            and "secondary_group" not in overrides:
        kw["secondary_group"] = mesh.group(tuple(kw["hpz_axes"]))
    return Policy(zcfg=ZeroConfig(**kw), n_params=n)
