"""Boot-time mesh probe: measure what the interconnect delivers.

Port of the reference's ``tune/probe.py``.  ZeRO++'s knobs (qwZ/qgZ
block sizes, hpZ placement, the prefetch ring's depth) pay only where the
tiers' bandwidths justify them, and those are a property of the
deployment, not of the code:

  * :func:`probe_mesh` times small real collectives over each axis of the
    live world (an all-gather and an all-to-all at three sizes each) and
    fits a per-tier ``t = latency + bytes / bandwidth`` model;
  * :func:`static_profile` loads the committed
    ``profiles/static_h100.json`` instead of timing: the deterministic
    ``--tune static`` mode, whose numbers are a DGX H100 cluster's
    published link rates (its ``description`` names them and the
    assumptions beside them).

Where the port departs from the reference: the reference times each
collective in one process; here every rank times its own, and every rank
must resolve the same policy (else the next collective deadlocks or
mismatches), so each point's best-of-``iters`` time is the MAX over the
world (one all-reduce a point) before the fit, which is then the same on
every rank.  The per-axis groups the probe times over are the mesh's:
``launch.mesh.make_mesh(axis_groups=True)`` builds one over each single
axis, on every rank in the same order (``new_group`` is collective).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_PROFILE_DIR = os.path.join(os.path.dirname(__file__), "profiles")
STATIC_PROFILE_PATH = os.path.join(_PROFILE_DIR, "static_h100.json")

# Fit clamps: a probe on a shared host can time degenerate points (zero
# variance, a negative slope); the resolver must still get a usable
# positive model out.
_MIN_BW = 1e6      # 1 MB/s floor
_MAX_BW = 1e15     # an effectively free tier (size-1 axes)


@dataclasses.dataclass(frozen=True)
class TierProfile:
    """Fitted alpha/beta collective cost model of one mesh-axis tier."""

    latency_s: float       # alpha: fixed per-collective cost
    bandwidth_Bps: float   # 1/beta: per-device wire bytes per second

    def time_s(self, wire_bytes: float) -> float:
        return self.latency_s + wire_bytes / self.bandwidth_Bps


@dataclasses.dataclass(frozen=True)
class ProbeProfile:
    """Per-tier collective cost model of one mesh: ``tiers`` maps each
    axis name to its :class:`TierProfile`; ``source`` says where the
    numbers come from ("probe": timed on the live world, "static": the
    committed profile)."""

    source: str
    mesh_axes: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    tiers: Dict[str, TierProfile]

    def fast_bw(self, intra_axis: str = "model") -> float:
        """Bandwidth of the fast (intra) tier."""
        t = self.tiers.get(intra_axis)
        return t.bandwidth_Bps if t else _MAX_BW

    def slow_bw(self, inter_axes: Sequence[str] = ()) -> float:
        """Bandwidth of the slowest tier a collective over ``inter_axes``
        touches; every tier when no axes are given."""
        axes = tuple(inter_axes) or tuple(self.tiers)
        bws = [self.tiers[a].bandwidth_Bps for a in axes if a in self.tiers]
        return min(bws) if bws else _MAX_BW

    def coll_latency(self, axes: Sequence[str] = ()) -> float:
        """Per-collective fixed cost over ``axes`` (the worst tier)."""
        names = tuple(axes) or tuple(self.tiers)
        lats = [self.tiers[a].latency_s for a in names if a in self.tiers]
        return max(lats) if lats else 0.0

    def to_json(self) -> Dict:
        return {
            "source": self.source,
            "mesh_axes": list(self.mesh_axes),
            "mesh_shape": list(self.mesh_shape),
            "tiers": {a: {"latency_s": t.latency_s,
                          "bandwidth_Bps": t.bandwidth_Bps}
                      for a, t in self.tiers.items()},
        }

    @classmethod
    def from_json(cls, d: Dict) -> "ProbeProfile":
        return cls(
            source=d["source"],
            mesh_axes=tuple(d["mesh_axes"]),
            mesh_shape=tuple(d["mesh_shape"]),
            tiers={a: TierProfile(float(t["latency_s"]),
                                  float(t["bandwidth_Bps"]))
                   for a, t in d["tiers"].items()},
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "ProbeProfile":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def for_mesh(self, mesh_axes: Sequence[str],
                 mesh_shape: Sequence[int]) -> "ProbeProfile":
        """This profile re-keyed onto another mesh's axes: known axes keep
        their numbers, unknown names take the 'data' tier, size-1 axes
        (no traffic) the free tier."""
        fallback = self.tiers.get("data") or next(iter(self.tiers.values()))
        tiers = {}
        for a, g in zip(mesh_axes, mesh_shape):
            if g <= 1:
                tiers[a] = TierProfile(0.0, _MAX_BW)
            else:
                tiers[a] = self.tiers.get(a, fallback)
        return ProbeProfile(self.source, tuple(mesh_axes), tuple(mesh_shape),
                            tiers)


def static_profile(mesh_axes: Sequence[str] = ("pod", "data", "model"),
                   mesh_shape: Optional[Sequence[int]] = None,
                   path: str = STATIC_PROFILE_PATH) -> ProbeProfile:
    """The committed deterministic profile, re-keyed for ``mesh_axes``
    (unknown sizes: every axis populated, size 2)."""
    base = ProbeProfile.load(path)
    if mesh_shape is None:
        mesh_shape = tuple(2 for _ in mesh_axes)
    return base.for_mesh(tuple(mesh_axes), tuple(mesh_shape))


# ---------------------------------------------------------------------------
# live probe
# ---------------------------------------------------------------------------

def _fit(points: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Least-squares ``t = alpha + bytes/bw`` over (wire_bytes, seconds)."""
    n = len(points)
    mx = sum(p[0] for p in points) / n
    mt = sum(p[1] for p in points) / n
    var = sum((x - mx) ** 2 for x, _ in points)
    slope = (sum((x - mx) * (t - mt) for x, t in points) / var) if var else 0.0
    slope = max(slope, 1.0 / _MAX_BW)
    alpha = max(mt - slope * mx, 0.0)
    bw = min(max(1.0 / slope, _MIN_BW), _MAX_BW)
    return alpha, bw


def _time_collective(group, g: int, n_local: int, iters: int, kind: str,
                     device: torch.device) -> float:
    """Best-of-``iters`` wall time of one collective of bf16 elements over
    ``group`` (``g`` ranks): an all-gather of ``n_local`` elements a rank,
    or an all-to-all of a (g, n_local) block (the same wire bytes).  The
    bf16 lanes cross as their raw bytes (int8), as the port's gathers send
    them: every backend takes int8."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if kind == "gather":
        x = torch.ones(2 * n_local, dtype=torch.int8, device=device)
        out = torch.empty(g * 2 * n_local, dtype=torch.int8, device=device)

        def op():
            dist.all_gather_into_tensor(out, x, group=group)
    else:
        x = torch.ones(g * 2 * n_local, dtype=torch.int8, device=device)
        out = torch.empty_like(x)

        def op():
            dist.all_to_all_single(out, x, group=group)
    op()                     # warm up (connections, buffers) off the clock
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        op()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _world_max(t: float) -> float:
    """``t`` maxed over every rank of the default group (one all-reduce):
    every rank fits the same points."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    buf = torch.tensor([t], dtype=torch.float64)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return float(buf[0])


def probe_mesh(mesh, sizes: Sequence[int] = (1 << 13, 1 << 15, 1 << 17),
               iters: int = 2, device="cpu") -> ProbeProfile:
    """Time small real collectives over each axis of ``mesh`` (a
    ``launch.mesh.Mesh``; every rank of its world calls this, in step)
    and fit per-tier costs.

    For every axis of size > 1 this times an all-gather and an
    all-to-all at each of ``sizes`` local bf16 elements on ``device``
    (gloo takes the card's tensors too), takes each point's best of
    ``iters`` maxed over the world, and least-squares-fits ``t = latency
    + wire_bytes / bandwidth``.  Size-1 axes carry no traffic and get the
    free tier.  The largest message is 256 KiB a rank."""
    dev = torch.device(device)
    names = tuple(mesh.axes)
    shape = tuple(int(s) for s in mesh.shape)
    tiers: Dict[str, TierProfile] = {}
    for axis, g in zip(names, shape):
        if g <= 1:
            tiers[axis] = TierProfile(0.0, _MAX_BW)
            continue
        group = mesh.group((axis,))
        pts = []
        for n_local in sizes:
            wire = 2.0 * n_local * (g - 1)   # bf16, per device, both kinds
            for kind in ("gather", "a2a"):
                t = _time_collective(group, g, n_local, iters, kind, dev)
                pts.append((wire, _world_max(t)))
        alpha, bw = _fit(pts)
        tiers[axis] = TierProfile(alpha, bw)
    return ProbeProfile("probe", names, shape, tiers)
