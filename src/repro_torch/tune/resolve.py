"""The single owner of ZeRO++ configuration resolution.

Port of the reference's ``tune/resolve.py``.  Every consumer
(``train/policy.py``'s preset, ``launch/train.py --tune``,
``ServeEngine(tune=)``) funnels through :func:`resolve`, which turns
(ArchConfig, mesh, probe profile, HBM budget) into one frozen
:class:`ResolvedPolicy`.  Decision order (the reference's):

  1. variant   — the paper's ablation table sets the qwZ/hpZ/qgZ switches.
  2. hpZ       — preset placement (large models: secondary group widened
                 to one pod on a multi-pod mesh, off on one pod), then the
                 probe veto: no measurably slower inter tier => nothing
                 for hpZ's memory to buy back.
  3. blocks    — qwZ/qgZ block sizes from the slow tier's bandwidth
                 (scarce wire bytes => coarser blocks, fewer scale bytes;
                 plentiful => finer blocks, tighter quantization).
  4. overrides — explicit caller overrides win, always.
  5. moments / accum — the preset memory rules (bf16 moments and
                 microbatching for large / active-heavy models).
  6. prefetch  — ``break_even_depth`` fed with the profile's per-tier
                 latency and bandwidth, then walked DOWN until the HBM
                 ledger (which charges the (k+1) ring buffers) fits the
                 budget.  A tighter budget can only lower the depth.
  7. backend   — the kernels' route.

``mode="off"`` is the static preset table (no profile, no ledger), what
``train/policy.make_policy`` wraps.

Where the port departs from the reference:

  * ``mesh=`` is the port's ``launch.mesh.Mesh``: the sizes come from
    ``mesh.sizes``, and its groups become the config's ``intra_group``,
    ``inter_group`` and, where hpZ's axes are wider than ``model``,
    ``secondary_group`` (the reference's mesh needs no groups);
  * decision 7 reports the port's route, not a platform seam: "cuda"
    (the hand-written kernels) when ``device`` is the card, "plain" (their
    PyTorch versions) on the CPU;
  * the ring model is the port's copy (``tune/ring_model.py``, the H100's
    peak), always present.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.zeropp import ZeroConfig
from repro_torch.tune import memory as memory_lib
from repro_torch.tune import ring_model
from repro_torch.tune.probe import ProbeProfile, probe_mesh, static_profile

LARGE_PARAMS = 32e9

MODES = ("off", "static", "probe")

# Block-size thresholds (step 3): below _COARSE_BW the slow tier is so
# scarce that halving the scale overhead (4 B a block) wins; above
# _FINE_BW wire bytes are cheap and finer blocks buy quantization accuracy.
_COARSE_BW = 16e9
_FINE_BW = 100e9


def _model(arch, zcfg: ZeroConfig, world: int = 1):
    """An analytic model (specs only: nothing is allocated)."""
    from repro_torch.models.model import Model
    return Model(arch, zcfg, world=world, device="cpu")


def count_params(arch) -> int:
    """Analytic parameter count (no sharding, no devices)."""
    return _model(arch, ZeroConfig.local()).n_params()


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """One frozen, self-describing answer to 'how do we run this cell'."""

    zcfg: ZeroConfig
    moments_dtype: torch.dtype
    n_params: int
    train_accum: int
    kernel_backend: str
    mode: str                       # off | static | probe
    note: str                       # preset note (make_policy parity)
    decisions: Tuple[str, ...]      # human-readable, in decision order
    ledger: Optional[memory_lib.HBMLedger] = None
    profile: Optional[ProbeProfile] = None

    def explain(self) -> str:
        out = [f"resolved policy (mode={self.mode}, "
               f"profile={self.profile.source if self.profile else 'none'}, "
               f"kernel_backend={self.kernel_backend}):"]
        for i, d in enumerate(self.decisions, 1):
            out.append(f"  {i}. {d}")
        if self.ledger is not None:
            out.append(self.ledger.explain())
        return "\n".join(out)

    def as_dict(self) -> Dict:
        """Flat summary for obs metrics / BENCH snapshots."""
        z = self.zcfg
        d = {
            "mode": self.mode,
            "kernel_backend": self.kernel_backend,
            "n_params": self.n_params,
            "train_accum": self.train_accum,
            "moments_dtype": str(self.moments_dtype).removeprefix("torch."),
            "qwz": z.qwz, "hpz": z.hpz, "qgz": z.qgz,
            "qwz_block": z.qwz_block, "qgz_block": z.qgz_block,
            "hpz_axes": list(z.secondary_axes) if z.hpz else None,
            "prefetch": z.prefetch,
            "profile_source": self.profile.source if self.profile else None,
            "decisions": list(self.decisions),
        }
        if self.ledger is not None:
            d["ledger"] = self.ledger.as_dict()
        return d


def _resolve_profile(mode: str, mesh, mesh_axes: Sequence[str],
                     mesh_sizes: Optional[Mapping[str, int]],
                     profile: Optional[ProbeProfile],
                     device) -> Optional[ProbeProfile]:
    if profile is not None:
        if mesh_sizes:
            return profile.for_mesh(tuple(mesh_axes),
                                    tuple(mesh_sizes[a] for a in mesh_axes))
        return profile
    if mode == "off":
        return None
    if mode == "probe":
        if mesh is None:
            raise ValueError("mode='probe' needs the live mesh")
        return probe_mesh(mesh, device=device)
    if mode == "static":
        shape = tuple(mesh_sizes[a] for a in mesh_axes) if mesh_sizes \
            else None
        return static_profile(tuple(mesh_axes), shape)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _break_even_depth(n_dev_params: float, tokens_dev: int, variant: str,
                      n_layers: int, prof: ProbeProfile,
                      intra_axis: str, inter_axes: Sequence[str]) -> int:
    """Depth from the ring step-time model with the profile's
    coefficients."""
    return ring_model.break_even_depth(
        int(n_dev_params), tokens_dev, variant,
        slow_bw=prof.slow_bw(inter_axes),
        n_layers=max(n_layers, 2),
        latency=prof.coll_latency(),
        fast_bw=prof.fast_bw(intra_axis))


def resolve(
    arch,
    mesh_axes: Sequence[str],
    variant: str = "zeropp",       # zeropp | baseline | qwz | hpz | qgz
    *,
    mode: str = "off",
    mesh=None,
    mesh_sizes: Optional[Mapping[str, int]] = None,
    profile: Optional[ProbeProfile] = None,
    hbm_budget_bytes: int = memory_lib.HBM_BYTES,
    tokens_per_device: int = 2048,
    workload: str = "train",       # train | serve
    n_slots: int = 8,
    kv_len: int = 2048,
    overrides: Optional[Dict] = None,
    device="cuda",
) -> ResolvedPolicy:
    """Resolve every ZeRO++ knob for an (arch, mesh) cell (the decision
    order is the module docstring's).

    ``mesh_sizes`` ({axis: size}; from ``mesh`` where given) enables the
    HBM ledger and the depth-vs-headroom trade; without it only the
    profile-informed decisions apply.  ``mesh`` (a ``launch.mesh.Mesh``)
    is the live world: the probe times its groups, and its groups join
    the config.  ``overrides`` are explicit ZeroConfig field overrides
    and always win.  ``device`` is where the run's kernels go (decision
    7; the probe's tensors)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    overrides = dict(overrides or {})
    mesh_axes = tuple(mesh_axes)
    if mesh_sizes is None and mesh is not None:
        mesh_sizes = dict(mesh.sizes)
    prof = _resolve_profile(mode, mesh, mesh_axes, mesh_sizes, profile,
                            device)
    decisions = []

    n = count_params(arch)
    large = n >= LARGE_PARAMS
    multi_pod = "pod" in mesh_axes

    # -- 1. variant table ---------------------------------------------------
    on = dict(qwz=variant in ("zeropp", "qwz"),
              hpz=variant in ("zeropp", "hpz"),
              qgz=variant in ("zeropp", "qgz"))
    decisions.append(f"variant={variant}: qwz={on['qwz']} hpz={on['hpz']} "
                     f"qgz={on['qgz']} (paper ablation table)")

    # -- 2. hpZ placement ---------------------------------------------------
    hpz_axes: Optional[Tuple[str, ...]] = None
    # the preset's note is the reference's word for word (make_policy
    # parity): its 16 GB is the HBM that preset was sized for
    note = ""
    if on["hpz"] and large:
        if multi_pod:
            hpz_axes = ("data", "model")   # secondary group = one pod
            note = (f"{n/1e9:.0f}B params: node-sized secondary copy "
                    f"(2M/16) exceeds 16 GB HBM; secondary group widened to "
                    f"one pod (2M/256) — kills cross-pod weight traffic")
        else:
            on["hpz"] = False
            note = (f"{n/1e9:.0f}B params on single-pod mesh: hpZ off "
                    f"(no slower tier to trade memory against; paper's "
                    f"Table 4 shows the same memory wall for MiCS)")
    if note:
        decisions.append(f"hpz preset: {note}")
    intra_axis = "model"
    if on["hpz"] and prof is not None:
        sec_axes = hpz_axes or (intra_axis,)
        inter = tuple(a for a in mesh_axes if a not in sec_axes)
        fast, slow = prof.fast_bw(intra_axis), prof.slow_bw(inter)
        if not inter or slow >= fast:
            on["hpz"] = False
            hpz_axes = None
            decisions.append(
                f"hpz probe veto: no inter tier slower than the fast tier "
                f"(slow {slow/1e9:.1f} GB/s >= fast {fast/1e9:.1f} GB/s) — "
                f"secondary copy would buy nothing")
        else:
            decisions.append(
                f"hpz on over {sec_axes}: probed inter tier "
                f"{slow/1e9:.1f} GB/s << fast {fast/1e9:.1f} GB/s")

    # -- 3. quant block sizes ----------------------------------------------
    qwz_block = qgz_block = 256
    if prof is not None:
        inter = tuple(a for a in mesh_axes if a != intra_axis)
        slow = prof.slow_bw(inter or mesh_axes)
        if slow < _COARSE_BW:
            qwz_block = qgz_block = 512
            decisions.append(
                f"blocks=512: slow tier {slow/1e9:.1f} GB/s < "
                f"{_COARSE_BW/1e9:.0f} GB/s — halve the per-block fp32 "
                f"scale overhead on the wire")
        elif slow >= _FINE_BW:
            qwz_block = qgz_block = 128
            decisions.append(
                f"blocks=128: slow tier {slow/1e9:.1f} GB/s >= "
                f"{_FINE_BW/1e9:.0f} GB/s — wire bytes are cheap, buy "
                f"quantization accuracy")
        else:
            decisions.append(
                f"blocks=256 (default): slow tier {slow/1e9:.1f} GB/s in "
                f"the balanced regime")

    kw = dict(
        qwz=on["qwz"], hpz=on["hpz"], qgz=on["qgz"],
        hpz_axes=hpz_axes,
        dp_axes=mesh_axes,
        intra_axis=intra_axis,
    )
    if prof is not None:
        kw.update(qwz_block=qwz_block, qgz_block=qgz_block)

    # -- 4. explicit overrides win -----------------------------------------
    if overrides:
        decisions.append(f"caller overrides: {sorted(overrides)}")
        kw.update(overrides)
    if mesh is not None:
        # the live world's groups (not a decision: the same cell anywhere)
        kw.setdefault("intra_group", mesh.intra)
        kw.setdefault("inter_group", mesh.inter)
        if kw.get("hpz_axes") and "secondary_group" not in kw:
            kw["secondary_group"] = mesh.group(tuple(kw["hpz_axes"]))
    zcfg = ZeroConfig(**kw)

    # -- 5. moments dtype + accumulation (preset memory rules) -------------
    moments = torch.bfloat16 if large else torch.float32
    # microbatching keys on ACTIVE params (a 235B MoE with 22B active has
    # dense-4B-scale activations and fits at accum=1; accum multiplies
    # the weight-gather volume, so never more than memory requires)
    n_active = _model(arch, zcfg).n_active_params()
    accum = 2 if n_active >= 70e9 else 1
    if mode != "off":
        decisions.append(
            f"moments={'bf16' if large else 'fp32'}, accum={accum} "
            f"(preset memory rules: {n/1e9:.1f}B total, "
            f"{n_active/1e9:.1f}B active)")

    # -- 6. prefetch depth: break-even, then walk down into the budget -----
    ledger = None
    if prof is not None and mesh_sizes:
        world = 1
        for a in mesh_axes:
            world *= int(mesh_sizes[a])
        model = _model(arch, zcfg, world)
        micro_tokens = max(tokens_per_device // max(accum, 1), 1)
        m_bytes = torch.finfo(moments).bits // 8

        def _ledger(depth: int) -> memory_lib.HBMLedger:
            m = model.with_prefetch(depth)
            if workload == "serve":
                return memory_lib.serve_ledger(
                    m, mesh_sizes, n_slots=n_slots, kv_len=kv_len,
                    budget_bytes=hbm_budget_bytes)
            return memory_lib.train_ledger(
                m, mesh_sizes, moments_itemsize=m_bytes,
                tokens_per_device=micro_tokens, accum=accum,
                budget_bytes=hbm_budget_bytes)

        if "prefetch" in overrides:
            depth = zcfg.prefetch
            decisions.append(f"prefetch={depth}: pinned by caller override")
        else:
            inter = tuple(a for a in mesh_axes if a != intra_axis)
            tok = n_slots if workload == "serve" else tokens_per_device
            depth = _break_even_depth(n / world, tok, variant,
                                      model.n_periods, prof, intra_axis,
                                      inter)
            decisions.append(
                f"prefetch break-even depth={depth}: ring model with "
                f"probed slow {prof.slow_bw(inter)/1e9:.1f} GB/s, "
                f"latency {prof.coll_latency()*1e6:.0f} us, "
                f"{model.n_periods} scan steps, {tok} tokens/dev")
            while depth > 0 and not _ledger(depth).fits:
                depth -= 1
            led = _ledger(depth)
            if depth != zcfg.prefetch or not led.fits:
                decisions.append(
                    f"prefetch={depth} after HBM ledger walk-down: "
                    f"(k+1) ring buffers charged against "
                    f"{hbm_budget_bytes / memory_lib.GB:.1f} GiB budget "
                    f"({'fits' if led.fits else 'still over at depth 0'})")
            zcfg = dataclasses.replace(zcfg, prefetch=depth)
        ledger = _ledger(zcfg.prefetch)

    # -- 7. kernel route ----------------------------------------------------
    on_card = torch.device(device).type == "cuda"
    kernel_backend = "cuda" if on_card else "plain"
    if mode != "off":
        decisions.append(
            f"kernel_backend={kernel_backend} (the port's route: "
            f"{'the hand-written Hopper kernels' if on_card else 'their plain PyTorch versions'}"
            f", kernels/platform.py)")

    return ResolvedPolicy(
        zcfg=zcfg, moments_dtype=moments, n_params=n, train_accum=accum,
        kernel_backend=kernel_backend, mode=mode, note=note,
        decisions=tuple(decisions), ledger=ledger, profile=prof)
