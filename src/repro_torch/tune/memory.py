"""HBM ledger: charge every persistent byte a policy implies.

Port of the reference's ``tune/memory.py``, line for line and byte for
byte (the resolver's walk-down must agree with the reference's).  The
depth-k prefetch ring holds k gathered layer buffers in flight and one
more being computed with, so a depth-k schedule holds **k+1** gathered
buffers a loop; the resolver trades ring depth against this ledger's
headroom instead of running out of memory at boot.

Line items (per device):

  master_params      fp32 master shard, the parameter buffer (4 B/param)
  adam_moments       two Adam moment shards (fp32: 8 B, bf16: 4 B /param)
  grad_shards        fp32 reduced-gradient shard live at the update
  hpz_secondary      bf16 secondary copy per hpZ group (2·M / |secondary|)
  ring_weights_*     (k+1) live gathered buffers per ring'd loop
  ring_grads_bwd     backward's k-slot unreduced-gradient ring
  gathered_transient largest single-shot gathered buffer (embed/rem/unemb)
  activations        residual-stream saves under remat (coarse)
  kv_pool            serve: the engine's KV slabs or page arena
  params_bf16        serve: the inference weight shard

Everything is analytic (no devices touched).  The charges are the
reference's, so they describe its schedule: the port's ring keeps an
in-flight qwZ gather as its INT8 payload (not a bf16 buffer) and starts
each layer's gradient reduce at once, hop by hop (not from a bf16 ring);
``testing/ring_probe.py`` counts the port's live buffers and chip_smoke
reads the allocator beside these lines.

The default budget: the reference's is a v5e's 16 GiB.  Here
:func:`device_budget` reads the card's memory and divides it by the ranks
that share it (every rank of a card world is on device 0);
``HBM_BYTES``, an H100 SXM's 80 GB, stands in where no card is visible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

GB = 1 << 30
# an NVIDIA H100 SXM's 80 GB of HBM3: the budget where no card is visible
HBM_BYTES = 80 * GB

_COMPUTE_BYTES = 2   # gathered weights / grads ride in bf16 (compute dtype)


def device_budget(device="cuda", ranks: int = 1) -> int:
    """The per-rank HBM budget on ``device``: the card's memory
    (``total_memory``) over the ``ranks`` that share it; ``HBM_BYTES``
    over them off the card."""
    dev = torch.device(device)
    total = (torch.cuda.get_device_properties(dev.index or 0).total_memory
             if dev.type == "cuda" else HBM_BYTES)
    return int(total) // max(int(ranks), 1)


@dataclasses.dataclass(frozen=True)
class LedgerLine:
    name: str
    bytes: int
    detail: str


@dataclasses.dataclass(frozen=True)
class HBMLedger:
    """An itemized per-device HBM bill against a budget; ``ring_buffers``
    is (loop name, live gathered-buffer count): the (k+1) contract the
    live-buffer checks compare."""

    lines: Tuple[LedgerLine, ...]
    budget_bytes: int
    ring_buffers: Tuple[Tuple[str, int], ...] = ()

    @property
    def total(self) -> int:
        return sum(l.bytes for l in self.lines)

    @property
    def headroom(self) -> int:
        return self.budget_bytes - self.total

    @property
    def fits(self) -> bool:
        return self.total <= self.budget_bytes

    def line(self, name: str) -> int:
        for l in self.lines:
            if l.name == name:
                return l.bytes
        return 0

    def explain(self) -> str:
        out = ["HBM ledger (per device):"]
        for l in self.lines:
            out.append(f"  {l.name:<20s} {l.bytes / GB:7.3f} GiB  {l.detail}")
        verdict = "fits" if self.fits else "OVER BUDGET"
        out.append(f"  {'total':<20s} {self.total / GB:7.3f} GiB  "
                   f"of {self.budget_bytes / GB:.1f} GiB budget -> {verdict} "
                   f"(headroom {self.headroom / GB:+.3f} GiB)")
        return "\n".join(out)

    def as_dict(self) -> Dict:
        return {
            "budget_bytes": self.budget_bytes,
            "total_bytes": self.total,
            "headroom_bytes": self.headroom,
            "fits": self.fits,
            "ring_buffers": dict(self.ring_buffers),
            "lines": {l.name: l.bytes for l in self.lines},
        }


def _group_size(mesh_sizes: Mapping[str, int], axes: Sequence[str]) -> int:
    g = 1
    for a in axes:
        g *= int(mesh_sizes.get(a, 1))
    return g


def ring_lines(model) -> Tuple[List[LedgerLine], List[Tuple[str, int]]]:
    """The prefetch-ring charge: (k+1) live gathered buffers per loop (k
    in flight, one computed with; the synchronous schedule's one), and
    the backward's k-slot ring of unreduced per-layer gradients (compute
    dtype), charged apart so that ``explain`` shows which phase owns the
    bytes."""
    z = model.zcfg
    lines: List[LedgerLine] = []
    rings: List[Tuple[str, int]] = []

    k = z.effective_prefetch(model.n_periods)
    P = model.period_spec.padded_size
    lines.append(LedgerLine(
        "ring_weights_layers", (k + 1) * _COMPUTE_BYTES * P,
        f"(k+1)={k + 1} live gathered layer buffers x {P:,} params bf16 "
        f"(k={k} ring slots + 1 read copy; layer scan)"))
    rings.append(("layers", k + 1))
    if k:
        lines.append(LedgerLine(
            "ring_grads_bwd", k * _COMPUTE_BYTES * P,
            f"backward k={k} unreduced per-layer gradient slots x "
            f"{P:,} params bf16"))

    if model.is_moe:
        kc = z.effective_prefetch(model.cfg.expert_chunks)
        E = model.expert_spec.padded_size
        lines.append(LedgerLine(
            "ring_weights_experts", (kc + 1) * _COMPUTE_BYTES * E,
            f"(k+1)={kc + 1} live gathered expert-chunk buffers x "
            f"{E:,} params bf16 (nested chunk scan)"))
        rings.append(("expert_chunks", kc + 1))
        if kc:
            lines.append(LedgerLine(
                "ring_grads_experts_bwd", kc * _COMPUTE_BYTES * E,
                f"backward kc={kc} unreduced expert-chunk gradient slots"))
    return lines, rings


def _transient_line(model) -> LedgerLine:
    """Largest single-shot (un-ring'd) gathered buffer."""
    singles = {"unemb_chunk": model.unemb_spec.padded_size,
               "head": model.head_spec.padded_size}
    if model.embed_spec is not None:
        singles["embed"] = model.embed_spec.padded_size
    if model.rem_spec is not None:
        singles["rem"] = model.rem_spec.padded_size
    worst = max(singles, key=lambda k: singles[k])
    return LedgerLine(
        "gathered_transient", _COMPUTE_BYTES * singles[worst],
        f"largest one-shot gathered buffer = {worst} "
        f"({singles[worst]:,} params bf16)")


def train_ledger(model, mesh_sizes: Mapping[str, int],
                 moments_itemsize: int = 4,
                 tokens_per_device: int = 2048,
                 accum: int = 1,
                 budget_bytes: int = HBM_BYTES) -> HBMLedger:
    """Per-device training HBM bill for ``model`` on a mesh of
    ``mesh_sizes`` ({axis: size}).  ``moments_itemsize`` is a moment
    element's size (4 fp32, 2 bf16); ``tokens_per_device`` the
    MICRObatch tokens one device holds activations for."""
    z = model.zcfg
    world = _group_size(mesh_sizes, mesh_sizes.keys())
    N = model.n_params()
    lines: List[LedgerLine] = [
        LedgerLine("master_params", 4 * N // world,
                   f"fp32 master shard: 4 B x {N / 1e9:.2f}B params "
                   f"/ {world} devices"),
        LedgerLine("adam_moments", 2 * moments_itemsize * N // world,
                   f"2 moment shards x {moments_itemsize} B/param"),
        LedgerLine("grad_shards", 4 * N // world,
                   "fp32 reduced-gradient shard live at the optimizer "
                   "update"),
    ]
    if z.hpz:
        sec = _group_size(mesh_sizes, z.secondary_axes)
        lines.append(LedgerLine(
            "hpz_secondary", _COMPUTE_BYTES * N // max(sec, 1),
            f"bf16 secondary copy over {z.secondary_axes} "
            f"(group size {sec})"))
    rlines, rings = ring_lines(model)
    lines += rlines
    lines.append(_transient_line(model))
    d = model.cfg.d_model
    layers = model.cfg.n_layers
    act = _COMPUTE_BYTES * tokens_per_device * d * (layers + 2)
    lines.append(LedgerLine(
        "activations", act,
        f"residual-stream saves under remat: {tokens_per_device} tok x "
        f"d_model {d} x ({layers}+2) layers bf16 x accum=1 microbatch "
        f"(accum={accum} shrinks tokens, not this term)"))
    return HBMLedger(tuple(lines), budget_bytes, tuple(rings))


def _cache_elems(shapes) -> List[int]:
    """Element counts of every leaf of ``Model.cache_shapes``."""
    out = []
    groups = list(shapes["blocks"]) + list(shapes["rem"] or ())
    for per in groups:
        for leaf in per.values():
            n = 1
            for s in leaf.shape:
                n *= int(s)
            out.append(n)
    return out


def serve_ledger(model, mesh_sizes: Mapping[str, int],
                 n_slots: int, kv_len: int,
                 cache_itemsize: int = 2,
                 budget_bytes: int = HBM_BYTES,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 kv_axes: Sequence[str] = ()) -> HBMLedger:
    """Per-device serving HBM bill: bf16 weight shard + KV pool + rings.

    With ``page_size`` set the KV line charges the paged arena: ``n_pages``
    pages (default: full capacity) of ``page_size`` positions, cut only
    over ``kv_axes`` (replicated over the other axes), plus the page table
    (``n_slots x kv_len/page_size`` int32).  Every cache leaf is charged
    at ``cache_itemsize``, as the reference charges it."""
    world = _group_size(mesh_sizes, mesh_sizes.keys())
    N = model.n_params()
    lines: List[LedgerLine] = [
        LedgerLine("params_bf16", _COMPUTE_BYTES * N // world,
                   f"bf16 inference weight shard / {world} devices"),
    ]
    if page_size is not None:
        if kv_len % page_size:
            raise ValueError(f"kv_len {kv_len} % page_size {page_size} != 0")
        pages_per_slot = kv_len // page_size
        if n_pages is None:
            n_pages = n_slots * pages_per_slot
        page_bytes = sum(n * cache_itemsize for n in
                         _cache_elems(model.cache_shapes(1, page_size)))
        kv_world = _group_size(mesh_sizes, kv_axes)
        table_bytes = n_slots * pages_per_slot * 4
        lines.append(LedgerLine(
            "kv_pool",
            (n_pages * page_bytes) // kv_world + table_bytes,
            f"{n_pages} pages x {page_size} positions KV / {kv_world} "
            f"kv-axis devices + {n_slots}x{pages_per_slot} int32 page "
            f"table"))
    else:
        kv_bytes = sum(n * cache_itemsize for n in
                       _cache_elems(model.cache_shapes(n_slots, kv_len)))
        lines.append(LedgerLine(
            "kv_pool", kv_bytes // world,
            f"{n_slots} slots x {kv_len} positions KV / {world} devices"))
    rlines, rings = ring_lines(model)
    # the serving loops ring the forward gathers only: no backward grads
    rlines = [l for l in rlines if "grads" not in l.name]
    rings = list(rings)
    lines += rlines
    lines.append(_transient_line(model))
    return HBMLedger(tuple(lines), budget_bytes, tuple(rings))
