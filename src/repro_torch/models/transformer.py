"""Decoder blocks: training, prefill, decode and paged serving.

Port of the reference's ``models/transformer.py`` for the block kinds
``attn`` (global causal attention), ``local`` (sliding-window attention
over ``cfg.window`` positions) and ``moe`` (global causal attention and a
mixture-of-experts MLP, driven by the Model: :func:`moe_pre_block` here,
the routed experts in ``Model._moe_layer``; its decode cache is
``attn``'s): parameter entries (same names,
shapes and order, so the flat layout matches; the ``bq``/``bk``/``bv``
biases of ``cfg.qkv_bias`` after ``wo``), ``RunSpec``, the attention
half (biases added before the head split, ``cfg.logit_softcap`` on every
route) in its train/prefill, decode and paged branches (a ``local``
layer's decode cache is a ring buffer of ``min(window, kv_len)`` slots:
position t lives in slot t mod capacity, filled at prefill with the
prompt's last ``window`` positions; the paged branch serves ``attn``
layers, the only kind ``Model.paged_fn`` admits), the MLP half with its ``cfg.act`` gate,
``apply_block``, ``select_positions`` and ``last_shard_value``.  Training
and prefill may shard the sequence (``RunSpec.seq_axes``/``seq_group``,
``mha``'s KV gather); serving may shard the cache's sequence
(``RunSpec.kv_axes``/``kv_group``): a decode cache's slots (global
capacity S_loc × kv world, rank r owning slots [r·S_loc, (r+1)·S_loc)),
a paged arena's offsets within each page.  A prefill cache keeps the
activations' layout (kv_axes == seq_axes), a ``local`` ring built from
the sequence gathered over ``seq_axes``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as cl
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib


KINDS = ("attn", "local", "moe")


def _moe_entries(cfg: ArchConfig, pre: str
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """Router and shared experts only: the routed experts live in their
    own chunked groups (:func:`expert_entries`)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_ff
    e = [(pre + "ln2", (d,)), (pre + "router", (d, E))]
    if cfg.n_shared:
        e += [(pre + "sgu", (d, 2 * f * cfg.n_shared)),
              (pre + "sdn", (f * cfg.n_shared, d))]
    return e


def expert_entries(cfg: ArchConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """One expert CHUNK's parameters (n_experts / expert_chunks experts)."""
    d, f = cfg.d_model, cfg.moe_ff
    ec = cfg.n_experts // cfg.expert_chunks
    return [("egu", (ec, d, 2 * f)), ("edn", (ec, f, d))]


def block_entries(cfg: ArchConfig, kind: str, pre: str
                  ) -> List[Tuple[str, Tuple[int, ...]]]:
    """Parameter entries of one block, in the reference's order: ``attn``
    and ``local`` hold the same weights, ``moe`` the attention's, then its
    router and shared experts."""
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    e = [(pre + "ln1", (d,)),
         (pre + "wq", (d, H * hd)), (pre + "wk", (d, K * hd)),
         (pre + "wv", (d, K * hd)), (pre + "wo", (H * hd, d))]
    if cfg.qkv_bias:
        e += [(pre + "bq", (H * hd,)), (pre + "bk", (K * hd,)),
              (pre + "bv", (K * hd,))]
    if cfg.qk_norm:
        e += [(pre + "qn", (hd,)), (pre + "kn", (hd,))]
    if kind == "moe":
        return e + _moe_entries(cfg, pre)
    return e + [(pre + "ln2", (d,)), (pre + "wgu", (d, 2 * cfg.d_ff)),
                (pre + "wdn", (cfg.d_ff, d))]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Static run-mode description."""
    mode: str = "prefill"              # train | prefill | decode | paged
    seq_axes: Tuple[str, ...] = ()     # activation sequence sharding
    seq_group: Any = None              # the process group of seq_axes
    kv_axes: Tuple[str, ...] = ()      # cache sequence sharding
    kv_group: Any = None               # the process group of kv_axes
    attn_impl: str = "xla"             # xla | pallas (flash kernels B6/B7)


def _sub(p: Dict[str, torch.Tensor], pre: str) -> Dict[str, torch.Tensor]:
    n = len(pre)
    return {k[n:]: v for k, v in p.items() if k.startswith(pre)}


def _attn_block(cfg: ArchConfig, kind: str, p, h: torch.Tensor, rs: RunSpec,
                pos, cache):
    """Attention mixer (+ cache handling); returns (mix_out, new_cache)."""
    B, S, d = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hn = nn.rms_norm(h, p["ln1"])
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p["qn"])
        k = nn.rms_norm(k, p["kn"])
    cos, sin = pos["rope"]
    q = nn.apply_rope(q, cos, sin)
    k = nn.apply_rope(k, cos, sin)

    window = cfg.window if kind == "local" else 0
    if rs.mode == "paged":
        # the cache is a page arena shared by every row, addressed through
        # pos["page_table"]: insert the chunk's keys (the offsets this rank
        # owns: pos["write_plan"]), then attend causally at
        # pos["positions"] (decode T = 1, verify T = g + 1, prefill B = 1,
        # T = chunk); Model.paged_fn admits attn layers only
        kc, vc = attn.paged_insert(cache["k"], cache["v"], k, v,
                                   pos["positions"], pos["page_table"],
                                   plan=pos["write_plan"])
        o = attn.paged_attend(q, kc, vc, pos["positions"], pos["page_table"],
                              logit_softcap=cfg.logit_softcap,
                              kv_axes=rs.kv_axes, kv_group=rs.kv_group)
        new_cache = {"k": kc, "v": vc}
    elif rs.mode == "decode":
        # global slot t mod capacity: slot == position for a full cache
        # (t < kv_len), the ring of a local layer's window; this rank holds
        # the global slots [off, off + S_loc)
        world, s_loc, off = attn.kv_shard(rs.kv_axes, rs.kv_group,
                                          n_loc=cache["k"].shape[1])
        cap = s_loc * world                              # global capacity
        t = attn.per_seq_pos(pos["cache_pos"], B).to(h.device).long()
        slot = torch.remainder(t, cap)
        kc, vc = attn.cache_insert(cache["k"], cache["v"], k, v, slot, off)
        gslot = off + torch.arange(s_loc, device=h.device)
        spos = t[:, None] - torch.remainder(t[:, None] - gslot[None, :], cap)
        o = attn.decode_attend(q, kc, vc, t, window=window,
                               logit_softcap=cfg.logit_softcap,
                               slot_positions=spos, kv_axes=rs.kv_axes,
                               kv_group=rs.kv_group)
        new_cache = {"k": kc, "v": vc}
    else:
        o = attn.mha(q, k, v, seq_axes=rs.seq_axes, seq_group=rs.seq_group,
                     impl=rs.attn_impl, window=window,
                     logit_softcap=cfg.logit_softcap)
        new_cache = _build_prefill_cache(cfg, kind, k, v, rs) \
            if rs.mode == "prefill" else None
    o = o.reshape(B, S, H * hd) @ p["wo"]
    return o, new_cache


def _build_prefill_cache(cfg: ArchConfig, kind: str, k: torch.Tensor,
                         v: torch.Tensor, rs: RunSpec):
    """Prefill K/V (B, S_loc, K, hd) in the decode cache layout: for
    ``attn`` this rank's slice of the sequence as it stands (slot ==
    position; the cache inherits the activations' layout), for ``local``
    the ring of the last ``window`` positions of the sequence gathered over
    ``seq_axes``, of which this rank keeps its slice over ``kv_axes``: slot
    s holds position (S - 1) - ((S - 1 - s) mod window), the slot decode
    writes it to.  A prompt shorter than the window leaves slots of
    negative positions, which decode masks; the reference fills them with
    whatever its gather reads there (values of the prompt, or NaN below
    -S), here they are zeros, so a masked slot adds an exact 0."""
    if kind != "local":                   # attn, moe
        return {"k": k, "v": v}
    k = attn._gather_seq(k, rs.seq_axes, rs.seq_group)
    v = attn._gather_seq(v, rs.seq_axes, rs.seq_group)
    S, W = k.shape[1], cfg.window
    _, loc, off = attn.kv_shard(rs.kv_axes, rs.kv_group, n=W)
    slots = off + torch.arange(loc, device=k.device)
    src = (S - 1) - torch.remainder((S - 1) - slots, W)
    keep = (src >= 0)[None, :, None, None]
    idx = src.clamp(min=0)
    return {key: torch.where(keep, t[:, idx], 0)
            for key, t in (("k", k), ("v", v))}


def _mlp_block(cfg: ArchConfig, p, h: torch.Tensor) -> torch.Tensor:
    """Feed-forward half (dense, gated by ``cfg.act``)."""
    return nn.swiglu(nn.rms_norm(h, p["ln2"]), p["wgu"], p["wdn"],
                     act=cfg.act)


def select_positions(h: torch.Tensor, pos: torch.Tensor,
                     seq_axes: Sequence[str] = (),
                     seq_group: Any = None) -> torch.Tensor:
    """Per-sequence select h[b, pos[b], :] -> (B, 1, d): the last REAL
    token of each right-padded prompt, ``pos`` GLOBAL positions.  Under a
    sequence sharded over ``seq_axes`` each rank reads its own positions
    (zeros elsewhere) and the owner's value is summed over ``seq_group``
    in fp32 (exact: one value and zeros), as the reference psums its
    one-hot reduce."""
    S_loc = h.shape[1]
    rows = torch.arange(h.shape[0], device=h.device)
    idx = pos.to(h.device).long() - attn.seq_shard_offset(
        S_loc, seq_axes, seq_group)
    v = h[rows, idx.clamp(0, S_loc - 1)][:, None, :]
    if not seq_axes or cl.world_size(seq_group) == 1:
        return v
    mine = ((idx >= 0) & (idx < S_loc))[:, None, None]
    v = torch.where(mine, v.to(torch.float32), 0.0).contiguous()
    cl.all_reduce(v, seq_group)
    return v.to(h.dtype)


def last_shard_value(x: torch.Tensor, seq_axes: Sequence[str] = (),
                     seq_group: Any = None) -> torch.Tensor:
    """The LAST sequence shard's ``x`` on every rank of ``seq_group`` (the
    reference's ``_last_shard_value``: a psum of x times "am I last", here
    in fp32, exact); ``x`` itself unsharded."""
    w = cl.world_size(seq_group) if seq_axes else 1
    if w == 1:
        return x
    v = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if cl.flat_rank(seq_group) == w - 1:
        v.copy_(x)
    cl.all_reduce(v, seq_group)
    return v.to(x.dtype)


def moe_pre_block(cfg: ArchConfig, p, h: torch.Tensor, rs: RunSpec, pos,
                  cache):
    """An MoE layer up to (and excluding) the routed experts, all under
    the layer group's one gather: attention, the post-attention norm, the
    router logits and the shared experts.  Returns (h after attention,
    hn2 (B·S, d), router logits (B·S, E), shared_y (B, S, d), new cache)."""
    B, S, d = h.shape
    mix, new_cache = _attn_block(cfg, "moe", p, h, rs, pos, cache)
    h = h + mix
    hn2 = nn.rms_norm(h, p["ln2"]).reshape(B * S, d)
    logits = hn2 @ p["router"]
    if cfg.n_shared:
        shared_y = moe_lib.shared_ffn(hn2, p["sgu"], p["sdn"]).reshape(
            B, S, d)
    else:
        shared_y = torch.zeros_like(h)
    return h, hn2, logits, shared_y, new_cache


def apply_block(cfg: ArchConfig, kind: str, p, h: torch.Tensor, rs: RunSpec,
                pos, cache):
    """One ``attn`` or ``local`` block with residuals; returns (h,
    new_cache).  ``moe`` blocks are driven by the Model
    (:func:`moe_pre_block`, the expert chunks, the combine)."""
    if kind == "moe":
        raise ValueError("moe blocks run through Model._moe_layer")
    mix, new_cache = _attn_block(cfg, kind, p, h, rs, pos, cache)
    h = h + mix
    return h + _mlp_block(cfg, p, h), new_cache


def init_cache_shapes(cfg: ArchConfig, kind: str, batch: int,
                      kv_len: int, kv_world: int = 1
                      ) -> Dict[str, Tuple[int, ...]]:
    """Per-layer K/V cache shapes of a block on one rank of a cache
    sequence sharded ``kv_world`` ways: ``kv_len`` slots for ``attn``, the
    ring's ``min(window, kv_len)`` for ``local``, each cut into
    ``kv_world`` equal slices (refused where they do not divide); a
    ``moe`` layer's cache is ``attn``'s."""
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    n = min(cfg.window, kv_len) if kind == "local" else kv_len
    if n % kv_world:
        raise ValueError(f"{kind} cache of {n} slots does not divide over "
                         f"the {kv_world}-way kv sharding")
    s = (batch, n // kv_world, cfg.n_kv_heads, cfg.d_head)
    return {"k": s, "v": s}
