"""Decoder blocks: training, prefill, decode and paged serving.

Port of the reference's ``models/transformer.py`` for the block kinds
``attn`` (global causal attention), ``local`` (sliding-window attention
over ``cfg.window`` positions), ``moe`` (global causal attention and a
mixture-of-experts MLP, driven by the Model: :func:`moe_pre_block` here,
the routed experts in ``Model._moe_layer``; its decode cache is
``attn``'s), ``ssd`` (a Mamba-2 block: its input projection, the causal
conv over x, B and C, the SSD scan and the gated norm; no separate MLP)
and ``rec`` (a Griffin recurrent block: the RG-LRU under a tanh-gelu
gate, then the dense MLP).  An ``ssd`` or ``rec`` layer's decode cache is
its recurrent state ``h`` (fp32) and the conv's last ``conv_width - 1``
inputs ``conv`` (compute dtype); training and prefill scan the sequence
(``models/ssm.py``; under a sharded sequence each rank's state and conv
history come from the ranks before it), prefill hands on the last
shard's state and history (:func:`last_shard_value`), decode steps the
recurrence one token and updates the cache in place.  Parameter entries
(same names, shapes and order, so the flat layout matches; the
``bq``/``bk``/``bv``
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
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as cl
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib


KINDS = ("attn", "local", "moe", "ssd", "rec")


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


def _attn_entries(cfg: ArchConfig, pre: str
                  ) -> List[Tuple[str, Tuple[int, ...]]]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    e = [(pre + "ln1", (d,)),
         (pre + "wq", (d, H * hd)), (pre + "wk", (d, K * hd)),
         (pre + "wv", (d, K * hd)), (pre + "wo", (H * hd, d))]
    if cfg.qkv_bias:
        e += [(pre + "bq", (H * hd,)), (pre + "bk", (K * hd,)),
              (pre + "bv", (K * hd,))]
    if cfg.qk_norm:
        e += [(pre + "qn", (hd,)), (pre + "kn", (hd,))]
    return e


def _mlp_entries(cfg: ArchConfig, pre: str
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    d = cfg.d_model
    return [(pre + "ln2", (d,)), (pre + "wgu", (d, 2 * cfg.d_ff)),
            (pre + "wdn", (cfg.d_ff, d))]


def _ssd_entries(cfg: ArchConfig, pre: str
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    return [(pre + "ln", (d,)),
            (pre + "inp", (d, 2 * di + 2 * gn + nh)),
            (pre + "cw", (cfg.conv_width, cfg.conv_dim)),
            (pre + "alog", (nh,)), (pre + "dskip", (nh,)),
            (pre + "dtb", (nh,)),
            (pre + "onrm", (di,)), (pre + "outp", (di, d))]


def _rec_entries(cfg: ArchConfig, pre: str
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    d, dr = cfg.d_model, cfg.d_rnn
    return [(pre + "ln1", (d,)),
            (pre + "px", (d, dr)), (pre + "pg", (d, dr)),
            (pre + "cw", (cfg.conv_width, dr)),
            (pre + "wa", (dr, dr)), (pre + "ba", (dr,)),
            (pre + "wx", (dr, dr)), (pre + "bx", (dr,)),
            (pre + "loga", (dr,)),
            (pre + "po", (dr, d))] + _mlp_entries(cfg, pre)


def block_entries(cfg: ArchConfig, kind: str, pre: str
                  ) -> List[Tuple[str, Tuple[int, ...]]]:
    """Parameter entries of one block, in the reference's order: ``attn``
    and ``local`` hold the same weights, ``moe`` the attention's, then its
    router and shared experts; ``ssd`` and ``rec`` their mixers' (``rec``
    then the MLP's)."""
    if kind in ("attn", "local"):
        return _attn_entries(cfg, pre) + _mlp_entries(cfg, pre)
    if kind == "moe":
        return _attn_entries(cfg, pre) + _moe_entries(cfg, pre)
    if kind == "ssd":
        return _ssd_entries(cfg, pre)
    if kind == "rec":
        return _rec_entries(cfg, pre)
    raise ValueError(f"unknown block kind {kind!r}")


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


def _chunk_for(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk (the SSD chunk must tile S)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


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


def _conv(cfg: ArchConfig, w: torch.Tensor, x: torch.Tensor, rs: RunSpec,
          cache):
    """The block's causal conv over x (B, S, C) and its new history: from
    the cache's in decode, else from the previous sequence shard's
    tail."""
    if rs.mode == "decode":
        return nn.causal_conv1d(x, w, cache["conv"])
    halo = ssm_lib.gather_conv_halo(x, cfg.conv_width - 1, rs.seq_axes,
                                    rs.seq_group)
    return nn.causal_conv1d(x, w, halo)


def _state_cache(rs: RunSpec, cache, h_new: torch.Tensor,
                 conv: torch.Tensor, h_fin: torch.Tensor):
    """The recurrent cache after the block: decode writes the new state
    and conv history into ``cache`` in place; prefill hands on the last
    sequence shard's; training keeps none."""
    if rs.mode == "decode":
        cache["h"].copy_(h_new)
        cache["conv"].copy_(conv)
        return cache
    if rs.mode == "prefill":
        return {"h": last_shard_value(h_fin, rs.seq_axes, rs.seq_group),
                "conv": last_shard_value(conv, rs.seq_axes, rs.seq_group)}
    return None


def _ssd_block(cfg: ArchConfig, p, h: torch.Tensor, rs: RunSpec, cache):
    """Mamba-2 mixer; returns (mix_out, new_cache)."""
    B, S, _ = h.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    hn = nn.rms_norm(h, p["ln"])
    z, xBC, dt_raw = torch.split(hn @ p["inp"], [di, cfg.conv_dim, nh],
                                 dim=-1)
    # x (di), B (G·N) and C (G·N) pass through the causal conv together
    y_c, conv = _conv(cfg, p["cw"], xBC, rs, cache)
    x, Bm, Cm = torch.split(F.silu(y_c), [di, G * N, G * N], dim=-1)
    x = x.reshape(B, S, nh, hp)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dtb"].to(torch.float32))
    A = -torch.exp(p["alog"])
    h_new = h_fin = None
    if rs.mode == "decode":
        y, h_new = ssm_lib.ssd_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                    cache["h"])
        y = y[:, None]
    else:
        h0 = cache["h"] if cache and "h" in cache else None
        y, h_fin = ssm_lib.ssd_scan(x, dt, A, Bm, Cm,
                                    chunk=_chunk_for(S, cfg.ssm_chunk),
                                    h0=h0, seq_axes=rs.seq_axes,
                                    seq_group=rs.seq_group)
    new_cache = _state_cache(rs, cache, h_new, conv, h_fin)
    y = y + p["dskip"].to(torch.float32)[:, None] * x.to(torch.float32)
    y = y.reshape(B, S, di).to(h.dtype)
    y = nn.rms_norm(y * F.silu(z), p["onrm"])
    return y @ p["outp"], new_cache


def _rec_block(cfg: ArchConfig, p, h: torch.Tensor, rs: RunSpec, cache):
    """RG-LRU mixer under its gelu gate; returns (mix_out, new_cache)."""
    hn = nn.rms_norm(h, p["ln1"])
    xc, conv = _conv(cfg, p["cw"], hn @ p["px"], rs, cache)
    gate = hn @ p["pg"]
    r = torch.sigmoid(xc @ p["wa"] + p["ba"])
    i = torch.sigmoid(xc @ p["wx"] + p["bx"])
    h_new = h_fin = None
    if rs.mode == "decode":
        y, h_new = ssm_lib.rglru_step(xc[:, 0], r[:, 0], i[:, 0], p["loga"],
                                      cache["h"])
        y = y[:, None]
    else:
        h0 = cache["h"] if cache and "h" in cache else None
        y, h_fin = ssm_lib.rglru_scan(xc, r, i, p["loga"], h0=h0,
                                      seq_axes=rs.seq_axes,
                                      seq_group=rs.seq_group)
    new_cache = _state_cache(rs, cache, h_new, conv, h_fin)
    return (y * F.gelu(gate, approximate="tanh")) @ p["po"], new_cache


def apply_block(cfg: ArchConfig, kind: str, p, h: torch.Tensor, rs: RunSpec,
                pos, cache):
    """One ``attn``, ``local``, ``ssd`` or ``rec`` block with residuals;
    returns (h, new_cache).  ``moe`` blocks are driven by the Model
    (:func:`moe_pre_block`, the expert chunks, the combine)."""
    if kind in ("attn", "local"):
        mix, new_cache = _attn_block(cfg, kind, p, h, rs, pos, cache)
        h = h + mix
        return h + _mlp_block(cfg, p, h), new_cache
    if kind == "ssd":
        mix, new_cache = _ssd_block(cfg, p, h, rs, cache)
        return h + mix, new_cache
    if kind == "rec":
        mix, new_cache = _rec_block(cfg, p, h, rs, cache)
        h = h + mix
        return h + _mlp_block(cfg, p, h), new_cache
    if kind == "moe":
        raise ValueError("moe blocks run through Model._moe_layer")
    raise ValueError(f"unknown block kind {kind!r}")


class CacheLeaf(NamedTuple):
    """One decode-cache tensor's shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_shapes(cfg: ArchConfig, kind: str, batch: int,
                      kv_len: int, kv_world: int = 1,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, CacheLeaf]:
    """Per-layer decode-cache leaves of a block on one rank of a cache
    sequence sharded ``kv_world`` ways: K/V of ``kv_len`` slots for
    ``attn`` (and ``moe``), the ring's ``min(window, kv_len)`` for
    ``local``, each cut into ``kv_world`` equal slices (refused where they
    do not divide), in ``dtype``; an ``ssd`` or ``rec`` layer's state
    ``h`` in fp32 and conv history ``conv`` in ``dtype``, whole on every
    kv rank."""
    if kind == "ssd":
        return {"h": CacheLeaf((batch, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_headdim), torch.float32),
                "conv": CacheLeaf((batch, cfg.conv_width - 1, cfg.conv_dim),
                                  dtype)}
    if kind == "rec":
        return {"h": CacheLeaf((batch, cfg.d_rnn), torch.float32),
                "conv": CacheLeaf((batch, cfg.conv_width - 1, cfg.d_rnn),
                                  dtype)}
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    n = min(cfg.window, kv_len) if kind == "local" else kv_len
    if n % kv_world:
        raise ValueError(f"{kind} cache of {n} slots does not divide over "
                         f"the {kv_world}-way kv sharding")
    s = CacheLeaf((batch, n // kv_world, cfg.n_kv_heads, cfg.d_head), dtype)
    return {"k": s, "v": s}
