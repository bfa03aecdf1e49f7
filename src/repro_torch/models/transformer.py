"""Decoder blocks: training, prefill and decode.

Port of the reference's ``models/transformer.py`` for dense ``attn``
blocks: parameter entries (same names, shapes and order, so the flat
layout matches), ``RunSpec``, the attention half in its train/prefill and
decode branches, the MLP half, ``apply_block`` and
``select_positions``.  One device: no sequence or KV sharding, so the
reference's ``_last_shard_value`` (replicate the last sequence shard's
value) is the identity and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn


def block_entries(cfg: ArchConfig, pre: str
                  ) -> List[Tuple[str, Tuple[int, ...]]]:
    """Parameter entries of one ``attn`` block, in the reference's order."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    e = [(pre + "ln1", (d,)),
         (pre + "wq", (d, H * hd)), (pre + "wk", (d, K * hd)),
         (pre + "wv", (d, K * hd)), (pre + "wo", (H * hd, d))]
    if cfg.qk_norm:
        e += [(pre + "qn", (hd,)), (pre + "kn", (hd,))]
    return e + [(pre + "ln2", (d,)), (pre + "wgu", (d, 2 * cfg.d_ff)),
                (pre + "wdn", (cfg.d_ff, d))]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Static run-mode description."""
    mode: str = "prefill"              # train | prefill | decode
    attn_impl: str = "xla"             # xla | pallas (flash kernels B6/B7)


def _sub(p: Dict[str, torch.Tensor], pre: str) -> Dict[str, torch.Tensor]:
    n = len(pre)
    return {k[n:]: v for k, v in p.items() if k.startswith(pre)}


def _attn_block(cfg: ArchConfig, p, h: torch.Tensor, rs: RunSpec, pos,
                cache):
    """Attention mixer (+ cache handling); returns (mix_out, new_cache)."""
    B, S, d = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hn = nn.rms_norm(h, p["ln1"])
    q = (hn @ p["wq"]).reshape(B, S, H, hd)
    k = (hn @ p["wk"]).reshape(B, S, K, hd)
    v = (hn @ p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p["qn"])
        k = nn.rms_norm(k, p["kn"])
    cos, sin = pos["rope"]
    q = nn.apply_rope(q, cos, sin)
    k = nn.apply_rope(k, cos, sin)

    if rs.mode == "decode":
        # full-attention cache: slot == position
        t = pos["cache_pos"]
        kc, vc = attn.cache_insert(cache["k"], cache["v"], k, v, t)
        o = attn.decode_attend(q, kc, vc, t)
        new_cache = {"k": kc, "v": vc}
    else:
        o = attn.mha(q, k, v, impl=rs.attn_impl)
        new_cache = {"k": k, "v": v} if rs.mode == "prefill" else None
    o = o.reshape(B, S, H * hd) @ p["wo"]
    return o, new_cache


def _mlp_block(p, h: torch.Tensor) -> torch.Tensor:
    """Feed-forward half (dense, SiLU-gated)."""
    return nn.swiglu(nn.rms_norm(h, p["ln2"]), p["wgu"], p["wdn"])


def select_positions(h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-sequence select h[b, pos[b], :] -> (B, 1, d): the last REAL
    token of each right-padded prompt.  (The reference does a one-hot
    reduce so it can psum over sequence shards; on one device it is this
    gather, and exact either way.)"""
    rows = torch.arange(h.shape[0], device=h.device)
    return h[rows, pos.to(h.device).long()][:, None, :]


def apply_block(cfg: ArchConfig, p, h: torch.Tensor, rs: RunSpec, pos,
                cache):
    """One ``attn`` block with residuals; returns (h, new_cache)."""
    mix, new_cache = _attn_block(cfg, p, h, rs, pos, cache)
    h = h + mix
    return h + _mlp_block(p, h), new_cache


def init_cache_shapes(cfg: ArchConfig, batch: int,
                      kv_len: int) -> Dict[str, Tuple[int, ...]]:
    """Per-layer K/V cache shapes of an attn block."""
    s = (batch, kv_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": s, "v": s}
