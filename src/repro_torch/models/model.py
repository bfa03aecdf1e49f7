"""The Model: parameter groups, init, training loss, prefill, decode.

Port of the reference's ``models/model.py`` ``Model`` for dense stacks of
``attn`` and ``local`` blocks tiled from ``cfg.pattern``: one period of the
pattern per layer group (its blocks named ``0.*``, ``1.*``, ... in the
flat layout; ``("attn",)`` is one block a group) and the ``n_layers %
len(pattern)`` leftover layers, the first kinds of a period, in a group of
their own (``rem``) applied after the loop.  ``Model`` owns the flat ZeRO
parameter groups — same specs, offsets and padding as the reference, so
its buffers load unchanged (``repro_torch.convert``) — and drives the
layer loop through the ZeRO++ engine (``core/zeropp.py``,
``core/schedule.py``): each group is qwZ-gathered right before the
compute that uses it and, in training, re-gathered (hpZ) and its gradient
reduced (qgZ) right around its backward.  The serving head takes the
fused INT8 route (``kernels.ops.dequant_matmul``) wherever
``qwz_gemm_eligible`` holds; the training loss streams the unembedding
chunks through ``_streaming_xent``.

Groups (flat buffers):

  embed  : (E_pad,)            token embedding
  blocks : (n_periods, P_pad)  one period of the pattern per loop step
  rem    : (R_pad,)            the leftover layers (only when there are)
  head   : (H_pad,)            final norm
  unemb  : (nv, U_pad)         unembedding, TRANSPOSED (V, d), nv chunks

The model runs on ``device`` ("cuda" unless the caller asks for "cpu").
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partition import ParamSpec
from repro_torch.core.schedule import zero_apply_scan
from repro_torch.core.zeropp import (ZeroConfig, fwd_gather_quant,
                                     qwz_gemm_eligible, zero_apply,
                                     zero_apply_inference,
                                     zero_scan_inference)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import platform
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as nn
from repro_torch.models.transformer import (RunSpec, _sub, apply_block,
                                            block_entries, init_cache_shapes,
                                            select_positions)

Params = Dict[str, torch.Tensor]


class Model:
    def __init__(self, cfg: ArchConfig, zcfg: ZeroConfig, world: int = 1,
                 device="cuda"):
        self.device = platform.resolve_device(device)
        self.cfg = cfg
        self.zcfg = zcfg
        self.world = world
        self.period = tuple(cfg.pattern)
        self.n_periods = cfg.n_layers // len(self.period)
        self.rem = cfg.n_layers % len(self.period)
        self.rem_kinds = self.period[:self.rem]   # the leftover layers
        align = zcfg.align(world) if zcfg.distributed else zcfg.align(1)
        self.period_spec = ParamSpec(self._entries(self.period), align=align)
        self.rem_spec = ParamSpec(self._entries(self.rem_kinds),
                                  align=align) if self.rem else None
        self.embed_spec = ParamSpec((("emb", (cfg.vocab, cfg.d_model)),),
                                    align=align)
        self.head_spec = ParamSpec((("fnorm", (cfg.d_model,)),), align=align)
        nv = cfg.unemb_chunks or self._auto_unemb_chunks()
        assert cfg.vocab % nv == 0, (cfg.vocab, nv)
        self.unemb_chunks = nv
        self.vchunk = cfg.vocab // nv
        self.unemb_spec = ParamSpec(
            (("unemb", (self.vchunk, cfg.d_model)),), align=align)

    def _entries(self, kinds: Sequence[str]) -> tuple:
        """Flat-layout entries of a group of blocks: block i's under
        ``f"{i}."``."""
        out: list = []
        for i, kind in enumerate(kinds):
            out += block_entries(self.cfg, kind, f"{i}.")
        return tuple(out)

    def _auto_unemb_chunks(self, target_bytes: int = 512 * 2 ** 20) -> int:
        cfg = self.cfg
        total = cfg.vocab * cfg.d_model * 2  # bf16 gathered
        want = max(1, -(-total // target_bytes))
        # floor of 4 for big vocabularies: nv also bounds the (T, V/nv)
        # fp32 logits tile
        if cfg.vocab >= 32768:
            want = max(want, 4)
        nv = want
        while cfg.vocab % nv:
            nv += 1
        return nv

    # ------------------------------------------------------------------ init

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """GLOBAL flat buffer shapes (the reference's, key for key)."""
        out = {"embed": (self.embed_spec.padded_size,),
               "blocks": (self.n_periods, self.period_spec.padded_size)}
        if self.rem_spec:
            out["rem"] = (self.rem_spec.padded_size,)
        out["head"] = (self.head_spec.padded_size,)
        out["unemb"] = (self.unemb_chunks, self.unemb_spec.padded_size)
        return out

    def n_params(self) -> int:
        """Parameters in the flat groups, padding excluded."""
        return (self.embed_spec.size + self.period_spec.size * self.n_periods
                + (self.rem_spec.size if self.rem_spec else 0)
                + self.head_spec.size + self.unemb_spec.size * self.unemb_chunks)

    def comm_events(self, accum: int = 1) -> list:
        """Every ZeRO engine collective one training step issues:
        ``[{"kind", "elems", "count", "site"}, ...]``, kind fwd_gather /
        bwd_gather / grad_reduce, elems the GLOBAL flat buffer length,
        count the times it runs a step.  ``zeropp.step_wire_by_label``
        folds it into the per-label projection that the collectives'
        counters are gated against (``obs.report``).

        Each ``zero_apply`` site (the embedding, the leftover layers'
        ``rem`` group, the head norm, each unembedding chunk) issues one of
        each kind; the layer loop issues
        n of each per step at every ring depth.  The reference's scan ring
        issues n + k (k wrap-around gathers and k reduces of zero
        gradients); the port's ring (``core/schedule.py``) issues neither,
        so its bytes at every depth are the reference's at depth 0.  Each
        of ``accum`` microbatches runs the whole forward, backward and
        reduce, so every count is multiplied by it."""
        ev: list = []
        if not self.zcfg.distributed:
            return ev

        def add(kind, elems, count, site):
            ev.append({"kind": kind, "elems": int(elems),
                       "count": float(count) * accum, "site": site})

        sites = [("embed", self.embed_spec.padded_size, 1)]
        if self.rem_spec:
            sites.append(("rem", self.rem_spec.padded_size, 1))
        sites += [("head", self.head_spec.padded_size, 1),
                  ("unemb", self.unemb_spec.padded_size, self.unemb_chunks)]
        for site, e, c in sites:
            for kind in ("fwd_gather", "bwd_gather", "grad_reduce"):
                add(kind, e, c, site)
        n, P = self.n_periods, self.period_spec.padded_size
        add("fwd_gather", P, n, "blocks.fwd")
        add("bwd_gather", P, n, "blocks.bwd")
        add("grad_reduce", P, n, "blocks.reduce")
        return ev

    @staticmethod
    def _init_std(name: str, shape: Tuple[int, ...]) -> Optional[float]:
        """The reference's per-name init scale (None = zeros: norms)."""
        base = name.split(".")[-1]
        if base == "emb":
            return 0.02
        if base == "unemb":                 # stored (V_chunk, d)
            return shape[-1] ** -0.5
        if base in ("wq", "wk", "wv", "wgu", "wo", "wdn"):
            return shape[0] ** -0.5
        return None

    def _init_flat(self, spec: ParamSpec, gen: torch.Generator,
                   dtype: torch.dtype) -> torch.Tensor:
        flat = torch.zeros(spec.padded_size, dtype=torch.float32,
                           device=self.device)
        for name, shape in spec.entries:
            std = self._init_std(name, shape)
            if std is not None:
                off, n = spec.offsets[name]
                flat[off:off + n] = torch.randn(
                    n, generator=gen, device=self.device) * std
        return flat.to(dtype)

    def init_params(self, gen: torch.Generator,
                    dtype: Optional[torch.dtype] = None) -> Params:
        """GLOBAL flat buffers, normal draws from ``gen`` (a generator on
        the model's device) at the reference's per-name scales, in
        ``dtype`` (default ``param_dtype``; training passes float32: the
        master buffers ARE the trained parameters).  The draws are not the
        reference's: parity tests load its buffers through
        ``repro_torch.convert`` instead."""
        dtype = dtype or self.zcfg.param_dtype
        out = {"embed": self._init_flat(self.embed_spec, gen, dtype)}
        blocks = torch.empty(self.n_periods, self.period_spec.padded_size,
                             dtype=dtype, device=self.device)
        for g in range(self.n_periods):
            blocks[g] = self._init_flat(self.period_spec, gen, dtype)
        out["blocks"] = blocks
        if self.rem_spec:
            out["rem"] = self._init_flat(self.rem_spec, gen, dtype)
        out["head"] = self._init_flat(self.head_spec, gen, dtype)
        out["unemb"] = torch.stack([
            self._init_flat(self.unemb_spec, gen, dtype)
            for _ in range(self.unemb_chunks)])
        return out

    # ------------------------------------------------------------- positions

    def _rope_tables(self, rs: RunSpec, s_local: int,
                     cache_pos: Optional[torch.Tensor] = None):
        cfg = self.cfg
        if rs.mode == "decode":
            p = cache_pos[:, None]            # per-sequence: (B, 1)
        else:
            p = attn_lib.seq_shard_offset(s_local, rs.seq_axes,
                                          rs.seq_group) + torch.arange(
                s_local, device=self.device)
        return nn.rope_table(p, cfg.d_head, cfg.rope_theta)

    def _emb_lookup(self, W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.embed_spec.unpack(W)["emb"][t].to(self.zcfg.compute_dtype)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return zero_apply_inference(self._emb_lookup, self.zcfg)(
            params["embed"], tokens)

    # ------------------------------------------------------------- train

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                rs: RunSpec, dp_world: int = 1
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Local training loss: sum-NLL over this rank's tokens / the global
        token count (``dp_world`` ranks of equal (rows, sequence slice)
        tiles), differentiable with respect to the flat groups through the
        ZeRO++ engine.  ``rs`` is a train-mode RunSpec; its ``seq_axes``
        say whether ``batch`` is a slice of the sequence (rope and the
        causal mask then start at ``seq_shard_offset``) and its
        ``attn_impl`` picks the attention route (the flash kernels run in
        the forward and again in each layer's recompute).
        ``params["blocks"]`` and ``params["unemb"]`` may be (n, P) tensors
        or sequences of per-group (P,) shards.  Returns (loss, {"nll_sum",
        "tokens"})."""
        cfg, z = self.cfg, self.zcfg
        if rs.mode != "train":
            raise ValueError(f"loss_fn needs a train RunSpec, got {rs}")
        h = zero_apply(self._emb_lookup, z)(params["embed"], batch["tokens"])
        B, S = h.shape[0], h.shape[1]
        cos, sin = self._rope_tables(rs, S)

        def group_fn(W, h, cos, sin, spec, kinds):
            p = spec.unpack(W.to(z.compute_dtype))
            for i, kind in enumerate(kinds):
                h = apply_block(cfg, kind, _sub(p, f"{i}."), h, rs,
                                {"rope": (cos, sin)}, None)[0]
            return h

        h = zero_apply_scan(partial(group_fn, spec=self.period_spec,
                                    kinds=self.period), z)(
            params["blocks"], h, cos, sin)
        if self.rem_spec:
            h = zero_apply(partial(group_fn, spec=self.rem_spec,
                                   kinds=self.rem_kinds), z)(
                params["rem"], h, cos, sin)

        def norm_fn(W, h):
            p = self.head_spec.unpack(W.to(z.compute_dtype))
            return nn.rms_norm(h, p["fnorm"])

        hn = zero_apply(norm_fn, z)(params["head"], h)
        nll_sum = self._streaming_xent(params["unemb"],
                                       hn.reshape(-1, cfg.d_model),
                                       batch["targets"].reshape(-1))
        loss = nll_sum / float(B * S * dp_world)
        return loss, {"nll_sum": nll_sum.detach(), "tokens": float(B * S)}

    def _streaming_xent(self, unemb, hn2: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
        """Sum-NLL with the (V, d) unembedding gathered one vocab chunk at
        a time; the log-sum-exp streams across chunks (exact).  The (T, V)
        logits never exist: each chunk's ``zero_apply`` returns the
        per-token max, the sum of exponentials relative to it and the gold
        logit's contribution, all (T,), combined by the running-max rule.
        Logits are fp32 (bf16 products are exact in fp32)."""
        z = self.zcfg
        Vc = self.vchunk
        T = hn2.shape[0]

        def chunk_f(Wc, hn2, targets, c):
            p = self.unemb_spec.unpack(Wc.to(z.compute_dtype))
            logits = hn2.to(torch.float32) @ p["unemb"].to(torch.float32).T
            m_c = logits.amax(dim=1)
            s_c = torch.exp(logits - m_c[:, None]).sum(dim=1)
            idx = targets - c * Vc
            in_r = (idx >= 0) & (idx < Vc)
            g = logits.gather(1, idx.clamp(0, Vc - 1)[:, None])[:, 0]
            return m_c, s_c, torch.where(in_r, g, 0.0)

        ap = zero_apply(chunk_f, z)
        dev = hn2.device
        m = torch.full((T,), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((T,), dtype=torch.float32, device=dev)
        gold = torch.zeros((T,), dtype=torch.float32, device=dev)
        for c in range(self.unemb_chunks):
            m_c, s_c, g_c = ap(unemb[c], hn2, targets, c)
            m_new = torch.maximum(m, m_c)
            l = l * torch.exp(m - m_new) + s_c * torch.exp(m_c - m_new)
            gold = gold + g_c
            m = m_new
        return torch.sum(m + torch.log(l) - gold)

    # -------------------------------------------------------------- head

    def _head_logits(self, params: Params, h_last: torch.Tensor
                     ) -> torch.Tensor:
        """Serving head: (B, S, V) fp32 logits assembled from vocab chunks."""
        z, cfg = self.zcfg, self.cfg

        def norm_fn(W, hl):
            p = self.head_spec.unpack(W.to(z.compute_dtype))
            return nn.rms_norm(hl, p["fnorm"])

        hn = zero_apply_inference(norm_fn, z)(params["head"], h_last)
        B, S = hn.shape[0], hn.shape[1]
        Vc, d = self.vchunk, cfg.d_model
        if qwz_gemm_eligible(z, Vc, d):
            # fused head: gather the qwZ payload WITHOUT dequantizing; the
            # dequant-GEMM kernel applies the scales itself, so the bf16
            # (Vc, d) chunk never exists.  The unemb entry sits at flat
            # offset 0, so payload rows are a plain reshape; scales are
            # per-row groups (d % block == 0) or one block per block/d
            # whole rows (broadcast to each row).
            blk = z.qwz_block

            def ap(Wc, hn):
                pq, sq = fwd_gather_quant(Wc, z)
                pr = pq[: Vc * d].reshape(Vc, d)
                if d % blk == 0:
                    sr = sq[: Vc * (d // blk)].reshape(Vc, d // blk)
                else:
                    sr = torch.repeat_interleave(
                        sq[: Vc // (blk // d)], blk // d)[:, None]
                out2 = kops.dequant_matmul(hn.reshape(-1, d), pr, sr,
                                           compute_dtype=z.compute_dtype)
                return out2.reshape(B, S, Vc)
        else:
            def chunk_f(Wc, hn):
                p = self.unemb_spec.unpack(Wc.to(z.compute_dtype))
                return hn.to(torch.float32) @ p["unemb"].to(torch.float32).T

            ap = zero_apply_inference(chunk_f, z)
        return torch.cat([ap(params["unemb"][c], hn)
                          for c in range(self.unemb_chunks)], dim=-1)

    # ------------------------------------------------------------ prefill

    def _group_fn(self, rs: RunSpec, pos, spec: ParamSpec,
                  kinds: Sequence[str]):
        """``f(W, h, caches) -> (h, new caches)`` of a group of blocks
        (a period, or the ``rem`` layers); ``caches`` holds one per block
        (None in prefill)."""
        cfg, z = self.cfg, self.zcfg

        def group_fn(W, h, caches):
            p = spec.unpack(W.to(z.compute_dtype))
            out = []
            for i, kind in enumerate(kinds):
                h, c = apply_block(cfg, kind, _sub(p, f"{i}."), h, rs, pos,
                                   None if caches is None else caches[i])
                out.append(c)
            return h, tuple(out)
        return group_fn

    @torch.no_grad()
    def prefill_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                   rs: RunSpec, last_pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
        """Forward over a prompt; returns (last-token logits (B, 1, V),
        caches).  ``last_pos`` (B,) selects each sequence's logits position
        — the last REAL token of a right-padded prompt; default: the final
        position."""
        z = self.zcfg
        h = self._embed(params, batch["tokens"])
        pos = {"rope": self._rope_tables(rs, h.shape[1])}
        h, ys = zero_scan_inference(
            self._group_fn(rs, pos, self.period_spec, self.period), z)(
            params["blocks"], h)
        # per-period caches -> one (n_periods, B, S, K, hd) stack for each
        # block of the period (S: the prompt, or a local layer's window)
        caches = tuple({key: torch.stack([y[j][key] for y in ys])
                        for key in ("k", "v")}
                       for j in range(len(self.period)))
        rem = None
        if self.rem_spec:
            h, rem = zero_apply_inference(
                self._group_fn(rs, pos, self.rem_spec, self.rem_kinds),
                z)(params["rem"], h, None)
        h_last = h[:, -1:, :] if last_pos is None \
            else select_positions(h, last_pos)
        return self._head_logits(params, h_last), {"blocks": caches,
                                                   "rem": rem}

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def decode_fn(self, params: Params, caches, batch: Dict[str, torch.Tensor],
                  cache_pos, rs: RunSpec) -> Tuple[torch.Tensor, Any]:
        """One decode step.  batch: tokens (B, 1).  ``cache_pos`` is
        PER-SEQUENCE (B,) (a scalar broadcasts), so rows admitted at
        different steps decode together.  The caches are updated IN PLACE
        (the reference returns new arrays) and returned."""
        h = self._embed(params, batch["tokens"])
        cache_pos = attn_lib.per_seq_pos(cache_pos, h.shape[0]).to(self.device)
        pos = {"rope": self._rope_tables(rs, 1, cache_pos=cache_pos),
               "cache_pos": cache_pos}
        per_period = [tuple({key: c[key][i] for key in ("k", "v")}
                            for c in caches["blocks"])
                      for i in range(self.n_periods)]
        h, _ = zero_scan_inference(
            self._group_fn(rs, pos, self.period_spec, self.period),
            self.zcfg)(params["blocks"], h, per_period)
        if self.rem_spec:
            h, _ = zero_apply_inference(
                self._group_fn(rs, pos, self.rem_spec, self.rem_kinds),
                self.zcfg)(params["rem"], h, caches["rem"])
        return self._head_logits(params, h), caches

    # ------------------------------------------------------------- caches

    def cache_shapes(self, batch: int, kv_len: int):
        """GLOBAL cache shapes matching decode_fn's layout: for each block
        of the period a (n_periods, ...) stack, for each ``rem`` layer its
        own (None without one)."""
        blocks = tuple({k: (self.n_periods,) + s for k, s in
                        init_cache_shapes(self.cfg, kind, batch,
                                          kv_len).items()}
                       for kind in self.period)
        rem = tuple(init_cache_shapes(self.cfg, kind, batch, kv_len)
                    for kind in self.rem_kinds) if self.rem_spec else None
        return {"blocks": blocks, "rem": rem}

    def init_caches(self, batch: int, kv_len: int,
                    dtype: torch.dtype = torch.bfloat16):
        def zeros(per):
            return {k: torch.zeros(s, dtype=dtype, device=self.device)
                    for k, s in per.items()}
        shapes = self.cache_shapes(batch, kv_len)
        rem = shapes["rem"]
        return {"blocks": tuple(zeros(per) for per in shapes["blocks"]),
                "rem": None if rem is None else tuple(zeros(p) for p in rem)}
