"""The Model: parameter groups, init, training loss, prefill, decode.

Port of the reference's ``models/model.py`` ``Model`` for stacks of
``attn``, ``local``, ``ssd`` and ``rec`` blocks tiled from
``cfg.pattern``, and for MoE stacks (``pattern=("moe",)``): one period of
the pattern per layer group (its blocks named ``0.*``, ``1.*``, ... in
the flat layout; ``("attn",)`` is one block a group) and the ``n_layers %
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

  embed  : (E_pad,)            token embedding (absent with
                               ``cfg.embed_inputs``: the batch brings
                               ``embeds``, (B, S, d), from the stub)
  blocks : (n_periods, P_pad)  one period of the pattern per loop step
  experts: (n_periods, nc, E_pad)  MoE only: each layer's routed experts
                               in ``expert_chunks`` chunk groups, gathered
                               one chunk at a time (``_moe_layer``)
  rem    : (R_pad,)            the leftover layers (only when there are)
  head   : (H_pad,)            final norm
  unemb  : (nv, U_pad)         unembedding, TRANSPOSED (V, d), nv chunks

Rotary tables come from the positions 0..S-1 of the sequence (offset by
this rank's sequence shard), or with ``cfg.mrope`` from the batch's
``positions`` (3, B, S) in every mode (already this rank's slice, so no
offset is added); a stack without attention (mamba2) builds them at the
reference's ``d_head`` (d_model) and reads none.  Decode caches carry a
dtype per leaf: K/V and conv histories in the cache dtype, recurrent
states in fp32 (``transformer.init_cache_shapes``).  The model runs on
``device`` ("cuda" unless the caller asks for "cpu").

An MoE layer (``_moe_layer``) runs attention, the router and the shared
experts under its layer group's gather (``transformer.moe_pre_block``),
dispatches the tokens by sorting (``models/moe.py``), then runs the
expert chunks through their own ring (``core/schedule.py``
``zero_chunk_scan``): chunk c+k's gather in flight under chunk c's
grouped GEMMs, each chunk's slot buffer rebuilt from the token
activations inside its own gather.  With the layer ring on, layer i+k's
first chunk is gathered beside its group (routing-ahead), and under hpZ
the backward's recompute replays the chunks from their saved secondary
slices on the hpZ tier.  The load-balance loss joins the training loss
as ``aux_loss_weight · aux / (n_moe_layers · dp_world)``.
"""
from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partition import ParamSpec
from repro_torch.core.schedule import (zero_apply_scan, zero_chunk_scan,
                                       zero_chunk_scan_hpz,
                                       zero_chunk_scan_inference)
from repro_torch.core.zeropp import (ZeroConfig, fwd_gather_quant,
                                     qwz_gemm_eligible, zero_apply,
                                     zero_apply_inference,
                                     zero_scan_inference)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import platform
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import (RunSpec, _sub, apply_block,
                                            block_entries, expert_entries,
                                            init_cache_shapes,
                                            last_shard_value, moe_pre_block,
                                            select_positions)

# the reference's init range of dtb: softplus⁻¹(1e-3) .. softplus⁻¹(0.1)
_DT_LO, _DT_HI = float(np.log(np.expm1(1e-3))), float(np.log(np.expm1(0.1)))

Params = Dict[str, torch.Tensor]


def _host_ints(x) -> torch.Tensor:
    """An int64 CPU tensor of ``x`` (a tensor on any device, an array or a
    sequence)."""
    if torch.is_tensor(x):
        return x.detach().long().cpu()
    return torch.as_tensor(np.asarray(x, np.int64))


def _spec_chunk0(xs, i):
    """Routing-ahead source of the training ring: layer ``i``'s first
    expert-chunk primary shard (its inputs are its chunk shards)."""
    return xs[i][0]


def _serve_spec_chunk0(xs, i):
    """The serving ring's: layer ``i``'s inputs are (its (nc, P) expert
    stack, its cache)."""
    return xs[i][0][0]


def _bwd_spec_chunk0(auxs, i):
    """The reverse ring's mirror: layer ``i``'s first chunk's secondary
    slice, kept by the forward."""
    return auxs[i][0]


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
        self.is_moe = "moe" in self.period
        if self.is_moe and self.period != ("moe",):
            # the chunked expert path runs one MoE layer per loop step
            raise ValueError(f"moe must be the whole pattern, got "
                             f"{self.period}")
        self.expert_spec = ParamSpec(tuple(expert_entries(cfg)),
                                     align=align) if self.is_moe else None
        self.n_moe_layers = cfg.n_layers if self.is_moe else 0
        self.period_spec = ParamSpec(self._entries(self.period), align=align)
        self.rem_spec = ParamSpec(self._entries(self.rem_kinds),
                                  align=align) if self.rem else None
        self.embed_spec = None if cfg.embed_inputs else ParamSpec(
            (("emb", (cfg.vocab, cfg.d_model)),), align=align)
        self.head_spec = ParamSpec((("fnorm", (cfg.d_model,)),), align=align)
        nv = cfg.unemb_chunks or self._auto_unemb_chunks()
        assert cfg.vocab % nv == 0, (cfg.vocab, nv)
        self.unemb_chunks = nv
        self.vchunk = cfg.vocab // nv
        self.unemb_spec = ParamSpec(
            (("unemb", (self.vchunk, cfg.d_model)),), align=align)

    def with_prefetch(self, k: int) -> "Model":
        """A shallow copy of this model at ring depth ``k`` (the layer and
        the expert-chunk loops), as the reference's: the specs are shared,
        only the schedule changes (serving deepens its ring this way)."""
        m = copy.copy(self)
        m.zcfg = dataclasses.replace(self.zcfg, prefetch=k)
        return m

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
        out = {"embed": (self.embed_spec.padded_size,)} \
            if self.embed_spec else {}
        out["blocks"] = (self.n_periods, self.period_spec.padded_size)
        if self.is_moe:
            out["experts"] = (self.n_periods, self.cfg.expert_chunks,
                              self.expert_spec.padded_size)
        if self.rem_spec:
            out["rem"] = (self.rem_spec.padded_size,)
        out["head"] = (self.head_spec.padded_size,)
        out["unemb"] = (self.unemb_chunks, self.unemb_spec.padded_size)
        return out

    def n_params(self) -> int:
        """Parameters in the flat groups, padding excluded."""
        return ((self.embed_spec.size if self.embed_spec else 0)
                + self.period_spec.size * self.n_periods
                + (self.expert_spec.size * self.cfg.expert_chunks
                   * self.n_periods if self.is_moe else 0)
                + (self.rem_spec.size if self.rem_spec else 0)
                + self.head_spec.size
                + self.unemb_spec.size * self.unemb_chunks)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        cfg = self.cfg
        if not cfg.n_experts:
            return self.n_params()
        inactive = (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.moe_ff
        return self.n_params() - inactive * cfg.n_layers

    def comm_events(self, accum: int = 1) -> list:
        """Every ZeRO engine collective one training step issues:
        ``[{"kind", "elems", "count", "site"}, ...]``, kind fwd_gather /
        bwd_gather / grad_reduce, elems the GLOBAL flat buffer length,
        count the times it runs a step.  ``zeropp.step_wire_by_label``
        folds it into the per-label projection that the collectives'
        counters are gated against (``obs.report``).

        Each ``zero_apply`` site (the embedding where the model has one,
        the leftover layers' ``rem`` group, the head norm, each
        unembedding chunk) issues one of each kind; the layer loop issues
        n of each per step at every ring depth.  The reference's scan ring
        issues n + k (k wrap-around gathers and k reduces of zero
        gradients); the port's ring (``core/schedule.py``) issues neither,
        so its bytes at every depth are the reference's at depth 0.  Each
        of ``accum`` microbatches runs the whole forward, backward and
        reduce, so every count is multiplied by it.

        An MoE stack adds its n·nc expert chunks (E_pad each): a forward
        gather each, where the routing-ahead gather (``blocks.spec``, on
        whenever both the layer and the chunk rings are) takes chunk 0's
        place; a re-gather and a reduce each in the backward, whose
        recompute runs the chunks' forward again: at depth 0 each chunk's
        ``zero_apply`` gathers it on the qwZ tier, then on the hpZ one (the
        reference's counts); on the ring with hpZ the recompute replays
        from the saved secondary slices on the hpZ tier, chunk 0 from the
        reverse ring's ``blocks.bwd_spec``; without hpZ it gathers on the
        qwZ tier.  The reference's rings add k and kc wrap-around terms
        (n + k, n·(nc + kc)); the port's issue none."""
        ev: list = []
        if not self.zcfg.distributed:
            return ev

        def add(kind, elems, count, site):
            if count > 0:
                ev.append({"kind": kind, "elems": int(elems),
                           "count": float(count) * accum, "site": site})

        sites = [("embed", self.embed_spec.padded_size, 1)] \
            if self.embed_spec else []
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
        if not self.is_moe:
            return ev
        z = self.zcfg
        nc, E = self.cfg.expert_chunks, self.expert_spec.padded_size
        k = z.effective_prefetch(n)
        spec = int(k >= 1 and z.effective_prefetch(nc) >= 1)
        add("fwd_gather", E, n * spec, "blocks.spec")
        add("fwd_gather", E, n * (nc - spec), "experts.fwd")
        if k >= 1 and z.hpz:
            add("bwd_gather", E, n * spec, "blocks.bwd_spec")
            add("bwd_gather", E, n * (nc - spec), "experts.bwd_recompute")
        else:
            add("fwd_gather", E, n * nc, "experts.bwd_recompute")
        add("bwd_gather", E, n * nc, "experts.bwd")
        add("grad_reduce", E, n * nc, "experts.reduce")
        return ev

    @staticmethod
    def _init_rule(name: str, shape: Tuple[int, ...]) -> Optional[tuple]:
        """The reference's per-name init (``_init_fn``): ("normal", std),
        ("uniform", lo, hi), ("log_uniform", lo, hi) (the log of a uniform
        draw: ``alog``), ("ones",) (``dskip``), or None (zeros: norms and
        biases)."""
        base = name.split(".")[-1]
        if base == "emb":
            return ("normal", 0.02)
        if base == "unemb":                 # stored (V_chunk, d)
            return ("normal", shape[-1] ** -0.5)
        if base in ("wq", "wk", "wv", "wgu", "wo", "wdn", "router", "sdn",
                    "px", "pg", "wa", "wx", "inp", "po", "outp", "cw"):
            return ("normal", shape[0] ** -0.5)
        if base in ("egu", "sgu", "edn"):
            return ("normal", shape[-2] ** -0.5)
        if base == "alog":
            return ("log_uniform", 1.0, 16.0)
        if base == "dskip":
            return ("ones",)
        if base == "dtb":
            return ("uniform", _DT_LO, _DT_HI)
        if base == "loga":
            return ("uniform", -0.8, -0.01)
        return None                         # norms and biases

    def _init_flat(self, spec: ParamSpec, gen: torch.Generator,
                   dtype: torch.dtype) -> torch.Tensor:
        flat = torch.zeros(spec.padded_size, dtype=torch.float32,
                           device=self.device)
        for name, shape in spec.entries:
            rule = self._init_rule(name, shape)
            if rule is None:
                continue
            off, n = spec.offsets[name]
            kind, *arg = rule
            if kind == "normal":
                v = torch.randn(n, generator=gen, device=self.device) * arg[0]
            elif kind == "ones":
                v = 1.0
            else:
                lo, hi = arg
                v = torch.rand(n, generator=gen, device=self.device) \
                    * (hi - lo) + lo
                if kind == "log_uniform":
                    v = torch.log(v)
            flat[off:off + n] = v
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
        out = {"embed": self._init_flat(self.embed_spec, gen, dtype)} \
            if self.embed_spec else {}
        blocks = torch.empty(self.n_periods, self.period_spec.padded_size,
                             dtype=dtype, device=self.device)
        for g in range(self.n_periods):
            blocks[g] = self._init_flat(self.period_spec, gen, dtype)
        out["blocks"] = blocks
        if self.is_moe:
            experts = torch.empty(self.param_shapes()["experts"], dtype=dtype,
                                  device=self.device)
            for g in range(self.n_periods):
                for c in range(self.cfg.expert_chunks):
                    experts[g, c] = self._init_flat(self.expert_spec, gen,
                                                    dtype)
            out["experts"] = experts
        if self.rem_spec:
            out["rem"] = self._init_flat(self.rem_spec, gen, dtype)
        out["head"] = self._init_flat(self.head_spec, gen, dtype)
        out["unemb"] = torch.stack([
            self._init_flat(self.unemb_spec, gen, dtype)
            for _ in range(self.unemb_chunks)])
        return out

    # ------------------------------------------------------------- positions

    def _rope_tables(self, batch: Dict[str, torch.Tensor], rs: RunSpec,
                     s_local: int, cache_pos: Optional[torch.Tensor] = None):
        cfg = self.cfg
        if cfg.mrope:       # (3, B, S_loc) from the frontend stub
            return nn.mrope_tables(batch["positions"].to(self.device),
                                   cfg.d_head, cfg.rope_theta)
        if rs.mode == "decode":
            p = cache_pos[:, None]            # per-sequence: (B, 1)
        else:
            p = attn_lib.seq_shard_offset(s_local, rs.seq_axes,
                                          rs.seq_group) + torch.arange(
                s_local, device=self.device)
        return nn.rope_table(p, cfg.d_head, cfg.rope_theta)

    def _emb_lookup(self, W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.embed_spec.unpack(W)["emb"][t].to(self.zcfg.compute_dtype)

    def _inputs(self, params: Params, batch: Dict[str, torch.Tensor],
                train: bool = False) -> torch.Tensor:
        """(B, S, d) activations in the compute dtype: the stub's
        ``embeds`` (``cfg.embed_inputs``), else the ``tokens``' rows of the
        embedding group, gathered by its ``zero_apply`` (training) or
        ``zero_apply_inference``."""
        z = self.zcfg
        if self.cfg.embed_inputs:
            return batch["embeds"].to(self.device, z.compute_dtype)
        ap = zero_apply if train else zero_apply_inference
        return ap(self._emb_lookup, z)(params["embed"], batch["tokens"])

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
        or sequences of per-group (P,) shards, ``params["experts"]`` (MoE)
        an (n, nc, E) tensor or n sequences of nc shards.  Returns (loss,
        {"nll_sum", "tokens"}, and for MoE "moe_aux": the layers' summed
        load-balance losses)."""
        cfg, z = self.cfg, self.zcfg
        if rs.mode != "train":
            raise ValueError(f"loss_fn needs a train RunSpec, got {rs}")
        h = self._inputs(params, batch, train=True)
        B, S = h.shape[0], h.shape[1]
        cos, sin = self._rope_tables(batch, rs, S)

        def group_fn(W, h, cos, sin, spec, kinds):
            p = spec.unpack(W.to(z.compute_dtype))
            for i, kind in enumerate(kinds):
                h = apply_block(cfg, kind, _sub(p, f"{i}."), h, rs,
                                {"rope": (cos, sin)}, None)[0]
            return h

        aux = None
        if self.is_moe:
            h, aux = self._moe_stack(params, h, rs, cos, sin)
        else:
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
        mets = {"nll_sum": nll_sum.detach(), "tokens": float(B * S)}
        if aux is not None:
            loss = loss + cfg.aux_loss_weight * aux / (self.n_moe_layers
                                                       * dp_world)
            mets["moe_aux"] = aux.detach()
        return loss, mets

    # ------------------------------------------------------------- moe

    def _moe_layer(self, rs: RunSpec, train: bool, W, eflat, h, cos, sin,
                   cache_pos, cache, W_spec=None, sec=None,
                   collect_sec: bool = False):
        """One MoE layer from its gathered group ``W`` and its nc expert
        chunk shards ``eflat`` (the reference's ``_moe_layer``): attention,
        router and shared experts (``moe_pre_block``), the sort-based
        dispatch (indices only), the chunk pipeline (each chunk rebuilds
        its slot buffer from the token activations, runs the grouped GEMMs
        and applies its gates, so the router's gradient comes from the
        chunk's recompute), then the index-only combine.  Serving takes
        ``serve_capacity`` (drop-free at decode).  ``W_spec``: chunk 0
        already gathered (the routing-ahead buffer; in the recompute, the
        reverse ring's); ``collect_sec``: also return the chunks'
        secondary slices; ``sec``: replay the chunks from them on the hpZ
        tier.  Returns (h, new cache, aux loss, secondary slices or
        None)."""
        cfg, z = self.cfg, self.zcfg
        B, S, d = h.shape
        Ec = cfg.n_experts // cfg.expert_chunks
        p = _sub(self.period_spec.unpack(W.to(z.compute_dtype)), "0.")
        h2, hn2, logits, shared_y, new_cache = moe_pre_block(
            cfg, p, h, rs, {"rope": (cos, sin), "cache_pos": cache_pos},
            cache)
        capacity = None if train else moe_lib.serve_capacity(
            hn2.shape[0], cfg.top_k, cfg.n_experts)
        disp = moe_lib.moe_dispatch(hn2, logits, top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor,
                                    capacity=capacity)
        slots = Ec * disp.cap

        def chunk_f(Wc, c, hn2, g_sorted):
            pc = self.expert_spec.unpack(Wc.to(z.compute_dtype))
            buf = moe_lib.build_chunk_buf(hn2, disp, c * slots, slots)
            out = moe_lib.expert_ffn(buf.reshape(Ec, disp.cap, d),
                                     pc["egu"], pc["edn"])
            g = moe_lib.build_chunk_gates(g_sorted, disp.dest, c * slots,
                                          slots)
            return out * g.reshape(Ec, disp.cap, 1).to(out.dtype)

        chunks = [eflat[c] for c in range(cfg.expert_chunks)]
        sec_out = None
        if not train:
            outs = zero_chunk_scan_inference(chunk_f, z)(
                chunks, hn2, disp.g_sorted, W0=W_spec)
        elif sec is not None:
            outs = zero_chunk_scan_hpz(chunk_f, z)(
                chunks, sec, hn2, disp.g_sorted, W0=W_spec)
        elif collect_sec:
            outs, sec_out = zero_chunk_scan(chunk_f, z,
                                            collect_secondary=True)(
                chunks, hn2, disp.g_sorted, W0=W_spec)
        else:
            outs = zero_chunk_scan(chunk_f, z)(chunks, hn2, disp.g_sorted,
                                               W0=W_spec)
        y = moe_lib.moe_combine(
            torch.stack(outs).reshape(cfg.n_experts, disp.cap, d), disp)
        h3 = h2 + shared_y + y.reshape(B, S, d).to(h2.dtype)
        return h3, new_cache, disp.aux_loss, sec_out

    def _moe_stack(self, params: Params, h, rs: RunSpec, cos, sin):
        """The training loop over the MoE layers: the layer ring carries
        each layer's chunk shards as its inputs and its aux loss as its
        output; routing-ahead (``spec``) wherever the chunk ring can start
        from it, and with hpZ the recompute's chunks replayed from the
        saved secondary slices (``f_fwd``/``f_bwd``/``bwd_spec``).
        Returns (h, the layers' summed aux loss)."""
        cfg, z = self.cfg, self.zcfg
        hpz_remat = z.hpz and z.distributed
        spec = _spec_chunk0 \
            if z.effective_prefetch(cfg.expert_chunks) >= 1 else None

        def moe_f(W, h, x, cos, sin):
            h2, _, aux, _ = self._moe_layer(rs, True, W, x, h, cos, sin,
                                            None, None)
            return h2, aux

        def moe_f_fwd(W, W_spec, h, x, cos, sin):
            h2, _, aux, sec = self._moe_layer(
                rs, True, W, x, h, cos, sin, None, None, W_spec=W_spec,
                collect_sec=hpz_remat)
            return h2, aux, sec

        def moe_f_bwd(W, h, x, sec, cos, sin, W0=None):
            h2, _, aux, _ = self._moe_layer(rs, True, W, x, h, cos, sin,
                                            None, None, sec=sec, W_spec=W0)
            return h2, aux

        ap = zero_apply_scan(
            moe_f, z, f_fwd=moe_f_fwd,
            f_bwd=moe_f_bwd if hpz_remat else None, spec=spec,
            bwd_spec=_bwd_spec_chunk0
            if hpz_remat and spec is not None else None)
        ex = params["experts"]
        xs = [tuple(ex[i][c] for c in range(cfg.expert_chunks))
              for i in range(self.n_periods)]
        h, auxs = ap(params["blocks"], h, cos, sin, xs=xs)
        return h, torch.stack(auxs).sum()

    def _moe_serve(self, params: Params, h, rs: RunSpec, cos, sin,
                   cache_pos=None, caches=None):
        """The serving loop over the MoE layers (routing-ahead wherever
        the chunk ring can start from it): (h, [each layer's (cache,)])."""
        z = self.zcfg

        def moe_f(W, W_spec, h, x):
            eflat, cache = x
            h2, c, _, _ = self._moe_layer(
                rs, False, W, eflat, h, cos, sin, cache_pos,
                None if cache is None else cache[0], W_spec=W_spec)
            return h2, (c,)

        xs = [(params["experts"][i], None if caches is None else caches[i])
              for i in range(self.n_periods)]
        if z.effective_prefetch(self.cfg.expert_chunks) >= 1:
            run = zero_scan_inference(moe_f, z, spec=_serve_spec_chunk0)
        else:
            run = zero_scan_inference(
                lambda W, h, x: moe_f(W, None, h, x), z)
        return run(params["blocks"], h, xs)

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
        position.  Under a sequence sharded over ``rs.seq_axes`` the batch
        is this rank's slice, the caches keep that layout
        (``rs.kv_axes`` == ``rs.seq_axes``) and the logits are every
        sequence rank's (the position's owner hands its value over)."""
        z = self.zcfg
        h = self._inputs(params, batch)
        pos = {"rope": self._rope_tables(batch, rs, h.shape[1])}
        if self.is_moe:
            h, ys = self._moe_serve(params, h, rs, *pos["rope"])
        else:
            h, ys = zero_scan_inference(
                self._group_fn(rs, pos, self.period_spec, self.period), z)(
                params["blocks"], h)
        # per-period caches -> one (n_periods, ...) stack of each leaf for
        # each block of the period: K/V (B, S, K, hd) with S the prompt or
        # a local layer's window, an ssd/rec layer's state and conv history
        caches = tuple({key: torch.stack([y[j][key] for y in ys])
                        for key in ys[0][j]}
                       for j in range(len(self.period)))
        rem = None
        if self.rem_spec:
            h, rem = zero_apply_inference(
                self._group_fn(rs, pos, self.rem_spec, self.rem_kinds),
                z)(params["rem"], h, None)
        h_last = last_shard_value(h[:, -1:, :], rs.seq_axes, rs.seq_group) \
            if last_pos is None else select_positions(h, last_pos,
                                                      rs.seq_axes,
                                                      rs.seq_group)
        return self._head_logits(params, h_last), {"blocks": caches,
                                                   "rem": rem}

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def decode_fn(self, params: Params, caches, batch: Dict[str, torch.Tensor],
                  cache_pos, rs: RunSpec) -> Tuple[torch.Tensor, Any]:
        """One decode step.  batch: tokens (B, 1), or embeds (B, 1, d)
        (``cfg.embed_inputs``), and with ``cfg.mrope`` the new token's
        positions (3, B, 1).  ``cache_pos`` is PER-SEQUENCE (B,) (a scalar
        broadcasts), so rows admitted at different steps decode together.
        The caches (this rank's slice of the cache sequence over
        ``rs.kv_axes``) are updated IN PLACE (the reference returns new
        arrays) and returned."""
        h = self._inputs(params, batch)
        cache_pos = attn_lib.per_seq_pos(cache_pos, h.shape[0]).to(self.device)
        pos = {"rope": self._rope_tables(batch, rs, 1, cache_pos=cache_pos),
               "cache_pos": cache_pos}
        per_period = [tuple({key: t[i] for key, t in c.items()}
                            for c in caches["blocks"])
                      for i in range(self.n_periods)]
        if self.is_moe:
            h, _ = self._moe_serve(params, h, rs, *pos["rope"], cache_pos,
                                   per_period)
        else:
            h, _ = zero_scan_inference(
                self._group_fn(rs, pos, self.period_spec, self.period),
                self.zcfg)(params["blocks"], h, per_period)
        if self.rem_spec:
            h, _ = zero_apply_inference(
                self._group_fn(rs, pos, self.rem_spec, self.rem_kinds),
                self.zcfg)(params["rem"], h, caches["rem"])
        return self._head_logits(params, h), caches

    # -------------------------------------------------------------- paged

    def _refuse_paged(self) -> None:
        if set(self.period) != {"attn"}:
            raise ValueError("paged serving supports dense attn-only "
                             f"stacks; got period {self.period}")
        if self.cfg.mrope:
            raise ValueError("paged serving does not support mrope")

    @torch.no_grad()
    def paged_fn(self, params: Params, caches, batch: Dict[str, torch.Tensor],
                 page_table, start_pos, rs: RunSpec
                 ) -> Tuple[torch.Tensor, Any]:
        """One paged-serving step: (B, T) tokens against a page arena.

        ``caches`` hold a PAGE ARENA, (n_pages, page_loc, K, hd) per layer
        shared by every row (``init_paged_caches``; page_loc = page_size / kv
        world: this rank's offsets within each page under ``rs.kv_axes``),
        updated IN PLACE and returned; ``page_table`` (B, Pm) maps each row's
        logical pages to physical ones (-1: the row writes nothing there and
        attends to nothing there).  Row r's token j sits at position
        ``start_pos[r] + j``.  One step serves batched decode (T = 1),
        speculative verify (T = g + 1) and chunked prefill (B = 1, T = chunk);
        the logits come back for every position, (B, T, V), through the serving
        head (B8 where qwZ's GEMM route is eligible).  The table and positions
        are read on the host once a call: the writes that land
        (``attention.paged_write_plan``) are the same for every layer."""
        self._refuse_paged()
        cfg, z = self.cfg, self.zcfg
        h = self._inputs(params, batch)
        B, T = h.shape[0], h.shape[1]
        table = _host_ints(page_table)
        tpos = attn_lib.per_seq_pos(_host_ints(start_pos), B).long()[
            :, None] + torch.arange(T)                           # (B, T)
        world, page_loc, d_off = attn_lib.kv_shard(
            rs.kv_axes, rs.kv_group, n_loc=caches["blocks"][0]["k"].shape[2])
        dev = self.device
        tpos_d = tpos.to(dev)
        plan = attn_lib.paged_write_plan(tpos, table, page_loc * world,
                                         d_off, page_loc)
        pos = {"rope": nn.rope_table(tpos_d, cfg.d_head, cfg.rope_theta),
               "positions": tpos_d, "page_table": table.to(dev),
               "write_plan": tuple(t.to(dev) for t in plan)}
        per_period = [tuple({key: c[key][i] for key in ("k", "v")}
                            for c in caches["blocks"])
                      for i in range(self.n_periods)]
        h, _ = zero_scan_inference(
            self._group_fn(rs, pos, self.period_spec, self.period), z)(
            params["blocks"], h, per_period)
        if self.rem_spec:
            h, _ = zero_apply_inference(
                self._group_fn(rs, pos, self.rem_spec, self.rem_kinds), z)(
                params["rem"], h, caches["rem"])
        return self._head_logits(params, h), caches

    def paged_cache_shapes(self, n_pages: int, page_size: int,
                           kv_world: int = 1,
                           dtype: torch.dtype = torch.bfloat16):
        """This rank's page arena shapes: :meth:`cache_shapes` with (batch,
        kv_len) read as (n_pages, page_size), the within-page dim cut
        ``kv_world`` ways."""
        self._refuse_paged()
        return self.cache_shapes(n_pages, page_size, kv_world, dtype)

    def init_paged_caches(self, n_pages: int, page_size: int,
                          dtype: torch.dtype = torch.bfloat16,
                          kv_world: int = 1):
        self._refuse_paged()
        return self.init_caches(n_pages, page_size, dtype, kv_world)

    # ------------------------------------------------------------- caches

    def cache_shapes(self, batch: int, kv_len: int, kv_world: int = 1,
                     dtype: torch.dtype = torch.bfloat16):
        """This rank's cache leaves (``transformer.CacheLeaf``: shape and
        dtype) matching decode_fn's layout, ``batch`` its rows and each
        block's cache sequence cut ``kv_world`` ways (S_loc = kv_len /
        kv_world; a ``kv_len`` that does not divide is refused), K/V and
        conv histories in ``dtype``, recurrent states in fp32: for each
        block of the period a (n_periods, ...) stack, for each ``rem``
        layer its own (None without one)."""
        blocks = tuple({k: l._replace(shape=(self.n_periods,) + l.shape)
                        for k, l in init_cache_shapes(
                            self.cfg, kind, batch, kv_len, kv_world,
                            dtype).items()}
                       for kind in self.period)
        rem = tuple(init_cache_shapes(self.cfg, kind, batch, kv_len,
                                      kv_world, dtype)
                    for kind in self.rem_kinds) if self.rem_spec else None
        return {"blocks": blocks, "rem": rem}

    def init_caches(self, batch: int, kv_len: int,
                    dtype: torch.dtype = torch.bfloat16, kv_world: int = 1):
        def zeros(per):
            return {k: torch.zeros(l.shape, dtype=l.dtype, device=self.device)
                    for k, l in per.items()}
        shapes = self.cache_shapes(batch, kv_len, kv_world, dtype)
        rem = shapes["rem"]
        return {"blocks": tuple(zeros(per) for per in shapes["blocks"]),
                "rem": None if rem is None else tuple(zeros(p) for p in rem)}
