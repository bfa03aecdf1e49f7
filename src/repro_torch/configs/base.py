"""ArchConfig: static description of a decoder (own copy of the
reference's ``configs/base.py``, cut to the fields the port's ``attn``,
``local``, ``moe``, ``ssd`` and ``rec`` blocks, its inputs and its flat
parameter layout read), and the named workload shapes the serving shape
policy and the dry run read (``ShapeConfig``, ``SHAPES``,
``shape_supported``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # block pattern, tiled over n_layers: one period of it per layer group,
    # the n_layers % len(pattern) leftover layers in a group of their own.
    # kinds: attn (global causal GQA + MLP), local (sliding-window GQA +
    # MLP), moe (global causal GQA + a mixture-of-experts MLP), ssd (a
    # Mamba-2 block, no separate MLP), rec (an RG-LRU block + MLP)
    pattern: Tuple[str, ...] = ("attn",)
    # attention (0 heads: a stack without attention)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False           # bq/bk/bv added before the head split
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False              # Qwen2-VL 3-stream rotary (t, h, w)
    logit_softcap: float = 0.0       # attention logits: c·tanh(x / c)
    window: int = 0                  # sliding window of the "local" layers
    # mlp (gated: act(gate) * up)
    d_ff: int = 0
    act: str = "silu"                # silu | gelu (tanh approximation)
    # moe: n_shared always-on experts + n_experts routed, top_k a token
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_ff: int = 0                  # per-routed-expert hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # the routed experts are gathered expert_chunks at a time (one flat
    # group per chunk): bounds the gathered working set
    expert_chunks: int = 1
    # the unembedding is stored TRANSPOSED (V, d) in this many vocab-row
    # chunks, each gathered on its own; 0 = auto (<= 512 MB per chunk)
    unemb_chunks: int = 0
    # ssm (mamba-2): state size N, head dim, d_inner = expand · d_model,
    # groups of B/C, the SSD chunk; conv_width: the depthwise causal conv
    # of ssd and rec blocks
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    conv_width: int = 4
    # rg-lru: the recurrence width (0: d_model)
    rnn_width: int = 0
    # io: a frontend stub supplies (B, S, d_model) embeddings (audio, vlm);
    # the model then has no embedding group
    embed_inputs: bool = False
    # sub-quadratic in the context (window or recurrence): may run the
    # long_500k shape (``shape_supported``)
    long_context: bool = False

    @property
    def d_head(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        """Channels of the ssd block's conv: x, B and C together."""
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def d_rnn(self) -> int:
        return self.rnn_width or self.d_model

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny config of the same shape family for CPU tests (the
        reference's rule: a multi-kind pattern keeps one whole period;
        qkv_bias, mrope, logit_softcap and embed_inputs are kept; an MoE
        keeps 8 experts, top_k <= 2, n_shared <= 1, in 2 chunks; no heads
        and no MLP where the config has none; an SSM keeps state 16, head
        dim 8, chunk 4; an RG-LRU width 64)."""
        scale = dict(n_layers=max(len(self.pattern), 2)
                     if len(self.pattern) > 1 else min(self.n_layers, 2),
                     d_model=64, vocab=128,
                     n_heads=4 if self.n_heads else 0,
                     n_kv_heads=min(self.n_kv_heads, 2),
                     head_dim=16 if self.n_heads else 0,
                     d_ff=96 if self.d_ff else 0,
                     window=min(self.window, 8) if self.window else 0,
                     n_experts=8 if self.n_experts else 0,
                     top_k=min(self.top_k, 2) if self.top_k else 0,
                     n_shared=min(self.n_shared, 1),
                     moe_ff=32 if self.moe_ff else 0,
                     expert_chunks=2 if self.n_experts else 1,
                     unemb_chunks=2,
                     ssm_state=16 if self.ssm_state else 0,
                     ssm_headdim=8 if self.ssm_state else 64,
                     ssm_expand=2, ssm_chunk=4,
                     rnn_width=64 if self.rnn_width else 0,
                     name=self.name + "-reduced")
        scale.update(overrides)
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch × shape) matrix."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_supported(arch: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether ``arch`` runs the named shape, and why not (the
    reference's rule: only a long-context config decodes 500k tokens)."""
    if shape == "long_500k" and not arch.long_context:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "requires sub-quadratic attention")
    return True, ""
