"""ArchConfig: static description of a decoder (own copy of the
reference's ``configs/base.py``, cut to the fields the port's ``attn``,
``local`` and ``moe`` blocks, its inputs and its flat parameter layout
read), and the
named workload shapes the serving shape policy reads (``ShapeConfig``,
``SHAPES``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int
    n_kv_heads: int
    head_dim: int
    # block pattern, tiled over n_layers: one period of it per layer group,
    # the n_layers % len(pattern) leftover layers in a group of their own.
    # kinds: attn (global causal GQA + MLP), local (sliding-window GQA +
    # MLP), moe (global causal GQA + a mixture-of-experts MLP)
    pattern: Tuple[str, ...] = ("attn",)
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
    # io: a frontend stub supplies (B, S, d_model) embeddings (audio, vlm);
    # the model then has no embedding group
    embed_inputs: bool = False

    @property
    def d_head(self) -> int:
        return self.head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny config of the same shape family for CPU tests (the
        reference's rule: a multi-kind pattern keeps one whole period;
        qkv_bias, mrope, logit_softcap and embed_inputs are kept; an MoE
        keeps 8 experts, top_k <= 2, n_shared <= 1, in 2 chunks)."""
        scale = dict(n_layers=max(len(self.pattern), 2)
                     if len(self.pattern) > 1 else min(self.n_layers, 2),
                     d_model=64, vocab=128,
                     n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
                     head_dim=16, d_ff=96,
                     window=min(self.window, 8) if self.window else 0,
                     n_experts=8 if self.n_experts else 0,
                     top_k=min(self.top_k, 2) if self.top_k else 0,
                     n_shared=min(self.n_shared, 1),
                     moe_ff=32 if self.moe_ff else 0,
                     expert_chunks=2 if self.n_experts else 1,
                     unemb_chunks=2, name=self.name + "-reduced")
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
