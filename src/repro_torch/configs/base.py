"""ArchConfig: static description of a decoder (own copy of the
reference's ``configs/base.py``, cut to the fields the port's ``attn`` and
``local`` blocks and its flat parameter layout read)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
    # kinds: attn (global causal GQA + MLP), local (sliding-window GQA + MLP)
    pattern: Tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0                  # sliding window of the "local" layers
    # mlp (gated: act(gate) * up)
    d_ff: int = 0
    act: str = "silu"                # silu | gelu (tanh approximation)
    # the unembedding is stored TRANSPOSED (V, d) in this many vocab-row
    # chunks, each gathered on its own; 0 = auto (<= 512 MB per chunk)
    unemb_chunks: int = 0

    @property
    def d_head(self) -> int:
        return self.head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny config of the same shape family for CPU tests (the
        reference's rule: a multi-kind pattern keeps one whole period)."""
        scale = dict(n_layers=max(len(self.pattern), 2)
                     if len(self.pattern) > 1 else min(self.n_layers, 2),
                     d_model=64, vocab=128,
                     n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
                     head_dim=16, d_ff=96,
                     window=min(self.window, 8) if self.window else 0,
                     unemb_chunks=2, name=self.name + "-reduced")
        scale.update(overrides)
        return dataclasses.replace(self, **scale)
