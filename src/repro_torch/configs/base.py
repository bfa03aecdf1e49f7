"""ArchConfig: static description of a dense decoder (own copy of the
reference's ``configs/base.py``, cut to the fields the port's dense
``attn`` path and its flat parameter layout read)."""
from __future__ import annotations

import dataclasses


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
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # mlp (SiLU-gated)
    d_ff: int = 0
    # the unembedding is stored TRANSPOSED (V, d) in this many vocab-row
    # chunks, each gathered on its own; 0 = auto (<= 512 MB per chunk)
    unemb_chunks: int = 0

    @property
    def d_head(self) -> int:
        return self.head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny config of the same shape family for CPU tests (the
        reference's rule for a dense ``attn`` stack)."""
        scale = dict(n_layers=min(self.n_layers, 2), d_model=64, vocab=128,
                     n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
                     head_dim=16, d_ff=96, unemb_chunks=2,
                     name=self.name + "-reduced")
        scale.update(overrides)
        return dataclasses.replace(self, **scale)
