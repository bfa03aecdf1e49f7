"""Deterministic synthetic LM data (the port's own copy of the reference's
``data/synthetic.py``, numpy only; the same draws for the same seed).

An order-1 Markov chain with a low-entropy, seeded transition table: the
conditional distribution is learnable, so loss curves fall toward the
chain's conditional entropy, and every batch is a pure function of (seed,
step, shard).  The frontend stub of the ``embed_inputs`` configs (audio,
vlm) maps tokens through a fixed seeded table (the "precomputed frame /
patch embeddings"), and M-RoPE gets synthetic (t, h, w) positions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    seed: int = 0
    branching: int = 4      # candidate next-tokens per state (entropy knob)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        k = min(self.branching, v)
        self._succ = rng.integers(0, v, size=(v, k))          # successor table
        p = rng.dirichlet(np.full(k, 0.6), size=v)            # skewed probs
        self._cum = np.cumsum(p, axis=1).astype(np.float64)

    @property
    def entropy_bound(self) -> float:
        """Mean conditional entropy (nats) — the best achievable LM loss."""
        p = np.diff(np.concatenate([np.zeros((self.vocab, 1)), self._cum], 1))
        p = np.clip(p, 1e-12, 1)
        return float(-(p * np.log(p)).sum(1).mean())

    def batch(self, step: int, batch_size: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        """(batch_size, seq_len+1) tokens; pure function of its arguments."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard * 257)
        assert batch_size % n_shards == 0
        b = batch_size // n_shards
        out = np.empty((b, self.seq_len + 1), np.int32)
        state = rng.integers(0, self.vocab, size=b)
        u = rng.random((b, self.seq_len + 1))
        for t in range(self.seq_len + 1):
            out[:, t] = state
            nxt = (u[:, t, None] < self._cum[state]).argmax(axis=1)
            state = self._succ[state, nxt]
        return out


@functools.lru_cache(maxsize=2)
def stub_table(vocab: int, d_model: int) -> np.ndarray:
    """The frontend stub's fixed (vocab, d_model) fp32 projection table:
    the reference's ``default_rng(vocab * 7 + 13)`` normal draws times
    0.05, bit for bit.  Drawn row block by row block (one generator, so
    the same stream as one call) and kept for the last two (vocab,
    d_model): qwen2-vl-72b's is 1.25 B draws, 4.98 GB, too costly to
    redraw each step.  Read-only: batches gather copies of its rows."""
    rng = np.random.default_rng(vocab * 7 + 13)
    table = np.empty((vocab, d_model), np.float32)
    rows = max(1, (1 << 24) // d_model)
    for r in range(0, vocab, rows):
        n = min(rows, vocab - r)
        table[r:r + n] = rng.standard_normal((n, d_model)) * 0.05
    table.flags.writeable = False
    return table


def make_batch(arch: ArchConfig, lm: SyntheticLM, step: int,
               global_batch: int) -> Dict[str, np.ndarray]:
    """GLOBAL batch dict for one train step: next-token ``targets``
    (global_batch, seq_len) int32, and ``tokens`` (the same shape), or
    with ``arch.embed_inputs`` the stub's ``embeds`` (global_batch,
    seq_len, d_model) float32; with ``arch.mrope`` the stub's
    ``positions`` (3, global_batch, seq_len) int32: (t, t // 16, t % 16)
    — the reference's draws and layout."""
    toks = lm.batch(step, global_batch)
    batch = {"targets": toks[:, 1:].astype(np.int32)}
    B, S = batch["targets"].shape
    if arch.embed_inputs:
        batch["embeds"] = stub_table(arch.vocab, arch.d_model)[toks[:, :-1]]
    else:
        batch["tokens"] = toks[:, :-1].astype(np.int32)
    if arch.mrope:
        # text-like ramp on t, a coarse grid on h and w
        t = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        batch["positions"] = np.stack([t, t // 16, t % 16]).astype(np.int32)
    return batch
