"""Token sampling: temperature / top-k / top-p with per-request generators.

Port of the reference's ``serve/sampling.py``.  Pure functions over a
trailing vocab axis.  Seed discipline: every request owns a CPU
``torch.Generator`` seeded from its integer seed and draws its tokens from
it in order, so its stream is reproducible whichever requests share its
decode batches.  (The reference folds the token index into a JAX key;
the two give different numbers from the same seed.  Greedy decoding,
temperature 0, uses no randomness and is the parity case.)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask keeping exactly the k largest entries of the last axis."""
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return torch.ones(logits.shape, dtype=torch.bool,
                          device=logits.device)
    flat = logits.reshape(-1, V)
    idx = torch.topk(flat, k, dim=-1).indices
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=logits.device)
    mask.scatter_(1, idx, True)
    return mask.reshape(logits.shape)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: the smallest prefix of probability-sorted tokens whose
    cumulative probability reaches ``p`` (the argmax is always kept)."""
    V = logits.shape[-1]
    if p >= 1.0:
        return torch.ones(logits.shape, dtype=torch.bool,
                          device=logits.device)
    flat = logits.reshape(-1, V).to(torch.float32)
    srt, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    probs = torch.softmax(srt, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # token i stays while the mass BEFORE it is < p; the first always stays
    keep_sorted = (csum - probs) < p
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=logits.device)
    mask.scatter_(1, order, keep_sorted)
    return mask.reshape(logits.shape)


def sample_logits(logits: torch.Tensor, gen: torch.Generator,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Sample token ids from (..., V) logits.  temperature 0 is greedy
    argmax (``gen`` unused); otherwise top-k, then top-p, then a
    categorical draw at the given temperature from ``gen`` (a CPU
    generator: the probabilities move to the host for the draw)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = logits.to(torch.float32) / temperature
    if top_k:
        l = torch.where(top_k_mask(l, top_k), l, NEG_INF)
    if top_p < 1.0:
        l = torch.where(top_p_mask(l, top_p), l, NEG_INF)
    probs = torch.softmax(l, dim=-1).reshape(-1, l.shape[-1]).cpu()
    draw = torch.multinomial(probs, 1, generator=gen)
    return draw.reshape(l.shape[:-1])


def request_generator(seed: int) -> torch.Generator:
    """The per-request sampling stream."""
    g = torch.Generator()
    g.manual_seed(seed)
    return g
