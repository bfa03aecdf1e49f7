"""Bars for one training step of the port held against the reference's.

Shared by the CPU tests that run both sides on the same fp32 state (one
rank, ``tests/test_torch_train.py``; gloo ranks,
``tests/test_torch_train_multirank.py``).  Arrays are numpy, global or a
rank's shard alike.

  * :func:`close` — rtol 1e-5 / atol 1e-6: only fp32 summation order
    differs;
  * after one AdamW step a parameter moves by lr·(ĝ + wd·w) with the first
    step's direction ĝ = g/(|g| + eps), which turns a 1e-9 gradient
    difference into a visible one where |g| is near eps: :func:`params_near`
    adds lr·|ĝ_port − ĝ_ref| to the bar, each side's direction read from
    its own gradient (:func:`first_step_dir`) or moments
    (:func:`moment_dir`), and holds the tight bar alone where the
    direction is stable;
  * with qgZ on, a gradient element may differ beyond the tight bar only
    by at most one INT4 step of its block (the block's absmax / 7) and in
    fewer than 1 of 1,000 elements (:func:`grads_within_int4`); after the
    step the same holds of m (linear in the gradient) and of v = (1 −
    b2)·g², whose step is (1 − b2)·step·(|g_port| + |g_ref|)
    (:func:`moments_within_int4`).  The inputs to qgZ differ in the last
    float bits, so a value on a rounding boundary may land on either side:
    the share of such elements grows with the quantizations an element
    passes through, :func:`far_share` (1 in 1,000 at world 1).
    "One INT4 step of its block" is the step of the final block, which B4
    quantized, only where the world has one row (Y = 1).  At Y > 1 the
    final gradient is the fp32 sum of Y requantized contributions, each of
    the X contributions to them quantized at its own rank, so a rounding
    flip moves an element by one step of the block that flipped, not of
    the final sum: :func:`qgz_path_steps` bounds what the flips on an
    element's path can move it by, from the scales the ranks' B4 and B5
    read, and the bars take it in place of the final block's step.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.optim.adamw import AdamWConfig

BLOCK = 256          # the qgZ quantization block


def far_share(shape=(1, 1)) -> float:
    """The share of elements allowed beyond the tight bar under qgZ on a
    ``(Y, X)`` world: 1 in 2,000 per quantization an element's gradient
    passes through, which is Y·X (B3, each rank's contribution) plus Y
    (B4, the requantized sum of each intra group): 1 in 1,000 at world 1,
    3 in 1,000 at 2 × 2."""
    y, x = shape
    return (y * x + y) / 2000


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)


def first_step_dir(g, gnorm: float, clip: float = 1.0, eps: float = 1e-8):
    """AdamW's first-step direction m̂/(√v̂ + eps) = g/(|g| + eps) on the
    clipped gradient, in float64."""
    gs = g.astype(np.float64) * (clip / (gnorm + 1e-12) if gnorm > clip
                                 else 1.0)
    return gs / (np.abs(gs) + eps)


def moment_dir(o: Mapping, k: str, cfg: AdamWConfig = AdamWConfig()):
    """A side's first-step direction m̂/(√v̂ + eps), read from its own
    moments after the step, in float64."""
    m = o["m"][k].astype(np.float64) / (1 - cfg.b1)
    v = o["v"][k].astype(np.float64) / (1 - cfg.b2)
    return m / (np.sqrt(v) + cfg.eps)


def params_near(tp: Mapping, jp: Mapping, t_dir: Mapping, j_dir: Mapping,
                lr: float, far: float = 1e-3) -> None:
    """Parameters after a first step: rtol 1e-5 / atol 1e-6 plus what the
    two sides' own directions move apart; the tight bar alone where the
    direction is stable, which it must be in all but a share ``far`` of
    the elements."""
    for k in tp:
        amp = lr * np.abs(t_dir[k] - j_dir[k])
        bar = 1e-6 + 1e-5 * np.abs(jp[k]) + amp
        assert np.all(np.abs(tp[k] - jp[k]) <= bar), f"param {k}"
        # where the direction is stable the tight bar holds on its own
        stable = amp < 1e-7
        assert stable.mean() > 1 - far, (k, stable.mean())
        close(tp[k][stable], jp[k][stable], f"param {k} (stable)")


def within_int4_step(got, want, step, what: str):
    """Every element within one INT4 step (per block of 256) of the
    reference's, and fewer than 1 in 1,000 beyond rtol 1e-5 / atol 1e-6.
    Returns (elements beyond the tight bar, elements)."""
    assert np.all(np.abs(got - want) <= step * (1 + 1e-5) + 1e-12), what
    far = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    return int(far.sum()), got.size


def _steps(a):
    return np.abs(a).max(axis=1, keepdims=True) / 7


def qgz_path_steps(b4_scales: Sequence, b5_scales: Sequence,
                   shape) -> np.ndarray:
    """What rounding flips can move each block of one qgZ reduce by on a
    ``(Y, X)`` world, (W·NB,) in global block order: for the shard of rank
    (d, m), the sum over the Y contributions of one step of the block B4
    requantized (the scales rank (d, m)'s B5 reads, ``b5_scales[r]`` (Y,
    NB)) plus one step of each of the X blocks B3 quantized into it (the
    scales rank (y, m)'s B4 reads for slice d, ``b4_scales[r]`` (X, Y·NB)).
    A flip of one of B3's roundings moves B4's input by its step, and B4's
    rounding moves its output by at most that plus one of its own steps."""
    y, x = shape
    out = []
    for r in range(y * x):
        d, m = divmod(r, x)
        bar = np.asarray(b5_scales[r], np.float64).sum(axis=0)
        for yy in range(y):
            b4 = np.asarray(b4_scales[yy * x + m], np.float64)
            bar = bar + b4.reshape(x, y, -1)[:, d].sum(axis=0)
        out.append(bar)
    return np.concatenate(out)


def grads_within_int4(tg: Mapping, jg: Mapping, far: float = 1e-3,
                      steps: Optional[Mapping] = None) -> None:
    """qgZ on: every gradient within one INT4 step of its block (or of
    ``steps[k]``, one per block, from :func:`qgz_path_steps`), fewer than
    a share ``far`` of the elements beyond the tight bar."""
    n_far = n = 0
    for k in tg:
        got, want = tg[k].reshape(-1, BLOCK), jg[k].reshape(-1, BLOCK)
        step = _steps(want) if steps is None else steps[k].reshape(-1, 1)
        f, c = within_int4_step(got, want, step, f"grad {k}")
        n_far, n = n_far + f, n + c
    assert n_far < n * far, (n_far, n)


def moments_within_int4(to: Mapping, jo: Mapping, far: float = 1e-3,
                        cfg: AdamWConfig = AdamWConfig(),
                        g_steps: Optional[Mapping] = None) -> None:
    """m and v after one step from gradients held by
    :func:`grads_within_int4` (``g_steps``: its ``steps``, scaled by the
    step's clip factor)."""
    n_far = n = 0
    for k in to["m"]:
        mt, mj = to["m"][k].reshape(-1, BLOCK), jo["m"][k].reshape(-1, BLOCK)
        vt, vj = to["v"][k].reshape(-1, BLOCK), jo["v"][k].reshape(-1, BLOCK)
        gt, gj = (np.sqrt(a.astype(np.float64) / (1 - cfg.b2))
                  for a in (vt, vj))
        if g_steps is None:
            m_step, step = _steps(mj), gj.max(axis=1, keepdims=True) / 7
        else:
            step = g_steps[k].reshape(-1, 1)
            m_step = (1 - cfg.b1) * step
        f, c = within_int4_step(mt, mj, m_step, f"m {k}")
        n_far, n = n_far + f, n + c
        f, c = within_int4_step(vt, vj, (1 - cfg.b2) * step * (gt + gj),
                                f"v {k}")
        n_far, n = n_far + f, n + c
    assert n_far < n * far, (n_far, n)
