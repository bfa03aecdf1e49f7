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
    read (recorded by :func:`recording`, mapped onto the buffers by
    :func:`path_steps`), and the bars take it in place of the final
    block's step.  A three-axis world reads as (Y, X) with Y the product
    of its slower axes (the inter group's ranks in row-major order).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.kernels import ops as _kops
from repro_torch.optim.adamw import AdamWConfig

BLOCK = 256          # the qgZ quantization block


def far_share(shape=(1, 1), two_hop: bool = True) -> float:
    """The share of elements allowed beyond the tight bar under qgZ on a
    ``(Y, X)`` or ``(P, Y, X)`` world (Y: the product of every axis but
    the last): 1 in 2,000 per quantization an element's gradient passes
    through, which is Y·X (B3, each rank's contribution) plus Y (B4, the
    requantized sum of each intra group), or Y·X alone on the 1-hop
    (``two_hop=False``, each contribution quantized once): 1 in 1,000 at
    world 1, 3 in 1,000 at 2 × 2, 6 in 1,000 at 2 × 2 × 2."""
    x = shape[-1]
    y = 1
    for s in shape[:-1]:
        y *= s
    return (y * x + (y if two_hop else 0)) / 2000


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


def _yx(shape):
    y = 1
    for s in shape[:-1]:
        y *= s
    return y, shape[-1]


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
    y, x = _yx(shape)
    out = []
    for r in range(y * x):
        d, m = divmod(r, x)
        bar = np.asarray(b5_scales[r], np.float64).sum(axis=0)
        for yy in range(y):
            b4 = np.asarray(b4_scales[yy * x + m], np.float64)
            bar = bar + b4.reshape(x, y, -1)[:, d].sum(axis=0)
        out.append(bar)
    return np.concatenate(out)


@contextlib.contextmanager
def recording(scales: Dict[str, List[np.ndarray]]):
    """Record the scales B4 (``dequant_reduce_quant``) and B5
    (``dequant_reduce``) read, per call on the CPU, into
    ``scales["b4"]``/``["b5"]``."""
    real = {"b4": _kops.dequant_reduce_quant, "b5": _kops.dequant_reduce}
    names = {"b4": "dequant_reduce_quant", "b5": "dequant_reduce"}

    def rec(key):
        def f(payload, sc, *a, **kw):
            scales.setdefault(key, []).append(sc.numpy().copy())
            return real[key](payload, sc, *a, **kw)
        return f
    for key, name in names.items():
        setattr(_kops, name, rec(key))
    try:
        yield
    finally:
        for key, name in names.items():
            setattr(_kops, name, real[key])


def path_steps(per_rank: Sequence[Mapping], grads: Mapping, shape,
               two_hop: bool = True) -> Dict[str, np.ndarray]:
    """Each gradient block's bar from the scales every rank's B4 and B5
    read in one backward (``per_rank[r]``: :func:`recording`'s dict),
    (rows, blocks) per buffer: :func:`qgz_path_steps` on the 2-hop; on the
    1-hop (``two_hop=False``) one step of each of the W blocks its B5
    sums (each contribution quantized once).  The reduces run in the
    backward's order: the groups stacked in rows (the layers, the
    unembedding chunks) last row first."""
    world = len(per_rank)
    by_nb: Dict[int, list] = {}
    b5s = zip(*(r["b5"] for r in per_rank))
    b4s = zip(*(r["b4"] for r in per_rank)) if two_hop else None
    for b5 in b5s:
        if two_hop:
            bar = qgz_path_steps(next(b4s), b5, shape)
        else:
            bar = np.concatenate([np.asarray(b, np.float64).sum(axis=0)
                                  for b in b5])
        by_nb.setdefault(b5[0].shape[-1], []).append(bar)
    out = {}
    for k, g in grads.items():
        rows = g.reshape(-1, g.shape[-1])
        got = by_nb.pop(rows.shape[1] // world // BLOCK)
        assert len(got) == rows.shape[0], (k, len(got))
        out[k] = np.stack(got[::-1])
    assert not by_nb, sorted(by_nb)
    return out


def grads_within_int4(tg: Mapping, jg: Mapping, far: float = 1e-3,
                      steps: Optional[Mapping] = None) -> None:
    """qgZ on: every gradient within one INT4 step of its block (or of
    ``steps[k]``, one per block, from :func:`path_steps`), fewer than
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


def global_params(model, seed: int) -> dict:
    """GLOBAL fp32 buffers of ``model``'s flat layout, numpy draws by the
    reference's per-name rules (``Model._init_rule``: normal at its scale,
    the SSM's uniform ranges; norms, biases and padding zero;
    no ``embed`` where the model has none; an MoE model's ``experts``
    after ``blocks``): the state both sides of a
    step comparison start from."""
    rng = np.random.default_rng(seed)

    def flat(spec):
        out = np.zeros(spec.padded_size, np.float32)
        for name, shape in spec.entries:
            rule = type(model)._init_rule(name, shape)
            if rule is None:
                continue
            off, n = spec.offsets[name]
            kind, *arg = rule
            if kind == "normal":
                out[off:off + n] = rng.standard_normal(n) * arg[0]
            elif kind == "ones":
                out[off:off + n] = 1.0
            else:
                v = rng.uniform(arg[0], arg[1], n)
                out[off:off + n] = np.log(v) if kind == "log_uniform" else v
        return out
    out = {"embed": flat(model.embed_spec)} if model.embed_spec else {}
    out["blocks"] = np.stack([flat(model.period_spec)
                              for _ in range(model.n_periods)])
    if model.expert_spec is not None:
        out["experts"] = np.stack([
            np.stack([flat(model.expert_spec)
                      for _ in range(model.cfg.expert_chunks)])
            for _ in range(model.n_periods)])
    if model.rem_spec:
        out["rem"] = flat(model.rem_spec)
    out["head"] = flat(model.head_spec)
    out["unemb"] = np.stack([flat(model.unemb_spec)
                             for _ in range(model.unemb_chunks)])
    return out


def _glued(per_rank: Sequence[Mapping], part: str) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([r[part][k] for r in per_rank], axis=-1)
            for k in per_rank[0][part]}


def hold_qgz_step(per_rank: Sequence[Mapping], ref: Mapping, name: str,
                  shape, lr: float, two_hop: bool = True) -> None:
    """One step with qgZ on, every rank's against the reference's, in one
    call.  ``per_rank[r]``: rank r's ``loss`` and ``met`` (its
    ``loss_and_grads`` loss and its step's metrics), ``scales``
    (:func:`recording` over ``loss_and_grads``), the shards ``grads``,
    ``params`` and ``opt`` (numpy), and the step's counted bytes ``comm``
    with their ``projected``; ``ref``: the reference's arrays under
    ``<name>.loss``, ``<name>.{g,p,m,v,met}.<key>``.  Holds the loss and
    metrics (1e-5), the gradients and moments within :func:`path_steps`
    (a share :func:`far_share` beyond the tight bar), the parameters
    within :func:`params_near`, and every rank's bytes per ``zero.*``
    label equal to the projection."""
    def tree(prefix):
        return {k[len(prefix):]: v for k, v in ref.items()
                if k.startswith(prefix)}
    loss = sum(r["loss"] for r in per_rank)
    assert abs(loss - float(ref[name + ".loss"])) <= 1e-5, \
        (loss, ref[name + ".loss"])
    mets = [r["met"] for r in per_rank]
    assert all(m == mets[0] for m in mets), "ranks disagree on the metrics"
    jm = tree(name + ".met.")
    assert abs(mets[0]["loss"] - float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(mets[0]["nll"], jm["nll"], rtol=1e-5)
    tg, jg = _glued(per_rank, "grads"), tree(name + ".g.")
    far = far_share(shape, two_hop)
    steps = path_steps([r["scales"] for r in per_rank], jg, shape, two_hop)
    grads_within_int4(tg, jg, far, steps)
    gdiff = np.sqrt(sum(np.sum((tg[k].astype(np.float64) - jg[k]) ** 2)
                        for k in tg))
    jn = float(jm["grad_norm"])
    assert abs(mets[0]["grad_norm"] - jn) <= gdiff + 1e-5 * jn
    to = {mv: {k: np.concatenate([r["opt"][mv][k] for r in per_rank],
                                 axis=-1) for k in tg} for mv in ("m", "v")}
    jo = {mv: tree(f"{name}.{mv}.") for mv in ("m", "v")}
    clip = min(1.0, 1.0 / (jn + 1e-12))
    moments_within_int4(to, jo, far,
                        g_steps={k: v * clip for k, v in steps.items()})
    tp, jp = _glued(per_rank, "params"), tree(name + ".p.")
    params_near(tp, jp, {k: moment_dir(to, k) for k in tp},
                {k: moment_dir(jo, k) for k in tp}, lr, far)
    for r in per_rank:
        zero = {k: v for k, v in r["comm"].items() if k != "other"}
        assert zero == r["projected"], (name, r["comm"], r["projected"])
