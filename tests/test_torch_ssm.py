"""Port vs reference: the SSM mixers (``models/ssm.py``) and the causal
conv (``layers.causal_conv1d``).

Inputs are numpy draws from seeds, fp32 on both sides.

  * ``ssd_scan`` at ``tests/test_ssm.py``'s shapes, chunks 1, 4 and 8 and
    a prime S (chunk 1), with and without a carried-in state; ``rglru_scan``
    at its shape and a prime S, with and without one: outputs and final
    states against the reference's at rtol = atol = 1e-5, every input's
    gradient against ``jax.grad`` within 1e-5 · max|g|;
  * ``ssd_step`` and ``rglru_step`` against the reference's, and a decode
    token by token against the scan;
  * the overflow case: chunk 128 with a decay span past 88 (dt U[0, 0.2],
    A in [-16, -1]): the reference's ``dt`` gradient holds NaNs (its
    exp-then-where segment sum), the port's is finite and, like every
    other input's, within 1e-4 · max|g| of a float64 sequential
    recurrence's (torch autograd through a loop over the tokens);
  * the scan Function against a sequential loop, forward and backward,
    with a decay broadcast over the state;
  * on 2 and 4 gloo ranks (the sequence cut over the ranks):
    ``ssd_scan`` (with a carried-in state), ``rglru_scan`` and the conv
    with ``gather_conv_halo``'s history equal the unsharded results,
    forward and every gradient (the halo's and the prefix state's reach
    the earlier ranks).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.models import layers as tlayers             # noqa: E402
from repro_torch.models import ssm as tssm                   # noqa: E402
from repro_torch.testing.multirank import run as run_ranks   # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(seed, B, S, nh, hp, G, N, h0, dt=(0.1, 0.9), A=(0.5, 2.0)):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, nh, hp)),
           rng.uniform(*dt, size=(B, S, nh)),
           -rng.uniform(*A, size=(nh,)),
           rng.normal(size=(B, S, G, N)),
           rng.normal(size=(B, S, G, N))]
    if h0:
        out.append(rng.normal(size=(B, nh, N, hp)))
    cts = (rng.normal(size=(B, S, nh, hp)), rng.normal(size=(B, nh, N, hp)))
    return [a.astype(np.float32) for a in out], \
        [c.astype(np.float32) for c in cts]


def _rglru_inputs(seed, B, S, D, h0):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, D)), rng.uniform(0, 1, size=(B, S, D)),
           rng.uniform(0, 1, size=(B, S, D)),
           -rng.uniform(0.1, 3.0, size=(D,))]
    if h0:
        out.append(rng.normal(size=(B, D)))
    cts = (rng.normal(size=(B, S, D)), rng.normal(size=(B, D)))
    return [a.astype(np.float32) for a in out], \
        [c.astype(np.float32) for c in cts]


def _ref_fn(kind, chunk=None):
    from repro.models import ssm as jssm
    if kind == "ssd":
        return lambda x, dt, A, Bm, Cm, h0=None: jssm.ssd_scan(
            x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return lambda x, r, i, la, h0=None: jssm.rglru_scan(x, r, i, la, h0=h0)


def _port_fn(kind, chunk=None):
    if kind == "ssd":
        return lambda x, dt, A, Bm, Cm, h0=None: tssm.ssd_scan(
            x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return lambda x, r, i, la, h0=None: tssm.rglru_scan(x, r, i, la, h0=h0)


def _ref_value_grads(fn, ins, cts):
    """The reference's (y, h) and the gradients of <y, ct_y> + <h, ct_h>
    with respect to every input."""
    import jax
    import jax.numpy as jnp
    args = [jnp.asarray(a) for a in ins]

    def loss(*a):
        y, h = fn(*a)
        return jnp.sum(y * cts[0]) + jnp.sum(h * cts[1]), (y, h)
    g, (y, h) = jax.jit(jax.grad(loss, argnums=tuple(range(len(args))),
                                 has_aux=True))(*args)
    return np.asarray(y), np.asarray(h), [np.asarray(x) for x in g]


def _port_value_grads(fn, ins, cts, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in ins]
    y, h = fn(*ts)
    (torch.sum(y * torch.tensor(cts[0], dtype=dtype))
     + torch.sum(h * torch.tensor(cts[1], dtype=dtype))).backward()
    return (y.detach().numpy(), h.detach().numpy(),
            [t.grad.numpy() for t in ts])


def _hold(port, ref, bar=1e-5):
    """Outputs at rtol = atol = 1e-5, gradients within bar · max|g|."""
    ty, th, tg = port
    jy, jh, jg = ref
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert np.isfinite(a).all(), f"input {i}: non-finite gradient"
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=bar * np.abs(b).max(),
                                   err_msg=f"gradient of input {i}")


# ---------------------------------------------------------------- the scans

SSD_CASES = [(16, 1), (16, 4), (16, 8), (17, 1)]


@pytest.mark.parametrize("h0", (False, True))
@pytest.mark.parametrize("S,chunk", SSD_CASES)
def test_ssd_scan_matches_reference(S, chunk, h0):
    ins, cts = _ssd_inputs(S * 10 + chunk, 2, S, 4, 8, 2, 6, h0)
    _hold(_port_value_grads(_port_fn("ssd", chunk), ins, cts),
          _ref_value_grads(_ref_fn("ssd", chunk), ins, cts))


@pytest.mark.parametrize("h0", (False, True))
@pytest.mark.parametrize("S", (12, 13))
def test_rglru_scan_matches_reference(S, h0):
    ins, cts = _rglru_inputs(S, 2, S, 8, h0)
    _hold(_port_value_grads(_port_fn("rec"), ins, cts),
          _ref_value_grads(_ref_fn("rec"), ins, cts))


def test_steps_match_reference_and_the_scans():
    """``ssd_step``/``rglru_step`` against the reference's, and token by
    token against the scans (the reference's ``test_ssd_step_matches_scan``
    and the decode half of ``test_rglru_matches_naive``)."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    (x, dt, A, Bm, Cm, h0), _ = _ssd_inputs(2, 2, 8, 4, 4, 1, 5, True)
    h = torch.from_numpy(h0)
    ys = []
    for t in range(8):
        args = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        jy, jh = jssm.ssd_step(*map(jnp.asarray, args), jnp.asarray(h))
        y, h = tssm.ssd_step(*map(torch.from_numpy, args), h)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        ys.append(y.numpy())
    sy, sh = tssm.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                           chunk=4, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(np.stack(ys, 1), sy.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), sh.numpy(), rtol=2e-4, atol=2e-4)

    (x, r, i, la, h0), _ = _rglru_inputs(3, 2, 12, 8, True)
    h = torch.from_numpy(h0)
    ys = []
    for t in range(12):
        args = (x[:, t], r[:, t], i[:, t], la)
        jy, jh = jssm.rglru_step(*map(jnp.asarray, args), jnp.asarray(h))
        y, h = tssm.rglru_step(*map(torch.from_numpy, args), h)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        ys.append(y.numpy())
    sy, sh = tssm.rglru_scan(*map(torch.from_numpy, (x, r, i, la)),
                             h0=torch.from_numpy(h0))
    np.testing.assert_allclose(np.stack(ys, 1), sy.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), sh.numpy(), **TOL)


def test_causal_conv_matches_reference():
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    carry = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for c in (None, carry):
        jy, jc = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                       None if c is None else jnp.asarray(c))
        ty, tc = tlayers.causal_conv1d(torch.from_numpy(x),
                                       torch.from_numpy(w),
                                       None if c is None
                                       else torch.from_numpy(c))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ------------------------------------------------------------ the overflow

def _ssd_naive64(x, dt, A, Bm, Cm):
    """The SSD recurrence token by token in float64 (torch autograd):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t, y_t = C_t · h_t."""
    B, S, nh, hp = x.shape
    hg = nh // Bm.shape[2]
    Bh = Bm.repeat_interleave(hg, dim=2)
    Ch = Cm.repeat_interleave(hg, dim=2)
    h = x.new_zeros((B, nh, Bm.shape[3], hp))
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h \
            + dt[:, t, :, None, None] * Bh[:, t, :, :, None] \
            * x[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    return torch.stack(ys, 1), h


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """Chunk 128 at (1, 256, 2, 4), G 1, N 8, dt U[0, 0.2], A in [-16,
    -1]: a chunk's decay span Σ dt·|A| passes 88, where the reference's
    exp(cum_i - cum_j) overflows above the diagonal."""
    ins, cts = _ssd_inputs(0, 1, 256, 2, 4, 1, 8, False, dt=(0.0, 0.2),
                           A=(1.0, 16.0))
    span = max((ins[1][0, c:c + 128] * np.abs(ins[2])).sum(0).max()
               for c in (0, 128))
    assert span > 88, span
    jy, jh, jg = _ref_value_grads(_ref_fn("ssd", 128), ins, cts)
    assert np.isfinite(jy).all() and np.isfinite(jh).all()
    assert np.isnan(jg[1]).any(), "the reference's dt gradient is finite"
    ty, th, tg = _port_value_grads(_port_fn("ssd", 128), ins, cts)
    oy, oh, og = _port_value_grads(_ssd_naive64, ins, cts, torch.float64)
    np.testing.assert_allclose(ty, oy, rtol=1e-4,
                               atol=1e-4 * np.abs(oy).max())
    np.testing.assert_allclose(th, oh, rtol=1e-4,
                               atol=1e-4 * np.abs(oh).max())
    for i, (a, b) in enumerate(zip(tg, og)):
        assert np.isfinite(a).all(), f"input {i}: non-finite gradient"
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"gradient of input {i}")


def test_linear_scan_matches_a_sequential_loop():
    """h_t = a_t h_{t-1} + b_t over 37 steps, a (B, S, 3, 1) broadcast over
    b (B, S, 3, 5): the doubling scan and its reversed-scan backward
    against autograd through the loop."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, size=(2, 37, 3, 1))
    b = rng.normal(size=(2, 37, 3, 5))
    ct = rng.normal(size=b.shape)

    def loop(a, b):
        h, out = torch.zeros_like(b[:, 0]), []
        for t in range(b.shape[1]):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, 1)

    got, want = [], []
    for fn, sink in ((lambda a, b: tssm._LinearScan.apply(a, b, 1), got),
                     (loop, want)):
        ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
        h = fn(ta, tb)
        (h * torch.from_numpy(ct)).sum().backward()
        sink += [h.detach().numpy(), ta.grad.numpy(), tb.grad.numpy()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------- the sequence sharded

SHARD_S, TAPS = 16, 3


def _sharded_rank(rank, world, ssd_in, ssd_ct, rec_in, rec_ct, conv_in):
    """This rank's slice of the sequence through the sharded scans (the
    whole world is the sequence group): outputs and the gradients of its
    share of the loss (its outputs against their cotangent slices; the
    final state's on the last rank, whose final state is the global one)."""
    s = SHARD_S // world
    sl = slice(rank * s, (rank + 1) * s)
    last = rank == world - 1
    seq = ("model",)
    out = {}
    for name, fn, ins, cts in (
            ("ssd", lambda x, dt, A, Bm, Cm, h0: tssm.ssd_scan(
                x, dt, A, Bm, Cm, chunk=2, h0=h0, seq_axes=seq),
             ssd_in, ssd_ct),
            ("rec", lambda x, r, i, la: tssm.rglru_scan(x, r, i, la,
                                                        seq_axes=seq),
             rec_in, rec_ct)):
        ts = [torch.tensor(a[:, sl] if a.ndim >= 3 and a.shape[1] == SHARD_S
                           else a, requires_grad=True) for a in ins]
        y, h = fn(*ts)
        loss = torch.sum(y * torch.from_numpy(cts[0][:, sl]))
        if last:
            loss = loss + torch.sum(h * torch.from_numpy(cts[1]))
        loss.backward()
        out[name] = (y.detach().numpy(), h.detach().numpy(),
                     [t.grad.numpy() for t in ts])
    x, w, ct = conv_in
    tx = torch.tensor(x[:, sl], requires_grad=True)
    halo = tssm.gather_conv_halo(tx, TAPS, seq)
    y, _ = tlayers.causal_conv1d(tx, torch.from_numpy(w), halo)
    torch.sum(y * torch.from_numpy(ct[:, sl])).backward()
    out["halo"] = halo.detach().numpy()
    out["conv"] = (y.detach().numpy(), tx.grad.numpy())
    return out


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_sequence_equals_the_unsharded_scans(world):
    S = SHARD_S
    ssd_in, ssd_ct = _ssd_inputs(8, 2, S, 4, 4, 2, 3, True)
    rec_in, rec_ct = _rglru_inputs(9, 2, S, 6, False)
    rng = np.random.default_rng(10)
    conv_in = [rng.normal(size=(2, S, 5)).astype(np.float32),
               rng.normal(size=(TAPS + 1, 5)).astype(np.float32),
               rng.normal(size=(2, S, 5)).astype(np.float32)]
    ranks = run_ranks(_sharded_rank, world, ssd_in, ssd_ct, rec_in, rec_ct,
                      conv_in)
    for name, fn, ins, cts in (("ssd", _port_fn("ssd", 2), ssd_in, ssd_ct),
                               ("rec", _port_fn("rec"), rec_in, rec_ct)):
        wy, wh, wg = _port_value_grads(fn, ins, cts)
        np.testing.assert_allclose(
            np.concatenate([r[name][0] for r in ranks], 1), wy, **TOL)
        np.testing.assert_allclose(ranks[-1][name][1], wh, **TOL)
        for i, g in enumerate(wg):
            parts = [r[name][2][i] for r in ranks]
            got = np.concatenate(parts, 1) if g.ndim >= 3 and \
                g.shape[1] == S else np.sum(parts, 0)
            np.testing.assert_allclose(got, g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=f"{name} gradient {i}")
    x, w, ct = conv_in
    s = S // world
    for r, res in enumerate(ranks):
        want = x[:, r * s - TAPS:r * s] if r else np.zeros((2, TAPS, 5))
        np.testing.assert_array_equal(res["halo"], want)
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tlayers.causal_conv1d(tx, torch.from_numpy(w))
    torch.sum(y * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(
        np.concatenate([r["conv"][0] for r in ranks], 1), y.detach().numpy(),
        **TOL)
    np.testing.assert_allclose(
        np.concatenate([r["conv"][1] for r in ranks], 1), tx.grad.numpy(),
        **TOL)
