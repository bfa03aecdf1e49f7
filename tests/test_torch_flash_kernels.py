"""Port vs reference: the flash-attention pair B6/B7 and its route in mha.

The port's ``flash_fwd``/``flash_bwd`` on CPU tensors take their plain
versions (``kernels/ref.py``) at the reference's default tiles; they are
held against the reference's ``flash_fwd_pallas``/``flash_bwd_pallas`` in
interpret mode on the same numpy inputs, across the reference's own sweep
(``tests/test_flash_kernels.py``: GQA 1/2/4, window, softcap, both, and
its tiles passed as bq/bk) and one bf16 case at S = 512 with 512 tiles.
The plain versions ``ref.flash_fwd_ref``/``flash_bwd_ref``, which alone
take tiles, are held the same way at each case's tiles.

Tolerances:
  * f32: the reference's own bars, rtol/atol 2e-5 forward (out, m, l) and
    3e-5 backward (dq, dk, dv): only fp32 summation order differs;
  * bf16 outputs, element by element (``repro_torch.testing.flash_bars``):
    out within 2^-7 of its row's sum p|v|/l plus one bf16 ulp, the most
    the two sides' bf16 roundings of p and of out can differ by; dq, dk,
    dv within one bf16 ulp plus the fp32 bar 3e-5, from the reference's
    own saved (out, m, l), since a one-ulp difference in out would move
    dsum; m and l stay fp32 at rtol 2e-5.

``test_tensor_core_split_prices_the_backward`` emulates the precision of
the card's bf16 backward (QKᵀ and dO·Vᵀ on bf16 operands into fp32; p and
dl enter dl·K, pᵀ·dO and dlᵀ·Q as bf16 hi + lo pairs) in plain torch and
holds it against the reference's fp32 ``flash_bwd_pallas`` at the
per-element bf16 bars; p and dl as bf16 alone are printed beside it.

``mha(impl="pallas")`` must take the flash route exactly where the
reference's rule does (S >= 512, S and Sq multiples of 512): at S = 256
it takes the dense path and launches nothing of the pair, at S = 512 the
flash kernels.  Both are held against the reference's
``mha(impl="pallas")``, forward and gradients, at f32 3e-5.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.kernels.flash_attention import (                  # noqa: E402
    flash_bwd_pallas, flash_fwd_pallas)
from repro.models import attention as jattn                  # noqa: E402

from repro_torch.kernels import flash_ops, ops, ref          # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.testing import flash_bars                   # noqa: E402

# B, S, H, K, hd, window, softcap, bq, bk, dtype
CASES = [
    (2, 64, 4, 4, 32, 0, 0.0, 16, 16, "f32"),      # GQA 1
    (1, 128, 8, 2, 64, 0, 0.0, 32, 64, "f32"),     # GQA 4
    (2, 64, 4, 1, 32, 16, 0.0, 16, 16, "f32"),     # window
    (1, 64, 4, 2, 64, 0, 30.0, 32, 32, "f32"),     # softcap, GQA 2
    (1, 128, 2, 2, 32, 32, 20.0, 64, 32, "f32"),   # window + softcap
    (1, 512, 4, 2, 64, 0, 0.0, 512, 512, "bf16"),  # the path's tiles
    (1, 512, 2, 1, 256, 0, 0.0, 256, 256, "f32"),  # hd 256 (gemma3-4b)
    (1, 512, 2, 1, 256, 300, 0.0, 256, 128, "f32"),  # hd 256, its window
]
IDS = ["gqa1", "gqa4", "window", "softcap", "window_softcap", "bf16_s512",
       "hd256", "hd256_window"]


def _inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                      (B, S, H, hd))]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _within(got: torch.Tensor, want: torch.Tensor, bar: torch.Tensor,
            what: str) -> None:
    ratio, err = flash_bars.worst(got, want, bar)
    assert ratio <= 1, (what, ratio, err)


@pytest.mark.parametrize("B,S,H,K,hd,window,softcap,bq,bk,dtype", CASES,
                         ids=IDS)
def test_flash_pair_matches_reference(B, S, H, K, hd, window, softcap, bq,
                                      bk, dtype):
    q, k, v, g = _inputs(B, S, H, K, hd, seed=B * S + H)
    scale = hd ** -0.5
    kw = dict(scale=scale, causal=True, window=window, softcap=softcap)
    tiles = dict(bq=bq, bk=bk)
    jt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tt = torch.float32 if dtype == "f32" else torch.bfloat16
    jq, jk, jv, jg = (jnp.asarray(a, jt) for a in (q, k, v, g))
    jo, jm, jl = flash_fwd_pallas(jq, jk, jv, interpret=True, **kw, **tiles)
    # the same bf16 values on both sides: round through JAX, cross as f32
    tq, tk, tv, tg = (_t(a).to(tt) for a in (jq, jk, jv, jg))
    saved = (_t(jo).to(tt), _t(jm), _t(jl))
    jd = flash_bwd_pallas(jq, jk, jv, jo, jm, jl, jg, interpret=True, **kw,
                          **tiles)
    for port, extra in (("ops", {}), ("ref", tiles)):
        fwd = ops.flash_fwd if port == "ops" else ref.flash_fwd_ref
        bwd = ops.flash_bwd if port == "ops" else ref.flash_bwd_ref
        to, tm, tl = fwd(tq, tk, tv, **kw, **extra)
        assert to.dtype == tt and tm.dtype == tl.dtype == torch.float32
        assert tuple(tm.shape) == (B, H, S)
        for name, got, want in (("m", tm, jm), ("l", tl, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{port} {name}")
        if dtype == "f32":
            td = bwd(tq, tk, tv, to, tm, tl, tg, **kw, **extra)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{port} out")
            for name, got, want in zip(("dq", "dk", "dv"), td, jd):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=3e-5, atol=3e-5,
                                           err_msg=f"{port} {name}")
        else:
            want = saved[0]
            _within(to, want, flash_bars.out_bar(tq, tk, tv, want, **kw),
                    f"{port} out")
            td = bwd(tq, tk, tv, *saved, tg, **kw, **extra)
            for name, got, want in zip(("dq", "dk", "dv"), td, jd):
                assert got.dtype == tt
                want = _t(want)
                _within(got, want, flash_bars.grad_bar(want),
                        f"{port} {name}")


@pytest.mark.parametrize("S,route", [(256, "dense"), (512, "flash")])
def test_mha_pallas_routes_as_the_reference(S, route, monkeypatch):
    """The port's ``mha(impl="pallas")`` against the reference's, forward
    and gradients (f32, GQA 4/2, hd 32), and the route it took."""
    B, H, K, hd = 1, 4, 2, 32
    q, k, v, g = _inputs(B, S, H, K, hd, seed=S)

    def ref(a, b, c):
        return jattn.mha(a, b, c, causal=True, impl="pallas")
    jo, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = [jo, *vjp(jnp.asarray(g))]

    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = ops.flash_fwd, ops.flash_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)
    monkeypatch.setattr(flash_ops.ops, "flash_fwd", fwd)
    monkeypatch.setattr(flash_ops.ops, "flash_bwd", bwd)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = tattn.mha(tq, tk, tv, impl="pallas")
    to.backward(torch.from_numpy(g))
    assert calls == ({"fwd": 1, "bwd": 1} if route == "flash"
                     else {"fwd": 0, "bwd": 0}), calls
    got = [to.detach(), tq.grad, tk.grad, tv.grad]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5,
                                   atol=3e-5, err_msg=name)


def test_wrappers_refuse_bad_shapes_and_impls():
    q = torch.zeros(1, 64, 4, 16)
    with pytest.raises(ValueError, match="H % K"):
        ops.flash_fwd(q, torch.zeros(1, 64, 3, 16), torch.zeros(1, 64, 3, 16),
                      scale=0.25)
    with pytest.raises(ValueError, match="impl"):
        tattn.mha(q, q, q, impl="triton")


def _split(x: torch.Tensor, terms: int) -> torch.Tensor:
    """``x`` as the sum of ``terms`` bf16 values, each the bf16 rounding of
    what the ones before it left over: the operand a bf16 tensor core sees
    when x enters a product as hi (+ lo) fragments.  The sum is exact in
    fp32, so an fp32 product of it equals the two bf16 products into one
    fp32 accumulator up to summation order."""
    out = torch.zeros_like(x)
    for _ in range(terms):
        out = out + (x - out).to(torch.bfloat16).float()
    return out


def _tc_backward(q, k, v, out, m, l, dout, *, scale, causal, window,
                 softcap, terms):
    """B7's tensor-core precision in plain torch: QKᵀ and dO·Vᵀ of the
    bf16 inputs into fp32, p = exp(logit − m)·(1/l) and dl in fp32, then
    dl·K, pᵀ·dO and dlᵀ·Q with p and dl split into ``terms`` bf16 parts."""
    f32 = torch.float32
    B, S, H, hd = q.shape
    r = H // k.shape[2]
    kf, vf = (t.float().repeat_interleave(r, dim=2) for t in (k, v))
    qf, dof = q.float(), dout.float()
    lg = ref._tile_logits(q, k, 0, 0, scale, causal, window, softcap)
    lg = lg.reshape(B, H, S, S)
    p = torch.exp(lg - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.einsum("bqhd,bshd->bhqs", dof, vf)
    dsum = torch.sum(dof * out.float(), dim=-1).permute(0, 2, 1)
    dl = p * (dp - dsum[..., None])
    if softcap:
        t = lg / softcap
        dl = dl * torch.where(lg <= ref.NEG_INF / 2, 0.0, 1.0 - t * t)
    ps, dls = _split(p, terms), _split(dl, terms)
    dq = torch.einsum("bhqs,bshd->bqhd", dls, kf) * scale
    dk = torch.einsum("bhqs,bqhd->bshd", dls, qf) * scale
    dv = torch.einsum("bhqs,bqhd->bshd", ps, dof)
    dk, dv = (t.reshape(B, S, H // r, r, hd).sum(3) for t in (dk, dv))
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (200, 30.0)],
                         ids=["causal", "window_softcap"])
def test_tensor_core_split_prices_the_backward(window, softcap):
    """Before any card time: the tensor-core backward's precision (p and dl
    as bf16 hi + lo pairs) against the reference's fp32 ``flash_bwd_pallas``
    in interpret mode, at the per-element bf16 bars.  The one-term variant
    (p and dl rounded to bf16 alone) is printed beside it, not asserted."""
    B, S, H, K, hd = 1, 512, 4, 2, 64
    q, k, v, g = _inputs(B, S, H, K, hd, seed=B * S + H)
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=softcap)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    jo, jm, jl = flash_fwd_pallas(jq, jk, jv, interpret=True, **kw)
    want = flash_bwd_pallas(jq, jk, jv, jo, jm, jl, jg, interpret=True, **kw)
    tq, tk, tv, tg, to = (_t(a).to(torch.bfloat16)
                          for a in (jq, jk, jv, jg, jo))
    tm, tl = _t(jm), _t(jl)
    readings = {}
    for terms in (1, 2):
        got = _tc_backward(tq, tk, tv, to, tm, tl, tg, terms=terms, **kw)
        readings[terms] = [flash_bars.worst(a, _t(b), flash_bars.grad_bar(
            _t(b)))[0] for a, b in zip(got, want)]
    print(f"dq/dk/dv in units of the per-element bar: one term (p, dl "
          f"bf16) {readings[1]}, hi + lo {readings[2]}")
    assert max(readings[2]) <= 1, readings
