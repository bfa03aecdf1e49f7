"""Port vs reference: the ZeRO++ training step of a reduced qwen3-0.6b.

The reference runs ``build_train_step`` (and, for the gradients, the
same ``loss_fn`` under ``jax.value_and_grad``) jitted on a one-device
``("data", "model")`` mesh, where ``ZeroConfig.distributed`` holds and
qgZ takes its 2-hop branch: every layer group goes through the qwZ INT8
gather, the hpZ secondary slice and the qgZ INT4 reorder-quantize ->
reduce-requantize -> reduce, with identities for the wire.  The port runs
its step on the CPU (plain versions of the kernels) from the same fp32
master buffers and AdamW state (``repro_torch.convert``) and the same
``SyntheticLM`` batch.  Model: 2 layers, d 64, GQA 4/2 heads of 16,
qk-norm, vocab 128 in 2 unembedding chunks; batch 2 × seq 64.

Tolerances (f32 compute, parameter and reduce dtypes):
  * qgZ off (passed as an override, as the reference's
    ``make_policy(**overrides)`` takes it): loss within 1e-5; gradients,
    and m and v after one AdamW step, within rtol 1e-5 / atol 1e-6 — only
    fp32 summation order differs.  The AdamW update alone, fed the same
    gradients on both sides, gives parameters within the same bar.  After
    the whole step a parameter moves by lr·(ĝ + wd·w) with the first
    step's direction ĝ = g/(|g| + eps) (clipped g), which turns a 1e-9
    gradient difference into a visible one where |g| is near eps: there
    the bar adds lr·|ĝ_port − ĝ_ref|, each side's direction computed from
    its own gradient;
  * full ZeRO++: loss within 1e-5; a gradient element may differ from
    the reference's beyond that only by at most one INT4 step of its
    block (the block's absmax / 7) and in fewer than 1 of 1,000 elements:
    the inputs to qgZ differ in the last float bits, and a value on a
    rounding boundary may land on either side.  After one AdamW step the
    same holds of m (linear in the gradient: one step is the block's
    max |m| / 7) and of v = (1 − b2)·g² (one step moves it by at most
    (1 − b2)·step·(|g_port| + |g_ref|), with |g| = √(v / (1 − b2))); the
    grad norm is within the norm of the two gradients' difference; the
    parameters are held as above, each side's first-step direction read
    from its own m and v;
  * each of the reference's variants (baseline, qwz, hpz, qgz) under
    ``make_policy(variant)``: the bar above that fits it (qgZ on: the
    INT4 bar, else the 1e-5 one);
  * the flash VJP (S = 2·kv_chunk) at 1e-5, alone and inside the step;
  * the step under ``attn_impl="pallas"`` at batch 1 × 512, where every
    layer's attention runs the flash pair (the port's plain versions of
    B6/B7 here, the reference's Pallas kernels in interpret mode): qgZ off
    at the 1e-5 bars, full ZeRO++ under the INT4 bar.  The reference's
    step is built with ``global_batch`` so that it keeps the sequence
    unsharded (else it picks ``seq_axes=("model",)`` and its jnp flash
    path); the test checks that its Pallas pair was traced.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse                                              # noqa: E402
import contextlib                                            # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
from jax.sharding import PartitionSpec as P                  # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core.compat import make_mesh, shard_map           # noqa: E402
from repro.data import synthetic as jsyn                     # noqa: E402
from repro.kernels import flash_ops as jflash_ops             # noqa: E402
from repro.models.attention import flash_attention as jflash  # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402
from repro.models.transformer import RunSpec as JaxRunSpec   # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamW        # noqa: E402
from repro.optim.adamw import apply_update as japply         # noqa: E402
from repro.train import trainer as jtrainer                  # noqa: E402
from repro.train.policy import make_policy as jax_policy     # noqa: E402
from repro.train.state import param_specs                    # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import (opt_from_numpy,             # noqa: E402
                                 params_from_numpy, to_numpy)
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.kernels import flash_ops as tflash_ops      # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models.attention import flash_attention     # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, apply_update  # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402
from repro_torch.train.trainer import build_train_step       # noqa: E402

LR = 3e-3
AXES = ("data", "model")
JF32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
            reduce_dtype=jnp.float32)
TF32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
            reduce_dtype=torch.float32)


class _Pair:
    """The reference and the port on the same fp32 state."""

    def __init__(self, variant: str = "zeropp", arch: str = "qwen3-0.6b",
                 cut=None, **overrides):
        """``arch`` reduced, with ``cut`` (e.g. {"n_layers": 8}) passed
        on to ``reduced`` on both sides."""
        cut = cut or {}
        self.mesh = make_mesh((1, 1), AXES)
        self.jarch = jax_get_config(arch).reduced(**cut)
        pol = jax_policy(self.jarch, AXES, variant, **overrides, **JF32)
        self.jm = JaxModel(self.jarch, pol.zcfg, world=1)
        self.jopt_cfg = JaxAdamW(lr=LR)
        self.jp, self.jo = jtrainer.init_state(self.jm, self.mesh,
                                               self.jopt_cfg,
                                               jax.random.PRNGKey(0))
        arch = get_config(arch).reduced(**cut)
        self.model = Model(arch, make_policy(arch, AXES, variant,
                                             **overrides, **TF32).zcfg,
                           device="cpu")
        z, jz = self.model.zcfg, pol.zcfg
        assert (z.qwz, z.hpz, z.qgz) == (jz.qwz, jz.hpz, jz.qgz), variant
        self.lm = jsyn.SyntheticLM(vocab=arch.vocab, seq_len=64, seed=7)

    def port_state(self):
        params = params_from_numpy(
            {k: np.asarray(v) for k, v in self.jp.items()}, self.model)
        opt = opt_from_numpy(jax.tree.map(np.asarray, self.jo), self.model)
        return params, opt

    def batch(self, step=0, B=2, S=64):
        if S == 64:
            return jsyn.make_batch(self.jarch, self.lm, step, B)
        toks = np.random.default_rng(step).integers(
            0, self.jarch.vocab, (B, S + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def ref_grads(self, batch, attn_impl="xla"):
        rs = JaxRunSpec(mode="train", seq_axes=(), attn_impl=attn_impl)
        specs = param_specs(self.jm, AXES)
        bspec = {k: P(AXES, None) for k in batch}

        def lg(p, b):
            (loss, _), g = jax.value_and_grad(
                lambda p: self.jm.loss_fn(p, b, rs, 1), has_aux=True)(p)
            return loss, g

        f = jax.jit(shard_map(lg, mesh=self.mesh, in_specs=(specs, bspec),
                              out_specs=(P(), specs), check_vma=False))
        loss, g = f(self.jp, batch)
        return float(loss), {k: np.asarray(v) for k, v in g.items()}

    def ref_step(self, batch, accum=1, attn_impl="xla"):
        ts = jtrainer.build_train_step(self.jm, self.mesh, self.jopt_cfg,
                                       accum=accum, donate=False,
                                       global_batch=batch["tokens"].shape[0],
                                       attn_impl=attn_impl)
        if accum > 1:
            batch = {k: v.reshape((accum, -1) + v.shape[1:])
                     for k, v in batch.items()}
        b = jtrainer.place_batch(batch, self.mesh, ts.in_specs[2])
        p, o, m = ts.fn(self.jp, self.jo, b)
        return (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o),
                {k: float(v) for k, v in m.items()})


def _tbatch(batch, accum=1):
    out = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if accum > 1:
        out = {k: v.reshape((accum, -1) + tuple(v.shape[1:]))
               for k, v in out.items()}
    return out


@pytest.fixture(scope="module")
def pair_off():
    return _Pair(qgz=False)


@pytest.fixture(scope="module")
def pair_zeropp():
    return _Pair()


_close = step_bars.close


def _params_after_first_step(tp, jp, tg, jg, t_norm, j_norm):
    """Parameters after one step, each side's first-step direction read
    from its own gradient."""
    step_bars.params_near(
        tp, jp, {k: step_bars.first_step_dir(tg[k], t_norm) for k in tp},
        {k: step_bars.first_step_dir(jg[k], j_norm) for k in tp}, LR)


def test_synthetic_data_is_the_reference_draws():
    arch = get_config("qwen3-0.6b").reduced()
    for step in (0, 3):
        t = tsyn.make_batch(arch, tsyn.SyntheticLM(arch.vocab, 64, seed=7),
                            step, 4)
        j = jsyn.make_batch(jax_get_config("qwen3-0.6b").reduced(),
                            jsyn.SyntheticLM(arch.vocab, 64, seed=7), step, 4)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(t[k], j[k])
    assert tsyn.SyntheticLM(128, 64, seed=7).entropy_bound == \
        jsyn.SyntheticLM(128, 64, seed=7).entropy_bound


def _step_exact(pair, batch=None, attn_impl="xla"):
    """Loss and gradients at 1e-5, then one AdamW step on both sides."""
    batch = pair.batch() if batch is None else batch
    j_loss, j_grads = pair.ref_grads(batch, attn_impl)
    params, opt = pair.port_state()
    st = build_train_step(pair.model, AdamWConfig(lr=LR), device="cpu",
                          attn_impl=attn_impl)
    loss, mets, grads = st.loss_and_grads(params, _tbatch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5
    assert mets["tokens"] == batch["tokens"].size
    assert set(grads) == set(j_grads)
    for k in grads:
        assert grads[k].dtype == torch.float32
        _close(grads[k].numpy(), j_grads[k], f"grad {k}")
    # one AdamW step, on both sides from the same state
    jp, jo, jm = pair.ref_step(batch, attn_impl=attn_impl)
    m = st.fn(params, opt, _tbatch(batch))
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-7)
    np.testing.assert_allclose(float(m["nll"]), jm["nll"], rtol=1e-5)
    tp, to = to_numpy(params), to_numpy(opt)
    for k in tp:
        _close(to["m"][k], jo["m"][k], f"m {k}")
        _close(to["v"][k], jo["v"][k], f"v {k}")
    assert int(to["count"]) == int(jo["count"]) == 1
    _params_after_first_step(tp, jp, to_numpy(grads), j_grads,
                             float(m["grad_norm"]), jm["grad_norm"])


def _step_int4(pair, batch=None, attn_impl="xla"):
    """qgZ on: loss at 1e-5, gradients within one INT4 step, then one
    AdamW step on both sides (m, v, grad norm and parameters).  Returns
    the port's gradients."""
    batch = pair.batch() if batch is None else batch
    j_loss, j_grads = pair.ref_grads(batch, attn_impl)
    params, opt = pair.port_state()
    st = build_train_step(pair.model, AdamWConfig(lr=LR), device="cpu",
                          attn_impl=attn_impl)
    loss, _, grads = st.loss_and_grads(params, _tbatch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5
    step_bars.grads_within_int4(to_numpy(grads), j_grads)
    # one AdamW step, on both sides from the same state
    jp, jo, jm = pair.ref_step(batch, attn_impl=attn_impl)
    m = st.fn(params, opt, _tbatch(batch))
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
    gdiff = np.sqrt(sum(np.sum((grads[k].numpy().astype(np.float64)
                                - j_grads[k]) ** 2) for k in grads))
    assert abs(float(m["grad_norm"]) - jm["grad_norm"]) <= \
        gdiff + 1e-5 * jm["grad_norm"]
    tp, to = to_numpy(params), to_numpy(opt)
    step_bars.moments_within_int4(to, jo)
    assert int(to["count"]) == int(jo["count"]) == 1
    step_bars.params_near(tp, jp, {k: step_bars.moment_dir(to, k) for k in tp},
                          {k: step_bars.moment_dir(jo, k) for k in tp}, LR)
    return grads


def test_step_matches_reference_with_qgz_off(pair_off):
    _step_exact(pair_off)


@pytest.mark.parametrize("variant", ["baseline", "qwz", "hpz", "qgz"])
def test_step_matches_reference_per_variant(variant):
    """Each ablation of ``make_policy`` against the reference's own
    ``make_policy(variant)`` on the same state."""
    pair = _Pair(variant)
    if pair.model.zcfg.qgz:
        _step_int4(pair)
    else:
        _step_exact(pair)


def test_adamw_update_matches_reference_on_the_same_gradients(pair_off):
    """The update alone: the reference's ``apply_update`` and the port's
    on the same gradients, parameters and state (two steps, so the bias
    corrections and a nonzero m/v are exercised)."""
    rng = np.random.default_rng(3)
    params, opt = pair_off.port_state()
    jp = {k: np.asarray(v) for k, v in pair_off.jp.items()}
    jo = jax.tree.map(np.asarray, pair_off.jo)
    for step in range(2):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -(step + 1)).astype(
            np.float32) for k, v in jp.items()}
        jp, jo, jst = jax.jit(lambda g, p, o: japply(g, p, o,
                                                     pair_off.jopt_cfg))(
            g, jp, jo)
        tst = apply_update({k: torch.from_numpy(v) for k, v in g.items()},
                           params, opt, AdamWConfig(lr=LR))
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        tp, to = to_numpy(params), to_numpy(opt)
        for k in tp:
            _close(tp[k], np.asarray(jp[k]), f"param {k}")
            _close(to["m"][k], np.asarray(jo["m"][k]), f"m {k}")
            _close(to["v"][k], np.asarray(jo["v"][k]), f"v {k}")


def test_step_matches_reference_with_full_zeropp(pair_zeropp, pair_off):
    batch = pair_zeropp.batch()
    grads = _step_int4(pair_zeropp)
    # qgZ really quantized: the qgZ-off gradients of the same state differ
    off = build_train_step(pair_off.model, AdamWConfig(lr=LR), device="cpu")
    _, _, g_off = off.loss_and_grads(pair_off.port_state()[0], _tbatch(batch))
    assert not np.allclose(grads["blocks"].numpy(), g_off["blocks"].numpy(),
                           rtol=1e-3, atol=1e-5)


def test_flash_vjp_matches_reference():
    """The chunked online-softmax attention and its hand-written VJP:
    out, dq, dk, dv at f32 1e-5 (GQA 4/2, 4 KV chunks)."""
    rng = np.random.default_rng(0)
    B, S, H, K, hd, kc = 2, 64, 4, 2, 16, 16
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                             (B, S, H, hd)))
    pos = np.arange(S)
    scale = hd ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, jnp.asarray(pos),
                                              scale, True, 0, 0.0, kc),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = flash_attention(tq, tk, tv, torch.from_numpy(pos), scale, kc)
    tout.backward(torch.from_numpy(do))
    got = [tout.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_step_through_the_flash_path(pair_off):
    """S = 2048 = 2·kv_chunk: every layer's attention takes the chunked
    path and its VJP, in the reference and in the port."""
    batch = pair_off.batch(B=1, S=2048)
    j_loss, j_grads = pair_off.ref_grads(batch)
    params, _ = pair_off.port_state()
    st = build_train_step(pair_off.model, AdamWConfig(lr=LR), device="cpu")
    loss, _, grads = st.loss_and_grads(params, _tbatch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5
    for k in grads:
        _close(grads[k].numpy(), j_grads[k], f"grad {k}")


def test_grad_accumulation_matches_reference(pair_off):
    """accum = 2 (two microbatches of 1) against the reference's
    accumulation on the same microbatches, and against the port's own
    single full-batch step (checks.check_trainer_grad_accumulation)."""
    batch = pair_off.batch()
    jp, _, jm = pair_off.ref_step(batch, accum=2)
    params, opt = pair_off.port_state()
    st2 = build_train_step(pair_off.model, AdamWConfig(lr=LR), accum=2,
                           device="cpu")
    loss2, _, g2 = st2.loss_and_grads(params, _tbatch(batch, 2))
    m = st2.fn(params, opt, _tbatch(batch, 2))
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
    assert m["tokens"] == jm["tokens"] == 2 * 64
    # the reference's accumulated gradient, for the first-step bar
    j_loss = []
    j_g = None
    for i in range(2):
        l, g = pair_off.ref_grads({k: v[i:i + 1] for k, v in batch.items()})
        j_loss.append(l)
        j_g = g if j_g is None else {k: j_g[k] + g[k] for k in g}
    j_g = {k: v / 2 for k, v in j_g.items()}
    assert abs(float(loss2) - sum(j_loss) / 2) <= 1e-5
    _params_after_first_step(to_numpy(params), jp, to_numpy(g2), j_g,
                             float(m["grad_norm"]), jm["grad_norm"])
    p1, _ = pair_off.port_state()
    st1 = build_train_step(pair_off.model, AdamWConfig(lr=LR), device="cpu")
    loss1, _, g1 = st1.loss_and_grads(p1, _tbatch(batch))
    assert abs(float(loss1) - float(loss2)) <= 1e-5
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _args(**kw):
    ns = tlaunch.parser().parse_args([])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_loss_falls_on_synthetic_lm():
    """checks.check_trainer_loss_decreases in the port: 4 full ZeRO++
    steps of the reduced model learn (CPU, plain kernel versions)."""
    out = tlaunch.train_loop(_args(reduced=True, device="cpu", batch=16,
                                   seq=64, steps=4, lr=3e-3,
                                   lr_schedule="constant", log_every=0))
    losses = out["losses"]
    assert all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.9, losses
    assert [sum(c.values()) for c in out["launches"]] == [0] * 4


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run")
    arch = get_config("qwen3-0.6b").reduced()
    model = Model(arch, make_policy(arch).zcfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        build_train_step(model, AdamWConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--reduced", "--steps", "1"])
    with pytest.raises(ValueError, match="variant"):
        make_policy(arch, variant="zero3")
    assert isinstance(tlaunch.parser().parse_args([]), argparse.Namespace)


@contextlib.contextmanager
def _count_reference_flash(monkeypatch):
    """Count the reference's traces of its Pallas flash pair."""
    seen = {"fwd": 0, "bwd": 0}
    fwd, bwd = jflash_ops.flash_fwd_pallas, jflash_ops.flash_bwd_pallas

    def cfwd(*a, **kw):
        seen["fwd"] += 1
        return fwd(*a, **kw)

    def cbwd(*a, **kw):
        seen["bwd"] += 1
        return bwd(*a, **kw)
    monkeypatch.setattr(jflash_ops, "flash_fwd_pallas", cfwd)
    monkeypatch.setattr(jflash_ops, "flash_bwd_pallas", cbwd)
    yield seen


@pytest.mark.parametrize("zeropp", [False, True], ids=["qgz_off", "zeropp"])
def test_step_through_the_flash_kernels(zeropp, pair_off, pair_zeropp,
                                        monkeypatch):
    """attn_impl="pallas" at batch 1 × 512: the port's step (plain B6/B7)
    against the reference's Pallas-routed loss_fn and train step."""
    pair = pair_zeropp if zeropp else pair_off
    batch = pair.batch(B=1, S=512)
    with _count_reference_flash(monkeypatch) as seen:
        (_step_int4 if zeropp else _step_exact)(pair, batch, "pallas")
    assert seen["fwd"] > 0 and seen["bwd"] > 0, seen
    # and the port's step went through its flash pair: 2 forwards (the
    # forward and each layer's recompute) and 1 backward per layer
    calls = {"fwd": 0, "bwd": 0}
    real = {"fwd": tops.flash_fwd, "bwd": tops.flash_bwd}

    def counted(name):
        def f(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return f
    monkeypatch.setattr(tflash_ops.ops, "flash_fwd", counted("fwd"))
    monkeypatch.setattr(tflash_ops.ops, "flash_bwd", counted("bwd"))
    st = build_train_step(pair.model, AdamWConfig(lr=LR), device="cpu",
                          attn_impl="pallas")
    st.loss_and_grads(pair.port_state()[0], _tbatch(batch))
    n = pair.model.cfg.n_layers
    assert calls == {"fwd": 2 * n, "bwd": n}, calls
