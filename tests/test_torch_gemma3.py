"""Port vs reference: gemma3-4b (5 local : 1 global) at reduced size.

The reference's ``gemma3-4b.reduced(n_layers=8)``: one period of the
pattern (five ``local`` sliding-window layers and one global ``attn``
layer) in the ``blocks`` group and the 8 % 6 = 2 leftover ``local`` layers
in the ``rem`` group; d 64, GQA 4/2 heads of 16, window 8, qk-norm, the
gelu (tanh) gate, vocab 128 in 2 unembedding chunks.

  * the flat layout: ``param_shapes``, every spec's entries and offsets,
    and the reference's ``init_params`` carried through ``convert`` and
    back, element for element; qwen3-0.6b and gpt-350m keep theirs;
  * one ZeRO++ training step on a one-device ("data", "model") mesh at
    batch 2 × seq 64 (the window masks), at ``tests/test_torch_train.py``'s
    bars: all techniques off (``baseline``) at the 1e-5 bars, full ZeRO++
    under the one-INT4-step bar, on a 3-layer cut (one ("local", "attn")
    period and a ``rem`` local layer) and on the 8-layer stack, where
    all-off's fp32 noise outgrows the 2-layer atol and takes the bar
    ``_exact_deep`` states; qwen3-0.6b at 8 layers takes the same bar,
    and a witness shows that depth moves it (qwen3 misses the 2-layer
    bar at 8 layers too, and gemma3 stays within 2x of qwen3);
  * serving on a one-device ("model",) mesh in f32: ``prefill_fn`` at the
    prompt's exact length, then 3 teacher-forced ``decode_fn`` steps from
    caches grown to 32 slots, for prompts of 5, 8 and 14 tokens (shorter
    than, equal to and longer than the window): every step's logits
    within 1e-5 (f32 summation order only), the global layer's caches
    within 1e-5 everywhere and each ring cache within 1e-5 at every slot
    that holds a position >= 0 (the reference fills the others with what
    its gather reads there, the port with zeros; decode masks them);
  * the engine: ``kv_len`` below the window is refused, and the port's
    ``ServeEngine`` (exact-length prefill of a stack with ``local``
    layers) decodes each request as the raw steps do alone.

torch's tanh-gelu and XLA's agree to a few fp32 ulps on the CPU
(``test_gelu_gate_matches_reference`` holds the gate at 1e-5), inside
every bar above: the 3-layer steps pass the 2-layer qwen3 steps' bars
unchanged.
"""
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
from jax.sharding import NamedSharding                       # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core.compat import make_mesh                      # noqa: E402
from repro.models import layers as jlayers                   # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402
from repro.serve import steps as jax_steps                   # noqa: E402
from repro.train.policy import make_policy as jax_policy     # noqa: E402
from repro.train.state import param_specs                    # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.models import layers as tlayers             # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.optim.adamw import AdamWConfig              # noqa: E402
from repro_torch.serve import ServeEngine, steps             # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402
from repro_torch.train.trainer import build_train_step       # noqa: E402

from test_torch_train import (LR, _Pair, _step_exact,        # noqa: E402
                              _step_int4, _tbatch)

ARCH, LAYERS = "gemma3-4b", 8
KV = 32
PROMPTS = (5, 8, 14)           # shorter than, equal to, longer than window 8
N_DECODE = 3


def _archs(**over):
    over = dict(n_layers=LAYERS, **over)
    return (jax_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


def test_reduced_config_is_the_references():
    jarch, arch = _archs()
    for f in ("n_layers", "d_model", "vocab", "pattern", "n_heads",
              "n_kv_heads", "head_dim", "qk_norm", "rope_theta", "window",
              "d_ff", "act", "unemb_chunks"):
        assert getattr(arch, f) == getattr(jarch, f), f
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    for f in ("n_layers", "d_model", "vocab", "pattern", "window", "act",
              "head_dim", "d_ff", "rope_theta"):
        assert getattr(full, f) == getattr(jfull, f), f
    # the reference's rule: a multi-kind pattern keeps one whole period
    assert get_config(ARCH).reduced().n_layers == \
        jax_get_config(ARCH).reduced().n_layers == 6
    assert get_config("qwen3-0.6b").reduced().pattern == ("attn",)


@pytest.mark.parametrize("arch_name,layers", [
    (ARCH, LAYERS), (ARCH, 6), ("qwen3-0.6b", 0), ("gpt-350m", 0)])
def test_flat_layout_is_the_references(arch_name, layers):
    """Shapes, entries and offsets of every group, and the reference's
    buffers through ``convert`` and back, element for element."""
    over = {"n_layers": layers} if layers else {}
    jarch = jax_get_config(arch_name).reduced(**over)
    arch = get_config(arch_name).reduced(**over)
    jm = JaxModel(jarch, jax_policy(jarch, ("data", "model")).zcfg, world=1)
    tm = Model(arch, make_policy(arch).zcfg, device="cpu")
    assert tm.param_shapes() == jm.param_shapes()
    assert list(tm.param_shapes()) == list(jm.param_shapes())
    assert (tm.n_periods, tm.rem, tm.period) == \
        (jm.n_periods, jm.rem, jm.period)
    assert tm.n_params() == jm.n_params()
    for name in ("period_spec", "rem_spec", "embed_spec", "head_spec",
                 "unemb_spec"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.entries == b.entries, name
            assert a.offsets == b.offsets, name
            assert a.padded_size == b.padded_size, name
    jp = {k: np.asarray(v) for k, v in
          jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32).items()}
    back = to_numpy(params_from_numpy(jp, tm))
    assert set(back) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k], err_msg=k)
    if layers == LAYERS:
        assert tm.rem == 2 and "rem" in back


def test_gelu_gate_matches_reference():
    rng = np.random.default_rng(0)
    x, wgu, wdn = (rng.standard_normal(s).astype(np.float32)
                   for s in ((3, 5, 16), (16, 48), (24, 16)))
    want = np.asarray(jlayers.swiglu(jnp.asarray(x), jnp.asarray(wgu),
                                     jnp.asarray(wdn), act="gelu"))
    got = tlayers.swiglu(torch.from_numpy(x), torch.from_numpy(wgu),
                         torch.from_numpy(wdn), act="gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="activation"):
        tlayers.swiglu(torch.from_numpy(x), torch.from_numpy(wgu),
                       torch.from_numpy(wdn), act="relu")


# one (local, attn) period and a leftover local layer: every piece of the
# path (window, gelu, the rem group) at the 2-layer stack's depth
SHORT = {"n_layers": 3, "pattern": ("local", "attn")}


@pytest.mark.parametrize("variant", ["baseline", "zeropp"])
@pytest.mark.parametrize("depth", ["short", "reduced"])
def test_step_matches_reference(variant, depth):
    """One step at seq 64 (window 8): every technique off at the exact
    bars, full ZeRO++ under the INT4 bar; ``rem`` is a flat group of its
    own on both sides.  ``short`` is ``SHORT``; ``reduced`` the 8-layer
    stack, where all-off takes ``_exact_deep``'s bars."""
    pair = (_off_pair(ARCH, LAYERS) if (variant, depth) == ("baseline",
                                                               "reduced")
            else _Pair(variant, arch=ARCH,
                       cut=SHORT if depth == "short" else {"n_layers": LAYERS}))
    assert pair.model.rem == (1 if depth == "short" else 2)
    assert pair.model.n_periods == 1
    if variant == "zeropp":
        grads = _step_int4(pair)
        assert grads["rem"].abs().sum() > 0
    elif depth == "short":
        _step_exact(pair)
    else:
        _exact_deep(pair)


@functools.lru_cache(maxsize=None)
def _off_pair(arch: str, layers: int) -> _Pair:
    """All techniques off, ``arch`` reduced to ``layers`` layers; built
    once for the deep step and the witness below."""
    return _Pair("baseline", arch=arch, cut={"n_layers": layers})


def _exact_deep(pair):
    """All-off at 8 layers.  fp32 summation noise grows with depth: at 8
    layers it passes the 2-layer bar's atol of 1e-6 in the embedding's
    gradient (values up to ~1), on qwen3-0.6b as on gemma3-4b
    (``test_depth_moves_the_all_off_step_as_much_on_qwen3`` holds that).
    So the gradients and moments are held at rtol 1e-5 with the atol
    scaled by the buffer, 1e-5 · max |reference|, and the parameters at
    ``params_near``'s bar with a share of 2 in 1,000 unstable first-step
    directions (the 2-layer bar allows 1; the witness bounds gemma3's
    share by twice qwen3's at the same depth)."""
    batch = pair.batch()
    j_loss, j_grads = pair.ref_grads(batch)
    params, opt = pair.port_state()
    st = build_train_step(pair.model, AdamWConfig(lr=LR), device="cpu")
    loss, _, grads = st.loss_and_grads(params, _tbatch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5

    def near(got, want, what):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    assert set(grads) == set(j_grads)
    for k in grads:
        near(grads[k].numpy(), j_grads[k], f"grad {k}")
    jp, jo, jm = pair.ref_step(batch)
    m = st.fn(params, opt, _tbatch(batch))
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    tp, to = to_numpy(params), to_numpy(opt)
    for k in tp:
        near(to["m"][k], jo["m"][k], f"m {k}")
        near(to["v"][k], jo["v"][k], f"v {k}")
    tg = to_numpy(grads)
    t_norm, j_norm = float(m["grad_norm"]), jm["grad_norm"]
    step_bars.params_near(
        tp, jp, {k: step_bars.first_step_dir(tg[k], t_norm) for k in tp},
        {k: step_bars.first_step_dir(j_grads[k], j_norm) for k in tp}, LR,
        far=2e-3)


def test_qwen3_at_depth_takes_the_deep_bars():
    """``_exact_deep`` on a stack with no gemma3 feature: qwen3-0.6b at 8
    layers (global attention, silu, no ``rem`` group)."""
    _exact_deep(_off_pair("qwen3-0.6b", LAYERS))


def _noise(pair) -> tuple:
    """The all-off step's distance between the port and the reference:
    the worst gradient element over the 2-layer bar, |port - reference| /
    (1e-6 + 1e-5 |reference|), and the share of unstable first-step
    directions (``params_near``'s amp >= 1e-7) over the stack's top two
    layers (the ``rem`` group of the 8-layer gemma3; the last two rows of
    an ("attn",) stack's ``blocks``)."""
    batch = pair.batch()
    _, jg = pair.ref_grads(batch)
    params, _ = pair.port_state()
    st = build_train_step(pair.model, AdamWConfig(lr=LR), device="cpu")
    tg = to_numpy(st.loss_and_grads(params, _tbatch(batch))[2])
    worst = max(float((np.abs(tg[k] - jg[k])
                       / (1e-6 + 1e-5 * np.abs(jg[k]))).max()) for k in tg)

    def norm(g):
        return float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                                 for v in g.values())))

    def top(g):
        return g["rem"] if "rem" in g else g["blocks"][-2:]
    amp = LR * np.abs(step_bars.first_step_dir(top(tg), norm(tg))
                      - step_bars.first_step_dir(top(jg), norm(jg)))
    return worst, float((amp >= 1e-7).mean())


def test_depth_moves_the_all_off_step_as_much_on_qwen3():
    """Why ``_exact_deep``'s bars are wider than the 2-layer ones: depth,
    not gemma3.  qwen3-0.6b (no local layer, no gelu, no ``rem`` group)
    passes the 2-layer gradient bar at 2 layers and misses it at 8, and
    the share of unstable directions over its top two layers grows with
    depth by more than 1.5x; gemma3-4b at 8 layers stays within 2x of
    qwen3 at 8 on both (2x: the factor by which ``_exact_deep`` widens
    ``params_near``'s share)."""
    q2, q8, g8 = (_noise(_off_pair(a, n)) for a, n in (
        ("qwen3-0.6b", 2), ("qwen3-0.6b", LAYERS), (ARCH, LAYERS)))
    assert q2[0] <= 1 < q8[0], (q2, q8)
    assert q8[1] > 1.5 * q2[1], (q2, q8)
    assert g8[0] <= 2 * q8[0] and g8[1] <= 2 * q8[1], (g8, q8)


# ------------------------------------------------------------------ serving

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _port_zcfg(jz):
    return ZeroConfig(qwz=jz.qwz, qwz_bits=jz.qwz_bits,
                      qwz_block=jz.qwz_block, qwz_gemm=jz.qwz_gemm,
                      qgz_block=jz.qgz_block, dp_axes=tuple(jz.dp_axes),
                      param_dtype=_TORCH[jz.param_dtype],
                      compute_dtype=_TORCH[jz.compute_dtype])


@pytest.fixture(scope="module")
def serve_pair():
    mesh = make_mesh((1,), ("model",))
    jarch, arch = _archs()
    pol = jax_policy(jarch, mesh.axis_names, param_dtype=jnp.float32,
                     compute_dtype=jnp.float32)
    jmodel = JaxModel(jarch, pol.zcfg, world=1)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    specs = param_specs(jmodel, tuple(mesh.axis_names))
    jparams = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
               for k, v in jparams.items()}
    model = Model(arch, _port_zcfg(pol.zcfg), world=1, device="cpu")
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               model)
    return (jmodel, mesh, jparams), (model, params)


def _slot_positions(t: int, cap: int) -> np.ndarray:
    """Position each slot of a ring of ``cap`` holds once position t is
    written (the reference's rule)."""
    s = np.arange(cap)
    return t - np.mod(t - s, cap)


def _hold_caches(jc, tc, model, t):
    """Every layer's cache: the global layer's everywhere, a ring's at the
    slots of positions >= 0 (t: the newest position written)."""
    kinds = list(model.period)
    pairs = [(k, jc["blocks"][j], tc["blocks"][j], 1)
             for j, k in enumerate(kinds)]
    pairs += [(k, jc["rem"][j], tc["rem"][j], 0)
              for j, k in enumerate(kinds[:model.rem])]
    for kind, jcache, tcache, axis in pairs:
        for key in ("k", "v"):
            a = np.asarray(jcache[key], np.float32)
            b = tcache[key].detach().float().numpy()
            assert a.shape == b.shape, (kind, key, a.shape, b.shape)
            if kind == "local":
                keep = _slot_positions(t, a.shape[axis + 1]) >= 0
                a = np.compress(keep, a, axis=axis + 1)
                b = np.compress(keep, b, axis=axis + 1)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{kind} {key}")


@pytest.mark.parametrize("P", PROMPTS)
def test_prefill_decode_match_reference(serve_pair, P):
    (jmodel, mesh, jparams), (model, params) = serve_pair
    rng = np.random.default_rng(P)
    toks = rng.integers(0, model.cfg.vocab, (1, P)).astype(np.int32)
    nxt = rng.integers(0, model.cfg.vocab, (N_DECODE, 1, 1)).astype(np.int32)
    jps = jax_steps.build_prefill_step(jmodel, mesh, (), ())
    jds = jax_steps.build_decode_step(jmodel, mesh, (), ("model",),
                                      donate=False)
    jl, jc = jps.fn(jparams, {"tokens": toks})
    jc = jax_steps.pad_prefill_caches(jmodel, jc, KV)
    ps = steps.build_prefill_step(model, device="cpu")
    ds = steps.build_decode_step(model, device="cpu")
    tl, tc = ps.fn(params, {"tokens": torch.from_numpy(toks).long()})
    # the rings are window-sized from prefill on; the global cache grows
    assert tc["blocks"][0]["k"].shape[2] == model.cfg.window
    assert tc["blocks"][5]["k"].shape[2] == P
    tc = steps.pad_prefill_caches(model, tc, KV)
    assert tc["blocks"][5]["k"].shape[2] == KV
    assert tc["rem"][1]["k"].shape[1] == model.cfg.window
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(jl)[:, -1],
                               rtol=1e-5, atol=1e-5)
    _hold_caches(jc, tc, model, P - 1)
    for i in range(N_DECODE):
        pos = np.array([P + i], np.int32)
        jl, jc = jds.fn(jparams, jc, {"tokens": nxt[i]}, jnp.asarray(pos))
        tl, tc = ds.fn(params, tc, {"tokens": torch.from_numpy(nxt[i]).long()},
                       torch.from_numpy(pos))
        assert np.all(np.isfinite(np.asarray(jl)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode step {i}")
        _hold_caches(jc, tc, model, P + i)


def test_engine_prefills_local_stacks_at_exact_length(serve_pair):
    """kv_len below the window is refused with the reference's message;
    the engine's tokens are each request's own greedy tokens through the
    raw steps (so its ring caches never saw a pad token)."""
    _, (model, params) = serve_pair
    with pytest.raises(ValueError, match="below the sliding window"):
        ServeEngine(model, params, n_slots=2, kv_len=model.cfg.window - 1,
                    device="cpu")
    eng = ServeEngine(model, params, n_slots=2, kv_len=KV, device="cpu")
    assert not eng._pad_ok
    seen = []
    pre = eng._prefill

    def prefill(p, batch, last):
        seen.append(batch["tokens"].shape[1])
        return pre.fn(p, batch, last)
    eng._prefill = steps.ServeStep(fn=prefill, run_spec=pre.run_spec)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, n).astype(np.int32)
               for n in (5, 11, 3)]
    uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    res = eng.run(max_steps=100)
    assert seen == [len(p) for p in prompts]
    ps = steps.build_prefill_step(model, device="cpu")
    ds = steps.build_decode_step(model, device="cpu")
    for u, p in zip(uids, prompts):
        logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
            p[None, :]).long()})
        caches = steps.pad_prefill_caches(model, caches, KV)
        toks = [int(logits[0, -1].argmax())]
        for i in range(1, 6):
            logits, caches = ds.fn(params, caches,
                                   {"tokens": torch.tensor([[toks[-1]]])},
                                   torch.tensor([len(p) + i - 1]))
            toks.append(int(logits[0, -1].argmax()))
        assert res[u] == toks, (u, res[u], toks)
