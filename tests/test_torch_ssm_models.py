"""Port vs reference: the SSM and hybrid stacks, mamba2-130m (``ssd``
blocks) and recurrentgemma-2b (``rec``, ``rec``, ``local``), reduced.

Both sides run ``ZeroConfig.local`` in fp32 on the reference's
``init_params`` buffers carried over by ``convert``; inputs are numpy draws
from seeds.

  * every ``ArchConfig`` field is the reference's, full and reduced;
  * the train step: the loss within 1e-5 and every gradient within the
    bars of ``tests/test_torch_models_smoke.py`` against the reference's
    ``value_and_grad``;
  * prefill over 32 positions, the caches grown to 36 slots, then 3 decode
    steps: every logit within 1e-5 of the reference's;
  * decode token by token against the prefill's last logits (the
    reference's ``test_decode_matches_forward_dense`` and ``_hybrid``,
    recurrentgemma at ``window=4`` so that its ring wraps);
  * ``cache_shapes``: every leaf's shape and dtype the reference's
    (states fp32, conv histories and K/V in the cache dtype);
  * the port's own init: the reference's per-name rules (``alog`` = log
    U[1, 16], ``dskip`` = 1, ``dtb`` in softplus⁻¹ of [1e-3, 0.1], ``loga``
    in [-0.8, -0.01], the projections at 1/√fan-in, norms and biases 0);
  * the slab engine: each request's tokens as it gives alone (raw prefill
    and decode steps), prompts of prime lengths among them, and a recycled
    slot that keeps nothing of its previous occupant; the paged engine
    refuses both models;
  * a ``ZeroState`` save and restore, bit for bit;
  * one training step on 2 × 2 gloo ranks, batch 2 (rows over ``data``,
    the sequence over ``model``: the conv halo and the prefix state cross
    ranks forward and backward), against the port's world-1 step: the
    loss within 1e-5, the gradients at the bars above.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.configs.base import ArchConfig              # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.models.transformer import RunSpec           # noqa: E402
from repro_torch.optim.adamw import AdamWConfig              # noqa: E402
from repro_torch.serve import ServeEngine, steps             # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train import trainer                        # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ARCHS = ("mamba2-130m", "recurrentgemma-2b")
TZ = ZeroConfig.local(param_dtype=torch.float32, compute_dtype=torch.float32)
F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
           reduce_dtype=torch.float32)
B, S, N_DECODE = 2, 32, 3
KV = S + N_DECODE + 1
SEQ = 64


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


class _Pair:
    """The reference's and the port's model of ``arch`` reduced (with
    ``over``) on the reference's ``init_params`` buffers."""

    def __init__(self, arch: str, **over):
        jax, jnp = _jax()
        from repro.configs import get_config as jax_get_config
        from repro.core.zeropp import ZeroConfig as JaxZeroConfig
        from repro.models.model import Model as JaxModel
        self.jarch = jax_get_config(arch).reduced(**over)
        self.arch = get_config(arch).reduced(**over)
        self.jm = JaxModel(self.jarch, JaxZeroConfig.local(
            param_dtype=jnp.float32, compute_dtype=jnp.float32))
        self.tm = Model(self.arch, TZ, device="cpu")
        self.np_params = {k: np.array(v) for k, v in self.jm.init_params(
            jax.random.PRNGKey(0), dtype=jnp.float32).items()}
        self.jp = {k: jnp.asarray(v) for k, v in self.np_params.items()}
        self.tp = params_from_numpy(self.np_params, self.tm)


def _batch(cfg, rng, rows, n):
    return {"tokens": rng.integers(0, cfg.vocab, (rows, n)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _hold_grads(tg, jg, n_layers):
    """``step_bars.close`` at 2 layers; deeper stacks (recurrentgemma's
    period of 3) the depth-scaled atol 1e-5 · max|reference| of
    ``tests/test_torch_models_smoke.py``."""
    assert set(tg) == set(jg)
    for k in tg:
        assert tg[k].shape == jg[k].shape, k
        assert np.isfinite(tg[k]).all(), k
        if n_layers <= 2:
            step_bars.close(tg[k], jg[k], f"grad {k}")
        else:
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(jg[k]).max(),
                                       err_msg=f"grad {k}")


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_are_the_references(arch):
    from repro.configs import get_config as jax_get_config
    for over in (None, {}, {"window": 4}):
        j, t = jax_get_config(arch), get_config(arch)
        if over is not None:
            j, t = j.reduced(**over), t.reduced(**over)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        for prop in ("d_head", "d_inner", "ssm_heads", "conv_dim", "d_rnn"):
            assert getattr(t, prop) == getattr(j, prop), (arch, prop)


# --------------------------------------------------------------- the model

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jax, _ = _jax()
    from repro.models.transformer import RunSpec as JaxRunSpec
    pair = _Pair(arch)
    cfg = pair.arch
    rng = np.random.default_rng(0)
    batch = _batch(cfg, rng, B, S)
    batch["targets"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    rs = JaxRunSpec(mode="train")
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: pair.jm.loss_fn(p, b, rs, dp_world=1)[0]))(pair.jp,
                                                                batch)
    st = trainer.build_train_step(pair.tm, AdamWConfig(), device="cpu")
    loss, _, grads = st.loss_and_grads(pair.tp, _torch(batch))
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(j_loss)) <= 1e-5, (float(loss),
                                                      float(j_loss))
    _hold_grads({k: v.numpy() for k, v in grads.items()},
                {k: np.asarray(v) for k, v in j_grads.items()},
                cfg.n_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_reference(arch):
    jax, jnp = _jax()
    from repro.models.transformer import RunSpec as JaxRunSpec
    from repro.train import serve as jserve
    pair = _Pair(arch)
    cfg = pair.arch
    rng = np.random.default_rng(1)
    batch = _batch(cfg, rng, B, S)
    dec = [_batch(cfg, rng, B, 1) for _ in range(N_DECODE)]
    jl, jc = jax.jit(lambda p, b: pair.jm.prefill_fn(
        p, b, JaxRunSpec(mode="prefill")))(pair.jp, batch)
    jc = jserve.pad_prefill_caches(pair.jm, jc, KV)
    jd = jax.jit(lambda p, c, b, t: pair.jm.decode_fn(
        p, c, b, t, JaxRunSpec(mode="decode", kv_len=KV)))
    tl, tc = pair.tm.prefill_fn(pair.tp, _torch(batch),
                                RunSpec(mode="prefill"))
    tc = steps.pad_prefill_caches(pair.tm, tc, KV)
    outs = [(np.asarray(jl), tl.numpy())]
    for i, db in enumerate(dec):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jd(pair.jp, jc, db, jnp.asarray(pos))
        tl, tc = pair.tm.decode_fn(pair.tp, tc, _torch(db),
                                   torch.from_numpy(pos),
                                   RunSpec(mode="decode"))
        outs.append((np.asarray(jl), tl.numpy()))
    for i, (j, t) in enumerate(outs):
        assert t.shape == (B, 1, cfg.vocab) and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{arch} step {i}")
    # the decode caches carried every leaf of the reference's
    for tcache, jcache in zip(tc["blocks"], jc["blocks"]):
        for k, v in jcache.items():
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch,over,tol", [("mamba2-130m", {}, 2e-4),
                                           ("recurrentgemma-2b",
                                            {"window": 4}, 2e-3)])
def test_decode_matches_forward(arch, over, tol):
    """Token by token from empty caches, the last step's logits equal the
    prefill's over the same tokens (``tests/test_models_smoke.py:110-150``
    on the port, at its tolerances; recurrentgemma's ring of 4 wraps)."""
    pair = _Pair(arch, **over)
    tm, n = pair.tm, 6
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, pair.arch.vocab, (1, n)))
    caches = tm.init_caches(1, n, dtype=torch.float32)
    for t in range(n):
        lg, caches = tm.decode_fn(pair.tp, caches,
                                  {"tokens": toks[:, t:t + 1]},
                                  torch.tensor([t]), RunSpec(mode="decode"))
    last, _ = tm.prefill_fn(pair.tp, {"tokens": toks},
                            RunSpec(mode="prefill"))
    np.testing.assert_allclose(lg[:, 0].numpy(), last[:, 0].numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_are_the_references(arch):
    _, jnp = _jax()
    pair = _Pair(arch)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = pair.tm.cache_shapes(3, 16, dtype=dt)
        want = pair.jm.cache_shapes(3, 16, dtype=jdt)
        for g, w in zip(got["blocks"] + (got["rem"] or ()),
                        want["blocks"] + (want["rem"] or ())):
            assert set(g) == set(w)
            for k in g:
                assert g[k].shape == tuple(w[k].shape), (k, g[k], w[k])
                assert names[g[k].dtype] == str(w[k].dtype), (k, g[k])
        caches = pair.tm.init_caches(3, 16, dtype=dt)
        for c in caches["blocks"]:
            for k, v in c.items():
                assert v.dtype == (torch.float32 if k == "h" else dt)


def test_init_follows_the_references_rules():
    lo, hi = np.log(np.expm1(1e-3)), np.log(np.expm1(0.1))
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = Model(cfg, TZ, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        seen = set()
        for group, spec in (("blocks", model.period_spec),
                            ("rem", model.rem_spec)):
            if spec is None:
                continue
            buf = params[group].reshape(-1, spec.padded_size)
            for name, shape in spec.entries:
                off, n = spec.offsets[name]
                v = buf[:, off:off + n].numpy()
                base = name.split(".")[-1]
                seen.add(base)
                if base == "alog":
                    assert (v >= 0).all() and (v <= np.log(16) + 1e-6).all()
                    assert v.std() > 0.3
                elif base == "dskip":
                    assert (v == 1).all()
                elif base == "dtb":
                    assert (v >= lo - 1e-6).all() and (v <= hi + 1e-6).all()
                elif base == "loga":
                    assert (v >= -0.8).all() and (v <= -0.01).all()
                elif base in ("inp", "px", "pg", "wa", "wx", "cw", "po",
                              "outp", "wq", "wk", "wv", "wo", "wgu", "wdn"):
                    assert abs(v.std() * np.sqrt(shape[0]) - 1) < 0.2, name
                else:                       # norms and biases
                    assert base in ("ln", "ln1", "ln2", "onrm", "ba", "bx",
                                    "qn", "kn"), name
                    assert (v == 0).all(), name
        assert seen >= ({"alog", "dskip", "dtb", "inp", "cw"}
                        if arch == "mamba2-130m"
                        else {"loga", "px", "pg", "wa", "wx", "cw", "po"})


# ----------------------------------------------------------------- serving

def _alone(model, params, prompt, n):
    """A request alone through the raw steps: its prefill at its own
    length, then greedy decode steps."""
    ps = steps.build_prefill_step(model, device="cpu")
    ds = steps.build_decode_step(model, device="cpu")
    logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
        prompt[None]).long()})
    caches = steps.pad_prefill_caches(model, caches, KV)
    want = [int(logits[0, -1].argmax())]
    for i in range(1, n):
        logits, caches = ds.fn(params, caches,
                               {"tokens": torch.tensor([[want[-1]]])},
                               torch.tensor([len(prompt) + i - 1]))
        want.append(int(logits[0, -1].argmax()))
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_engine_equals_each_request_alone(arch):
    """Five requests over 2 slots (prompts 7, 13, 4, 11 and 9 tokens:
    primes among them give SSD chunk 1), so slots are recycled."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, make_policy(cfg, **F32).zcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    jobs = [(7, 5), (13, 4), (4, 6), (11, 3), (9, 4)]
    prompts = [rng.integers(0, cfg.vocab, p).astype(np.int32)
               for p, _ in jobs]
    eng = ServeEngine(model, params, n_slots=2, kv_len=KV, device="cpu",
                      kv_axes=())
    uids = [eng.submit(p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, jobs)]
    res = eng.run(max_steps=200)
    assert len(set(eng.slot_history.values())) == 2
    for u, p, (_, n) in zip(uids, prompts, jobs):
        assert res[u] == _alone(model, params, p, n), (u, len(p))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses(arch):
    cfg = get_config(arch).reduced()
    model = Model(cfg, make_policy(cfg).zcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="attn-only"):
        ServeEngine(model, params, n_slots=2, kv_len=KV, device="cpu",
                    pool="paged", page_size=4, kv_axes=())
    with pytest.raises(ValueError, match="attn-only"):
        model.init_paged_caches(4, 4)
    with pytest.raises(ValueError, match="attn-only"):
        steps.paged_cache_specs(model, ())


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_state_roundtrip(tmp_path, arch):
    cfg = get_config(arch).reduced()
    model = Model(cfg, make_policy(cfg).zcfg, world=1, device="cpu")
    mesh = mesh_lib.make_mesh((1, 1))
    st = ts.ZeroState(model, mesh).init(4)
    gen = torch.Generator().manual_seed(9)
    for mom in ("m", "v"):
        st.opt[mom] = {k: torch.rand(v.shape, generator=gen)
                       for k, v in st.params.items()}
    st.save(str(tmp_path), 3, meta={"arch": cfg.name})
    back = ts.ZeroState.restore(model, mesh, str(tmp_path))
    assert back is not None and back.step == 3
    assert back.meta["arch"] == cfg.name
    for k, v in st.params.items():
        assert torch.equal(back.params[k], v), k
    for mom in ("m", "v"):
        for k, v in st.opt[mom].items():
            assert torch.equal(back.opt[mom][k], v), (mom, k)


# ------------------------------------------------- the sequence over ranks

def _step(model, params, batch, **kw):
    st = trainer.build_train_step(model, AdamWConfig(), device="cpu", **kw)
    loss, _, grads = st.loss_and_grads(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return float(loss), to_numpy(grads), st.run_spec.seq_axes


def _seq_rank(rank, world, bufs, batch):
    mesh = mesh_lib.make_mesh((2, 2))
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        pol = make_policy(cfg, mesh_lib.AXES, mesh=mesh, qgz=False, **F32)
        model = Model(cfg, pol.zcfg, world=world, device="cpu")
        out[arch] = _step(model, params_from_numpy(
            bufs[arch], model, rank=rank, world=world), batch,
            global_batch=2, mesh=mesh)
    return out


def test_sequence_over_model_at_2x2_matches_world1():
    bufs, arch0 = {}, get_config(ARCHS[0]).reduced()
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        bufs[arch] = step_bars.global_params(
            Model(cfg, make_policy(cfg).zcfg, world=4, device="cpu"), 1)
    batch = tsyn.make_batch(arch0, tsyn.SyntheticLM(arch0.vocab, SEQ,
                                                    seed=7), 0, 2)
    ranks = mesh_lib.spawn(_seq_rank, 4, bufs, batch, device="cpu")
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        assert cfg.vocab == arch0.vocab
        tiles = [r[arch] for r in ranks]
        assert all(t[2] == ("model",) for t in tiles)
        model = Model(cfg, make_policy(cfg, qgz=False, **F32).zcfg,
                      device="cpu")
        p1 = {k: bufs[arch][k][..., :n[-1]]
              for k, n in model.param_shapes().items()}
        loss, grads, seq = _step(model, params_from_numpy(p1, model), batch,
                                 global_batch=2)
        assert seq == ()
        assert abs(sum(t[0] for t in tiles) - loss) <= 1e-5
        g4 = {k: np.concatenate([t[1][k] for t in tiles], axis=-1)
              for k in grads}
        _hold_grads({k: g4[k][..., :g.shape[-1]] for k, g in grads.items()},
                    grads, cfg.n_layers)
