"""Port vs reference: every dense config the two packages share, reduced.

The reference's ``tests/test_models_smoke.py`` cases on the port, each
held against the reference on the same converted parameters and inputs,
for qwen3-0.6b, gpt-350m, gemma3-4b, starcoder2-3b, qwen1.5-110b (QKV
bias), qwen2-vl-72b (QKV bias, M-RoPE, embedding inputs), musicgen-large
(embedding inputs, MHA) and gpt-18b, each ``reduced()``.  Both sides run
``ZeroConfig.local`` in fp32, as the reference's smoke test does.  The
reference's ``init_params`` buffers cross through ``convert``, with every
``bq``/``bk``/``bv`` bias drawn nonzero from a seed (zero biases would
not test the bias path).  Inputs are numpy draws from a seed; M-RoPE
positions are the stub's (t, t // 16, t % 16) over S = 32, whose three
streams differ (the reference smoke test's (p, p, p) gives plain RoPE's
tables and cannot catch a wrong section split).

  * the train step: the reference's assertions on the port (a finite
    loss under 3 ln V + 5, every gradient finite and nonzero, an SGD step
    of 0.05 lowers the loss), and the port's loss within 1e-5 and
    gradients within ``step_bars.close`` (rtol 1e-5 / atol 1e-6) of the
    reference's (gemma3-4b's 6 layers: the depth-scaled atol of
    ``tests/test_torch_gemma3.py``'s 8-layer step);
  * prefill over 32 positions, then 3 decode steps from the prefill
    caches grown to 36 slots (tokens, or embeddings and the next
    positions): shapes, finite values, every logit within 1e-5;
  * the port's own decode-against-prefill consistency (the reference's
    ``test_decode_matches_forward_dense``) for qwen2-vl reduced at 2e-4,
    the embeddings and positions fed step by step;
  * ``mrope_tables`` against the reference's at head dims 16 and 128
    (atol 1e-6), and equal streams give ``rope_table``'s values;
  * the stub's embeddings and positions bit-identical to
    ``repro.data.synthetic.make_batch``;
  * ``logit_softcap=30`` (a ``reduced()`` override, with the query and
    key weights scaled so that the cap bites) on the dense (S 64),
    chunked (S 2048 > ``kv_chunk``) and flash (S 512 under
    ``attn_impl="pallas"``: the plain B6/B7 here) routes, loss and
    gradients against the reference at the bars above, and on the decode
    route at 1e-5;
  * every field of the port's ``ArchConfig`` is the reference's, full and
    reduced; ``ServeEngine`` refuses an embedding-input, M-RoPE model;
    gradient accumulation cuts embeddings into microbatches (the step
    equals the whole batch's at the fp32 bars) and refuses M-RoPE.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core.zeropp import ZeroConfig as JaxZeroConfig    # noqa: E402
from repro.data import synthetic as jsyn                     # noqa: E402
from repro.models import layers as jlayers                   # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402
from repro.models.transformer import RunSpec as JaxRunSpec   # noqa: E402
from repro.train import serve as jserve                      # noqa: E402

from repro_torch.configs import get_config, list_archs       # noqa: E402
from repro_torch.configs.base import ArchConfig              # noqa: E402
from repro_torch.convert import params_from_numpy            # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402
from repro_torch.models import layers as tlayers             # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.models.transformer import RunSpec           # noqa: E402
from repro_torch.optim.adamw import AdamWConfig              # noqa: E402
from repro_torch.serve import ServeEngine, steps             # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train.trainer import build_train_step       # noqa: E402

ARCHS = ("gemma3-4b", "gpt-18b", "gpt-350m", "musicgen-large",
         "qwen1.5-110b", "qwen2-vl-72b", "qwen3-0.6b", "starcoder2-3b")
VLM = "qwen2-vl-72b"
JZ = JaxZeroConfig.local(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TZ = ZeroConfig.local(param_dtype=torch.float32, compute_dtype=torch.float32)
B, S, N_DECODE = 2, 32, 3
KV = S + N_DECODE + 1


def test_the_registry_is_the_references_dense_set():
    # the dense set beside the two MoE configs (tests/test_torch_moe.py)
    # and the SSM and hybrid ones (tests/test_torch_ssm_models.py)
    assert tuple(list_archs()) == tuple(sorted(
        ARCHS + ("deepseek-moe-16b", "qwen3-moe-235b-a22b", "mamba2-130m",
                 "recurrentgemma-2b")))
    from repro.configs import list_archs as jax_list_archs
    assert set(ARCHS) <= set(jax_list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_are_the_references(arch):
    """Every field of the port's ``ArchConfig`` (the new ``qkv_bias``,
    ``mrope``, ``logit_softcap`` and ``embed_inputs`` among them), full
    and reduced, and under a ``reduced()`` override."""
    for over in (None, {}, {"logit_softcap": 30.0, "n_layers": 3}):
        j, t = jax_get_config(arch), get_config(arch)
        if over is not None:
            j, t = j.reduced(**over), t.reduced(**over)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)


# ------------------------------------------------------------------ state

def _thw(batch: int, start: int, n: int) -> np.ndarray:
    """The stub's (t, t // 16, t % 16) positions of t in [start, start +
    n): (3, batch, n) int32."""
    t = np.tile(np.arange(start, start + n, dtype=np.int32), (batch, 1))
    return np.stack([t, t // 16, t % 16]).astype(np.int32)


def _inputs(cfg, rng, rows: int, start: int, n: int) -> dict:
    """Model inputs of ``n`` positions from ``start``: tokens or
    embeddings, and M-RoPE positions where the config takes them."""
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = (rng.standard_normal((rows, n, cfg.d_model))
                         * 0.1).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (rows, n)).astype(np.int32)
    if cfg.mrope:
        out["positions"] = _thw(rows, start, n)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).float() if k == "embeds"
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _scale(jm, params, names, factor):
    """Multiply the entries ``names`` of every layer group by ``factor``."""
    for group, spec in (("blocks", jm.period_spec), ("rem", jm.rem_spec)):
        if spec is None:
            continue
        buf = params[group].reshape(-1, spec.padded_size)
        for name, _ in spec.entries:
            if name.split(".")[-1] in names:
                off, n = spec.offsets[name]
                buf[:, off:off + n] *= factor


class _Pair:
    """The reference's and the port's model of ``arch`` reduced (with
    ``over``) on the reference's ``init_params`` buffers, biases seeded
    nonzero; ``qk_scale`` multiplies the query and key weights."""

    def __init__(self, arch: str, qk_scale: float = 1.0, **over):
        self.jarch = jax_get_config(arch).reduced(**over)
        self.arch = get_config(arch).reduced(**over)
        self.jm = JaxModel(self.jarch, JZ)
        self.tm = Model(self.arch, TZ, device="cpu")
        jp = {k: np.array(v) for k, v in self.jm.init_params(
            jax.random.PRNGKey(0), dtype=jnp.float32).items()}
        rng = np.random.default_rng(11)
        for group, spec in (("blocks", self.jm.period_spec),
                            ("rem", self.jm.rem_spec)):
            if spec is None:
                continue
            buf = jp[group].reshape(-1, spec.padded_size)
            for name, _ in spec.entries:
                if name.split(".")[-1] in ("bq", "bk", "bv"):
                    off, n = spec.offsets[name]
                    buf[:, off:off + n] = 0.5 * rng.standard_normal(
                        (buf.shape[0], n))
        if qk_scale != 1.0:
            _scale(self.jm, jp, ("wq", "wk"), qk_scale)
        self.np_params = jp
        self.jp = {k: jnp.asarray(v) for k, v in jp.items()}
        self.tp = params_from_numpy(jp, self.tm)

    def ref_loss_grads(self, batch, attn_impl="xla"):
        rs = JaxRunSpec(mode="train", attn_impl=attn_impl)
        f = jax.jit(jax.value_and_grad(
            lambda p, b: self.jm.loss_fn(p, b, rs, dp_world=1)[0]))
        loss, g = f(self.jp, batch)
        return f, float(loss), {k: np.asarray(v) for k, v in g.items()}

    def port_loss_grads(self, params, batch, attn_impl="xla"):
        st = build_train_step(self.tm, AdamWConfig(), device="cpu",
                              attn_impl=attn_impl)
        loss, _, grads = st.loss_and_grads(params, _torch(batch))
        return float(loss), {k: v.numpy() for k, v in grads.items()}

    def serve(self, batch, steps_in):
        """(prefill logits, [decode logits]) of the reference and of the
        port: prefill over ``batch``, caches grown to KV, then one decode
        step per ``steps_in`` entry at positions S, S + 1, ..."""
        jl, jc = jax.jit(lambda p, b: self.jm.prefill_fn(
            p, b, JaxRunSpec(mode="prefill")))(self.jp, batch)
        jc = jserve.pad_prefill_caches(self.jm, jc, KV)
        jd = jax.jit(lambda p, c, b, t: self.jm.decode_fn(
            p, c, b, t, JaxRunSpec(mode="decode", kv_len=KV)))
        tl, tc = self.tm.prefill_fn(self.tp, _torch(batch),
                                    RunSpec(mode="prefill"))
        tc = steps.pad_prefill_caches(self.tm, tc, KV)
        j_out, t_out = [np.asarray(jl)], [tl.numpy()]
        for i, db in enumerate(steps_in):
            pos = np.full((B,), S + i, np.int32)
            jl, jc = jd(self.jp, jc, db, jnp.asarray(pos))
            tl, tc = self.tm.decode_fn(self.tp, tc, _torch(db),
                                       torch.from_numpy(pos),
                                       RunSpec(mode="decode"))
            j_out.append(np.asarray(jl))
            t_out.append(tl.numpy())
        return j_out, t_out


def _hold_grads(tg, jg, n_layers: int = 2):
    """``step_bars.close``; a stack deeper than 2 layers (gemma3-4b
    reduced: one period of 6) takes the depth-scaled atol of
    ``tests/test_torch_gemma3.py``'s ``_exact_deep``, 1e-5 · max
    |reference|, since fp32 summation noise grows with depth."""
    assert set(tg) == set(jg)
    for k in tg:
        assert tg[k].shape == jg[k].shape, k
        if n_layers <= 2:
            step_bars.close(tg[k], jg[k], f"grad {k}")
        else:
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(jg[k]).max(),
                                       err_msg=f"grad {k}")


# ------------------------------------------------------------- train step

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    pair = _Pair(arch)
    cfg = pair.arch
    rng = np.random.default_rng(0)
    batch = _inputs(cfg, rng, B, 0, S)
    batch["targets"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    f, j_loss, j_grads = pair.ref_loss_grads(batch)
    loss0, grads = pair.port_loss_grads(pair.tp, batch)
    # the reference smoke test's assertions, on the port
    assert np.isfinite(loss0), f"{arch} loss NaN"
    assert 0 < loss0 < 3 * np.log(cfg.vocab) + 5
    for k, v in grads.items():
        assert np.isfinite(v).all(), f"{arch} grad {k} NaN"
        assert np.abs(v).max() > 0, f"{arch} grad {k} all-zero"
    assert ("embed" in grads) == (not cfg.embed_inputs)
    stepped = {k: v - 0.05 * torch.from_numpy(grads[k])
               for k, v in pair.tp.items()}
    loss1, _ = pair.port_loss_grads(stepped, batch)
    assert loss1 < loss0, f"{arch} SGD step did not reduce the loss"
    # against the reference, before and after the SGD step
    assert abs(loss0 - j_loss) <= 1e-5, (loss0, j_loss)
    _hold_grads(grads, j_grads, cfg.n_layers)
    j_loss1, _ = f({k: v - 0.05 * j_grads[k] for k, v in pair.jp.items()},
                   batch)
    assert abs(loss1 - float(j_loss1)) <= 1e-5, (loss1, float(j_loss1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_smoke(arch):
    pair = _Pair(arch)
    cfg = pair.arch
    rng = np.random.default_rng(1)
    batch = _inputs(cfg, rng, B, 0, S)
    dec = [_inputs(cfg, rng, B, S + i, 1) for i in range(N_DECODE)]
    j_out, t_out = pair.serve(batch, dec)
    for i, (j, t) in enumerate(zip(j_out, t_out)):
        assert t.shape == (B, 1, cfg.vocab)
        assert np.isfinite(t).all(), f"{arch} step {i} NaN"
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{arch} step {i}")


def test_decode_matches_forward_dense():
    """Token-by-token decode logits == the prefill's last logits, for
    qwen2-vl reduced: each step feeds its own embedding and positions."""
    pair = _Pair(VLM)
    cfg, tm = pair.arch, pair.tm
    n = 20
    batch = _torch(_inputs(cfg, np.random.default_rng(2), 1, 0, n))
    caches = tm.init_caches(1, n, dtype=torch.float32)
    for t in range(n):
        step = {"embeds": batch["embeds"][:, t:t + 1],
                "positions": batch["positions"][:, :, t:t + 1]}
        lg, caches = tm.decode_fn(pair.tp, caches, step, torch.tensor([t]),
                                  RunSpec(mode="decode"))
    last, _ = tm.prefill_fn(pair.tp, batch, RunSpec(mode="prefill"))
    np.testing.assert_allclose(lg[:, 0].numpy(), last[:, 0].numpy(),
                               rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("head_dim", (16, 128))
def test_mrope_tables_match_reference(head_dim):
    rng = np.random.default_rng(head_dim)
    pos = rng.integers(0, 4096, (3, 2, 40)).astype(np.int32)
    jc, js = jlayers.mrope_tables(jnp.asarray(pos), head_dim, 1e6)
    tc, ts = tlayers.mrope_tables(torch.from_numpy(pos), head_dim, 1e6)
    assert tuple(tc.shape) == (2, 40, head_dim // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # the three sections really read three streams
    half = head_dim // 2
    s_t, s_h = int(half * 0.25), int(half * 0.375)
    for sec, stream in ((slice(0, s_t), 0), (slice(s_t, s_t + s_h), 1),
                        (slice(s_t + s_h, half), 2)):
        rc, _ = tlayers.rope_table(torch.from_numpy(pos[stream]), head_dim,
                                   1e6)
        np.testing.assert_array_equal(tc[..., sec].numpy(),
                                      rc[..., sec].numpy())
    # witness: equal streams are plain RoPE
    same = np.stack([pos[0]] * 3)
    mc, ms = tlayers.mrope_tables(torch.from_numpy(same), head_dim, 1e6)
    rc, rs = tlayers.rope_table(torch.from_numpy(pos[0]), head_dim, 1e6)
    np.testing.assert_array_equal(mc.numpy(), rc.numpy())
    np.testing.assert_array_equal(ms.numpy(), rs.numpy())


@pytest.mark.parametrize("arch", (VLM, "musicgen-large"))
def test_stub_batch_is_the_references(arch):
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    for step in (0, 3):
        t = tsyn.make_batch(cfg, tsyn.SyntheticLM(cfg.vocab, 40, seed=7),
                            step, 4)
        j = jsyn.make_batch(jcfg, jsyn.SyntheticLM(cfg.vocab, 40, seed=7),
                            step, 4)
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert ("positions" in t) == cfg.mrope and "tokens" not in t
    # the table is drawn once per (vocab, d_model, dtype)
    a = tsyn.stub_table(cfg.vocab, cfg.d_model)
    assert tsyn.stub_table(cfg.vocab, cfg.d_model) is a
    assert tsyn.stub_table(cfg.vocab, 32).shape == (cfg.vocab, 32)


# ---------------------------------------------------------- logit softcap

CAP = 30.0
# logits of std ~2.5: the cap moves the loss by ~1e-2 on every route, and
# the softmax stays soft enough for fp32 noise to sit under the bars
QK_SCALE = 2.5


@pytest.fixture(scope="module")
def capped():
    return _Pair(VLM, qk_scale=QK_SCALE, logit_softcap=CAP)


@pytest.fixture(scope="module")
def uncapped():
    return _Pair(VLM, qk_scale=QK_SCALE)


@pytest.mark.parametrize("route,seq,impl", [
    ("dense", 64, "xla"), ("chunked", 2048, "xla"), ("flash", 512, "pallas")])
def test_logit_softcap_train_routes_match_reference(capped, uncapped, route,
                                                    seq, impl):
    """Loss and gradients through each ``mha`` route under the cap, and a
    witness that the cap changes the loss beyond the bar.  The flash
    route is the port's plain B6/B7 against the reference's plain
    attention (the same function)."""
    rng = np.random.default_rng(seq)
    rows = 2 if seq == 64 else 1
    batch = _inputs(capped.arch, rng, rows, 0, seq)
    batch["targets"] = rng.integers(0, capped.arch.vocab,
                                    (rows, seq)).astype(np.int32)
    _, j_loss, j_grads = capped.ref_loss_grads(batch)
    loss, grads = capped.port_loss_grads(capped.tp, batch, attn_impl=impl)
    assert abs(loss - j_loss) <= 1e-5, (loss, j_loss)
    _hold_grads(grads, j_grads)
    free = uncapped.port_loss_grads(uncapped.tp, batch, attn_impl=impl)[0]
    assert abs(free - loss) > 1e-3, (route, free, loss)


def test_logit_softcap_decode_matches_reference(capped):
    rng = np.random.default_rng(5)
    batch = _inputs(capped.arch, rng, B, 0, S)
    dec = [_inputs(capped.arch, rng, B, S + i, 1) for i in range(N_DECODE)]
    j_out, t_out = capped.serve(batch, dec)
    for i, (j, t) in enumerate(zip(j_out, t_out)):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")


# ---------------------------------------------------------------- serving

def test_engine_refuses_stub_fed_models(tmp_path):
    """The reference's refusal: embedding-input and M-RoPE models serve
    through the raw steps only (the constructor and the checkpoint boot,
    before anything is read)."""
    for arch in (VLM, "musicgen-large"):
        cfg = get_config(arch).reduced()
        model = Model(cfg, TZ, device="cpu")
        with pytest.raises(ValueError, match="token-in models"):
            ServeEngine(model, {}, n_slots=2, kv_len=16, device="cpu")
        with pytest.raises(ValueError, match="token-in models"):
            ServeEngine.from_checkpoint(model, str(tmp_path / "none"),
                                        n_slots=2, kv_len=16, device="cpu")


def test_accumulation_cuts_embeds_and_mrope_positions():
    """accum > 1: the embeddings (B, S, d) are cut into microbatches as the
    reference's launcher cuts every leaf, and M-RoPE positions (3, B, S)
    on their rows into (accum, 3, B/accum, S), as the reference's trainer
    takes them (``P(None, None, b, s)``); the two halves' step equals the
    whole batch's for musicgen-large (embeds) and qwen2-vl-72b (embeds and
    M-RoPE)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import device_batch
    for arch in ("musicgen-large", VLM):
        cfg = get_config(arch).reduced()
        model = Model(cfg, TZ, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float32)
        lm = SyntheticLM(cfg.vocab, 32, seed=7)
        one = build_train_step(model, AdamWConfig(), device="cpu")
        two = build_train_step(model, AdamWConfig(), accum=2, device="cpu")
        whole = device_batch(cfg, lm, 0, 4, 1, "cpu")
        halves = device_batch(cfg, lm, 0, 4, 2, "cpu")
        assert whole["embeds"].dtype == torch.float32
        assert tuple(halves["embeds"].shape) == (2, 2, 32, cfg.d_model)
        if cfg.mrope:
            assert tuple(halves["positions"].shape) == (2, 3, 2, 32)
            for i in range(2):
                assert torch.equal(halves["positions"][i],
                                   whole["positions"][:, 2 * i:2 * i + 2])
        l1, _, g1 = one.loss_and_grads(params, whole)
        l2, _, g2 = two.loss_and_grads(params, halves)
        assert abs(float(l1) - float(l2)) <= 1e-5, (arch, l1, l2)
        for k in g1:
            step_bars.close(g2[k].numpy(), g1[k].numpy(), f"{arch} {k}")
