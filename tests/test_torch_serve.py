"""Port vs reference: the qwZ serving path of a reduced qwen3-0.6b.

The reference (``repro``) runs its jitted shard_map steps on a one-device
``("model",)`` mesh, where ``ZeroConfig.distributed`` holds, so every
layer group goes through the qwZ quantize -> gather (identity) ->
dequantize round trip and the head takes the fused INT8 dequant-GEMM
route (broadcast scales at d=64, block 256).  The port runs the same
flat buffers, converted from the reference's numpy arrays, on the CPU
(plain versions of its kernels).

Tolerances: in f32 both sides quantize bit-identically, so logits and
caches differ only by fp32 summation order in the matmuls and softmax
(measured: 2e-6 max abs on logits of magnitude ~4); the bar is 1e-5 abs +
1e-5 rel.  In bf16 the two frameworks round intermediate activations at
different places, so the bar is 0.1 abs on logits of magnitude ~4
(measured: 0.03) and 0.1 abs on the bf16 caches, plus top-1 agreement at
every position whose reference top-2 gap exceeds 0.2.
"""
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
from repro.models.model import Model as JaxModel             # noqa: E402
from repro.serve import ServeEngine as JaxEngine             # noqa: E402
from repro.serve import steps as jax_steps                   # noqa: E402
from repro.train.policy import make_policy                   # noqa: E402
from repro.train.state import param_specs                    # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy            # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.kernels import platform                     # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import ServeEngine, steps             # noqa: E402

JOBS = [(5, 6), (11, 4), (8, 5), (3, 7)]      # (prompt_len, max_new) x4
KV = 32
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _port_zcfg(jz):
    """The port's ZeroConfig with the reference policy's serving fields."""
    return ZeroConfig(qwz=jz.qwz, qwz_bits=jz.qwz_bits,
                      qwz_block=jz.qwz_block, qwz_gemm=jz.qwz_gemm,
                      qgz_block=jz.qgz_block, dp_axes=tuple(jz.dp_axes),
                      param_dtype=_TORCH[jz.param_dtype],
                      compute_dtype=_TORCH[jz.compute_dtype])


def _setup(dtype, **overrides):
    mesh = make_mesh((1,), ("model",))
    arch = jax_get_config("qwen3-0.6b").reduced()
    pol = make_policy(arch, mesh.axis_names, param_dtype=dtype,
                      compute_dtype=dtype, **overrides)
    jmodel = JaxModel(arch, pol.zcfg, world=1)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), dtype=dtype)
    specs = param_specs(jmodel, tuple(mesh.axis_names))
    jparams = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
               for k, v in jparams.items()}
    model = Model(get_config("qwen3-0.6b").reduced(), _port_zcfg(pol.zcfg),
                  world=1, device="cpu")
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               model)
    return (jmodel, mesh, jparams), (model, params)


@pytest.fixture(scope="module")
def f32_pair():
    return _setup(jnp.float32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _run_both(pair, B=2, S=8, n_decode=3, seed=0):
    """Prefill a (B, S) batch with per-row last positions, then decode
    n_decode steps at per-row positions; returns the reference's and the
    port's (logits list, final caches)."""
    (jmodel, mesh, jparams), (model, params) = pair
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    last = np.array([S - 1 - (b % 3) for b in range(B)], np.int32)
    nxt = rng.integers(0, model.cfg.vocab, (n_decode, B, 1)).astype(np.int32)

    jps = jax_steps.build_prefill_step(jmodel, mesh, (), (),
                                       with_last_pos=True)
    jds = jax_steps.build_decode_step(jmodel, mesh, (), ("model",),
                                      donate=False)
    jl, jc = jps.fn(jparams, {"tokens": toks}, jnp.asarray(last))
    jlogits, jpre = [np.asarray(jl)], jax.tree.map(np.asarray, jc)
    jc = jax_steps.pad_prefill_caches(jmodel, jc, KV)
    ps = steps.build_prefill_step(model, with_last_pos=True, device="cpu")
    ds = steps.build_decode_step(model, device="cpu")
    tl, tc = ps.fn(params, {"tokens": torch.from_numpy(toks).long()},
                   torch.from_numpy(last).long())
    tlogits = [_np(tl)]
    tpre = {k: _np(tc["blocks"][0][k]) for k in ("k", "v")}
    tc = steps.pad_prefill_caches(tc, KV)
    for i in range(n_decode):
        pos = last + 1 + i
        jl, jc = jds.fn(jparams, jc, {"tokens": nxt[i]}, jnp.asarray(pos))
        jlogits.append(np.asarray(jl))
        tl, tc = ds.fn(params, tc, {"tokens": torch.from_numpy(nxt[i]).long()},
                       torch.from_numpy(pos))
        tlogits.append(_np(tl))
    jfin = {k: np.asarray(jc["blocks"][0][k], np.float32) for k in ("k", "v")}
    tfin = {k: _np(tc["blocks"][0][k]) for k in ("k", "v")}
    jpre = {k: np.asarray(jpre["blocks"][0][k], np.float32)
            for k in ("k", "v")}
    return (jlogits, jpre, jfin), (tlogits, tpre, tfin)


# the gather routes of the head and the layers: qwZ with the fused INT8
# head (the default), qwZ with the staged head, the bf16 baseline gather
VARIANTS = {"qwz_fused_head": {}, "qwz_staged_head": {"qwz_gemm": False},
            "baseline_gather": {"qwz": False}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_decode_match_reference_f32(f32_pair, variant):
    pair = f32_pair if not VARIANTS[variant] \
        else _setup(jnp.float32, **VARIANTS[variant])
    (jl, jpre, jfin), (tl, tpre, tfin) = _run_both(pair)
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpre[k], jpre[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tfin[k], jfin[k], rtol=1e-5, atol=1e-5)


def test_prefill_decode_match_reference_bf16():
    """bf16 params and compute (the card's dtype): looser bar, same top-1."""
    (jl, jpre, jfin), (tl, tpre, tfin) = _run_both(_setup(jnp.bfloat16),
                                                   B=8, seed=1)
    n_clear = 0
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=0, atol=0.1)
        srt = np.sort(a, axis=-1)
        clear = (srt[..., -1] - srt[..., -2]) > 0.2
        n_clear += int(clear.sum())
        np.testing.assert_array_equal(b.argmax(-1)[clear],
                                      a.argmax(-1)[clear])
    assert n_clear >= 3
    for k in ("k", "v"):
        np.testing.assert_allclose(tpre[k], jpre[k], rtol=0, atol=0.1)
        np.testing.assert_allclose(tfin[k], jfin[k], rtol=0, atol=0.1)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in JOBS]


def _port_greedy(model, params, prompt, n):
    """One request alone through the port's raw prefill + decode steps."""
    ps = steps.build_prefill_step(model, device="cpu")
    ds = steps.build_decode_step(model, device="cpu")
    logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
        prompt[None, :]).long()})
    caches = steps.pad_prefill_caches(caches, KV)
    toks = [int(logits[0, -1].argmax())]
    for i in range(1, n):
        logits, caches = ds.fn(params, caches,
                               {"tokens": torch.tensor([[toks[-1]]])},
                               torch.tensor([len(prompt) + i - 1]))
        toks.append(int(logits[0, -1].argmax()))
    return toks


def test_engine_greedy_matches_reference_engine(f32_pair):
    """4 requests, mixed prompt lengths, 3 slots (one slot recycled): the
    port's engine emits per request exactly the reference engine's greedy
    tokens, and exactly its own per-request raw prefill+decode tokens."""
    (jmodel, mesh, jparams), (model, params) = f32_pair
    prompts = _prompts(model.cfg.vocab)
    jeng = JaxEngine(jmodel, mesh, jparams, n_slots=3, kv_len=KV)
    eng = ServeEngine(model, params, n_slots=3, kv_len=KV, device="cpu")
    juids = [jeng.submit(pr, max_new_tokens=n)
             for pr, (_, n) in zip(prompts, JOBS)]
    uids = [eng.submit(pr, max_new_tokens=n)
            for pr, (_, n) in zip(prompts, JOBS)]
    jres = jeng.run(max_steps=100)
    res = eng.run(max_steps=100)
    for ju, u, pr, (_, n) in zip(juids, uids, prompts, JOBS):
        assert len(res[u]) == n
        assert res[u] == jres[ju], (u, res[u], jres[ju])
        assert res[u] == _port_greedy(model, params, pr, n)
    slots = [eng.slot_history[u] for u in uids]
    assert slots == [jeng.slot_history[u] for u in juids]
    assert len(set(slots)) == 3                    # a retired slot recycled
    assert eng.pool.n_free == 3 and (eng.pool.lengths == 0).all()
    st = eng.stats()
    assert st["completed"] == 4 and st["ttft_ms"]["n"] == 4
    assert st["tok_per_s"] is not None
