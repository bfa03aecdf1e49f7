"""Port vs reference: the qgZ kernels' plain versions (B3, B4, B5).

``quantize_reordered`` (B3), ``dequant_reduce_quant`` (B4) and
``dequant_reduce`` (B5), reached through ``repro_torch.kernels.ops`` on CPU
tensors, must give BIT-IDENTICAL payloads, scales and fp32 sums to the
reference's ``repro.kernels.ref`` oracles under ``jax.jit`` and to its
Pallas kernels in interpret mode, on the same numpy inputs: INT4 and INT8,
f32 and bf16 gradients, N in {1, 2, 4, 8} contributions, (Y, X) in
{(1, 1), (2, 2), (2, 4)}, and with the uniform field that
``repro.core.quant.stochastic_uniform`` draws for a key.  The port sums
the N contributions in index order from +0; the reference's fp32 sum over
the leading axis gives the same bits at every N here, so no tolerance is
needed.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import functools                                             # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.core import quant as jq                           # noqa: E402
from repro.kernels import fused_dequant_reduce_quant as jfq  # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.kernels import quant_block as jqb                 # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402

from repro_torch.core import quant as tq                     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import platform                     # noqa: E402


def _torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _bits(a) -> np.ndarray:
    """Raw bits, so -0.0 and +0.0 differ."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_array_equal(_bits(_np(got)), _bits(want), err_msg=what)


def _grads(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 10)).astype(
        np.float32)
    x.reshape(-1)[:256] = 0.0                    # one all-zero block
    return np.asarray(jnp.asarray(x, dtype))


def _contributions(N, C, bits, block, seed):
    """N quantized contributions (N, P) int8 + (N, NB) f32, drawn the way
    a hop delivers them: each row the quantization of a random slice."""
    x = _grads((N, C), jnp.float32, seed)
    cfg = jq.QuantConfig(bits=bits, block_size=block)
    p, s = jax.jit(functools.partial(jq.quantize_blockwise, cfg=cfg))(
        jnp.asarray(x))
    return np.asarray(p), np.asarray(s)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("YX", [(1, 1), (2, 2), (2, 4)])
def test_quantize_reordered_bit_identical(bits, dtype, YX):
    Y, X = YX
    L, block = 1024, 256
    x = _grads((Y, X, L), dtype, seed=bits + 10 * Y + X)
    jcfg = jq.QuantConfig(bits=bits, block_size=block)
    tcfg = tq.QuantConfig(bits=bits, block_size=block)
    p, s = ops.quantize_reordered(_torch(x), tcfg)
    assert tuple(p.shape) == (X, Y, L // 2 if bits == 4 else L)
    refs = {"ref": jax.jit(functools.partial(jref.quantize_reordered_ref,
                                             cfg=jcfg))(jnp.asarray(x)),
            "pallas": jqb.quantize_reordered_pallas(jnp.asarray(x), jcfg,
                                                    interpret=True)}
    for name, (jp, js) in refs.items():
        _same(p, jp, name)
        _same(s, js, name)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_reordered_stochastic_field_bit_identical(bits):
    """A key's uniform field (drawn on the transposed (X, Y, L) layout, as
    the reference's dispatch draws it) feeds the port's ``u``; the
    reference rounds with the key itself under jit, and its Pallas kernel
    with the same field."""
    Y, X, L, block = 2, 2, 512, 256
    x = _grads((Y, X, L), jnp.bfloat16, seed=3 + bits)
    jcfg = jq.QuantConfig(bits=bits, block_size=block, stochastic=True)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jq.stochastic_uniform((X, Y, L), jcfg, key))
    p, s = ops.quantize_reordered(_torch(x), tq.QuantConfig(bits, block),
                                  _torch(u))
    with jops.use_backend("xla"):
        jp, js = jax.jit(lambda a, k: jops.quantize_reordered(a, jcfg, k))(
            jnp.asarray(x), key)
    kp, ks = jqb.quantize_reordered_pallas(jnp.asarray(x), jcfg,
                                           u=jnp.asarray(u), interpret=True)
    for name, (a, b) in {"xla": (jp, js), "pallas": (kp, ks)}.items():
        _same(p, a, name)
        _same(s, b, name)
    p_det, _ = ops.quantize_reordered(_torch(x), tq.QuantConfig(bits, block))
    assert not torch.equal(p, p_det)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_reduce_bit_identical(N, bits):
    C, block = 2048, 256
    pay, sc = _contributions(N, C, bits, block, seed=N + bits)
    jcfg = jq.QuantConfig(bits=bits, block_size=block)
    tcfg = tq.QuantConfig(bits=bits, block_size=block)
    got = ops.dequant_reduce(_torch(pay), _torch(sc), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C,)
    refs = {"ref": jax.jit(functools.partial(jref.dequant_reduce_ref,
                                             cfg=jcfg))(pay, sc),
            "pallas": jfq.dequant_reduce_pallas(jnp.asarray(pay),
                                                jnp.asarray(sc), jcfg,
                                                interpret=True)}
    for name, want in refs.items():
        _same(got, want, name)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
@pytest.mark.parametrize("bits_in,bits_out", [(4, 4), (8, 8), (8, 4)])
def test_dequant_reduce_quant_bit_identical(N, bits_in, bits_out):
    C, block = 2048, 256
    pay, sc = _contributions(N, C, bits_in, block, seed=3 * N + bits_in)
    jin = jq.QuantConfig(bits=bits_in, block_size=block)
    jout = jq.QuantConfig(bits=bits_out, block_size=block)
    p, s = ops.dequant_reduce_quant(_torch(pay), _torch(sc),
                                    tq.QuantConfig(bits_in, block),
                                    tq.QuantConfig(bits_out, block))
    refs = {"ref": jax.jit(functools.partial(jref.dequant_reduce_quant_ref,
                                             cfg_in=jin, cfg_out=jout))(
                pay, sc),
            "pallas": jfq.dequant_reduce_quant_pallas(
                jnp.asarray(pay), jnp.asarray(sc), jin, jout,
                interpret=True)}
    for name, (jp, js) in refs.items():
        _same(p, jp, name)
        _same(s, js, name)


@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_reduce_quant_stochastic_field_bit_identical(bits):
    N, C, block = 4, 2048, 256
    pay, sc = _contributions(N, C, bits, block, seed=17 + bits)
    jcfg = jq.QuantConfig(bits=bits, block_size=block)
    jsr = jq.QuantConfig(bits=bits, block_size=block, stochastic=True)
    key = jax.random.PRNGKey(9)
    u = np.asarray(jq.stochastic_uniform((C,), jsr, key))
    tcfg = tq.QuantConfig(bits, block)
    p, s = ops.dequant_reduce_quant(_torch(pay), _torch(sc), tcfg, tcfg,
                                    _torch(u))
    with jops.use_backend("xla"):
        jp, js = jax.jit(lambda a, b, k: jops.dequant_reduce_quant(
            a, b, jcfg, jsr, k))(pay, sc, key)
    kp, ks = jfq.dequant_reduce_quant_pallas(
        jnp.asarray(pay), jnp.asarray(sc), jcfg, jsr, u=jnp.asarray(u),
        interpret=True)
    for name, (a, b) in {"xla": (jp, js), "pallas": (kp, ks)}.items():
        _same(p, a, name)
        _same(s, b, name)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors nothing launches: the counters stay put."""
    before = dict(platform.LAUNCHES)
    cfg = tq.QuantConfig(4, 256)
    p, s = ops.quantize_reordered(torch.randn(2, 2, 512), cfg)
    ops.dequant_reduce_quant(p.reshape(2, -1), s.reshape(2, -1), cfg, cfg)
    ops.dequant_reduce(p.reshape(2, -1), s.reshape(2, -1), cfg)
    assert platform.LAUNCHES == before


def test_wrappers_reject_mismatched_shapes():
    cfg = tq.QuantConfig(4, 256)
    with pytest.raises(ValueError, match="multiple of block"):
        ops.quantize_reordered(torch.zeros(2, 2, 300), cfg)
    with pytest.raises(ValueError, match="u shape"):
        ops.quantize_reordered(torch.zeros(2, 1, 256), cfg,
                               torch.zeros(2, 1, 256))
    with pytest.raises(ValueError, match="do not match"):
        ops.dequant_reduce(torch.zeros(2, 128, dtype=torch.int8),
                           torch.zeros(2, 2), cfg)
    with pytest.raises(ValueError, match="block_size"):
        ops.dequant_reduce_quant(torch.zeros(1, 128, dtype=torch.int8),
                                 torch.zeros(1, 1), cfg,
                                 tq.QuantConfig(4, 128))
