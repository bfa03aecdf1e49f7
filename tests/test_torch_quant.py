"""Port vs reference: blockwise quantize (B1) and dequantize (B2).

The port's plain versions, reached through ``repro_torch.kernels.ops`` on
CPU tensors, must give BIT-IDENTICAL payloads, scales and f32/bf16 outputs
to the reference's ``repro.core.quant`` functions and to its Pallas
kernels in interpret mode, on the same numpy inputs.  The reference runs
under ``jax.jit``, as every reference path does: there XLA folds
``absmax / qmax`` into ``absmax * fl(1/qmax)``, which is the op the port
implements (un-jitted, the reference divides and may differ in the last
bit of a scale).
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
from repro.kernels.quant_block import (dequantize_pallas,    # noqa: E402
                                       quantize_pallas)

from repro_torch.core import quant as tq                     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _input(shape, dtype, seed, zero_block=None):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(1e-3, 50.0)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if zero_block is not None:
        x[..., :zero_block] = 0.0                 # one all-zero block
    return np.asarray(jnp.asarray(x, dtype))     # rounds to bf16 if asked


# (shape, block, bits, dtype, zero block)
CASES = [
    ((1, 4096), 256, 8, jnp.float32, None),
    ((1, 4096), 256, 8, jnp.bfloat16, 256),
    ((3, 1024), 256, 8, jnp.float32, 256),
    ((4, 2048), 128, 4, jnp.float32, None),
    ((2, 1536), 256, 4, jnp.bfloat16, 256),
    ((5, 512), 64, 8, jnp.bfloat16, None),
    ((2, 4096), 1024, 4, jnp.bfloat16, None),
    ((8, 768), 256, 8, jnp.bfloat16, None),
]


@pytest.mark.parametrize("shape,block,bits,dtype,zero", CASES)
def test_quantize_dequantize_bit_identical(shape, block, bits, dtype, zero):
    x = _input(shape, dtype, seed=sum(shape) + bits, zero_block=zero)
    jcfg = jq.QuantConfig(bits=bits, block_size=block)
    tcfg = tq.QuantConfig(bits=bits, block_size=block)
    p, s = ops.quantize_blockwise(_torch(x), tcfg)
    refs = {
        "core.quant": jax.jit(functools.partial(
            jq.quantize_blockwise, cfg=jcfg))(jnp.asarray(x)),
        "quantize_pallas": quantize_pallas(jnp.asarray(x), jcfg,
                                           interpret=True),
    }
    for name, (jp, js) in refs.items():
        np.testing.assert_array_equal(_np(p), np.asarray(jp), err_msg=name)
        np.testing.assert_array_equal(_np(s), np.asarray(js), err_msg=name)
    for out in (jnp.float32, jnp.bfloat16):
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        d = ops.dequantize_blockwise(p, s, tcfg, tout)
        jp, js = refs["core.quant"]
        ref_d = jax.jit(functools.partial(
            jq.dequantize_blockwise, cfg=jcfg, out_dtype=out))(jp, js)
        ker_d = dequantize_pallas(jp, js, jcfg, out, interpret=True)
        np.testing.assert_array_equal(_np(d), _bits(ref_d))
        np.testing.assert_array_equal(_np(d), _bits(ker_d))


@pytest.mark.parametrize("bits,dtype", [(8, jnp.float32), (4, jnp.bfloat16),
                                        (8, jnp.bfloat16)])
def test_quantize_stochastic_field_bit_identical(bits, dtype):
    """A given uniform field ``u``: the same numpy array feeds the Pallas
    kernel's ``u=`` and the port."""
    shape, block = (3, 2048), 256
    x = _input(shape, dtype, seed=7 + bits, zero_block=block)
    u = np.random.default_rng(11).random(shape).astype(np.float32)
    jcfg = jq.QuantConfig(bits=bits, block_size=block)
    tcfg = tq.QuantConfig(bits=bits, block_size=block)
    p, s = ops.quantize_blockwise(_torch(x), tcfg, u=_torch(u))
    jp, js = quantize_pallas(jnp.asarray(x), jcfg, u=jnp.asarray(u),
                             interpret=True)
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    # the field is not ignored: deterministic rounding differs somewhere
    p_det, _ = ops.quantize_blockwise(_torch(x), tcfg)
    assert not torch.equal(p, p_det)


def test_flat_shard_goes_through_as_one_row():
    """A flat 1-D shard (the qwZ gather's input) is quantized as (1, N),
    and matches the reference's 1-D call."""
    x = _input((8192,), jnp.bfloat16, seed=3)
    cfg = jq.QuantConfig(bits=8, block_size=256)
    p, s = ops.quantize_blockwise(_torch(x), tq.QuantConfig())
    jp, js = jax.jit(functools.partial(jq.quantize_blockwise, cfg=cfg))(
        jnp.asarray(x))
    assert tuple(p.shape) == (8192,) and tuple(s.shape) == (32,)
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    np.testing.assert_array_equal(_np(s), np.asarray(js))


def test_int4_pack_unpack_roundtrip():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(4)
    packed = tq.pack_int4(q)
    assert packed.shape[-1] == q.shape[-1] // 2
    assert torch.equal(tq.unpack_int4(packed), q)
    jpacked = jq.pack_int4(jnp.asarray(q.numpy()))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))


def test_quantize_rejects_ragged_blocks():
    with pytest.raises(ValueError, match="multiple of block"):
        ops.quantize_blockwise(torch.zeros(1, 300), tq.QuantConfig())
    with pytest.raises(ValueError, match="bits"):
        tq.QuantConfig(bits=6)
