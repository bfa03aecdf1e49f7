"""Port vs reference: the fused INT8 dequant-GEMM (B8).

The port's plain version (``repro_torch.kernels.ops.dequant_matmul`` on CPU
tensors) is held against the reference's Pallas kernel in interpret mode
and against its staged oracle ``repro.kernels.ref.dequant_matmul_ref``, on
the same numpy inputs, for per-row scale groups (NB = K / block) and the
broadcast layout (NB = 1, one scale per row).

Tolerance: fp32 rtol 1e-5, atol 1e-5 · max|out|.  Both sides round each
dequantized weight through bf16 identically and multiply exactly in fp32
(a bf16·bf16 product is exact), so they differ only in fp32 summation
order over K; at K <= 2048 that is a few ulps of the largest partial sum.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.kernels import ref as jref                        # noqa: E402
from repro.kernels.dequant_matmul import dequant_matmul_pallas  # noqa: E402

from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402


def _inputs(T, N, K, NB, seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((T, K)), jnp.bfloat16))
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    s = (rng.random((N, NB)) * 0.02 + 1e-4).astype(np.float32)
    return x, w, s


def _torch_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
        .view(torch.bfloat16)


def _close(out, want):
    want = np.asarray(want, np.float32)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=tol)


# (T, N, K, NB): decode-like T, per-row groups and broadcast, multi k-tile
CASES = [(4, 512, 1024, 4), (1, 256, 256, 1), (3, 128, 64, 1),
         (8, 384, 2048, 8), (5, 96, 512, 2)]


@pytest.mark.parametrize("T,N,K,NB", CASES)
def test_dequant_matmul_matches_pallas_and_staged(T, N, K, NB):
    x, w, s = _inputs(T, N, K, NB, seed=T * 7 + NB)
    out = ops.dequant_matmul(_torch_bf16(x), torch.from_numpy(w),
                             torch.from_numpy(s),
                             compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and tuple(out.shape) == (T, N)
    out = out.numpy()
    jx, jw, js = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    _close(out, dequant_matmul_pallas(jx, jw, js, interpret=True))
    _close(out, jref.dequant_matmul_ref(jx, jw, js))
    # the port's own staged oracle is the plain version
    np.testing.assert_array_equal(
        out, tref.dequant_matmul_ref(_torch_bf16(x), torch.from_numpy(w),
                                     torch.from_numpy(s)).numpy())


def test_dequant_matmul_f32_compute_matches_staged():
    """compute_dtype f32 (the f32 serving policy): no bf16 rounding of the
    dequantized weights."""
    T, N, K, NB = 2, 64, 256, 1
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    s = rng.random((N, NB)).astype(np.float32)
    out = ops.dequant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(s),
                             compute_dtype=torch.float32).numpy()
    _close(out, jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(s),
                                        compute_dtype=jnp.float32))


def test_dequant_matmul_rejects_bad_scale_groups():
    with pytest.raises(ValueError, match="K % NB"):
        ops.dequant_matmul(torch.zeros(1, 96), torch.zeros(4, 96,
                                                           dtype=torch.int8),
                           torch.ones(4, 5))
