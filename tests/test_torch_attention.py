"""Port vs reference: the serving path's attention, at small shapes.

``mha`` is held against the reference's ``repro.models.attention.mha`` on
the same numpy q/k/v, on both of its paths: the dense one and the chunked
online-softmax one (taken when S > kv_chunk and S % kv_chunk == 0; here
with a small kv_chunk so the chunk loop runs several times).  GQA (4 query
heads over 2 KV heads), causal.  ``decode_attend`` and ``cache_insert``
are held against the reference's at per-row cache positions.

Tolerance: f32 throughout, so the two differ only by fp32 summation order
in the logits, the softmax and the value product; the bar is 1e-5 abs +
1e-5 rel (outputs are of magnitude ~1).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.models import attention as jattn                  # noqa: E402

from repro_torch.models import attention as tattn            # noqa: E402

B, H, K, HD = 2, 4, 2, 16


def _qkv(rng, Sq, S):
    q = rng.standard_normal((B, Sq, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, K, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, K, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,kv_chunk", [(48, 64), (64, 16), (96, 32)])
def test_mha_matches_reference(S, kv_chunk):
    """(48, 64) takes the dense path; (64, 16) and (96, 32) the chunked
    online-softmax path (4 and 3 KV chunks)."""
    q, k, v = _qkv(np.random.default_rng(S), S, S)
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                kv_chunk=kv_chunk))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), kv_chunk=kv_chunk).numpy()
    assert got.shape == want.shape == (B, S, H, HD)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chunked_path_equals_dense_path():
    """The two paths of the port compute one function."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(7), 64, 64))
    np.testing.assert_allclose(tattn.mha(q, k, v, kv_chunk=16).numpy(),
                               tattn.mha(q, k, v, kv_chunk=1024).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_decode_attend_and_cache_insert_match_reference():
    """Rows at different cache positions (continuous batching); a row whose
    position lies past the cache is left unwritten by both."""
    rng = np.random.default_rng(3)
    S = 24
    q, kc, vc = _qkv(rng, 1, S)
    _, kn, vn = _qkv(rng, 1, 1)
    for pos in (np.array([5, 17], np.int32), np.array([0, S], np.int32)):
        jk, jv = jattn.cache_insert(jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(pos))
        tk, tv = tattn.cache_insert(torch.from_numpy(kc.copy()),
                                    torch.from_numpy(vc.copy()),
                                    torch.from_numpy(kn), torch.from_numpy(vn),
                                    torch.from_numpy(pos))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        vis = np.minimum(pos, S - 1)
        want = np.asarray(jattn.decode_attend(jnp.asarray(q), jk, jv,
                                              jnp.asarray(vis)))
        got = tattn.decode_attend(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(vis)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
