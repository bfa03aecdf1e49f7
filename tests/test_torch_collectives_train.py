"""Port vs reference: the training collectives (hpZ, qgZ) on gloo ranks.

Four CPU gloo ranks laid out as the reference's 2 × 2 ``("data",
"model")`` mesh (rank = data·2 + model; intra group = the two ranks of a
``data`` row, inter group = the two ranks of a ``model`` column), plus
world 1:

  * ``qgz_reduce_scatter`` (INT4 and INT8, f32 and bf16 gradients, the
    2-hop and the single-tier branch) is BIT-IDENTICAL to the reference's
    on the same per-rank gradients; the reference runs in a subprocess
    with 4 simulated devices, as ``repro.testing.subproc`` runs its checks;
  * ``check_qgz_exact_when_representable`` (``checks.py:86``): gradients
    whose every block is an integer multiple of one INT4 pattern make
    quantization the identity up to the scale's rounding (``absmax ·
    fl(1/7)`` is not exactly ``absmax / 7``), so qgZ equals a plain
    reduce-scatter within the reference's own atol 1e-3 — any
    slice-reordering bug scrambles the pattern by whole units;
  * ``check_hpz_roundtrip`` (``checks.py:172``): gather -> secondary
    slice -> intra-only gather returns the weights exactly;
  * the packed-scales message has the reference's byte layout.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
from jax.sharding import PartitionSpec as P                  # noqa: E402

from repro.core import collectives as jcl                    # noqa: E402
from repro.core import quant as jq                           # noqa: E402
from repro.core.compat import make_mesh, shard_map           # noqa: E402

from repro_torch.core import collectives as cl               # noqa: E402
from repro_torch.core.quant import QuantConfig               # noqa: E402
from repro_torch.testing import multirank                    # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# (bits, block, dtype, L): L = each rank's output length
CASES = [(4, 256, "float32", 512), (4, 256, "bfloat16", 512),
         (8, 64, "float32", 128)]


def _local_grads(case_i, bits, block, dtype, L):
    """(WORLD, WORLD·L) per-rank local gradients as float32 holding values
    of ``dtype``."""
    rng = np.random.default_rng(100 + case_i)
    g = (rng.standard_normal((WORLD, WORLD * L))
         * rng.uniform(0.1, 3.0, (WORLD, 1))).astype(np.float32)
    g[:, :block] *= 1e-4                       # a block of tiny values
    return np.asarray(jnp.asarray(g, dtype).astype(jnp.float32))


_REF_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import collectives as cl
from repro.core.compat import make_mesh, shard_map
from repro.core.quant import QuantConfig
d = dict(np.load(sys.argv[1]))
out = {}
spec = P(("data", "model"))
for key in [k for k in d if k.startswith("g")]:
    bits, block, dtype = d["meta" + key[1:]].tolist()
    cfg = QuantConfig(bits=int(bits), block_size=int(block))
    x = jnp.asarray(d[key]).astype(jnp.bfloat16 if dtype else jnp.float32)
    mesh = make_mesh((2, 2), ("data", "model"))
    f = jax.jit(shard_map(
        lambda g: cl.qgz_reduce_scatter(g, "model", ("data",), cfg),
        mesh=mesh, in_specs=spec, out_specs=spec))
    out["two" + key[1:]] = np.asarray(f(x.reshape(-1)))
    mesh1 = make_mesh((4,), ("model",))
    f1 = jax.jit(shard_map(
        lambda g: cl.qgz_reduce_scatter(g, "model", (), cfg),
        mesh=mesh1, in_specs=P("model"), out_specs=P("model")))
    out["one" + key[1:]] = np.asarray(f1(x.reshape(-1)))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_qgz(tmp_path_factory):
    """The reference's qgZ outputs for every case, 2-hop and single-tier,
    from a subprocess with 4 simulated devices."""
    d = tmp_path_factory.mktemp("qgz")
    arrays = {}
    for i, (bits, block, dtype, L) in enumerate(CASES):
        arrays[f"g{i}"] = _local_grads(i, bits, block, dtype, L)
        arrays[f"meta{i}"] = np.array([bits, block, int(dtype == "bfloat16")])
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_SNIPPET,
                        str(d / "in.npz"), str(d / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "out.npz"))


def _cases():
    return [((bits, block, dtype, L), _local_grads(i, bits, block, dtype, L))
            for i, (bits, block, dtype, L) in enumerate(CASES)]


def _exact_grads():
    """Rank d's local gradient is (d+1)·pattern, pattern integers in
    [-7, 7] with each 32-block's absmax pinned to 7."""
    n = WORLD * 32
    rng = np.random.default_rng(1)
    pattern = rng.integers(-7, 8, size=(n,)).astype(np.float32)
    pattern.reshape(-1, 32)[:, 0] = 7.0
    return np.arange(1, WORLD + 1, dtype=np.float32)[:, None] \
        * pattern[None, :]


def _weights():
    return np.random.default_rng(4).standard_normal(WORLD * 64).astype(
        np.float32)


def _rank(rank, world):
    """Everything the 4-rank tests read, computed in one gloo world."""
    intra, inter = cl.tier_groups(2)
    out = {"qgz": []}
    for (bits, block, dtype, L), g in _cases():
        cfg = QuantConfig(bits=bits, block_size=block)
        x = torch.from_numpy(g[rank]).to(getattr(torch, dtype))
        two = cl.qgz_reduce_scatter(x, intra, inter, cfg)
        one = cl.qgz_reduce_scatter(x, None, None, cfg, two_tier=False)
        out["qgz"].append((two.numpy(), one.numpy()))
    x = torch.from_numpy(_exact_grads()[rank])
    out["exact"] = (cl.qgz_reduce_scatter(x, intra, inter,
                                          QuantConfig(4, 32)).numpy(),
                    cl.baseline_reduce_scatter(x).numpy())
    w = _weights()
    per = w.shape[0] // world
    out["hpz"] = []
    for dt in (torch.float32, torch.bfloat16):
        full = torch.from_numpy(w).to(dt)
        gathered = cl.baseline_all_gather(full[rank * per:(rank + 1) * per])
        sec = cl.slice_secondary(gathered, intra)
        back = cl.hpz_all_gather(sec, intra)
        out["hpz"].append((sec.shape[0], bool(torch.equal(gathered, full)),
                           bool(torch.equal(back, full))))
    return out


@pytest.fixture(scope="module")
def four_ranks():
    return multirank.run(_rank, WORLD)


def test_qgz_bit_identical_to_reference_on_four_ranks(reference_qgz,
                                                      four_ranks):
    for i, (bits, block, dtype, L) in enumerate(CASES):
        two = np.stack([four_ranks[r]["qgz"][i][0] for r in range(WORLD)])
        one = np.stack([four_ranks[r]["qgz"][i][1] for r in range(WORLD)])
        assert two.shape == (WORLD, L)
        want_two = reference_qgz[f"two{i}"].reshape(WORLD, L)
        want_one = reference_qgz[f"one{i}"].reshape(WORLD, L)
        np.testing.assert_array_equal(two.view(np.int32),
                                      want_two.view(np.int32),
                                      err_msg=f"2-hop case {CASES[i]}")
        np.testing.assert_array_equal(one.view(np.int32),
                                      want_one.view(np.int32),
                                      err_msg=f"single-tier case {CASES[i]}")


def test_qgz_exact_when_representable_on_four_ranks(four_ranks):
    """checks.check_qgz_exact_when_representable in the port (INT4, block
    32, L = 32 per rank)."""
    for r in range(WORLD):
        got, want = four_ranks[r]["exact"]
        assert got.shape == (32,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_hpz_roundtrip_on_four_ranks(four_ranks):
    """checks.check_hpz_roundtrip in the port, f32 and bf16 (which crosses
    as its raw bytes, 2 per element): the secondary shard is half the
    buffer (intra group of 2) and the intra-only gather rebuilds it."""
    n = WORLD * 64
    assert [four_ranks[r]["hpz"] for r in range(WORLD)] == \
        [[(n // 2, True, True)] * 2] * WORLD


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_qgz_world_one_bit_identical_to_reference(dtype):
    """World 1 (no process group): both hops are identities, but the
    quantize / reduce / requantize still run, as on the reference's
    one-device ("data", "model") mesh."""
    cfg = jq.QuantConfig(bits=4, block_size=256)
    g = np.asarray(jnp.asarray(
        np.random.default_rng(7).standard_normal(2048).astype(np.float32),
        dtype))
    mesh = make_mesh((1, 1), ("data", "model"))
    f = jax.jit(shard_map(
        lambda x: jcl.qgz_reduce_scatter(x, "model", ("data",), cfg),
        mesh=mesh, in_specs=P(("data", "model")),
        out_specs=P(("data", "model"))))
    want = np.asarray(f(jnp.asarray(g)))
    x = torch.from_numpy(np.array(g, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = cl.qgz_reduce_scatter(x, None, None, QuantConfig(4, 256))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # the quantization really ran: the result is not the input
    assert not np.array_equal(got.numpy(), np.asarray(g, np.float32))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_packed_scales_have_the_reference_byte_layout(lead):
    rng = np.random.default_rng(len(lead))
    payload = rng.integers(-128, 128, lead + (64,)).astype(np.int8)
    scales = (rng.standard_normal(lead + (4,)) * 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(jcl._pack_scales)(jnp.asarray(payload),
                                                jnp.asarray(scales)))
    got = cl._pack_scales(torch.from_numpy(payload), torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), want)
    p, s = cl._unpack_scales(got, 64)
    assert np.array_equal(p.numpy(), payload)
    assert np.array_equal(s.numpy().view(np.int32), scales.view(np.int32))


def test_qgz_rejects_unaligned_gradients():
    with pytest.raises(ValueError, match="multiple of world"):
        cl.qgz_reduce_scatter(torch.zeros(300), None, None,
                              QuantConfig(4, 256))
