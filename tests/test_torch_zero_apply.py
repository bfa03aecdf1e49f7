"""The port's ZeRO++ engine primitive ``zero_apply`` on a toy layer.

The reference's engine checks (``checks.py:237-323``) in the port, at
world 1 (no process group: gathers and all-to-alls are identities, every
quantization still runs) and on 4 gloo ranks laid out 2 × 2 (intra groups
of 2): one residual tanh MLP layer ``x + tanh(x @ w1) @ w2`` with its
flat weights sharded, loss ``sum(h**2) / n_global`` summed over ranks,
against the plain autograd gradient of the full-batch loss:

  * ZeRO-3 baseline (fp32 end to end, fp32 reduce): loss rtol 1e-5,
    grads rtol 2e-4 / atol 2e-5 (``check_engine_baseline_matches_local``);
    at world 1 it equals local mode exactly;
  * full ZeRO++ (qwZ INT8 + hpZ + qgZ INT4, blocks of 64): loss within
    5 %, gradient relative L2 error < 0.2 and cosine > 0.98
    (``check_engine_zeropp_close_to_local``);
  * hpZ on vs off (qwZ and qgZ off): identical loss, grads within 1e-6
    (``check_engine_hpz_consistency``).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import collectives as cl
from repro_torch.core.partition import ParamSpec
from repro_torch.core.zeropp import ZeroConfig, fwd_gather, zero_apply
from repro_torch.testing import multirank

WORLD = 4
F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)


def _spec(align):
    return ParamSpec((("w1", (16, 32)), ("w2", (32, 16))), align=align)


def _layer(spec):
    def f(wflat, x):
        w = spec.unpack(wflat.to(torch.float32))
        return x + torch.tanh(x @ w["w1"]) @ w["w2"]
    return f


def _inputs(world, align, seed):
    spec = _spec(align)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(spec.padded_size) * 0.3).astype(np.float32)
    x = rng.standard_normal((world, 4, 16)).astype(np.float32)
    return spec, w, x


def _oracle(spec, w, x):
    """Plain autograd of the full-batch loss over every rank's rows."""
    wt = torch.from_numpy(w).requires_grad_(True)
    xs = torch.from_numpy(x.reshape(-1, 16))
    loss = torch.sum(_layer(spec)(wt, xs) ** 2) / (x.shape[0] * 4)
    loss.backward()
    return float(loss.detach()), wt.grad.numpy()


def _engine(z, spec, shard, xr, n_global):
    """This rank's (local loss, gradient shard) through zero_apply."""
    p = torch.from_numpy(shard).requires_grad_(True)
    h = zero_apply(_layer(spec), z)(p, torch.from_numpy(xr))
    loss = torch.sum(h ** 2) / n_global
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def _configs(intra=None, inter=None):
    g = dict(intra_group=intra, inter_group=inter)
    # name -> (config, alignment per rank, input seed)
    return {
        "local": (ZeroConfig.local(**F32), 2, 0),
        "baseline": (ZeroConfig.baseline(reduce_dtype=torch.float32, **g,
                                         **F32), 2, 0),
        "zeropp": (ZeroConfig(qwz_block=64, qgz_block=64, **g, **F32), 64, 1),
        "hpz_on": (ZeroConfig(qwz=False, qgz=False, hpz=True,
                              reduce_dtype=torch.float32, **g, **F32), 2, 2),
        "hpz_off": (ZeroConfig(qwz=False, qgz=False, hpz=False,
                               reduce_dtype=torch.float32, **g, **F32), 2, 2),
    }


def _run_all(rank, world, intra=None, inter=None):
    out = {}
    for name, (z, a, seed) in _configs(intra, inter).items():
        if name == "local" and world > 1:
            continue
        spec, w, x = _inputs(world, world * a, seed)
        per = w.shape[0] // world
        out[name] = _engine(z, spec, w[rank * per:(rank + 1) * per], x[rank],
                            world * 4)
    return out


def _check(results, world):
    """results[name] = (total loss, full gradient) assembled over ranks."""
    for name, (loss, grad) in results.items():
        _, a, seed = _configs()[name]
        spec, w, x = _inputs(world, world * a, seed)
        l_o, g_o = _oracle(spec, w, x)
        if name in ("baseline", "hpz_on", "hpz_off", "local"):
            np.testing.assert_allclose(loss, l_o, rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(grad, g_o, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        else:   # zeropp: quantized weights and gradients
            assert abs(loss - l_o) / abs(l_o) < 0.05, (loss, l_o)
            rel = np.linalg.norm(grad - g_o) / (np.linalg.norm(g_o) + 1e-9)
            assert rel < 0.2, f"zero++ grad rel err {rel}"
            cos = (grad * g_o).sum() / (np.linalg.norm(grad)
                                        * np.linalg.norm(g_o) + 1e-9)
            assert cos > 0.98, f"cosine {cos}"
            # the quantization really ran
            assert not np.allclose(grad, g_o, rtol=1e-4, atol=1e-5)
    # hpZ's secondary re-gather rebuilds exactly the forward weights
    on, off = results["hpz_on"], results["hpz_off"]
    assert on[0] == off[0]
    np.testing.assert_allclose(on[1], off[1], rtol=0, atol=1e-6)


def test_zero_apply_world_one():
    res = _run_all(0, 1)
    _check(res, 1)
    # at world 1 the baseline's gather and reduce are identities: the
    # engine computes exactly what local mode computes
    assert res["baseline"][0] == res["local"][0]
    np.testing.assert_array_equal(res["baseline"][1], res["local"][1])


def _rank(rank, world):
    intra, inter = cl.tier_groups(2)
    out = _run_all(rank, world, intra, inter)
    totals = {}
    for name, (loss, g) in out.items():
        t = torch.tensor(loss, dtype=torch.float64)
        dist.all_reduce(t)
        totals[name] = (float(t), g)
    return totals


@pytest.fixture(scope="module")
def four_ranks():
    return multirank.run(_rank, WORLD)


def test_zero_apply_four_gloo_ranks(four_ranks):
    results = {name: (four_ranks[0][name][0],
                      np.concatenate([r[name][1] for r in four_ranks]))
               for name in four_ranks[0]}
    for r in four_ranks:
        assert {k: v[0] for k, v in r.items()} == \
            {k: v[0] for k, v in results.items()}
    _check(results, WORLD)


def test_zero_apply_grads_float_args_and_skips_the_others():
    """Float tensor args that need a gradient get the recomputed one;
    integer tensors and Python scalars pass through."""
    z = ZeroConfig(**F32)                      # full ZeRO++ at world 1
    w = torch.randn(512, requires_grad=True)
    x = torch.randn(4, requires_grad=True)
    idx = torch.tensor([0, 3, 3])

    def f(W, x, idx, c):
        return (W.reshape(128, 4)[idx] * x).sum() * c

    zero_apply(f, z)(w, x, idx, 2.0).backward()
    xx = x.detach().requires_grad_(True)
    f(fwd_gather(w.detach(), z), xx, idx, 2.0).backward()
    assert torch.equal(x.grad, xx.grad)
    assert w.grad.shape == (512,) and w.grad.dtype == torch.float32
    rows = w.grad.reshape(128, 4).abs().amax(dim=1)
    assert rows[0] > 0 and rows[3] > 0 and rows.count_nonzero() == 2
