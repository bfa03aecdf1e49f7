"""The depth-k prefetch ring of the port's layer loops.

``ZeroConfig.prefetch = k`` runs the reference's ring (``core/schedule.py``
``zero_apply_scan``, ``core/zeropp.py`` ``zero_scan_inference``): layer
i+k's gather in flight under layer i's compute, the backward's re-gathers
mirrored, each reduce hop retired k layers behind.  It issues the same
collectives on the same values as ``prefetch=0``, so every depth must give
the same bits: the reference's ``check_prefetch_matches_sync`` and
``check_prefetch_depth_sweep`` (``checks.py:786``, ``:974``).

  (e) one ``loss_and_grads`` on 4 CPU gloo ranks (2 × 2), gpt-350m reduced
      at 4 layers, bf16 compute, for the full ZeRO++ and the ZeRO-3
      baseline variants (and full ZeRO++ with the sequence over ``model``,
      batch 2): the loss and every rank's gradients ``torch.equal`` to
      ``prefetch=0`` at depths 1, 2, 3 and 8 (beyond the 4 layers: it
      clamps), with the same calls of every kernel wrapper and every
      collective; and the serving prefill and decode logits of the same
      world, bit-identical across depths.  One spawn for all of it.
      The ring's order is held on a toy loop: each gather and each reduce
      hop is issued before a layer's compute and waited for after it;
  (f) ``effective_prefetch``'s clamp, against the reference's, and the
      error for a negative depth;
  (g) serving prefill and decode logits at world 1 bit-identical across
      depths.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import schedule
from repro_torch.core import zeropp
from repro_torch.core.partition import shard_of
from repro_torch.core.zeropp import ZeroConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunSpec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer
from repro_torch.train.policy import make_policy

DEPTHS = (0, 1, 2, 3, 8)
SEQ = 64
# name -> (variant, global batch)
CASES = {"zeropp": ("zeropp", 8), "baseline": ("baseline", 8),
         "zeropp_seq": ("zeropp", 2)}
KERNELS = ("quantize_blockwise", "dequantize_blockwise", "quantize_reordered",
           "dequant_reduce_quant", "dequant_reduce", "dequant_matmul")
COLLECTIVES = ("all_gather_into_tensor", "all_to_all_single",
               "reduce_scatter_tensor")
PROMPT, DECODE_STEPS = 16, 3


def _arch():
    return dataclasses.replace(get_config("gpt-350m").reduced(), n_layers=4)


class _Counts:
    """Counts the calls of every kernel wrapper (``kernels.ops``) and every
    collective the port issues, while open."""

    def __init__(self):
        self.n = {}
        self.real = [(tops, k, getattr(tops, k)) for k in KERNELS] + \
            [(dist, k, getattr(dist, k)) for k in COLLECTIVES]

    def __enter__(self):
        for mod, name, fn in self.real:
            setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def f(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return f

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def _serve(model, params):
    """Prefill logits of a (2, PROMPT) prompt, then DECODE_STEPS greedy
    decode steps' logits."""
    rs = RunSpec(mode="prefill")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, PROMPT))).long()
    logits, caches = model.prefill_fn(params, {"tokens": toks}, rs)
    k = caches["blocks"][0]["k"]
    full = model.init_caches(2, PROMPT + DECODE_STEPS, dtype=k.dtype)
    for key in ("k", "v"):
        full["blocks"][0][key][:, :, :PROMPT] = caches["blocks"][0][key]
    out = [logits]
    tok = logits[:, -1].argmax(-1)[:, None]
    for t in range(DECODE_STEPS):
        logits, full = model.decode_fn(params, full, {"tokens": tok},
                                       PROMPT + t, RunSpec(mode="decode"))
        out.append(logits)
        tok = logits[:, -1].argmax(-1)[:, None]
    return [o.numpy() for o in out]


def _world4_rank(rank, world):
    arch = _arch()
    mesh = mesh_lib.make_mesh((2, 2))
    lm = tsyn.SyntheticLM(arch.vocab, SEQ, seed=7)
    out = {}
    for name, (variant, rows) in CASES.items():
        batch = {k: torch.from_numpy(v).long()
                 for k, v in tsyn.make_batch(arch, lm, 0, rows).items()}
        for depth in DEPTHS:
            pol = make_policy(arch, mesh_lib.AXES, variant, mesh=mesh,
                              prefetch=depth)
            model = Model(arch, pol.zcfg, world=world, device="cpu")
            full = model.init_params(torch.Generator().manual_seed(0),
                                     dtype=torch.float32)
            params = {k: shard_of(v, rank, world).clone()
                      for k, v in full.items()}
            step = trainer.build_train_step(model, AdamWConfig(),
                                            device="cpu", global_batch=rows,
                                            mesh=mesh)
            with _Counts() as c:
                loss, _, grads = step.loss_and_grads(params, batch)
            res = {"loss": float(loss),
                   "grads": {k: v.numpy() for k, v in grads.items()},
                   "counts": c.n,
                   "seq_axes": step.run_spec.seq_axes}
            if name == "zeropp":
                serve = {k: v.to(torch.bfloat16) for k, v in params.items()}
                with _Counts() as c:
                    res["serve"] = _serve(model, serve)
                res["serve_counts"] = c.n
            out[(name, depth)] = res
    return out


@pytest.fixture(scope="module")
def world4():
    return mesh_lib.spawn(_world4_rank, 4, device="cpu")


@pytest.mark.parametrize("depth", DEPTHS[1:])
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_at_every_depth_equals_the_synchronous_step(world4, case, depth):
    for r in world4:
        sync, ring = r[(case, 0)], r[(case, depth)]
        assert ring["loss"] == sync["loss"], (case, depth)
        assert sync["grads"].keys() == ring["grads"].keys()
        for k, g in sync["grads"].items():
            np.testing.assert_array_equal(ring["grads"][k], g,
                                          err_msg=f"{case} {depth} {k}")
        assert ring["counts"] == sync["counts"], (case, depth)
        assert ring["seq_axes"] == sync["seq_axes"] == (
            ("model",) if case == "zeropp_seq" else ())
    # the qgZ path really ran, once per flat group
    counts = world4[0][("zeropp", depth)]["counts"]
    groups = 1 + 4 + 1 + _model(1).unemb_chunks
    assert all(counts[k] == groups for k in KERNELS[:5]), counts


def _model(world, prefetch=1):
    arch = _arch()
    return Model(arch, make_policy(arch, prefetch=prefetch).zcfg,
                 world=world, device="cpu")


@pytest.mark.parametrize("depth", DEPTHS[1:])
def test_serving_at_every_depth_equals_the_synchronous_scan_on_4_ranks(
        world4, depth):
    for r in world4:
        sync, ring = r[("zeropp", 0)], r[("zeropp", depth)]
        assert len(ring["serve"]) == 1 + DECODE_STEPS
        for a, b in zip(sync["serve"], ring["serve"]):
            np.testing.assert_array_equal(a, b)
        assert ring["serve_counts"] == sync["serve_counts"]


@pytest.mark.parametrize("depth", DEPTHS[1:])
def test_serving_at_every_depth_equals_the_synchronous_scan_at_world1(depth):
    """(g): at world 1 the gathers are identities, but qwZ's quantize and
    dequantize still run in the ring's order."""
    sync_m, ring_m = _model(1, 0), _model(1, depth)
    params = sync_m.init_params(torch.Generator().manual_seed(1))
    with _Counts() as cs:
        sync = _serve(sync_m, params)
    with _Counts() as cr:
        ring = _serve(ring_m, params)
    for a, b in zip(sync, ring):
        np.testing.assert_array_equal(a, b)
    assert cs.n == cr.n and cs.n["dequant_matmul"] > 0


@pytest.mark.parametrize("prefetch", DEPTHS)
def test_effective_prefetch_matches_reference(prefetch):
    """(f): min(prefetch, n-1), and 0 in local mode or for one step."""
    from repro.core.zeropp import ZeroConfig as JaxZeroConfig
    for local in (False, True):
        kw = dict(dp_axes=(), intra_axis="") if local else {}
        z = ZeroConfig(prefetch=prefetch, **kw)
        jz = JaxZeroConfig(prefetch=prefetch, **kw)
        for n in (1, 2, 3, 4, 9):
            assert z.effective_prefetch(n) == jz.effective_prefetch(n), \
                (prefetch, local, n)
            want = 0 if local or n < 2 else min(prefetch, n - 1)
            assert z.effective_prefetch(n) == want
    assert ZeroConfig().prefetch == JaxZeroConfig().prefetch == 1


def test_negative_prefetch_raises():
    with pytest.raises(ValueError, match="prefetch"):
        ZeroConfig(prefetch=-1)
    with pytest.raises(ValueError, match="prefetch"):
        make_policy(_arch(), prefetch=-2)


def test_prefetch_reaches_the_policy_and_the_launcher():
    from repro_torch.launch import train as tlaunch
    assert make_policy(_arch()).zcfg.prefetch == 1
    assert make_policy(_arch(), prefetch=3).zcfg.prefetch == 3
    assert tlaunch.parser().parse_args([]).prefetch is None
    b = tlaunch.build_everything("gpt-350m", reduced=True, batch=2, seq=SEQ,
                                 device="cpu", prefetch=2)
    assert b.model.zcfg.prefetch == 2
    b = tlaunch.build_everything("gpt-350m", reduced=True, batch=2, seq=SEQ,
                                 device="cpu")
    assert b.model.zcfg.prefetch == 1


# ----------------------------------------------------- the ring's order

N_TOY = 5


def _toy_run(k, monkeypatch):
    """A toy layer loop (h -> h·(1 + mean(W)/10)) through zero_apply_scan
    at depth ``k``, its gathers, re-gathers and reduces replaced by fakes
    that log when they are issued and waited for (two hops a reduce, as
    qgZ's), and each compute logged.  Returns (log, loss, grads)."""
    log = []

    def gather(p, z):
        i = int(p[0])
        log.append(("issue", "gather", i))
        yield
        log.append(("wait", "gather", i))
        return p.clone()

    order = iter(range(N_TOY - 1, -1, -1))

    def reduce(dW, z):
        i = next(order)
        log.append(("issue", "reduce", i))
        yield
        log.append(("wait", "reduce", i))
        log.append(("issue", "reduce2", i))
        yield
        log.append(("wait", "reduce2", i))
        return dW.to(torch.float32) * 2

    monkeypatch.setattr(schedule, "fwd_gather_hops", gather)
    monkeypatch.setattr(schedule, "bwd_gather_hops", gather)
    monkeypatch.setattr(schedule, "grad_reduce_hops", reduce)
    monkeypatch.setattr(zeropp, "fwd_gather_hops", gather)
    monkeypatch.setattr(zeropp, "bwd_gather_hops", gather)
    monkeypatch.setattr(zeropp, "grad_reduce_hops", reduce)

    def f(W, h):
        i = int(W[0])
        log.append(("compute" if torch.is_grad_enabled() else "forward",
                    "layer", i))
        return h * (1 + W.mean() / 10)

    z = ZeroConfig(prefetch=k, hpz=False)
    shards = [torch.full((4,), float(i)).requires_grad_(True)
              for i in range(N_TOY)]
    h0 = torch.ones(3, requires_grad=True)
    out = schedule.zero_apply_scan(f, z)(shards, h0)
    out.sum().backward()
    grads = [s.grad.clone() for s in shards] + [h0.grad.clone()]
    return log, float(out.sum().detach()), grads


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ring_issues_before_the_compute_it_hides_under(k, monkeypatch):
    """Each gather of layer j > k-1 is issued before layer j-k's compute
    and waited for after layer j-1's; in the backward each re-gather is
    issued k layers ahead and each reduce hop is waited for only after a
    later layer's compute was enqueued, k layers on.  The values are the
    synchronous loop's."""
    log, loss, grads = _toy_run(k, monkeypatch)
    sync_log, sync_loss, sync_grads = _toy_run(0, monkeypatch)
    assert loss == sync_loss
    assert all(torch.equal(a, b) for a, b in zip(grads, sync_grads))
    assert sorted(log) == sorted(sync_log)

    def at(*ev):
        return log.index(ev)
    fwd_end = at("forward", "layer", N_TOY - 1)
    for j in range(k, N_TOY):
        assert at("issue", "gather", j) < at("forward", "layer", j - k)
        assert at("wait", "gather", j) > at("forward", "layer", j - 1)
    bwd = log[fwd_end + 1:]

    def bt(*ev):
        return bwd.index(ev)
    for j in range(N_TOY - 1 - k, -1, -1):
        assert bt("issue", "gather", j) < bt("compute", "layer", j + k)
        assert bt("wait", "gather", j) > bt("compute", "layer", j + 1)
    computes = [i for i, ev in enumerate(bwd) if ev[0] == "compute"]
    for j in range(N_TOY):
        assert bt("issue", "reduce", j) > bt("compute", "layer", j)
        for hop, behind in (("reduce", k), ("reduce2", 2 * k)):
            issued, waited = bt("issue", hop, j), bt("wait", hop, j)
            # a compute lies between issue and wait wherever one follows
            if issued < computes[-1]:
                assert any(issued < c < waited for c in computes), (hop, j)
            if j - behind >= 0:
                assert waited > bt("compute", "layer", j - behind), (hop, j)
