"""Port vs reference: sharded serving on CPU gloo ranks (one process a
rank) against the reference on 8 simulated devices.

Weights: the port's seeded init of a reduced qwen3-0.6b (and gemma3-4b),
drawn here at the world's flat layout and carried to both sides as numpy
(the reference loads them with ``param_specs``, the port's ranks keep
``shard_of`` them); the INT8 checkpoint of (b)-(d) is the reference's,
saved at (2, 4).

  (a) ``check_serve_prefill_decode_consistency`` (``checks.py:607``),
      fp32: qwen3 at (2, 2) (rows over ``data``, the prompt and cache
      sequence over ``model``), gemma3 at (1, 2) (its ``local`` rings
      built under the sharded prefill), and the counterparts of
      ``check_serve_consistency_ssm`` and ``_hybrid`` (``:672, 676``):
      mamba2 at (2, 2) and recurrentgemma at (1, 2) (their states and conv
      histories handed on from the prefill's last sequence shard, whole
      on every kv rank).  The port's prefill(P) + decode
      steps against its prefill(P + n): rel 2e-2 and the same argmax;
      every rank's logits against the reference's at the same mesh within
      rtol = atol = 1e-5.
  (b) ``check_serve_engine_continuous_batching`` (``:1100``) at (2, 4):
      the INT8 boot with ``batch_axes=("data",)``, ``kv_axes=("model",)``,
      six jobs over 4 slots; the bf16 engine's tokens equal each request
      alone through the port's raw sharded steps; in fp32 compute the
      engine's tokens equal the reference engine's, booted from the same
      checkpoint.
  (c) ``check_serve_engine_speculative`` (``:1232``) at (2, 4), fp32: the
      independent drafter's streams equal plain paged greedy, self-drafting
      accepts > 1, all equal the reference's streams, the mean accepted
      equal to the reference's.
  (d) the paged engine at (1, 4) and (2, 4), fp32 compute, booted from the
      INT8 checkpoint: the rule of ``check_serve_engine_paged`` (``:1163``)
      — equal to the slab engine on the same mesh and requests, a prefix
      hit reusing >= 16 tokens, the pool drained.  (Its bf16 form fails
      in the reference itself at 4 devices: one token of 25.)
  (e) lockstep: ranks whose clocks differ (offset by rank) and a deadline
      that expires mid-run retire the same requests at the same tick;
      sampled requests give the same tokens on every rank and at world 1.
  (f) ``ZeroConfig(prefetch=2)`` serving at (2, 2) (4 layers, so the ring
      is 2 deep): tokens and logits bit-identical to depth 0, slab and
      paged.
  (g) ``serve_shape_policy``: the reference's answers and errors
      (``tests/test_serve_engine.py:316``).
  (h) refusals: an ``n_slots``, ``kv_len`` or ``page_size`` the world does
      not divide; a paged pool with ``batch_axes``.

One spawn each of 8 ranks ((2, 4)), 4 ranks ((2, 2) and (1, 4)) and 2
ranks ((1, 2)); the reference's subprocess runs beside them.  The
reference is imported inside the tests only: every spawned rank imports
this module.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
import time                                                  # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy            # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import ServeEngine, steps             # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 400.0
KV = 32
# (a): the check's two rows, 14 prompt tokens and 2 decoded
A_ROWS, A_P, A_EXTRA = 2, 14, 2
# (b): the check's six jobs over 4 slots
JOBS_B = [(5, 6), (11, 4), (8, 5), (16, 3), (3, 7), (9, 4)]
# (c): its four
JOBS_C = [(5, 6), (11, 4), (8, 5), (3, 7)]
# (a)'s worlds and archs
A_CASES = {"qwen3-0.6b": (2, 2), "gemma3-4b": (1, 2),
           "mamba2-130m": (2, 2), "recurrentgemma-2b": (1, 2)}
F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)

_REF_SNIPPET = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.models.model import Model
from repro.serve import ServeEngine
from repro.train import serve as serve_lib
from repro.train.policy import make_policy
from repro.train.state import ZeroState, param_specs
R, P = sys.argv[1], sys.argv[2]
JOBS_B, JOBS_C = json.loads(sys.argv[3]), json.loads(sys.argv[4])
A_CASES = json.loads(sys.argv[5])
F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
def model_of(name, mesh, **kw):
    arch = get_config(name).reduced()
    pol = make_policy(arch, tuple(mesh.axis_names), **kw)
    return arch, Model(arch, pol.zcfg, world=mesh.size)
def load(name, model, mesh):
    specs = param_specs(model, tuple(mesh.axis_names))
    with np.load(os.path.join(P, name + ".npz")) as z:
        return {k: jax.device_put(jnp.asarray(z[k]),
                                  NamedSharding(mesh, specs[k]))
                for k in z.files}
def put(mesh, d, specs):
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in d.items()}
out = {}
# (b)-(d): the INT8 checkpoint at (2, 4), published first
mesh8 = mesh_of((2, 4))
arch, m8 = model_of("qwen3-0.6b", mesh8)
st = ZeroState(m8, mesh8, opt_cfg=None, params=load("q8w", m8, mesh8),
               meta={"arch": arch.name})
st.save(os.path.join(R, "ck"), 0, fmt="int8")
# (a) prefill(P) + decode vs prefill(P + n)
for name, shape in A_CASES.items():
    mesh = mesh_of(tuple(shape))
    arch, model = model_of(name, mesh, **F32)
    params = load("a_" + name, model, mesh)
    B, Pn, extra = 2, 14, 2
    cap = Pn + extra
    toks = np.random.default_rng(3).integers(0, arch.vocab, (B, cap))
    toks = toks.astype(np.int32)
    ps = serve_lib.build_prefill_step(model, mesh, ("data",), ("model",))
    ds = serve_lib.build_decode_step(model, mesh, ("data",), ("model",),
                                     donate=False)
    ref, _ = ps.fn(params, put(mesh, {"tokens": toks}, ps.in_specs[1]))
    logits, caches = ps.fn(params, put(mesh, {"tokens": toks[:, :Pn]},
                                       ps.in_specs[1]))
    caches = serve_lib.pad_prefill_caches(model, caches, cap)
    c_specs = serve_lib.cache_specs(model, ("data",), ("model",))
    caches = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), caches,
        c_specs)
    for t in range(Pn, cap):
        got, caches = ds.fn(params, caches,
                            put(mesh, {"tokens": toks[:, t:t + 1]},
                                ds.in_specs[2]),
                            jnp.full((B,), t, jnp.int32))
    out["a_ref_" + name] = np.asarray(ref)
    out["a_got_" + name] = np.asarray(got)
# (b) the fp32-compute engine booted from the checkpoint
arch, f8 = model_of("qwen3-0.6b", mesh8, **F32)
rng = np.random.default_rng(7)
prompts = [rng.integers(0, arch.vocab, p).astype(np.int32) for p, _ in JOBS_B]
eng = ServeEngine.from_checkpoint(f8, mesh8, os.path.join(R, "ck"),
                                  dtype=jnp.float32, n_slots=4, kv_len=32,
                                  batch_axes=("data",), kv_axes=("model",))
uids = [eng.submit(p, max_new_tokens=n) for p, (_, n) in zip(prompts, JOBS_B)]
res = eng.run(max_steps=200)
out["b_f32"] = np.array([t for u in uids for t in res[u]])
# (c) speculative decoding
params, drafter = load("q8w", f8, mesh8), load("c_draft", f8, mesh8)
rng = np.random.default_rng(11)
prompts = [rng.integers(0, arch.vocab, p).astype(np.int32) for p, _ in JOBS_C]
for tag, kw in (("plain", {}),
                ("bad", dict(draft=(f8, drafter), spec_tokens=4)),
                ("self", dict(draft=(f8, params), spec_tokens=4))):
    eng = ServeEngine(f8, mesh8, params, n_slots=4, kv_len=32,
                      kv_axes=("model",), pool="paged", page_size=8,
                      chunk_size=8, cache_dtype=jnp.float32, **kw)
    uids = [eng.submit(p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, JOBS_C)]
    res = eng.run(max_steps=300)
    out["c_" + tag] = np.array([t for u in uids for t in res[u]])
    if kw:
        out["c_mean_" + tag] = np.array(eng.stats()["spec_accepted"]["mean"])
np.savez(os.path.join(R, "ref.npz"), **out)
"""


def _arch(name, **over):
    return get_config(name).reduced(**over)


def _build(name, shape, **kw):
    """(arch, mesh, model) for this rank of a ``shape`` world."""
    arch = _arch(name)
    mesh = mesh_lib.make_mesh(shape)
    pol = make_policy(arch, mesh.axes, mesh=mesh, **kw)
    return arch, mesh, Model(arch, pol.zcfg, world=mesh.world, device="cpu")


def _load(P, name, model, rank, world, dtype=torch.float32):
    with np.load(os.path.join(P, name + ".npz")) as z:
        g = {k: z[k] for k in z.files}
    return {k: v.to(dtype) for k, v in params_from_numpy(
        g, model, rank=rank, world=world).items()}


def _wait(path):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(os.path.join(path, ts.MANIFEST)):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)
    return path


def _prompts(vocab, jobs, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in jobs]


def _serve(eng, prompts, jobs, **kw):
    uids = [eng.submit(p, max_new_tokens=n, **kw)
            for p, (_, n) in zip(prompts, jobs)]
    res = eng.run(max_steps=300)
    return [res[u] for u in uids]


def _paged_jobs(vocab):
    """``check_serve_engine_paged``'s six requests: prompts of 1-3 chunks,
    three sharing a full-page 16-token prefix."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 16).astype(np.int32)

    def r(n):
        return rng.integers(0, vocab, n).astype(np.int32)
    return [(r(5), 6), (np.concatenate([shared, r(3)]), 4), (r(11), 4),
            (np.concatenate([shared, r(6)]), 3), (r(21), 3),
            (np.concatenate([shared, r(1)]), 5)]


def _paged_vs_slab(model, mesh, ck):
    """(d): the paged and slab engines booted fp32 from ``ck`` on the same
    mesh and requests."""
    kw = dict(dtype=torch.float32, mesh=mesh, n_slots=4, kv_len=KV,
              kv_axes=("model",), device="cpu")
    jobs = _paged_jobs(model.cfg.vocab)
    prompts, jb = [p for p, _ in jobs], [(len(p), n) for p, n in jobs]
    slab = _serve(ServeEngine.from_checkpoint(model, ck, **kw), prompts, jb)
    paged = ServeEngine.from_checkpoint(model, ck, pool="paged", page_size=8,
                                        chunk_size=8, **kw)
    got = _serve(paged, prompts, jb)
    return {"slab": slab, "paged": got, "util": paged.pool.utilization(),
            "n_free": paged.pool.n_free,
            "refs": int(np.abs(paged.pool.refcount).sum())}


def _alone(model, mesh, params, prompt, n):
    """A request alone through the raw sharded steps: batch 1 whole, the
    cache sequence over ``model``."""
    ps = steps.build_prefill_step(model, device="cpu", mesh=mesh)
    ds = steps.build_decode_step(model, device="cpu", mesh=mesh,
                                 kv_axes=("model",))
    logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
        prompt[None]).long()})
    caches = steps.pad_prefill_caches(model, caches, KV, mesh, (),
                                      ("model",))
    want = [int(logits[0, -1].argmax())]
    for i in range(1, n):
        logits, caches = ds.fn(params, caches,
                               {"tokens": torch.tensor([[want[-1]]])},
                               torch.tensor([len(prompt) + i - 1]))
        want.append(int(logits[0, -1].argmax()))
    return want


def _rank8(rank, world, P, R):
    """(2, 4): (b), (c), (d)."""
    out = {}
    ck = _wait(os.path.join(R, "ck", "ckpt_0"))
    arch, mesh, model = _build("qwen3-0.6b", (2, 4))
    eng = ServeEngine.from_checkpoint(model, ck, mesh=mesh, n_slots=4,
                                      kv_len=KV, batch_axes=("data",),
                                      kv_axes=("model",), device="cpu")
    prompts = _prompts(arch.vocab, JOBS_B, 7)
    out["b_bf16"] = _serve(eng, prompts, JOBS_B)
    out["b_slots"] = dict(eng.slot_history)
    out["b_alone"] = [_alone(model, mesh, eng.params, p, n)
                      for p, (_, n) in zip(prompts, JOBS_B)]
    _, _, f32 = _build("qwen3-0.6b", (2, 4), **F32)
    eng = ServeEngine.from_checkpoint(f32, ck, mesh=mesh, dtype=torch.float32,
                                      n_slots=4, kv_len=KV,
                                      batch_axes=("data",),
                                      kv_axes=("model",), device="cpu")
    out["b_f32"] = _serve(eng, prompts, JOBS_B)
    params = _load(P, "q8w", f32, rank, world)
    drafter = _load(P, "c_draft", f32, rank, world)
    prompts = _prompts(arch.vocab, JOBS_C, 11)
    for tag, kw in (("plain", {}),
                    ("bad", dict(draft=(f32, drafter), spec_tokens=4)),
                    ("self", dict(draft=(f32, params), spec_tokens=4))):
        eng = ServeEngine(f32, params, mesh=mesh, n_slots=4, kv_len=KV,
                          kv_axes=("model",), pool="paged", page_size=8,
                          chunk_size=8, cache_dtype=torch.float32,
                          device="cpu", **kw)
        out["c_" + tag] = _serve(eng, prompts, JOBS_C)
        if kw:
            out["c_mean_" + tag] = eng.stats()["spec_accepted"]["mean"]
    out["d"] = _paged_vs_slab(f32, mesh, ck)
    return out


class _Clock:
    """A clock that advances one unit a reading, from ``offset``."""

    def __init__(self, offset: float):
        self.t = offset

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _lockstep(model, mesh, params, clock):
    """(e): six sampled requests over 4 slots, two of them with a deadline
    that expires mid-run; every tick's (tick, emitted, statuses)."""
    eng = ServeEngine(model, params, mesh=mesh, n_slots=4, kv_len=KV,
                      batch_axes=("data",), kv_axes=("model",),
                      device="cpu", clock=clock)
    prompts = _prompts(model.cfg.vocab, JOBS_B, 5)
    uids = []
    for i, (p, (_, n)) in enumerate(zip(prompts, JOBS_B)):
        uids.append(eng.submit(p, max_new_tokens=n + 4, temperature=0.8,
                               top_k=20, seed=100 + i,
                               deadline={1: 14.0, 4: 24.0}.get(i)))
    log = []
    while not eng.done:
        emitted = eng.step()
        log.append((eng._tick, emitted, dict(eng.status)))
        assert len(log) < 300
    return {"log": log, "tokens": [eng.results[u] for u in uids],
            "status": [eng.status[u] for u in uids]}


def _capture(model, mesh, params, pool, prompts, jobs):
    """The tokens of one engine run and every model call's logits (numpy:
    a rank's tensors would not outlive its process)."""
    calls = []
    kw = dict(pool="paged", page_size=8, chunk_size=8) if pool == "paged" \
        else dict(batch_axes=("data",))
    eng = ServeEngine(model, params, mesh=mesh, n_slots=4, kv_len=KV,
                      kv_axes=("model",), device="cpu",
                      observer=lambda k, r, lg: calls.append(
                          lg.numpy().copy()),
                      **kw)
    return _serve(eng, prompts, jobs), calls


def _refusals(model, mesh, params):
    """(h): what each indivisible layout raises, at (2, 2)."""
    out = {}
    cases = {
        "n_slots": dict(n_slots=3, kv_len=KV, batch_axes=("data",)),
        "kv_len": dict(n_slots=4, kv_len=KV - 1, batch_axes=("data",)),
        "page_size": dict(n_slots=4, kv_len=27, pool="paged", page_size=9,
                          chunk_size=9),
        "paged_batch": dict(n_slots=4, kv_len=KV, pool="paged",
                            batch_axes=("data",))}
    for name, kw in cases.items():
        kw.setdefault("kv_axes", ("model",))
        try:
            ServeEngine(model, params, mesh=mesh, device="cpu", **kw)
        except ValueError as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def _a_cases(world):
    """(a)'s archs on a world of ``world`` ranks."""
    return [n for n, (y, x) in A_CASES.items() if y * x == world]


def _rank4(rank, world, P, R):
    """(2, 2): (a) qwen3 and mamba2, (e), (f), (h); (1, 4): (d)."""
    out = {"a": {n: _consistency(rank, world, P, n)
                 for n in _a_cases(world)}}
    arch, mesh, model = _build("qwen3-0.6b", (2, 2), **F32)
    params = _load(P, "a_qwen3-0.6b", model, rank, world)
    out["e"] = _lockstep(model, mesh, params, _Clock(3.0 * rank))
    out["h"] = _refusals(model, mesh, params)
    prompts = _prompts(arch.vocab, JOBS_B, 7)
    deep = _arch("qwen3-0.6b", n_layers=4)
    for depth in (0, 2):
        pol = make_policy(deep, mesh.axes, mesh=mesh, prefetch=depth, **F32)
        m = Model(deep, pol.zcfg, world=world, device="cpu")
        p = _load(P, "f_deep", m, rank, world)
        out[f"f{depth}"] = {pool: _capture(m, mesh, p, pool, prompts, JOBS_B)
                            for pool in ("slab", "paged")}
    _, mesh14, m14 = _build("qwen3-0.6b", (1, 4), **F32)
    out["d"] = _paged_vs_slab(m14, mesh14, _wait(os.path.join(R, "ck",
                                                              "ckpt_0")))
    return out


def _consistency(rank, world, P, name):
    """(a) on this rank: (prefill(P + n) logits, prefill(P) + n decode
    steps' last logits)."""
    arch, mesh, model = _build(name, A_CASES[name], **F32)
    params = _load(P, "a_" + name, model, rank, world)
    cap = A_P + A_EXTRA
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, arch.vocab, (A_ROWS, cap))).long()
    lay = dict(batch_axes=("data",), device="cpu", mesh=mesh)
    ps = steps.build_prefill_step(model, seq_axes=("model",), **lay)
    ds = steps.build_decode_step(model, kv_axes=("model",), **lay)
    ref, _ = ps.fn(params, {"tokens": toks})
    _, caches = ps.fn(params, {"tokens": toks[:, :A_P]})
    caches = steps.pad_prefill_caches(model, caches, cap, mesh, ("model",),
                                      ("model",))
    for t in range(A_P, cap):
        got, caches = ds.fn(params, caches, {"tokens": toks[:, t:t + 1]},
                            torch.full((A_ROWS,), t))
    return {"ref": ref.numpy(), "got": got.numpy()}


def _rank2(rank, world, P):
    """(1, 2): (a) gemma3 and recurrentgemma."""
    return {"a": {n: _consistency(rank, world, P, n)
                  for n in _a_cases(world)}}


def _draw(P, name, arch, world, seed):
    """The port's seeded init at a ``world``'s flat layout, saved for both
    sides; returns the global buffers."""
    pol = make_policy(arch)
    model = Model(arch, pol.zcfg, world=world, device="cpu")
    g = {k: v.numpy() for k, v in model.init_params(
        torch.Generator().manual_seed(seed), torch.float32).items()}
    np.savez(os.path.join(P, name + ".npz"), **g)
    return g


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import json
    P = str(tmp_path_factory.mktemp("params"))
    R = str(tmp_path_factory.mktemp("ref"))
    glob = {}
    for name, shape in A_CASES.items():
        glob["a_" + name] = _draw(P, "a_" + name, _arch(name),
                                  shape[0] * shape[1], 1)
    glob["q8w"] = _draw(P, "q8w", _arch("qwen3-0.6b"), 8, 0)
    _draw(P, "c_draft", _arch("qwen3-0.6b"), 8, 1)
    _draw(P, "f_deep", _arch("qwen3-0.6b", n_layers=4), 4, 2)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    log_path = os.path.join(R, "ref.log")
    with open(log_path, "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_SNIPPET, R, P, json.dumps(JOBS_B),
             json.dumps(JOBS_C), json.dumps(A_CASES)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            r8 = mesh_lib.spawn(_rank8, 8, P, R, device="cpu",
                                timeout=WAIT_S)
            r4 = mesh_lib.spawn(_rank4, 4, P, R, device="cpu",
                                timeout=WAIT_S)
            r2 = mesh_lib.spawn(_rank2, 2, P, device="cpu", timeout=WAIT_S)
            ref.wait(timeout=WAIT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, Path(log_path).read_text()[-5000:]
    with np.load(os.path.join(R, "ref.npz")) as z:
        refs = {k: z[k] for k in z.files}
    return dict(r8=r8, r4=r4, r2=r2, ref=refs, glob=glob)


def _flat(streams):
    return [t for s in streams for t in s]


def _same_on_every_rank(ranks, key):
    assert all(r[key] == ranks[0][key] for r in ranks), key
    return ranks[0][key]


# ---------------------------------------------------------------------------
# (a) check_serve_prefill_decode_consistency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(A_CASES))
def test_prefill_decode_consistency(world, arch):
    y, x = A_CASES[arch]
    ranks = world["r4"] if y * x == 4 else world["r2"]
    rref, rgot = world["ref"]["a_ref_" + arch], world["ref"]["a_got_" + arch]
    for r in ranks:
        ref, got = r["a"][arch]["ref"], r["a"][arch]["got"]
        assert ref.shape == got.shape == (A_ROWS, 1, _arch(arch).vocab)
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < 2e-2, f"prefill/decode mismatch rel {err}"
        assert (got.argmax(-1) == ref.argmax(-1)).all()
        np.testing.assert_allclose(ref, rref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, rgot, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) check_serve_engine_continuous_batching
# ---------------------------------------------------------------------------

def test_continuous_batching_int8_boot(world):
    ranks = world["r8"]
    got = _same_on_every_rank(ranks, "b_bf16")
    assert got == ranks[0]["b_alone"], (got, ranks[0]["b_alone"])
    slots = ranks[0]["b_slots"]
    assert len(slots) == len(JOBS_B) and len(set(slots.values())) <= 4
    assert [len(t) for t in got] == [n for _, n in JOBS_B]
    f32 = _same_on_every_rank(ranks, "b_f32")
    assert _flat(f32) == list(world["ref"]["b_f32"]), \
        (f32, world["ref"]["b_f32"])


# ---------------------------------------------------------------------------
# (c) check_serve_engine_speculative
# ---------------------------------------------------------------------------

def test_speculative_decoding(world):
    ranks, ref = world["r8"], world["ref"]
    want = _same_on_every_rank(ranks, "c_plain")
    bad = _same_on_every_rank(ranks, "c_bad")
    good = _same_on_every_rank(ranks, "c_self")
    assert bad == want and good == want, (bad, good, want)
    for tag in ("plain", "bad", "self"):
        assert _flat(ranks[0]["c_" + tag]) == list(ref["c_" + tag]), tag
    m_self = _same_on_every_rank(ranks, "c_mean_self")
    m_bad = _same_on_every_rank(ranks, "c_mean_bad")
    assert m_self is not None and m_self > 1.0 and m_bad <= m_self
    assert m_self == float(ref["c_mean_self"])
    assert m_bad == float(ref["c_mean_bad"])


# ---------------------------------------------------------------------------
# (d) the paged engine against the slab engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ("1x4", "2x4"))
def test_paged_engine_equals_slab(world, shape):
    ranks = world["r4"] if shape == "1x4" else world["r8"]
    d = ranks[0]["d"]
    assert all(r["d"] == d for r in ranks)
    assert d["paged"] == d["slab"], (d["paged"], d["slab"])
    u = d["util"]
    assert u["prefix_hits"] >= 1 and u["prefix_tokens_reused"] >= 16, u
    assert d["n_free"] == 4 and d["refs"] == 0


# ---------------------------------------------------------------------------
# (e) lockstep
# ---------------------------------------------------------------------------

def test_ranks_stay_in_lockstep(world):
    """Rank r's clock reads 3·r ahead of rank 0's, so a rank that read its
    own would expire the two deadlined requests ticks early; every rank
    retires them at the same tick, with the same tokens."""
    ranks = [r["e"] for r in world["r4"]]
    e = ranks[0]
    for r in ranks[1:]:
        assert r["log"] == e["log"] and r["tokens"] == e["tokens"]
    assert e["status"].count("timeout") == 2 and \
        e["status"].count("done") == 4, e["status"]
    # the deadline fell mid-run: the timed-out requests had been admitted
    # and emitted tokens, and others went on decoding after them
    ticks = [t for t, _, st in e["log"] if "timeout" in st.values()]
    assert ticks and ticks[0] < e["log"][-1][0]
    assert all(e["tokens"][i] for i in (1, 4))


def test_sampled_tokens_match_world_one(world):
    """The same sampled requests on one process (the global buffers
    re-fitted to world 1's layout): the same tokens as every rank's,
    deadlines aside (world 1 runs without them)."""
    arch = _arch("qwen3-0.6b")
    model = Model(arch, make_policy(arch, **F32).zcfg, world=1, device="cpu")
    shapes = model.param_shapes()
    params = {k: torch.from_numpy(ts.fit_to(v, shapes[k]))
              for k, v in world["glob"]["a_qwen3-0.6b"].items()}
    eng = ServeEngine(model, params, n_slots=4, kv_len=KV, device="cpu")
    prompts = _prompts(arch.vocab, JOBS_B, 5)
    uids = [eng.submit(p, max_new_tokens=n + 4, temperature=0.8, top_k=20,
                       seed=100 + i)
            for i, (p, (_, n)) in enumerate(zip(prompts, JOBS_B))]
    res = eng.run(max_steps=300)
    got = world["r4"][0]["e"]["tokens"]
    for i, u in enumerate(uids):
        if i in (1, 4):      # timed out on the ranks: a prefix of world 1's
            assert res[u][:len(got[i])] == got[i]
        else:
            assert res[u] == got[i], (i, res[u], got[i])


# ---------------------------------------------------------------------------
# (f) the prefetch ring at depth 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", ("slab", "paged"))
def test_prefetch_depth_two_is_bit_identical(world, pool):
    for r in world["r4"]:
        t0, l0 = r["f0"][pool]
        t2, l2 = r["f2"][pool]
        assert t0 == t2 and len(l0) == len(l2) > 0
        for a, b in zip(l0, l2):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (g) serve_shape_policy
# ---------------------------------------------------------------------------

POLICY_CASES = [("decode_32k", ("pod", "data", "model")),
                ("long_500k", ("data", "model")),
                ("prefill_32k", ("data", "model")),
                ("decode_64k", ("data", "model")),
                ("train_4k", ("data", "model")),
                ("decode_32k", ("data", "mdl")),
                ("decode_32k", ("data", "data", "model"))]


@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_serve_shape_policy_matches_reference(case):
    """The same (batch_axes, kv_axes), or a ValueError where the
    reference raises one."""
    from repro.train.serve import serve_shape_policy as ref_policy
    shape, axes = POLICY_CASES[case]

    def call(fn):
        try:
            return fn(shape, axes)
        except ValueError:
            return ValueError
    assert call(steps.serve_shape_policy) == call(ref_policy)


def test_serve_shape_policy_validation():
    """The reference's test (``tests/test_serve_engine.py:316``) on the
    port's policy."""
    pol = steps.serve_shape_policy
    assert pol("decode_32k", ("pod", "data", "model")) == \
        (("pod", "data"), ("model",))
    assert pol("long_500k", ("data", "model")) == ((), ("data", "model"))
    with pytest.raises(ValueError, match="unknown inference shape"):
        pol("decode_64k", ("data", "model"))
    with pytest.raises(ValueError, match="train shape"):
        pol("train_4k", ("data", "model"))
    with pytest.raises(ValueError, match="'model'"):
        pol("decode_32k", ("data", "mdl"))
    with pytest.raises(ValueError, match="duplicate"):
        pol("decode_32k", ("data", "data", "model"))


# ---------------------------------------------------------------------------
# (h) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,match", [
    ("n_slots", "must divide over batch axes"),
    ("kv_len", "does not divide over the 2-way kv sharding"),
    ("page_size", "must divide over the 2-way kv sharding"),
    ("paged_batch", "keeps the batch unsharded")])
def test_indivisible_layouts_are_refused(world, what, match):
    import re
    for r in world["r4"]:
        msg = r["h"][what]
        assert msg is not None and re.search(match, msg), (what, msg)
