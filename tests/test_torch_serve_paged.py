"""Port vs reference: paged KV serving of a reduced qwen3-0.6b.

The reference (``repro``) runs its paged functions, its jitted paged step
and its paged engine on a one-device ``("model",)`` mesh in f32; the port
runs the same flat buffers (``convert.params_from_numpy``) on the CPU.

Tolerances:
- ``paged_insert`` writes copies of its inputs: the arena is held
  bit-identical.  ``paged_attend`` differs only by fp32 summation order:
  1e-5 abs + 1e-5 rel on outputs of magnitude ~1.
- ``paged_fn``: logits and arena at ``test_torch_serve.py``'s f32 bar,
  1e-5 abs + 1e-5 rel (both sides quantize the weights bit-identically).
- ``PagedKVPool`` is host bookkeeping: tables, refcounts, LRU order,
  ``utilization()`` and every refusal are held equal.
- Engines: greedy token streams held equal, token for token, to the
  port's slab engine and to the reference's paged engine, with equal
  ``prefill_chunks`` and ``spec_accepted``.  A prefix-cache hit's logits
  are held bit-identical to the cold run's, and a model at
  ``prefetch=2`` to one at ``prefetch=0`` bit for bit (logits, arena,
  tokens).
"""
import dataclasses
import os
from collections import Counter

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402
from jax.sharding import NamedSharding                       # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core.compat import make_mesh                      # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402
from repro.serve import PagedKVPool as JaxPagedPool          # noqa: E402
from repro.serve import ServeEngine as JaxEngine             # noqa: E402
from repro.serve import steps as jax_steps                   # noqa: E402
from repro.train.policy import make_policy                   # noqa: E402
from repro.train.state import param_specs                    # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.convert import params_from_numpy            # noqa: E402
from repro_torch.launch import mesh as mesh_lib              # noqa: E402
from repro_torch.models import attention as attn             # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import PagedKVPool, ServeEngine, steps  # noqa: E402
from repro_torch.train import state as ts                    # noqa: E402

from test_torch_serve import _np, _port_zcfg                  # noqa: E402

JOBS = [(5, 6), (11, 4), (8, 5), (3, 7)]      # (prompt_len, max_new) x4
KV = 32
PAGE = 8
G = 4                                          # spec_tokens


@pytest.fixture(scope="module")
def pair():
    """((jmodel, mesh, jparams), (model, params), (jdraft, draft)): the
    reduced qwen3-0.6b in f32 on both sides, and an independent drafter of
    the same widths drawn from seed 1."""
    mesh = make_mesh((1,), ("model",))
    arch = jax_get_config("qwen3-0.6b").reduced()
    pol = make_policy(arch, mesh.axis_names, param_dtype=jnp.float32,
                      compute_dtype=jnp.float32)
    jmodel = JaxModel(arch, pol.zcfg, world=1)
    specs = param_specs(jmodel, tuple(mesh.axis_names))
    model = Model(get_config("qwen3-0.6b").reduced(), _port_zcfg(pol.zcfg),
                  world=1, device="cpu")

    def draw(seed):
        jp = jmodel.init_params(jax.random.PRNGKey(seed), dtype=jnp.float32)
        jp = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in jp.items()}
        return jp, params_from_numpy({k: np.asarray(v)
                                      for k, v in jp.items()}, model)

    jparams, params = draw(0)
    jdraft, draft = draw(1)
    return (jmodel, mesh, jparams), (model, params), (jdraft, draft)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in JOBS]


def _run(eng, prompts, jobs=JOBS, max_steps=200):
    uids = [eng.submit(pr, max_new_tokens=n)
            for pr, (_, n) in zip(prompts, jobs)]
    res = eng.run(max_steps=max_steps)
    return [res[u] for u in uids]


def _paged(model, params, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("kv_len", KV)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("chunk_size", PAGE)
    return ServeEngine(model, params, pool="paged", device="cpu",
                       cache_dtype=torch.float32, **kw)


def _jpaged(jmodel, mesh, jparams, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("kv_len", KV)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("chunk_size", PAGE)
    return JaxEngine(jmodel, mesh, jparams, pool="paged",
                     cache_dtype=jnp.float32, **kw)


def _slab(model, params, prompts, jobs=JOBS):
    return _run(ServeEngine(model, params, n_slots=3, kv_len=KV,
                            device="cpu"), prompts, jobs)


# ---------------------------------------------------------------- functions

# (B, T, H, K, Pm, positions start per row, table rows, softcap):
# -1 rows (idle), -1 pages past the reservation, T > 1 rows crossing page
# boundaries and running past the reservation, GQA
ATTEND_CASES = {
    "decode_idle_row": (3, 1, 4, 2, 4, [5, 0, 17],
                        [[2, 7, -1, -1], [-1, -1, -1, -1], [0, 1, 3, -1]],
                        0.0),
    "chunk_past_reservation": (2, 6, 4, 2, 4, [6, 13],
                               [[4, 5, -1, -1], [1, -1, -1, -1]], 0.0),
    "verify_softcap_mha": (2, 5, 2, 2, 3, [9, 0],
                           [[6, 0, 2], [3, 4, -1]], 30.0),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_paged_insert_and_attend_match_reference(case):
    B, T, H, K, Pm, start, table, cap = ATTEND_CASES[case]
    N, hd = 8, 16
    rng = np.random.default_rng(sorted(ATTEND_CASES).index(case))
    kc = rng.normal(size=(N, PAGE, K, hd)).astype(np.float32)
    vc = rng.normal(size=(N, PAGE, K, hd)).astype(np.float32)
    kn = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    vn = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32) * 3
    pos = (np.asarray(start)[:, None] + np.arange(T)).astype(np.int32)
    tab = np.asarray(table, np.int32)

    jk, jv = jattn.paged_insert(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(pos), jnp.asarray(tab))
    jout = jattn.paged_attend(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                              jnp.asarray(tab), logit_softcap=cap)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    attn.paged_insert(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(pos), torch.from_numpy(tab))
    tout = attn.paged_attend(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(pos), torch.from_numpy(tab),
                             logit_softcap=cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), kc)          # something landed
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    idle = (tab < 0).all(axis=1)
    assert (tout.numpy()[idle] == 0).all()               # zeros, not NaN


@pytest.mark.parametrize("B,T", [(3, 1), (1, PAGE), (3, G + 1)])
def test_paged_fn_matches_reference(pair, B, T):
    """One paged step on a seeded arena: per-row tables (one row idle at
    B = 3), rows at different start positions, through the qwZ gathers
    and the fused INT8 head, against the reference's jitted step."""
    (jmodel, mesh, jparams), (model, params), _ = pair
    n_pages = 8
    rng = np.random.default_rng(B * 10 + T)
    arena = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        jmodel.paged_cache_shapes(n_pages, PAGE, jnp.float32))
    tables = np.array([[3, 1, 6, -1], [-1, -1, -1, -1], [0, 2, 4, 5]],
                      np.int32)[:B]
    start = np.array([9, 0, 21], np.int32)[:B]
    toks = rng.integers(0, model.cfg.vocab, (B, T)).astype(np.int32)

    jstep = jax_steps.build_paged_step(jmodel, mesh, ("model",),
                                       donate=False)
    jl, jc = jstep.fn(jparams, jax.tree.map(jnp.asarray, arena),
                      {"tokens": jnp.asarray(toks)}, jnp.asarray(tables),
                      jnp.asarray(start))
    tarena = model.init_paged_caches(n_pages, PAGE, torch.float32)
    for pc, a in zip(tarena["blocks"], arena["blocks"]):
        for key in ("k", "v"):
            pc[key].copy_(torch.from_numpy(a[key]))
    step = steps.build_paged_step(model, device="cpu")
    tl, tc = step.fn(params, tarena, {"tokens": torch.from_numpy(toks)},
                     tables, start)
    assert tuple(tl.shape) == (B, T, model.cfg.vocab)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for pc, jcc in zip(tc["blocks"], jc["blocks"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(pc[key]), np.asarray(jcc[key]),
                                       rtol=1e-5, atol=1e-5)


def test_paged_fn_refuses_window_and_mrope():
    z = _port_zcfg(make_policy(jax_get_config("qwen3-0.6b").reduced(),
                               ("model",)).zcfg)
    gemma = Model(get_config("gemma3-4b").reduced(), z, device="cpu")
    with pytest.raises(ValueError, match="attn-only"):
        gemma.init_paged_caches(4, PAGE)
    with pytest.raises(ValueError, match="attn-only"):
        PagedKVPool(gemma, 1, KV, page_size=PAGE)
    vl = Model(get_config("qwen2-vl-72b").reduced(), z, device="cpu")
    with pytest.raises(ValueError, match="mrope"):
        vl.paged_fn({}, None, {}, np.zeros((1, 1)), np.zeros(1), None)


# --------------------------------------------------------------------- pool

def _pool_state(pool):
    return (pool.table.tolist(), pool.refcount.tolist(),
            list(pool._lru.items()), list(pool._free_pages),
            list(pool._free_slots), pool.utilization())


def test_paged_pool_bookkeeping_matches_reference(pair):
    """Both pools through one sequence of alloc, register, free and
    match_prefix calls under page pressure (4 slots, 8 pages): every
    result, table, refcount, LRU order and utilization equal, and the
    constructor's refusal."""
    (jmodel, mesh, _), (model, _), _ = pair
    jp = JaxPagedPool(jmodel, mesh, n_slots=4, kv_len=KV, page_size=PAGE,
                      n_pages=8, kv_axes=("model",), dtype=jnp.float32)
    tp = PagedKVPool(model, n_slots=4, kv_len=KV, page_size=PAGE, n_pages=8,
                     dtype=torch.float32)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 100, 17).astype(np.int32)
    b = rng.integers(0, 100, 9).astype(np.int32)
    c = rng.integers(0, 100, 25).astype(np.int32)
    calls = [("alloc", a, 4), ("register", 0, a), ("alloc", a, 4),
             ("match", a, 1), ("match", a, PAGE * 2), ("free", 0),
             ("alloc", b, 4), ("register", 2, b), ("free", 2),
             ("free", 1), ("match", b, 1), ("alloc", c, 8),
             ("alloc", c, 8), ("alloc", a, 4), ("match", a, 1),
             ("free", 0), ("alloc", b, 30), ("alloc", a, 4)]
    for call in calls:
        outs = []
        for pool in (jp, tp):
            if call[0] == "alloc":
                outs.append(pool.alloc(call[1], call[2], align=PAGE))
            elif call[0] == "register":
                outs.append(pool.register_prefix(call[1], call[2]))
            elif call[0] == "match":
                m, pairs = pool.match_prefix(call[1], call[2])
                outs.append((m, [pg for _, pg in pairs]))
            else:
                outs.append(pool.free(call[1]))
        assert outs[0] == outs[1], (call, outs)
        assert _pool_state(jp) == _pool_state(tp), call
    assert tp.utilization()["evicted"] > 0            # pressure was real
    assert tp.pages_needed(20, 100) == jp.pages_needed(20, 100)
    assert tp.free_pages == jp.free_pages
    with pytest.raises(ValueError, match="page_size"):
        PagedKVPool(model, n_slots=1, kv_len=30, page_size=PAGE)
    with pytest.raises(ValueError, match="page_size"):
        JaxPagedPool(jmodel, mesh, n_slots=1, kv_len=30, page_size=PAGE)


# -------------------------------------- the reference's paged tests, ported

def test_paged_engine_matches_slab_greedy(pair):
    """The paged engine (page tables, chunked prefill) emits per request
    the slab engine's stream and the reference's paged engine's, with the
    reference's prefill chunk count; a full drain unpins every page."""
    (jmodel, mesh, jparams), (model, params), _ = pair
    prompts = _prompts(model.cfg.vocab)
    eng = _paged(model, params)
    got = _run(eng, prompts)
    assert got == _slab(model, params, prompts)
    jeng = _jpaged(jmodel, mesh, jparams)
    assert got == _run(jeng, prompts)
    assert eng.stats()["prefill_chunks"] == jeng.stats()["prefill_chunks"]
    assert eng.pool.n_free == 3 and (eng.pool.refcount == 0).all()
    assert eng.stats()["pool"] == jeng.stats()["pool"]


def _chunked_prefill(pool, step, params, prompt, chunk, max_new=4):
    """Drive pool + paged step through one chunked prefill; returns (slot,
    matched, last prompt token's logits)."""
    res = pool.alloc(prompt, max_new, align=chunk)
    assert res is not None
    slot, matched = res
    P = len(prompt)
    done, last = matched, None
    while done < P:
        end = min(done + chunk, P)
        toks = np.zeros((1, chunk), np.int64)
        toks[0, : end - done] = prompt[done:end]
        logits, pool.caches = step.fn(
            params, pool.caches, {"tokens": torch.from_numpy(toks)},
            pool.table[slot: slot + 1], np.asarray([done]))
        if end >= P:
            last = logits[0, (P - 1) - done].clone()
        done = end
    pool.lengths[slot] = P
    pool.register_prefix(slot, prompt)
    return slot, matched, last


def _port_pool(model, **kw):
    return PagedKVPool(model, kv_len=KV, page_size=PAGE,
                       dtype=torch.float32, **kw)


def test_prefix_hit_bitwise_identical_logits(pair):
    """A prefix hit skips the matched chunks but must leave the same
    memory as the cold prefill: the recomputed final chunk's first-token
    logits are bit-identical."""
    _, (model, params), _ = pair
    pool = _port_pool(model, n_slots=2)
    step = steps.build_paged_step(model, device="cpu")
    prompt = np.random.default_rng(7).integers(
        0, model.cfg.vocab, 20).astype(np.int32)
    slot, matched, cold = _chunked_prefill(pool, step, params, prompt, PAGE)
    assert matched == 0
    pool.free(slot)                      # full prompt pages park in the LRU
    assert pool.counters["prefix_hits"] == 0
    _, matched2, warm = _chunked_prefill(pool, step, params, prompt, PAGE)
    assert matched2 == 16                # pages 0, 1 of 20 tokens / 8
    assert pool.counters["prefix_hits"] == 1
    assert pool.counters["prefix_tokens_reused"] == 16
    assert torch.equal(cold, warm)


def test_refcounted_pages_never_reclaimed_while_referenced(pair):
    """Two live slots share prefix pages: freeing one keeps them out of the
    free list and the LRU until the last reference drops; eviction claims
    refcount-0 pages only, and a pool with every page referenced refuses."""
    _, (model, params), _ = pair
    pool = _port_pool(model, n_slots=4, n_pages=8)
    step = steps.build_paged_step(model, device="cpu")
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, model.cfg.vocab, 17).astype(np.int32)
    a, _, _ = _chunked_prefill(pool, step, params, prompt, PAGE)
    b, matched, _ = _chunked_prefill(pool, step, params, prompt, PAGE)
    shared = [int(pg) for pg in pool.table[a][:2]]
    assert matched == 16 and list(pool.table[b][:2]) == shared
    assert all(pool.refcount[pg] == 2 for pg in shared)
    pool.free(a)
    assert all(pool.refcount[pg] == 1 for pg in shared)
    assert all(pg not in pool._free_pages for pg in shared)
    assert all(pg not in pool._lru.values() for pg in shared)
    other = rng.integers(0, model.cfg.vocab, 24).astype(np.int32)
    res = pool.alloc(other, max_new=8, align=PAGE)        # needs 4 pages
    assert res is not None
    assert set(int(p) for p in pool.table[res[0]]).isdisjoint(shared)
    assert all(pool.refcount[pg] == 1 for pg in shared)
    assert pool.alloc(other, max_new=8, align=PAGE) is None
    assert (pool.refcount[[int(p) for p in pool.table[b] if p >= 0]]
            >= 1).all()


def test_lru_eviction_frees_only_refcount_zero(pair):
    """Two prompts' pages parked in the LRU; a request needing them back
    evicts the oldest first, and the evicted hashes stop matching."""
    _, (model, params), _ = pair
    pool = _port_pool(model, n_slots=2, n_pages=4)
    step = steps.build_paged_step(model, device="cpu")
    rng = np.random.default_rng(9)
    p1 = rng.integers(0, model.cfg.vocab, 9).astype(np.int32)
    p2 = rng.integers(0, model.cfg.vocab, 9).astype(np.int32)
    s1, _, _ = _chunked_prefill(pool, step, params, p1, PAGE)
    pool.free(s1)
    s2, _, _ = _chunked_prefill(pool, step, params, p2, PAGE)
    pool.free(s2)
    assert pool.utilization()["pages_cached"] == 2
    big = rng.integers(0, model.cfg.vocab, 25).astype(np.int32)
    assert pool.alloc(big, max_new=4, align=PAGE) is not None
    u = pool.utilization()
    assert u["evicted"] == 2 and u["pages_cached"] == 0
    assert pool.match_prefix(p1)[0] == 0 and pool.match_prefix(p2)[0] == 0


def _interleaved(eng, short, long):
    """Submit ``short``, step once, submit ``long``; run to the end.
    Returns (uids, whether a decode tick emitted for ``short`` while
    ``long`` was mid-prefill)."""
    u_short = eng.submit(short, max_new_tokens=8)
    eng.step()
    u_long = eng.submit(long, max_new_tokens=4)
    seen = False
    for _ in range(50):
        if eng.done:
            break
        emitted = eng.step()
        if eng._prefilling and any(u == u_short for u, _ in emitted):
            seen = True
    return (u_short, u_long), seen


def test_chunked_prefill_interleaves_decode(pair):
    """A long prompt prefills in chunks WHILE a short request keeps
    decoding; both streams equal the slab engine's and the reference's."""
    (jmodel, mesh, jparams), (model, params), _ = pair
    rng = np.random.default_rng(10)
    short = rng.integers(0, model.cfg.vocab, 4).astype(np.int32)
    long = rng.integers(0, model.cfg.vocab, 24).astype(np.int32)
    eng = _paged(model, params, n_slots=2)
    uids, seen = _interleaved(eng, short, long)
    assert seen, "no decode tick overlapped the chunked prefill"
    assert eng.stats()["prefill_chunks"] == 4     # 24 / 8 = 3, short 1
    jeng = _jpaged(jmodel, mesh, jparams, n_slots=2)
    juids, _ = _interleaved(jeng, short, long)
    assert [eng.results[u] for u in uids] == [jeng.results[u] for u in juids]
    assert jeng.stats()["prefill_chunks"] == 4
    assert [eng.results[u] for u in uids] == _slab(
        model, params, [short, long], [(4, 8), (24, 4)])


@pytest.mark.parametrize("drafter", ["self", "independent"])
def test_speculative_greedy_token_identical(pair, drafter):
    """Speculative decoding emits the plain greedy streams, with the
    reference's accepted-tokens distribution: the self-drafter accepts more
    than one token a verify, the independent one (seed 1) about one."""
    (jmodel, mesh, jparams), (model, params), (jdraft, draft) = pair
    prompts = _prompts(model.cfg.vocab, seed=12)
    tdraft = (model, params) if drafter == "self" else (model, draft)
    jd = (jmodel, jparams) if drafter == "self" else (jmodel, jdraft)
    eng = _paged(model, params, draft=tdraft, spec_tokens=G)
    got = _run(eng, prompts)
    assert got == _slab(model, params, prompts)
    jeng = _jpaged(jmodel, mesh, jparams, draft=jd, spec_tokens=G)
    assert got == _run(jeng, prompts)
    acc, jacc = eng.stats()["spec_accepted"], jeng.stats()["spec_accepted"]
    assert acc == jacc
    assert eng.stats()["prefill_chunks"] == jeng.stats()["prefill_chunks"]
    if drafter == "self":
        assert acc["n"] > 0 and acc["mean"] > 1.0, acc
    assert (eng.pool.refcount == 0).all()
    assert (eng.draft_pool.refcount == 0).all()


def test_speculative_rejects_sampling(pair):
    _, (model, params), _ = pair
    eng = _paged(model, params, draft=(model, params), spec_tokens=2)
    with pytest.raises(ValueError, match="greedily"):
        eng.submit(np.zeros(4, np.int32), max_new_tokens=2, temperature=0.7)


def test_paged_engine_rejects_bad_configs(pair):
    _, (model, params), (_, draft) = pair
    with pytest.raises(ValueError, match="chunk_size"):
        _paged(model, params, chunk_size=12)
    with pytest.raises(ValueError, match="pool"):
        ServeEngine(model, params, n_slots=1, kv_len=KV, pool="heap",
                    device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, n_slots=1, kv_len=KV, device="cpu",
                    draft=(model, params))
    with pytest.raises(ValueError, match="spec_tokens"):
        _paged(model, params, draft=(model, params), spec_tokens=1)
    wide = Model(dataclasses.replace(model.cfg, vocab=2 * model.cfg.vocab),
                 model.zcfg, device="cpu")
    with pytest.raises(ValueError, match="drafter vocab"):
        _paged(model, params, draft=(wide, {}))
    with pytest.raises(ValueError, match="mode"):
        _paged(model, params, tune="fast")


# ------------------------------------------------------------------- engine

def test_mid_prefill_request_expires(pair):
    """A request past its deadline while mid-prefill times out: its slot
    and pages (drafter's too) go back, the queue behind it runs, and the
    reference's engine ends in the same statuses and streams."""
    (jmodel, mesh, jparams), (model, params), _ = pair
    rng = np.random.default_rng(11)
    long = rng.integers(0, model.cfg.vocab, 27).astype(np.int32)
    short = rng.integers(0, model.cfg.vocab, 5).astype(np.int32)
    out = []
    for make in (lambda clock: _paged(model, params, n_slots=1,
                                      draft=(model, params), clock=clock),
                 lambda clock: _jpaged(jmodel, mesh, jparams, n_slots=1,
                                       draft=(jmodel, jparams),
                                       clock=clock)):
        now = [0.0]
        eng = make(lambda: now[0])
        u1 = eng.submit(long, max_new_tokens=3, deadline=5.0)
        u2 = eng.submit(short, max_new_tokens=3)
        eng.step()                                # one chunk of 4 done
        assert eng._prefilling and eng.status[u1] == "active"
        now[0] = 6.0
        eng.run(max_steps=50)
        st = eng.stats()
        out.append((eng.status[u1], eng.status[u2], eng.results[u1],
                    eng.results[u2], st["expired"], st["completed"],
                    st["prefill_chunks"], st["prefilling"]))
        assert (eng.pool.refcount == 0).all()
        assert (eng.draft_pool.refcount == 0).all()
    assert out[0] == out[1]
    assert out[0][:2] == ("timeout", "done") and out[0][2] == []


def test_prefetch_depths_are_bit_identical(pair):
    """A model at ``ZeroConfig(prefetch=2)`` (the layer loop's ring two
    groups deep, on 4 layers) against one at ``prefetch=0``: every logit
    of every paged call (seen by the engine's observer), the final arena
    and the tokens, bit for bit."""
    _, (model2, _), _ = pair
    cfg = dataclasses.replace(model2.cfg, n_layers=4)
    params = Model(cfg, model2.zcfg, device="cpu").init_params(
        torch.Generator().manual_seed(13))
    prompts = _prompts(cfg.vocab, seed=13)
    runs = []
    for k in (0, 2):
        model = Model(cfg, dataclasses.replace(model2.zcfg, prefetch=k),
                      device="cpu")
        assert model.zcfg.effective_prefetch(model.n_periods) == k
        seen = []
        eng = _paged(model, params, observer=lambda kind, rows, logits,
                     seen=seen: seen.append((kind, rows, logits.clone())))
        runs.append((_run(eng, prompts), seen, eng.pool.caches))
    (t0, l0, c0), (t2, l2, c2) = runs
    assert t0 == t2 and len(l0) == len(l2) > 0
    assert all(a[:2] == b[:2] and torch.equal(a[2], b[2])
               for a, b in zip(l0, l2))
    for a, b in zip(c0["blocks"], c2["blocks"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_paged_engine_boots_from_a_checkpoint(pair, tmp_path):
    """``from_checkpoint(..., pool="paged")`` (an INT8 checkpoint, bf16
    serving load) serves the slab engine's tokens from the same
    checkpoint."""
    _, (model, params), _ = pair
    mesh = mesh_lib.make_mesh((1, 1))
    d = str(tmp_path / "ck")
    ts.ZeroState(model, mesh, params={k: v.clone() for k, v in
                                      params.items()}).save(
        d, 0, fmt="int8", meta={"arch": model.cfg.name})
    prompts = _prompts(model.cfg.vocab, seed=14)
    slab = ServeEngine.from_checkpoint(model, d, n_slots=3, kv_len=KV,
                                       device="cpu")
    paged = ServeEngine.from_checkpoint(model, d, n_slots=3, kv_len=KV,
                                        device="cpu", pool="paged",
                                        page_size=PAGE)
    assert paged.pool_kind == "paged" and paged._chunk == 2 * PAGE
    assert _run(paged, prompts) == _run(slab, prompts)


ENGINES = {"slab": {},
           "paged": {"pool": "paged", "page_size": PAGE,
                     "chunk_size": PAGE},
           "speculative": {"pool": "paged", "page_size": PAGE,
                           "chunk_size": PAGE, "spec_tokens": G}}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_observer_sees_every_model_call(pair, engine):
    """``observer=`` is called once a model call, with its kind and the
    (uid, row, position) of every request it served: each greedy token is
    the argmax of its request's row at the position before it (the last
    prompt position for the first token), read from the latest call that
    covered that position; the prefill calls are the engine's prefills
    (a paged engine's chunks), a speculative round is G drafter calls and
    one verify."""
    _, (model, params), _ = pair
    prompts = _prompts(model.cfg.vocab, seed=15)
    seen = []
    kw = dict(ENGINES[engine])
    if engine == "speculative":
        kw["draft"] = (model, params)
    eng = ServeEngine(model, params, n_slots=3, kv_len=KV, device="cpu",
                      cache_dtype=torch.float32, **kw,
                      observer=lambda kind, rows, logits: seen.append(
                          (kind, rows, logits.clone())))
    got = _run(eng, prompts)
    rows = {}
    for kind, served, logits in seen:
        assert logits.dim() == 3 and logits.shape[-1] == model.cfg.vocab
        if not kind.startswith("draft"):
            for uid, r, p in served:
                for j in range(logits.shape[1]):
                    rows.setdefault(uid, {})[p + j] = logits[r, j]
    for uid, (prompt, toks) in enumerate(zip(prompts, got)):
        assert toks == [int(rows[uid][len(prompt) - 1 + j].argmax())
                        for j in range(len(toks))]
    kinds = Counter(kind for kind, _, _ in seen)
    if engine == "slab":
        assert set(kinds) == {"prefill", "decode"}
        assert kinds["prefill"] == len(prompts)
    else:
        assert kinds["prefill"] == eng.stats()["prefill_chunks"]
    if engine == "paged":
        assert set(kinds) == {"prefill", "decode"}
    if engine == "speculative":
        assert set(kinds) == {"prefill", "draft_prefill", "draft", "verify"}
        assert kinds["draft_prefill"] == kinds["prefill"]
        assert kinds["draft"] == G * kinds["verify"]


def test_paged_entry_points_default_to_cuda(pair):
    """Asked for the card where there is none, the paged step and the
    paged and speculative engines raise: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    _, (model, params), _ = pair
    with pytest.raises(RuntimeError, match="cuda"):
        steps.build_paged_step(model)
    for kw in ({}, {"draft": (model, params)}):
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(model, params, n_slots=1, kv_len=KV, pool="paged",
                        **kw)
