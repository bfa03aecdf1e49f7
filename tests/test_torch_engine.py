"""The port's serving engine, sampling and scheduler, on the CPU.

Behaviour the reference's tests/test_serve_engine.py checks for the JAX
engine, held here for the port: slot recycling, streaming and EOS,
deadlines, seeded sampling, and the sampling masks (against the
reference's masks on the same logits).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.serve import sampling as jax_sampling             # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.serve import FIFOScheduler, Request, ServeEngine, steps  # noqa: E402,E501
from repro_torch.serve import sampling                       # noqa: E402

KV = 32
JOBS = [(5, 6), (11, 4), (8, 5), (3, 7)]


@pytest.fixture(scope="module")
def served():
    model = Model(get_config("qwen3-0.6b").reduced(),
                  ZeroConfig(dp_axes=("model",), param_dtype=torch.float32,
                             compute_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return model, params


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in JOBS]


def _greedy(model, params, prompt, n):
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


def test_engine_slot_recycling(served):
    """More requests than slots: retired slots are reused FIFO and the
    recycled requests' outputs are their standalone greedy tokens."""
    model, params = served
    eng = ServeEngine(model, params, n_slots=2, kv_len=KV, device="cpu")
    prompts = _prompts(model.cfg.vocab, seed=1)
    uids = [eng.submit(p, max_new_tokens=n) for p, (_, n) in
            zip(prompts, JOBS)]
    res = eng.run(max_steps=100)
    slots = [eng.slot_history[u] for u in uids]
    assert set(slots) == {0, 1} and len(slots) == 4
    assert eng.pool.n_free == 2 and (eng.pool.lengths == 0).all()
    for u, p, (_, n) in zip(uids, prompts, JOBS):
        assert res[u] == _greedy(model, params, p, n)


def test_engine_streaming_and_eos(served):
    model, params = served
    pr = _prompts(model.cfg.vocab, seed=2)[0]
    first = _greedy(model, params, pr, 1)[0]
    streamed = []
    eng = ServeEngine(model, params, n_slots=2, kv_len=KV, device="cpu")
    uid = eng.submit(pr, max_new_tokens=10, eos_id=first,
                     on_token=lambda u, t: streamed.append((u, t)))
    assert eng.run(max_steps=50)[uid] == [first]
    assert streamed == [(uid, first)]
    assert eng.status[uid] == "done"


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_engine_request_deadline_timeout(served):
    """Past its deadline an active request retires as 'timeout' and frees
    its slot; a queued one never takes a slot."""
    model, params = served
    clk = _Clock()
    eng = ServeEngine(model, params, n_slots=1, kv_len=KV, device="cpu",
                      clock=clk)
    pr = _prompts(model.cfg.vocab, seed=6)[0]
    slow = eng.submit(pr, max_new_tokens=1000, deadline=5.0)
    queued = eng.submit(pr, max_new_tokens=4, deadline=5.0)
    ok = eng.submit(pr, max_new_tokens=4)
    eng.step()
    eng.step()
    assert eng.status[slow] == "active" and eng.status[queued] == "queued"
    n_before = len(eng.results[slow])
    clk.t = 10.0
    eng.step()
    assert eng.status[slow] == "timeout" and eng.status[queued] == "timeout"
    assert eng.status[ok] == "active"
    assert len(eng.results[slow]) == n_before
    res = eng.run(max_steps=50)
    assert res[ok] == _greedy(model, params, pr, 4)
    st = eng.stats()
    assert (st["completed"], st["expired"], st["admitted"]) == (1, 2, 2)


def test_engine_seeded_sampling_deterministic(served):
    model, params = served
    pr = _prompts(model.cfg.vocab, seed=4)[2]

    def run_once(seed):
        eng = ServeEngine(model, params, n_slots=1, kv_len=KV, device="cpu")
        uid = eng.submit(pr, max_new_tokens=8, temperature=1.0, top_k=20,
                         top_p=0.95, seed=seed)
        return eng.run(max_steps=50)[uid]

    a, b, c = run_once(5), run_once(5), run_once(6)
    assert a == b and a != c


def test_sampling_masks_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 64)).astype(np.float32) * 3
    for k in (1, 5, 63):
        np.testing.assert_array_equal(
            sampling.top_k_mask(torch.from_numpy(logits), k).numpy(),
            np.asarray(jax_sampling.top_k_mask(jnp.asarray(logits), k)))
    for p in (0.3, 0.7, 1.0):
        np.testing.assert_array_equal(
            sampling.top_p_mask(torch.from_numpy(logits), p).numpy(),
            np.asarray(jax_sampling.top_p_mask(jnp.asarray(logits), p)))
    greedy = sampling.sample_logits(torch.from_numpy(logits),
                                    torch.Generator(), temperature=0.0)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_scheduler_buckets_and_admission():
    s = FIFOScheduler(kv_len=64)
    assert s.buckets == (8, 16, 32, 64)
    for plen in (3, 9, 17):
        s.submit(Request(prompt=np.zeros(plen, np.int32)))
    adm = s.admit(2)
    assert [len(r.prompt) for r, _ in adm] == [3, 9]
    assert [b for _, b in adm] == [8, 16]
    with pytest.raises(ValueError, match="no room to generate"):
        s.submit(Request(prompt=np.zeros(64, np.int32)))
