"""Port vs reference: MoE at world 1 (``models/moe.py``, the MoE layer,
loss, serving and flat layout).

Inputs are numpy draws from a seed; both sides run fp32 on the CPU.

  (a) ``models/moe.py`` function by function against
      ``repro.models.moe``: ``route_topk`` (indices equal, gates at rtol
      1e-6, ties broken to the lower index as ``lax.top_k`` does),
      ``moe_dispatch`` (``cap``, ``keep``, ``dest``, ``src_tok`` and
      ``inv`` equal; ``gates``, ``g_sorted``, the aux loss and the
      dropped share (the mean of equal masks) at rtol 1e-6) at the
      training capacity, at a capacity that forces drops and at ``serve_capacity``'s; ``serve_capacity``
      on a grid; ``build_chunk_buf``, ``build_chunk_gates``,
      ``expert_ffn``, ``moe_combine``, ``moe_ffn_chunked``, ``shared_ffn``
      and ``moe_mlp`` at rtol 1e-6 / atol 1e-6, and ``moe_mlp``'s
      gradients with respect to every input at rtol 1e-5 / atol 1e-6 ·
      max(1, max |reference|) (the router's reach 5: fp32 sums over the
      tokens in another order); the pair gather's backward equals autograd's
      scatter within 1e-6 and repeats bit for bit;
  (b) ``transformer.moe_pre_block`` (h, normed tokens, router logits,
      shared experts at 1e-5) and the routing of its logits (indices
      equal; the smallest top-k margin printed); the whole MoE
      ``loss_fn`` of deepseek-moe-16b and qwen3-moe-235b-a22b reduced on a
      one-rank ("data", "model") world at the default ring depth 1 (the
      layer ring, the chunk ring, routing-ahead and the hpZ nested
      recompute all run) with every group's gradient and one AdamW step
      at ``tests/test_torch_train.py``'s bars (qgZ off at 1e-5, full
      ZeRO++ at one INT4 step), the parameters after the step within
      ``step_bars.params_near`` with 1 in 100 elements allowed an
      unstable first-step direction (``MOE_FAR_PARAMS``); the step's
      ``moe_aux`` metric within rtol 1e-5 of the reference's;
  (e) prefill and three decode steps (``ZeroConfig.local``, as the
      reference's smoke test) at 1e-5 against the reference; the slab
      engine at world 1 (distributed, the serving ring with its
      routing-ahead gather) serving four requests greedily gives each the
      tokens it gets alone; prefill and decode logits at ring depth 1
      equal depth 0 bit for bit; paged serving refuses MoE;
  and the flat layout (specs, ``param_shapes``, ``n_params``,
  ``n_active_params``) and every ``ArchConfig`` field are the
  reference's; the port's ``comm_events`` fold to the reference's bytes
  at depth 0 and to its own rule at depth k (no wrap-around terms);
  ``convert`` carries ``experts`` at any rank; a world-1 MoE checkpoint
  crosses both ways (``tests/test_torch_state.py``'s rule); the launcher
  takes ``--moe-chunks`` and trains on the CPU.
The gloo-rank halves ((c) depth sweeps, (d) wire, (e) on (1, 2), the
2 → 1 checkpoint) are ``tests/test_torch_moe_multirank.py``.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402
import torch                                                 # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core.zeropp import ZeroConfig as JaxZeroConfig    # noqa: E402
from repro.core.zeropp import \
    step_wire_by_label as jax_wire                           # noqa: E402
from repro.models import moe as jmoe                         # noqa: E402
from repro.models import transformer as jtr                  # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.configs.base import ArchConfig              # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core.partition import shard_of              # noqa: E402
from repro_torch.core.zeropp import ZeroConfig, step_wire_by_label  # noqa
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import moe as tmoe                   # noqa: E402
from repro_torch.models import transformer as ttr            # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402
from repro_torch.models.transformer import RunSpec           # noqa: E402
from repro_torch.optim.adamw import AdamWConfig              # noqa: E402
from repro_torch.serve import ServeEngine                    # noqa: E402
from repro_torch.testing import step_bars                    # noqa: E402
from repro_torch.train.policy import make_policy             # noqa: E402
from repro_torch.train.trainer import build_train_step       # noqa: E402

import test_torch_models_smoke as smoke                      # noqa: E402
import test_torch_state as tstate                            # noqa: E402
import test_torch_train as ttrain                            # noqa: E402

MOE = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
T, D, E, K, FF = 48, 16, 8, 2, 12


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def margin(logits: np.ndarray, top_k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability (a flip below it moves the output by O(1))."""
    p = np.asarray(jax.nn.softmax(_j(logits).astype(jnp.float32), axis=-1))
    s = -np.sort(-p, axis=-1)
    return float((s[:, top_k - 1] - s[:, top_k]).min())


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("arch", MOE)
def test_config_fields_are_the_references(arch):
    """Every field of the port's ``ArchConfig`` (the MoE ones among them),
    full, reduced and reduced with an override."""
    for over in (None, {}, {"n_layers": 4, "expert_chunks": 4}):
        j, t = jax_get_config(arch), get_config(arch)
        if over is not None:
            j, t = j.reduced(**over), t.reduced(**over)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)


@pytest.mark.parametrize("arch", MOE)
def test_flat_layout_and_counts_are_the_references(arch):
    """Specs, buffer shapes, parameter counts (full width: qwen3-moe is
    over ``LARGE_PARAMS``, where ``make_policy`` takes the large-model
    preset: bf16 moments, hpZ off on one pod) and the expert group's place
    at every world."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(),
                       jax_get_config(arch).reduced())):
        for world in (1, 4):
            tm = Model(cfg, ZeroConfig(), world=world, device="cpu")
            jm = JaxModel(jcfg, JaxZeroConfig(), world=world)
            assert tm.param_shapes() == jm.param_shapes()
            assert tm.period_spec.entries == jm.period_spec.entries
            assert tm.expert_spec.entries == jm.expert_spec.entries
            assert tm.expert_spec.padded_size == jm.expert_spec.padded_size
            assert tm.n_params() == jm.n_params()
            assert tm.n_active_params() == jm.n_active_params()
            assert tm.n_moe_layers == jm.n_moe_layers == cfg.n_layers
    big = make_policy(get_config("qwen3-moe-235b-a22b"))
    assert big.n_params == JaxModel(jax_get_config("qwen3-moe-235b-a22b"),
                                    JaxZeroConfig()).n_params()
    assert big.moments_dtype == torch.bfloat16 and not big.zcfg.hpz
    assert make_policy(get_config("deepseek-moe-16b")).n_params == \
        JaxModel(jax_get_config("deepseek-moe-16b"),
                 JaxZeroConfig()).n_params()


# ------------------------------------------------------------ (a) moe.py

def _logits(seed, ties=False):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((T, E)).astype(np.float32)
    if ties:        # exact ties across experts, inside and at the top k
        lg[:, 3] = lg[:, 5]
        lg[::2, 1] = lg[::2, 6] = lg[::2, 0]
        lg[::3] = 0.0
    return lg


@pytest.mark.parametrize("ties", [False, True])
def test_route_topk_matches_reference(ties):
    lg = _logits(0, ties)
    jg, ji = jmoe.route_topk(_j(lg), K)
    tg, ti = tmoe.route_topk(_t(lg), K)
    print(f"smallest top-{K} margin {margin(lg, K):.3e}")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg.numpy(), jg, "gates")
    for norm in (False,):
        jg, ji = jmoe.route_topk(_j(lg), 3, norm)
        tg, ti = tmoe.route_topk(_t(lg), 3, norm)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tg.numpy(), jg, "gates unnormalised")


def _dispatch_pair(seed, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    lg = _logits(seed)
    jd = jmoe.moe_dispatch(_j(x), _j(lg), top_k=K, **kw)
    td = tmoe.moe_dispatch(_t(x), _t(lg), top_k=K, **kw)
    return x, lg, jd, td


DISPATCH = {"train": {}, "drops": {"capacity_factor": 0.5},
            "serve": {"capacity": tmoe.serve_capacity(T, K, E)},
            "tight": {"capacity": 2}}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_matches_reference(case):
    _, lg, jd, td = _dispatch_pair(1, **DISPATCH[case])
    print(f"smallest top-{K} margin {margin(lg, K):.3e}")
    assert td.cap == jd.cap
    for f in ("keep", "dest", "src_tok", "inv"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    for f in ("gates", "g_sorted", "aux_loss"):
        _close(getattr(td, f).numpy(), getattr(jd, f), f)
    _close(float(td.dropped_frac), float(jd.dropped_frac), "dropped")
    if case in ("drops", "tight"):
        assert float(td.dropped_frac) > 0
    if case == "serve":
        assert float(td.dropped_frac) == 0


def test_serve_capacity_matches_reference():
    for t in (1, 2, 4, 7, 64, 257, 8192):
        for k, e in ((2, 8), (6, 64), (8, 128)):
            assert tmoe.serve_capacity(t, k, e) == \
                jmoe.serve_capacity(t, k, e), (t, k, e)
    # decode at 4 slots is drop-free: every token may take one expert
    assert tmoe.serve_capacity(4, 6, 64) == 4 * 6


def _weights(seed, e=E):
    rng = np.random.default_rng(seed)
    return {"wgu": (rng.standard_normal((e, D, 2 * FF)) / 4).astype(
                np.float32),
            "wdn": (rng.standard_normal((e, FF, D)) / 4).astype(np.float32),
            "router": rng.standard_normal((D, E)).astype(np.float32),
            "sgu": (rng.standard_normal((D, 2 * FF)) / 4).astype(np.float32),
            "sdn": (rng.standard_normal((FF, D)) / 4).astype(np.float32)}


def test_chunk_primitives_match_reference():
    x, _, jd, td = _dispatch_pair(2, capacity_factor=1.0)
    w = _weights(3)
    nc, Ec = 2, E // 2
    slots = Ec * jd.cap
    outs_t, outs_j = [], []
    for c in range(nc):
        jb = jmoe.build_chunk_buf(_j(x), jd.dest, jd.src_tok,
                                  jnp.int32(c * slots), slots)
        tb = tmoe.build_chunk_buf(_t(x), td, c * slots, slots)
        _close(tb.numpy(), jb, f"chunk {c} buffer")
        jg = jmoe.build_chunk_gates(jd.g_sorted, jd.dest, c * slots, slots)
        tg = tmoe.build_chunk_gates(td.g_sorted, td.dest, c * slots, slots)
        _close(tg.numpy(), jg, f"chunk {c} gates")
        sl = slice(c * Ec, (c + 1) * Ec)
        jo = jmoe.expert_ffn(jb.reshape(Ec, jd.cap, D), _j(w["wgu"][sl]),
                             _j(w["wdn"][sl]))
        to = tmoe.expert_ffn(tb.reshape(Ec, td.cap, D), _t(w["wgu"][sl]),
                             _t(w["wdn"][sl]))
        _close(to.numpy(), jo, f"chunk {c} expert_ffn")
        outs_j.append(jo * jg.reshape(Ec, jd.cap, 1))
        outs_t.append(to * tg.reshape(Ec, td.cap, 1))
    jy = jmoe.moe_combine(jnp.concatenate(outs_j), jd)
    ty = tmoe.moe_combine(torch.cat(outs_t), td)
    _close(ty.numpy(), jy, "combine")
    _close(tmoe.moe_ffn_chunked(_t(x), td, _t(w["wgu"]),
                                _t(w["wdn"])).numpy(),
           jmoe.moe_ffn_chunked(_j(x), jd, _j(w["wgu"]), _j(w["wdn"])),
           "moe_ffn_chunked")
    _close(tmoe.shared_ffn(_t(x), _t(w["sgu"]), _t(w["sdn"])).numpy(),
           jmoe.shared_ffn(_j(x), _j(w["sgu"]), _j(w["sdn"])), "shared_ffn")


@pytest.mark.parametrize("shared", [True, False])
def test_moe_mlp_and_its_gradients_match_reference(shared):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = _weights(5)
    names = ["router", "wgu", "wdn"] + (["sgu", "sdn"] if shared else [])

    def jf(x, *ws):
        kw = dict(zip(names, ws))
        o = jmoe.moe_mlp(x, kw["router"], kw["wgu"], kw["wdn"], top_k=K,
                         shared_gate_up=kw.get("sgu"),
                         shared_down=kw.get("sdn"))
        return jnp.sum(o.y * jnp.cos(x)) + o.aux_loss, o

    args = [x] + [w[n] for n in names]
    (jl, jo), jg = jax.value_and_grad(jf, argnums=tuple(range(len(args))),
                                      has_aux=True)(*map(_j, args))
    ta = [_t(a).requires_grad_(True) for a in args]
    kw = dict(zip(names, ta[1:]))
    to = tmoe.moe_mlp(ta[0], kw["router"], kw["wgu"], kw["wdn"], top_k=K,
                      shared_gate_up=kw.get("sgu"),
                      shared_down=kw.get("sdn"))
    tl = torch.sum(to.y * torch.cos(ta[0])) + to.aux_loss
    tg = torch.autograd.grad(tl, ta)
    _close(to.y.detach().numpy(), jo.y, "y")
    _close(float(to.aux_loss.detach()), float(jo.aux_loss), "aux")
    _close(float(to.dropped_frac), float(jo.dropped_frac), "dropped")
    for n, a, b in zip(["x"] + names, tg, jg):
        b = np.asarray(b)
        _close(a.numpy(), b, f"grad {n}", rtol=1e-5,
               atol=1e-6 * max(1.0, np.abs(b).max()))


def test_pair_gather_backward_is_exact_and_repeats():
    """``gather_pairs``' fixed-order sum equals autograd's scatter of
    ``x[src_tok]`` and gives the same bits twice."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((T, D)).astype(np.float32))
    lg = _t(_logits(6))
    disp = tmoe.moe_dispatch(x, lg, top_k=K)
    g = _t(rng.standard_normal((T * K, D)).astype(np.float32))
    outs = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        outs.append(torch.autograd.grad(tmoe.gather_pairs(xx, disp), xx,
                                        g)[0])
    xx = x.clone().requires_grad_(True)
    plain = torch.autograd.grad(xx[disp.src_tok], xx, g)[0]
    assert torch.equal(outs[0], outs[1])
    _close(outs[0].numpy(), plain.numpy(), "pair gather backward")


# ------------------------------------------------- (b) the layer and loss

@pytest.mark.parametrize("arch", MOE)
def test_moe_pre_block_and_routing_match_reference(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jm = JaxModel(jcfg, JaxZeroConfig.local(param_dtype=jnp.float32,
                                            compute_dtype=jnp.float32))
    blocks = step_bars.global_params(
        Model(cfg, ZeroConfig.local(), device="cpu"), 0)["blocks"]
    p = jm.period_spec.unpack(_j(blocks[0]))
    p = {k[2:]: v for k, v in p.items()}
    tp = {k: _t(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(7)
    B, S = 2, 16
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    cos, sin = jl.rope_table(jnp.arange(S), cfg.d_head, cfg.rope_theta)
    tcos, tsin = tl.rope_table(torch.arange(S), cfg.d_head, cfg.rope_theta)
    jout = jtr.moe_pre_block(jcfg, p, _j(h), jtr.RunSpec(mode="train"),
                             {"rope": (cos, sin)}, None)
    tout = ttr.moe_pre_block(cfg, tp, _t(h), RunSpec(mode="train"),
                             {"rope": (tcos, tsin)}, None)
    for name, a, b in zip(("h", "hn2", "logits", "shared_y"), tout, jout):
        _close(a.numpy(), b, name, rtol=1e-5, atol=1e-5)
    lg = np.asarray(jout[2])
    print(f"{arch}: smallest top-{cfg.top_k} margin "
          f"{margin(lg, cfg.top_k):.3e}")
    _, ji = jmoe.route_topk(_j(lg), cfg.top_k)
    _, ti = tmoe.route_topk(tout[2], cfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


STEP_CASES = {"deepseek_off": ("deepseek-moe-16b", {"qgz": False}),
              "deepseek_zeropp": ("deepseek-moe-16b", {}),
              "qwen3_moe_zeropp": ("qwen3-moe-235b-a22b", {})}


# an expert that takes few tokens has gradient elements below ~3e-7, where
# AdamW's first-step direction g / (|g| + eps) turns a 1e-6 relative
# gradient difference into a visible update difference (step_bars
# .params_near's amp term, held element by element); the share of such
# elements allowed is 1 in 100 (a dense stack's: 1 in 1,000)
MOE_FAR_PARAMS = 1e-2


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_loss_and_every_groups_gradient_match_reference(case):
    """The whole MoE ``loss_fn`` on a one-rank world at ring depth 1: the
    loss, gradients of every group (the experts among them) and one AdamW
    step at ``tests/test_torch_train.py``'s bars (qgZ off: 1e-5; full
    ZeRO++: one INT4 step), the parameters at ``MOE_FAR_PARAMS``; the
    ``moe_aux`` metric."""
    arch, over = STEP_CASES[case]
    pair = ttrain._Pair(arch=arch, **over)
    assert pair.model.zcfg.prefetch == 1 and pair.model.is_moe
    batch = pair.batch()
    j_loss, j_grads = pair.ref_grads(batch)
    params, opt = pair.port_state()
    st = build_train_step(pair.model, AdamWConfig(lr=ttrain.LR),
                          device="cpu")
    loss, mets, grads = st.loss_and_grads(params, ttrain._tbatch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5
    assert set(grads) == set(j_grads) and "experts" in grads
    tg = to_numpy(grads)
    qgz = over.get("qgz", True)
    if qgz:
        step_bars.grads_within_int4(tg, j_grads)
    else:
        for k in tg:
            step_bars.close(tg[k], j_grads[k], f"grad {k}")
    jp, jo, jm = pair.ref_step(batch)
    m = st.fn(params, opt, ttrain._tbatch(batch))
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
    np.testing.assert_allclose(float(m["nll"]), jm["nll"], rtol=1e-5)
    np.testing.assert_allclose(float(m["moe_aux"]), jm["moe_aux"],
                               rtol=1e-5)
    tp, to = to_numpy(params), to_numpy(opt)
    if qgz:
        step_bars.moments_within_int4(to, jo)
    else:
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                                   rtol=1e-5)
        for k in tp:
            step_bars.close(to["m"][k], jo["m"][k], f"m {k}")
            step_bars.close(to["v"][k], jo["v"][k], f"v {k}")
    step_bars.params_near(tp, jp, {k: step_bars.moment_dir(to, k)
                                   for k in tp},
                          {k: step_bars.moment_dir(jo, k) for k in tp},
                          ttrain.LR, MOE_FAR_PARAMS)


# ------------------------------------------------------------ (e) serving

@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_match_reference(arch):
    pair = smoke._Pair(arch)
    rng = np.random.default_rng(8)
    batch = smoke._inputs(pair.arch, rng, smoke.B, 0, smoke.S)
    steps_in = [smoke._inputs(pair.arch, rng, smoke.B, smoke.S + i, 1)
                for i in range(smoke.N_DECODE)]
    j_out, t_out = pair.serve(batch, steps_in)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        assert a.shape == b.shape and np.isfinite(a).all()
        _close(a, b, f"{arch} logits {i}", rtol=1e-5, atol=1e-5)


F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)


def _world1(arch="deepseek-moe-16b", prefetch=1, **kw):
    cfg = get_config(arch).reduced(**kw)
    model = Model(cfg, make_policy(cfg, prefetch=prefetch, **F32).zcfg,
                  device="cpu")
    params = {k: v for k, v in model.init_params(
        torch.Generator().manual_seed(2), dtype=torch.float32).items()}
    return model, params


def _serve_logits(model, params):
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 12))).long()
    logits, caches = model.prefill_fn(params, {"tokens": toks},
                                      RunSpec(mode="prefill"))
    from repro_torch.serve import steps
    caches = steps.pad_prefill_caches(model, caches, 16)
    out = [logits]
    tok = logits[:, -1].argmax(-1)[:, None]
    for t in range(3):
        logits, caches = model.decode_fn(params, caches, {"tokens": tok},
                                         12 + t, RunSpec(mode="decode"))
        out.append(logits)
        tok = logits[:, -1].argmax(-1)[:, None]
    return out


def test_serving_ring_equals_the_synchronous_scan_at_world1():
    """Depth 1 (the layer ring with its routing-ahead chunk-0 gather, the
    chunk ring) against depth 0, prefill and decode, bit for bit."""
    m0, params = _world1(prefetch=0)
    m1, _ = _world1(prefetch=1)
    for a, b in zip(_serve_logits(m0, params), _serve_logits(m1, params)):
        assert torch.equal(a, b)


def _engine_tokens(model, params, prompts, n_slots):
    eng = ServeEngine(model, params, n_slots=n_slots, kv_len=64,
                      device="cpu")
    uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run(max_steps=200)
    return [out[u] for u in uids]


@pytest.mark.parametrize("arch", MOE)
def test_slab_engine_serves_each_request_as_alone(arch):
    """Four requests batched in a 4-slot engine at world 1 (prefill at each
    prompt's own length, decode drop-free at ``serve_capacity``) get the
    greedy tokens each gets alone."""
    model, params = _world1(arch)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (3, 9, 17, 30)]
    batched = _engine_tokens(model, params, prompts, 4)
    for p, got in zip(prompts, batched):
        assert len(got) == 6
        assert got == _engine_tokens(model, params, [p], 1)[0]


def test_paged_serving_refuses_moe():
    model, params = _world1()
    with pytest.raises(ValueError, match="attn-only"):
        model.init_paged_caches(4, 16)
    with pytest.raises(ValueError, match="attn-only"):
        ServeEngine(model, params, n_slots=1, kv_len=32, device="cpu",
                    pool="paged")


# ------------------------------------------------------ wire accounting

SIZES = {"data": 2, "model": 2}


def _events(prefetch, hpz=True, variant="zeropp"):
    cfg = get_config("deepseek-moe-16b").reduced(n_layers=4)
    z = make_policy(cfg, variant=variant, prefetch=prefetch, hpz=hpz).zcfg
    return Model(cfg, z, world=4, device="cpu")


def test_comm_events_fold_to_the_references_bytes_at_depth0():
    for hpz in (True, False):
        tm = _events(0, hpz)
        jcfg = jax_get_config("deepseek-moe-16b").reduced(n_layers=4)
        jz = JaxZeroConfig(prefetch=0, hpz=hpz)
        jm = JaxModel(jcfg, jz, world=4)
        assert step_wire_by_label(tm.comm_events(), tm.zcfg, SIZES) == \
            jax_wire(jm.comm_events(), jz, SIZES)


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_comm_events_at_depth_k_drop_the_wrap_around(depth):
    """At depth k the port counts n layer gathers and n·nc chunk gathers
    (the reference n + k and n·(nc + kc)); the routing-ahead gather takes
    chunk 0's place, and with hpZ the recompute rides the hpZ tier."""
    n, nc = 4, 2
    for hpz in (True, False):
        ev = {e["site"]: (e["kind"], e["count"])
              for e in _events(depth, hpz).comm_events()}
        assert ev["blocks.fwd"] == ("fwd_gather", n)
        assert ev["blocks.spec"] == ("fwd_gather", n)
        assert ev["experts.fwd"] == ("fwd_gather", n * (nc - 1))
        assert ev["experts.bwd"] == ("bwd_gather", n * nc)
        assert ev["experts.reduce"] == ("grad_reduce", n * nc)
        if hpz:
            assert ev["blocks.bwd_spec"] == ("bwd_gather", n)
            assert ev["experts.bwd_recompute"] == ("bwd_gather",
                                                   n * (nc - 1))
        else:
            assert "blocks.bwd_spec" not in ev
            assert ev["experts.bwd_recompute"] == ("fwd_gather", n * nc)


# ------------------------------------------ convert, checkpoints, launcher

def test_convert_carries_experts_at_any_rank():
    model, params = _world1()
    g = {k: v.numpy() for k, v in params.items()}
    for world in (1, 2, 4):
        m = Model(model.cfg, model.zcfg, world=world, device="cpu")
        g2 = {k: np.pad(v, [(0, 0)] * (v.ndim - 1) + [
            (0, m.param_shapes()[k][-1] - v.shape[-1])])
            for k, v in g.items()}
        for r in range(world):
            t = params_from_numpy(g2, m, rank=r, world=world)
            np.testing.assert_array_equal(t["experts"].numpy(),
                                          shard_of(g2["experts"], r, world))
            assert to_numpy(t)["experts"].shape == \
                (m.n_periods, m.cfg.expert_chunks,
                 m.expert_spec.padded_size // world)


@pytest.mark.parametrize("fmt", ("fp32", "int8"))
def test_world1_moe_checkpoints_cross_both_ways(tmp_path, fmt):
    """A deepseek-moe-16b reduced checkpoint of each side restores on the
    other (the ``experts`` group in the manifest's layout and the shard
    file, in the reference's format)."""
    path = tstate._cross_both_ways(tmp_path, fmt, "deepseek-moe-16b")
    from repro_torch.train import state as ts
    layout = ts.read_manifest(path)["param_layout"]
    assert [n for n, _ in layout["experts"]["entries"]] == ["egu", "edn"]


def test_launcher_takes_the_moe_flags_and_trains(capsys):
    args = tlaunch.parser().parse_args(
        ["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--steps", "2", "--lr", "3e-3",
         "--lr-schedule", "constant", "--moe-chunks", "4"])
    out = tlaunch.train_loop(args)
    assert out["built"].arch.expert_chunks == 4
    assert out["built"].model.param_shapes()["experts"][:2] == (2, 4)
    assert len(out["losses"]) == len(out["moe_aux"]) == 2
    assert np.isfinite(out["losses"]).all() and \
        np.isfinite(out["moe_aux"]).all()
    assert "moe_aux" in capsys.readouterr().out
