"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package, and runs these phases; any failure exits non-zero before the
last line is printed.

1. Device and build: prints the card's name and power limit (nvidia-smi),
   then compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together).
2. Kernel phase: each kernel at the shapes its paths give it against its
   plain PyTorch version on the same inputs — B1 quantize (bf16 serving
   shards and the fp32 master shards of training), B2 dequantize, and the
   qgZ kernels B3 reorder-quantize, B4 dequant-reduce-requantize and B5
   dequant-reduce (every flat group of qwen3-0.6b with N = 1, the reorder
   shape (Y, X, L) = (2, 8, 1,966,336), and N = 8 at one layer group) all
   bit-identical; B8 dequant-GEMM within fp32 rtol 1e-5, atol
   1e-5·max|out| (summation order) — with its median time (CUDA events, L2
   flushed before every launch, warm-up excluded), the plain version's time
   and the least time the card could take (bytes over 3.35 TB/s or
   operations over the type's peak, whichever is larger).
3. Engine phase: qwen3-0.6b at full width (28 layers, d 1024, vocab
   151936), bf16 weights from a seeded generator, on
   ``ServeEngine(n_slots=4, kv_len=2048)``: six greedy requests (prompts
   7, 33, 120, 257, 600 and 1500 tokens — the last prefills in the 2048
   bucket, through the chunked attention path — 32 new tokens each, so
   slots recycle).  Checks that every request finishes, that each
   request's first-token logits match its own standalone raw prefill,
   that each of the engine's batched decode steps matches the request
   decoded alone on the engine's own tokens (teacher-forced), and that
   every kernel's launch count over the run is > 0 and equals what the
   code issues per model call; prints greedy agreement, TTFT, decode
   tokens/s and ms per decode step.
4. Train-parity phase: qwen3-0.6b widths at 2 layers and a vocabulary of
   8192 (4 unembedding chunks), fp32 compute, full ZeRO++: one
   ``loss_and_grads`` of a batch of 2 × 256 on the card (kernels) and on
   the CPU (plain versions) from the same parameters, held to the rule the
   CPU tests hold the port to against the reference (loss within 1e-5; a
   gradient element beyond rtol 1e-5 / atol 1e-6 only by at most one INT4
   step of its block, in fewer than 1 of 1,000 elements).
5. Train phase: ``repro_torch.launch.train.train_loop`` at full width
   (28 layers, bf16 compute, fp32 master and moments, full ZeRO++ on a
   one-rank ("data", "model") world), 8 steps of ``SyntheticLM`` batches
   of 8 × 2048 tokens at a constant lr of 3e-4.  Checks finite losses, the
   last step's loss below the first's by ``LOSS_DROP``, and that every
   step launches each of B1–B5 exactly once per flat group; prints step
   time (p50 of steps 2–8), tokens/s, peak memory and one profiled step
   (device busy share, device kernels, top device ops).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.core.zeropp import ZeroConfig  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import fused_dequant_reduce_quant as fq  # noqa: E402
from repro_torch.kernels import platform, ref  # noqa: E402
from repro_torch.kernels import quant_block as qb  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serve import ServeEngine, steps  # noqa: E402
from repro_torch.train.policy import make_policy  # noqa: E402
from repro_torch.train.trainer import build_train_step  # noqa: E402

HBM_BYTES_S = 3.35e12          # H100 SXM rated memory bandwidth
F32_OPS_S = 67e12              # fp32 outside the tensor cores
BF16_OPS_S = 989e12            # bf16 dense tensor-core peak
FLUSH_BYTES = 256 << 20        # > 50 MB L2: every timed launch starts cold

PROMPTS = (7, 33, 120, 257, 600, 1500)
MAX_NEW = 32
N_SLOTS, KV_LEN = 4, 2048
# first-token logits, engine (bucket-padded prefill inside a batch of
# requests) vs the request's own unpadded prefill: both bf16 end to end
# through 28 layers, different sequence lengths (and, for the 1500-token
# prompt, the chunked vs the dense attention path), so the rounding of
# every activation differs; logits are ~N(0, 1) at this init
LOGIT_ATOL = 0.25
# decode logits, engine (one batched step over all slots) vs the request
# alone at the same position, fed the engine's own tokens: bf16 again, and
# cuBLAS picks its GEMM kernel by the batch's row count, so the summation
# order differs between M = 4 and M = 1
DECODE_ATOL = 0.25
# flat group sizes of qwen3-0.6b on the training path: one layer group,
# the embedding, one unembedding chunk and the head norm
LAYER_N = 15_730_944
PATH_NS = (LAYER_N, 155_582_464, 38_895_616, 1024)
REORDER_SHAPE = (2, 8, 1_966_336)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 2048, 8, 3e-4
# the loss after 8 steps must lie this far below the first step's: half
# the drop an H100 read over these 8 steps (0.2045)
LOSS_DROP = 0.1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def device_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, flush: torch.Tensor, n: int = 15, warmup: int = 3) -> float:
    """Median device time of fn() over n launches, each from a cold L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_b, t_o = bytes_moved / HBM_BYTES_S, ops / ops_rate
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------- kernels

def kernel_phase(flush: torch.Tensor) -> dict:
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg = QuantConfig(bits=8, block_size=256)
    rec = {}

    # B1 / B2 at every flat-shard shape of the paths (all (1, N) rows, bf16,
    # INT8, block 256): the head norm, one layer group, one unembedding
    # chunk (serving feeds it to the dequant-GEMM, training dequantizes
    # it) and the embedding
    q_err = d_err = 0.0
    for n in (1024, 15_730_944, 38_895_616, 155_582_464):
        x = torch.randn(1, n, generator=g, device=dev).to(torch.bfloat16)
        p, s = qb.quantize(x, cfg)
        pp, sp = quant.quantize_blockwise(x, cfg)
        err = max((p.int() - pp.int()).abs().max().item(),
                  (s - sp).abs().max().item())
        q_err = max(q_err, err)
        if not (torch.equal(p, pp) and torch.equal(s, sp)):
            fail(f"B1 quantize (1, {n}) differs from its plain version "
                 f"(max abs err {err})")
        del pp, sp
        nb = n // 256
        q_ms = median_ms(lambda: qb.quantize(x, cfg), flush)
        q_plain = median_ms(lambda: quant.quantize_blockwise(x, cfg), flush,
                            n=5)
        q_bound = bound(2 * n + n + 4 * nb, 5 * n, F32_OPS_S)
        print(f"B1 quantize   (1, {n}) bf16->int8: bit-identical; "
              f"kernel {q_ms:.4f} ms, plain {q_plain:.4f} ms, "
              f"bound {q_bound[0]:.4f} ms ({q_bound[1]})", flush=True)
        if n == 15_730_944:   # the per-layer shape: 28 launches per call
            rec["quantize_blockwise"] = dict(ms=q_ms, plain_ms=q_plain,
                                             bound=q_bound, shape=(1, n))
        d = qb.dequantize(p, s, cfg, torch.bfloat16)
        dp = quant.dequantize_blockwise(p, s, cfg, torch.bfloat16)
        err = (d.float() - dp.float()).abs().max().item()
        d_err = max(d_err, err)
        if not torch.equal(d, dp):
            fail(f"B2 dequantize (1, {n}) differs from its plain version "
                 f"(max abs err {err})")
        del d, dp
        d_ms = median_ms(lambda: qb.dequantize(p, s, cfg, torch.bfloat16),
                         flush)
        d_plain = median_ms(lambda: quant.dequantize_blockwise(
            p, s, cfg, torch.bfloat16), flush, n=5)
        d_bound = bound(n + 4 * nb + 2 * n, n, F32_OPS_S)
        print(f"B2 dequantize (1, {n}) int8->bf16: bit-identical; "
              f"kernel {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
              f"bound {d_bound[0]:.4f} ms ({d_bound[1]})", flush=True)
        if n == 15_730_944:
            rec["dequantize_blockwise"] = dict(
                ms=d_ms, plain_ms=d_plain, bound=d_bound, shape=(1, n))
        del x, p, s

    # small INT4 and stochastic-rounding (u field) cases, bit-identical
    for bits, dtype, with_u in ((4, torch.bfloat16, False),
                                (4, torch.float32, True),
                                (8, torch.bfloat16, True)):
        c = QuantConfig(bits=bits, block_size=256)
        x = torch.randn(3, 8192, generator=g, device=dev).to(dtype)
        u = torch.rand(3, 8192, generator=g, device=dev) if with_u else None
        p, s = qb.quantize(x, c, u)
        pp, sp = quant.quantize_blockwise(x, c, u)
        d = qb.dequantize(p, s, c, torch.bfloat16)
        dp = quant.dequantize_blockwise(p, s, c, torch.bfloat16)
        q_err = max(q_err, (p.int() - pp.int()).abs().max().item(),
                    (s - sp).abs().max().item())
        d_err = max(d_err, (d.float() - dp.float()).abs().max().item())
        if not (torch.equal(p, pp) and torch.equal(s, sp)
                and torch.equal(d, dp)):
            fail(f"B1/B2 INT{bits} {dtype} u={with_u} differ from plain")
    print("B1/B2 INT4, f32 input and u-field cases: bit-identical",
          flush=True)

    # B8 at the head's decode shape (T = n_slots rows, one vocab chunk,
    # NB = d/256 scale groups) and the broadcast layout (NB = 1)
    errs = []
    for T, N, K, NB in ((4, 37984, 1024, 4), (1, 37984, 1024, 4),
                        (3, 4096, 64, 1)):
        x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(N, NB, generator=g, device=dev) * 0.01
        out = dm.dequant_matmul(x, w, sc)
        want = ref.dequant_matmul_ref(x, w, sc)
        if not torch.isfinite(out).all():
            fail("B8 produced non-finite values")
        err = (out - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        if not torch.allclose(out, want, rtol=1e-5, atol=tol):
            fail(f"B8 T={T} N={N} K={K} NB={NB}: max err {err} > tol")
        errs.append(err)
        line = f"B8 dequant_matmul T={T} N={N} K={K} NB={NB}: max abs err " \
               f"{err:.3e} (tol rtol 1e-5, atol {tol:.3e})"
        if (T, NB) == (4, 4):
            ms = median_ms(lambda: dm.dequant_matmul(x, w, sc), flush)
            plain = median_ms(lambda: ref.dequant_matmul_ref(x, w, sc),
                              flush, n=5)
            b8 = bound(N * K + 4 * N * NB + 2 * T * K + 4 * T * N,
                       2 * T * N * K, BF16_OPS_S)
            rec["dequant_matmul"] = dict(ms=ms, plain_ms=plain, bound=b8,
                                         shape=(T, N, K, NB))
            line += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, " \
                    f"bound {b8[0]:.4f} ms ({b8[1]})"
        print(line, flush=True)
    rec["dequant_matmul"]["max_abs_err"] = max(errs)
    rec["quantize_blockwise"]["max_abs_err"] = q_err
    rec["dequantize_blockwise"]["max_abs_err"] = d_err
    torch.cuda.synchronize()
    return rec


def _err(a, b) -> float:
    """Max abs difference of two tensors, read as integers or floats."""
    if not a.is_floating_point():
        a, b = a.int(), b.int()
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def _same(name, shape, got, want) -> float:
    """Fail unless the kernel's outputs equal the plain version's bit for
    bit; return the max abs error read from the compared tensors."""
    err = max(_err(g, w) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name} {shape} differs from its plain version (max abs err "
             f"{err})")
    return err


def qgz_kernel_phase(flush: torch.Tensor) -> dict:
    """B1 on fp32 master shards and the qgZ kernels B3, B4, B5, each at
    every flat group of the training path (N = 1), B3 at a reordering
    shape and B4/B5 at N = 8; bit-identical to the plain versions."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    c8, c4 = QuantConfig(8, 256), QuantConfig(4, 256)
    rec = {}
    errs = {"quantize_reordered": 0.0, "dequant_reduce_quant": 0.0,
            "dequant_reduce": 0.0}

    def timed(name, n, fn, plain, nbytes, ops):
        ms = median_ms(fn, flush)
        plain_ms = median_ms(plain, flush, n=5)
        b = bound(nbytes, ops, F32_OPS_S)
        print(f"{name} n={n}: bit-identical; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound=b)

    for n in PATH_NS:
        nb = n // 256
        # B1: the qwZ quantize of an fp32 master shard (training)
        x = torch.randn(1, n, generator=g, device=dev) * 0.02
        b1_err = _same("B1 quantize f32", (1, n), qb.quantize(x, c8),
                       quant.quantize_blockwise(x, c8))
        r = timed("B1 quantize f32->int8", n, lambda: qb.quantize(x, c8),
                  lambda: quant.quantize_blockwise(x, c8),
                  4 * n + n + 4 * nb, 5 * n)
        if n == LAYER_N:
            rec["quantize_blockwise_f32"] = dict(r, shape=(1, n))
        rec.setdefault("quantize_blockwise_f32", {})
        rec["quantize_blockwise_f32"]["max_abs_err"] = max(
            b1_err, rec["quantize_blockwise_f32"].get("max_abs_err", 0.0))
        del x
        # B3: the bf16 gradient of the group, quantized to INT4 (Y = X = 1)
        gr = (torch.randn(1, 1, n, generator=g, device=dev) * 1e-3).to(
            torch.bfloat16)
        p3 = qb.quantize_reordered(gr, c4)
        errs["quantize_reordered"] = max(errs["quantize_reordered"], _same(
            "B3 quantize_reordered", (1, 1, n), p3,
            ref.quantize_reordered_ref(gr, c4)))
        r3 = timed("B3 quantize_reordered bf16->int4", n,
                   lambda: qb.quantize_reordered(gr, c4),
                   lambda: ref.quantize_reordered_ref(gr, c4),
                   2 * n + n // 2 + 4 * nb, 5 * n)
        del gr
        # B4 then B5 on that payload, N = 1, as the 2-hop reduce runs them
        pay, sc = p3[0].reshape(1, -1), p3[1].reshape(1, -1)
        p4 = fq.dequant_reduce_quant(pay, sc, c4, c4)
        errs["dequant_reduce_quant"] = max(
            errs["dequant_reduce_quant"],
            _same("B4 dequant_reduce_quant", (1, n), p4,
                  ref.dequant_reduce_quant_ref(pay, sc, c4, c4)))
        r4 = timed("B4 dequant_reduce_quant N=1 int4->int4", n,
                   lambda: fq.dequant_reduce_quant(pay, sc, c4, c4),
                   lambda: ref.dequant_reduce_quant_ref(pay, sc, c4, c4),
                   2 * (n // 2 + 4 * nb), 8 * n)
        pay5, sc5 = p4[0].reshape(1, -1), p4[1].reshape(1, -1)
        out = fq.dequant_reduce(pay5, sc5, c4)
        errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
            "B5 dequant_reduce", (1, n), (out,),
            (ref.dequant_reduce_ref(pay5, sc5, c4),)))
        r5 = timed("B5 dequant_reduce N=1 int4->f32", n,
                   lambda: fq.dequant_reduce(pay5, sc5, c4),
                   lambda: ref.dequant_reduce_ref(pay5, sc5, c4),
                   n // 2 + 4 * nb + 4 * n, 3 * n)
        if n == LAYER_N:
            rec["quantize_reordered"] = dict(r3, shape=(1, 1, n))
            rec["dequant_reduce_quant"] = dict(r4, shape=(1, n // 2))
            rec["dequant_reduce"] = dict(r5, shape=(1, n // 2))
        del p3, p4, pay, sc, pay5, sc5, out

    # B3 where a wrong index would show: Y, X > 1, with and without a u field
    gr = (torch.randn(*REORDER_SHAPE, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    Y, X, L = REORDER_SHAPE
    u = torch.rand(X, Y, L, generator=g, device=dev)
    for field in (None, u):
        errs["quantize_reordered"] = max(errs["quantize_reordered"], _same(
            "B3 quantize_reordered", REORDER_SHAPE,
            qb.quantize_reordered(gr, c4, field),
            ref.quantize_reordered_ref(gr, c4, field)))
    n = Y * X * L
    timed(f"B3 quantize_reordered {REORDER_SHAPE}", n,
          lambda: qb.quantize_reordered(gr, c4),
          lambda: ref.quantize_reordered_ref(gr, c4),
          2 * n + n // 2 + 4 * (n // 256), 5 * n)
    del gr, u

    # B4 / B5 with N = 8 contributions (the paper's node) at a layer group
    n, N = LAYER_N, 8
    nb = n // 256
    x8 = torch.randn(N, n, generator=g, device=dev) * 1e-3
    pay, sc = quant.quantize_blockwise(x8, c4)
    del x8
    u = torch.rand(n, generator=g, device=dev)
    for field in (None, u):
        errs["dequant_reduce_quant"] = max(
            errs["dequant_reduce_quant"],
            _same("B4 dequant_reduce_quant", (N, n), fq.dequant_reduce_quant(
                pay, sc, c4, c4, field),
                  ref.dequant_reduce_quant_ref(pay, sc, c4, c4, field)))
    errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
        "B5 dequant_reduce", (N, n), (fq.dequant_reduce(pay, sc, c4),),
        (ref.dequant_reduce_ref(pay, sc, c4),)))
    timed("B4 dequant_reduce_quant N=8", n,
          lambda: fq.dequant_reduce_quant(pay, sc, c4, c4),
          lambda: ref.dequant_reduce_quant_ref(pay, sc, c4, c4),
          N * (n // 2 + 4 * nb) + n // 2 + 4 * nb, (2 * N + 6) * n)
    timed("B5 dequant_reduce N=8", n, lambda: fq.dequant_reduce(pay, sc, c4),
          lambda: ref.dequant_reduce_ref(pay, sc, c4),
          N * (n // 2 + 4 * nb) + 4 * n, (2 * N + 1) * n)
    del pay, sc, u
    for k, e in errs.items():
        rec[k]["max_abs_err"] = e
    torch.cuda.synchronize()
    return rec


# ----------------------------------------------------------------- engine

def engine_phase() -> dict:
    cfg = get_config("qwen3-0.6b")
    z = ZeroConfig(dp_axes=("model",))            # qwZ on, world 1, bf16
    model = Model(cfg, z, world=1, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = model.init_params(g)
    n_params = sum(int(np.prod(s)) for s in model.param_shapes().values())
    print(f"engine: {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {n_params} flat params bf16, "
          f"{model.unemb_chunks} head chunks", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPTS]

    # warm-up (library load, cuBLAS handles, allocator) outside the count
    warm = ServeEngine(model, params, n_slots=1, kv_len=KV_LEN)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run(max_steps=10)
    torch.cuda.synchronize()

    eng = ServeEngine(model, params, n_slots=N_SLOTS, kv_len=KV_LEN)
    calls = {"prefill": 0, "decode": 0}
    first_logits = []
    pre, dec = eng._prefill, eng._decode

    def prefill_fn(*a):
        calls["prefill"] += 1
        logits, caches = pre.fn(*a)
        first_logits.append(logits[0, 0].float().clone())
        return logits, caches

    # per request, the engine's decode logits of its j-th token: j -> (V,)
    step_logits: dict = {}

    def decode_fn(*a):
        calls["decode"] += 1
        logits, caches = dec.fn(*a)
        for act in eng.slots:
            if act is not None:
                step_logits.setdefault(act.req.uid, {})[act.n_gen] = \
                    logits[act.slot, 0].float().clone()
        return logits, caches

    eng._prefill = steps.ServeStep(fn=prefill_fn, run_spec=pre.run_spec)
    eng._decode = steps.ServeStep(fn=decode_fn, run_spec=dec.run_spec)
    uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    platform.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(platform.LAUNCHES)

    for u, n in zip(uids, PROMPTS):
        if eng.status[u] != "done" or len(res[u]) != MAX_NEW:
            fail(f"request {u} (prompt {n}) did not finish: "
                 f"{eng.status[u]}, {len(res[u])} tokens")
    model_calls = calls["prefill"] + calls["decode"]
    # per model call: qwZ gathers of embed + every layer group + head norm
    # (quantize + dequantize each) and of every unemb chunk (quantize
    # only, consumed by one dequant-GEMM each)
    per_call = {"quantize_blockwise": 1 + cfg.n_layers + 1
                + model.unemb_chunks,
                "dequantize_blockwise": 1 + cfg.n_layers + 1,
                "dequant_matmul": model.unemb_chunks}
    for k, per in per_call.items():
        if launches[k] <= 0 or launches[k] != per * model_calls:
            fail(f"{k}: {launches[k]} launches, expected {per} x "
                 f"{model_calls} model calls")
    print(f"engine: {len(uids)} requests done, {calls['prefill']} prefills "
          f"+ {calls['decode']} batched decode steps in {wall:.3f} s; "
          f"launches {launches} (= per-call {per_call} x {model_calls})",
          flush=True)

    # each request alone: raw prefill at its exact length, then decode
    # teacher-forced on the engine's own tokens, so every one of the
    # engine's batched decode steps is held against the same request run
    # alone at the same positions
    ps = steps.build_prefill_step(model)
    ds = steps.build_decode_step(model)
    worst = dec_worst = 0.0
    shift_min = float("inf")
    agree = decisive = decisive_agree = 0
    for i, (u, p) in enumerate(zip(uids, prompts)):
        toks = res[u]
        logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
            p[None, :]).long().cuda()})
        want = logits[0, -1].float()
        if not torch.isfinite(want).all() or want.shape != (cfg.vocab,):
            fail(f"request {u}: standalone prefill logits bad")
        err = (first_logits[i] - want).abs().max().item()
        worst = max(worst, err)
        if err > LOGIT_ATOL:
            fail(f"request {u} (prompt {len(p)}): first-token logits differ "
                 f"from its standalone prefill by {err} > {LOGIT_ATOL}")
        caches = steps.pad_prefill_caches(caches, KV_LEN)
        same = int(int(want.argmax()) == toks[0])
        req_err = 0.0
        for j in range(1, MAX_NEW):
            prev = want
            lg, caches = ds.fn(params, caches,
                               {"tokens": torch.tensor([[toks[j - 1]]],
                                                       device="cuda")},
                               torch.tensor([len(p) + j - 1], device="cuda"))
            want = lg[0, -1].float()
            got = step_logits[u][j]
            req_err = max(req_err, (got - want).abs().max().item())
            # what an engine one position behind would have produced
            shift_min = min(shift_min, (got - prev).abs().max().item())
            same += int(int(want.argmax()) == toks[j])
            top2 = torch.topk(want, 2).values
            if (top2[0] - top2[1]).item() > 2 * DECODE_ATOL:
                decisive += 1
                decisive_agree += int(int(want.argmax()) == toks[j])
        dec_worst = max(dec_worst, req_err)
        agree += same
        print(f"  request {u} prompt {len(p):5d}: first-token logits max "
              f"abs diff {err:.4f}; teacher-forced decode logits max abs "
              f"diff {req_err:.4f}; greedy agreement {same}/{MAX_NEW}",
              flush=True)
    total = len(uids) * MAX_NEW
    print(f"engine: batched decode vs each request alone (teacher-forced): "
          f"logits max abs diff {dec_worst:.4f} (bar {DECODE_ATOL}); a "
          f"one-position slip would differ by at least {shift_min:.4f}; "
          f"greedy agreement {agree}/{total}, {decisive_agree}/{decisive} "
          f"where the top-2 gap exceeds {2 * DECODE_ATOL}", flush=True)
    if dec_worst > DECODE_ATOL:
        fail(f"batched decode logits differ from the request alone by "
             f"{dec_worst} > {DECODE_ATOL}")
    if shift_min <= DECODE_ATOL:
        fail(f"the decode check cannot tell a one-position slip "
             f"({shift_min}) from rounding ({DECODE_ATOL})")
    if decisive_agree != decisive:
        fail(f"greedy tokens differ at {decisive - decisive_agree} decisive "
             f"steps")
    profile_decode(dec.fn, params, eng.pool.caches,
                   [len(p) for p in prompts[:N_SLOTS]])
    st = eng.stats()
    print(f"engine: first-token logits vs standalone prefill max abs diff "
          f"{worst:.4f} (bar {LOGIT_ATOL})", flush=True)
    print(f"engine: TTFT p50 {st['ttft_ms']['p50']:.2f} ms (p90 "
          f"{st['ttft_ms']['p90']:.2f}), decode {st['tok_per_s']:.1f} tok/s,"
          f" {st['tok_latency_ms']['p50']:.3f} ms per decode step (p50)",
          flush=True)
    return launches


def _grads_within_one_int4_step(got: dict, want: dict) -> tuple:
    """The CPU tests' rule: every gradient element within rtol 1e-5 / atol
    1e-6 of ``want``, or off by at most one INT4 step of its 256-block
    (the block's absmax / 7), the latter in fewer than 1 of 1,000."""
    n_far = n = 0
    worst = 0.0
    for k in want:
        a = got[k].detach().float().cpu().reshape(-1, 256)
        b = want[k].detach().float().cpu().reshape(-1, 256)
        step = b.abs().amax(dim=1, keepdim=True) / 7
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        if not bool((d <= step * (1 + 1e-5) + 1e-12).all()):
            fail(f"grad {k}: an element is off by more than one INT4 step")
        n_far += int((d > 1e-6 + 1e-5 * b.abs()).sum())
        n += a.numel()
    if n_far >= n / 1000:
        fail(f"{n_far} of {n} gradient elements beyond rtol 1e-5 / atol 1e-6")
    return n_far, n, worst


def train_parity_phase() -> None:
    """One loss_and_grads of the full ZeRO++ step on the card and on the
    CPU, same fp32 parameters and batch (qwen3-0.6b widths, 2 layers,
    vocab 8192 in 4 chunks, batch 2 x 256, fp32 compute)."""
    import dataclasses
    from repro_torch.data.synthetic import SyntheticLM
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              vocab=8192, unemb_chunks=4)
    pol = make_policy(cfg, variant="zeropp", param_dtype=torch.float32,
                      compute_dtype=torch.float32, reduce_dtype=torch.float32)
    cpu_model = Model(cfg, pol.zcfg, device="cpu")
    params = cpu_model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float32)
    lm = SyntheticLM(vocab=cfg.vocab, seq_len=256, seed=7)
    out = {}
    for dev in ("cuda", "cpu"):
        model = cpu_model if dev == "cpu" else Model(cfg, pol.zcfg,
                                                     device=dev)
        st = build_train_step(model, AdamWConfig(), device=dev)
        batch = train_launch.device_batch(cfg, lm, 0, 2, 1, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        platform.reset_launches()
        loss, _, grads = st.loss_and_grads(p, batch)
        launches = dict(platform.LAUNCHES)
        out[dev] = (float(loss), grads)
        if dev == "cuda":
            groups = 1 + cfg.n_layers + 1 + model.unemb_chunks
            want = {k: (0 if k == "dequant_matmul" else groups)
                    for k in launches}
            if launches != want:
                fail(f"train parity: launches {launches}, expected {want}")
    dl = abs(out["cuda"][0] - out["cpu"][0])
    if not (np.isfinite(out["cuda"][0]) and dl <= 1e-5):
        fail(f"train parity: loss {out['cuda'][0]} (card) vs "
             f"{out['cpu'][0]} (CPU)")
    n_far, n, worst = _grads_within_one_int4_step(out["cuda"][1],
                                                  out["cpu"][1])
    print(f"train parity ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, batch 2 x 256, fp32): loss card {out['cuda'][0]:.6f}"
          f" vs CPU {out['cpu'][0]:.6f} (|diff| {dl:.2e} <= 1e-5); grads: "
          f"{n_far} of {n} elements beyond rtol 1e-5 / atol 1e-6, max abs "
          f"diff {worst:.3e}, none beyond one INT4 step", flush=True)


def train_phase() -> dict:
    """The full-width ZeRO++ training run through the launcher's loop."""
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    cfg, model = built.arch, built.model
    groups = 1 + cfg.n_layers + 1 + model.unemb_chunks
    per_step = {k: (0 if k == "dequant_matmul" else groups)
                for k in launches}
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"train step {i}: launches {c}, expected {per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] - LOSS_DROP:
        fail(f"loss did not fall by {LOSS_DROP}: {losses}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {model.n_params()} params "
          f"fp32 master + fp32 moments, full ZeRO++ (qwZ INT8, hpZ, qgZ "
          f"INT4 2-hop) on a one-rank world, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, constant lr {TRAIN_LR}", flush=True)
    print(f"train: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}, bar {LOSS_DROP}); entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"train: step p50 (steps 2-{TRAIN_STEPS}) {p50 * 1e3:.1f} ms, "
          f"{tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches per "
          f"step {per_step} x {TRAIN_STEPS} steps", flush=True)
    batch = train_launch.device_batch(cfg, built.lm, TRAIN_STEPS,
                                      TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 "train step")
    return launches


def profile_decode(decode, params, caches, positions) -> None:
    """Where a batched decode step's time goes (see profile_step)."""
    batch = {"tokens": torch.zeros((N_SLOTS, 1), dtype=torch.long,
                                   device="cuda")}
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    profile_step(lambda: decode(params, caches, batch, pos),
                 f"decode step, {N_SLOTS} slots at positions {positions}",
                 n=3)


def profile_step(step, what: str, n: int = 1) -> None:
    """Host wall per ``step()`` (synchronized, no profiler, after one
    warm-up call), then device busy time, device kernels and the top
    device ops per step from torch.profiler over n more calls."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile ({what}): host wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of the wall), "
          f"{len(dev) / n:.0f} device kernels/step", flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms/step  {name[:90]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    print(device_line(), flush=True)
    t0 = time.perf_counter()
    logs = platform.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}.cu: {len(regs)} kernels, at most {max(regs)} "
              f"registers per thread, {spills} bytes spilled", flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec = kernel_phase(flush)
    rec.update(qgz_kernel_phase(flush))
    rec["quantize_blockwise"]["max_abs_err"] = max(
        rec["quantize_blockwise"]["max_abs_err"],
        rec["quantize_blockwise_f32"]["max_abs_err"])
    del flush
    by_path = {"serve": engine_phase()}
    train_parity_phase()
    by_path["train"] = train_phase()

    # each kernel's path(s): it must have launched in every one of them
    paths = {"quantize_blockwise": ("serve", "train"),
             "dequantize_blockwise": ("serve", "train"),
             "quantize_reordered": ("train",),
             "dequant_reduce_quant": ("train",),
             "dequant_reduce": ("train",),
             "dequant_matmul": ("serve",)}
    for name, ps in paths.items():
        for pth in ps:
            if by_path[pth][name] <= 0:
                fail(f"{name} was not launched on the {pth} path")
    cu = "src/repro_torch/kernels/csrc/"
    srcs = {"quantize_blockwise": (cu + "quant_block.cu",
                                   "src/repro/kernels/quant_block.py:106"),
            "dequantize_blockwise": (cu + "quant_block.cu",
                                     "src/repro/kernels/quant_block.py:170"),
            "quantize_reordered": (cu + "quant_block.cu",
                                   "src/repro/kernels/quant_block.py:217"),
            "dequant_reduce_quant": (
                cu + "fused_dequant_reduce_quant.cu",
                "src/repro/kernels/fused_dequant_reduce_quant.py:104"),
            "dequant_reduce": (
                cu + "fused_dequant_reduce_quant.cu",
                "src/repro/kernels/fused_dequant_reduce_quant.py:73"),
            "dequant_matmul": (cu + "dequant_matmul.cu",
                               "src/repro/kernels/dequant_matmul.py:58")}
    kernels = []
    for name, (src, replaces) in srcs.items():
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path[p][name] for p in paths[name]),
                        "launches_by_path": {p: by_path[p][name]
                                             for p in paths[name]},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": None,
                        "shape": list(r["shape"])})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
