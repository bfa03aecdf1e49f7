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
   operations over the type's peak, whichever is larger).  Then the flash
   pair: B6 forward and B7 backward in bf16 (the tensor-core kernels) at
   the training path's shape (B 8, S 2048, H 16, K 8, hd 128, causal)
   and at five small shapes that reach what the path does not (window 300
   with softcap 30, non-causal, Sq < S, hd 16 and 64, GQA groups 1, 2 and
   4), against the plain versions (element by element,
   ``repro_torch.testing.flash_bars``: out within 2^-7 of its row's sum
   p|v|/l plus one bf16 ulp, m and l within 2e-5; dq, dk, dv within one
   bf16 ulp plus 3e-5; and the out bar must be one that a kv tile dropped
   or counted twice in the last q tile would exceed), and at (B 1, S
   1024) in fp32 (the FFMA kernels) at the reference's bars (2e-5
   forward, 3e-5 backward), plain causal and with a window and a softcap;
   two launches on the same inputs must give the same bits.  Beside their
   times: SDPA's at the same shape (forward, and backward), a yardstick
   that the port never calls, and both routes' times at (B 1, S 1024).
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
   ``loss_and_grads`` on the card (kernels) and on the CPU (plain
   versions) from the same parameters, of a batch of 2 × 256 with plain
   attention and of 2 × 512 with ``attn_impl="pallas"`` (through B6/B7),
   each held to the rule the CPU tests hold the port to against the
   reference (loss within 1e-5; a gradient element beyond rtol 1e-5 /
   atol 1e-6 only by at most one INT4 step of its block, in fewer than 1
   of 1,000 elements), with the step read on both sides' block scales,
   which must agree to rtol 1e-5.
5. Train phase: ``repro_torch.launch.train.train_loop`` at full width
   (28 layers, bf16 compute, fp32 master and moments, full ZeRO++ on a
   one-rank ("data", "model") world), 8 steps of ``SyntheticLM`` batches
   of 8 × 2048 tokens at a constant lr of 3e-4, first with ``--attn
   pallas`` (this slice's path: every layer's attention through the flash
   kernels), then with ``--attn xla`` from the same seed on the same
   batches.  Checks finite losses, the last step's loss below the first's
   by ``LOSS_DROP``, the two runs' step-1 losses within
   ``ROUTE_LOSS_ATOL``, and that every step launches each of B1–B5
   exactly once per flat group and, under pallas, B6 twice and B7 once
   per layer; prints step time (p50 of steps 2–8), tokens/s, peak memory
   and one profiled step (device busy share, device kernels, top device
   ops) of each run.

The line before the last is the kernels' JSON record (every kernel: its
launches on each path, its error against the plain version, its time, the
plain version's, its bound and, for B6/B7, SDPA's); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_dequant_reduce_quant as fq  # noqa: E402
from repro_torch.kernels import platform, ref  # noqa: E402
from repro_torch.kernels import quant_block as qb  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.testing import flash_bars  # noqa: E402
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
# the training path's attention: (B, S, H, K, hd) of qwen3-0.6b at 8 x 2048
FLASH_SHAPE = (8, 2048, 16, 8, 128)
# the fp32 checks of the flash pair, at the reference's own bars
FLASH_F32_SHAPE = (1, 1024, 16, 8, 128)
FLASH_WINDOW, FLASH_SOFTCAP = 300, 30.0
# bf16 cases the path shape does not reach: (B, Sq, S, H, K, hd, causal,
# window, softcap)
FLASH_BF16_CASES = (
    (1, 1024, 1024, 16, 8, 128, True, FLASH_WINDOW, FLASH_SOFTCAP),
    (1, 1024, 1024, 16, 8, 128, False, 0, 0.0),     # non-causal
    (1, 512, 1024, 16, 8, 128, True, 0, 0.0),       # Sq < S
    (1, 1024, 1024, 16, 16, 16, True, 0, 0.0),      # hd 16, GQA 1
    (1, 1024, 1024, 16, 4, 64, True, 0, 0.0),       # hd 64, GQA 4
)
FLASH_TILE = fa.TILE          # the kernels' q and kv tile
# step-1 losses of the two attention routes: bf16 through 28 layers, with
# kv tiles summed in other orders (64-wide vs 1024-wide chunks)
ROUTE_LOSS_ATOL = 1e-2
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
    return bound_mixed(bytes_moved, ((ops, ops_rate),))


def bound_mixed(bytes_moved: float, work) -> tuple:
    """As :func:`bound`, for work ((ops, rate), ...) of several types."""
    t_b = bytes_moved / HBM_BYTES_S
    t_o = sum(ops / rate for ops, rate in work)
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


# ------------------------------------------------------------------ flash

def _flash_inputs(g, shape, dtype, Sq=None):
    """q, k, v, dO for (B, S, H, K, hd); q and dO of Sq rows (default S)."""
    B, S, H, K, hd = shape
    return [torch.randn(B, n_s, n, hd, generator=g, device="cuda").to(dtype)
            for n_s, n in ((Sq or S, H), (S, K), (S, K), (Sq or S, H))]


def _max_err(got, want) -> float:
    """Max abs difference of two tensors, in fp32."""
    return (got.float() - want.float()).abs().max().item()


def _causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def _dropped_tile_reading(q, k, v, want, bar, scale: float) -> tuple:
    """How far out the causal forward of the last q tile moves, in units
    of B6's bar, when its diagonal kv tile is dropped or counted twice:
    the fault a kv loop that ends one tile early, or repeats one, makes.
    Dense fp32 plain attention on those rows, with each key weighted 1, 0
    or 2; returns (max |Δ|/bar dropped, max |Δ|/bar doubled)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rows = slice(S - FLASH_TILE, S)
    qg = q[:, rows].float().reshape(B, FLASH_TILE, K, H // K, hd)
    lg = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    lg = lg.masked_fill(pos[None, :] > pos[rows, None], ref.NEG_INF)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    tile = (pos >= S - FLASH_TILE).float()

    def attend(weight):
        pw = p * weight
        o = torch.einsum("bkrqs,bskd->bqkrd", pw / pw.sum(-1, keepdim=True),
                         v.float())
        return o.reshape(B, FLASH_TILE, H, hd)
    good = attend(torch.ones_like(tile))
    return tuple(((attend(1 + c * tile) - good).abs() / bar[:, rows]).max()
                 .item() for c in (-1.0, 1.0))


def _hold_bf16(tag: str, q, k, v, do, kw: dict):
    """B6/B7 in bf16 (the tensor-core kernels) against their plain
    versions on the same inputs, element by element: out within what the
    two sides' bf16 roundings of p and of out can account for
    (testing/flash_bars.py: 2^-7 of the row's sum p|v|/l plus one ulp), m
    and l within 2e-5 (fp32 sums in another order); dq/dk/dv from the
    kernel's own saved (out, m, l), fp32 inside both (the reference's fp32
    bar, 3e-5) plus one bf16 ulp for the rounding.  Two launches on the
    same inputs must give the same bits (no atomics).  Returns ((out, m,
    l), the plain out, its bar, the forward's and the backward's max abs
    error)."""
    out, m, l = fa.flash_fwd(q, k, v, **kw)
    want = ref.flash_fwd_ref(q, k, v, **kw)
    bar = flash_bars.out_bar(q, k, v, want[0], **kw)
    r_out, e_out = flash_bars.worst(out, want[0], bar)
    if not torch.isfinite(out).all() or r_out > 1:
        fail(f"B6 {tag}: out differs from its plain version beyond its "
             f"per-element bar ({r_out:.3f} x the bar, max abs err {e_out})")
    for name, a, b in (("m", m, want[1]), ("l", l, want[2])):
        if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
            fail(f"B6 {tag}: {name} differs from its plain version beyond "
                 f"2e-5 (max abs err {_max_err(a, b)})")
    fwd_err = max(e_out, *(_max_err(a, b) for a, b in
                           ((m, want[1]), (l, want[2]))))
    grads = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
    wgrads = ref.flash_bwd_ref(q, k, v, out, m, l, do, **kw)
    bwd_err, bwd_read = 0.0, []
    for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
        r, e = flash_bars.worst(a, b, flash_bars.grad_bar(b))
        bwd_err = max(bwd_err, e)
        bwd_read.append(f"{name} {e:.3e} ({r:.3f} x bar)")
        if not torch.isfinite(a).all() or r > 1:
            fail(f"B7 {tag}: {name} differs from its plain version beyond "
                 f"its per-element bar ({r:.3f} x the bar, max abs err {e})")
    del wgrads
    again = fa.flash_fwd(q, k, v, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, (out, m, l))):
        fail(f"B6 {tag}: two launches on the same inputs differ")
    again = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, grads)):
        fail(f"B7 {tag}: two launches on the same inputs differ")
    print(f"B6/B7 {tag} bf16: out max abs err {e_out:.3e} ({r_out:.3f} x "
          f"its per-element bar), m/l within 2e-5; B7 max abs err "
          f"{', '.join(bwd_read)}; both bit-identical across two launches",
          flush=True)
    return (out, m, l), want[0], bar, fwd_err, bwd_err


def flash_kernel_phase(flush: torch.Tensor) -> dict:
    """B6/B7 against their plain versions: bf16 (tensor cores) at the
    training path's shape and at small shapes that reach window, softcap,
    non-causal, Sq < S, hd 16/64 and GQA 1/2/4; fp32 (FFMA) at a smaller
    shape (plain causal, and with window and softcap); two launches bit
    for bit; times against the bound and SDPA, and both routes at (1,
    1024)."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the plain fp32 versions would not be fp32")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    rec = {}
    B, S, H, K, hd = FLASH_SHAPE
    q, k, v, do = _flash_inputs(g, FLASH_SHAPE, torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=True)
    print("bars: out 2^-7 x (sum p|v|/l + |out|) x 1.01; dq/dk/dv 2^-7 x "
          "1.01 x |grad| + 3e-5 x (1 + |grad|)", flush=True)
    (out, m, l), want, bar, fwd_err, bwd_err = _hold_bf16(
        f"{FLASH_SHAPE} causal", q, k, v, do, kw)
    fault = _dropped_tile_reading(q, k, v, want, bar, kw["scale"])
    del want, bar
    print(f"B6 bar's reach, plain fp32 rows {S - FLASH_TILE}..{S - 1}: the "
          f"diagonal kv tile dropped reads {fault[0]:.2f} x the bar, counted "
          f"twice {fault[1]:.2f} x", flush=True)
    if min(fault) <= 1:
        fail(f"B6's bar would not catch a dropped or doubled kv tile: "
             f"{fault}")
    for Bc, Sq, Sc, Hc, Kc, hdc, causal, window, softcap in FLASH_BF16_CASES:
        cq, ck, cv, cdo = _flash_inputs(g, (Bc, Sc, Hc, Kc, hdc),
                                        torch.bfloat16, Sq=Sq)
        ckw = dict(scale=hdc ** -0.5, causal=causal, window=window,
                   softcap=softcap)
        tag = (f"(B {Bc}, Sq {Sq}, S {Sc}, H {Hc}, K {Kc}, hd {hdc}) "
               f"causal {causal} window {window} softcap {softcap}")
        res = _hold_bf16(tag, cq, ck, cv, cdo, ckw)
        fwd_err, bwd_err = max(fwd_err, res[3]), max(bwd_err, res[4])
        del res, cq, ck, cv, cdo

    # times at the path shape
    pairs = B * H * _causal_pairs(S)
    prod = 2 * hd * pairs                     # one causal product
    qb, kb = B * S * H * hd * 2, B * S * K * hd * 2
    b6 = bound_mixed(2 * qb + 2 * kb + 8 * B * H * S,
                     ((2 * prod, BF16_OPS_S),))
    # B7: QK^T and dO.V^T on bf16 inputs, and dl.K, p^T.dO, dl^T.Q with p
    # and dl as bf16 hi + lo pairs: 2 tensor-core products each
    n_prod = 2 + 3 * 2
    b7_bytes = 4 * qb + 4 * kb + 8 * B * H * S
    b7 = bound_mixed(b7_bytes, ((n_prod * prod, BF16_OPS_S),))
    print(f"B7 bound: max(bytes {b7_bytes:.4g} / {HBM_BYTES_S:.4g} B/s = "
          f"{b7_bytes / HBM_BYTES_S * 1e3:.4f} ms, (2 + 3 x 2) = {n_prod} "
          f"bf16 products x {prod:.4g} FLOP / {BF16_OPS_S:.4g} FLOP/s = "
          f"{n_prod * prod / BF16_OPS_S * 1e3:.4f} ms) = {b7[0]:.4f} ms",
          flush=True)
    f_ms = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
    f_plain = median_ms(lambda: ref.flash_fwd_ref(q, k, v, **kw), flush, n=5)
    b_ms = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                     flush)
    b_plain = median_ms(lambda: ref.flash_bwd_ref(q, k, v, out, m, l, do,
                                                  **kw), flush, n=5)
    if f_ms < b6[0] or b_ms < b7[0]:
        fail(f"a flash kernel reads faster than its bound: B6 {f_ms} < "
             f"{b6[0]} or B7 {b_ms} < {b7[0]} ms")
    # the library's causal GQA attention, as a yardstick only: SDPA on
    # (B, heads, S, hd) views; its backward takes p and dS in bf16, the
    # pair's as hi + lo pairs (fp32-level products)
    sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdo = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        lib_f = median_ms(sdpa, flush)
    so = sdpa()
    lib_b = median_ms(lambda: torch.autograd.grad(
        so, (sq, sk, sv), sdo, retain_graph=True), flush)
    lib_fb = median_ms(lambda: torch.autograd.grad(
        sdpa(), (sq, sk, sv), sdo), flush)
    del so, sq, sk, sv, sdo
    print(f"B6 flash_fwd {FLASH_SHAPE} bf16 causal: kernel {f_ms:.4f} ms "
          f"({100 * b6[0] / f_ms:.1f} % of its bound), plain {f_plain:.4f} "
          f"ms, bound {b6[0]:.4f} ms ({b6[1]}), SDPA {lib_f:.4f} ms",
          flush=True)
    print(f"B7 flash_bwd {FLASH_SHAPE} bf16 causal: kernel {b_ms:.4f} ms "
          f"({100 * b7[0] / b_ms:.1f} % of its bound; dsum reduction, dq "
          f"kernel, dk/dv kernel), plain {b_plain:.4f} ms, bound "
          f"{b7[0]:.4f} ms ({b7[1]}), SDPA backward {lib_b:.4f} ms (forward "
          f"+ backward {lib_fb:.4f} ms)", flush=True)
    rec["flash_fwd"] = dict(ms=f_ms, plain_ms=f_plain, bound=b6,
                            shape=FLASH_SHAPE, max_abs_err=fwd_err,
                            library_ms=lib_f)
    rec["flash_bwd"] = dict(ms=b_ms, plain_ms=b_plain, bound=b7,
                            shape=FLASH_SHAPE, max_abs_err=bwd_err,
                            library_ms=lib_b)
    del q, k, v, do, out, m, l

    # both routes at (1, 1024), causal: fp32 (FFMA) and bf16 (tensor cores)
    kw = dict(scale=FLASH_F32_SHAPE[-1] ** -0.5, causal=True)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _flash_inputs(g, FLASH_F32_SHAPE, dtype)
        out, m, l = fa.flash_fwd(q, k, v, **kw)
        t_f = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
        t_b = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                        flush)
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"B6/B7 {FLASH_F32_SHAPE} {name} causal: forward {t_f:.4f} "
              f"ms, backward {t_b:.4f} ms", flush=True)
        rec["flash_fwd"][f"{name}_1024_ms"] = t_f
        rec["flash_bwd"][f"{name}_1024_ms"] = t_b
        del q, k, v, do, out, m, l

    # fp32 at the reference's bars: plain causal, then window + softcap
    for extra in ({}, dict(window=FLASH_WINDOW, softcap=FLASH_SOFTCAP)):
        q, k, v, do = _flash_inputs(g, FLASH_F32_SHAPE, torch.float32)
        kw = dict(scale=FLASH_F32_SHAPE[-1] ** -0.5, causal=True, **extra)
        got = fa.flash_fwd(q, k, v, **kw)
        want = ref.flash_fwd_ref(q, k, v, **kw)
        for name, a, b in zip(("out", "m", "l"), got, want):
            if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
                fail(f"B6 f32 {extra} {name}: beyond 2e-5 (max abs err "
                     f"{_max_err(a, b)})")
        grads = fa.flash_bwd(q, k, v, *got, do, **kw)
        wgrads = ref.flash_bwd_ref(q, k, v, *got, do, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
            if not torch.allclose(a, b, rtol=3e-5, atol=3e-5):
                fail(f"B7 f32 {extra} {name}: beyond 3e-5 (max abs err "
                     f"{_max_err(a, b)})")
        again = fa.flash_bwd(q, k, v, *got, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(again, grads)):
            fail(f"B7 f32 {extra}: two launches differ")
        errs = [_max_err(a, b) for a, b in zip((*got, *grads),
                                                     (*want, *wgrads))]
        print(f"B6/B7 {FLASH_F32_SHAPE} f32 causal {extra or ''}: out/m/l "
              f"max abs err {max(errs[:3]):.3e} (rtol/atol 2e-5), dq/dk/dv "
              f"{max(errs[3:]):.3e} (3e-5)", flush=True)
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


def _int4_level(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """x's level on its block's INT4 grid (0 where the block is all 0)."""
    return torch.where(step > 0, torch.round(x / torch.where(step > 0, step,
                                                             1)), 0)


def _grads_within_one_int4_step(got: dict, want: dict) -> tuple:
    """The card's gradients against the CPU's, both out of qgZ's INT4
    reduce: every element within rtol 1e-5 / atol 1e-6 of ``want``, or at
    most one INT4 step of its 256-block away, the latter in fewer than 1
    of 1,000.  This is the CPU tests' rule (``_within_int4_step`` in
    ``tests/test_torch_train.py``), with one INT4 step read as one level:
    a block's step is its absmax / 7 on each side, the two sides' steps
    differ by fp32 rounding, and every element must sit on its block's
    grid on both sides (within 1e-5 of a step) at levels at most one
    apart.  With equal steps that is the CPU tests' bound; a block that
    is 0 on one side must be 0 on the other.  The steps must agree as the
    blocks' absmax elements (level 7) must: at rtol 1e-5 / atol 1e-6 on
    7·step."""
    n_far = n = n_loose = 0
    worst = 0.0
    for k in want:
        a = got[k].detach().float().cpu().reshape(-1, 256)
        b = want[k].detach().float().cpu().reshape(-1, 256)
        sa = a.abs().amax(dim=1, keepdim=True) / 7
        sb = b.abs().amax(dim=1, keepdim=True) / 7
        ds = (7 * (sa - sb)).abs()
        if not bool((ds <= 1e-6 + 1e-5 * 7 * sb).all()):
            fail(f"grad {k}: a block's INT4 step differs beyond rtol 1e-5 / "
                 f"atol 1e-6 on its absmax")
        n_loose += int((ds > 1e-5 * 7 * sb).sum())
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        far = d > 1e-6 + 1e-5 * b.abs()
        la, lb = _int4_level(a, sa), _int4_level(b, sb)
        on_grid = ((a - la * sa).abs() <= 1e-5 * sa) & (
            (b - lb * sb).abs() <= 1e-5 * sb)
        if not bool((on_grid & ((la - lb).abs() <= 1)).all()):
            fail(f"grad {k}: an element is off by more than one INT4 step")
        n_far += int(far.sum())
        n += a.numel()
    if n_far >= n / 1000:
        fail(f"{n_far} of {n} gradient elements beyond rtol 1e-5 / atol 1e-6")
    return n_far, n, worst, n_loose


def step_launches(cfg, model, attn: str) -> dict:
    """Kernel launches one training step issues: each of B1-B5 once per
    flat group (embedding, layers, head norm, unembedding chunks), none of
    B8, and under --attn pallas B6 twice per layer (the forward and the
    layer's recompute) and B7 once."""
    groups = 1 + cfg.n_layers + 1 + model.unemb_chunks
    want = {k: groups for k in platform.LAUNCHES}
    want["dequant_matmul"] = 0
    flash = attn == "pallas"
    want["flash_fwd"] = 2 * cfg.n_layers if flash else 0
    want["flash_bwd"] = cfg.n_layers if flash else 0
    return want


def train_parity_phase() -> None:
    """One loss_and_grads of the full ZeRO++ step on the card and on the
    CPU, same fp32 parameters and batch (qwen3-0.6b widths, 2 layers,
    vocab 8192 in 4 chunks, fp32 compute): batch 2 x 256 with plain
    attention, and 2 x 512 with --attn pallas (the flash kernels need S a
    multiple of 512, the reference's rule)."""
    import dataclasses
    from repro_torch.data.synthetic import SyntheticLM
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              vocab=8192, unemb_chunks=4)
    pol = make_policy(cfg, variant="zeropp", param_dtype=torch.float32,
                      compute_dtype=torch.float32, reduce_dtype=torch.float32)
    cpu_model = Model(cfg, pol.zcfg, device="cpu")
    cuda_model = Model(cfg, pol.zcfg, device="cuda")
    params = cpu_model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float32)
    for attn, seq in (("xla", 256), ("pallas", 512)):
        lm = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=7)
        out = {}
        for dev in ("cuda", "cpu"):
            model = cpu_model if dev == "cpu" else cuda_model
            st = build_train_step(model, AdamWConfig(), device=dev,
                                  attn_impl=attn)
            batch = train_launch.device_batch(cfg, lm, 0, 2, 1, dev)
            p = {k: v.to(dev) for k, v in params.items()}
            platform.reset_launches()
            loss, _, grads = st.loss_and_grads(p, batch)
            launches = dict(platform.LAUNCHES)
            out[dev] = (float(loss), grads)
            if dev == "cuda":
                want = step_launches(cfg, model, attn)
                if launches != want:
                    fail(f"train parity --attn {attn}: launches {launches}, "
                         f"expected {want}")
        dl = abs(out["cuda"][0] - out["cpu"][0])
        if not (np.isfinite(out["cuda"][0]) and dl <= 1e-5):
            fail(f"train parity --attn {attn}: loss {out['cuda'][0]} (card) "
                 f"vs {out['cpu'][0]} (CPU)")
        n_far, n, worst, n_loose = _grads_within_one_int4_step(
            out["cuda"][1], out["cpu"][1])
        print(f"train parity --attn {attn} ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, vocab {cfg.vocab}, batch 2 x {seq}, fp32): "
              f"loss card {out['cuda'][0]:.6f} vs CPU {out['cpu'][0]:.6f} "
              f"(|diff| {dl:.2e} <= 1e-5); grads: {n_far} of {n} elements "
              f"beyond rtol 1e-5 / atol 1e-6, max abs diff {worst:.3e}, none "
              f"beyond one INT4 step; {n_loose} blocks' steps apart by more "
              f"than rtol 1e-5 (within atol 1e-6 on 7·step)", flush=True)


def train_phase(attn: str) -> tuple:
    """The full-width ZeRO++ training run through the launcher's loop, with
    the attention route ``attn``.  Returns (launches over the run, the
    step-1 loss)."""
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", attn])
    # earlier phases' tensors (the engine holds itself in a cycle) must not
    # count in this run's peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    cfg, model = built.arch, built.model
    per_step = step_launches(cfg, model, attn)
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"train --attn {attn} step {i}: launches {c}, expected "
                 f"{per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] - LOSS_DROP:
        fail(f"loss did not fall by {LOSS_DROP}: {losses}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tag = f"train --attn {attn}"
    print(f"{tag}: {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {model.n_params()} params "
          f"fp32 master + fp32 moments, full ZeRO++ (qwZ INT8, hpZ, qgZ "
          f"INT4 2-hop) on a one-rank world, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, constant lr {TRAIN_LR}", flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}, bar {LOSS_DROP}); entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"{tag}: step p50 (steps 2-{TRAIN_STEPS}) {p50 * 1e3:.1f} ms, "
          f"{tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches per "
          f"step {per_step} x {TRAIN_STEPS} steps", flush=True)
    batch = train_launch.device_batch(cfg, built.lm, TRAIN_STEPS,
                                      TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step")
    return launches, losses[0]


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
    flash = {re.search(r"::(flash_\w+)", k).group(1): ms
             for k, ms in by_name.items() if "::flash_" in k}
    print(f"profile ({what}): host wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of the wall), "
          f"{len(dev) / n:.0f} device kernels/step", flush=True)
    if flash:
        print(f"  flash kernels {sum(flash.values()):.3f} ms/step: "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in flash.items()),
              flush=True)
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
    # per kernel of the flash sources (the others report their maximum)
    for src, dt in (("flash_attention", "f32"), ("flash_attention_tc", "bf16")):
        smem = getattr(platform.library(src, {}), f"repro_flash_{dt}_smem")
        for fn, hd, spill, regs in re.findall(
                r"Compiling entry function '\S*?\d(flash_\w+?_kernel)ILi"
                r"(\d+)E.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                logs.get(src, ""), re.S):
            which = 0 if "fwd" in fn else 1 if "dq" in fn else 2
            print(f"    {fn}<{dt}, hd {hd}>: {regs} registers, {spill} bytes "
                  f"spilled, {smem(which, int(hd))} bytes of shared memory",
                  flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec = kernel_phase(flush)
    rec.update(qgz_kernel_phase(flush))
    rec["quantize_blockwise"]["max_abs_err"] = max(
        rec["quantize_blockwise"]["max_abs_err"],
        rec["quantize_blockwise_f32"]["max_abs_err"])
    rec.update(flash_kernel_phase(flush))
    del flush
    by_path = {"serve": engine_phase()}
    train_parity_phase()
    # this slice's path, then the plain-attention run beside it (same seed
    # and batches) so that one call shows both step times
    by_path["train"], loss_pallas = train_phase("pallas")
    by_path["train_xla"], loss_xla = train_phase("xla")
    print(f"train: step-1 loss --attn pallas {loss_pallas:.6f} vs --attn "
          f"xla {loss_xla:.6f} (|diff| {abs(loss_pallas - loss_xla):.2e}, "
          f"bar {ROUTE_LOSS_ATOL})", flush=True)
    if not abs(loss_pallas - loss_xla) <= ROUTE_LOSS_ATOL:
        fail("the two attention routes' step-1 losses differ beyond "
             f"{ROUTE_LOSS_ATOL}")

    # each kernel's path(s): it must have launched in every one of them
    quant_train = ("train", "train_xla")
    paths = {"quantize_blockwise": ("serve",) + quant_train,
             "dequantize_blockwise": ("serve",) + quant_train,
             "quantize_reordered": quant_train,
             "dequant_reduce_quant": quant_train,
             "dequant_reduce": quant_train,
             "dequant_matmul": ("serve",),
             "flash_fwd": ("train",),
             "flash_bwd": ("train",)}
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
                               "src/repro/kernels/dequant_matmul.py:58"),
            "flash_fwd": (cu + "flash_attention_tc.cu",
                          "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd": (cu + "flash_attention_tc.cu",
                          "src/repro/kernels/flash_attention.py:194")}
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
                        "bound_by": r["bound"][1],
                        "library_ms": r.get("library_ms"),
                        "shape": list(r["shape"])})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
