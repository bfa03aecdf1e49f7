"""The CUDA kernels against their plain versions, on the card.

Skipped where ``torch.cuda.is_available()`` is false (the decision is
made inside the fixture, never at import).  On the card: B1, B2, B3, B4
and B5 must be bit-identical to the plain versions (B3 and B4 also at
quant-block counts that leave a warp tile part full, every block size,
N in {1, 2, 3, 8, 11}, half-way inputs and raw payload bytes); B8 must agree within fp32
rtol 1e-5, atol 1e-5·max|out| (summation order only), with NaN and inf
where the plain version has them at edge inputs, and give the same bits
from one launch to the next; the flash pair B6/B7
in fp32 (its FFMA kernels) within the reference's fp32 bars (2e-5 forward,
3e-5 backward: the plain version, tiled 64 x 64 as the kernels are, still
sums within a tile in another order), in bf16 (its tensor-core kernels)
within the per-element bars of ``repro_torch.testing.flash_bars``, and
bit-identical from one launch to the next.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py``.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import quant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_dequant_reduce_quant as fq
from repro_torch.kernels import platform, ref
from repro_torch.kernels import quant_block as qb
from repro_torch.testing import flash_bars
from repro_torch.testing.quant_edges import (B8_EDGE_SCALES,
                                             dequant_matmul_close,
                                             dequant_matmul_edges, edge_rows,
                                             same_bits)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("R,C,block,bits,dtype", [
    (1, 4096, 256, 8, torch.bfloat16), (3, 2048, 128, 4, torch.float32),
    (2, 4096, 1024, 4, torch.bfloat16), (5, 640, 64, 8, torch.float32)])
def test_quant_kernels_bit_identical(gen, R, C, block, bits, dtype):
    cfg = QuantConfig(bits=bits, block_size=block)
    x = (torch.randn(R, C, generator=gen, device="cuda") * 3).to(dtype)
    x[0, :block] = 0
    u = torch.rand(R, C, generator=gen, device="cuda")
    for field in (None, u):
        before = platform.LAUNCHES["quantize_blockwise"]
        p, s = qb.quantize(x, cfg, field)
        assert platform.LAUNCHES["quantize_blockwise"] == before + 1
        pp, sp = quant.quantize_blockwise(x, cfg, field)
        assert torch.equal(p, pp) and torch.equal(s, sp)
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(qb.dequantize(p, s, cfg, out),
                               quant.dequantize_blockwise(p, s, cfg, out))
    torch.cuda.synchronize()


@pytest.mark.parametrize("T,N,K,NB", [(4, 4096, 1024, 4), (1, 300, 64, 1),
                                      (9, 200, 2048, 8)])
def test_dequant_matmul_kernel_close(gen, T, N, K, NB):
    x = torch.randn(T, K, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(N, NB, generator=gen, device="cuda") * 0.01
    out = dm.dequant_matmul(x, w, s)
    want = ref.dequant_matmul_ref(x, w, s)
    torch.cuda.synchronize()
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=tol)


# B8 where the redesign could slip: T 1-9 and 17 (x tiles of 1, 2, 4 and 8
# rows, two launches past 8), N 1, 31 and 4,097 (a warp's run of rows part
# full, most warps idle at N = 1), (K, NB) (64, 1) (lanes idle in a row),
# (1024, 4) (the head's) and (4096, 16) (four k steps an item row); then
# the serving path's two shapes, decode (T = 4) and prefill (T = 1)
B8_EDGE_CASES = [(T, N, K, NB) for T in (*range(1, 10), 17)
                 for N in (1, 31, 4097)
                 for K, NB in ((64, 1), (1024, 4), (4096, 16))]
B8_PATH_CASES = [(4, 37984, 1024, 4), (1, 37984, 1024, 4)]


@pytest.mark.parametrize("T,N,K,NB", B8_PATH_CASES + B8_EDGE_CASES)
def test_dequant_matmul_kernel_edges(gen, T, N, K, NB):
    """B8 on rows of all -128, all +-127 and special scales (+-0,
    subnormal, products overflowing to inf, inf, NaN): NaN and inf where
    the plain version has them, finite values within rtol 1e-5, atol
    1e-5·max|finite|; one launch counted; two launches, same bits."""
    x, w, s = dequant_matmul_edges(gen, T, N, K, NB)
    before = platform.LAUNCHES["dequant_matmul"]
    out = dm.dequant_matmul(x, w, s)
    assert platform.LAUNCHES["dequant_matmul"] == before + 1
    want = ref.dequant_matmul_ref(x, w, s)
    holds, err, atol = dequant_matmul_close(out, want)
    assert out.shape == (T, N) and holds, (err, atol)
    assert same_bits(dm.dequant_matmul(x, w, s), out)
    torch.cuda.synchronize()


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,N,K,NB", [(4, 4097, 1024, 4), (9, 31, 4096, 16),
                                      (1, 31, 64, 1)])
def test_dequant_matmul_kernel_f32_x(gen, T, N, K, NB, compute):
    """fp32 x, with the weights rounded to bf16 or (compute fp32) not.
    Unrounded, a 3.4e38 scale gives finite weights whose products overflow
    in an order-dependent way, so that scale is left out there."""
    scales = B8_EDGE_SCALES if compute == torch.bfloat16 else tuple(
        v for v in B8_EDGE_SCALES if v != 3.4e38)
    x, w, s = dequant_matmul_edges(gen, T, N, K, NB, torch.float32, scales)
    out = dm.dequant_matmul(x, w, s, compute)
    want = ref.dequant_matmul_ref(x, w, s, compute)
    holds, err, atol = dequant_matmul_close(out, want)
    assert holds, (err, atol)
    assert same_bits(dm.dequant_matmul(x, w, s, compute), out)
    torch.cuda.synchronize()


def test_dequant_matmul_routes_by_dtype(gen):
    """bf16 x with weights rounded to bf16 (the serving path) launches the
    tensor-core kernel; fp32 x, or weights left in fp32, the FFMA kernel."""
    w = torch.randint(-128, 128, (64, 256), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(64, 2, generator=gen, device="cuda")
    x = torch.randn(3, 256, generator=gen, device="cuda")
    calls = ((torch.bfloat16, torch.bfloat16, "dequant_matmul_tc_kernel("),
             (torch.float32, torch.bfloat16, "dequant_matmul_kernel<"),
             (torch.bfloat16, torch.float32, "dequant_matmul_kernel<"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x_dtype, compute, _ in calls:
            dm.dequant_matmul(x.to(x_dtype), w, s, compute)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "dequant_matmul" in e.name]
    assert len(names) == len(calls), names
    for name, (_, _, want) in zip(names, calls):
        assert f"::{want}" in name, names


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    with pytest.raises(ValueError, match="blocks"):
        qb.quantize(torch.zeros(1, 96, device="cuda"), QuantConfig(8, 96))
    with pytest.raises(ValueError, match="K % 16"):
        dm.dequant_matmul(torch.zeros(1, 40, device="cuda"),
                          torch.zeros(2, 40, dtype=torch.int8, device="cuda"),
                          torch.ones(2, 1, device="cuda"))
    q = torch.zeros(1, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd in"):     # 256 launches
        fa.flash_fwd(q, q, q, scale=0.1)


# the redesigned B3/B4 tile 1,024 elements a warp, 32 a lane: block counts
# that leave a warp or a tile part full, every block size, both widths
EDGE_BLOCKS = (1, 3, 4097)
B3_CASES = [(1, 1, 8192, 256, 4, torch.bfloat16),
            (2, 4, 2048, 256, 4, torch.float32),
            (2, 2, 1024, 128, 8, torch.bfloat16),
            (3, 1, 512, 64, 4, torch.float32)] + [
    (Y, X, nb * block, block, bits, dtype)
    for (Y, X) in ((1, 1), (2, 3)) for nb in EDGE_BLOCKS
    for block in qb._QUANT_BLOCKS for bits in (4, 8)
    for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("Y,X,L,block,bits,dtype", B3_CASES)
def test_quantize_reordered_kernel_bit_identical(gen, Y, X, L, block, bits,
                                                  dtype):
    cfg = QuantConfig(bits=bits, block_size=block)
    x = edge_rows(gen, Y * X, L, block, bits, dtype).reshape(Y, X, L)
    u = torch.rand(X, Y, L, generator=gen, device="cuda")
    for field in (None, u):
        before = platform.LAUNCHES["quantize_reordered"]
        p, s = qb.quantize_reordered(x, cfg, field)
        assert platform.LAUNCHES["quantize_reordered"] == before + 1
        pp, sp = ref.quantize_reordered_ref(x, cfg, field)
        assert torch.equal(p, pp) and torch.equal(s, sp)
    torch.cuda.synchronize()


B4_CASES = [(1, 8192, 256, 4, 4), (8, 4096, 256, 4, 4), (3, 2048, 128, 8, 8),
            (2, 1024, 64, 8, 4), (4, 2048, 1024, 4, 8)] + [
    (N, 3 * block, block, bits_in, bits_out)
    for N in (1, 2, 3, 8, 11) for block in qb._QUANT_BLOCKS
    for bits_in in (4, 8) for bits_out in (4, 8)] + [
    (N, nb * block, block, 4, 4) for N in (1, 2, 8, 11) for nb in (1, 4097)
    for block in (64, 256, 1024)]


@pytest.mark.parametrize("N,C,block,bits_in,bits_out", B4_CASES)
def test_dequant_reduce_kernels_bit_identical(gen, N, C, block, bits_in,
                                              bits_out):
    """B5 and B4 on quantizer output (a block of tiny values, an all-zero
    block, half-way points) and on raw random payload bytes, so that the
    nibble 0x8 (-8) and the byte -128 are decoded too."""
    cin = QuantConfig(bits=bits_in, block_size=block)
    cout = QuantConfig(bits=bits_out, block_size=block)
    x = edge_rows(gen, N, C, block, bits_in, torch.float32)
    x[:, -block:] *= 1e-6                     # a block of tiny values
    quantized = quant.quantize_blockwise(x, cin)
    raw = (torch.randint(-128, 128, quantized[0].shape, generator=gen,
                         device="cuda", dtype=torch.int8),
           torch.rand(quantized[1].shape, generator=gen, device="cuda"))
    u = torch.rand(C, generator=gen, device="cuda")
    for p, s in (quantized, raw):
        out = fq.dequant_reduce(p, s, cin)
        assert torch.equal(out, ref.dequant_reduce_ref(p, s, cin))
        for field in (None, u):
            before = platform.LAUNCHES["dequant_reduce_quant"]
            q2, s2 = fq.dequant_reduce_quant(p, s, cin, cout, field)
            assert platform.LAUNCHES["dequant_reduce_quant"] == before + 1
            qp, sp = ref.dequant_reduce_quant_ref(p, s, cin, cout, field)
            assert torch.equal(q2, qp) and torch.equal(s2, sp)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,S,H,K,hd,window,softcap", [
    (1, 256, 4, 2, 64, 0, 0.0), (2, 192, 4, 1, 64, 70, 0.0),
    (1, 128, 2, 2, 128, 0, 20.0), (1, 256, 8, 2, 16, 100, 30.0),
    (1, 128, 2, 1, 256, 0, 0.0), (1, 192, 4, 2, 256, 70, 20.0)])
def test_flash_kernels_close_and_deterministic(gen, B, S, H, K, hd, window,
                                               softcap):
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
    k = torch.randn(B, S, K, hd, generator=gen, device="cuda")
    v = torch.randn(B, S, K, hd, generator=gen, device="cuda")
    do = torch.randn(B, S, H, hd, generator=gen, device="cuda")
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=softcap)
    tiles = dict(bq=64, bk=64)        # the plain version tiled as the kernel
    before = dict(platform.LAUNCHES)
    o, m, l = fa.flash_fwd(q, k, v, **kw)
    grads = fa.flash_bwd(q, k, v, o, m, l, do, **kw)
    assert platform.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert platform.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    want = ref.flash_fwd_ref(q, k, v, **kw, **tiles)
    for got, w in zip((o, m, l), want):
        torch.testing.assert_close(got, w, rtol=2e-5, atol=2e-5)
    wgrads = ref.flash_bwd_ref(q, k, v, *want, do, **kw, **tiles)
    for got, w in zip(grads, wgrads):
        torch.testing.assert_close(got, w, rtol=3e-5, atol=3e-5)
    o2, m2, l2 = fa.flash_fwd(q, k, v, **kw)
    grads2 = fa.flash_bwd(q, k, v, o, m, l, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip((o, m, l, *grads), (o2, m2, l2, *grads2)):
        assert torch.equal(a, b)


# B, Sq, S, H, K, hd, causal, window, softcap
BF16_CASES = [
    (2, 256, 256, 4, 4, 128, True, 0, 0.0),      # GQA 1, the path's hd
    (1, 256, 256, 4, 2, 64, False, 0, 0.0),      # non-causal, GQA 2
    (1, 128, 384, 8, 2, 16, True, 0, 0.0),       # Sq < S, GQA 4
    (1, 320, 320, 4, 1, 64, True, 100, 30.0),    # window + softcap, GQA 4
    (1, 192, 448, 4, 2, 128, False, 70, 0.0),    # Sq < S, non-causal window
    (2, 256, 256, 2, 2, 16, True, 0, 20.0),      # softcap, hd 16
    (1, 256, 256, 4, 2, 256, True, 0, 0.0),      # hd 256 (gemma3-4b)
    (1, 192, 320, 4, 1, 256, False, 100, 30.0),  # hd 256, Sq < S, window
]


@pytest.mark.parametrize("B,Sq,S,H,K,hd,causal,window,softcap", BF16_CASES)
def test_flash_tensor_core_kernels_within_bars(gen, B, Sq, S, H, K, hd,
                                               causal, window, softcap):
    """The bf16 route: out within its per-element bar of the plain version,
    m and l within 2e-5, dq/dk/dv within theirs from the kernel's own saved
    (out, m, l); one launch counted per call; two launches, same bits."""
    q, do = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    before = dict(platform.LAUNCHES)
    o, m, l = fa.flash_fwd(q, k, v, **kw)
    grads = fa.flash_bwd(q, k, v, o, m, l, do, **kw)
    assert platform.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert platform.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    want = ref.flash_fwd_ref(q, k, v, **kw)
    ratio, err = flash_bars.worst(o, want[0], flash_bars.out_bar(
        q, k, v, want[0], **kw))
    assert torch.isfinite(o).all() and ratio <= 1, ("out", ratio, err)
    for got, w in zip((m, l), want[1:]):
        torch.testing.assert_close(got, w, rtol=2e-5, atol=2e-5)
    wgrads = ref.flash_bwd_ref(q, k, v, o, m, l, do, **kw)
    for name, got, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert got.dtype == torch.bfloat16
        ratio, err = flash_bars.worst(got, w, flash_bars.grad_bar(w))
        assert torch.isfinite(got).all() and ratio <= 1, (name, ratio, err)
    again = (*fa.flash_fwd(q, k, v, **kw),
             *fa.flash_bwd(q, k, v, o, m, l, do, **kw))
    torch.cuda.synchronize()
    for a, b in zip((o, m, l, *grads), again):
        assert torch.equal(a, b)


def test_flash_routes_by_dtype(gen):
    """A bf16 call launches the tensor-core kernels (flash_attention_tc.cu)
    and an fp32 call the FFMA kernels, as the profiler names them."""
    tc = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
          "flash_bwd_dkv_tc_kernel")
    ffma = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    for dtype, want, other in ((torch.bfloat16, tc, ffma),
                               (torch.float32, ffma, tc)):
        q, k, v, do = (torch.randn(1, 128, 2, 64, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        kw = dict(scale=0.125, causal=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o, m, l = fa.flash_fwd(q, k, v, **kw)
            fa.flash_bwd(q, k, v, o, m, l, do, **kw)
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        assert all(f"::{n}<" in names for n in want), (dtype, names)
        assert not any(f"::{n}<" in names for n in other), (dtype, names)
