"""The CUDA kernels against their plain versions, on the card.

Skipped where ``torch.cuda.is_available()`` is false (the decision is
made inside the fixture, never at import).  On the card: B1, B2, B3, B4
and B5 must be bit-identical to the plain versions; B8 must agree within fp32
rtol 1e-5, atol 1e-5·max|out| (summation order only).  Run on the card
with ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py``.
"""
import pytest
import torch

from repro_torch.core import quant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import fused_dequant_reduce_quant as fq
from repro_torch.kernels import platform, ref
from repro_torch.kernels import quant_block as qb


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


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    with pytest.raises(ValueError, match="blocks"):
        qb.quantize(torch.zeros(1, 96, device="cuda"), QuantConfig(8, 96))
    with pytest.raises(ValueError, match="K % 16"):
        dm.dequant_matmul(torch.zeros(1, 40, device="cuda"),
                          torch.zeros(2, 40, dtype=torch.int8, device="cuda"),
                          torch.ones(2, 1, device="cuda"))


@pytest.mark.parametrize("Y,X,L,block,bits,dtype", [
    (1, 1, 8192, 256, 4, torch.bfloat16), (2, 4, 2048, 256, 4, torch.float32),
    (2, 2, 1024, 128, 8, torch.bfloat16), (3, 1, 512, 64, 4, torch.float32)])
def test_quantize_reordered_kernel_bit_identical(gen, Y, X, L, block, bits,
                                                  dtype):
    cfg = QuantConfig(bits=bits, block_size=block)
    x = (torch.randn(Y, X, L, generator=gen, device="cuda") * 3).to(dtype)
    x[0, 0, :block] = 0
    u = torch.rand(X, Y, L, generator=gen, device="cuda")
    for field in (None, u):
        before = platform.LAUNCHES["quantize_reordered"]
        p, s = qb.quantize_reordered(x, cfg, field)
        assert platform.LAUNCHES["quantize_reordered"] == before + 1
        pp, sp = ref.quantize_reordered_ref(x, cfg, field)
        assert torch.equal(p, pp) and torch.equal(s, sp)
    torch.cuda.synchronize()


@pytest.mark.parametrize("N,C,block,bits_in,bits_out", [
    (1, 8192, 256, 4, 4), (8, 4096, 256, 4, 4), (3, 2048, 128, 8, 8),
    (2, 1024, 64, 8, 4), (4, 2048, 1024, 4, 8)])
def test_dequant_reduce_kernels_bit_identical(gen, N, C, block, bits_in,
                                              bits_out):
    cin = QuantConfig(bits=bits_in, block_size=block)
    cout = QuantConfig(bits=bits_out, block_size=block)
    x = torch.randn(N, C, generator=gen, device="cuda") * 2
    x[:, :block] *= 1e-6                      # a block of tiny values
    p, s = quant.quantize_blockwise(x, cin)
    out = fq.dequant_reduce(p, s, cin)
    assert torch.equal(out, ref.dequant_reduce_ref(p, s, cin))
    u = torch.rand(C, generator=gen, device="cuda")
    for field in (None, u):
        before = platform.LAUNCHES["dequant_reduce_quant"]
        q2, s2 = fq.dequant_reduce_quant(p, s, cin, cout, field)
        assert platform.LAUNCHES["dequant_reduce_quant"] == before + 1
        qp, sp = ref.dequant_reduce_quant_ref(p, s, cin, cout, field)
        assert torch.equal(q2, qp) and torch.equal(s2, sp)
    torch.cuda.synchronize()
