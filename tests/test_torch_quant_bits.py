"""The exact arithmetic the qgZ stream kernels (B3, B4) and the INT8
dequant-GEMM (B8) rely on, in float32.

``src/repro_torch/kernels/csrc/qgz_stream.cuh`` decodes INT4 nibbles and
INT8 bytes and rounds to integers with no conversion instruction: a
payload value is put into the low mantissa bits of 2^23 and the bias
subtracted, and x is rounded half to even by adding 1.5 * 2^23 after
clipping to [-qmax, qmax].  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``); these tests hold the same identities
in numpy float32 on the CPU: the decodes for all 256 byte values, the
rounding over a dense sweep, every half-way point and its float neighbours,
and the claim that lets the kernels skip the clip (a block with a finite
absmax and a zero or normal scale never rounds outside [-qmax, qmax]).
B8's tensor-core route (``csrc/dequant_matmul.cu``) dequantizes a weight
as ``decode_int8``, ``__fmul_rn`` by its group scale and a packed round to
bf16 (``bf16_bits``); the tests below hold that recipe bit for bit against
PyTorch's own ``(q.float() * s).to(torch.bfloat16)``, NaN included, and
replay its mma fragment layout.
The word-level helpers below mirror the header's ``decode_int4``,
``decode_int8``, ``pack_int4`` and ``pack_int8``, ``__byte_perm`` included.
"""
import numpy as np
import pytest

F32 = np.float32
MAGIC = F32(12582912.0)                      # 1.5 * 2^23
QMAX = {4: F32(7.0), 8: F32(127.0)}


def _as_f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _as_u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's __byte_perm for selectors with nibbles 0..7."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    r = np.zeros(np.shape(v), np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        r |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return r.astype(np.uint32)


def decode_int4(w) -> np.ndarray:
    """(..., 8) float32 elements of INT4 words w, element 2j the low nibble
    of byte j (qgz_stream.cuh decode_int4)."""
    w = np.asarray(w, np.uint32)
    lo = (w ^ np.uint32(0x88888888)) & np.uint32(0x0F0F0F0F)
    hi = ((w >> np.uint32(4)) ^ np.uint32(0x08080808)) & np.uint32(0x0F0F0F0F)
    out = []
    for j in range(4):
        for half in (lo, hi):
            out.append(_as_f32(byte_perm(half, 0x4B000000, 0x7440 + j))
                       - F32(8388616.0))
    return np.stack(out, axis=-1)


def decode_int8(w) -> np.ndarray:
    w = np.asarray(w, np.uint32) ^ np.uint32(0x80808080)
    return np.stack([_as_f32(byte_perm(w, 0x4B000000, 0x7440 + j))
                     - F32(8388736.0) for j in range(4)], axis=-1)


def round_bits(x, qmax, clip=True) -> np.ndarray:
    """__float_as_uint(clip(x) + 1.5 * 2^23): the payload in the low byte."""
    x = np.asarray(x, np.float32)
    if clip:
        x = np.minimum(np.maximum(x, -qmax), qmax)
    return _as_u32(x + MAGIC)


def pack_int4(t) -> np.ndarray:
    """(..., 8) rounded words -> one INT4 word (qgz_stream.cuh pack_int4)."""
    t = np.asarray(t, np.uint32)
    e = byte_perm(byte_perm(t[..., 0], t[..., 2], 0x5140),
                  byte_perm(t[..., 4], t[..., 6], 0x5140), 0x5410)
    o = byte_perm(byte_perm(t[..., 1], t[..., 3], 0x5140),
                  byte_perm(t[..., 5], t[..., 7], 0x5140), 0x5410)
    return (e & np.uint32(0x0F0F0F0F)) | ((o << np.uint32(4))
                                          & np.uint32(0xF0F0F0F0))


def pack_int8(t) -> np.ndarray:
    t = np.asarray(t, np.uint32)
    return byte_perm(byte_perm(t[..., 0], t[..., 1], 0x5140),
                     byte_perm(t[..., 2], t[..., 3], 0x5140), 0x5410)


def _signed(bits, width) -> np.ndarray:
    """The low ``width`` bits of ``bits`` as a two's-complement integer."""
    v = np.asarray(bits, np.int64) & ((1 << width) - 1)
    return np.where(v >= 1 << (width - 1), v - (1 << width), v)


ALL_BYTES = np.arange(256, dtype=np.uint32)


def test_nibble_decode_all_bytes():
    """Both nibbles of every byte, through the word decode (each byte in
    each of the four byte lanes), against the arithmetic shifts the plain
    version (``core.quant.unpack_int4``) uses."""
    b = ALL_BYTES.astype(np.uint8).view(np.int8).astype(np.int32)
    want_lo = (b << 28) >> 28                 # sign-extended low nibble
    want_hi = b >> 4                          # arithmetic shift
    for j in range(4):
        got = decode_int4(ALL_BYTES << np.uint32(8 * j))
        np.testing.assert_array_equal(got[:, 2 * j], want_lo.astype(F32))
        np.testing.assert_array_equal(got[:, 2 * j + 1], want_hi.astype(F32))
        others = [k for k in range(8) if k // 2 != j]
        assert (got[:, others] == 0).all()
    assert decode_int4(0x8)[0] == -8 and decode_int4(0x80)[1] == -8


def test_byte_decode_all_bytes():
    want = ALL_BYTES.astype(np.uint8).view(np.int8).astype(F32)
    for j in range(4):
        got = decode_int8(ALL_BYTES << np.uint32(8 * j))
        np.testing.assert_array_equal(got[:, j], want)
    assert decode_int8(0x80)[0] == -128
    # the decoded value is exact and the sign of a zero is +
    assert _as_u32(decode_int8(0))[0] == 0 and _as_u32(decode_int4(0))[0] == 0


@pytest.mark.parametrize("bits", [4, 8])
def test_magic_round_dense_sweep(bits):
    """clip then + 1.5*2^23 == clip(rint(x)) over a dense sweep well past
    +-qmax, tiny values, huge values and infinities."""
    qmax = QMAX[bits]
    rng = np.random.default_rng(bits)
    x = np.concatenate([
        np.linspace(-3 * qmax, 3 * qmax, 2_000_001, dtype=F32),
        (rng.standard_normal(500_000) * qmax).astype(F32),
        np.ldexp(rng.uniform(-1, 1, 100_000), rng.integers(-149, 128, 100_000)
                 ).astype(F32),
        np.array([np.inf, -np.inf, 3e38, -3e38, 1e-45, -1e-45], F32)])
    with np.errstate(over="ignore"):
        want = np.clip(np.rint(x), -qmax, qmax).astype(np.int64)
    np.testing.assert_array_equal(_signed(round_bits(x, qmax), bits), want)


@pytest.mark.parametrize("bits", [4, 8])
def test_magic_round_half_way_points(bits):
    """Every half-way point k + 1/2 in [-qmax - 1.5, qmax + 1.5] and its
    nextafter neighbours round as rint (half to even) does; +-0 give 0."""
    qmax = QMAX[bits]
    half = np.arange(-qmax - 1.5, qmax + 2.0, 1.0, dtype=F32)
    x = np.concatenate([half, np.nextafter(half, F32(np.inf)),
                        np.nextafter(half, F32(-np.inf)),
                        np.array([0.0, -0.0], F32)])
    want = np.clip(np.rint(x), -qmax, qmax).astype(np.int64)
    got = _signed(round_bits(x, qmax), bits)
    np.testing.assert_array_equal(got, want)
    # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    np.testing.assert_array_equal(
        _signed(round_bits(np.array([0.5, 1.5, -2.5], F32), qmax), bits),
        [0, 2, -2])


@pytest.mark.parametrize("bits", [4, 8])
def test_clip_never_acts_on_a_finite_normal_scale(bits):
    """What lets the kernels skip the clip: for a block whose absmax a is
    finite and whose scale s = a * fl(1/qmax) is zero or normal, every
    x = v * fl(1/s) (|v| <= a) rounds into [-qmax, qmax] without it.  Swept
    over absmax values from the smallest normal scale to the largest
    float, with v = +-a and v at a's neighbours."""
    qmax = QMAX[bits]
    recip = F32(1.0) / qmax
    rng = np.random.default_rng(bits + 10)
    tiny = np.finfo(F32).tiny
    a = np.concatenate([
        np.ldexp(rng.uniform(1, 2, 400_000), rng.integers(-124, 128, 400_000)
                 ).astype(F32),
        np.nextafter(np.array([tiny * qmax, tiny * qmax * 2], F32), F32(1)),
        np.array([np.finfo(F32).max], F32)])
    s = a * recip
    keep = np.isfinite(a) & (s >= tiny)       # the kernels' own test
    assert keep.mean() > 0.95 and keep[-3:].all()
    a, s = a[keep], s[keep]
    inv = F32(1.0) / s
    for v in (a, -a, np.nextafter(a, F32(0)), rng.uniform(-1, 1, a.size
                                                         ).astype(F32) * a):
        x = v * inv
        assert np.abs(x).max() < qmax + F32(0.5)
        np.testing.assert_array_equal(
            _signed(round_bits(x, qmax, clip=False), bits),
            np.clip(np.rint(x), -qmax, qmax).astype(np.int64))


def test_pack_int4_matches_the_plain_packing():
    """pack_int4 of the rounded words == core.quant.pack_int4's nibble
    order (element 2j low nibble of byte j), and decode_int4 inverts it."""
    rng = np.random.default_rng(3)
    q = rng.integers(-8, 8, (1000, 8))
    t = round_bits(q.astype(F32), F32(8.0), clip=False)
    words = pack_int4(t)
    want = np.zeros(1000, np.uint32)
    for j in range(4):
        byte = (q[:, 2 * j] & 0xF) | ((q[:, 2 * j + 1] & 0xF) << 4)
        want |= byte.astype(np.uint32) << np.uint32(8 * j)
    np.testing.assert_array_equal(words, want)
    np.testing.assert_array_equal(decode_int4(words), q.astype(F32))


def test_pack_int8_roundtrip():
    rng = np.random.default_rng(4)
    q = rng.integers(-128, 128, (1000, 4))
    words = pack_int8(round_bits(q.astype(F32), F32(128.0), clip=False))
    np.testing.assert_array_equal(
        words, q.astype(np.int8).view(np.uint32).reshape(-1))
    np.testing.assert_array_equal(decode_int8(words), q.astype(F32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_rows_reach_the_quantizer_edges(bits, dtype):
    """The inputs the card's B3/B4 holds use (``testing.quant_edges``) are
    what they claim, read through the port's plain quantizer on the CPU:
    block 0 quantizes to zero, block 1 has scale 2^-3 and puts every
    element but its absmax exactly half-way (x * inv = k + 1/2), and in
    fp32 block 2 puts each element one float32 step off a half-way point."""
    import torch

    from repro_torch.core.quant import QuantConfig, quantize_blockwise
    from repro_torch.testing.quant_edges import edge_rows

    block, qmax = 64, QMAX[bits]
    dt = getattr(torch, dtype)
    x = edge_rows(torch.Generator().manual_seed(bits), 3, 5 * block, block,
                  bits, dt)
    assert x.shape == (3, 5 * block) and x.dtype == dt
    _, scales = quantize_blockwise(x, QuantConfig(bits, block))
    xb = x.float().numpy().reshape(3, 5, block)
    s = scales.numpy().reshape(3, 5)
    assert not xb[:, 0].any() and (s[:, 0] == 0).all()
    assert (s[:, 1] == F32(2.0 ** -3)).all()
    y = xb[:, 1] * (F32(1.0) / s[:, 1:2])
    assert (y[:, 0] == qmax).all()
    assert (y[:, 1:] - np.floor(y[:, 1:]) == F32(0.5)).all()
    if dtype == "float32":
        assert (s[:, 2] == F32(2.0 ** -3)).all()
        y2 = xb[:, 2, 1:] * (F32(1.0) / s[:, 2:3])
        off = np.abs(y2 - y[:, 1:])
        assert (off > 0).all() and (off <= np.spacing(np.abs(y[:, 1:]))).all()


# ------------------------------------------------------------------- B8

# the card's result for any float operation whose result is NaN
CANONICAL_NAN = np.uint32(0x7FFFFFFF)


def bf16_bits(v) -> np.ndarray:
    """cvt.rn.bf16x2.f32 (__floats2bfloat162_rn), the conversion B8's
    tensor-core route rounds with: float32 -> the nearest bf16, ties to
    even, NaN -> the canonical bf16 NaN 0x7FFF; returned as the float32
    bits of the bf16 value."""
    u = _as_u32(v)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return np.where(np.isnan(np.asarray(v, F32)), np.uint32(0x7FFF0000), r)


def b8_weight_bits(words, s) -> np.ndarray:
    """B8's recipe for (..., 4) weights of int8 words ``words`` times scales
    ``s`` (broadcast against the words): decode_int8, the float32 multiply
    (a NaN product as the card returns it) and the round to bf16."""
    q = decode_int8(words)
    with np.errstate(invalid="ignore", over="ignore"):
        v = q * np.asarray(s, F32)[..., None]
    v = np.where(np.isnan(v), CANONICAL_NAN.view(F32), v).astype(F32)
    return bf16_bits(v)


def _torch_bf16_bits(q, s) -> np.ndarray:
    """(q.float() * s).to(torch.bfloat16), as float32 bits: the staged
    path's dequantized weight (kernels/ref.py dequant_matmul_ref)."""
    import torch
    w = (torch.from_numpy(np.asarray(q, np.int8)).float()
         * torch.from_numpy(np.array(s, F32))).to(torch.bfloat16)
    return w.view(torch.int16).numpy().astype(np.uint16).astype(
        np.uint32) << np.uint32(16)


def _scale_grid() -> np.ndarray:
    """+-0, subnormals (the smallest, 2^-149 multiples, 1e-41, the largest),
    2^-126 and its neighbour below, scales whose products overflow float32
    (3.4e38, the largest float, 2^120, 1e37), +-inf, NaN, and random normal
    scales of both signs over every exponent."""
    rng = np.random.default_rng(16)
    tiny = np.finfo(F32).tiny
    special = np.array([0.0, -0.0, 2.0 ** -149, -(2.0 ** -149), 3 * 2.0 ** -149,
                        1e-41, -1e-41, np.nextafter(tiny, F32(0)), tiny,
                        -tiny, 3.4e38, -3.4e38, np.finfo(F32).max,
                        2.0 ** 120, 1e37, 1.0, 0.5, 1 / 127, np.inf, -np.inf,
                        np.nan], F32)
    normal = (np.ldexp(rng.uniform(1, 2, 6000), rng.integers(-126, 128, 6000))
              * rng.choice([-1.0, 1.0], 6000)).astype(F32)
    return np.concatenate([special, normal])


def _same_or_both_nan(got, want) -> np.ndarray:
    return (got == want) | (np.isnan(got.view(F32)) & np.isnan(want.view(F32)))


def test_b8_bf16_round_at_every_half_way_point():
    """The round B8 relies on matches PyTorch's float32 -> bf16 cast (the
    staged path's) at every bf16 half-way point (low 16 bits 0x8000, every
    sign and exponent, subnormal and near-overflow ones included), at its
    neighbours one float32 step either side and at every bf16 value itself,
    NaN patterns included (as NaN): ties go to even, a tie above the
    largest bf16 goes to inf, -0 stays -0."""
    import torch
    hi = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    v = np.concatenate([hi | np.uint32(0x8000), hi | np.uint32(0x7FFF),
                        hi | np.uint32(0x8001), hi]).view(F32)
    want = torch.from_numpy(v.copy()).to(torch.bfloat16).view(
        torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16
    assert _same_or_both_nan(bf16_bits(v), want).all()
    assert np.isnan(v).sum() > 0
    # half to even: 1 + 2^-8 (a tie, even below) stays 1, 1 + 3 * 2^-8 goes up
    assert bf16_bits(_as_f32(0x3F808000)) == 0x3F800000
    assert bf16_bits(_as_f32(0x3F818000)) == 0x3F820000
    assert bf16_bits(_as_f32(0x7F7F8000)) == 0x7F800000          # -> inf
    assert bf16_bits(_as_f32(0x80000000)) == 0x80000000          # -0 stays


def test_b8_dequantized_weight_bit_exact_on_the_scale_grid():
    """decode_int8, the float32 multiply and the round to bf16 give the
    staged path's bf16 weight bit for bit for all 256 bytes times every
    scale of the grid: +-0, subnormal scales and products, normal scales of
    both signs, products that overflow to +-inf, and the products that are
    NaN (a NaN scale, an infinite one times q = 0), which stay NaN."""
    grid = _scale_grid()
    words = (np.arange(256, dtype=np.uint32) * np.uint32(0x01010101))
    got = b8_weight_bits(words[:, None], grid[None, :])       # (256, S, 4)
    q = np.arange(256, dtype=np.uint8).view(np.int8)[:, None] + np.zeros(
        grid.size, np.int8)[None, :]
    want = _torch_bf16_bits(q, np.broadcast_to(grid, q.shape))
    for j in range(4):                        # the byte in each of 4 lanes
        assert _same_or_both_nan(got[..., j], want).all()
    # the grid reaches what it claims
    w = want.view(F32)
    assert np.isinf(w).any() and (w == 0).any() and np.isnan(w).any()
    assert ((np.abs(w) < np.finfo(F32).tiny) & (w != 0)).any()
    assert (want == np.uint32(0x80000000)).any()              # -0
    nan_products = np.isnan(grid)[None, :] | (np.isinf(grid)[None, :]
                                              & (q == 0))
    np.testing.assert_array_equal(np.isnan(w), nan_products)


def test_b8_tensor_core_fragments_sum_the_right_pairs():
    """B8's tc_step, replayed in numpy for one 16-row tile and one 128-k
    step: lane (g, q) holds 16-element chunks q and q + 4 of rows g and
    g + 8, product j takes word j % 4 of chunk j / 4, its elements {0, 1}
    at the mma's k columns 2q + {0, 1} and {2, 3} at 2q + {8, 9} (A and B
    alike), and x's bf16 pairs are the B fragments as they lie in memory.
    Placed by the PTX fragment layout of mma.m16n8k16 (A row-major 16 x 16,
    B 16 x 8, D 16 x 8), the 8 products must sum to W . x^T, and the lane's
    D values must land at out[2q + (e & 1), g + 8 (e >> 1)]."""
    rng = np.random.default_rng(8)
    W = rng.integers(-128, 128, (16, 128)).astype(np.float64)
    X = rng.integers(-8, 9, (8, 128)).astype(np.float64)
    D = np.zeros((16, 8))
    for j in range(8):
        h, i = divmod(j, 4)
        A = np.zeros((16, 16))
        B = np.zeros((16, 8))
        for lane in range(32):
            g, q = divmod(lane, 4)
            k0 = 64 * h + 16 * q + 4 * i      # the word's first element
            for row, rr in ((g, g), (g + 8, g + 8)):
                A[rr, 2 * q:2 * q + 2] = W[row, k0:k0 + 2]
                A[rr, 2 * q + 8:2 * q + 10] = W[row, k0 + 2:k0 + 4]
            B[2 * q:2 * q + 2, g] = X[g, k0:k0 + 2]
            B[2 * q + 8:2 * q + 10, g] = X[g, k0 + 2:k0 + 4]
        D += A @ B
    np.testing.assert_array_equal(D, W @ X.T)
    out = np.zeros((8, 16))
    for lane in range(32):
        g, q = divmod(lane, 4)
        for e in range(4):
            row, col = g + 8 * (e >> 1), 2 * q + (e & 1)   # D's c0..c3
            out[2 * q + (e & 1), g + 8 * (e >> 1)] = D[row, col]
    np.testing.assert_array_equal(out, (W @ X.T).T)
