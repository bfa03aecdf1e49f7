// Shared device code of the qgZ stream kernels B3 (quant_block.cu:
// quantize_reordered) and B4 (fused_dequant_reduce_quant.cu:
// dequant_reduce_quant): the INT4/INT8 decode and the 32-element-per-lane
// quantize body.
//
// No conversion-pipe instruction per element.  Hopper runs "other type
// conversions" (I2F, F2I, FRND) at 16 results per clock per SM against 128
// for fp32 add/multiply/FMA, so the decode and the round-and-convert are
// done with integer permutes and one fp32 add, each exact:
//   * decode: a nibble n (two's complement in 4 bits) is
//     __int_as_float(0x4B000000 | (n ^ 0x8)) - 8388616.0f, a byte b is
//     __int_as_float(0x4B000000 | (b ^ 0x80)) - 8388736.0f: the biased
//     value sits in the low mantissa bits of 2^23 and the subtraction
//     removes 2^23 plus the bias, exactly, for every value (-8 and -128
//     included).  One prmt per element puts the byte under 0x4B.
//   * round and convert: t = x + 1.5*2^23 rounds x half-to-even to an
//     integer in the low mantissa bits (|x| < 2^22), so the payload is
//     __float_as_int(t) & 0xF (INT4) or & 0xFF (INT8).  Clipping to
//     [-qmax, qmax] first gives clip(rint(x)) because +-qmax are integers.
// tests/test_torch_quant_bits.py checks both identities in float32 on the
// CPU over every byte, every half-way point and their neighbours.
//
// The clip itself is skipped where it cannot act: with the block's absmax
// finite and its scale s = absmax * fl(1/qmax) zero or normal, every
// |x| = |v * fl(1/s)| <= qmax * (1 + 2^-21) < qmax + 1/2, so rint already
// lies in [-qmax, qmax].  The absmax is taken with max.NaN (NaN-
// propagating), so a block holding a NaN, an inf or a subnormal scale is
// seen, and a warp holding one runs the full clip path, with the
// NaN-ignoring fmaxf absmax of the plain version: the bits are those of
// rintf + clip + (int) in every case.  Stochastic rounding keeps floorf
// (it is off the training path) and converts with the same add.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_qgz {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kLane = 32;                  // elements a lane owns
constexpr int kTile = kWarp * kLane;       // elements a warp owns per tile
constexpr float kMagic = 12582912.0f;      // 1.5 * 2^23

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Elements 2j and 2j+1 of an INT4 word (8 nibbles, element 2j in the low
// nibble of byte j): lo/hi hold the XOR-biased nibbles one per byte.
__device__ __forceinline__ void decode_int4(uint32_t w, float (&q)[8]) {
  const uint32_t lo = (w ^ 0x88888888u) & 0x0F0F0F0Fu;
  const uint32_t hi = ((w >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[2 * j] = __fsub_rn(__int_as_float(__byte_perm(lo, 0x4B000000u, 0x7440u + j)),
                         8388616.0f);
    q[2 * j + 1] = __fsub_rn(__int_as_float(__byte_perm(hi, 0x4B000000u, 0x7440u + j)),
                             8388616.0f);
  }
}

// The four int8 elements of a word, byte j = element j.
__device__ __forceinline__ void decode_int8(uint32_t w, float (&q)[4]) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = __fsub_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)),
                     8388736.0f);
}

// Eight rounded values (their low bytes hold the two's-complement payload)
// -> one INT4 word, element 2j in the low nibble of byte j.
__device__ __forceinline__ uint32_t pack_int4(const uint32_t (&t)[8]) {
  const uint32_t e = __byte_perm(__byte_perm(t[0], t[2], 0x5140u),
                                 __byte_perm(t[4], t[6], 0x5140u), 0x5410u);
  const uint32_t o = __byte_perm(__byte_perm(t[1], t[3], 0x5140u),
                                 __byte_perm(t[5], t[7], 0x5140u), 0x5410u);
  return (e & 0x0F0F0F0Fu) | ((o << 4) & 0xF0F0F0F0u);
}

__device__ __forceinline__ uint32_t pack_int8(const uint32_t (&t)[4]) {
  return __byte_perm(__byte_perm(t[0], t[1], 0x5140u), __byte_perm(t[2], t[3], 0x5140u),
                     0x5410u);
}

// bf16 pair word -> (element 2j, element 2j+1) as fp32, exactly.
__device__ __forceinline__ void bf16x2_f32(uint32_t w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

// The quantize body on 32 elements per lane.  v: the lane's elements (all
// in one quant block of 32 * lpb elements, the block's lanes consecutive
// and lpb-aligned in the warp; an idle lane holds zeros).  uval(i):
// element i's uniform draw, read only when sr.  Writes the lane's payload
// words (INT4: word w = elements 8w..8w+7; INT8: 4w..4w+3) and returns the
// block's scale (in every lane of the block).
template <int BITS, typename UVal>
__device__ __forceinline__ float quantize_lane(const float (&v)[kLane], int lpb, bool sr,
                                               UVal uval,
                                               uint32_t (&words)[BITS == 4 ? 4 : 8]) {
  constexpr float kQmax = BITS == 8 ? 127.0f : 7.0f;
  constexpr float kRecip = 1.0f / kQmax;          // folded, correctly rounded
  // four independent chains: a fold of 32 dependent maxima is latency-bound
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kLane; ++i) m[i % 4] = max_nan(m[i % 4], fabsf(v[i]));
  float a = max_nan(max_nan(m[0], m[1]), max_nan(m[2], m[3]));
  for (int off = 1; off < lpb; off <<= 1)
    a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, off));
  float s = __fmul_rn(a, kRecip);
  // NaN and inf fail the first test; a subnormal scale the second
  const bool plain = a <= 3.402823466e38f && (s == 0.0f || s >= 1.17549435e-38f);
  const bool clip = sr || !__all_sync(0xffffffffu, plain);   // warp-uniform
  if (clip) {                                     // the NaN-ignoring absmax
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kLane; ++i) m[i % 4] = fmaxf(m[i % 4], fabsf(v[i]));
    a = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
    for (int off = 1; off < lpb; off <<= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    s = __fmul_rn(a, kRecip);
  }
  const float inv = s > 0.0f ? __frcp_rn(s) : 0.0f;
  uint32_t t[kLane];
  if (!clip) {
#pragma unroll
    for (int i = 0; i < kLane; ++i)
      t[i] = __float_as_uint(__fadd_rn(__fmul_rn(v[i], inv), kMagic));
  } else {
#pragma unroll
    for (int i = 0; i < kLane; ++i) {
      const float x = __fmul_rn(v[i], inv);
      float r;
      if (sr) {
        const float lo = floorf(x);
        r = lo + (uval(i) < __fsub_rn(x, lo) ? 1.0f : 0.0f);
      } else {
        r = x;                                    // rounded by the add below
      }
      r = fminf(fmaxf(r, -kQmax), kQmax);
      t[i] = __float_as_uint(__fadd_rn(r, kMagic));
    }
  }
  if constexpr (BITS == 4) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t g[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j] = t[8 * w + j];
      words[w] = pack_int4(g);
    }
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      uint32_t g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = t[4 * w + j];
      words[w] = pack_int8(g);
    }
  }
  return s;
}

// log2 of a quant block the kernels take (64 ... 1024), else -1.
inline int block_shift(int block) {
  for (int s = 6; s <= 10; ++s)
    if (block == 1 << s) return s;
  return -1;
}

}  // namespace repro_qgz
