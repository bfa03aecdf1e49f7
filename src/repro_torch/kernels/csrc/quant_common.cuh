// Shared device code of the blockwise quantization kernels: the fp32
// loads, the byte stores and the one-warp-per-block quantize body that
// quant_block.cu (B1, B3) and fused_dequant_reduce_quant.cu (B4) run.
// Numerics are those of repro_torch/core/quant.py, bit for bit: see
// quantize_regs.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_quant {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Load N consecutive elements starting at p (16-byte aligned when the
// run is a multiple of 16 bytes) into fp32 registers.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 w = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void store_bytes(int8_t* __restrict__ p, const int8_t (&b)[N]) {
  if constexpr (N == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(b);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(b);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(b);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = b[i];
  }
}

// The quantize body on one warp's registers: v holds this lane's EPL
// consecutive elements of one quant block (EPL = block / 32, even, so INT4
// pairs stay in a lane); u_lane (or nullptr) the lane's uniform field.
// Writes the lane's payload bytes at payload_lane and, from lane 0, the
// block's scale.  Shared by B1, B3 and the fused reduce-requantize (B4).
template <int EPL, int BITS>
__device__ __forceinline__ void quantize_regs(const float (&v)[EPL], const float* __restrict__ u_lane,
                                              int8_t* __restrict__ payload_lane,
                                              float* __restrict__ scale, int lane) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  constexpr float kQmax = BITS == 8 ? 127.0f : 7.0f;
  constexpr float kRecip = 1.0f / kQmax;          // folded, correctly rounded
  const float s = __fmul_rn(amax, kRecip);
  const float inv = s > 0.0f ? __frcp_rn(s) : 0.0f;

  float uv[EPL];
  if (u_lane != nullptr) load_f32<float, EPL>(u_lane, uv);
  __align__(16) int8_t q[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const float x = __fmul_rn(v[i], inv);
    float r;
    if (u_lane != nullptr) {
      const float lo = floorf(x);
      r = lo + (uv[i] < __fsub_rn(x, lo) ? 1.0f : 0.0f);
    } else {
      r = rintf(x);                               // half to even
    }
    r = fminf(fmaxf(r, -kQmax), kQmax);
    q[i] = (int8_t)(int)r;
  }
  if constexpr (BITS == 8) {
    store_bytes<EPL>(payload_lane, q);
  } else {
    __align__(16) int8_t packed[EPL / 2];
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i)
      packed[i] = (int8_t)((q[2 * i] & 0xF) | ((q[2 * i + 1] & 0xF) << 4));
    store_bytes<EPL / 2>(payload_lane, packed);
  }
  if (lane == 0) *scale = s;
}

}  // namespace repro_quant
