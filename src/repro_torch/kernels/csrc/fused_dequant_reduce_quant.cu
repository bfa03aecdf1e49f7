// Fused dequantize -> fp32 reduce (B5) and dequantize -> fp32 reduce ->
// requantize (B4) for Hopper (sm_90a): the qgZ operators after each
// all-to-all hop.
//
// Replaces the TPU kernels in src/repro/kernels/fused_dequant_reduce_quant.py:
//   dequant_reduce_pallas       (_reduce_kernel)
//   dequant_reduce_quant_pallas (_reduce_requant_kernel / _reduce_requant_kernel_sr)
// and computes the same bits as repro_torch/kernels/ref.py
// (dequant_reduce_ref, dequant_reduce_quant_ref).
//
// Input: N contributions, payload (N, P) int8 (INT4 packed two per byte
// or INT8) and scales (N, NB) f32, NB quant blocks of `block` elements
// each.  Every contribution is dequantized in fp32 and the N values of an
// element are summed in index order as a fused multiply-add chain from +0,
// acc = fma(q_n, scale_n, acc): what the reference computes under XLA,
// which contracts its `sum(q * scale, axis=0)` into FMAs, and what the
// plain version computes, so the three agree bit for bit.  B5 writes the
// (C,) fp32 sum; B4 requantizes it with B1's warp body (quant_common.cuh),
// so the fp32 intermediate never reaches memory (paper §4.2: one read of
// each input byte, one write of each output byte).
//
// What bounds them: bytes.  Per output element B4 reads N/2 + 4N/block
// bytes (INT4) and writes 1/2 + 4/block, B5 writes 4; a few operations per
// input byte, far below the card's ~295 operations per byte.
//
// Design.  The TPU kernel tiles the slice length and keeps all N rows of a
// tile in VMEM; here one warp owns one quant block (the grid covers the C/
// block blocks), each lane EPL = block/32 consecutive elements.  For each
// contribution a lane loads its EPL/2 (INT4) or EPL (INT8) payload bytes
// in one access and the block's scale, unpacks by arithmetic shifts,
// multiplies and accumulates in registers.  Then either the lane stores
// its EPL fp32 sums (B5) or the warp takes the absmax with shuffles and
// requantizes (B4), with the optional uniform field u (C,) for stochastic
// rounding.  Build without --use_fast_math: the chain is __fmaf_rn, and
// the requantize body keeps its own products separately rounded.
#include "quant_common.cuh"

namespace {

using namespace repro_quant;

// Load N consecutive bytes (N-byte aligned for N in {4, 8, 16}).
template <int N>
__device__ __forceinline__ void load_bytes(const int8_t* __restrict__ p, int8_t (&b)[N]) {
  if constexpr (N == 16) {
    *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(b) = *reinterpret_cast<const uint32_t*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = p[i];
  }
}

// acc[i] = fma chain over n of q_n[i] * scale_n, for this lane's EPL
// elements of quant block blk.  Payload rows are P bytes apart, scale
// rows NB floats.
template <int EPL, int BITS>
__device__ __forceinline__ void dequant_sum(const int8_t* __restrict__ payload,
                                            const float* __restrict__ scales, int N,
                                            long long P, long long NB, long long blk,
                                            int lane, float (&acc)[EPL]) {
  constexpr int kBytes = BITS == 8 ? EPL : EPL / 2;
  const long long off = blk * (kBytes * kWarp) + (long long)lane * kBytes;
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.0f;
  for (int n = 0; n < N; ++n) {
    __align__(16) int8_t b[kBytes];
    load_bytes<kBytes>(payload + n * P + off, b);
    const float s = scales[n * NB + blk];
    float q[EPL];
    if constexpr (BITS == 8) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) q[i] = (float)b[i];
    } else {
#pragma unroll
      for (int i = 0; i < kBytes; ++i) {
        q[2 * i] = (float)((int32_t)((uint32_t)b[i] << 28) >> 28);  // low nibble, sign-extended
        q[2 * i + 1] = (float)((int)b[i] >> 4);                     // arithmetic shift
      }
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] = __fmaf_rn(q[i], s, acc[i]);
  }
}

template <int EPL, int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_reduce_kernel(const int8_t* __restrict__ payload, const float* __restrict__ scales,
                      float* __restrict__ out, int N, long long n_blocks) {
  const long long blk = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x % kWarp;
  const long long P = n_blocks * (BITS == 8 ? EPL : EPL / 2) * kWarp;
  __align__(16) float acc[EPL];
  dequant_sum<EPL, BITS>(payload, scales, N, P, n_blocks, blk, lane, acc);
  float* dst = out + blk * (EPL * kWarp) + (long long)lane * EPL;
  if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(acc)[i];
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) dst[i] = acc[i];
  }
}

template <int EPL, int BITS_IN, int BITS_OUT>
__global__ void __launch_bounds__(kThreads)
dequant_reduce_quant_kernel(const int8_t* __restrict__ payload,
                            const float* __restrict__ scales, const float* __restrict__ u,
                            int8_t* __restrict__ out_payload, float* __restrict__ out_scales,
                            int N, long long n_blocks) {
  const long long blk = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x % kWarp;
  const long long P = n_blocks * (BITS_IN == 8 ? EPL : EPL / 2) * kWarp;
  float acc[EPL];
  dequant_sum<EPL, BITS_IN>(payload, scales, N, P, n_blocks, blk, lane, acc);
  const long long e0 = blk * (EPL * kWarp) + (long long)lane * EPL;
  quantize_regs<EPL, BITS_OUT>(acc, u == nullptr ? nullptr : u + e0,
                               out_payload + (BITS_OUT == 8 ? e0 : e0 / 2),
                               out_scales + blk, lane);
}

long long grid_of(long long n_blocks) {
  return (n_blocks + kThreads / kWarp - 1) / (kThreads / kWarp);
}

template <int BITS>
cudaError_t launch_reduce(const int8_t* payload, const float* scales, float* out, int N,
                          long long n_blocks, int block, cudaStream_t stream) {
  const unsigned grid = (unsigned)grid_of(n_blocks);
  switch (block) {
#define REPRO_R_CASE(B)                                                          \
  case B:                                                                        \
    dequant_reduce_kernel<B / kWarp, BITS><<<grid, kThreads, 0, stream>>>(       \
        payload, scales, out, N, n_blocks);                                      \
    break;
    REPRO_R_CASE(64)
    REPRO_R_CASE(128)
    REPRO_R_CASE(256)
    REPRO_R_CASE(512)
    REPRO_R_CASE(1024)
#undef REPRO_R_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BITS_IN, int BITS_OUT>
cudaError_t launch_requant(const int8_t* payload, const float* scales, const float* u,
                           int8_t* out_payload, float* out_scales, int N,
                           long long n_blocks, int block, cudaStream_t stream) {
  const unsigned grid = (unsigned)grid_of(n_blocks);
  switch (block) {
#define REPRO_RQ_CASE(B)                                                         \
  case B:                                                                        \
    dequant_reduce_quant_kernel<B / kWarp, BITS_IN, BITS_OUT>                    \
        <<<grid, kThreads, 0, stream>>>(payload, scales, u, out_payload,         \
                                        out_scales, N, n_blocks);                \
    break;
    REPRO_RQ_CASE(64)
    REPRO_RQ_CASE(128)
    REPRO_RQ_CASE(256)
    REPRO_RQ_CASE(512)
    REPRO_RQ_CASE(1024)
#undef REPRO_RQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every pointer is 16-byte aligned and contiguous (checked by the wrapper).
// payload (N, n_blocks*block[/2]) int8, scales (N, n_blocks) f32,
// out (n_blocks*block,) f32.
int repro_dequant_reduce(int device, const int8_t* payload, const float* scales, float* out,
                         int N, long long n_blocks, int block, int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8) err = launch_reduce<8>(payload, scales, out, N, n_blocks, block, s);
  else if (bits == 4) err = launch_reduce<4>(payload, scales, out, N, n_blocks, block, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// As above, requantized with bits_out (same block): out_payload
// (n_blocks*block[/2],) int8, out_scales (n_blocks,) f32; u (n_blocks*block,)
// f32 or null.
int repro_dequant_reduce_quant(int device, const int8_t* payload, const float* scales,
                               const float* u, int8_t* out_payload, float* out_scales,
                               int N, long long n_blocks, int block, int bits_in,
                               int bits_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits_in == 4 && bits_out == 4)
    err = launch_requant<4, 4>(payload, scales, u, out_payload, out_scales, N, n_blocks, block, s);
  else if (bits_in == 4 && bits_out == 8)
    err = launch_requant<4, 8>(payload, scales, u, out_payload, out_scales, N, n_blocks, block, s);
  else if (bits_in == 8 && bits_out == 4)
    err = launch_requant<8, 4>(payload, scales, u, out_payload, out_scales, N, n_blocks, block, s);
  else if (bits_in == 8 && bits_out == 8)
    err = launch_requant<8, 8>(payload, scales, u, out_payload, out_scales, N, n_blocks, block, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
