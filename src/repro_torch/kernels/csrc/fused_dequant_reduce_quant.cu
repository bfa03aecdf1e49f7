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
// element are summed in index order as a fused multiply-add chain from +0
// (B5: or from an fp32 `init`, the quantized ring's addend),
// acc = fma(q_n, scale_n, acc): what the reference computes under XLA,
// which contracts its `sum(q * scale, axis=0)` into FMAs, and what the
// plain version computes, so the three agree bit for bit.  B5 writes the
// (C,) fp32 sum; B4 requantizes it in registers, so the fp32 intermediate
// never reaches memory (paper §4.2: one read of each input byte, one write
// of each output byte).
//
// B5 (dequant_reduce_kernel): one warp per quant block, each lane
// block/32 consecutive elements; bound by its 4-byte fp32 output.
//
// B4 (dequant_reduce_quant_kernel).  Bytes alone would bound it (per
// output element N/2 + 4N/block bytes read, 1/2 + 4/block written at
// INT4), but a one-warp-per-block design with an int->float
// convert, a rintf and a float->int convert per element, is bound by
// Hopper's conversion pipe (16 results per clock per SM) and, at 4 bytes
// a lane and one block a warp, by too few bytes in flight.  This design:
//   * no conversion-pipe instruction per element: nibbles and bytes
//     decode with a prmt and one fp32 subtraction, the requantize rounds
//     and converts with one fp32 add (qgz_stream.cuh, exact);
//   * a lane owns 32 consecutive elements: one 16-byte payload load per
//     contribution (INT4; two at INT8) and one 16-byte payload store, a
//     warp 1,024 elements (1024/block quant blocks; the absmax takes
//     log2(block/32) shuffles);
//   * a persistent grid (as many CTAs as fit) walks the warp tiles, the
//     next tile's N rows loaded while this tile is requantized.  N in {1,
//     2, 4, 8} is a template argument; any other N takes a plain loop.
// What bounds it now: the memory system's mixed read/write rate.  At N = 1
// on an H100 it runs at the speed of a plain device copy of its payload
// bytes at a layer's shape and within a quarter of it at the embedding
// (chip_smoke.py prints both); the ~8 instructions an element cost the
// rest.  Three alternatives read slower on the card: two to four tiles in
// flight per warp (more registers, fewer warps), one tile per warp with
// no persistent grid, and the same tiles staged by a TMA bulk-copy ring
// in shared memory (PERF.md keeps the ring's times).
// Build without --use_fast_math: the chain is __fmaf_rn, and the
// requantize keeps its products separately rounded.
#include "qgz_stream.cuh"

namespace {

using repro_qgz::kThreads;
using repro_qgz::kWarp;

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
// elements of quant block blk, from init[i] (null: +0).  Payload rows
// are P bytes apart, scale rows NB floats.
template <int EPL, int BITS>
__device__ __forceinline__ void dequant_sum(const int8_t* __restrict__ payload,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ init, int N,
                                            long long P, long long NB, long long blk,
                                            int lane, float (&acc)[EPL]) {
  constexpr int kBytes = BITS == 8 ? EPL : EPL / 2;
  const long long off = blk * (kBytes * kWarp) + (long long)lane * kBytes;
  const long long el = blk * (EPL * kWarp) + (long long)lane * EPL;
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = init ? init[el + i] : 0.0f;
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
                      const float* __restrict__ init, float* __restrict__ out, int N,
                      long long n_blocks) {
  const long long blk = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x % kWarp;
  const long long P = n_blocks * (BITS == 8 ? EPL : EPL / 2) * kWarp;
  __align__(16) float acc[EPL];
  dequant_sum<EPL, BITS>(payload, scales, init, N, P, n_blocks, blk, lane, acc);
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

namespace qz = repro_qgz;

// One warp tile's inputs for one lane: NC contributions' payload (16
// bytes at INT4, 32 at INT8) and their scales.
template <int BITS_IN, int NC>
struct Contribs {
  static constexpr int kVecs = BITS_IN == 4 ? 1 : 2;
  uint4 p[NC][kVecs];
  float s[NC];
};

template <int BITS_IN>
__device__ __forceinline__ void load_contrib(const int8_t* __restrict__ row,
                                             const float* __restrict__ scale_row,
                                             long long e, int shift,
                                             uint4 (&p)[BITS_IN == 4 ? 1 : 2], float& s) {
  const uint4* src = reinterpret_cast<const uint4*>(row + (BITS_IN == 4 ? e / 2 : e));
#pragma unroll
  for (int w = 0; w < (BITS_IN == 4 ? 1 : 2); ++w) p[w] = __ldcs(src + w);
  s = __ldg(scale_row + (e >> shift));
}

// acc[i] = fma(q[i], s, acc[i]) over the lane's 32 elements of one
// contribution.
template <int BITS_IN>
__device__ __forceinline__ void add_contrib(const uint4 (&p)[BITS_IN == 4 ? 1 : 2], float s,
                                            float (&acc)[qz::kLane]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  if constexpr (BITS_IN == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float q[8];
      qz::decode_int4(w[k], q);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[8 * k + j] = __fmaf_rn(q[j], s, acc[8 * k + j]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float q[4];
      qz::decode_int8(w[k], q);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * k + j] = __fmaf_rn(q[j], s, acc[4 * k + j]);
    }
  }
}

// Load a tile's NC contributions for the lane whose first element is e
// (zeros where the lane is past the end: e >= n_elems).
template <int BITS_IN, int NC>
__device__ __forceinline__ void fetch(Contribs<BITS_IN, NC>& c, const int8_t* __restrict__ payload,
                                      const float* __restrict__ scales, long long P,
                                      long long NB, long long e, long long n_elems,
                                      int shift) {
  if (e < n_elems) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
      load_contrib<BITS_IN>(payload + n * P, scales + n * NB, e, shift, c.p[n], c.s[n]);
  } else {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int w = 0; w < Contribs<BITS_IN, NC>::kVecs; ++w) c.p[n][w] = make_uint4(0, 0, 0, 0);
      c.s[n] = 0.0f;
    }
  }
}

// Requantize the lane's 32 sums and store its payload and (from the
// block's first lane) the block's scale.
template <int BITS_OUT>
__device__ __forceinline__ void requantize(const float (&acc)[qz::kLane],
                                           const float* __restrict__ u,
                                           int8_t* __restrict__ out_payload,
                                           float* __restrict__ out_scales, long long e,
                                           long long n_elems, int shift, int lane) {
  const bool valid = e < n_elems;
  const int lpb = 1 << (shift - 5);
  uint32_t words[BITS_OUT == 4 ? 4 : 8];
  const float s = qz::quantize_lane<BITS_OUT>(
      acc, lpb, u != nullptr,
      [&](int i) { return valid ? __ldg(u + e + i) : 0.0f; }, words);
  if (!valid) return;
  uint4* dst = reinterpret_cast<uint4*>(out_payload + (BITS_OUT == 4 ? e / 2 : e));
  dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
  if constexpr (BITS_OUT == 8) dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
  if ((lane & (lpb - 1)) == 0) out_scales[e >> shift] = s;
}

// Persistent: warp w takes warp tiles w, w + stride, ...; a tile is 1,024
// consecutive elements, lane l its elements 32l .. 32l + 31.  NC > 0: N ==
// NC, the next tile's NC rows loaded while this one is requantized; NC ==
// 0: any N, loaded as it is summed.
template <int BITS_IN, int BITS_OUT, int NC>
__global__ void __launch_bounds__(qz::kThreads)
dequant_reduce_quant_kernel(const int8_t* __restrict__ payload,
                            const float* __restrict__ scales, const float* __restrict__ u,
                            int8_t* __restrict__ out_payload, float* __restrict__ out_scales,
                            int N, long long n_elems, int shift) {
  const int lane = threadIdx.x % qz::kWarp;
  const long long n_tiles = (n_elems + qz::kTile - 1) / qz::kTile;
  const long long stride = (long long)gridDim.x * qz::kWarps;
  const long long P = BITS_IN == 4 ? n_elems / 2 : n_elems;
  const long long NB = n_elems >> shift;
  long long t = (long long)blockIdx.x * qz::kWarps + threadIdx.x / qz::kWarp;
  auto first = [&](long long tile) { return tile * qz::kTile + lane * qz::kLane; };
  if constexpr (NC > 0) {
    Contribs<BITS_IN, NC> buf;
    fetch(buf, payload, scales, P, NB, first(t), n_elems, shift);
    for (; t < n_tiles; t += stride) {
      float acc[qz::kLane];
#pragma unroll
      for (int i = 0; i < qz::kLane; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int n = 0; n < NC; ++n) add_contrib<BITS_IN>(buf.p[n], buf.s[n], acc);
      fetch(buf, payload, scales, P, NB, first(t + stride), n_elems, shift);
      requantize<BITS_OUT>(acc, u, out_payload, out_scales, first(t), n_elems, shift, lane);
    }
  } else {
    for (; t < n_tiles; t += stride) {
      const long long e = first(t);
      float acc[qz::kLane];
#pragma unroll
      for (int i = 0; i < qz::kLane; ++i) acc[i] = 0.0f;
      if (e < n_elems) {
        for (int n = 0; n < N; ++n) {
          uint4 p[BITS_IN == 4 ? 1 : 2];
          float s;
          load_contrib<BITS_IN>(payload + n * P, scales + n * NB, e, shift, p, s);
          add_contrib<BITS_IN>(p, s, acc);
        }
      }
      requantize<BITS_OUT>(acc, u, out_payload, out_scales, e, n_elems, shift, lane);
    }
  }
}

// CTAs for a persistent launch: as many as fit on the card at once, and
// no more than the `need` the tiles ask for.  `resident` caches the
// kernel's fit (one static per launcher instantiation, read once).
cudaError_t persistent_grid(const void* kernel, int& resident, long long need, unsigned& grid) {
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, qz::kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  grid = (unsigned)(need < resident ? need : resident);
  return cudaSuccess;
}

long long grid_of(long long n_blocks) {
  return (n_blocks + kThreads / kWarp - 1) / (kThreads / kWarp);
}

template <int BITS>
cudaError_t launch_reduce(const int8_t* payload, const float* scales, const float* init,
                          float* out, int N, long long n_blocks, int block,
                          cudaStream_t stream) {
  const unsigned grid = (unsigned)grid_of(n_blocks);
  switch (block) {
#define REPRO_R_CASE(B)                                                          \
  case B:                                                                        \
    dequant_reduce_kernel<B / kWarp, BITS><<<grid, kThreads, 0, stream>>>(       \
        payload, scales, init, out, N, n_blocks);                                \
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

template <int BITS_IN, int BITS_OUT, int NC>
cudaError_t launch_requant_n(const int8_t* payload, const float* scales, const float* u,
                             int8_t* out_payload, float* out_scales, int N,
                             long long n_elems, int shift, cudaStream_t stream) {
  const auto kernel = dequant_reduce_quant_kernel<BITS_IN, BITS_OUT, NC>;
  static int resident = 0;
  const long long need = ((n_elems + qz::kTile - 1) / qz::kTile + qz::kWarps - 1) / qz::kWarps;
  unsigned grid;
  cudaError_t err = persistent_grid(reinterpret_cast<const void*>(kernel), resident, need, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, qz::kThreads, 0, stream>>>(payload, scales, u, out_payload, out_scales, N,
                                            n_elems, shift);
  return cudaGetLastError();
}

template <int BITS_IN, int BITS_OUT>
cudaError_t launch_requant(const int8_t* payload, const float* scales, const float* u,
                           int8_t* out_payload, float* out_scales, int N,
                           long long n_blocks, int block, cudaStream_t stream) {
  const int shift = qz::block_shift(block);
  if (shift < 0 || N < 1) return cudaErrorInvalidValue;
  const long long n = n_blocks << shift;
#define REPRO_RQ_ARGS payload, scales, u, out_payload, out_scales, N, n, shift, stream
  switch (N) {
    case 1: return launch_requant_n<BITS_IN, BITS_OUT, 1>(REPRO_RQ_ARGS);
    case 2: return launch_requant_n<BITS_IN, BITS_OUT, 2>(REPRO_RQ_ARGS);
    case 4: return launch_requant_n<BITS_IN, BITS_OUT, 4>(REPRO_RQ_ARGS);
    case 8: return launch_requant_n<BITS_IN, BITS_OUT, 8>(REPRO_RQ_ARGS);
    default: return launch_requant_n<BITS_IN, BITS_OUT, 0>(REPRO_RQ_ARGS);
  }
#undef REPRO_RQ_ARGS
}

}  // namespace

extern "C" {

// Every pointer is 16-byte aligned and contiguous (checked by the wrapper).
// payload (N, n_blocks*block[/2]) int8, scales (N, n_blocks) f32,
// init (n_blocks*block,) f32 or null (+0), out (n_blocks*block,) f32.
int repro_dequant_reduce(int device, const int8_t* payload, const float* scales,
                         const float* init, float* out, int N, long long n_blocks,
                         int block, int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8) err = launch_reduce<8>(payload, scales, init, out, N, n_blocks, block, s);
  else if (bits == 4) err = launch_reduce<4>(payload, scales, init, out, N, n_blocks, block, s);
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
