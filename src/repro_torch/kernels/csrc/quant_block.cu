// Blockwise quantize (B1), dequantize (B2) and the qgZ reorder-quantize
// (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/quant_block.py:
//   quantize_pallas           (_quant_kernel / _quant_kernel_sr, body _quant_body)
//   dequantize_pallas         (_dequant_kernel, body _dequant_body)
//   quantize_reordered_pallas (_quant3_kernel / _quant3_kernel_sr)
// and computes the same bits as repro_torch/core/quant.py and
// repro_torch/kernels/ref.py (quantize_reordered_ref).
//
// What bounds them: bytes.  Each is a single pass over memory with a
// handful of operations per element (quantize: 2 B read + 1 B written per
// bf16 element; dequantize: 1 B read + 2 B written), far below the card's
// ~295 operations per byte, so the only goal is to move each byte once,
// in wide coalesced transactions.
//
// Design.  The TPU kernels tile rows (pick_tiles); on the serving and
// training paths a flat shard is one row of up to 155 M elements, so here
// the grid covers quant blocks, not rows.  Quant blocks are contiguous
// runs of `block` trailing elements, and a contiguous (R, C) input with
// C % block == 0 is simply R*C/block consecutive blocks, so the kernels
// are 1-D.
//   quantize:   one warp per quant block.  Each lane owns block/32
//               consecutive elements (block 256: 8 bf16 = one 16-byte
//               load), takes the absmax with warp shuffles, and writes its
//               8 (INT8) or 4 (INT4) payload bytes with one store; lane 0
//               writes the scale.
//   reordered:  the same warp body.  Output block (x, y, b) of the (X, Y,
//               L) result reads input block (y, x, b) of the (Y, X, L)
//               gradient: the qgZ slice transpose lives in the load index,
//               with no transpose pass.  The u field, like the output, is
//               laid out (X, Y, L).
//   dequantize: one thread per 16 output elements: one 16-byte (INT8) or
//               8-byte (INT4) payload load, one scale, 32 (bf16) or 64
//               (f32) bytes stored.
// Numerics match the plain version bit for bit: scale = absmax * fl(1/qmax)
// and s = x * (1/scale) use the round-to-nearest intrinsics (no FMA
// contraction), rounding is rintf (half to even), and the bf16 cast is
// __float2bfloat16_rn.  Build without --use_fast_math.
#include "quant_common.cuh"

namespace {

using namespace repro_quant;

// B1: output block blk reads input block blk.  B3 (REORDER): the output is
// (X, Y, L) with nbl = L / block blocks per slice; output block (x, y, b)
// reads input block (y, x, b) of the (Y, X, L) input.  u, payload and
// scales follow the output layout.
template <typename T, int EPL, int BITS, bool REORDER>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ u,
                int8_t* __restrict__ payload, float* __restrict__ scales,
                long long n_blocks, int Y, int X, long long nbl) {
  const long long blk = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (blk >= n_blocks) return;  // whole warp exits together
  const int lane = threadIdx.x % kWarp;
  const long long out_base = blk * (EPL * kWarp) + (long long)lane * EPL;
  long long in_base = out_base;
  if constexpr (REORDER) {
    const long long per_x = (long long)Y * nbl;   // output blocks per x
    const long long xi = blk / per_x;
    const long long yi = (blk % per_x) / nbl;
    const long long b = blk % nbl;
    in_base = ((yi * X + xi) * nbl + b) * (EPL * kWarp) + (long long)lane * EPL;
  }
  float v[EPL];
  load_f32<T, EPL>(x + in_base, v);
  quantize_regs<EPL, BITS>(v, u == nullptr ? nullptr : u + out_base,
                           payload + (BITS == 8 ? out_base : out_base / 2),
                           scales + blk, lane);
}

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One thread per 16 consecutive output elements (block % 16 == 0, so all
// 16 share one scale).
template <typename O, int BITS>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ payload, const float* __restrict__ scales,
                  O* __restrict__ out, long long n_groups, int block) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const long long e0 = g * 16;
  const float s = scales[e0 / block];
  __align__(16) int8_t q[16];
  if constexpr (BITS == 8) {
    *reinterpret_cast<uint4*>(q) = reinterpret_cast<const uint4*>(payload)[g];
  } else {
    __align__(8) int8_t p[8];
    *reinterpret_cast<uint2*>(p) = reinterpret_cast<const uint2*>(payload)[g];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[2 * i] = (int8_t)((int32_t)((uint32_t)p[i] << 28) >> 28);  // low nibble, sign-extended
      q[2 * i + 1] = (int8_t)((int)p[i] >> 4);        // arithmetic shift
    }
  }
  __align__(16) O o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = from_f32<O>(__fmul_rn((float)q[i], s));
  uint4* dst = reinterpret_cast<uint4*>(out + e0);
  const uint4* src = reinterpret_cast<const uint4*>(o);
#pragma unroll
  for (int i = 0; i < (int)(16 * sizeof(O)) / 16; ++i) dst[i] = src[i];
}

template <typename T, int BITS, bool REORDER>
cudaError_t launch_quantize_bits(const void* x, const float* u, int8_t* payload,
                                 float* scales, long long n_blocks, int block,
                                 int Y, int X, long long nbl, cudaStream_t stream) {
  const long long grid = (n_blocks + kThreads / kWarp - 1) / (kThreads / kWarp);
  const T* xp = static_cast<const T*>(x);
  switch (block) {
#define REPRO_Q_CASE(B)                                                        \
  case B:                                                                      \
    quantize_kernel<T, B / kWarp, BITS, REORDER>                               \
        <<<(unsigned)grid, kThreads, 0, stream>>>(xp, u, payload, scales,      \
                                                  n_blocks, Y, X, nbl);        \
    break;
    REPRO_Q_CASE(64)
    REPRO_Q_CASE(128)
    REPRO_Q_CASE(256)
    REPRO_Q_CASE(512)
    REPRO_Q_CASE(1024)
#undef REPRO_Q_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool REORDER>
cudaError_t launch_quantize(const void* x, const float* u, int8_t* payload,
                            float* scales, long long n_blocks, int block, int bits,
                            int Y, int X, long long nbl, cudaStream_t stream) {
  if (bits == 8)
    return launch_quantize_bits<T, 8, REORDER>(x, u, payload, scales, n_blocks, block,
                                               Y, X, nbl, stream);
  if (bits == 4)
    return launch_quantize_bits<T, 4, REORDER>(x, u, payload, scales, n_blocks, block,
                                               Y, X, nbl, stream);
  return cudaErrorInvalidValue;
}

template <bool REORDER>
cudaError_t launch_quantize_dtype(const void* x, int x_dtype, const float* u,
                                  int8_t* payload, float* scales, long long n_blocks,
                                  int block, int bits, int Y, int X, long long nbl,
                                  cudaStream_t stream) {
  if (x_dtype == 0)
    return launch_quantize<float, REORDER>(x, u, payload, scales, n_blocks, block, bits,
                                           Y, X, nbl, stream);
  if (x_dtype == 1)
    return launch_quantize<__nv_bfloat16, REORDER>(x, u, payload, scales, n_blocks, block,
                                                   bits, Y, X, nbl, stream);
  return cudaErrorInvalidValue;
}

template <typename O>
cudaError_t launch_dequantize(const int8_t* payload, const float* scales, void* out,
                              long long n_elems, int block, int bits,
                              cudaStream_t stream) {
  const long long n_groups = n_elems / 16;
  const long long grid = (n_groups + kThreads - 1) / kThreads;
  O* op = static_cast<O*>(out);
  if (bits == 8)
    dequantize_kernel<O, 8><<<(unsigned)grid, kThreads, 0, stream>>>(
        payload, scales, op, n_groups, block);
  else if (bits == 4)
    dequantize_kernel<O, 4><<<(unsigned)grid, kThreads, 0, stream>>>(
        payload, scales, op, n_groups, block);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
// Every pointer is 16-byte aligned and contiguous (checked by the wrapper).
int repro_quantize_blockwise(int device, const void* x, int x_dtype, const float* u,
                             int8_t* payload, float* scales, long long n_blocks,
                             int block, int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks == 0) return 0;
  return (int)launch_quantize_dtype<false>(x, x_dtype, u, payload, scales, n_blocks, block,
                                           bits, 1, 1, n_blocks,
                                           static_cast<cudaStream_t>(stream));
}

// x: (Y, X, L) contiguous; u, payload, scales: the (X, Y, .) output layout.
int repro_quantize_reordered(int device, const void* x, int x_dtype, const float* u,
                             int8_t* payload, float* scales, int Y, int X,
                             long long L, int block, int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L % block) return (int)cudaErrorInvalidValue;
  const long long nbl = L / block;
  const long long n_blocks = (long long)Y * X * nbl;
  if (n_blocks == 0) return 0;
  return (int)launch_quantize_dtype<true>(x, x_dtype, u, payload, scales, n_blocks, block,
                                          bits, Y, X, nbl,
                                          static_cast<cudaStream_t>(stream));
}

int repro_dequantize_blockwise(int device, const int8_t* payload, const float* scales,
                               void* out, int out_dtype, long long n_elems, int block,
                               int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_elems == 0) return 0;
  if (block % 16 || n_elems % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) err = launch_dequantize<float>(payload, scales, out, n_elems, block, bits, s);
  else if (out_dtype == 1) err = launch_dequantize<__nv_bfloat16>(payload, scales, out, n_elems, block, bits, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
