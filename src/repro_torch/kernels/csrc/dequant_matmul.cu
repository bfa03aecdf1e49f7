// Fused INT8-weight x activation GEMM (B8) for Hopper (sm_90a):
//   out[t, n] = sum_k x[t, k] * bf16(float(W[n, k]) * scales[n, k / kb])
// with fp32 accumulation, kb = K / NB.
//
// Replaces the TPU kernel in src/repro/kernels/dequant_matmul.py:
//   dequant_matmul_pallas (_gemm_kernel).
// The serving head calls it once per vocab chunk on the qwZ-gathered INT8
// payload, so the bf16 (N, K) weight matrix never exists in memory.
//
// What bounds it: bytes.  On the decode path T (the batch) is 1-8 rows,
// so the kernel does 2*T operations per weight byte, far below the card's
// ~295 operations per byte: it is a GEMV in disguise, and its floor is
// reading W once at 1 B/element (plus scales, x and the fp32 output).
//
// Design.  Each block of 8 warps owns 32 consecutive output columns n
// (4 per warp, many blocks across N) and loops over K tiles of 1024.
// Per tile the block stages x[t0:t0+TT, k-tile] in shared memory in its
// own dtype, permuted so that the 16-byte vectors a warp reads for one k
// chunk are consecutive (no bank conflicts).  Each lane streams 16 INT8
// weights per row with one 16-byte load (a warp reads 512 contiguous
// bytes of a row), dequantizes them in registers exactly as the staged
// path does (fp32 multiply by the row's group scale, round to bf16 when
// the compute dtype is bf16) and accumulates x*w in fp32.  A bf16*bf16
// product is exact in fp32, so the result differs from the staged
// dequantize+matmul only in summation order.  Lanes reduce with shuffles
// at the end; lane 0 writes out[t, n].  T larger than the TT tile reruns
// the K loop per tile of TT rows (not the decode path's case).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 4;                  // output columns n per warp
constexpr int kKTile = 1024;              // k elements staged per tile
constexpr int kChunks = kKTile / 16;      // 16-element k chunks per tile

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, int TT, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int T, int N, int K, int NB) {
  constexpr int kVec = 16 / (int)sizeof(TX);  // x elements per 16-byte vector
  constexpr int kUnits = 16 / kVec;           // vectors per 16-element chunk
  __shared__ uint4 xs[TT][kKTile / kVec];     // [t][m * kChunks + chunk]

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n0 = blockIdx.x * (kWarps * kRows) + warp * kRows;
  const int kb = K / NB;

  for (int t0 = 0; t0 < T; t0 += TT) {
    float acc[TT][kRows];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[t][r] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kKTile) {
      const int kt = min(kKTile, K - k0);     // multiple of 16
      const int nvec = kt / kVec;
      __syncthreads();
      for (int i = threadIdx.x; i < TT * nvec; i += kThreads) {
        const int t = i / nvec, u = i % nvec;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t0 + t < T)
          v = reinterpret_cast<const uint4*>(x + (long long)(t0 + t) * K + k0)[u];
        xs[t][(u % kUnits) * kChunks + u / kUnits] = v;
      }
      __syncthreads();

      for (int c = lane; c < kt / 16; c += kWarp) {
        const int k = k0 + c * 16;
        float wf[kRows][16];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = n0 + r;
          if (n < N) {
            __align__(16) int8_t q[16];
            *reinterpret_cast<uint4*>(q) =
                *reinterpret_cast<const uint4*>(w + (long long)n * K + k);
            const float s = scales[(long long)n * NB + k / kb];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              float v = __fmul_rn((float)q[j], s);
              if (ROUND_BF16) v = __bfloat162float(__float2bfloat16_rn(v));
              wf[r][j] = v;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) wf[r][j] = 0.0f;
          }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          float xf[16];
#pragma unroll
          for (int m = 0; m < kUnits; ++m) {
            uint4 v = xs[t][m * kChunks + c];
            const TX* e = reinterpret_cast<const TX*>(&v);
#pragma unroll
            for (int j = 0; j < kVec; ++j) xf[m * kVec + j] = to_f32(e[j]);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[t][r] = fmaf(xf[j], wf[r][j], acc[t][r]);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = acc[t][r];
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        const int n = n0 + r;
        if (lane == 0 && n < N && t0 + t < T) out[(long long)(t0 + t) * N + n] = v;
      }
  }
}

template <typename TX, int TT>
cudaError_t launch_tt(const void* x, const int8_t* w, const float* scales, float* out,
                      int T, int N, int K, int NB, int round_bf16, cudaStream_t stream) {
  const unsigned grid = (unsigned)((N + kWarps * kRows - 1) / (kWarps * kRows));
  const TX* xp = static_cast<const TX*>(x);
  if (round_bf16)
    dequant_matmul_kernel<TX, TT, true><<<grid, kThreads, 0, stream>>>(xp, w, scales, out, T, N, K, NB);
  else
    dequant_matmul_kernel<TX, TT, false><<<grid, kThreads, 0, stream>>>(xp, w, scales, out, T, N, K, NB);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, const int8_t* w, const float* scales, float* out,
                   int T, int N, int K, int NB, int round_bf16, cudaStream_t stream) {
  // smallest row tile that covers T (decode batches are 1-8 rows)
  if (T <= 1) return launch_tt<TX, 1>(x, w, scales, out, T, N, K, NB, round_bf16, stream);
  if (T <= 2) return launch_tt<TX, 2>(x, w, scales, out, T, N, K, NB, round_bf16, stream);
  if (T <= 4) return launch_tt<TX, 4>(x, w, scales, out, T, N, K, NB, round_bf16, stream);
  return launch_tt<TX, 8>(x, w, scales, out, T, N, K, NB, round_bf16, stream);
}

}  // namespace

extern "C" {

// x (T, K) float32 (x_dtype 0) or bfloat16 (1); w (N, K) int8; scales
// (N, NB) f32; out (T, N) f32.  Requires K % 16 == 0 and (K / NB) % 16 ==
// 0; every pointer contiguous and 16-byte aligned (checked by the wrapper).
int repro_dequant_matmul(int device, const void* x, int x_dtype, const int8_t* w,
                         const float* scales, float* out, int T, int N, int K, int NB,
                         int round_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K % 16 || NB <= 0 || K % NB || (K / NB) % 16) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) err = launch<float>(x, w, scales, out, T, N, K, NB, round_bf16, s);
  else if (x_dtype == 1) err = launch<__nv_bfloat16>(x, w, scales, out, T, N, K, NB, round_bf16, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
