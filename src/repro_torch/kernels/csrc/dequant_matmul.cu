// Fused INT8-weight x activation GEMM (B8) for Hopper (sm_90a):
//   out[t, n] = sum_k x[t, k] * bf16(fl32(float(W[n, k]) * scales[n, k / kb]))
// with exact products and fp32 sums, kb = K / NB.
//
// Replaces the TPU kernel in src/repro/kernels/dequant_matmul.py:
//   dequant_matmul_pallas (_gemm_kernel).
// The serving head calls it once per vocab chunk on the qwZ-gathered INT8
// payload, so the bf16 (N, K) weight matrix never exists in memory.
//
// What bounds it.  On the serving path T is 1 (prefill) or the decode batch
// (4 slots): 2T operations per weight byte, far below the ~295 the card
// needs before its arithmetic binds, so the floor is reading W once at 1
// byte a weight (chip_smoke.py prints B8 beside that bound and beside a
// PyTorch read of the same bytes).
// What the card must still do per weight is fixed by the staged path's
// numerics: decode the byte, multiply by the group scale in fp32, round to
// bf16, multiply by x and add.  Two routes:
//
// bf16 x, weights rounded to bf16 (every serving path): dequant_matmul_tc_
// kernel.  The products and sums go to the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate; a bf16 x bf16 product is exact), so the cost per
// weight is the dequantize alone and does not grow with T <= 8 (the
// product's n; x rows past T are zero):
//   * a byte decodes by a prmt and one fp32 subtraction (qgz_stream.cuh
//     decode_int8, exact), the scale multiplies with __fmul_rn, and each
//     pair of products rounds half to even to bf16 in one packed conversion
//     (cvt.rn.bf16x2.f32), which also keeps a NaN a NaN.  Four instructions
//     a weight in all.  Per-weight FFMAs (T of them) and an all-integer
//     round (three integer instructions a weight, and a NaN guard) each cost
//     more issue time than the bytes leave spare: builds of both read slower
//     on the card (PERF.md);
//   * a warp owns 16-row tiles and walks each in 128-k steps; lane (g, q)
//     loads 16-byte chunks q and q + 4 of the step in rows g and g + 8 (64
//     contiguous bytes of 8 rows a load instruction), the next step's loads
//     in flight under this one's math (plain loads into registers read
//     faster here than cp.async into a shared-memory ring);
//   * x is staged once per block in shared memory as it is (bf16 needs no
//     conversion: its pairs are the B fragments), rows padded so a quarter
//     warp's reads fall on distinct banks;
//   * 12-warp blocks, two per SM, so that at the head's N (2,374 tiles)
//     every warp has at most one tile and no tail wave is left; tiles go
//     round robin with consecutive tiles on different blocks;
//   * deterministic: every sum in a fixed order, no atomics.
// T above 8 runs one launch per 8-row tile of x, and K above kTcSlab one per
// slab of K, each adding its partial sums to out.  Each launch reads all of
// W again: the paged engine's prefill chunk (T 32) takes four launches and
// its speculative verify at 4 slots (T 20) three (PERF.md).  The entry
// point reports how many launches it made, and the wrapper counts those.
//
// fp32 x, or weights not rounded (the fp32 policy): dequant_matmul_kernel,
// the first port's FFMA kernel: each block stages x in shared memory per
// 1,024-k tile, each warp dequantizes 4 rows with fp32 FMAs and reduces
// across its lanes.
// Build without --use_fast_math: the multiply must round as written, and
// subnormals must not flush.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qgz_stream.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTile = 8;                   // x rows a tensor-core launch takes

// ------------------------------------------------- tensor-core route (bf16)

constexpr int kTcWarps = 12;
constexpr int kTcThreads = kTcWarps * kWarp;
constexpr int kTcSlab = 1024;                 // k a launch stages
// bytes between staged x rows: the 16 past the row put the 8 lanes of a
// quarter warp (two rows, four 32-byte pieces each) on distinct banks
constexpr int kTcXRow = 2 * kTcSlab + 16;
constexpr int kTcXBytes = kMaxTile * kTcXRow;

// One 128-k step of a 16-row tile in a lane's registers: lane (g, q) holds
// the 16-element chunks q and q + 4 of the step in rows g and g + 8 (g =
// lane / 4, q = lane % 4), as w[2 * row + half], with their scales.
struct TcItem {
  uint4 w[4];
  float s[4];
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment halves of one product: weights j and j + 1 of a row's
// word, fl32(q * s) each, rounded half to even to bf16 as one pair (low
// half first) by the packed conversion instruction.
__device__ __forceinline__ void dequant_word(uint32_t word, float s, uint32_t& lo,
                                             uint32_t& hi) {
  float v[4];
  repro_qgz::decode_int8(word, v);
  const __nv_bfloat162 a = __floats2bfloat162_rn(__fmul_rn(v[0], s), __fmul_rn(v[1], s));
  const __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(v[2], s), __fmul_rn(v[3], s));
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// d[j % 2] += the step's 16 x 128 weights . x over 8 m16n8k16 products.
// Product j takes word j % 4 (elements 4j' .. 4j' + 3) of the lane's chunk
// j / 4 in both rows: elements {0, 1} of the word are the product's k
// columns 2q + {0, 1}, elements {2, 3} its columns 2q + {8, 9}, for A and B
// alike, so each product sums the right pairs; x's bf16 pairs at the same
// k are the B fragments as they lie in memory (xw: chunk q, then q + 4).
__device__ __forceinline__ void tc_step(const TcItem& it, const uint32_t (&xw)[16],
                                        float (&d)[2][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int h = j / 4, i = j % 4;
    const uint4& va = it.w[h];
    const uint4& vb = it.w[2 + h];
    const uint32_t wa = i == 0 ? va.x : i == 1 ? va.y : i == 2 ? va.z : va.w;
    const uint32_t wb = i == 0 ? vb.x : i == 1 ? vb.y : i == 2 ? vb.z : vb.w;
    uint32_t a[4];
    dequant_word(wa, it.s[h], a[0], a[2]);
    dequant_word(wb, it.s[2 + h], a[1], a[3]);
    mma_bf16(d[j % 2], a, xw[2 * j], xw[2 * j + 1]);
  }
}

// One launch: bf16 x rows [0, T) (T <= 8, the product's n) against every
// row of W over the K slab [k0, k0 + kslab), kslab <= kTcSlab, weights
// rounded to bf16.  A warp owns 16-row tiles (round robin, consecutive tiles
// on different blocks) and walks each in 128-k steps, the next step's loads
// in flight under this one's math; a warp's load instruction moves 64
// contiguous bytes of each of 8 rows.
__global__ void __launch_bounds__(kTcThreads, 2)
dequant_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scales, float* __restrict__ out, int T,
                         int N, int K, int NB, int k0, int kslab, int accumulate) {
  __shared__ __align__(16) unsigned char xs[kTcXBytes];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, q = lane % 4;
  const int nch = kslab / 16, kc0 = k0 / 16, cpg = K / NB / 16;
  const int nsb = (nch + 7) / 8;               // 128-k steps in the slab
  const int tiles = (N + 15) / 16;
  const int warps = gridDim.x * kTcWarps;
  const int first = warp * gridDim.x + blockIdx.x;
  const int n_items = first < tiles ? (tiles - first + warps - 1) / warps * nsb : 0;

  // the next item to load: step ls of tile lt, the lane's chunks 8 ls + q
  // and 8 ls + q + 4 of the slab; pointers and scale groups move step by
  // step (a group changes every cpg chunks) and restart at each tile
  int lt = first, ls = 0;
  const int8_t* wt = w + (long long)(lt * 16 + g) * K + 16 * (kc0 + q);
  const float* st0 = scales + (long long)(lt * 16 + g) * NB;
  int grp0[2], rem0[2], grp[2], rem[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    grp0[h] = grp[h] = (kc0 + 4 * h + q) / cpg;
    rem0[h] = rem[h] = (kc0 + 4 * h + q) % cpg;
  }
  auto load_next = [&](TcItem& it) {
    const int r0 = lt * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * ls + 4 * h + q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = c < nch && r0 + 8 * r < N;
        it.w[2 * r + h] = ok ? __ldcs(reinterpret_cast<const uint4*>(
                                   wt + 8LL * r * K + 128 * ls + 64 * h))
                             : make_uint4(0u, 0u, 0u, 0u);
        it.s[2 * r + h] = ok ? __ldg(st0 + 8 * r * NB + grp[h]) : 0.0f;
      }
    }
    if (++ls == nsb) {
      ls = 0;
      lt += warps;
      wt += 16LL * warps * K;
      st0 += 16LL * warps * NB;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        grp[h] = grp0[h];
        rem[h] = rem0[h];
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (rem[h] += 8; rem[h] >= cpg; rem[h] -= cpg) ++grp[h];
    }
  };

  // x rows [0, T) of the slab as they are (bf16); rows T.. 7 and k past the
  // slab zero.  Its loads go out before the weights', so as not to queue
  // behind them.
  constexpr int kXUnits = kTcXBytes / 16, kXPer = (kXUnits + kTcThreads - 1) / kTcThreads;
  uint4 xv[kXPer];
#pragma unroll
  for (int j = 0; j < kXPer; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    const int t = i / (kTcXRow / 16), o = i % (kTcXRow / 16);
    xv[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kXUnits && t < T && 8 * o < kslab)
      xv[j] = *reinterpret_cast<const uint4*>(x + (long long)t * K + k0 + 8 * o);
  }
  TcItem a, b;
  if (n_items > 0) load_next(a);
#pragma unroll
  for (int j = 0; j < kXPer; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    if (i < kXUnits) *reinterpret_cast<uint4*>(xs + 16 * i) = xv[j];
  }
  __syncthreads();

  float d[2][4] = {};
  int ct = first, cs = 0;          // the tile and step being computed
  auto step = [&](const TcItem& cur, TcItem& nxt, int i) {
    if (i + 1 < n_items) load_next(nxt);
    // x[g][chunk q], then x[g][chunk q + 4], of this step
    const unsigned char* xr = xs + g * kTcXRow + 256 * cs + 32 * q;
    uint32_t xw[16];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + 128 * (m / 2) + 16 * (m % 2));
      xw[4 * m] = v.x;
      xw[4 * m + 1] = v.y;
      xw[4 * m + 2] = v.z;
      xw[4 * m + 3] = v.w;
    }
    tc_step(cur, xw, d);
    if (++cs == nsb) {
      // d[0] + d[1] holds rows g, g + 8 of the tile at x rows 2q, 2q + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 2 * q + (e & 1), n = ct * 16 + g + 8 * (e >> 1);
        if (t < T && n < N) {
          float* o = out + (long long)t * N + n;
          const float v = d[0][e] + d[1][e];
          *o = accumulate ? *o + v : v;
        }
        d[0][e] = d[1][e] = 0.0f;
      }
      cs = 0;
      ct += warps;
    }
  };
  // two buffers in turn, so the next step's loads fly under this one's math
  for (int i = 0; i < n_items; i += 2) {
    step(a, b, i);
    if (i + 1 < n_items) step(b, a, i + 1);
  }
}

cudaError_t launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scales, float* out,
                      int T, int N, int K, int NB, cudaStream_t stream, int* launches) {
  static int resident = 0;         // blocks the card holds at once
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequant_matmul_tc_kernel,
                                                          kTcThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = ((N + 15) / 16 + kTcWarps - 1) / kTcWarps;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  for (int t0 = 0; t0 < T; t0 += kMaxTile) {
    const int tt = T - t0 < kMaxTile ? T - t0 : kMaxTile;
    for (int k0 = 0; k0 < K; k0 += kTcSlab) {
      const int kslab = K - k0 < kTcSlab ? K - k0 : kTcSlab;
      dequant_matmul_tc_kernel<<<grid, kTcThreads, 0, stream>>>(
          x + (long long)t0 * K, w, scales, out + (long long)t0 * N, tt, N, K, NB, k0, kslab,
          k0 > 0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      ++*launches;
    }
  }
  return cudaSuccess;
}

// --------------------------------------- FFMA route (fp32 x or fp32 weights)

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

template <typename TX, int TT, bool ROUND_BF16>
cudaError_t launch_tt(const void* x, const int8_t* w, const float* scales, float* out,
                      int T, int N, int K, int NB, cudaStream_t stream) {
  const unsigned grid = (unsigned)((N + kWarps * kRows - 1) / (kWarps * kRows));
  dequant_matmul_kernel<TX, TT, ROUND_BF16><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), w, scales, out, T, N, K, NB);
  return cudaGetLastError();
}

template <typename TX, bool ROUND_BF16>
cudaError_t launch(const void* x, const int8_t* w, const float* scales, float* out,
                   int T, int N, int K, int NB, cudaStream_t stream) {
  // smallest row tile that covers T (decode batches are 1-8 rows)
  if (T <= 1) return launch_tt<TX, 1, ROUND_BF16>(x, w, scales, out, T, N, K, NB, stream);
  if (T <= 2) return launch_tt<TX, 2, ROUND_BF16>(x, w, scales, out, T, N, K, NB, stream);
  if (T <= 4) return launch_tt<TX, 4, ROUND_BF16>(x, w, scales, out, T, N, K, NB, stream);
  return launch_tt<TX, 8, ROUND_BF16>(x, w, scales, out, T, N, K, NB, stream);
}

}  // namespace

extern "C" {

// x (T, K) float32 (x_dtype 0) or bfloat16 (1); w (N, K) int8; scales
// (N, NB) f32; out (T, N) f32.  Requires K % 16 == 0 and (K / NB) % 16 ==
// 0; every pointer contiguous and 16-byte aligned (checked by the wrapper).
// bf16 x with weights rounded to bf16 takes the tensor cores, the rest the
// FFMA kernel.  *launches is set to the number of kernel launches made.
int repro_dequant_matmul(int device, const void* x, int x_dtype, const int8_t* w,
                         const float* scales, float* out, int T, int N, int K, int NB,
                         int round_bf16, void* stream, int* launches) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K % 16 || NB <= 0 || K % NB || (K / NB) % 16) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && round_bf16)
    return (int)launch_tc(static_cast<const __nv_bfloat16*>(x), w, scales, out, T, N, K, NB,
                          s, launches);
  if (x_dtype == 1)
    err = launch<__nv_bfloat16, false>(x, w, scales, out, T, N, K, NB, s);
  else if (x_dtype == 0 && round_bf16)
    err = launch<float, true>(x, w, scales, out, T, N, K, NB, s);
  else if (x_dtype == 0)
    err = launch<float, false>(x, w, scales, out, T, N, K, NB, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err == cudaSuccess) *launches = 1;   // the FFMA kernel: one launch
  return (int)err;
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
