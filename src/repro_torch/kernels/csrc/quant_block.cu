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
// What bounds B1 and B2: bytes.  Each is a single pass over memory with a
// handful of operations per element (quantize: 2 B read + 1 B written per
// bf16 element; dequantize: 1 B read + 2 B written), far below the card's
// ~295 operations per byte, so the goal is to move each byte once, in
// wide coalesced transactions.  B3 reads 2 B and writes 1/2 B per bf16
// element (INT4), so bytes bound it too; run on B1's body it would pay a
// rintf and a float->int convert per element on Hopper's conversion pipe
// (16 results per clock per SM), and the reorder index 64-bit divisions
// per lane.  Its own design is below.
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
//   reordered (B3): one warp per warp tile of 1,024 elements of one (x, y)
//               output slice.  A lane owns 32 elements of one quant block
//               (block/32 lanes a block, log2(block/32) shuffles for the
//               absmax) as 16-byte chunks interleaved with its block's
//               other lanes, so each 16-byte load instruction reads whole
//               128-byte lines.  The quantize body is qgz_stream.cuh's: no
//               conversion-pipe instruction per element.  The slice (x, y)
//               comes from one 32-bit division per tile; output slice (x,
//               y) reads input row (y, x) of the (Y, X, L) gradient: the
//               qgZ transpose lives in the load index, with no transpose
//               pass.  The u field, like the output, is laid out (X, Y, L).
//               What bounds it now: bytes, at the rate the memory system
//               gives a 4:1 read/write stream (chip_smoke.py times a plain
//               copy_ that moves the same bytes beside it).  Two designs
//               read slower on the card: a persistent grid with the next
//               tile's loads in flight, and the tiles staged by a TMA
//               bulk-copy ring in shared memory (PERF.md keeps their times).
//   dequantize: one thread per 16 output elements: one 16-byte (INT8) or
//               8-byte (INT4) payload load, one scale, 32 (bf16) or 64
//               (f32) bytes stored.
// Numerics match the plain version bit for bit: scale = absmax * fl(1/qmax)
// and s = x * (1/scale) use the round-to-nearest intrinsics (no FMA
// contraction), rounding is half to even (B1: rintf; B3: the exact
// magic-number add of qgz_stream.cuh), and the bf16 cast is
// __float2bfloat16_rn.  Build without --use_fast_math.
#include <cuda_bf16.h>
#include "qgz_stream.cuh"

namespace {

// ---- B1's one-warp-per-block body (numerics: core/quant.py, bit for bit)
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
// block's scale.
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


// B1: one warp per quant block.
template <typename T, int EPL, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ u,
                int8_t* __restrict__ payload, float* __restrict__ scales,
                long long n_blocks) {
  const long long blk = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (blk >= n_blocks) return;  // whole warp exits together
  const int lane = threadIdx.x % kWarp;
  const long long base = blk * (EPL * kWarp) + (long long)lane * EPL;
  float v[EPL];
  load_f32<T, EPL>(x + base, v);
  quantize_regs<EPL, BITS>(v, u == nullptr ? nullptr : u + base,
                           payload + (BITS == 8 ? base : base / 2), scales + blk, lane);
}

namespace qz = repro_qgz;

// B3's chunks: a 16-byte run of the input, kChunk elements.
template <typename T>
struct Chunks {
  static constexpr int kChunk = 16 / (int)sizeof(T);   // 8 bf16, 4 f32
  static constexpr int kPer = qz::kLane / kChunk;      // chunks a lane owns
  uint4 c[kPer];
};

// Lane l of a block's lpb lanes (p = l % lpb) owns the block's chunks p,
// p + lpb, p + 2 lpb, ...: its element i is element elem_offset(i) of the
// block.
template <typename T>
__device__ __forceinline__ int elem_offset(int i, int lpb, int p) {
  constexpr int kChunk = Chunks<T>::kChunk;
  return (i / kChunk * lpb + p) * kChunk + i % kChunk;
}

// Where a lane's work starts in warp tile t (tps tiles a slice): b0, the
// element offset of its quant block in its output slice (x, y) = (s / Y,
// s % Y), read from input row (y, x); valid if b0 < L.
struct LaneTile {
  long long in_row, out_row, b0;
  int p;
  bool valid;
};

__device__ __forceinline__ LaneTile lane_tile(int t, int tps, int Y, int X, long long L,
                                              int shift, int lane) {
  const int s = t / tps;                          // one division a tile
  const int j = t - s * tps;
  const int xi = s / Y, yi = s - xi * Y;
  LaneTile lt;
  lt.in_row = (long long)yi * X + xi;
  lt.out_row = s;
  lt.b0 = (long long)j * qz::kTile + ((long long)(lane >> (shift - 5)) << shift);
  lt.p = lane & ((1 << (shift - 5)) - 1);
  lt.valid = lt.b0 < L;
  return lt;
}

// The lane's chunks from `row`, the start of its quant block; zeros for an
// idle lane.
template <typename T>
__device__ __forceinline__ void load_chunks(Chunks<T>& c, const T* __restrict__ row, int lpb,
                                            int p, bool valid) {
#pragma unroll
  for (int i = 0; i < Chunks<T>::kPer; ++i)
    c.c[i] = valid ? __ldcs(reinterpret_cast<const uint4*>(
                         row + elem_offset<T>(i * Chunks<T>::kChunk, lpb, p)))
                   : make_uint4(0, 0, 0, 0);
}

template <typename T>
__device__ __forceinline__ void chunks_f32(const Chunks<T>& c, float (&v)[qz::kLane]) {
#pragma unroll
  for (int i = 0; i < Chunks<T>::kPer; ++i) {
    const uint32_t w[4] = {c.c[i].x, c.c[i].y, c.c[i].z, c.c[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        qz::bf16x2_f32(w[k], v[8 * i + 2 * k], v[8 * i + 2 * k + 1]);
      } else {
        v[4 * i + k] = __uint_as_float(w[k]);
      }
    }
  }
}

// Quantize the lane's 32 elements and store its payload chunks and (from
// the block's first lane) the block's scale, in the (X, Y, L) layout.
template <typename T, int BITS>
__device__ __forceinline__ void quantize_store(const float (&v)[qz::kLane], const LaneTile& lt,
                                               const float* __restrict__ u,
                                               int8_t* __restrict__ payload,
                                               float* __restrict__ scales, long long L,
                                               int shift) {
  constexpr int kChunk = Chunks<T>::kChunk;
  const int lpb = 1 << (shift - 5);
  const long long out0 = lt.out_row * L + lt.b0;  // the block's first output element
  uint32_t words[BITS == 4 ? 4 : 8];
  const float s = qz::quantize_lane<BITS>(
      v, lpb, u != nullptr,
      [&](int i) { return lt.valid ? __ldg(u + out0 + elem_offset<T>(i, lpb, lt.p)) : 0.0f; },
      words);
  if (!lt.valid) return;
#pragma unroll
  for (int i = 0; i < Chunks<T>::kPer; ++i) {
    const long long e = out0 + elem_offset<T>(i * kChunk, lpb, lt.p);
    if constexpr (BITS == 4 && kChunk == 8) {        // bf16 -> INT4: one word a chunk
      reinterpret_cast<uint32_t*>(payload)[e / 8] = words[i];
    } else if constexpr (BITS == 4) {                // f32 -> INT4: half a word
      reinterpret_cast<uint16_t*>(payload)[e / 4] =
          (uint16_t)(i % 2 ? words[i / 2] >> 16 : words[i / 2]);
    } else if constexpr (kChunk == 8) {              // bf16 -> INT8: two words
      reinterpret_cast<uint2*>(payload)[e / 8] = make_uint2(words[2 * i], words[2 * i + 1]);
    } else {                                         // f32 -> INT8: one word
      reinterpret_cast<uint32_t*>(payload)[e / 4] = words[i];
    }
  }
  if (lt.p == 0) scales[out0 >> shift] = s;
}

// B3.  x: (Y, X, L); payload, scales and u: the (X, Y, .) output layout.
// Warp t takes warp tile t of the Y * X * tps tiles (tps = ceil(L / 1024)
// a slice).
template <typename T, int BITS>
__global__ void __launch_bounds__(qz::kThreads)
quantize_reordered_kernel(const T* __restrict__ x, const float* __restrict__ u,
                          int8_t* __restrict__ payload, float* __restrict__ scales, int Y,
                          int X, long long L, int tps, int n_tiles, int shift) {
  const int t = blockIdx.x * qz::kWarps + threadIdx.x / qz::kWarp;
  if (t >= n_tiles) return;                       // whole warp exits together
  const int lane = threadIdx.x % qz::kWarp;
  const LaneTile lt = lane_tile(t, tps, Y, X, L, shift, lane);
  Chunks<T> buf;
  load_chunks<T>(buf, x + lt.in_row * L + lt.b0, 1 << (shift - 5), lt.p, lt.valid);
  float v[qz::kLane];
  chunks_f32(buf, v);
  quantize_store<T, BITS>(v, lt, u, payload, scales, L, shift);
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

template <typename T, int BITS>
cudaError_t launch_quantize_bits(const void* x, const float* u, int8_t* payload,
                                 float* scales, long long n_blocks, int block,
                                 cudaStream_t stream) {
  const long long grid = (n_blocks + kThreads / kWarp - 1) / (kThreads / kWarp);
  const T* xp = static_cast<const T*>(x);
  switch (block) {
#define REPRO_Q_CASE(B)                                                        \
  case B:                                                                      \
    quantize_kernel<T, B / kWarp, BITS>                                        \
        <<<(unsigned)grid, kThreads, 0, stream>>>(xp, u, payload, scales,      \
                                                  n_blocks);                   \
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

template <typename T>
cudaError_t launch_quantize(const void* x, const float* u, int8_t* payload, float* scales,
                            long long n_blocks, int block, int bits, cudaStream_t stream) {
  if (bits == 8)
    return launch_quantize_bits<T, 8>(x, u, payload, scales, n_blocks, block, stream);
  if (bits == 4)
    return launch_quantize_bits<T, 4>(x, u, payload, scales, n_blocks, block, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int BITS>
cudaError_t launch_reordered_bits(const void* x, const float* u, int8_t* payload,
                                  float* scales, int Y, int X, long long L, int shift,
                                  cudaStream_t stream) {
  const long long tps = (L + qz::kTile - 1) / qz::kTile;
  const long long n_tiles = (long long)Y * X * tps;
  if (n_tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_tiles + qz::kWarps - 1) / qz::kWarps);
  quantize_reordered_kernel<T, BITS><<<grid, qz::kThreads, 0, stream>>>(
      static_cast<const T*>(x), u, payload, scales, Y, X, L, (int)tps, (int)n_tiles, shift);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reordered(const void* x, const float* u, int8_t* payload, float* scales,
                             int Y, int X, long long L, int shift, int bits,
                             cudaStream_t stream) {
  if (bits == 8)
    return launch_reordered_bits<T, 8>(x, u, payload, scales, Y, X, L, shift, stream);
  if (bits == 4)
    return launch_reordered_bits<T, 4>(x, u, payload, scales, Y, X, L, shift, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)launch_quantize<float>(x, u, payload, scales, n_blocks, block, bits, s);
  if (x_dtype == 1)
    return (int)launch_quantize<__nv_bfloat16>(x, u, payload, scales, n_blocks, block, bits,
                                               s);
  return (int)cudaErrorInvalidValue;
}

// x: (Y, X, L) contiguous; u, payload, scales: the (X, Y, .) output layout.
int repro_quantize_reordered(int device, const void* x, int x_dtype, const float* u,
                             int8_t* payload, float* scales, int Y, int X,
                             long long L, int block, int bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int shift = qz::block_shift(block);
  if (shift < 0 || L % block) return (int)cudaErrorInvalidValue;
  if ((long long)Y * X * L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)launch_reordered<float>(x, u, payload, scales, Y, X, L, shift, bits, s);
  if (x_dtype == 1)
    return (int)launch_reordered<__nv_bfloat16>(x, u, payload, scales, Y, X, L, shift, bits,
                                                s);
  return (int)cudaErrorInvalidValue;
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
