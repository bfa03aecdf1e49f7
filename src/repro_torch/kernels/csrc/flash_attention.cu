// Flash attention in fp32 on the CUDA cores (sm_90a): the float32 route of
// the forward (B6) and the backward (B7), for the GQA layout q (B, Sq, H,
// hd), k and v (B, S, K, hd), query head h reading KV head h / (H / K).
// bf16 calls, the training path's, take the tensor-core kernels of
// flash_attention_tc.cu instead (the wrapper dispatches by dtype): with
// arbitrary fp32 q and k, bf16 tensor-core products could not hold the
// reference's fp32 bars (2e-5 forward, 3e-5 backward) without splitting
// both operands, so fp32 stays here.
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_fwd_pallas (_fwd_kernel, _masked_logits)  -> flash_fwd_kernel
//   flash_bwd_pallas (_bwd_dq_kernel)               -> flash_bwd_dq_kernel
//   flash_bwd_pallas (_bwd_dkv_kernel)              -> flash_bwd_dkv_kernel
// with the same arithmetic: fp32 logits times scale, softcap tanh(x/c)*c,
// -1e30 (not -inf) in masked places, m/l running stats, l clamped at
// 1e-30; a backward entirely in fp32 with p = exp(logits - m) / l, dl = p *
// (dO.V^T - dsum) and the softcap chain 1 - t^2 (zero where logits <=
// -1e30/2).
//
// What bounds them on this card: operations, and every product is fp32
// FFMA (never TF32), so the floor is the CUDA cores' 67 TFLOP/s.
//
// Design.  All three kernels tile by 64 query rows x 64 kv rows with 256
// threads, except the backward at hd 256 (below).  A tile of one head is
// staged in shared memory as fp32, row-major with a row of hd + 1 floats
// (c + 1 for a p/dl tile of c columns).  A row of an odd number of words
// puts rows r and r + 1 on neighbouring banks, so every scalar shared read
// of the inner loops (one row broadcast, or 16 consecutive rows, or 16
// consecutive columns) is free of bank conflicts whichever operand layout
// a product wants, at every hd: 17, 65, 129 and 257 words.  Thread (ty,
// tx) of a 16 x 16 grid owns rows ty + 16 i and columns tx + 16 j of a
// product tile and columns tx + 16 j of the hd-wide accumulators (j < hd
// / 16); a row's 16 threads are one half-warp, so its max and sum reduce
// by shuffles.  Nothing goes through atomics: the results are the same
// bit for bit from run to run.
// At hd 256 a 64-row tile is 65.8 KB, so the backward's staged tiles
// (q, dO, K, V and p/dl) would need 280 KB (dq) and 297 KB (dk/dv), more
// than a block's 227 KB.  There the kernels take 32-row kv tiles: dq
// walks kv in tiles of 32 (the 64 x 32 logits), and dk/dv owns 32 kv rows
// (the 32 x 64 transposed logits), 206 and 215 KB.  The forward keeps 64
// (Q, K-or-p and V: 197 KB).
//  * forward: grid (q tile, h, b).  The q tile stays in shared memory; the
//    block walks its kv tiles, stages K and V, computes the 64 x 64 logits,
//    updates (m, l) and rescales the fp32 accumulator held in registers,
//    writes p over K's slot and adds p.V.  The epilogue clamps l, divides
//    and writes out in (B, Sq, H, hd) and m, l in (B, H, Sq).  No
//    transposes: the kernel reads q, k, v through their strides.
//  * dq: grid (q tile, h, b), q-major as in the reference.  q and dO stay
//    in shared memory; per kv tile the block rebuilds p and dl and adds
//    dl.K.  dsum = rowsum(dO * O) comes in from a plain reduction, as it is
//    outside the reference's kernels.
//  * dk/dv: grid (kv tile, kv head, b), kv-major.  K and V stay in shared
//    memory; the block walks the H / K query heads of its group and their
//    q tiles, rebuilds p^T and dl^T and adds p^T.dO and dl^T.q, so dk and
//    dv are summed over the group inside one block.
// Tiles that are wholly masked are skipped.  They add exact zeros in the
// reference: above the causal diagonal p = exp(-1e30 - m) = 0 and the
// correction is exp(0) = 1, and in the backward p = 0 there too.  A
// sliding-window row's wholly masked leading tiles give m = -1e30 and
// p = 1 in the reference, but the first tile that holds a valid key
// rescales them by exp(-1e30 - m) = 0; every row has one (k = q, since
// Sq <= S), so skipping them changes nothing.
//
// Precision: fp32 accumulation in fmaf, expf/tanhf and IEEE division (the
// library is built without --use_fast_math).  The kernels' 64-wide tiles
// sum in another order than the reference's 512-wide ones, so they agree
// with the plain version to fp32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                 // q rows (and kv rows below hd 256)
constexpr int kLP = kTile + 1;            // row of a 64 x 64 p / dl tile
constexpr float kNegInf = -1e30f;

// kv rows per tile of the backward kernels at head dim HD (see the note)
template <int HD> struct Bwd {
  static constexpr int KT = HD > 128 ? 32 : kTile;
  static constexpr int LP = KT + 1;       // row of a 64 x KT (or KT x 64) tile
};

// Element strides of a (B, S, heads, hd) tensor; hd is contiguous.
struct Strides {
  long long b, s, h;
};

// Stage rows [s0, s0 + R) of head h of batch b as fp32 in dst[R][HD + 1].
// Consecutive threads take consecutive rows, so the shared stores hit
// distinct banks; each reads 16 bytes of its row.
template <int HD, int R = kTile>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          Strides st, int b, int s0, int h) {
  constexpr int kVec = 4;
  constexpr int kVecs = HD / kVec;
  const float* base = src + b * st.b + (long long)s0 * st.s + h * st.h;
  for (int idx = threadIdx.x; idx < R * kVecs; idx += kThreads) {
    const int r = idx % R, c = (idx / R) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(base + r * st.s + c);
    const float* e = reinterpret_cast<const float*>(&raw);
    float* d = dst + r * (HD + 1) + c;
#pragma unroll
    for (int i = 0; i < kVec; ++i) d[i] = e[i];
  }
}

struct Mask {
  float scale, softcap;
  int causal, window;

  // The reference's _masked_logits for one element.
  __device__ __forceinline__ float logit(float dot, int qp, int kp) const {
    float x = dot * scale;
    if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
    bool ok = true;
    if (causal) ok = ok && qp >= kp;
    if (window) ok = ok && qp - kp < window;
    return ok ? x : kNegInf;
  }
  // True when every (q, k) pair of the q tile [q0, q0 + qn) and the kv
  // tile [k0, k0 + kn) is masked.
  __device__ __forceinline__ bool skip(int q0, int k0, int qn = kTile, int kn = kTile) const {
    return (causal && q0 + qn - 1 < k0) || (window && q0 - (k0 + kn - 1) >= window);
  }
  // dl's softcap factor 1 - t^2, zero on masked logits.
  __device__ __forceinline__ float cap_grad(float lg) const {
    if (softcap == 0.0f) return 1.0f;
    const float t = lg / softcap;
    return lg <= kNegInf / 2 ? 0.0f : 1.0f - t * t;
  }
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum_d A[ra + 16 i][d] * B[rb + 16 j][d] over d < n, A and B
// row-major with rows of ld floats (the 16 NI x 16 NJ tile of a product
// A B^T).
template <int N, int LD, int NI = 4, int NJ = 4>
__device__ __forceinline__ void tile_abt(float (&acc)[NI][NJ], const float* __restrict__ A,
                                         const float* __restrict__ B, int ra, int rb) {
#pragma unroll 4
  for (int d = 0; d < N; ++d) {
    float a[NI], bb[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[(ra + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bb[j] = B[(rb + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P[ra + 16 i][c] * X[c][cx + 16 j] over c < NC, P with
// rows of LP floats, X with rows of HD + 1 (the hd-wide product P X of
// 16 NI rows).
template <int HD, int NI = 4, int NC = kTile, int LP = kLP>
__device__ __forceinline__ void tile_px(float (&acc)[NI][HD / 16], const float* __restrict__ P,
                                        const float* __restrict__ X, int ra, int cx) {
  constexpr int DC = HD / 16;
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    float a[NI], x[DC];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = P[(ra + 16 * i) * LP + c];
#pragma unroll
    for (int j = 0; j < DC; ++j) x[j] = X[c * (HD + 1) + cx + 16 * j];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 Strides sq, Strides sk, Strides sv, int Sq, int S, int H, int K, Mask mk) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;
  constexpr int KP = kTile * LD > kTile * kLP ? kTile * LD : kTile * kLP;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [64][LD]
  float* Ks = Qs + kTile * LD;      // [64][LD]; p [64][kLP] once the logits are in
  float* Vs = Ks + KP;              // [64][LD]
  float* Ps = Ks;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<HD>(Qs, q, sq, b, q0, h);
  float acc[4][DC], m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    if (mk.skip(q0, k0)) continue;
    __syncthreads();                      // the last tile's p and V are read
    load_tile<HD>(Ks, k, sk, b, k0, g);
    load_tile<HD>(Vs, v, sv, b, k0, g);
    __syncthreads();
    float s[4][4] = {};
    tile_abt<HD, LD>(s, Qs, Ks, ty, tx);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mk.logit(s[i][j], qp, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + half_warp_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                      // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kLP + tx + 16 * j] = p[i][j];
    __syncthreads();
    tile_px<HD>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l = fmaxf(l_i[i], 1e-30f);
    float* o = out + (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] / l;
    if (tx == 0) {
      const long long at = ((long long)b * H + h) * Sq + row;
      m_out[at] = m_i[i];
      l_out[at] = l;
    }
  }
}

// -------------------------------------------------------------- backward

// dq: q-major, kv in tiles of KT rows.  m, l and dsum are (B, H, Sq); dq
// is written (B, Sq, H, hd).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ l, const float* __restrict__ dsum,
                    float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sd,
                    int Sq, int S, int H, int K, Mask mk) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;
  constexpr int KT = Bwd<HD>::KT, LP = Bwd<HD>::LP, NJ = KT / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [64][LD]
  float* Ds = Qs + kTile * LD;      // dO [64][LD]
  float* Ks = Ds + kTile * LD;      // [KT][LD]
  float* Vs = Ks + KT * LD;         // [KT][LD]
  float* Ls = Vs + KT * LD;         // dl [64][LP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<HD>(Qs, q, sq, b, q0, h);
  load_tile<HD>(Ds, dout, sd, b, q0, h);
  float mr[4], lr[4], dr[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = ((long long)b * H + h) * Sq + row;
    mr[i] = m[at];
    lr[i] = l[at];
    dr[i] = dsum[at];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += KT) {
    if (mk.skip(q0, k0, kTile, KT)) continue;
    __syncthreads();
    load_tile<HD, KT>(Ks, k, sk, b, k0, g);
    load_tile<HD, KT>(Vs, v, sv, b, k0, g);
    __syncthreads();
    float s[4][NJ] = {}, dp[4][NJ] = {};
    tile_abt<HD, LD, 4, NJ>(s, Qs, Ks, ty, tx);
    tile_abt<HD, LD, 4, NJ>(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float lg = mk.logit(s[i][j], qp, k0 + tx + 16 * j);
        const float p = expf(lg - mr[i]) / lr[i];
        Ls[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - dr[i]) * mk.cap_grad(lg);
      }
    }
    __syncthreads();
    tile_px<HD, 4, KT, LP>(acc, Ls, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = dq + (((long long)b * Sq + q0 + ty + 16 * i) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] * mk.scale;
  }
}

// dk/dv: kv-major, KT kv rows a block, summed over the H / K query heads of
// the group.  dk and dv are written (B, S, K, hd).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ dsum,
                     float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sd, int Sq, int S, int H, int K, Mask mk) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;
  constexpr int KT = Bwd<HD>::KT, NI = KT / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [KT][LD]
  float* Vs = Ks + KT * LD;         // [KT][LD]
  float* Qs = Vs + KT * LD;         // [64][LD]
  float* Ds = Qs + kTile * LD;      // dO [64][LD]
  float* Pt = Ds + kTile * LD;      // p^T [KT kv][kLP]
  float* Lt = Pt + KT * kLP;        // dl^T [KT kv][kLP]
  float* st = Lt + KT * kLP;        // m, l, dsum of the q tile [3][64]

  const int k0 = blockIdx.x * KT;   // causal: the first kv tiles see the most q tiles
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<HD, KT>(Ks, k, sk, b, k0, g);
  load_tile<HD, KT>(Vs, v, sv, b, k0, g);
  float ak[NI][DC], av[NI][DC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) ak[i][j] = av[i][j] = 0.0f;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    for (int q0 = 0; q0 < Sq; q0 += kTile) {
      if (mk.skip(q0, k0, kTile, KT)) continue;
      __syncthreads();
      load_tile<HD>(Qs, q, sq, b, q0, h);
      load_tile<HD>(Ds, dout, sd, b, q0, h);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * H + h) * Sq + row;
        st[threadIdx.x] = m[at];
        st[kTile + threadIdx.x] = l[at];
        st[2 * kTile + threadIdx.x] = dsum[at];
      }
      __syncthreads();
      // rows: kv (ty + 16 i), columns: q (tx + 16 j)
      float s[NI][4] = {}, dp[NI][4] = {};
      tile_abt<HD, LD, NI, 4>(s, Ks, Qs, ty, tx);
      tile_abt<HD, LD, NI, 4>(dp, Vs, Ds, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float mq = st[c], lq = st[kTile + c], dq_ = st[2 * kTile + c];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float lg = mk.logit(s[i][j], q0 + c, k0 + ty + 16 * i);
          const float p = expf(lg - mq) / lq;
          Pt[(ty + 16 * i) * kLP + c] = p;
          Lt[(ty + 16 * i) * kLP + c] = p * (dp[i][j] - dq_) * mk.cap_grad(lg);
        }
      }
      __syncthreads();
      tile_px<HD, NI>(av, Pt, Ds, ty, tx);
      tile_px<HD, NI>(ak, Lt, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const long long at = (((long long)b * S + k0 + ty + 16 * i) * K + g) * HD;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[at + tx + 16 * j] = ak[i][j] * mk.scale;
      dv[at + tx + 16 * j] = av[i][j];
    }
  }
}

// ------------------------------------------------------------------ host

struct Shape {
  int B, Sq, S, H, K;
};

Strides strides_at(const long long* s, int t) { return Strides{s[3 * t], s[3 * t + 1], s[3 * t + 2]}; }

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Dynamic shared memory of each kernel (0 forward, 1 dq, 2 dk/dv).
template <int HD> size_t smem_bytes(int which) {
  constexpr int LD = HD + 1;
  constexpr int KP = kTile * LD > kTile * kLP ? kTile * LD : kTile * kLP;
  constexpr int KT = Bwd<HD>::KT;
  return sizeof(float) * (which == 0   ? 2 * kTile * LD + KP
                          : which == 1 ? 2 * (kTile + KT) * LD + kTile * Bwd<HD>::LP
                                       : 2 * (kTile + KT) * LD + 2 * KT * kLP + 3 * kTile);
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                const long long* st, Shape sh, Mask mk, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(0);
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(sh.Sq / kTile, sh.H, sh.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), m, l, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      sh.Sq, sh.S, sh.H, sh.K, mk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* dout, const float* m,
                const float* l, const float* dsum, void* dq, void* dk, void* dv,
                const long long* st, Shape sh, Mask mk, cudaStream_t stream) {
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1), sv = strides_at(st, 2),
                sd = strides_at(st, 3);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
          *vp = static_cast<const float*>(v), *dp = static_cast<const float*>(dout);

  const size_t smem_dq = smem_bytes<HD>(1);
  auto kdq = flash_bwd_dq_kernel<HD>;
  cudaError_t e = allow_smem(kdq, smem_dq);
  if (e != cudaSuccess) return e;
  kdq<<<dim3(sh.Sq / kTile, sh.H, sh.B), kThreads, smem_dq, stream>>>(
      qp, kp, vp, dp, m, l, dsum, static_cast<float*>(dq), sq, sk, sv, sd, sh.Sq, sh.S, sh.H,
      sh.K, mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_dkv = smem_bytes<HD>(2);
  auto kdkv = flash_bwd_dkv_kernel<HD>;
  e = allow_smem(kdkv, smem_dkv);
  if (e != cudaSuccess) return e;
  kdkv<<<dim3(sh.S / Bwd<HD>::KT, sh.K, sh.B), kThreads, smem_dkv, stream>>>(
      qp, kp, vp, dp, m, l, dsum, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, sv, sd,
      sh.Sq, sh.S, sh.H, sh.K, mk);
  return cudaGetLastError();
}

bool valid(int hd, Shape sh) {
  return (hd == 16 || hd == 64 || hd == 128 || hd == 256) && sh.B > 0 && sh.K > 0 &&
         sh.H % sh.K == 0 && sh.Sq % kTile == 0 && sh.S % kTile == 0 && sh.Sq > 0 &&
         sh.Sq <= sh.S;
}

#define REPRO_HD_DISPATCH(CALL) \
  switch (hd) {                 \
    case 16: return CALL(16);   \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    default: return CALL(256);  \
  }

}  // namespace

extern "C" {

// Forward, float32.  q (B, Sq, H, hd), k and v (B, S, K, hd), each with a
// contiguous hd and element strides (b, s, head) in strides[0..8] (q, k,
// v); rows 16-byte aligned.  Writes out (B, Sq, H, hd) contiguous, m and l
// (B, H, Sq).  Requires hd in {16, 64, 128, 256} (the port's configs:
// qwen3-0.6b, gpt-350m, gemma3-4b and the reduced test shapes), H % K ==
// 0, Sq and S multiples of 64, Sq <= S.
int repro_flash_fwd_f32(int device, int hd, const void* q, const void* k, const void* v,
                        void* out, float* m, float* l, const long long* strides, int B, int Sq,
                        int S, int H, int K, float scale, int causal, int window, float softcap,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{B, Sq, S, H, K};
  if (!valid(hd, sh) || window < 0) return (int)cudaErrorInvalidValue;
  const Mask mk{scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(HD) (int)fwd<HD>(q, k, v, out, m, l, strides, sh, mk, s)
  REPRO_HD_DISPATCH(REPRO_FWD)
#undef REPRO_FWD
}

// Backward, float32: the dq kernel, then the dk/dv kernel, on one stream.
// As the forward, plus dout (B, Sq, H, hd) with its strides in
// strides[9..11], m and l from the forward and dsum = rowsum(dout * out),
// all three (B, H, Sq).  Writes dq (B, Sq, H, hd), dk and dv (B, S, K,
// hd), contiguous.
int repro_flash_bwd_f32(int device, int hd, const void* q, const void* k, const void* v,
                        const void* dout, const float* m, const float* l, const float* dsum,
                        void* dq, void* dk, void* dv, const long long* strides, int B, int Sq,
                        int S, int H, int K, float scale, int causal, int window, float softcap,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{B, Sq, S, H, K};
  if (!valid(hd, sh) || window < 0) return (int)cudaErrorInvalidValue;
  const Mask mk{scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(HD) (int)bwd<HD>(q, k, v, dout, m, l, dsum, dq, dk, dv, strides, sh, mk, s)
  REPRO_HD_DISPATCH(REPRO_BWD)
#undef REPRO_BWD
}

// Dynamic shared memory, in bytes, of the forward (which 0), dq (1) or
// dk/dv (2) kernel at head dim hd.
int repro_flash_f32_smem(int which, int hd) {
#define REPRO_SMEM(HD) (int)smem_bytes<HD>(which)
  REPRO_HD_DISPATCH(REPRO_SMEM)
#undef REPRO_SMEM
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
