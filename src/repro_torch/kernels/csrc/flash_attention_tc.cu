// Flash attention on Hopper's tensor cores (sm_90a): the bf16 route of the
// forward (B6) and the backward (B7), for the GQA layout q (B, Sq, H, hd),
// k and v (B, S, K, hd), query head h reading KV head h / (H / K).  fp32
// calls take the FFMA kernels of flash_attention.cu instead (the wrapper
// dispatches by dtype).
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_fwd_pallas (_fwd_kernel, _masked_logits)  -> flash_fwd_tc_kernel
//   flash_bwd_pallas (_bwd_dq_kernel)               -> flash_bwd_dq_tc_kernel
//   flash_bwd_pallas (_bwd_dkv_kernel)              -> flash_bwd_dkv_tc_kernel
// with the same arithmetic: fp32 logits times scale, softcap tanh(x/c)*c,
// -1e30 (not -inf) in masked places, m/l running stats, p rounded to v's
// dtype (bf16) before the PV product, l clamped at 1e-30; a backward in
// fp32 with p = exp(logits - m) / l, dl = p * (dO.V^T - dsum) and the
// softcap chain 1 - t^2 (zero where logits <= -1e30/2).
//
// What bounds them on this card: operations.  At the training shape (B 8,
// S 2048, H 16, K 8, hd 128, causal) the forward does about 680 operations
// per byte it must move, above the ~295 at which bf16 tensor cores stop
// waiting on memory, and the backward more.  So every product runs on the
// tensor cores as warp-level mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// and nothing but q, k, v, o, dO and the row stats crosses device memory.
//
// Precision.  Products whose inputs are bf16 values are exact on the tensor
// cores and summed in fp32: QK^T, the forward's PV (p is rounded to bf16
// first, as the reference does) and the backward's dO.V^T.  The backward's
// other three products, dl.K, p^T.dO and dl^T.Q, take the fp32 values p
// and dl.  Each enters as a pair of bf16 fragments, hi = bf16(x) and lo =
// bf16(x - hi), two products into the same fp32 accumulator: hi + lo holds
// 16 significant bits of x (relative error <= 2^-16), against 2^-8 for hi
// alone.  The CPU test test_tensor_core_split_prices_the_backward reads
// that choice against the reference's fp32 backward: hi + lo stays within
// the per-element bf16 bars, hi alone misses them by 30-70x; no third term.
// So the backward does 2 + 3 x 2 = 8 tensor-core products per (q, kv) pair,
// the forward 2.  Elementwise work is fp32 on the CUDA cores (the library
// is built without --use_fast_math) and, beside the products, what bounds
// the forward: about 15 instructions a logit against 512 tensor-core
// FLOP.  So a tile where the mask keeps every pair skips the mask's
// arithmetic, and exp(x) is exp2f(x log2 e), a relative 1.5e-6 from expf
// where p >= 2e-9 (the rounding of the product; exactly 1 at x = 0, 0 at
// -1e30).  tanhf and the division of out by l stay as the reference has
// them.  The backward forms p as exp(logit - m) * (1 / l), one rounding
// more than the reference's division (a relative 6e-8).
//
// Design, FA2-style: every block has 4 warps and tiles by 64 query rows x
// 64 kv rows; each warp owns 16 rows of the block's tile (query rows in the
// forward and dq kernels, kv rows in the dk/dv kernel), so a row's max and
// sum reduce within a quad of lanes by shuffles.  Operands are staged in
// shared memory as bf16 rows of hd + 8 elements: hd / 8 + 1 chunks of 16
// bytes, an odd count at every hd the kernels take (3, 9, 17 and 33), so
// the 8 consecutive rows an ldmatrix phase reads (and the 16-byte cp.async
// stores) land on 8 distinct groups of 4 banks, free of conflicts at hd
// 16, 64, 128 and 256.
// ldmatrix feeds the A and B fragments (.trans where a product wants the
// transposed operand: V in PV, K in dl.K, dO and Q in the dk/dv products).
// Tiles arrive by 16-byte cp.async and are double-buffered (commit and wait
// groups), so the copy of the next tile overlaps the products of this one.
//  * forward: grid (q tile, h, b).  The warp's Q fragments stay in registers
//    for the whole kv loop.  S = QK^T lands in fp32 accumulators; scale,
//    softcap and mask, the online (m, l) update and the rescale of the
//    output accumulator follow in registers.  P is rounded to bf16 and
//    repacked in registers as the A operand of PV: the C fragment of two
//    adjacent m16n8 tiles is the A fragment of one k16 step, so P never
//    touches shared memory.  Shared memory: Q, and K and V twice, 5 tiles
//    (87,040 bytes at hd 128).
//  * dq: grid (q tile, h, b), q-major.  Q and dO stay in shared memory, K
//    and V are double-buffered (6 tiles, 104,448 bytes at hd 128).  Per kv
//    tile the warp computes S and dP = dO.V^T, forms p and dl in registers
//    and adds dl.K with dl as hi/lo A fragments taken straight from the C
//    fragments, as the forward does with P.
//  * dk/dv: grid (kv tile, kv head, b), kv-major.  K and V stay in shared
//    memory; the block walks the H / K query heads of its group and their
//    q tiles as one double-buffered stream of (Q, dO, m, l, dsum) tiles (6
//    tiles and 3 x 2 rows of 64 floats, 105,984 bytes at hd 128).  It
//    computes the transposed products S^T = K.Q^T and dP^T = V.dO^T, so
//    p^T and dl^T come out in C fragments whose rows are kv rows and are
//    already the A operands of p^T.dO and dl^T.Q: no transpose through
//    shared memory or shuffles.  The q tile is taken in two halves of 32
//    columns to keep the dk and dv accumulators (64 floats each at hd 128)
//    and the logits within the register file.  dk and dv are summed over
//    the group inside one block.
// Nothing goes through atomics: the results are the same bit for bit from
// run to run.  Tiles that are wholly masked are skipped, exactly as in the
// FFMA kernels (flash_attention.cu's note gives why that changes nothing).
//
// Head dim 256 (gemma3-4b).  A staged tile is 64 x 264 x 2 = 33.8 KB, so
// the three kernels' 5, 6 and 6 tiles (169, 203 and 204 KB) still fit one
// block's 227 KB; what does not fit is the register file.  A warp's fp32
// accumulators over hd are 16 x 256 / 32 = 128 floats a thread, and every
// kernel above holds more beside them at hd 128 already (the forward 198
// registers with its Q fragments; dk/dv 255 and a 40-byte spill with two
// accumulators).  So at hd 256:
//  * forward: the Q fragments (64 registers at hd 256) are read from
//    shared memory by ldmatrix at each k step instead of held: 128
//    accumulators, 32 logits and the fragments in flight;
//  * dq: the kv tile's 64 columns are taken as two halves of 32 (as dk/dv
//    takes its q columns), which halves the logits and dp (32 registers,
//    not 64) beside the 128 accumulators;
//  * dk/dv: dk and dv are split between two warp groups, flash_bwd_dkv_tc_
//    split_kernel: 8 warps, warps 0-3 own dv and warps 4-7 dk of the same
//    16 kv rows each, so each warp holds one 128-float accumulator.  Both
//    groups form p from S^T = K.Q^T (the dv group does no dP^T); the price
//    is one QK^T product more per pair, 7 instead of 6 (+17 %), against a
//    32-row kv tile (which leaves the accumulators as they are: they are
//    per 16 rows of a warp, not per tile) or a grid split over hd halves
//    (which recomputes S^T and dP^T in each half: 8 products, +33 %).
//    hd <= 128 keep flash_bwd_dkv_tc_kernel, since the split is slower
//    there: with the split kernel at every hd (151 registers, no spill at
//    hd 128), chip_smoke.py's flash phase read B7 at qwen3-0.6b's shape
//    (8, 2048, 16/8, 128) causal 4.4321 and 4.3770 ms, against 3.1999 and
//    3.2762 ms with flash_bwd_dkv_tc_kernel (255 registers, 40 bytes
//    spilled), the versions run A, B, B, A in one call on an H100 80GB
//    HBM3 at 700 W: the extra QK^T product and the 8-warp blocks cost
//    more than the spill.
//
// Next step (ROADMAP Queue B): wgmma with TMA and warp specialisation.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                 // q rows and kv rows per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct Dims {
  static constexpr int LD = HD + 8;       // row of a staged tile, bf16
  static constexpr int TILE = kTile * LD; // one staged tile, bf16
  static constexpr int KS = HD / 16;      // k16 steps over hd
  static constexpr int DN = HD / 8;       // n8 tiles over hd
  static constexpr bool kWide = HD > 128; // the hd-256 layouts (see above)
  static constexpr int QCOLS = kWide ? 32 : kTile;  // dq: kv columns a pass
};

// Element strides of a (B, S, heads, hd) tensor; hd is contiguous.
struct Strides {
  long long b, s, h;
};

struct Mask {
  float scale, softcap;
  int causal, window;

  // The reference's _masked_logits for one element (kMasked false: of a
  // tile where no pair is masked).
  template <bool kMasked = true>
  __device__ __forceinline__ float logit(float dot, int qp, int kp) const {
    float x = dot * scale;
    if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
    if (!kMasked) return x;
    bool ok = true;
    if (causal) ok = ok && qp >= kp;
    if (window) ok = ok && qp - kp < window;
    return ok ? x : kNegInf;
  }
  // True when some (q, k) pair of the tiles at q0, k0 is masked.
  __device__ __forceinline__ bool edge(int q0, int k0) const {
    return (causal && k0 + kTile - 1 > q0) || (window && q0 + kTile - 1 - k0 >= window);
  }
  // True when every (q, k) pair of the tiles at q0, k0 is masked.
  __device__ __forceinline__ bool skip(int q0, int k0) const {
    return (causal && q0 + kTile - 1 < k0) || (window && q0 - (k0 + kTile - 1) >= window);
  }
  // dl's softcap factor 1 - t^2, zero on masked logits.
  __device__ __forceinline__ float cap_grad(float lg) const {
    if (softcap == 0.0f) return 1.0f;
    const float t = lg / softcap;
    return lg <= kNegInf / 2 ? 0.0f : 1.0f - t * t;
  }
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [s0, s0 + 64) of head h of batch b into dst[64][HD + 8] by 16-byte
// cp.async, a block of NT threads; consecutive threads take consecutive
// chunks of a row.
template <int HD, int NT = kThreads>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, Strides st,
                                           int b, int s0, int h) {
  constexpr int kVecs = HD / 8;
  const bf16* base = src + b * st.b + (long long)s0 * st.s + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += NT) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    cp_async16(dst + r * Dims<HD>::LD + c, base + r * st.s + c);
  }
}

// 64 contiguous floats (16-byte aligned) into dst by cp.async, threads
// [t0, t0 + 16).
__device__ __forceinline__ void stage_row(float* dst, const float* src, int t0) {
  const int t = threadIdx.x - t0;
  if (t >= 0 && t < kTile / 4) cp_async16(dst + 4 * t, src + 4 * t);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of rows [m0, m0 + 16) x columns [k0, k0 + 16) of a row-major
// staged tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                       int lane) {
  ldsm_x4(a, smem_addr(tile + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8));
}

// B fragments of the two n8 tiles [n0, n0 + 16) at k step [k0, k0 + 16),
// from a tile stored [n][k] (a product with the tile's transpose, A.T^T):
// b[0], b[1] for n0 and b[2], b[3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, smem_addr(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                       ((lane >> 3) & 1) * 8));
}

// As load_b_nk, from a tile stored [k][n] (a product A.T), by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                          int lane) {
  ldsm_x4_t(b, smem_addr(tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + n0 +
                         (lane >> 4) * 8));
}

// d += a b, m16n8k16, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// Two fp32 values as one bf16 pair (the lower column in the low half).
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}
// Two fp32 values as hi = bf16(x) and lo = bf16(x - hi) pairs.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// The A fragment of k step kk (columns [16 kk, 16 kk + 16)) from C
// fragments c[8][4] of a 16 x 64 fp32 tile, rounded to bf16 (hi), and the
// remainders (lo).
__device__ __forceinline__ void a_from_c(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// exp(x) as 2^(x log2 e), in fewer instructions than expf: within
// a relative 1.5e-6 of exp(x) for |x| <= 20 (the rounding of the product).
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The kv tiles [lo, hi) that a q tile at q0 meets (every other one is
// wholly masked).
__device__ __forceinline__ void kv_range(const Mask& mk, int q0, int S, int& lo, int& hi) {
  hi = mk.causal ? min(S, q0 + kTile) : S;
  lo = 0;
  while (lo < hi && mk.skip(q0, lo)) lo += kTile;
}

// ---------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, Strides sq, Strides sk, Strides sv, int Sq, int S,
                    int H, int K, Mask mk) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ks = Qs + D::TILE;                       // 2 x [64][LD]
  bf16* Vs = Ks + 2 * D::TILE;                   // 2 x [64][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / K);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int fr = lane >> 2, fc = (lane & 3) * 2;  // fragment row, column pair

  int k_lo, k_hi;
  kv_range(mk, q0, S, k_lo, k_hi);
  stage_tile<HD>(Qs, q, sq, b, q0, h);
  if (k_lo < k_hi) {
    stage_tile<HD>(Ks, k, sk, b, k_lo, g);
    stage_tile<HD>(Vs, v, sv, b, k_lo, g);
  }
  cp_commit();

  // Q's A fragments, held for the whole kv loop below hd 256
  uint32_t qf[D::kWide ? 1 : D::KS][4];
  float acc[D::DN][4];
#pragma unroll
  for (int j = 0; j < D::DN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.0f, 0.0f};

  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile, buf ^= 1) {
    __syncthreads();                      // every warp is done with buffer buf ^ 1
    if (k0 + kTile < k_hi) {
      stage_tile<HD>(Ks + (buf ^ 1) * D::TILE, k, sk, b, k0 + kTile, g);
      stage_tile<HD>(Vs + (buf ^ 1) * D::TILE, v, sv, b, k0 + kTile, g);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                      // tile k0 (and Q) has landed
    if (!D::kWide && k0 == k_lo) {
#pragma unroll
      for (int ks = 0; ks < D::KS; ++ks) load_a<D::LD>(qf[D::kWide ? 0 : ks], Qs, r0, 16 * ks, lane);
    }
    const bf16* Kt = Ks + buf * D::TILE;
    const bf16* Vt = Vs + buf * D::TILE;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D::KS; ++ks) {
      uint32_t qa[4];
      if (D::kWide) {
        load_a<D::LD>(qa, Qs, r0, 16 * ks, lane);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[D::kWide ? 0 : ks][e];
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        load_b_nk<D::LD>(bb, Kt, 16 * np, 16 * ks, lane);
        mma(s[2 * np], qa, bb[0], bb[1]);
        mma(s[2 * np + 1], qa, bb[2], bb[3]);
      }
    }

    // logits, the online (m, l) update, p = exp(logit - m) over s
    float mx[2] = {kNegInf, kNegInf};
    auto logits = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = mk.template logit<decltype(masked)::value>(
              s[n][e], q0 + r0 + fr + 8 * (e >> 1), k0 + 8 * n + fc + (e & 1));
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    };
    if (mk.edge(q0, k0))
      logits(std::true_type());
    else
      logits(std::false_type());
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_i[i], quad_max(mx[i]));
      corr[i] = exp_e(m_i[i] - m_new);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp_e(s[n][e] - m_i[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < D::DN; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += bf16(p) . V, p repacked from C to A fragments in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D::DN / 2; ++dp) {
        uint32_t bb[4];
        load_b_kn<D::LD>(bb, Vt, 16 * kk, 16 * dp, lane);
        mma(acc[2 * dp], pa, bb[0], bb[1]);
        mma(acc[2 * dp + 1], pa, bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + fr + 8 * i;
    const float l = fmaxf(l_i[i], 1e-30f);
    bf16* o = out + (((long long)b * Sq + row) * H + h) * HD + fc;
#pragma unroll
    for (int j = 0; j < D::DN; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] / l, acc[j][2 * i + 1] / l);
    if ((lane & 3) == 0) {
      const long long at = ((long long)b * H + h) * Sq + row;
      m_out[at] = m_i[i];
      l_out[at] = l;
    }
  }
}

// -------------------------------------------------------------- backward

// dq: q-major.  m, l and dsum are (B, H, Sq); dq is written (B, Sq, H, hd).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ m, const float* __restrict__ l,
                       const float* __restrict__ dsum, bf16* __restrict__ dq, Strides sq,
                       Strides sk, Strides sv, Strides sd, int Sq, int S, int H, int K, Mask mk) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ds = Qs + D::TILE;                       // dO [64][LD]
  bf16* Ks = Ds + D::TILE;                       // 2 x [64][LD]
  bf16* Vs = Ks + 2 * D::TILE;                   // 2 x [64][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / K);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int fr = lane >> 2, fc = (lane & 3) * 2;

  int k_lo, k_hi;
  kv_range(mk, q0, S, k_lo, k_hi);
  stage_tile<HD>(Qs, q, sq, b, q0, h);
  stage_tile<HD>(Ds, dout, sd, b, q0, h);
  if (k_lo < k_hi) {
    stage_tile<HD>(Ks, k, sk, b, k_lo, g);
    stage_tile<HD>(Vs, v, sv, b, k_lo, g);
  }
  cp_commit();

  float mr[2], il[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * H + h) * Sq + q0 + r0 + fr + 8 * i;
    mr[i] = m[at];
    il[i] = 1.0f / l[at];
    dr[i] = dsum[at];
  }
  float acc[D::DN][4];
#pragma unroll
  for (int j = 0; j < D::DN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile, buf ^= 1) {
    __syncthreads();
    if (k0 + kTile < k_hi) {
      stage_tile<HD>(Ks + (buf ^ 1) * D::TILE, k, sk, b, k0 + kTile, g);
      stage_tile<HD>(Vs + (buf ^ 1) * D::TILE, v, sv, b, k0 + kTile, g);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * D::TILE;
    const bf16* Vt = Vs + buf * D::TILE;
    const bool edge = mk.edge(q0, k0);
    constexpr int NC = D::QCOLS, NN = NC / 8;

    // one pass below hd 256; at hd 256 the two halves are not unrolled
    // into each other, which would hold both halves' logits at once
#pragma unroll 1
    for (int c = 0; c < kTile; c += NC) {     // NC kv columns at a time
      // s = Q K^T, dp = dO V^T over kv columns [c, c + NC)
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D::KS; ++ks) {
        uint32_t aq[4], ad[4];
        load_a<D::LD>(aq, Qs, r0, 16 * ks, lane);
        load_a<D::LD>(ad, Ds, r0, 16 * ks, lane);
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t bk[4], bv[4];
          load_b_nk<D::LD>(bk, Kt, c + 16 * np, 16 * ks, lane);
          mma(s[2 * np], aq, bk[0], bk[1]);
          mma(s[2 * np + 1], aq, bk[2], bk[3]);
          load_b_nk<D::LD>(bv, Vt, c + 16 * np, 16 * ks, lane);
          mma(dp[2 * np], ad, bv[0], bv[1]);
          mma(dp[2 * np + 1], ad, bv[2], bv[3]);
        }
      }
      // dl = p (dp - dsum) cap', over s
      auto grads = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float lg = mk.template logit<decltype(masked)::value>(
                s[n][e], q0 + r0 + fr + 8 * i, k0 + c + 8 * n + fc + (e & 1));
            const float p = exp_e(lg - mr[i]) * il[i];
            s[n][e] = p * (dp[n][e] - dr[i]) * mk.cap_grad(lg);
          }
      };
      if (edge)
        grads(std::true_type());
      else
        grads(std::false_type());
      // acc += dl K, dl as hi + lo bf16 fragments
#pragma unroll
      for (int kk = 0; kk < NN / 2; ++kk) {
        uint32_t hi[4], lo[4];
        a_from_c(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
        for (int dn = 0; dn < D::DN / 2; ++dn) {
          uint32_t bb[4];
          load_b_kn<D::LD>(bb, Kt, c + 16 * kk, 16 * dn, lane);
          mma(acc[2 * dn], hi, bb[0], bb[1]);
          mma(acc[2 * dn], lo, bb[0], bb[1]);
          mma(acc[2 * dn + 1], hi, bb[2], bb[3]);
          mma(acc[2 * dn + 1], lo, bb[2], bb[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* o = dq + (((long long)b * Sq + q0 + r0 + fr + 8 * i) * H + h) * HD + fc;
#pragma unroll
    for (int j = 0; j < D::DN; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * mk.scale, acc[j][2 * i + 1] * mk.scale);
  }
}

// dk/dv: kv-major, summed over the H / K query heads of the group.  dk and
// dv are written (B, S, K, hd).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ dsum, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sd,
                        int Sq, int S, int H, int K, Mask mk) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + D::TILE;                       // [64][LD]
  bf16* Qs = Vs + D::TILE;                       // 2 x [64][LD]
  bf16* Ds = Qs + 2 * D::TILE;                   // dO, 2 x [64][LD]
  float* St = reinterpret_cast<float*>(Ds + 2 * D::TILE);  // 2 x m, l, dsum [3][64]

  const int k0 = blockIdx.x * kTile;  // causal: the first kv tiles see the most q tiles
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / K;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int fr = lane >> 2, fc = (lane & 3) * 2;

  // the q tiles [q_lo, q_hi) this kv tile meets, for each head of the group
  int q_lo = 0;
  while (q_lo < Sq && mk.skip(q_lo, k0)) q_lo += kTile;
  int q_hi = q_lo;
  while (q_hi < Sq && !mk.skip(q_hi, k0)) q_hi += kTile;
  const int per_head = (q_hi - q_lo) / kTile, n_items = rep * per_head;

  // item i: head g * rep + i / per_head, q tile q_lo + 64 (i % per_head)
  auto stage_item = [&](int i, int slot) {
    const int h = g * rep + i / per_head, q0 = q_lo + kTile * (i % per_head);
    stage_tile<HD>(Qs + slot * D::TILE, q, sq, b, q0, h);
    stage_tile<HD>(Ds + slot * D::TILE, dout, sd, b, q0, h);
    const long long at = ((long long)b * H + h) * Sq + q0;
    float* st = St + slot * 3 * kTile;
    stage_row(st, m + at, 0);
    stage_row(st + kTile, l + at, kTile / 4);
    stage_row(st + 2 * kTile, dsum + at, kTile / 2);
  };
  stage_tile<HD>(Ks, k, sk, b, k0, g);
  stage_tile<HD>(Vs, v, sv, b, k0, g);
  if (n_items > 0) stage_item(0, 0);
  cp_commit();

  float ak[D::DN][4], av[D::DN][4];
#pragma unroll
  for (int j = 0; j < D::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    __syncthreads();
    if (it + 1 < n_items) {
      stage_item(it + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = q_lo + kTile * (it % per_head);
    const bf16* Qt = Qs + buf * D::TILE;
    const bf16* Dt = Ds + buf * D::TILE;
    const float* st = St + buf * 3 * kTile;

#pragma unroll
    for (int c = 0; c < kTile; c += 32) {     // 32 q columns at a time
      // rows: kv (r0 + fr, + 8), columns: q (c + 8 n + fc, + 1)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D::KS; ++ks) {
        uint32_t ak_[4], av_[4];
        load_a<D::LD>(ak_, Ks, r0, 16 * ks, lane);
        load_a<D::LD>(av_, Vs, r0, 16 * ks, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bd[4];
          load_b_nk<D::LD>(bq, Qt, c + 16 * np, 16 * ks, lane);
          mma(s[2 * np], ak_, bq[0], bq[1]);
          mma(s[2 * np + 1], ak_, bq[2], bq[3]);
          load_b_nk<D::LD>(bd, Dt, c + 16 * np, 16 * ks, lane);
          mma(dp[2 * np], av_, bd[0], bd[1]);
          mma(dp[2 * np + 1], av_, bd[2], bd[3]);
        }
      }
      // p^T over s, dl^T over dp
      auto grads = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = c + 8 * n + fc + x;
            const float mq = st[col], il = 1.0f / st[kTile + col], dq_ = st[2 * kTile + col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * i + x;
              const float lg = mk.template logit<decltype(masked)::value>(
                  s[n][e], q0 + col, k0 + r0 + fr + 8 * i);
              const float p = exp_e(lg - mq) * il;
              s[n][e] = p;
              dp[n][e] = p * (dp[n][e] - dq_) * mk.cap_grad(lg);
            }
          }
      };
      if (mk.edge(q0, k0))
        grads(std::true_type());
      else
        grads(std::false_type());
      // dv += p^T dO, dk += dl^T Q, each as hi + lo bf16 fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4], lh[4], ll[4];
        a_from_c(s[2 * kk], s[2 * kk + 1], ph, pl);
        a_from_c(dp[2 * kk], dp[2 * kk + 1], lh, ll);
#pragma unroll
        for (int dn = 0; dn < D::DN / 2; ++dn) {
          uint32_t bd[4], bq[4];
          load_b_kn<D::LD>(bd, Dt, c + 16 * kk, 16 * dn, lane);
          mma(av[2 * dn], ph, bd[0], bd[1]);
          mma(av[2 * dn], pl, bd[0], bd[1]);
          mma(av[2 * dn + 1], ph, bd[2], bd[3]);
          mma(av[2 * dn + 1], pl, bd[2], bd[3]);
          load_b_kn<D::LD>(bq, Qt, c + 16 * kk, 16 * dn, lane);
          mma(ak[2 * dn], lh, bq[0], bq[1]);
          mma(ak[2 * dn], ll, bq[0], bq[1]);
          mma(ak[2 * dn + 1], lh, bq[2], bq[3]);
          mma(ak[2 * dn + 1], ll, bq[2], bq[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = (((long long)b * S + k0 + r0 + fr + 8 * i) * K + g) * HD + fc;
#pragma unroll
    for (int j = 0; j < D::DN; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(ak[j][2 * i] * mk.scale, ak[j][2 * i + 1] * mk.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(av[j][2 * i], av[j][2 * i + 1]);
    }
  }
}

// dk/dv at hd 256: the kernel above with dk and dv split between two warp
// groups (the header's note).  8 warps; warp w owns kv rows 16 (w % 4) of
// the tile and, in group w / 4, dv (0) or dk (1).  Both groups form p^T
// from S^T = K.Q^T; the dk group also forms dP^T = V.dO^T and dl^T.
template <int HD>
__global__ void __launch_bounds__(2 * kThreads)
flash_bwd_dkv_tc_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ m, const float* __restrict__ l,
                              const float* __restrict__ dsum, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                              Strides sd, int Sq, int S, int H, int K, Mask mk) {
  using D = Dims<HD>;
  constexpr int NT = 2 * kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + D::TILE;                       // [64][LD]
  bf16* Qs = Vs + D::TILE;                       // 2 x [64][LD]
  bf16* Ds = Qs + 2 * D::TILE;                   // dO, 2 x [64][LD]
  float* St = reinterpret_cast<float*>(Ds + 2 * D::TILE);  // 2 x m, l, dsum [3][64]

  const int k0 = blockIdx.x * kTile;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % kWarps) * 16;
  const bool dk_group = warp >= kWarps;           // warp-uniform
  const int fr = lane >> 2, fc = (lane & 3) * 2;

  int q_lo = 0;
  while (q_lo < Sq && mk.skip(q_lo, k0)) q_lo += kTile;
  int q_hi = q_lo;
  while (q_hi < Sq && !mk.skip(q_hi, k0)) q_hi += kTile;
  const int per_head = (q_hi - q_lo) / kTile, n_items = rep * per_head;

  auto stage_item = [&](int i, int slot) {
    const int h = g * rep + i / per_head, q0 = q_lo + kTile * (i % per_head);
    stage_tile<HD, NT>(Qs + slot * D::TILE, q, sq, b, q0, h);
    stage_tile<HD, NT>(Ds + slot * D::TILE, dout, sd, b, q0, h);
    const long long at = ((long long)b * H + h) * Sq + q0;
    float* st = St + slot * 3 * kTile;
    stage_row(st, m + at, 0);
    stage_row(st + kTile, l + at, kTile / 4);
    stage_row(st + 2 * kTile, dsum + at, kTile / 2);
  };
  stage_tile<HD, NT>(Ks, k, sk, b, k0, g);
  stage_tile<HD, NT>(Vs, v, sv, b, k0, g);
  if (n_items > 0) stage_item(0, 0);
  cp_commit();

  float acc[D::DN][4];                            // dv, or dk
#pragma unroll
  for (int j = 0; j < D::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    __syncthreads();
    if (it + 1 < n_items) {
      stage_item(it + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = q_lo + kTile * (it % per_head);
    const bf16* Qt = Qs + buf * D::TILE;
    const bf16* Dt = Ds + buf * D::TILE;
    const float* st = St + buf * 3 * kTile;
    const bool edge = mk.edge(q0, k0);

#pragma unroll 1
    for (int c = 0; c < kTile; c += 32) {     // 32 q columns at a time
      // rows: kv (r0 + fr, + 8), columns: q (c + 8 n + fc, + 1)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D::KS; ++ks) {
        uint32_t ak_[4];
        load_a<D::LD>(ak_, Ks, r0, 16 * ks, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4];
          load_b_nk<D::LD>(bq, Qt, c + 16 * np, 16 * ks, lane);
          mma(s[2 * np], ak_, bq[0], bq[1]);
          mma(s[2 * np + 1], ak_, bq[2], bq[3]);
        }
        if (dk_group) {
          uint32_t av_[4];
          load_a<D::LD>(av_, Vs, r0, 16 * ks, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bd[4];
            load_b_nk<D::LD>(bd, Dt, c + 16 * np, 16 * ks, lane);
            mma(dp[2 * np], av_, bd[0], bd[1]);
            mma(dp[2 * np + 1], av_, bd[2], bd[3]);
          }
        }
      }
      // p^T over s (dv group), dl^T over s (dk group)
      auto grads = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = c + 8 * n + fc + x;
            const float mq = st[col], il = 1.0f / st[kTile + col], dq_ = st[2 * kTile + col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * i + x;
              const float lg = mk.template logit<decltype(masked)::value>(
                  s[n][e], q0 + col, k0 + r0 + fr + 8 * i);
              const float p = exp_e(lg - mq) * il;
              s[n][e] = dk_group ? p * (dp[n][e] - dq_) * mk.cap_grad(lg) : p;
            }
          }
      };
      if (edge)
        grads(std::true_type());
      else
        grads(std::false_type());
      // dv += p^T dO, or dk += dl^T Q, as hi + lo bf16 fragments
      const bf16* Xt = dk_group ? Qt : Dt;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t hi[4], lo[4];
        a_from_c(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
        for (int dn = 0; dn < D::DN / 2; ++dn) {
          uint32_t bx[4];
          load_b_kn<D::LD>(bx, Xt, c + 16 * kk, 16 * dn, lane);
          mma(acc[2 * dn], hi, bx[0], bx[1]);
          mma(acc[2 * dn], lo, bx[0], bx[1]);
          mma(acc[2 * dn + 1], hi, bx[2], bx[3]);
          mma(acc[2 * dn + 1], lo, bx[2], bx[3]);
        }
      }
    }
  }
  cp_wait<0>();

  bf16* out = dk_group ? dk : dv;
  const float f = dk_group ? mk.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = (((long long)b * S + k0 + r0 + fr + 8 * i) * K + g) * HD + fc;
#pragma unroll
    for (int j = 0; j < D::DN; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * f, acc[j][2 * i + 1] * f);
  }
}

// ------------------------------------------------------------------ host

struct Shape {
  int B, Sq, S, H, K;
};

Strides strides_at(const long long* s, int t) { return Strides{s[3 * t], s[3 * t + 1], s[3 * t + 2]}; }

// Dynamic shared memory of each kernel (0 forward, 1 dq, 2 dk/dv).
template <int HD> size_t smem_bytes(int which) {
  const size_t tile = sizeof(bf16) * Dims<HD>::TILE;
  return which == 0 ? 5 * tile : which == 1 ? 6 * tile : 6 * tile + sizeof(float) * 6 * kTile;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                const long long* st, Shape sh, Mask mk, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(0);
  auto kern = flash_fwd_tc_kernel<HD>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(sh.Sq / kTile, sh.H, sh.B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), m, l, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      sh.Sq, sh.S, sh.H, sh.K, mk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* dout, const float* m,
                const float* l, const float* dsum, void* dq, void* dk, void* dv,
                const long long* st, Shape sh, Mask mk, cudaStream_t stream) {
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1), sv = strides_at(st, 2),
                sd = strides_at(st, 3);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dp = static_cast<const bf16*>(dout);

  auto kdq = flash_bwd_dq_tc_kernel<HD>;
  cudaError_t e = allow_smem(kdq, smem_bytes<HD>(1));
  if (e != cudaSuccess) return e;
  kdq<<<dim3(sh.Sq / kTile, sh.H, sh.B), kThreads, smem_bytes<HD>(1), stream>>>(
      qp, kp, vp, dp, m, l, dsum, static_cast<bf16*>(dq), sq, sk, sv, sd, sh.Sq, sh.S, sh.H,
      sh.K, mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dkv = [&](auto kern, int threads) {
    cudaError_t err = allow_smem(kern, smem_bytes<HD>(2));
    if (err != cudaSuccess) return err;
    kern<<<dim3(sh.S / kTile, sh.K, sh.B), threads, smem_bytes<HD>(2), stream>>>(
        qp, kp, vp, dp, m, l, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, sv,
        sd, sh.Sq, sh.S, sh.H, sh.K, mk);
    return cudaGetLastError();
  };
  if constexpr (Dims<HD>::kWide)
    return dkv(flash_bwd_dkv_tc_split_kernel<HD>, 2 * kThreads);
  else
    return dkv(flash_bwd_dkv_tc_kernel<HD>, kThreads);
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

// Forward, bfloat16.  q (B, Sq, H, hd), k and v (B, S, K, hd), each with a
// contiguous hd and element strides (b, s, head) in strides[0..8] (q, k,
// v); rows 16-byte aligned.  Writes out (B, Sq, H, hd) contiguous bf16, m
// and l (B, H, Sq) float32.  Requires hd in {16, 64, 128, 256}, H % K ==
// 0, Sq and S multiples of 64, Sq <= S.
int repro_flash_fwd_bf16(int device, int hd, const void* q, const void* k, const void* v,
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

// Backward, bfloat16: the dq kernel, then the dk/dv kernel, on one stream.
// As the forward, plus dout (B, Sq, H, hd) with its strides in
// strides[9..11], m and l from the forward and dsum = rowsum(dout * out),
// all three (B, H, Sq) float32.  Writes dq (B, Sq, H, hd), dk and dv (B, S,
// K, hd), contiguous bf16.
int repro_flash_bwd_bf16(int device, int hd, const void* q, const void* k, const void* v,
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
int repro_flash_bf16_smem(int which, int hd) {
#define REPRO_SMEM(HD) (int)smem_bytes<HD>(which)
  REPRO_HD_DISPATCH(REPRO_SMEM)
#undef REPRO_SMEM
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
