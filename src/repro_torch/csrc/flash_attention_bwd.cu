// The backward of prefill attention (K3's whole prefill) for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package has no backward kernel for K3
// (no custom_vjp in src/repro); its trainer differentiates the jnp
//   src/repro/models/layers.py::blocked_attention
// (rematerialised per query block by jax.checkpoint), and this kernel
// computes that gradient, so that training on the card runs no plain
// PyTorch on a CUDA tensor.  Its plain version, in the same
// decomposition, is kernels/flash_attention/kernel.py::
// flash_attention_bwd_plain.
//
// What it computes, for a whole prefill (query i and key j at positions i
// and j; key j admitted by query i iff (not causal or j <= i) and (window
// <= 0 or i - j < window); query head h*G + g reads kv head h), from q,
// k, v, the forward's output o and log-sum-exp lse (flash_attention.cu
// writes it under autograd) and the output's cotangent dO, FlashAttention-2
// style:
//   delta_i = sum_e dO_i[e] o_i[e];
//   P_ij    = exp(scale q_i . k_j - lse_i) where admitted, else 0;
//   dS_ij   = P_ij (dO_i . v_j - delta_i);
//   dv_j    = sum over the G heads and i of P_ij dO_i;
//   dk_j    = scale sum over the G heads and i of dS_ij q_i;
//   dq_i    = scale sum_j dS_ij k_j.
//
// Layout (the model layout), contiguous: q (B, S, Hq, DQK), k (B, S, Hkv,
// DQK), v (B, S, Hkv, DV), o and dO (B, S, Hq, DV), lse (B, Hq, S) fp32;
// dq, dk, dv as q, k, v; delta (B, Hq, S) fp32 scratch from the wrapper,
// and with G = Hq / Hkv > 1 or a split walk `part`, fp32 scratch (see the
// entry point).  Builds, in bf16 and in fp32: (DQK, DV) in (64, 64), (80,
// 80), (128, 128), (256, 256), (192, 128), the forward's, none padded;
// fp32 also (48, 32), as the forward.
//
// Design (bf16, redesigned for the H100), no atomics: each gradient
// element is summed by one block, or by the partials' sum, in a fixed
// order, so two identical calls give the same bits.  Launch order: dQ
// (which also writes delta), dK/dV, the partials' sum.  Each launch that
// does the products runs one block per QUERY head, so that few kv heads
// still fill the card, and the causal-heavy tiles first; where B Hq
// ceil(S / 64) blocks would still leave SMs idle, two blocks share each
// tile's walk (`nsplit`): gemma3-1b's 4 query heads over one kv head at
// S = 1024 get 128 blocks in each launch, where one block per kv head
// gave 32 and 64.  P and dS are rounded to bf16 once, as FlashAttention's
// kernels do (relative L2 2.4-2.5e-3 against the fp32 plain version,
// bound 5e-3).  A tile wholly inside the causal and window masks skips
// the admit mask; only edge tiles evaluate it per element.
//  (iii) dQ, one block per (query rows, b, query head[, key share]) over
//        the admitted key tiles of 64 (K and V through a double-buffered
//        cp.async ring), after delta = rowsum(dO o) of its rows:
//    - flash_bwd_q_wgmma_kernel ((64, 64), (128, 128), (192, 128)): one
//      warpgroup, 64 rows; S = Q K^T and dP = dO V^T on wgmma from
//      128-byte-swizzled shared memory (wgmma.cuh), dS = P (dP - delta)
//      in registers, then dQ += dS K with dS's registers as the A
//      fragments and K as an MN-major B; with key shares, fp32 partials;
//    - flash_bwd_q_kernel ((80, 80): 80 is no multiple of the swizzle's
//      64 columns; (256, 256): on wgmma its accumulators spill past 255
//      registers, so 32 rows a block here, 128 blocks at gemma3-1b): 8
//      warps on mma.sync.m16n8k16, S and dP once a block, dS in bf16
//      through shared memory, then dQ += dS K, each warp its 16 rows and
//      column group.
//  (ii)  dK/dV, one block per (query head, 64 keys, b[, query share])
//        walking the query steps of 64 the masks admit to its keys (Q and
//        dO double-buffered); S^T = K Q^T and dP^T = V dO^T are computed
//        ONCE a step:
//    - flash_bwd_kv_wgmma_kernel (every build but (80, 80)): two
//      warpgroups in FlashAttention-3's split: the first computes S^T on
//      wgmma, P^T = exp(S^T scale - lse), hands P^T to the second through
//      shared memory (fp32, behind a named barrier) and sums dV += P^T dO
//      with P^T's registers as A and dO as an MN-major B; the second
//      computes dP^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q (128
//      fp32 accumulators a thread at (256, 256));
//    - flash_bwd_kv_kernel ((80, 80)): 8 warps on mma.sync, each a 16 x 8
//      NS piece of S^T and dP^T, P^T and dS^T to shared memory in bf16,
//      then each warp sums dV and dK for its 16 keys and column group.
//    With G = 1 and one share a block writes dK and dV in bf16; else its
//    head's and share's fp32 partials, and
//  (iv)  flash_bwd_sum_kernel sums each row's partials in order (dK/dV of
//        a kv head over its G query heads, each over its shares; dQ over
//        its key shares).
// Design (fp32, redesigned for the H100): the bf16 structure above with
// every product in 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh: each operand
// a TF32 high part and the TF32 of its residual, hi lo + lo hi + hi hi
// summed in fp32), so P and dS are never rounded below fp32:
//  (iii) flash_bwd_q_f32_kernel: one block per (R query rows, b, query
//        head[, key share]), R = 64 (32 at (256, 256)), 8 warps; delta of
//        its rows first (written by the first share), then per step of 32
//        keys S (warps 0-3) and dP (warps 4-7) at once, once a block, P
//        and then dS in fp32 through shared memory, dQ += dS K per warp
//        and column group; with key shares, fp32 partials;
//  (ii)  flash_bwd_kv_f32_kernel: one block per (query head, R keys, b[,
//        query share]), 8 warps; per step of 32 queries S^T (warps 0-3)
//        and dP^T (warps 4-7) at once, P^T and then dS^T in fp32 through
//        shared memory, dV += P^T dO and dK += dS^T Q per warp and column
//        group; with G = 1 and one share it writes dK and dV, else its
//        head's and share's partials;
//  (iv)  flash_bwd_sum_kernel<float>, as in bf16.
//  Splitting the score phase by product gives each warp a 16 x 8 NS
//  piece with NS = 2 or 4 (so each A fragment, split once, serves NS
//  products) where one piece of each product per warp had NS = 1 at (256,
//  256); with the TF32 split by truncation this took gemma3-1b's fp32
//  backward from 168.7 to 114.1 µs (tf32_mma.cuh).  Each step's dV, dK
//  and dQ products are summed in fresh accumulators and added into the
//  running sums in fp32 (tf32_mma.cuh: the tensor cores' accumulation
//  drifts over long chains).
//  Two blocks share a tile's walk where B Hq ceil(S / R) blocks would not
//  fill the card (gemma3-1b's 4 heads at S = 512: 64 -> 128 blocks).  The
//  sums over the permuted k axis (tf32_mma.cuh) read each fp32 operand
//  tile in place: no transposed copy.  Shared memory 210 KiB at (256,
//  256), 185 at (192, 128), 105 at (80, 80); two blocks an SM at (64,
//  64) and (48, 32) (f32_min_blocks).
// The narrow builds ((64, 64), (80, 80)) run two blocks an SM.  Q, K, V
// and dO come in through cp.async, not TMA.
//
// Bound: operations at the prompt lengths training runs (S = 512-4096):
// 2 (3 DQK + 2 DV) flops per admitted (query head, query, key) pair (the
// scores recomputed, dP, dV, dK and dQ), against q, k, v, o, dO, lse read
// and dq, dk, dv written once; in fp32 at the CUDA cores' 67 TFLOP/s, or
// at 165 TFLOP/s as three TF32 passes on the tensor cores (495).  This design computes S and dP twice (once
// for dK/dV, once for dQ, which avoids a float sum across blocks): 2 (5
// DQK + 4 DV) flops a pair, 1.4x the least at DQK = DV, as
// FlashAttention-2 without atomics; the partials add fp32 traffic (16.8 MB
// written and read at gemma3-1b's S = 1024: 4 heads, 2 shares).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

using tc::bf16;

constexpr int kThreads = 256;     // bf16 dK/dV and dQ: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQStep = 64;        // bf16 dK/dV: query rows a step
constexpr int kKeyStep = 64;      // bf16 dQ: keys a step
constexpr int kKvKeys = 64;       // bf16 dK/dV: keys a block, all builds
// bf16 dQ: query rows a block
template <int DQK>
__host__ __device__ constexpr int q_rows() {
  return DQK >= 256 ? 32 : 64;
}
// blocks an SM the bf16 product kernels are built for: two at the narrow
// head dims (their accumulators fit 128 registers, their tiles two
// blocks' shared memory), one otherwise
template <int DQK>
__host__ __device__ constexpr int min_blocks() {
  return DQK <= 80 ? 2 : 1;
}
// fp32 (3xTF32 on mma.sync, tf32_mma.cuh): the block's own rows (keys for
// dK/dV, queries for dQ), 64, or 32 at DQK = 256, walked in steps of 32
// of the other side
template <int DQK>
__host__ __device__ constexpr int f32_rows() {
  return DQK >= 256 ? 32 : 64;
}
constexpr int kF32Step = 32;
constexpr int kF32SP = kF32Step + tf::kPadP;  // staged scores' row stride
// blocks an SM the fp32 kernels are built for: two where both fit 128
// registers a thread ((64, 64), (48, 32)); at (80, 80) the dK/dV kernel's
// per-step accumulators spill at 128, so one
template <int DQK, int DV>
__host__ __device__ constexpr int f32_min_blocks() {
  return DQK + DV <= 128 ? 2 : 1;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, S), natural log
  float* delta;      // (B, Hq, S)
  void* dq;
  void* dk;
  void* dv;
  float* part;       // G > 1 or nsplit > 1: dK then dV per query head
                     // and query share (then dQ per key share), fp32
  int B, S, Hq, Hkv, causal, window;
  int nsplit;        // blocks sharing a key tile's queries (dK/dV) or a
                     // query tile's keys (dQ): bf16 wgmma and fp32
  float scale;
};

// whether key kj is admitted by query qi (both below S)
__device__ __forceinline__ bool admit(const Args& p, int qi, int kj) {
  const int dq = qi - kj;
  return qi < p.S && kj < p.S && (p.causal == 0 || dq >= 0) &&
         (p.window <= 0 || dq < p.window);
}

// whether every query of [q0, q0 + nq) admits every key of [k0, k0 + nk)
// (all below S): such a tile skips the admit mask
__device__ __forceinline__ bool tile_inside(const Args& p, int q0, int nq,
                                            int k0, int nk) {
  return q0 + nq <= p.S && k0 + nk <= p.S &&
         (p.causal == 0 || q0 >= k0 + nk - 1) &&
         (p.window <= 0 || q0 + nq - 1 - k0 < p.window);
}

// the queries that may admit a key of [k0, k0 + n): causal ones start at
// k0, windowed ones end before k0 + n - 1 + window
__device__ __forceinline__ void query_range(const Args& p, int k0, int n,
                                            int step, int* begin, int* end) {
  *begin = (p.causal != 0 ? k0 : 0) / step * step;
  *end = p.window > 0 ? min(p.S, k0 + n - 1 + p.window) : p.S;
}

// the keys that queries [q0, q_last] may read: causal ones end after
// q_last, windowed ones start at q0 - window + 1 (rounded down to a tile)
__device__ __forceinline__ void key_range(const Args& p, int q0, int q_last,
                                          int tile, int* begin, int* end) {
  *end = p.causal != 0 ? min(q_last + 1, p.S) : p.S;
  *begin = p.window > 0 ? max(0, q0 - p.window + 1) / tile * tile : 0;
}

// ldmatrix lane offsets: A (rows, k) and a transposed B (k rows, n), and a
// B stored as its transpose (n rows, k)
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8),
        b_col(((lane >> 3) & 1) * 8) {}
};

// The 16-column pairs of a D-wide output that column group cg of NCG
// owns: [begin, begin + count), as even as D / 16 pairs allow (80 gives
// 3 and 2)
template <int D, int NCG>
struct Cols {
  static constexpr int kPairs = D / 16;
  static constexpr int kMax = (kPairs + NCG - 1) / NCG;
  __device__ __forceinline__ static int begin(int cg) {
    return cg * kPairs / NCG;
  }
  __device__ __forceinline__ static int count(int cg) {
    return (cg + 1) * kPairs / NCG - cg * kPairs / NCG;
  }
};

// c = A B^T over K: A the warp's 16 rows at `a` (row stride AS), B the
// NS * 8 rows at `b` (stride BS), both bf16 row-major in shared memory
template <int K, int AS, int BS, int NS>
__device__ __forceinline__ void mma_nt(float (&c)[NS][4], const bf16* a,
                                       const bf16* b, const Lanes& ln) {
  static_assert(NS % 2 == 0, "B rows come in pairs of 8-row tiles");
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4];
    tc::ldsm_x4(af, a + ln.a_row * AS + kc * 16 + ln.a_col);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      uint32_t bf[4];
      tc::ldsm_x4(bf, b + (j * 8 + ln.b_row) * BS + kc * 16 + ln.b_col);
      tc::mma_bf16(c[j], af, bf[0], bf[1]);
      tc::mma_bf16(c[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += A B over K: A the warp's 16 rows at `a` (stride AS), B K rows at
// `b` (stride BS), both bf16 row-major; acc[2 i], acc[2 i + 1] hold B's
// column pair p0 + i, for i < np <= MAXP
template <int K, int AS, int BS, int MAXP>
__device__ __forceinline__ void mma_nn(float (&acc)[2 * MAXP][4],
                                       const bf16* a, const bf16* b, int p0,
                                       int np, const Lanes& ln) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4];
    tc::ldsm_x4(af, a + ln.a_row * AS + kc * 16 + ln.a_col);
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < np) {
        uint32_t bf[4];
        tc::ldsm_x4_trans(bf, b + (kc * 16 + ln.a_row) * BS + (p0 + i) * 16 +
                                  ln.a_col);
        tc::mma_bf16(acc[2 * i], af, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * i + 1], af, bf[2], bf[3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// a warp's 16-row accumulator of column pairs [p0, p0 + np) to row `row`
// (hh: its first or second 8 rows) of `dst`, times `scale`: bf16 pairs
// or, with `f32`, fp32 pairs
template <int MAXP>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * MAXP][4],
                                           int hh, int p0, int np, int t4,
                                           float scale, void* dst, bool f32) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i >= np) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (p0 + i) * 16 + half * 8 + 2 * t4;
      const float x0 = acc[2 * i + half][2 * hh] * scale;
      const float x1 = acc[2 * i + half][2 * hh + 1] * scale;
      if (f32)
        *reinterpret_cast<float2*>(static_cast<float*>(dst) + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dst) + col) =
            tc::pack_bf16(x0, x1);
    }
  }
}

constexpr int kSP = kQStep + tc::kPad;      // P^T, dS^T row stride
constexpr int kDP = kKeyStep + tc::kPad;    // dS row stride (dQ)

template <int DQK, int DV>
__host__ __device__ constexpr size_t kv_smem_bytes() {
  return sizeof(bf16) *
             (static_cast<size_t>(kKvKeys + 2 * kQStep) *
                  (DQK + DV + 2 * tc::kPad) +
              2 * static_cast<size_t>(kKvKeys) * kSP) +
         sizeof(float) * 4 * kQStep;
}

// (ii) bf16 on mma.sync ((80, 80)): grid (B * Hq, ceil(S / 64)), one query
// head and key tile a block, the first key tiles (the most queries,
// causal) first
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, min_blocks<DQK>())
    flash_bwd_kv_kernel(Args p) {
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  constexpr int KT = kKvKeys;
  constexpr int RT = KT / 16;        // row tiles of keys
  constexpr int NCG = kWarps / RT;   // column groups
  constexpr int NS = kQStep / 8 / NCG;  // a warp's 8-query score tiles
  using CK = Cols<DQK, NCG>;
  using CV = Cols<DV, NCG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + KT * QS;
  bf16* qs = vs + KT * VS;            // ring of two query steps
  bf16* dos = qs + 2 * kQStep * QS;   // ring of two
  bf16* pts = dos + 2 * kQStep * VS;  // P^T (keys x queries)
  bf16* dst = pts + KT * kSP;         // dS^T
  float* ls = reinterpret_cast<float*>(dst + KT * kSP);  // lse log2 e
  float* dl = ls + 2 * kQStep;        // delta

  const int G = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hq, hq = blockIdx.x % p.Hq, hk = hq / G;
  const int k0 = blockIdx.y * KT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % RT, cg = warp / RT;  // row tile, column group
  const int g4 = lane / 4, t4 = lane % 4;
  const Lanes ln(lane);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  // keys past S are zero-filled (and never admitted)
  tc::load_rows<DQK, KT, kThreads>(ks, tid, k, [&](int r) -> const bf16* {
    return k0 + r < p.S ? k + kv_row(k0 + r) * DQK : nullptr;
  });
  tc::load_rows<DV, KT, kThreads>(vs, tid, v, [&](int r) -> const bf16* {
    return k0 + r < p.S ? v + kv_row(k0 + r) * DV : nullptr;
  });

  int q_begin, q_end;
  query_range(p, k0, KT, kQStep, &q_begin, &q_end);
  const int steps = q_end > q_begin ? (q_end - q_begin + kQStep - 1) / kQStep
                                    : 0;
  auto issue = [&](int it) {  // one commit group (the first carries K, V)
    const int sg = it & 1, q0 = q_begin + it * kQStep;
    tc::load_rows<DQK, kQStep, kThreads>(
        qs + sg * kQStep * QS, tid, q, [&](int r) -> const bf16* {
          return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
        });
    tc::load_rows<DV, kQStep, kThreads>(
        dos + sg * kQStep * VS, tid, dout, [&](int r) -> const bf16* {
          return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
        });
    if (tid < kQStep) {
      const int i = q0 + tid;
      const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + i;
      ls[sg * kQStep + tid] = i < p.S ? p.lse[o] * tc::kLog2e : 0.f;
      dl[sg * kQStep + tid] = i < p.S ? p.delta[o] : 0.f;
    }
    tc::cp_async_commit();
  };

  float acc_v[2 * CV::kMax][4], acc_k[2 * CK::kMax][4];
  zero(acc_v);
  zero(acc_k);
  const float scale_log2 = p.scale * tc::kLog2e;
  issue(0);
  for (int it = 0; it < steps; ++it) {
    tc::cp_async_wait<0>();  // step it has landed
    // one barrier: step it is visible, and every warp is done with step
    // it - 1 (its stage, P^T and dS^T), which the next issue overwrites
    __syncthreads();
    if (it + 1 < steps) issue(it + 1);
    const int sg = it & 1, q0 = q_begin + it * kQStep;
    const bf16* qt = qs + sg * kQStep * QS;
    const bf16* dt = dos + sg * kQStep * VS;
    const float* l2 = ls + sg * kQStep;
    const float* dlt = dl + sg * kQStep;
    const bool inside = tile_inside(p, q0, kQStep, k0, KT);
    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys and NS x 8
    // queries, once a block: P^T and dS^T go to shared memory in bf16
    float s[NS][4], dp[NS][4];
    const int c0 = cg * NS * 8;
    mma_nt<DQK, QS, QS, NS>(s, ks + rt * 16 * QS, qt + c0 * QS, ln);
    mma_nt<DV, VS, VS, NS>(dp, vs + rt * 16 * VS, dt + c0 * VS, ln);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + j * 8 + 2 * t4 + (e & 1);
        const int kj = k0 + rt * 16 + g4 + 8 * (e >> 1);
        const float pr = inside || admit(p, q0 + c, kj)
                             ? tc::ex2(s[j][e] * scale_log2 - l2[c])
                             : 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - dlt[c]);
      }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (rt * 16 + g4 + 8 * hh) * kSP + c0 + j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(pts + o) =
            tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dst + o) =
            tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);
      }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the warp's 16 keys and columns
    mma_nn<kQStep, kSP, VS, CV::kMax>(acc_v, pts + rt * 16 * kSP, dt,
                                      CV::begin(cg), CV::count(cg), ln);
    mma_nn<kQStep, kSP, QS, CK::kMax>(acc_k, dst + rt * 16 * kSP, qt,
                                      CK::begin(cg), CK::count(cg), ln);
  }
  if (steps == 0) tc::cp_async_wait<0>();

  // G = 1: dK and dV in bf16; else this head's fp32 partials, summed over
  // the group by flash_bwd_sum_kernel
  const bool f32 = G > 1;
  const size_t dk_all = static_cast<size_t>(p.B) * p.S * p.Hq * DQK;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = k0 + rt * 16 + g4 + 8 * hh;
    if (pos >= p.S) continue;
    void* dv_row;
    void* dk_row;
    if (f32) {
      const size_t r = (static_cast<size_t>(b) * p.S + pos) * p.Hq + hq;
      dk_row = p.part + r * DQK;
      dv_row = p.part + dk_all + r * DV;
    } else {
      dk_row = static_cast<bf16*>(p.dk) + kv_row(pos) * DQK;
      dv_row = static_cast<bf16*>(p.dv) + kv_row(pos) * DV;
    }
    store_rows<CV::kMax>(acc_v, hh, CV::begin(cg), CV::count(cg), t4, 1.f,
                         dv_row, f32);
    store_rows<CK::kMax>(acc_k, hh, CK::begin(cg), CK::count(cg), t4,
                         p.scale, dk_row, f32);
  }
}

// bf16 builds whose dK/dV products run on wgmma (head dims multiples of
// 64 up to 192: (64, 64), (128, 128), (192, 128)); the others keep
// flash_bwd_kv_kernel's mma.sync
// the builds whose products run on wgmma: widths multiples of 64 (the
// 128-byte swizzle's blocks); dQ only up to 192 (at 256 its accumulators
// and scores would spill past 255 registers)
constexpr int kWgmmaDqMax = 192;
template <int DQK, int DV>
__host__ __device__ constexpr bool wgmma_build() {
  return DQK % 64 == 0 && DV % 64 == 0;
}
template <int DQK, int DV>
__host__ __device__ constexpr bool wgmma_dq() {
  return wgmma_build<DQK, DV>() && DQK <= kWgmmaDqMax;
}

// 64 rows of D bf16 columns (a multiple of 64) into a 128-byte-swizzled
// tile at `dst` (wgmma.cuh), 16 bytes a thread: src(r) gives row r's
// address, or nullptr for a row to zero-fill without a read
template <int D, int NT = kThreads, typename Src>
__device__ __forceinline__ void load_swz(unsigned char* dst, int tid,
                                         const bf16* base, Src src) {
  constexpr int kChunks = D / 8;
  static_assert(64 * kChunks % NT == 0, "whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / kChunks, ch = c % kChunks;
    const bf16* g = src(r);
    tc::cp_async16(dst + wg::swz(64, r, ch * 8), g ? g + ch * 8 : base,
                   g != nullptr);
  }
}

// the wgmma products with A from registers, by the accumulated width
template <int N>
struct Rs;
template <>
struct Rs<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wg::rs_n64_t1(d, a, db);
  }
};
template <>
struct Rs<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wg::rs_n128_t1(d, a, db);
  }
};
template <>
struct Rs<192> {
  __device__ __forceinline__ static void mma(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wg::rs_n192_t1(d, a, db);
  }
};
template <>
struct Rs<256> {
  __device__ __forceinline__ static void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wg::rs_n256_t1(d, a, db);
  }
};

// the wgmma dK/dV kernel's shared memory: 1024 bytes of alignment slack,
// K and V (64 rows each), two stages of Q and dO (64 rows each), all
// swizzled; P^T in fp32, thread-linear; lse and delta of both stages
template <int DQK, int DV>
struct KvW {
  static constexpr uint32_t kBlk = kKvKeys * 128;  // a 64-column block
  static constexpr uint32_t oK = 0;
  static constexpr uint32_t oV = oK + DQK / 64 * kBlk;
  static constexpr uint32_t oQ = oV + DV / 64 * kBlk;   // 2 stages
  static constexpr uint32_t oO = oQ + 2 * (DQK / 64) * kBlk;
  static constexpr uint32_t oP = oO + 2 * (DV / 64) * kBlk;
  static constexpr uint32_t oL = oP + 4 * kKvKeys * kQStep;
  static constexpr size_t bytes = 1024 + oL + 4 * 4 * kQStep;
};

// One warpgroup's share of the wgmma dK/dV kernel.  Role 0: S^T = K Q^T,
// P^T (handed to role 1 through shared memory), dV += P^T dO.  Role 1:
// dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.  Both walk the
// same query steps and meet at the same block barriers.
template <int ROLE, int DQK, int DV>
__device__ __forceinline__ void kv_wgmma_role(const Args& p,
                                              unsigned char* sm, int b,
                                              int hq, int hk, int k0) {
  using L = KvW<DQK, DV>;
  constexpr int KT = kKvKeys;
  constexpr int N = ROLE == 0 ? DV : DQK;   // the summed gradient's width
  constexpr int KD = ROLE == 0 ? DQK : DV;  // the scores' depth
  constexpr uint32_t kBlk = L::kBlk;
  const uint32_t s0 = tc::smem_u32(sm);
  float4* ps = reinterpret_cast<float4*>(sm + L::oP);
  float* ls = reinterpret_cast<float*>(sm + L::oL);   // lse log2 e
  float* dl = ls + 2 * kQStep;                        // delta
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, wtid = tid % 128, w = wtid / 32;
  const int lane = tid % 32, g4 = lane / 4, t4 = lane % 4;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  load_swz<DQK>(sm + L::oK, tid, k, [&](int r) -> const bf16* {
    return k0 + r < p.S ? k + kv_row(k0 + r) * DQK : nullptr;
  });
  load_swz<DV>(sm + L::oV, tid, v, [&](int r) -> const bf16* {
    return k0 + r < p.S ? v + kv_row(k0 + r) * DV : nullptr;
  });
  // the block's share (blockIdx.z of nsplit) of the admitted query steps
  int q_begin, q_end;
  query_range(p, k0, KT, kQStep, &q_begin, &q_end);
  const int all = q_end > q_begin ? (q_end - q_begin + kQStep - 1) / kQStep
                                  : 0;
  const int share = (all + p.nsplit - 1) / p.nsplit;
  const int it0 = min(all, static_cast<int>(blockIdx.z) * share);
  const int steps = min(all - it0, share);
  q_begin += it0 * kQStep;
  auto issue = [&](int it) {  // one commit group (the first carries K, V)
    const int sg = it & 1, q0 = q_begin + it * kQStep;
    load_swz<DQK>(sm + L::oQ + sg * (DQK / 64) * kBlk, tid, q,
                  [&](int r) -> const bf16* {
                    return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
                  });
    load_swz<DV>(sm + L::oO + sg * (DV / 64) * kBlk, tid, dout,
                 [&](int r) -> const bf16* {
                   return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
                 });
    if (tid < kQStep) {
      const int i = q0 + tid;
      const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + i;
      ls[sg * kQStep + tid] = i < p.S ? p.lse[o] * tc::kLog2e : 0.f;
      dl[sg * kQStep + tid] = i < p.S ? p.delta[o] : 0.f;
    }
    tc::cp_async_commit();
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = p.scale * tc::kLog2e;
  issue(0);
  for (int it = 0; it < steps; ++it) {
    tc::cp_async_wait<0>();  // step it has landed
    wg::fence_async_smem();  // ... visible to wgmma
    __syncthreads();         // ... and every thread is done with step it-1
    if (it + 1 < steps) issue(it + 1);
    const int sg = it & 1, q0 = q_begin + it * kQStep;
    const uint32_t qt = s0 + L::oQ + sg * (DQK / 64) * kBlk;
    const uint32_t dt = s0 + L::oO + sg * (DV / 64) * kBlk;
    const float* l2 = ls + sg * kQStep;
    const float* dlt = dl + sg * kQStep;
    // S^T (role 0) or dP^T (role 1): the warpgroup's 64 keys x 64 queries
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t a0 = s0 + (ROLE == 0 ? L::oK : L::oV);
    const uint32_t b0 = ROLE == 0 ? qt : dt;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBlk + (kk % 4) * 32;
      wg::ss_n64_t0(s, wg::desc(a0 + off, 16, 1024),
                    wg::desc(b0 + off, 16, 1024), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    const bool inside = tile_inside(p, q0, kQStep, k0, KT);
    if (ROLE == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i / 4) * 8 + 2 * t4 + (i & 1);
        const int kj = k0 + 16 * w + g4 + 8 * ((i >> 1) & 1);
        s[i] = inside || admit(p, q0 + c, kj)
                   ? tc::ex2(s[i] * scale_log2 - l2[c])
                   : 0.f;
      }
#pragma unroll
      for (int x = 0; x < 8; ++x)
        ps[x * 128 + wtid] =
            make_float4(s[4 * x], s[4 * x + 1], s[4 * x + 2], s[4 * x + 3]);
      wg::bar_arrive(1, 2 * 128);  // P^T is written
    } else {
      wg::bar_sync(1, 2 * 128);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float4 pr = ps[x * 128 + wtid];
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * x + e, c = x * 8 + 2 * t4 + (e & 1);
          s[i] = pv[e] * (s[i] - dlt[c]);
        }
      }
    }
    // dV += P^T dO (role 0), dK += dS^T Q (role 1), over the 64 queries:
    // the scores' registers are the A fragments, in bf16
    const uint32_t bt = ROLE == 0 ? dt : qt;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk) {
      const uint32_t a[4] = {tc::pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      Rs<N>::mma(acc, a, wg::desc(bt + kk * 16 * 128, kBlk, 1024));
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
  }
  if (steps == 0) tc::cp_async_wait<0>();

  // G = 1 and one share: in bf16; else this head's and share's fp32
  // partial (dK then dV in `part`)
  const bool f32 = G > 1 || p.nsplit > 1;
  const float sc = ROLE == 0 ? 1.f : p.scale;
  const size_t dk_all =
      static_cast<size_t>(p.B) * p.S * p.Hq * p.nsplit * DQK;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = k0 + 16 * w + g4 + 8 * hh;
    if (pos >= p.S) continue;
    const size_t r =
        ((static_cast<size_t>(b) * p.S + pos) * p.Hq + hq) * p.nsplit +
        blockIdx.z;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float x0 = acc[4 * j + 2 * hh] * sc;
      const float x1 = acc[4 * j + 2 * hh + 1] * sc;
      if (f32)
        *reinterpret_cast<float2*>(
            p.part + (ROLE == 0 ? dk_all + r * DV : r * DQK) + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(
            static_cast<bf16*>(ROLE == 0 ? p.dv : p.dk) + kv_row(pos) * N +
            col) = tc::pack_bf16(x0, x1);
    }
  }
}

// (ii) bf16 on wgmma: grid (B * Hq, ceil(S / 64), nsplit), two
// warpgroups a block, one per role (kv_wgmma_role)
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, min_blocks<DQK>())
    flash_bwd_kv_wgmma_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int G = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hq, hq = blockIdx.x % p.Hq, hk = hq / G;
  const int k0 = blockIdx.y * kKvKeys;
  if (threadIdx.x < 128)
    kv_wgmma_role<0, DQK, DV>(p, sm, b, hq, hk, k0);
  else
    kv_wgmma_role<1, DQK, DV>(p, sm, b, hq, hk, k0);
}

// (iii) bf16 on wgmma, launched first: one warpgroup a block of 64 query
// rows (grid n_qt * B * Hq, the last query tiles first), over the admitted
// key tiles of 64 (K and V double-buffered, swizzled): S = Q K^T and dP =
// dO V^T on wgmma from shared memory, dS = P (dP - delta) in registers,
// dQ += dS K with dS as the A fragments (K as an MN-major B).  delta of
// the block's rows from dO in shared memory and O read once from device
// memory, written for (ii).
template <int DQK, int DV>
struct QW {
  static constexpr uint32_t kBlk = 64 * 128;  // a 64-column block
  static constexpr uint32_t oQ = 0;
  static constexpr uint32_t oD = oQ + DQK / 64 * kBlk;        // dO
  static constexpr uint32_t oK = oD + DV / 64 * kBlk;         // 2 stages
  static constexpr uint32_t oV = oK + 2 * (DQK / 64) * kBlk;  // 2 stages
  static constexpr uint32_t oL = oV + 2 * (DV / 64) * kBlk;   // delta
  static constexpr size_t bytes = 1024 + oL + 4 * 64;
};
constexpr int kWgThreads = 128;

template <int DQK, int DV>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_q_wgmma_kernel(Args p) {
  using L = QW<DQK, DV>;
  constexpr uint32_t kBlk = L::kBlk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t s0 = tc::smem_u32(sm);
  float* dls = reinterpret_cast<float*>(sm + L::oL);
  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.S + 63) / 64;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq, hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * 64;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  load_swz<DQK, kWgThreads>(sm + L::oQ, tid, q, [&](int r) -> const bf16* {
    return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
  });
  load_swz<DV, kWgThreads>(sm + L::oD, tid, dout, [&](int r) -> const bf16* {
    return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
  });
  tc::cp_async_commit();
  const size_t row0 = (static_cast<size_t>(b) * p.Hq + hq) * p.S + q0;
  float l2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * w + g4 + 8 * hh;
    l2[hh] = q0 + r < p.S ? p.lse[row0 + r] * tc::kLog2e : 0.f;
  }
  // the block's share (blockIdx.y of nsplit) of the admitted key tiles
  int k_begin, k_end;
  key_range(p, q0, min(q0 + 64, p.S) - 1, 64, &k_begin, &k_end);
  const int all = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;
  const int share = (all + p.nsplit - 1) / p.nsplit;
  const int it0 = min(all, static_cast<int>(blockIdx.y) * share);
  const int ntiles = min(all - it0, share);
  k_begin += it0 * 64;
  auto issue = [&](int it) {  // one commit group a key tile
    const int sg = it & 1, pos0 = k_begin + it * 64;
    load_swz<DQK, kWgThreads>(
        sm + L::oK + sg * (DQK / 64) * kBlk, tid, k,
        [&](int r) -> const bf16* {
          return pos0 + r < k_end ? k + kv_row(pos0 + r) * DQK : nullptr;
        });
    load_swz<DV, kWgThreads>(
        sm + L::oV + sg * (DV / 64) * kBlk, tid, v,
        [&](int r) -> const bf16* {
          return pos0 + r < k_end ? v + kv_row(pos0 + r) * DV : nullptr;
        });
    tc::cp_async_commit();
  };
  issue(0);
  // delta of the block's rows, two threads a row: O from device memory,
  // dO from its tile (rows past S: zero)
  tc::cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  {
    const int r = tid / 2, c0 = tid % 2 * (DV / 2);
    const bf16* o = static_cast<const bf16*>(p.o) + q_row(q0 + r) * DV;
    float x = 0.f;
    if (q0 + r < p.S) {
#pragma unroll 4
      for (int c = c0; c < c0 + DV / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(sm + L::oD +
                                                         wg::swz(64, r, c));
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x += __bfloat162float(oe[e]) * __bfloat162float(de[e]);
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (tid % 2 == 0) {
      dls[r] = x;
      if (q0 + r < p.S && blockIdx.y == 0) p.delta[row0 + r] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) dlt[hh] = dls[16 * w + g4 + 8 * hh];

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = p.scale * tc::kLog2e;
  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<0>();  // tile it has landed
    wg::fence_async_smem();  // ... visible to wgmma
    __syncthreads();         // ... and every thread is done with tile it-1
    if (it + 1 < ntiles) issue(it + 1);
    const int sg = it & 1, pos0 = k_begin + it * 64;
    const uint32_t kt = s0 + L::oK + sg * (DQK / 64) * kBlk;
    const uint32_t vt = s0 + L::oV + sg * (DV / 64) * kBlk;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBlk + (kk % 4) * 32;
      wg::ss_n64_t0(s, wg::desc(s0 + L::oQ + off, 16, 1024),
                    wg::desc(kt + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBlk + (kk % 4) * 32;
      wg::ss_n64_t0(dp, wg::desc(s0 + L::oD + off, 16, 1024),
                    wg::desc(vt + off, 16, 1024), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);
    const bool inside = tile_inside(p, q0, 64, pos0, 64);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int kj = pos0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const float pr = inside || admit(p, q0 + 16 * w + g4 + 8 * hh, kj)
                           ? tc::ex2(s[i] * scale_log2 - l2[hh])
                           : 0.f;
      s[i] = pr * (dp[i] - dlt[hh]);
    }
    // dQ += dS K: dS's registers the A fragments (bf16), K an MN-major B
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {tc::pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      Rs<DQK>::mma(acc, a, wg::desc(kt + kk * 16 * 128, kBlk, 1024));
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
  }
  if (ntiles == 0) tc::cp_async_wait<0>();

  // one share: dQ in bf16; else this share's fp32 partial, after the
  // dK and dV partials in `part`
  bf16* dq = static_cast<bf16*>(p.dq);
  const size_t rows = static_cast<size_t>(p.B) * p.S * p.Hq;
  float* pq = p.part + rows * p.nsplit * (DQK + DV);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + 16 * w + g4 + 8 * hh;
    if (i >= p.S) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j) {
      const float x0 = acc[4 * j + 2 * hh] * p.scale;
      const float x1 = acc[4 * j + 2 * hh + 1] * p.scale;
      const int col = 8 * j + 2 * t4;
      if (p.nsplit > 1)
        *reinterpret_cast<float2*>(
            pq + (q_row(i) * p.nsplit + blockIdx.y) * DQK + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(dq + q_row(i) * DQK + col) =
            tc::pack_bf16(x0, x1);
    }
  }
}

// (iv) with G > 1 or nsplit > 1: each gradient row from its fp32
// partials, summed in order, two columns a thread, written in T: dK and
// dV of a kv head over its G query heads, each over its nsplit shares of
// the queries (head g = 0 first, each head's shares in order); with
// `dq_parts`, dQ of a query head over its nsplit shares of the keys
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(Args p, int Dqk, int Dv, int dq_parts) {
  const long kv_rows = static_cast<long>(p.B) * p.S * p.Hkv;
  const long hq_rows = static_cast<long>(p.B) * p.S * p.Hq;
  const int nkv = p.Hq / p.Hkv * p.nsplit;   // partials of a dK/dV row
  const long n0 = kv_rows * (Dqk / 2), n1 = n0 + kv_rows * (Dv / 2);
  const bool dq = dq_parts != 0;  // dQ's partials follow dK's and dV's
  const long n2 = n1 + (dq ? hq_rows * (Dqk / 2) : 0);
  const float* pk = p.part;
  const float* pv = pk + hq_rows * p.nsplit * Dqk;
  const float* pq = pv + hq_rows * p.nsplit * Dv;
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n2;
       i += static_cast<long>(gridDim.x) * 256) {
    const int seg = i < n0 ? 0 : i < n1 ? 1 : 2;
    const long j = i - (seg == 0 ? 0 : seg == 1 ? n0 : n1);
    const int D = seg == 1 ? Dv : Dqk, n = seg == 2 ? p.nsplit : nkv;
    const long row = j / (D / 2);
    const int c = static_cast<int>(j % (D / 2)) * 2;
    const float* src = (seg == 0 ? pk : seg == 1 ? pv : pq) + row * n * D + c;
    float x0 = 0.f, x1 = 0.f;
    for (int g = 0; g < n; ++g) {
      const float2 x = *reinterpret_cast<const float2*>(src + g * D);
      x0 += x.x;
      x1 += x.y;
    }
    T* dst = static_cast<T*>(seg == 0 ? p.dk : seg == 1 ? p.dv : p.dq) +
             row * D + c;
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
    else
      *reinterpret_cast<uint32_t*>(dst) = tc::pack_bf16(x0, x1);
  }
}

template <int DQK, int DV>
__host__ __device__ constexpr size_t q_smem_bytes() {
  return sizeof(bf16) *
             (static_cast<size_t>(q_rows<DQK>() + 2 * kKeyStep) *
                  (DQK + DV + 2 * tc::kPad) +
              static_cast<size_t>(q_rows<DQK>()) * (kDP + DV + tc::kPad)) +
         sizeof(float) * q_rows<DQK>();
}

// (iii) bf16, launched first: grid n_qt * B * Hq, the last query tiles
// (the most keys, causal) first.  It also computes delta = rowsum(dO o)
// of its rows from O and dO in shared memory and writes it for (ii).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, min_blocks<DQK>())
    flash_bwd_q_kernel(Args p) {
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  constexpr int QR = q_rows<DQK>();
  constexpr int RQ = QR / 16;           // row tiles of queries
  constexpr int NCG = kWarps / RQ;      // column groups
  constexpr int NS = kKeyStep / 8 / NCG;  // a warp's 8-key score tiles
  using CQ = Cols<DQK, NCG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + QR * QS;
  bf16* ks = dos + QR * VS;              // ring of two key tiles
  bf16* vs = ks + 2 * kKeyStep * QS;     // ring of two
  bf16* dss = vs + 2 * kKeyStep * VS;    // dS (queries x keys)
  bf16* os = dss + QR * kDP;             // O
  float* dls = reinterpret_cast<float*>(os + QR * VS);  // delta

  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.S + QR - 1) / QR;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq, hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * QR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % RQ, cg = warp / RQ;
  const int g4 = lane / 4, t4 = lane % 4;
  const Lanes ln(lane);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  tc::load_rows<DQK, QR, kThreads>(qs, tid, q, [&](int r) -> const bf16* {
    return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
  });
  tc::load_rows<DV, QR, kThreads>(dos, tid, dout, [&](int r) -> const bf16* {
    return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
  });
  const bf16* o = static_cast<const bf16*>(p.o);
  tc::load_rows<DV, QR, kThreads>(os, tid, o, [&](int r) -> const bf16* {
    return q0 + r < p.S ? o + q_row(q0 + r) * DV : nullptr;
  });
  tc::cp_async_commit();
  const int i0 = rt * 16 + g4;      // the thread's score rows: i0, i0 + 8
  const size_t row0 = (static_cast<size_t>(b) * p.Hq + hq) * p.S + q0;
  float l2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    l2[hh] = i < p.S ? p.lse[row0 + i0 + 8 * hh] * tc::kLog2e : 0.f;
  }
  int k_begin, k_end;
  key_range(p, q0, min(q0 + QR, p.S) - 1, kKeyStep, &k_begin, &k_end);
  const int ntiles = k_end > k_begin
                         ? (k_end - k_begin + kKeyStep - 1) / kKeyStep
                         : 0;
  auto issue = [&](int it) {  // one commit group a key tile
    const int sg = it & 1, pos0 = k_begin + it * kKeyStep;
    tc::load_rows<DQK, kKeyStep, kThreads>(
        ks + sg * kKeyStep * QS, tid, k, [&](int r) -> const bf16* {
          return pos0 + r < k_end ? k + kv_row(pos0 + r) * DQK : nullptr;
        });
    tc::load_rows<DV, kKeyStep, kThreads>(
        vs + sg * kKeyStep * VS, tid, v, [&](int r) -> const bf16* {
          return pos0 + r < k_end ? v + kv_row(pos0 + r) * DV : nullptr;
        });
    tc::cp_async_commit();
  };

  float acc[2 * CQ::kMax][4];
  zero(acc);
  const float scale_log2 = p.scale * tc::kLog2e;
  issue(0);
  // delta of the block's rows, TPR threads a row (rows past S: zero)
  tc::cp_async_wait<1>();  // Q, dO and O have landed
  __syncthreads();
  {
    constexpr int TPR = kThreads / QR, PER = DV / TPR;
    static_assert(DV % TPR == 0, "delta's columns split evenly");
    const int r = tid / TPR, c0 = tid % TPR * PER;
    float x = 0.f;
#pragma unroll 4
    for (int e = c0; e < c0 + PER; ++e)
      x += __bfloat162float(os[r * VS + e]) *
           __bfloat162float(dos[r * VS + e]);
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (tid % TPR == 0) {
      dls[r] = x;
      if (q0 + r < p.S) p.delta[row0 + r] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) dlt[hh] = dls[i0 + 8 * hh];
  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<0>();  // tile it has landed
    __syncthreads();         // ... and every warp is done with tile it - 1
    if (it + 1 < ntiles) issue(it + 1);
    const int sg = it & 1, pos0 = k_begin + it * kKeyStep;
    const bf16* kt = ks + sg * kKeyStep * QS;
    const bf16* vt = vs + sg * kKeyStep * VS;
    const bool inside = tile_inside(p, q0, QR, pos0, kKeyStep);
    // S = Q K^T and dP = dO V^T over the warp's 16 rows and NS x 8 keys,
    // once a block: dS goes to shared memory in bf16
    float s[NS][4], dp[NS][4];
    const int c0 = cg * NS * 8;
    mma_nt<DQK, QS, QS, NS>(s, qs + rt * 16 * QS, kt + c0 * QS, ln);
    mma_nt<DV, VS, VS, NS>(dp, dos + rt * 16 * VS, vt + c0 * VS, ln);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kj = pos0 + c0 + j * 8 + 2 * t4 + (e & 1);
        const float pr = inside || admit(p, q0 + i0 + 8 * hh, kj)
                             ? tc::ex2(s[j][e] * scale_log2 - l2[hh])
                             : 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[hh]);
      }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dss + (i0 + 8 * hh) * kDP + c0 + j * 8 +
                                     2 * t4) =
            tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
    __syncthreads();
    // dQ += dS K over the warp's 16 rows and columns
    mma_nn<kKeyStep, kDP, QS, CQ::kMax>(acc, dss + rt * 16 * kDP, kt,
                                        CQ::begin(cg), CQ::count(cg), ln);
  }
  if (ntiles == 0) tc::cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    if (i < p.S)
      store_rows<CQ::kMax>(acc, hh, CQ::begin(cg), CQ::count(cg), t4,
                           p.scale, dq + q_row(i) * DQK, false);
  }
}

// the fp32 kernels' shared memory: the block's own R rows of DQK and DV,
// a ring of two steps of 32 of each, two staged score tiles (R x 40), and
// lse and delta of two steps
template <int DQK, int DV>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(f32_rows<DQK>() + 2 * kF32Step) *
              (DQK + DV + 2 * tf::kPad) +
          2 * static_cast<size_t>(f32_rows<DQK>()) * kF32SP + 4 * kF32Step);
}

// a warp's 16 x NS 8 score tile (C fragments, rows r0 and r0 + 8 of the
// thread) into a staged tile of stride kF32SP at columns c0..
template <int NS>
__device__ __forceinline__ void stage_rows(float* dst, const float (&x)[NS][4],
                                           int r0, int c0, int t4) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(dst + (r0 + 8 * hh) * kF32SP + c0 + j * 8 +
                                 2 * t4) =
          make_float2(x[j][2 * hh], x[j][2 * hh + 1]);
}

// (ii) fp32: grid (B * Hq, ceil(S / R), nsplit), one query head, R keys
// (f32_rows) and share of the query steps a block, 8 warps.  Per step of
// 32 queries, S^T = K Q^T on warps 0-3 and dP^T = V dO^T on warps 4-7 at
// once (a role's 4 warps tile the step's R x 32 scores, each warp 16 x 8
// NS, so each A fragment serves NS products: tf::dot_rows), P^T and then
// dS^T staged in fp32 shared memory; then each warp sums dV += P^T dO and
// dK += dS^T Q for its 16 keys (RT row tiles) and its column group (NCG);
// every product in 3xTF32.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, f32_min_blocks<DQK, DV>())
    flash_bwd_kv_f32_kernel(Args p) {
  constexpr int QS = DQK + tf::kPad, VS = DV + tf::kPad;
  constexpr int KT = f32_rows<DQK>(), QT = kF32Step;
  constexpr int RT = KT / 16;            // row tiles of keys
  constexpr int NCG = kWarps / RT;       // column groups (the sums)
  constexpr int NK = DQK / 8 / NCG, NV = DV / 8 / NCG;  // its 8-col tiles
  constexpr int NCS = 4 / RT;            // column groups (a role's scores)
  constexpr int NS = QT / 8 / NCS;       // a warp's 8-query score tiles
  static_assert(NS >= 1 && DQK / 8 % NCG == 0 && DV / 8 % NCG == 0,
                "column groups split evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + KT * QS;
  float* qs = vs + KT * VS;            // ring of two query steps
  float* dos = qs + 2 * QT * QS;       // ring of two
  float* pts = dos + 2 * QT * VS;      // P^T (keys x queries)
  float* dst = pts + KT * kF32SP;      // dS^T
  float* ls = dst + KT * kF32SP;       // lse log2 e, two stages
  float* dl = ls + 2 * QT;             // delta, two stages

  const int G = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hq, hq = blockIdx.x % p.Hq, hk = hq / G;
  const int k0 = blockIdx.y * KT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % RT, cg = warp / RT;  // row tile, column group
  // the score phase: warps 0-3 S^T and P^T, warps 4-7 dP^T and dS^T, each
  // its row tile rs of keys and NS x 8 queries from c0
  const int role = warp / 4, rs = warp % 4 % RT;
  const int c0 = warp % 4 / RT * NS * 8;
  const int g4 = lane / 4, t4 = lane % 4;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  // keys past S are zero-filled (and never admitted)
  tf::load_rows<DQK, KT, kThreads>(ks, tid, k, [&](int r) -> const float* {
    return k0 + r < p.S ? k + kv_row(k0 + r) * DQK : nullptr;
  });
  tf::load_rows<DV, KT, kThreads>(vs, tid, v, [&](int r) -> const float* {
    return k0 + r < p.S ? v + kv_row(k0 + r) * DV : nullptr;
  });
  // the block's share (blockIdx.z of nsplit) of the admitted query steps
  int q_begin, q_end;
  query_range(p, k0, KT, QT, &q_begin, &q_end);
  const int all = q_end > q_begin ? (q_end - q_begin + QT - 1) / QT : 0;
  const int share = (all + p.nsplit - 1) / p.nsplit;
  const int it0 = min(all, static_cast<int>(blockIdx.z) * share);
  const int steps = min(all - it0, share);
  q_begin += it0 * QT;
  auto issue = [&](int it) {  // one commit group (the first carries K, V)
    const int sg = it & 1, q0 = q_begin + it * QT;
    tf::load_rows<DQK, QT, kThreads>(
        qs + sg * QT * QS, tid, q, [&](int r) -> const float* {
          return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
        });
    tf::load_rows<DV, QT, kThreads>(
        dos + sg * QT * VS, tid, dout, [&](int r) -> const float* {
          return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
        });
    if (tid < QT) {
      const int i = q0 + tid;
      const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + i;
      ls[sg * QT + tid] = i < p.S ? p.lse[o] * tc::kLog2e : 0.f;
      dl[sg * QT + tid] = i < p.S ? p.delta[o] : 0.f;
    }
    tc::cp_async_commit();
  };

  float acc_v[NV][4], acc_k[NK][4];
  zero(acc_v);
  zero(acc_k);
  const float scale_log2 = p.scale * tc::kLog2e;
  // the role's A operand: K (S^T) or V (dP^T), its rows rs
  const float* ar = role == 0 ? ks + rs * 16 * QS : vs + rs * 16 * VS;
  issue(0);
  for (int it = 0; it < steps; ++it) {
    tc::cp_async_wait<0>();  // step it has landed
    // one barrier: step it is visible, and every warp is done with step
    // it - 1 (its stage, P^T and dS^T), which the next issue overwrites
    __syncthreads();
    if (it + 1 < steps) issue(it + 1);
    const int sg = it & 1, q0 = q_begin + it * QT;
    const float* qt = qs + sg * QT * QS;
    const float* dt = dos + sg * QT * VS;
    const float* l2 = ls + sg * QT;
    const float* dlt = dl + sg * QT;
    const bool inside = tile_inside(p, q0, QT, k0, KT);
    // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1) over the warp's 16
    // keys and NS x 8 queries, once a block (small products and hi hi
    // apart: tf::mma3); role 0 writes P^T, then role 1 reads it and
    // writes dS^T = P^T (dP^T - delta)
    float s[NS][4], sb[NS][4];
    if (role == 0)
      tf::dot_rows<DQK, QS, NS>(s, sb, ar, qt + c0 * QS, g4, t4);
    else
      tf::dot_rows<DV, VS, NS>(s, sb, ar, dt + c0 * VS, g4, t4);
    const int kr0 = rs * 16 + g4;  // the thread's key rows: kr0, kr0 + 8
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + j * 8 + 2 * t4 + (e & 1);
        const float x = sb[j][e] + s[j][e];
        if (role == 0)
          s[j][e] = inside || admit(p, q0 + c, k0 + kr0 + 8 * (e >> 1))
                        ? tc::ex2(x * scale_log2 - l2[c])
                        : 0.f;
        else
          s[j][e] = x - dlt[c];
      }
    if (role == 0) stage_rows<NS>(pts, s, kr0, c0, t4);
    __syncthreads();  // P^T is written
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 pr = *reinterpret_cast<const float2*>(
              pts + (kr0 + 8 * hh) * kF32SP + c0 + j * 8 + 2 * t4);
          s[j][2 * hh] *= pr.x;
          s[j][2 * hh + 1] *= pr.y;
        }
      stage_rows<NS>(dst, s, kr0, c0, t4);
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the warp's 16 keys and columns,
    // the queries (k) permuted: each step's sum in fresh accumulators,
    // then one fp32 add (tf32_mma.cuh)
    {
      float step[NV][4];
      zero(step);
#pragma unroll
      for (int kc = 0; kc < QT / 8; ++kc) {
        tf::FragA a;
        tf::load_a_perm<kF32SP>(a, pts + rt * 16 * kF32SP + kc * 8, g4, t4);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          tf::FragB f;
          tf::load_b_perm<VS>(f, dt + kc * 8 * VS + (cg * NV + n) * 8, g4,
                              t4);
          tf::mma3(step[n], a, f);
        }
      }
      tf::add(acc_v, step);
    }
    {
      float step[NK][4];
      zero(step);
#pragma unroll
      for (int kc = 0; kc < QT / 8; ++kc) {
        tf::FragA a;
        tf::load_a_perm<kF32SP>(a, dst + rt * 16 * kF32SP + kc * 8, g4, t4);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          tf::FragB f;
          tf::load_b_perm<QS>(f, qt + kc * 8 * QS + (cg * NK + n) * 8, g4,
                              t4);
          tf::mma3(step[n], a, f);
        }
      }
      tf::add(acc_k, step);
    }
  }
  if (steps == 0) tc::cp_async_wait<0>();

  // G = 1 and one share: dK and dV in fp32; else this head's and share's
  // partial (dK then dV in `part`), summed by flash_bwd_sum_kernel
  const bool part = G > 1 || p.nsplit > 1;
  const size_t dk_all =
      static_cast<size_t>(p.B) * p.S * p.Hq * p.nsplit * DQK;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = k0 + rt * 16 + g4 + 8 * hh;
    if (pos >= p.S) continue;
    float* dk_row;
    float* dv_row;
    if (part) {
      const size_t r =
          ((static_cast<size_t>(b) * p.S + pos) * p.Hq + hq) * p.nsplit +
          blockIdx.z;
      dk_row = p.part + r * DQK;
      dv_row = p.part + dk_all + r * DV;
    } else {
      dk_row = static_cast<float*>(p.dk) + kv_row(pos) * DQK;
      dv_row = static_cast<float*>(p.dv) + kv_row(pos) * DV;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<float2*>(dv_row + (cg * NV + n) * 8 + 2 * t4) =
          make_float2(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(dk_row + (cg * NK + n) * 8 + 2 * t4) =
          make_float2(acc_k[n][2 * hh] * p.scale,
                      acc_k[n][2 * hh + 1] * p.scale);
  }
}

// (iii) fp32, launched first: grid (n_qt * B * Hq, nsplit), R query rows
// (f32_rows) of one query head and a share of their key steps a block
// (the last query tiles first), 8 warps.  delta = rowsum(dO o) of its
// rows (O from device memory, dO from its tile), written for (ii) by the
// first share; then per step of 32 keys S = Q K^T on warps 0-3 and dP =
// dO V^T on warps 4-7 at once, P and then dS = P (dP - delta) staged in
// fp32 shared memory, dQ += dS K per warp (RQ row tiles of 16) and
// column group (NCG), in 3xTF32.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, f32_min_blocks<DQK, DV>())
    flash_bwd_q_f32_kernel(Args p) {
  constexpr int QS = DQK + tf::kPad, VS = DV + tf::kPad;
  constexpr int QR = f32_rows<DQK>(), KS = kF32Step;
  constexpr int RQ = QR / 16;            // row tiles of queries
  constexpr int NCG = kWarps / RQ;       // column groups (dQ's sum)
  constexpr int NQ = DQK / 8 / NCG;      // its 8-column tiles of dQ
  constexpr int NCS = 4 / RQ;            // column groups (a role's scores)
  constexpr int NS = KS / 8 / NCS;       // a warp's 8-key score tiles
  static_assert(NS >= 1 && DQK / 8 % NCG == 0, "column groups split evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + QR * QS;
  float* ks = dos + QR * VS;           // ring of two key steps
  float* vs = ks + 2 * KS * QS;        // ring of two
  float* pss = vs + 2 * KS * VS;       // P (queries x keys)
  float* dss = pss + QR * kF32SP;      // dS
  float* dls = dss + QR * kF32SP;      // delta

  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.S + QR - 1) / QR;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq, hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * QR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % RQ, cg = warp / RQ;
  // the score phase: warps 0-3 S and P, warps 4-7 dP and dS, each its row
  // tile rs of queries and NS x 8 keys from c0
  const int role = warp / 4, rs = warp % 4 % RQ;
  const int c0 = warp % 4 / RQ * NS * 8;
  const int g4 = lane / 4, t4 = lane % 4;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  tf::load_rows<DQK, QR, kThreads>(qs, tid, q, [&](int r) -> const float* {
    return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
  });
  tf::load_rows<DV, QR, kThreads>(dos, tid, dout,
                                  [&](int r) -> const float* {
    return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
  });
  tc::cp_async_commit();
  const int i0 = rt * 16 + g4;      // the thread's dQ rows: i0, i0 + 8
  const int is0 = rs * 16 + g4;     // its score rows: is0, is0 + 8
  const size_t row0 = (static_cast<size_t>(b) * p.Hq + hq) * p.S + q0;
  float l2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + is0 + 8 * hh;
    l2[hh] = i < p.S ? p.lse[row0 + is0 + 8 * hh] * tc::kLog2e : 0.f;
  }
  // the block's share (blockIdx.y of nsplit) of the admitted key steps
  int k_begin, k_end;
  key_range(p, q0, min(q0 + QR, p.S) - 1, KS, &k_begin, &k_end);
  const int all = k_end > k_begin ? (k_end - k_begin + KS - 1) / KS : 0;
  const int share = (all + p.nsplit - 1) / p.nsplit;
  const int it0 = min(all, static_cast<int>(blockIdx.y) * share);
  const int ntiles = min(all - it0, share);
  k_begin += it0 * KS;
  auto issue = [&](int it) {  // one commit group a key step
    const int sg = it & 1, pos0 = k_begin + it * KS;
    tf::load_rows<DQK, KS, kThreads>(
        ks + sg * KS * QS, tid, k, [&](int r) -> const float* {
          return pos0 + r < k_end ? k + kv_row(pos0 + r) * DQK : nullptr;
        });
    tf::load_rows<DV, KS, kThreads>(
        vs + sg * KS * VS, tid, v, [&](int r) -> const float* {
          return pos0 + r < k_end ? v + kv_row(pos0 + r) * DV : nullptr;
        });
    tc::cp_async_commit();
  };

  float acc[NQ][4];
  zero(acc);
  const float scale_log2 = p.scale * tc::kLog2e;
  issue(0);
  // delta of the block's rows, TPR threads a row: O from device memory,
  // dO from its tile (rows past S: zero)
  tc::cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  {
    constexpr int TPR = kThreads / QR, PER = DV / TPR;
    static_assert(DV % TPR == 0, "delta's columns split evenly");
    const int r = tid / TPR, c0 = tid % TPR * PER;
    const float* o = static_cast<const float*>(p.o) + q_row(q0 + r) * DV;
    float x = 0.f;
    if (q0 + r < p.S) {
#pragma unroll 4
      for (int e = c0; e < c0 + PER; ++e) x += o[e] * dos[r * VS + e];
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (tid % TPR == 0) {
      dls[r] = x;
      if (q0 + r < p.S && blockIdx.y == 0) p.delta[row0 + r] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) dlt[hh] = dls[is0 + 8 * hh];
  // the role's A operand: Q (S) or dO (dP), its rows rs
  const float* ar = role == 0 ? qs + rs * 16 * QS : dos + rs * 16 * VS;
  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<0>();  // step it has landed
    __syncthreads();         // ... and every warp is done with step it - 1
    if (it + 1 < ntiles) issue(it + 1);
    const int sg = it & 1, pos0 = k_begin + it * KS;
    const float* kt = ks + sg * KS * QS;
    const float* vt = vs + sg * KS * VS;
    const bool inside = tile_inside(p, q0, QR, pos0, KS);
    // S = Q K^T (role 0) or dP = dO V^T (role 1) over the warp's 16 rows
    // and NS x 8 keys, once a block (small products and hi hi apart:
    // tf::mma3); role 0 writes P, then role 1 reads it and writes dS = P
    // (dP - delta)
    float s[NS][4], sb[NS][4];
    if (role == 0)
      tf::dot_rows<DQK, QS, NS>(s, sb, ar, kt + c0 * QS, g4, t4);
    else
      tf::dot_rows<DV, VS, NS>(s, sb, ar, vt + c0 * VS, g4, t4);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kj = pos0 + c0 + j * 8 + 2 * t4 + (e & 1);
        const float x = sb[j][e] + s[j][e];
        if (role == 0)
          s[j][e] = inside || admit(p, q0 + is0 + 8 * hh, kj)
                        ? tc::ex2(x * scale_log2 - l2[hh])
                        : 0.f;
        else
          s[j][e] = x - dlt[hh];
      }
    if (role == 0) stage_rows<NS>(pss, s, is0, c0, t4);
    __syncthreads();  // P is written
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 pr = *reinterpret_cast<const float2*>(
              pss + (is0 + 8 * hh) * kF32SP + c0 + j * 8 + 2 * t4);
          s[j][2 * hh] *= pr.x;
          s[j][2 * hh + 1] *= pr.y;
        }
      stage_rows<NS>(dss, s, is0, c0, t4);
    }
    __syncthreads();
    // dQ += dS K over the warp's 16 rows and columns, the keys permuted:
    // the step's sum in fresh accumulators, then one fp32 add
    float step[NQ][4];
    zero(step);
#pragma unroll
    for (int kc = 0; kc < KS / 8; ++kc) {
      tf::FragA a;
      tf::load_a_perm<kF32SP>(a, dss + rt * 16 * kF32SP + kc * 8, g4, t4);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        tf::FragB f;
        tf::load_b_perm<QS>(f, kt + kc * 8 * QS + (cg * NQ + n) * 8, g4, t4);
        tf::mma3(step[n], a, f);
      }
    }
    tf::add(acc, step);
  }
  if (ntiles == 0) tc::cp_async_wait<0>();

  // one share: dQ; else this share's partial, after the dK and dV
  // partials in `part`
  const size_t rows = static_cast<size_t>(p.B) * p.S * p.Hq;
  float* pq = p.part + rows * p.nsplit * (DQK + DV);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    if (i >= p.S) continue;
    float* row = p.nsplit > 1
                     ? pq + (q_row(i) * p.nsplit + blockIdx.y) * DQK
                     : static_cast<float*>(p.dq) + q_row(i) * DQK;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      *reinterpret_cast<float2*>(row + (cg * NQ + n) * 8 + 2 * t4) =
          make_float2(acc[n][2 * hh] * p.scale,
                      acc[n][2 * hh + 1] * p.scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// (iv)'s launch: a grid-stride loop over the summed rows' column pairs
template <typename T>
int launch_sum(const Args& a, int Dqk, int Dv, bool dq_parts,
               cudaStream_t stream) {
  const long pairs = static_cast<long>(a.B) * a.S * a.Hq * (Dqk + Dv) / 2;
  const long blocks = (pairs + 255) / 256;
  flash_bwd_sum_kernel<T><<<static_cast<unsigned>(
                                blocks < 2112 ? blocks : 2112),
                            256, 0, stream>>>(a, Dqk, Dv, dq_parts);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_bf16(const Args& a, cudaStream_t stream) {
  size_t smem;
  cudaError_t e;
  if constexpr (wgmma_dq<DQK, DV>()) {
    auto qk = flash_bwd_q_wgmma_kernel<DQK, DV>;
    smem = QW<DQK, DV>::bytes;
    e = allow_smem(qk, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    qk<<<dim3((a.S + 63) / 64 * a.B * a.Hq, a.nsplit), kWgThreads, smem,
         stream>>>(a);
  } else {
    auto qk = flash_bwd_q_kernel<DQK, DV>;
    smem = q_smem_bytes<DQK, DV>();
    e = allow_smem(qk, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_qt = (a.S + q_rows<DQK>() - 1) / q_rows<DQK>();
    qk<<<n_qt * a.B * a.Hq, kThreads, smem, stream>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (wgmma_build<DQK, DV>()) {
    auto kv = flash_bwd_kv_wgmma_kernel<DQK, DV>;
    smem = KvW<DQK, DV>::bytes;
    e = allow_smem(kv, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kv<<<dim3(a.B * a.Hq, (a.S + kKvKeys - 1) / kKvKeys, a.nsplit),
         kThreads, smem, stream>>>(a);
  } else {
    auto kv = flash_bwd_kv_kernel<DQK, DV>;
    smem = kv_smem_bytes<DQK, DV>();
    e = allow_smem(kv, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kv<<<dim3(a.B * a.Hq, (a.S + kKvKeys - 1) / kKvKeys), kThreads, smem,
         stream>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || a.part == nullptr) return static_cast<int>(e);
  return launch_sum<bf16>(a, DQK, DV,
                         a.nsplit > 1 && DQK <= kWgmmaDqMax, stream);
}

template <int DQK, int DV>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int R = f32_rows<DQK>();
  const size_t smem = f32_smem_bytes<DQK, DV>();
  auto qk = flash_bwd_q_f32_kernel<DQK, DV>;
  cudaError_t e = allow_smem(qk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  qk<<<dim3((a.S + R - 1) / R * a.B * a.Hq, a.nsplit), kThreads, smem,
       stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kv = flash_bwd_kv_f32_kernel<DQK, DV>;
  e = allow_smem(kv, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(a.B * a.Hq, (a.S + R - 1) / R, a.nsplit), kThreads, smem,
       stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.part == nullptr) return static_cast<int>(e);
  return launch_sum<float>(a, DQK, DV, a.nsplit > 1, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; causal: 0 or 1; window <= 0: no window.
// lse: the forward's (B, Hq, S); delta: the wrapper's (B, Hq, S) fp32
// scratch; nsplit: the blocks a key tile (dK/dV) or a query tile (dQ) of
// the bf16 wgmma builds and of every fp32 build: 1, or 2 where B Hq
// ceil(S / rows) blocks would not fill the card (the wrapper's rule,
// kernel.py::bwd_split); part: the wrapper's fp32 scratch where Hq > Hkv
// or nsplit > 1, else null: B S Hq nsplit (Dqk + Dv) floats (the per-head
// and per-share dK, then dV), and with nsplit > 1 B S Hq nsplit Dqk more
// (dQ's per-share partials).  Launches the dQ kernel (writing delta), the
// dK/dV kernel and, with part, the partials' sum.  Returns the CUDA error
// code of the launches (0 on success); the wrapper raises on anything
// else.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* part, int B, int S, int Hq, int Hkv,
                                   int Dqk, int Dv, int causal, int window,
                                   int dtype, int nsplit, float scale,
                                   void* stream) {
  const bool wgmma_kv = Dqk % 64 == 0 && Dv % 64 == 0;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || nsplit < 1 ||
      (dtype != 0 && dtype != 1) ||
      (nsplit > 1 && dtype == 1 && !wgmma_kv) ||
      (Hq != Hkv || nsplit > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,  o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv, static_cast<float*>(part),
         B, S, Hq, Hkv, causal, window, nsplit, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = dtype == 1;
  if (Dqk == 64 && Dv == 64)
    return b16 ? launch_bf16<64, 64>(a, s) : launch_f32<64, 64>(a, s);
  if (Dqk == 80 && Dv == 80)
    return b16 ? launch_bf16<80, 80>(a, s) : launch_f32<80, 80>(a, s);
  if (Dqk == 128 && Dv == 128)
    return b16 ? launch_bf16<128, 128>(a, s) : launch_f32<128, 128>(a, s);
  if (Dqk == 256 && Dv == 256)
    return b16 ? launch_bf16<256, 256>(a, s) : launch_f32<256, 256>(a, s);
  if (Dqk == 192 && Dv == 128)
    return b16 ? launch_bf16<192, 128>(a, s) : launch_f32<192, 128>(a, s);
  if (Dqk == 48 && Dv == 32 && !b16) return launch_f32<48, 32>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
