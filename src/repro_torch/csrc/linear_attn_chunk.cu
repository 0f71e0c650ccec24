// Chunked decay linear attention for Hopper (sm_90a), plain C interface:
// RWKV6's wkv scan over a whole prompt, with an initial and a final state.
//
// Replaces the TPU kernel K6,
//   src/repro/kernels/linear_attn_chunk/kernel.py::linear_attn_chunk
// (`_chunk_body`), with the initial state, the final state and the
// in-chunk padding of src/repro/models/ssm.py::decay_attention_chunked,
// which the JAX model runs instead of the Pallas kernel because the
// kernel lacks them.
//
// What it computes, per (b, h), with per-channel log-decay w_t <= 0:
//   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
// in chunks of C tokens.  With lcw the inclusive cumulative log-decay of
// the chunk and lcw_excl = lcw - w (as the plain version forms it; at a
// strong decay |lcw| is large, and lcw[t - 1] rounds differently):
//   A[t][s] = sum_d r[t][d] k[s][d] exp(lcw_excl[t][d] - lcw[s][d]), s < t;
//   o[t]    = sum_{s<t} A[t][s] v[s] + (r[t] . (u * k[t])) v[t]
//             + (r[t] * exp(lcw_excl[t])) S;
//   S      <- S * exp(lcw[C-1]) (per row d)
//             + sum_s (k[s] * exp(lcw[C-1] - lcw[s])) v[s]^T.
// Positions at or past S (the sequence length) read as r = k = v = w = 0:
// decay 1 and nothing added, so the state passes them unchanged; this is
// the wrapper's chunk padding, done by the loads with no padded copy.
//
// Layout: r, k, v, o (B, S, H, 64) in one type, fp32 or bf16; w (B, S, H,
// 64) fp32; u (H, 64) fp32 or null; s0 (B, H, 64, 64) fp32 or null (zeros);
// s_out (B, H, 64, 64) fp32.  All contiguous.  dk = dv = 64 (RWKV6's head).
// Scratch from the wrapper (fp32), per (b, h, chunk c): q_eff and o_intra
// (C x 64 each), the state increment dS (64 x 64) and the decay (64).
// Under autograd the wrapper also passes `states` (B, H, n_chunks, 64, 64)
// fp32, and the scan writes there the state entering each chunk, which the
// backward (linear_attn_chunk_bwd.cu) reads; null otherwise.  The stores
// change no arithmetic: o and the final state keep their bits.
//
// Design: chunk-parallel, two launches.
//  (a) linear_attn_chunk_kernel, one block of 16 warps per (chunk, h, b):
//      768 blocks at B = 1, H = 32, S = 1536, C = 64.  It computes the chunk's A,
//      o_intra = A v + diag v, q_eff = r * exp(lcw_excl), dS = k2^T v with
//      k2 = k * exp(lcw[C-1] - lcw), and the decay exp(lcw[C-1]); none of
//      it depends on the state.  A is built from secondary chunks of 16:
//      the diagonal 16 x 16 blocks keep the pairwise form above (with
//      exp(min(., 0)), as the plain version), and an off-diagonal block
//      (sub-chunk i of t over sub-chunk j < i of s) factors through the
//      reference point L = lcw at the end of sub-chunk j:
//        A[t][s] = sum_d (r[t][d] exp(min(lcw_excl[t][d] - L[d], 0)))
//                        (k[s][d] exp(min(L[d] - lcw[s][d], 0))),
//      both factors <= 1 (lcw falls with t, and t - 1 >= end of j >= s;
//      the min only absorbs a rounding of lcw_excl past lcw[t - 1]),
//      so nothing overflows however strong the decay, and L depends on
//      nothing past the sequence (w = 0 there).  A factorisation against
//      the chunk start would overflow (log-decay down to -20 a step).  At
//      C = 64 a chunk takes 48,192 exponentials in fp32 (30,720 of them
//      in the diagonal blocks; 51,264 in bf16, whose tensor cores take the
//      factors straight from the tiles, unstaged, so that two blocks fit
//      an SM) where the first design's all-pairs form took 137,280.
//  (b) linear_attn_scan_kernel, one block per (slice of 16 state columns,
//      h, b): 128 blocks at B = 1, H = 32.  It carries its 64 x 16 slice
//      of the fp32 state through the chunks in order: o = o_intra +
//      q_eff S, then S <- decay * S + dS, and writes the final state.  A
//      chunk's operands come in through cp.async, a ring of three stages:
//      the next two chunks' load while this one computes.
// bf16 (r, k, v in bf16): the off-diagonal sub-block products, A v, dS and
// q_eff S run on mma.sync.m16n8k16 with fp32 accumulation.  Their fp32
// operands (the scaled factors, A, k2, q_eff, the state) enter as two
// bf16 parts, the rounded value and what the rounding dropped (about 16
// bits), in three products (big x big, big x small, small x big); v is
// bf16 already and enters whole.  fp32: the same decomposition on the
// CUDA cores (products as fp32 sums), the same two launches.
//
// Bound: bytes.  At B = 1, H = 32, S = 1536 the function reads r, k, v
// (bf16), w (fp32), u and the initial state once and writes o and the
// final state: ~39 MB, 11.6 us at 3.35 TB/s.  Its operations are below
// that: its exponentials are at least one per token and channel (every
// decay factor is a product of exp(w_t)), 3.1e6 on the SFUs (16 a clock
// per SM, 132 SMs, ~1.98 GHz: 0.8 us), and its products at least the
// state read-out and update, 4 dk dv a token, 0.81 GFLOP (0.8 us at the
// tensor cores' 989 TFLOP/s).  chip_smoke.py's k6_bound counts this.  The
// scratch this design writes (~38 MB at that shape) and reads back (~75
// MB: q_eff once per slice), much of it through the 50 MB L2, is its
// price for filling the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

using tc::bf16;

constexpr int kD = 64;          // dk = dv
constexpr int kP = kD + 4;      // fp32 shared row stride of (a): rows
                                // 16-byte aligned for float4 reads
constexpr int kSub = 16;        // secondary chunk
constexpr int kThreads = 512;   // (a): 16 warps
constexpr int kColGroups = kThreads / 32 / 4;  // (a): 4 row tiles x these
constexpr int kGroupCols = kD / kColGroups;    // columns of a group
constexpr int kScanThreads = 256;  // (b): 8 warps, 4 row tiles x 2
constexpr int kSlice = 16;      // (b): state columns per block
constexpr int kSlices = kD / kSlice;
// (b)'s stage row strides (floats), chosen for conflict-free fragment
// reads, and its ring of stages (chunks in flight)
constexpr int kQS = kD + 8, kOS = kSlice + 8, kSS = kSlice + 4;
constexpr int kStages = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// exp: the special-function unit's (ex2 of x log2 e) where the build's
// tolerance allows it (bf16), the accurate one otherwise
template <bool kFast>
__device__ __forceinline__ float ex(float x) {
  return kFast ? __expf(x) : expf(x);
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float x0,
                                              float x1) {
  dst[0] = x0;
  dst[1] = x1;
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;   // null: no bonus
  const float* s0;  // null: zero initial state
  void* o;
  float* s_out;
  float* q_eff;     // scratch (B, H, n_chunks, C, 64)
  float* o_intra;   // scratch (B, H, n_chunks, C, 64)
  float* dstate;    // scratch (B, H, n_chunks, 64, 64)
  float* decay;     // scratch (B, H, n_chunks, 64)
  float* states;    // (B, H, n_chunks, 64, 64): S entering each chunk, or null
  int B, S, H;
};

// (a)'s shared memory at chunk C: r, k (then k2), v, lcw, lcw_excl
// (C x kP each), A (C x (C + 1)), the diagonal (C), u (kD); fp32 also
// stages the k and r factors of the off-diagonal sub-blocks (16 x kP
// each), which the tensor cores take straight from the tiles (so two bf16
// blocks fit an SM)
template <typename T, int C>
struct Chunk {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int NS = C / kSub;                // sub-chunks
  static constexpr int NK = kTC ? 0 : NS - 1;        // staged k factors
  static constexpr int NPAIR = NS * (NS - 1) / 2;    // off-diagonal blocks
  static constexpr int NR = kTC ? 0 : NPAIR;         // staged r factors
  static constexpr int CP = C + 1;
  static constexpr size_t floats =
      5 * static_cast<size_t>(C) * kP + static_cast<size_t>(C) * CP +
      static_cast<size_t>(NK + NR) * kSub * kP + C + kD;
};

// off-diagonal block p -> (i, j), i > j: p = i (i - 1) / 2 + j
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int a = 1;
  while ((a + 1) * a / 2 <= p) ++a;
  *i = a;
  *j = p - a * (a - 1) / 2;
}

// An m16n8k16 A fragment (rows row0 + g / + 8, columns col0 + 2t..) of an
// fp32 matrix read through at(row, col), as two bf16 parts.
template <typename At>
__device__ __forceinline__ void frag_a(uint32_t (&big)[4],
                                       uint32_t (&small)[4], int row0,
                                       int col0, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int rr = row0 + g + 8 * (x & 1), cc = col0 + 2 * t + 8 * (x >> 1);
    tc::split_bf16(at(rr, cc), at(rr, cc + 1), big[x], small[x]);
  }
}

// c += A B with A and B each as two bf16 parts: three products (the
// small x small term is below the fp32 accumulate's rounding)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t b0,
                                     uint32_t b1, uint32_t s0, uint32_t s1) {
  tc::mma_bf16(c, ab, b0, b1);
  tc::mma_bf16(c, ab, s0, s1);
  tc::mma_bf16(c, as, b0, b1);
}

// (a): grid (n_chunks, H, B)
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
    linear_attn_chunk_kernel(Args p) {
  using L = Chunk<T, C>;
  constexpr bool kTC = L::kTC;
  constexpr int CP = L::CP;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  extern __shared__ float smem[];
  float* rs = smem;              // r
  float* ks = rs + C * kP;       // k, then k2 = k * exp(lcw[C-1] - lcw)
  float* vs = ks + C * kP;       // v
  float* ls = vs + C * kP;       // lcw (inclusive)
  float* xs = ls + C * kP;       // w, then lcw_excl = lcw - w
  float* as = xs + C * kP;       // A
  float* kt = as + C * CP;       // k factors: NK tiles of 16 rows
  float* rt = kt + L::NK * kSub * kP;  // r factors: NR tiles
  float* dg = rt + L::NR * kSub * kP;  // r[t] . (u * k[t])
  float* us = dg + C;            // u

  const T* r = static_cast<const T*>(p.r);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  // 16-byte loads, all of a thread's issued before its stores, so their
  // latencies overlap; rows at or past S read as zeros
  const int t0 = c * C;
  constexpr int kPer = 16 / sizeof(T);               // r, k, v: per load
  constexpr int kN = C * kD / kPer, kNw = C * kD / 4;
  constexpr int kU = (kN + kThreads - 1) / kThreads;
  constexpr int kUw = (kNw + kThreads - 1) / kThreads;
  auto row = [&](int t) {
    return ((static_cast<size_t>(b) * p.S + t0 + t) * p.H + h) * kD;
  };
  uint4 lr[kU], lk[kU], lv[kU];
  float4 lw[kUw];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = tid + u * kThreads, t = i / (kD / kPer);
    const int col = i % (kD / kPer) * kPer;
    lr[u] = lk[u] = lv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kN && t0 + t < p.S) {
      lr[u] = *reinterpret_cast<const uint4*>(r + row(t) + col);
      lk[u] = *reinterpret_cast<const uint4*>(k + row(t) + col);
      lv[u] = *reinterpret_cast<const uint4*>(v + row(t) + col);
    }
  }
#pragma unroll
  for (int u = 0; u < kUw; ++u) {
    const int i = tid + u * kThreads, t = i / (kD / 4);
    lw[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < kNw && t0 + t < p.S)
      lw[u] = *reinterpret_cast<const float4*>(p.w + row(t) + i % (kD / 4) * 4);
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = tid + u * kThreads, t = i / (kD / kPer);
    const int col = i % (kD / kPer) * kPer;
    if (i >= kN) break;
    const T* er = reinterpret_cast<const T*>(&lr[u]);
    const T* ek = reinterpret_cast<const T*>(&lk[u]);
    const T* ev = reinterpret_cast<const T*>(&lv[u]);
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      rs[t * kP + col + x] = to_f32(er[x]);
      ks[t * kP + col + x] = to_f32(ek[x]);
      vs[t * kP + col + x] = to_f32(ev[x]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUw; ++u) {
    const int i = tid + u * kThreads, t = i / (kD / 4);
    const int col = i % (kD / 4) * 4;
    if (i >= kNw) break;
    xs[t * kP + col] = lw[u].x;
    xs[t * kP + col + 1] = lw[u].y;
    xs[t * kP + col + 2] = lw[u].z;
    xs[t * kP + col + 3] = lw[u].w;
  }
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  __syncthreads();

  // cumulative log-decay, one thread per column; the u-bonus diagonal on
  // the next C threads meanwhile
  if (tid < kD) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = xs[t * kP + tid];
      acc += wv;
      ls[t * kP + tid] = acc;
      xs[t * kP + tid] = acc - wv;
    }
  } else if (tid < kD + C) {
    const int t = tid - kD;
    float s = 0.f;
    if (p.u)
      for (int d = 0; d < kD; ++d)
        s += rs[t * kP + d] * us[d] * ks[t * kP + d];
    dg[t] = s;
  }
  __syncthreads();
  auto excl = [&](int t, int d) { return xs[t * kP + d]; };

  // the diagonal sub-blocks pairwise: pair q of a sub-chunk -> (tt, ss),
  // tt (tt - 1) / 2 <= q < tt (tt + 1) / 2, ss = q - tt (tt - 1) / 2
  constexpr int kSubPairs = kSub * (kSub - 1) / 2;
  for (int pi = tid; pi < L::NS * kSubPairs; pi += kThreads) {
    const int sb = pi / kSubPairs, q = pi % kSubPairs;
    int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    while (tt * (tt - 1) / 2 > q) --tt;
    while (tt * (tt + 1) / 2 <= q) ++tt;
    const int t = sb * kSub + tt, s = sb * kSub + q - tt * (tt - 1) / 2;
    // four channels a read: one 16-byte load of each operand row
    const float4* r4 = reinterpret_cast<const float4*>(rs + t * kP);
    const float4* x4 = reinterpret_cast<const float4*>(xs + t * kP);
    const float4* k4 = reinterpret_cast<const float4*>(ks + s * kP);
    const float4* l4 = reinterpret_cast<const float4*>(ls + s * kP);
    float a = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      const float4 rv = r4[d4], xv = x4[d4], kv = k4[d4], lv = l4[d4];
      a += rv.x * kv.x * ex<kTC>(fminf(xv.x - lv.x, 0.f));
      a += rv.y * kv.y * ex<kTC>(fminf(xv.y - lv.y, 0.f));
      a += rv.z * kv.z * ex<kTC>(fminf(xv.z - lv.z, 0.f));
      a += rv.w * kv.w * ex<kTC>(fminf(xv.w - lv.w, 0.f));
    }
    as[t * CP + s] = a;
  }
  // zeros on and above the diagonal (A v runs over whole tiles)
  for (int i = tid; i < C * C; i += kThreads) {
    const int t = i / C, s = i % C;
    if (s >= t) as[t * CP + s] = 0.f;
  }
  // fp32: the factors of the off-diagonal blocks staged, against L = lcw
  // at the end of sub-chunk j: k[s] exp(L - lcw[s]) for s in j,
  // r[t] exp(lcw_excl[t] - L) for t in i > j; both at most 1 (the min
  // absorbs rounding).  bf16 computes them into its fragments below.
  for (int i = tid; i < L::NK * kSub * kD; i += kThreads) {
    const int j = i / (kSub * kD), s = j * kSub + (i / kD) % kSub,
              d = i % kD;
    const float ref = ls[(j * kSub + kSub - 1) * kP + d];
    kt[(i / kD) * kP + d] =
        ks[s * kP + d] * ex<kTC>(fminf(ref - ls[s * kP + d], 0.f));
  }
  for (int i = tid; i < L::NR * kSub * kD; i += kThreads) {
    const int pr = i / (kSub * kD), tt = (i / kD) % kSub, d = i % kD;
    int bi, bj;
    pair_of(pr, &bi, &bj);
    const int t = bi * kSub + tt;
    const float ref = ls[(bj * kSub + kSub - 1) * kP + d];
    rt[(i / kD) * kP + d] =
        rs[t * kP + d] * ex<kTC>(fminf(excl(t, d) - ref, 0.f));
  }
  __syncthreads();

  // the off-diagonal blocks; meanwhile q_eff and the decay
  if constexpr (kTC) {
    // warp p: block p's factors computed into its fragments, straight
    // from the tiles
    if (warp < L::NPAIR) {
      int bi, bj;
      pair_of(warp, &bi, &bj);
      const float* ref = ls + (bj * kSub + kSub - 1) * kP;  // L
      float acc[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        uint32_t ab[4], asm_[4];
        frag_a(ab, asm_, bi * kSub, kc * 16, [&](int t, int d) {
          return rs[t * kP + d] * ex<true>(fminf(excl(t, d) - ref[d], 0.f));
        });
        auto kf = [&](int s, int d) {
          return ks[s * kP + d] *
                 ex<true>(fminf(ref[d] - ls[s * kP + d], 0.f));
        };
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s = bj * kSub + nt * 8 + g, d = kc * 16 + 2 * t4;
          uint32_t b0, b1, s0, s1;
          tc::split_bf16(kf(s, d), kf(s, d + 1), b0, s0);
          tc::split_bf16(kf(s, d + 8), kf(s, d + 9), b1, s1);
          mma3(acc[nt], ab, asm_, b0, b1, s0, s1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          as[(bi * kSub + g + 8 * (e >> 1)) * CP + bj * kSub + nt * 8 +
             2 * t4 + (e & 1)] = acc[nt][e];
    }
  } else {
    for (int i = tid; i < L::NPAIR * kSub * kSub; i += kThreads) {
      const int pr = i / (kSub * kSub), tt = (i / kSub) % kSub,
                ss = i % kSub;
      int bi, bj;
      pair_of(pr, &bi, &bj);
      const float* rr = rt + (pr * kSub + tt) * kP;
      const float* kr = kt + (bj * kSub + ss) * kP;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) a += rr[d] * kr[d];
      as[(bi * kSub + tt) * CP + bj * kSub + ss] = a;
    }
  }
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  float* qe = p.q_eff + bhc * C * kD;
  for (int i = tid; i < C * kD; i += kThreads)
    qe[i] = rs[(i / kD) * kP + i % kD] * ex<kTC>(excl(i / kD, i % kD));
  if (tid < kD) p.decay[bhc * kD + tid] = expf(ls[(C - 1) * kP + tid]);
  __syncthreads();
  // k2 in place: the off-diagonal blocks have read k
  for (int i = tid; i < C * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    ks[t * kP + d] *= ex<kTC>(ls[(C - 1) * kP + d] - ls[t * kP + d]);
  }
  __syncthreads();

  // o_intra = A v + diag v (rows t, columns e) and dS = k2^T v (rows d)
  float* oi = p.o_intra + bhc * C * kD;
  float* ds = p.dstate + bhc * kD * kD;
  if constexpr (kTC) {
    const int mt = warp % 4, ng = warp / 4;  // row tile, column group
    constexpr int NT = kGroupCols / 8;
    // v as the B operand (k = s, n = e): bf16 already, exact
    auto frag_v = [&](int s0, int e, uint32_t& b0, uint32_t& b1) {
      b0 = tc::pack_bf16(vs[s0 * kP + e], vs[(s0 + 1) * kP + e]);
      b1 = tc::pack_bf16(vs[(s0 + 8) * kP + e], vs[(s0 + 9) * kP + e]);
    };
    if (mt < C / 16) {
      float acc[NT][4] = {};
      for (int kc = 0; kc <= mt; ++kc) {  // s < t: tiles on or below
        uint32_t ab[4], asm_[4];
        frag_a(ab, asm_, mt * 16, kc * 16,
               [&](int rr, int cc) { return as[rr * CP + cc]; });
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          frag_v(kc * 16 + 2 * t4, ng * kGroupCols + n * 8 + g, b0, b1);
          tc::mma_bf16(acc[n], ab, b0, b1);
          tc::mma_bf16(acc[n], asm_, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = mt * 16 + g + 8 * (e >> 1);
          const int col = ng * kGroupCols + n * 8 + 2 * t4 + (e & 1);
          oi[t * kD + col] = acc[n][e] + dg[t] * vs[t * kP + col];
        }
    }
    float acc[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t ab[4], asm_[4];
      frag_a(ab, asm_, mt * 16, kc * 16,
             [&](int rr, int cc) { return ks[cc * kP + rr]; });  // k2^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_v(kc * 16 + 2 * t4, ng * kGroupCols + n * 8 + g, b0, b1);
        tc::mma_bf16(acc[n], ab, b0, b1);
        tc::mma_bf16(acc[n], asm_, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[(mt * 16 + g + 8 * (e >> 1)) * kD + ng * kGroupCols + n * 8 +
           2 * t4 + (e & 1)] = acc[n][e];
  } else {
    for (int i = tid; i < C * kD; i += kThreads) {
      const int t = i / kD, e = i % kD;
      float acc = 0.f;
      for (int s = 0; s < t; ++s) acc += as[t * CP + s] * vs[s * kP + e];
      oi[i] = acc + dg[t] * vs[t * kP + e];
    }
    for (int i = tid; i < kD * kD; i += kThreads) {
      const int d = i / kD, e = i % kD;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < C; ++s) acc += ks[s * kP + d] * vs[s * kP + e];
      ds[i] = acc;
    }
  }
}

// (b)'s stage of one chunk: q_eff (C x kQS), the slice of o_intra
// (C x kOS) and of dS (64 x kSS), the decay (64)
template <int C>
__host__ __device__ constexpr size_t stage_floats() {
  return static_cast<size_t>(C) * (kQS + kOS) + kD * kSS + kD;
}

// (b): grid (kSlices, H, B); eight warps, warp w owns chunk rows
// 16 (w % 4) .. + 15 and state columns kSlice / 2 (w / 4) .. of the slice
// S[:, e0:e0+kSlice].
template <typename T, int C>
__global__ void __launch_bounds__(kScanThreads)
    linear_attn_scan_kernel(Args p) {
  constexpr bool kTC = std::is_same<T, bf16>::value;
  constexpr int kStage = stage_floats<C>();
  const int e0 = blockIdx.x * kSlice, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (p.S + C - 1) / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(16) float stage[];  // the ring, then fp32 S
  float* sst = stage + kStages * kStage;          // fp32: S slice 64 x 17
  const size_t bh = static_cast<size_t>(b) * p.H + h;

  auto issue = [&](int c) {  // one commit group, empty past the last chunk
    if (c >= n_chunks) {
      tc::cp_async_commit();
      return;
    }
    float* st = stage + (c % kStages) * kStage;
    const size_t bhc = bh * n_chunks + c;
    const float* qe = p.q_eff + bhc * C * kD;
    const float* oi = p.o_intra + bhc * C * kD + e0;
    const float* ds = p.dstate + bhc * kD * kD + e0;
    for (int i = tid; i < C * (kD / 4); i += kScanThreads) {
      const int t = i / (kD / 4), ch = i % (kD / 4);
      tc::cp_async16(st + t * kQS + ch * 4, qe + t * kD + ch * 4, true);
    }
    float* os = st + C * kQS;
    for (int i = tid; i < C * (kSlice / 4); i += kScanThreads) {
      const int t = i / (kSlice / 4), ch = i % (kSlice / 4);
      tc::cp_async16(os + t * kOS + ch * 4, oi + t * kD + ch * 4, true);
    }
    float* dss = os + C * kOS;
    for (int i = tid; i < kD * (kSlice / 4); i += kScanThreads) {
      const int d = i / (kSlice / 4), ch = i % (kSlice / 4);
      tc::cp_async16(dss + d * kSS + ch * 4, ds + d * kD + ch * 4, true);
    }
    float* dc = dss + kD * kSS;
    for (int i = tid; i < kD / 4; i += kScanThreads)
      tc::cp_async16(dc + i * 4, p.decay + bhc * kD + i * 4, true);
    tc::cp_async_commit();
  };

  // the state: tensor cores keep it in registers as B fragments of the
  // warp's NW column tiles of 8 (the warps of a column group hold the same
  // copy); fp32 keeps it in shared memory.  st[kc][n][x] holds
  // S[kc*16 + 2t + (x & 1) + 8 (x >> 1)][(cg*NW + n)*8 + g]
  constexpr int NW = kSlice / 16;  // column tiles of a warp
  const int mt = warp % 4, cg = warp / 4;
  float st[kD / 16][NW][4];
  auto st_d = [&](int kc, int x) {
    return kc * 16 + 2 * t4 + (x & 1) + 8 * (x >> 1);
  };
  const float* s0 = p.s0 ? p.s0 + bh * kD * kD + e0 : nullptr;
  if constexpr (kTC) {
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          st[kc][n][x] =
              s0 ? s0[st_d(kc, x) * kD + (cg * NW + n) * 8 + g] : 0.f;
  } else {
    for (int i = tid; i < kD * kSlice; i += kScanThreads)
      sst[(i / kSlice) * (kSlice + 1) + i % kSlice] =
          s0 ? s0[(i / kSlice) * kD + i % kSlice] : 0.f;
  }

  T* o = static_cast<T*>(p.o);
  const bool live = mt * 16 < C;
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    tc::cp_async_wait<kStages - 2>();  // chunk c has landed
    // one barrier a chunk: chunk c is visible, and every thread is done
    // with chunk c - 1, whose stage the next issue overwrites
    __syncthreads();
    issue(c + kStages - 1);
    const float* qs = stage + (c % kStages) * kStage;
    const float* os = qs + C * kQS;
    const float* dss = os + C * kOS;
    const float* dc = dss + kD * kSS;
    const int t0 = c * C;
    if constexpr (kTC) {
      if (live) {
        // o = o_intra + q_eff S over the warp's 16 rows and NW x 8
        // columns: the three products in accumulators of their own
        float acc[3][NW][4] = {};
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) {
          uint32_t ab[4], asm_[4];
          frag_a(ab, asm_, mt * 16, kc * 16,
                 [&](int rr, int cc) { return qs[rr * kQS + cc]; });
#pragma unroll
          for (int n = 0; n < NW; ++n) {
            uint32_t b0, b1, s0_, s1_;
            tc::split_bf16(st[kc][n][0], st[kc][n][1], b0, s0_);
            tc::split_bf16(st[kc][n][2], st[kc][n][3], b1, s1_);
            tc::mma_bf16(acc[0][n], ab, b0, b1);
            tc::mma_bf16(acc[1][n], ab, s0_, s1_);
            tc::mma_bf16(acc[2][n], asm_, b0, b1);
          }
        }
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = mt * 16 + g + 8 * hh;
            const int col = (cg * NW + n) * 8 + 2 * t4;
            auto sum = [&](int e) {
              return acc[0][n][e] + acc[1][n][e] + acc[2][n][e];
            };
            if (t0 + t < p.S)
              store2<T>(o + ((static_cast<size_t>(b) * p.S + t0 + t) * p.H +
                             h) * kD + e0 + col,
                        sum(2 * hh) + os[t * kOS + col],
                        sum(2 * hh + 1) + os[t * kOS + col + 1]);
          }
        if (p.states != nullptr && mt == 0) {  // one warp a column group
          float* sv = p.states + (bh * n_chunks + c) * kD * kD + e0;
#pragma unroll
          for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
            for (int n = 0; n < NW; ++n)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                sv[st_d(kc, x) * kD + (cg * NW + n) * 8 + g] = st[kc][n][x];
        }
        // S <- decay * S + dS
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
          for (int n = 0; n < NW; ++n)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int d = st_d(kc, x);
              st[kc][n][x] = st[kc][n][x] * dc[d] +
                             dss[d * kSS + (cg * NW + n) * 8 + g];
            }
      }
    } else {
      const int e = tid % kSlice, rg = tid / kSlice;
      for (int t = rg; t < C; t += kScanThreads / kSlice) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < kD; ++d)
          acc += qs[t * kQS + d] * sst[d * (kSlice + 1) + e];
        if (t0 + t < p.S)
          o[((static_cast<size_t>(b) * p.S + t0 + t) * p.H + h) * kD + e0 +
            e] = acc + os[t * kOS + e];
      }
      __syncthreads();
      for (int d = rg; d < kD; d += kScanThreads / kSlice) {
        float* cell = sst + d * (kSlice + 1) + e;
        if (p.states != nullptr)
          p.states[((bh * n_chunks + c) * kD + d) * kD + e0 + e] = *cell;
        *cell = *cell * dc[d] + dss[d * kSS + e];
      }
    }
  }

  float* so = p.s_out + bh * kD * kD + e0;
  if constexpr (kTC) {
    if (mt == 0) {  // one warp of each column group
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            so[st_d(kc, x) * kD + (cg * NW + n) * 8 + g] = st[kc][n][x];
    }
  } else {
    for (int i = tid; i < kD * kSlice; i += kScanThreads)
      so[(i / kSlice) * kD + i % kSlice] =
          sst[(i / kSlice) * (kSlice + 1) + i % kSlice];
  }
}

template <typename T, int C>
int launch(const Args& a, cudaStream_t stream) {
  const int n_chunks = (a.S + C - 1) / C;
  const size_t smem = Chunk<T, C>::floats * sizeof(float);
  auto chunk = linear_attn_chunk_kernel<T, C>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk<<<dim3(n_chunks, a.H, a.B), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t scan_smem =
      (kStages * stage_floats<C>() + kD * (kSlice + 1)) * sizeof(float);
  auto scan = linear_attn_scan_kernel<T, C>;
  if (scan_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan<<<dim3(kSlices, a.H, a.B), kScanThreads, scan_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk(const Args& a, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of r, k, v and o: 0 float32, 1 bfloat16.  u and s0 may be null.
// q_eff, o_intra, dstate, decay: the wrapper's fp32 scratch (see the
// header) for ceil(S / chunk) chunks; states: where the scan writes the
// state entering each chunk, or null.  Returns the CUDA error code of the
// two launches (0 on success); the wrapper raises on anything else.
extern "C" int linear_attn_chunk(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_out, void* q_eff,
                                 void* o_intra, void* dstate, void* decay,
                                 void* states, int B, int S, int H,
                                 int chunk, int dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
         static_cast<const float*>(s0), o, static_cast<float*>(s_out),
         static_cast<float*>(q_eff), static_cast<float*>(o_intra),
         static_cast<float*>(dstate), static_cast<float*>(decay),
         static_cast<float*>(states), B, S, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunk<float>(a, chunk, s);
    case 1: return launch_chunk<bf16>(a, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
