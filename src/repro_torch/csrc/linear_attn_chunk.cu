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
//      C = 64 a chunk takes 51,264 exponentials (30,720 of them in the
//      diagonal blocks; the tensor cores take the off-diagonal factors
//      straight from the tiles, unstaged, so that two blocks fit an SM)
//      where the first design's all-pairs form took 137,280.
//  (b) linear_attn_scan_kernel, one block per (slice of 16 state columns,
//      h, b): 128 blocks at B = 1, H = 32.  It carries its 64 x 16 slice
//      of the fp32 state through the chunks in order: o = o_intra +
//      q_eff S, then S <- decay * S + dS, and writes the final state.  A
//      chunk's operands come in through cp.async, a ring of three stages:
//      the next two chunks' load while this one computes.  The state
//      slice stays in registers as the products' B fragments.
// Every product (the off-diagonal sub-blocks, A v, dS and q_eff S) runs on
// the tensor cores with fp32 accumulation; the diagonal blocks stay
// pairwise on the CUDA cores.
//  bf16 (r, k, v in bf16): mma.sync.m16n8k16.  The fp32 operands (the
//      scaled factors, A, k2, q_eff, the state) enter as two bf16 parts,
//      the rounded value and what the rounding dropped (about 16 bits), in
//      three products (big x big, big x small, small x big); v is bf16
//      already and enters whole.  Exponentials on the SFUs (__expf).
//  fp32: mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh): every operand, r, k
//      and v too, enters as a TF32 high part and the TF32 of its residual,
//      in three products (lo hi, hi lo, hi hi).  A sum over the channels
//      keeps the small products and hi hi in accumulators of their own; a
//      sum over positions takes fresh ones every 16 and adds them in fp32
//      (the tensor cores accumulate without IEEE rounding: a long chain
//      drifts).  The accurate expf.  Where a product's k axis is a row
//      index of a tile (A v, dS) it is permuted (slot t takes 2t, slot
//      t + 4 takes 2t + 1), so that the fragments' loads fall on distinct
//      banks.  The same grid, warps and two blocks an SM as bf16 ((a):
//      106 KB of shared memory at C = 64).
//
// Bound: bytes.  At B = 1, H = 32, S = 1536 the function reads r, k, v
// (bf16), w (fp32), u and the initial state once and writes o and the
// final state: ~39 MB, 11.6 us at 3.35 TB/s.  Its operations are below
// that: its exponentials are at least one per token and channel (every
// decay factor is a product of exp(w_t)), 3.1e6 on the SFUs (16 a clock
// per SM, 132 SMs, ~1.98 GHz: 0.8 us), and its products at least the
// state read-out and update, 4 dk dv a token, 0.81 GFLOP (0.8 us at the
// tensor cores' 989 TFLOP/s).  chip_smoke.py's k6_bound counts this.  In
// fp32 the bytes double (r, k, v and o in fp32: 19.1 us at S = 1536) and
// stay the bound: op_cost.k6_charge's least fp32 operations at the CUDA
// cores' 67 TFLOP/s fall below them, and the kernel's own products, three
// TF32 passes, are the bf16 build's work at half its peak rate.  The
// scratch this design writes (~38 MB at that shape) and reads back (~75
// MB: q_eff once per slice), much of it through the 50 MB L2, is its
// price for filling the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using tc::bf16;

constexpr int kD = 64;          // dk = dv
constexpr int kP = kD + 4;      // fp32 shared row stride of (a): rows
                                // 16-byte aligned for float4 reads, and
                                // 4 mod 32 (tf32_mma.cuh's kPad)
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
// (C x kP each), A (C x CP), the diagonal (C), u (kD), in fp32 in both
// builds; the tensor cores take the off-diagonal blocks' factors straight
// from the tiles, unstaged, so that two blocks fit an SM (104 KB in bf16,
// 106 KB in fp32 at C = 64).  A's row stride: C + 1 in bf16; C + 8 in
// fp32, so that a permuted A fragment's 8-byte loads (rows g, columns 2t
// and 2t + 1) fall on distinct banks
template <typename T, int C>
struct Chunk {
  static constexpr bool kBF = std::is_same<T, bf16>::value;
  static constexpr int NS = C / kSub;                // sub-chunks
  static constexpr int NPAIR = NS * (NS - 1) / 2;    // off-diagonal blocks
  static constexpr int CP = kBF ? C + 1 : C + tf::kPadP;
  static constexpr size_t floats = 5 * static_cast<size_t>(C) * kP +
                                   static_cast<size_t>(C) * CP + C + kD;
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
  constexpr bool kBF = L::kBF;
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
  float* dg = as + C * CP;       // r[t] . (u * k[t])
  float* us = dg + C;            // u

  const T* r = static_cast<const T*>(p.r);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int t0 = c * C;
  auto row = [&](int t) {
    return ((static_cast<size_t>(b) * p.S + t0 + t) * p.H + h) * kD;
  };
  if constexpr (kBF) {
    // 16-byte loads, all of a thread's issued before its stores, so their
    // latencies overlap; rows at or past S read as zeros
    constexpr int kPer = 16 / sizeof(T);               // r, k, v: per load
    constexpr int kN = C * kD / kPer, kNw = C * kD / 4;
    constexpr int kU = (kN + kThreads - 1) / kThreads;
    constexpr int kUw = (kNw + kThreads - 1) / kThreads;
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
        lw[u] = *reinterpret_cast<const float4*>(p.w + row(t) +
                                                 i % (kD / 4) * 4);
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
  } else {
    // fp32: straight into the tiles through cp.async, 16 bytes a thread,
    // rows at or past S zero-filled without a read
    auto load = [&](float* dst, const float* src) {
      for (int i = tid; i < C * (kD / 4); i += kThreads) {
        const int t = i / (kD / 4), ch = i % (kD / 4);
        const bool in = t0 + t < p.S;
        tc::cp_async16(dst + t * kP + ch * 4, in ? src + row(t) + ch * 4 : src,
                       in);
      }
    };
    load(rs, r);
    load(ks, k);
    load(vs, v);
    load(xs, p.w);
    tc::cp_async_commit();
  }
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  if constexpr (!kBF) tc::cp_async_wait<0>();
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
      a += rv.x * kv.x * ex<kBF>(fminf(xv.x - lv.x, 0.f));
      a += rv.y * kv.y * ex<kBF>(fminf(xv.y - lv.y, 0.f));
      a += rv.z * kv.z * ex<kBF>(fminf(xv.z - lv.z, 0.f));
      a += rv.w * kv.w * ex<kBF>(fminf(xv.w - lv.w, 0.f));
    }
    as[t * CP + s] = a;
  }
  // zeros on and above the diagonal (A v runs over whole tiles)
  for (int i = tid; i < C * C; i += kThreads) {
    const int t = i / C, s = i % C;
    if (s >= t) as[t * CP + s] = 0.f;
  }
  __syncthreads();

  // the off-diagonal blocks, against L = lcw at the end of sub-chunk j:
  // k[s] exp(L - lcw[s]) for s in j, r[t] exp(lcw_excl[t] - L) for t in
  // i > j, both at most 1 (the min absorbs rounding); meanwhile q_eff and
  // the decay
  if constexpr (kBF) {
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
    // fp32, warp p: block p in 3xTF32, the factors computed into the
    // fragments (k the channel, not permuted); the sum over the channels
    // in two accumulators, the small products and hi hi
    if (warp < L::NPAIR) {
      int bi, bj;
      pair_of(warp, &bi, &bj);
      const float* ref = ls + (bj * kSub + kSub - 1) * kP;  // L
      float small[2][4] = {}, big[2][4] = {};
#pragma unroll 2
      for (int d0 = 0; d0 < kD; d0 += 8) {
        tf::FragA fa;
        tf::frag_a<false>(fa, [&](int i, int j) {
          const int t = bi * kSub + i, d = d0 + j;
          return rs[t * kP + d] * ex<false>(fminf(excl(t, d) - ref[d], 0.f));
        });
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          tf::FragB fb;  // B[d][s] = k[s][d] exp(L - lcw[s])
          tf::frag_b<false>(fb, [&](int j, int n) {
            const int s = bj * kSub + nt * 8 + n, d = d0 + j;
            return ks[s * kP + d] *
                   ex<false>(fminf(ref[d] - ls[s * kP + d], 0.f));
          });
          tf::mma3(small[nt], big[nt], fa, fb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          as[(bi * kSub + g + 8 * (e >> 1)) * CP + bj * kSub + nt * 8 +
             2 * t4 + (e & 1)] = big[nt][e] + small[nt][e];
    }
  }
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  float* qe = p.q_eff + bhc * C * kD;
  for (int i = tid; i < C * kD; i += kThreads)
    qe[i] = rs[(i / kD) * kP + i % kD] * ex<kBF>(excl(i / kD, i % kD));
  if (tid < kD) p.decay[bhc * kD + tid] = expf(ls[(C - 1) * kP + tid]);
  __syncthreads();
  // k2 in place: the off-diagonal blocks have read k
  for (int i = tid; i < C * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    ks[t * kP + d] *= ex<kBF>(ls[(C - 1) * kP + d] - ls[t * kP + d]);
  }
  __syncthreads();

  // o_intra = A v + diag v (rows t, columns e) and dS = k2^T v (rows d)
  float* oi = p.o_intra + bhc * C * kD;
  float* ds = p.dstate + bhc * kD * kD;
  const int mt = warp % 4, ng = warp / 4;  // row tile, column group
  constexpr int NT = kGroupCols / 8;
  if constexpr (kBF) {
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
    // fp32, 3xTF32 with k = s permuted: v's rows 2t, 2t + 1 as B (stride
    // 4 mod 32: conflict-free), A's as one 8-byte load (stride 8 mod 32)
    // and k2^T's columns likewise; each 16 positions of s summed in fresh
    // accumulators, then added in fp32
    const float* vg = vs + ng * kGroupCols;  // the group's columns
    if (mt < C / 16) {
      float acc[NT][4] = {};
      for (int kc = 0; kc <= mt; ++kc) {  // s < t: tiles on or below
        float small[NT][4] = {}, big[NT][4] = {};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s0 = kc * 16 + hh * 8;
          tf::FragA fa;
          tf::load_a_perm<CP>(fa, as + mt * 16 * CP + s0, g, t4);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            tf::FragB fb;
            tf::load_b_perm<kP>(fb, vg + s0 * kP + n * 8, g, t4);
            tf::mma3(small[n], big[n], fa, fb);
          }
        }
        tf::add(acc, big, small);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = mt * 16 + g + 8 * hh;
          const int col = ng * kGroupCols + n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(oi + t * kD + col) =
              make_float2(acc[n][2 * hh] + dg[t] * vs[t * kP + col],
                          acc[n][2 * hh + 1] + dg[t] * vs[t * kP + col + 1]);
        }
    }
    float acc[NT][4] = {};
    // not unrolled: unrolled, it spills at C = 64 (64 registers a thread)
#pragma unroll 1
    for (int kc = 0; kc < C / 16; ++kc) {
      float small[NT][4] = {}, big[NT][4] = {};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s0 = kc * 16 + hh * 8;
        tf::FragA fa;  // A[d][s] = k2[s][d]
        tf::frag_a<true>(fa, [&](int i, int j) {
          return ks[(s0 + j) * kP + mt * 16 + i];
        });
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          tf::FragB fb;
          tf::load_b_perm<kP>(fb, vg + s0 * kP + n * 8, g, t4);
          tf::mma3(small[n], big[n], fa, fb);
        }
      }
      tf::add(acc, big, small);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            ds + (mt * 16 + g + 8 * hh) * kD + ng * kGroupCols + n * 8 +
            2 * t4) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
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
  constexpr bool kBF = std::is_same<T, bf16>::value;
  constexpr int kStage = stage_floats<C>();
  const int e0 = blockIdx.x * kSlice, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (p.S + C - 1) / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(16) float stage[];  // the ring
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

  // the state in registers, as B fragments of the warp's NW column tiles
  // of 8 (the warps of a column group hold the same copy).  bf16:
  // st[kc][n][x] holds S[kc*16 + 2t + (x & 1) + 8 (x >> 1)][(cg*NW + n)*8
  // + g] (m16n8k16); fp32: sf[kc][n][x] holds S[kc*8 + 2t + x][...]
  // (m16n8k8, k permuted: tf32_mma.cuh)
  constexpr int NW = kSlice / 16;  // column tiles of a warp
  const int mt = warp % 4, cg = warp / 4;
  float st[kD / 16][NW][4];
  float sf[kD / 8][NW][2];
  auto st_d = [&](int kc, int x) {
    return kc * 16 + 2 * t4 + (x & 1) + 8 * (x >> 1);
  };
  auto sf_d = [&](int kc, int x) { return kc * 8 + 2 * t4 + x; };
  const float* s0 = p.s0 ? p.s0 + bh * kD * kD + e0 : nullptr;
  if constexpr (kBF) {
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          st[kc][n][x] =
              s0 ? s0[st_d(kc, x) * kD + (cg * NW + n) * 8 + g] : 0.f;
  } else {
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          sf[kc][n][x] =
              s0 ? s0[sf_d(kc, x) * kD + (cg * NW + n) * 8 + g] : 0.f;
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
    if constexpr (kBF) {
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
    } else if (live) {
      // fp32: o = o_intra + q_eff S in 3xTF32 (q_eff's rows g, columns
      // 2t, 2t + 1 one 8-byte load, stride 8 mod 32); the sum over the
      // channels in fresh accumulators a chunk, hi hi in two (even and
      // odd steps)
      float small[NW][4] = {}, big[NW][4] = {}, big1[NW][4] = {};
#pragma unroll
      for (int kc = 0; kc < kD / 8; ++kc) {
        tf::FragA fa;
        tf::load_a_perm<kQS>(fa, qs + mt * 16 * kQS + kc * 8, g, t4);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          tf::FragB fb;
          tf::split(sf[kc][n][0], fb.hi[0], fb.lo[0]);
          tf::split(sf[kc][n][1], fb.hi[1], fb.lo[1]);
          tf::mma3(small[n], kc % 2 ? big1[n] : big[n], fa, fb);
        }
      }
      tf::add(big, big1);
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = mt * 16 + g + 8 * hh;
          const int col = (cg * NW + n) * 8 + 2 * t4;
          auto sum = [&](int e) { return big[n][e] + small[n][e]; };
          if (t0 + t < p.S)
            store2<T>(o + ((static_cast<size_t>(b) * p.S + t0 + t) * p.H +
                           h) * kD + e0 + col,
                      sum(2 * hh) + os[t * kOS + col],
                      sum(2 * hh + 1) + os[t * kOS + col + 1]);
        }
      if (p.states != nullptr && mt == 0) {  // one warp a column group
        float* sv = p.states + (bh * n_chunks + c) * kD * kD + e0;
#pragma unroll
        for (int kc = 0; kc < kD / 8; ++kc)
#pragma unroll
          for (int n = 0; n < NW; ++n)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              sv[sf_d(kc, x) * kD + (cg * NW + n) * 8 + g] = sf[kc][n][x];
      }
      // S <- decay * S + dS
#pragma unroll
      for (int kc = 0; kc < kD / 8; ++kc)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int d = sf_d(kc, x);
            sf[kc][n][x] = sf[kc][n][x] * dc[d] +
                           dss[d * kSS + (cg * NW + n) * 8 + g];
          }
    }
  }

  float* so = p.s_out + bh * kD * kD + e0;
  if (mt == 0) {  // one warp of each column group
    if constexpr (kBF) {
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            so[st_d(kc, x) * kD + (cg * NW + n) * 8 + g] = st[kc][n][x];
    } else {
#pragma unroll
      for (int kc = 0; kc < kD / 8; ++kc)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            so[sf_d(kc, x) * kD + (cg * NW + n) * 8 + g] = sf[kc][n][x];
    }
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
  const size_t scan_smem = kStages * stage_floats<C>() * sizeof(float);
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
