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
// dq, dk, dv as q, k, v; delta (B, Hq, S) fp32 scratch from the wrapper.
// bf16 builds: (DQK, DV) in (64, 64), (80, 80), (128, 128), (256, 256),
// (192, 128), the forward's; fp32 builds DQK = DV in {64, 128, 256} (the
// wrapper pads other widths, as for the forward).
//
// Design: three launches, no atomics: each gradient element is summed by
// one block in a fixed order, so two identical calls give the same bits.
//  (i)   flash_bwd_delta_kernel: one warp a row.
//  (ii)  flash_bwd_kv_kernel (bf16): one block of 8 warps per (64 keys, b,
//        kv head), walking the G query heads of the group and, for each,
//        the query tiles of 32 rows the causal and window masks admit to
//        the key tile (q and dO through a double-buffered cp.async ring).
//        Warps 0-3 and 4-7 own the same 16 keys each: the first four sum
//        dV += P^T dO, the other four dP^T = V dO^T, dS^T and dK += dS^T
//        Q, so that a warp's fp32 accumulator is one of the two, at the
//        price of computing S^T twice.  At (256, 256) each of the two is
//        split again into two column halves (32 keys a block, 2 warps a
//        role and half): 16 x 128 fp32, 64 registers a thread.  S^T, dP^T, dV and dK run on mma.sync.m16n8k16 (bf16
//        in, fp32 accumulate) with the forward's fragment layouts
//        (attention_mma.cuh): P^T and dS^T enter their products from the
//        registers as two bf16 parts each (the value rounded, then what
//        the rounding dropped), ~16 bits, at twice those products.
//  (iii) flash_bwd_q_kernel (bf16): one block of 4 warps per (64 query
//        rows, b, query head), as the forward's, over the admitted key
//        tiles (32 keys at DQK > 128, else 64; K and V double-buffered):
//        S, P, dP = dO V^T, dS, dQ += dS K on the tensor cores, dS again
//        in two bf16 parts.  At DQK = 256, 8 warps, each row group's two
//        warps summing one column half of dQ (S and dP computed by both).
//  fp32: the same three launches on the CUDA cores, tiles of 16 keys and
//        16 queries in shared memory.
// The admit mask is evaluated per element on every tile (the forward
// skips it inside the masks; a later speed PR may do the same).
//
// Bound: operations at the prompt lengths training runs (S = 512-4096):
// 2 (3 DQK + 2 DV) flops per admitted (query head, query, key) pair (the
// scores recomputed, dP, dV, dK and dQ), against q, k, v, o, dO, lse read
// and dq, dk, dv written once.  This first design recomputes S^T once more
// in the dK/dV kernel and splits P and dS (about 1.9x the least products),
// and uses mma.sync, not wgmma or TMA: later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using tc::bf16;

constexpr int kQStep = 32;        // bf16 dK/dV: query rows a step
constexpr int kKVThreads = 256;   // bf16 dK/dV: 8 warps
constexpr int kQRows = 64;        // bf16 dQ: query rows a block (4 x 16)
constexpr int kQThreads = 128;    // bf16 dQ: 4 warps a column part

// the output column parts a bf16 warp sums: two at DQK = 256, whose fp32
// accumulators would not fit the registers whole
template <int DQK>
__host__ __device__ constexpr int col_parts() {
  return DQK >= 256 ? 2 : 1;
}
// bf16 dK/dV: keys a block, 16 for each of the 4 / col_parts warps of a
// role and part
template <int DQK>
__host__ __device__ constexpr int kv_keys() {
  return 64 / col_parts<DQK>();
}
constexpr int kT = 16;            // fp32: keys or queries a tile
constexpr int kF32Threads = 256;  // fp32: one thread a (query, key) pair

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
  int B, S, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// whether key kj is admitted by query qi (both below S)
__device__ __forceinline__ bool admit(const Args& p, int qi, int kj) {
  const int dq = qi - kj;
  return qi < p.S && kj < p.S && (p.causal == 0 || dq >= 0) &&
         (p.window <= 0 || dq < p.window);
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

// (i): one warp a row of the model layout, (b * S + i) * Hq + h
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(Args p,
                                                              int DV) {
  const int row = (blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.B * p.S * p.Hq) return;
  const T* o = static_cast<const T*>(p.o) + static_cast<size_t>(row) * DV;
  const T* d = static_cast<const T*>(p.dout) + static_cast<size_t>(row) * DV;
  float s = 0.f;
  for (int e = lane; e < DV; e += 32) s += to_f32(o[e]) * to_f32(d[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % p.Hq, i = row / p.Hq % p.S, b = row / (p.Hq * p.S);
    p.delta[(static_cast<size_t>(b) * p.Hq + h) * p.S + i] = s;
  }
}

// the A fragments of k-step kc from a warp's fp32 C fragments x[2kc],
// x[2kc + 1], as two bf16 parts (value, rounding residue)
template <int N>
__device__ __forceinline__ void split_a(const float (&x)[N][4], int kc,
                                        uint32_t (&a)[4], uint32_t (&lo)[4]) {
  tc::split_bf16(x[2 * kc][0], x[2 * kc][1], a[0], lo[0]);
  tc::split_bf16(x[2 * kc][2], x[2 * kc][3], a[1], lo[1]);
  tc::split_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1], a[2], lo[2]);
  tc::split_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3], a[3], lo[3]);
}

// c[n], c[n + 1] += (a + lo) B for the two 8-column B tiles of b
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[4]) {
  tc::mma_bf16(c0, a, b[0], b[1]);
  tc::mma_bf16(c1, a, b[2], b[3]);
  tc::mma_bf16(c0, lo, b[0], b[1]);
  tc::mma_bf16(c1, lo, b[2], b[3]);
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

template <int DQK, int DV>
__host__ __device__ constexpr size_t kv_smem_bytes() {
  return sizeof(bf16) * (static_cast<size_t>(kv_keys<DQK>() + 2 * kQStep) *
                         (DQK + DV + 2 * tc::kPad)) +
         sizeof(float) * 4 * kQStep;
}

// (ii) bf16: grid (ceil(S / kv_keys), B * Hkv)
template <int DQK, int DV>
__global__ void __launch_bounds__(kKVThreads, 1) flash_bwd_kv_kernel(Args p) {
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  constexpr int NP = col_parts<DQK>(), kKeys = kv_keys<DQK>();
  constexpr int NG = 4 / NP;                      // key groups of 16
  constexpr int NO = (DQK > DV ? DQK : DV) / 8 / NP;  // accumulator tiles
  constexpr int NV = DV / 8 / NP, NK = DQK / 8 / NP;  // of dV, of dK
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeys * QS;
  bf16* qs = vs + kKeys * VS;         // ring of two query steps
  bf16* dos = qs + 2 * kQStep * QS;   // ring of two
  float* ls = reinterpret_cast<float*>(dos + 2 * kQStep * VS);  // lse log2 e
  float* dl = ls + 2 * kQStep;        // delta

  const int G = p.Hq / p.Hkv;
  const int k0 = blockIdx.x * kKeys;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw = warp % NG;         // the warp's keys: k0 + 16 kw ..
  const bool dk_warp = warp / NG % 2 == 1;  // dV, or dP, dS and dK
  const int part = warp / (2 * NG);  // its column part of dV or dK
  const int g4 = lane / 4, t4 = lane % 4;
  const Lanes ln(lane);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
  };
  auto q_row = [&](int i, int hq) {
    return (static_cast<size_t>(b) * p.S + i) * p.Hq + hq;
  };
  // keys past S are zero-filled (and never admitted)
  tc::load_rows<DQK, kKeys, kKVThreads>(ks, tid, k, [&](int r) -> const bf16* {
    return k0 + r < p.S ? k + kv_row(k0 + r) * DQK : nullptr;
  });
  tc::load_rows<DV, kKeys, kKVThreads>(vs, tid, v, [&](int r) -> const bf16* {
    return k0 + r < p.S ? v + kv_row(k0 + r) * DV : nullptr;
  });
  tc::cp_async_commit();

  int q_begin, q_end;
  query_range(p, k0, kKeys, kQStep, &q_begin, &q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kQStep - 1) / kQStep
                                   : 0;
  const int steps = G * n_qt;       // (query head, query tile) pairs
  auto issue = [&](int it) {
    const int sg = it & 1, hq = hk * G + it / n_qt;
    const int q0 = q_begin + it % n_qt * kQStep;
    tc::load_rows<DQK, kQStep, kKVThreads>(
        qs + sg * kQStep * QS, tid, q, [&](int r) -> const bf16* {
          return q0 + r < p.S ? q + q_row(q0 + r, hq) * DQK : nullptr;
        });
    tc::load_rows<DV, kQStep, kKVThreads>(
        dos + sg * kQStep * VS, tid, dout, [&](int r) -> const bf16* {
          return q0 + r < p.S ? dout + q_row(q0 + r, hq) * DV : nullptr;
        });
    if (tid < kQStep) {
      const int i = q0 + tid;
      const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + i;
      ls[sg * kQStep + tid] = i < p.S ? p.lse[o] * tc::kLog2e : 0.f;
      dl[sg * kQStep + tid] = i < p.S ? p.delta[o] : 0.f;
    }
    tc::cp_async_commit();
  };

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = p.scale * tc::kLog2e;
  if (steps > 0) issue(0);
  tc::cp_async_wait<0>();
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      issue(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int sg = it & 1, q0 = q_begin + it % n_qt * kQStep;
    const bf16* qt = qs + sg * kQStep * QS;
    const bf16* dt = dos + sg * kQStep * VS;
    const float* l2 = ls + sg * kQStep;
    const float* dlt = dl + sg * kQStep;
    // S^T = K Q^T: the warp's 16 keys x kQStep queries
    float s[kQStep / 8][4];
#pragma unroll
    for (int j = 0; j < kQStep / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DQK / 16; ++kc) {
      uint32_t a[4];
      tc::ldsm_x4(a, ks + (kw * 16 + ln.a_row) * QS + kc * 16 + ln.a_col);
#pragma unroll
      for (int j = 0; j < kQStep / 8; j += 2) {
        uint32_t bq[4];
        tc::ldsm_x4(bq, qt + (j * 8 + ln.b_row) * QS + kc * 16 + ln.b_col);
        tc::mma_bf16(s[j], a, bq[0], bq[1]);
        tc::mma_bf16(s[j + 1], a, bq[2], bq[3]);
      }
    }
    // P^T from the log-sum-exp; exactly 0 where not admitted
#pragma unroll
    for (int j = 0; j < kQStep / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const int kj = k0 + kw * 16 + g4 + 8 * (e >> 1);
        s[j][e] = admit(p, q0 + c, kj) ? tc::ex2(s[j][e] * scale_log2 - l2[c])
                                       : 0.f;
      }
    if (!dk_warp) {
      // dV += P^T dO
#pragma unroll
      for (int kc = 0; kc < kQStep / 16; ++kc) {
        uint32_t a[4], lo[4];
        split_a(s, kc, a, lo);
#pragma unroll
        for (int n = 0; n < NV; n += 2) {
          uint32_t bd[4];
          tc::ldsm_x4_trans(bd, dt + (kc * 16 + ln.a_row) * VS +
                                    (part * NV + n) * 8 + ln.a_col);
          mma_split(acc[n], acc[n + 1], a, lo, bd);
        }
      }
    } else {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
      float dp[kQStep / 8][4];
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DV / 16; ++kc) {
        uint32_t a[4];
        tc::ldsm_x4(a, vs + (kw * 16 + ln.a_row) * VS + kc * 16 + ln.a_col);
#pragma unroll
        for (int j = 0; j < kQStep / 8; j += 2) {
          uint32_t bd[4];
          tc::ldsm_x4(bd, dt + (j * 8 + ln.b_row) * VS + kc * 16 + ln.b_col);
          tc::mma_bf16(dp[j], a, bd[0], bd[1]);
          tc::mma_bf16(dp[j + 1], a, bd[2], bd[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= dp[j][e] - dlt[j * 8 + 2 * t4 + (e & 1)];
      // dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < kQStep / 16; ++kc) {
        uint32_t a[4], lo[4];
        split_a(s, kc, a, lo);
#pragma unroll
        for (int n = 0; n < NK; n += 2) {
          uint32_t bq[4];
          tc::ldsm_x4_trans(bq, qt + (kc * 16 + ln.a_row) * QS +
                                    (part * NK + n) * 8 + ln.a_col);
          mma_split(acc[n], acc[n + 1], a, lo, bq);
        }
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = k0 + kw * 16 + g4 + 8 * hh;
    if (pos >= p.S) continue;
    if (!dk_warp) {
      bf16* o = static_cast<bf16*>(p.dv) + kv_row(pos) * DV + part * NV * 8;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) =
            tc::pack_bf16(acc[n][2 * hh], acc[n][2 * hh + 1]);
    } else {
      bf16* o = static_cast<bf16*>(p.dk) + kv_row(pos) * DQK + part * NK * 8;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) =
            tc::pack_bf16(acc[n][2 * hh] * p.scale,
                          acc[n][2 * hh + 1] * p.scale);
    }
  }
}

template <int DQK>
__host__ __device__ constexpr int q_threads() {
  return kQThreads * col_parts<DQK>();
}

template <int DQK, int DV, int KN>
__host__ __device__ constexpr size_t q_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(kQRows + 2 * KN) *
         (DQK + DV + 2 * tc::kPad);
}

// (iii) bf16: grid n_qt * B * Hq, the last query tile first
template <int DQK, int DV, int KN>
__global__ void __launch_bounds__(q_threads<DQK>())
    flash_bwd_q_kernel(Args p) {
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  constexpr int NT = q_threads<DQK>();
  constexpr int NQ = DQK / 8 / col_parts<DQK>();  // dQ's column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kQRows * QS;
  bf16* ks = dos + kQRows * VS;      // ring of two key tiles
  bf16* vs = ks + 2 * KN * QS;       // ring of two

  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.S + kQRows - 1) / kQRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq, hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * kQRows;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32 % 4, part = tid / 32 / 4;  // rows, column part
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
  tc::load_rows<DQK, kQRows, NT>(qs, tid, q, [&](int r) -> const bf16* {
    return q0 + r < p.S ? q + q_row(q0 + r) * DQK : nullptr;
  });
  tc::load_rows<DV, kQRows, NT>(
      dos, tid, dout, [&](int r) -> const bf16* {
        return q0 + r < p.S ? dout + q_row(q0 + r) * DV : nullptr;
      });
  const int i0 = warp * 16 + g4;    // the thread's rows: i0 and i0 + 8
  float l2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + i;
    l2[hh] = i < p.S ? p.lse[o] * tc::kLog2e : 0.f;
    dlt[hh] = i < p.S ? p.delta[o] : 0.f;
  }
  int k_begin, k_end;
  key_range(p, q0, min(q0 + kQRows, p.S) - 1, KN, &k_begin, &k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + KN - 1) / KN : 0;
  auto issue = [&](int it) {
    const int sg = it & 1, pos0 = k_begin + it * KN;
    tc::load_rows<DQK, KN, NT>(
        ks + sg * KN * QS, tid, k, [&](int r) -> const bf16* {
          return pos0 + r < k_end ? k + kv_row(pos0 + r) * DQK : nullptr;
        });
    tc::load_rows<DV, KN, NT>(
        vs + sg * KN * VS, tid, v, [&](int r) -> const bf16* {
          return pos0 + r < k_end ? v + kv_row(pos0 + r) * DV : nullptr;
        });
    tc::cp_async_commit();
  };

  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = p.scale * tc::kLog2e;
  if (ntiles > 0) {
    issue(0);  // the first group carries q and dO as well
  } else {
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      issue(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int sg = it & 1, pos0 = k_begin + it * KN;
    const bf16* kt = ks + sg * KN * QS;
    const bf16* vt = vs + sg * KN * VS;
    // S = Q K^T and dP = dO V^T over the warp's 16 rows and KN keys
    float s[KN / 8][4], dp[KN / 8][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DQK / 16; ++kc) {
      uint32_t a[4];
      tc::ldsm_x4(a, qs + (warp * 16 + ln.a_row) * QS + kc * 16 + ln.a_col);
#pragma unroll
      for (int j = 0; j < KN / 8; j += 2) {
        uint32_t bk[4];
        tc::ldsm_x4(bk, kt + (j * 8 + ln.b_row) * QS + kc * 16 + ln.b_col);
        tc::mma_bf16(s[j], a, bk[0], bk[1]);
        tc::mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int kc = 0; kc < DV / 16; ++kc) {
      uint32_t a[4];
      tc::ldsm_x4(a, dos + (warp * 16 + ln.a_row) * VS + kc * 16 + ln.a_col);
#pragma unroll
      for (int j = 0; j < KN / 8; j += 2) {
        uint32_t bv[4];
        tc::ldsm_x4(bv, vt + (j * 8 + ln.b_row) * VS + kc * 16 + ln.b_col);
        tc::mma_bf16(dp[j], a, bv[0], bv[1]);
        tc::mma_bf16(dp[j + 1], a, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta), P from the log-sum-exp, 0 where not admitted
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kj = pos0 + j * 8 + 2 * t4 + (e & 1);
        const float pr = admit(p, q0 + i0 + 8 * hh, kj)
                             ? tc::ex2(s[j][e] * scale_log2 - l2[hh])
                             : 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[hh]);
      }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < KN / 16; ++kc) {
      uint32_t a[4], lo[4];
      split_a(s, kc, a, lo);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t bk[4];
        tc::ldsm_x4_trans(bk, kt + (kc * 16 + ln.a_row) * QS +
                                  (part * NQ + n) * 8 + ln.a_col);
        mma_split(acc[n], acc[n + 1], a, lo, bk);
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    if (i >= p.S) continue;
    bf16* o = dq + q_row(i) * DQK + part * NQ * 8;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) = tc::pack_bf16(
          acc[n][2 * hh] * p.scale, acc[n][2 * hh + 1] * p.scale);
  }
}

template <int D>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kT) * (D + 1) +
                          2 * kT * (kT + 1) + 2 * kT);
}

// (ii) fp32: grid (ceil(S / 16), B * Hkv).  Thread tid owns column
// d = tid % D of key rows tid / D, + 256 / D, ...
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_kv_f32_kernel(Args p) {
  constexpr int DP = D + 1, NRG = kF32Threads / D, RPT = kT / NRG;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kT * DP;
  float* qs = vs + kT * DP;
  float* dos = qs + kT * DP;
  float* ps = dos + kT * DP;      // P (query x key)
  float* dss = ps + kT * (kT + 1);  // dS
  float* ls = dss + kT * (kT + 1);  // lse
  float* dl = ls + kT;            // delta
  const int G = p.Hq / p.Hkv;
  const int k0 = blockIdx.x * kT;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int tid = threadIdx.x, d = tid % D, rg = tid / D;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  for (int i = tid; i < kT * D; i += kF32Threads) {
    const int r = i / D, c = i % D, pos = k0 + r;
    const size_t o = ((static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk) * D + c;
    ks[r * DP + c] = pos < p.S ? k[o] : 0.f;
    vs[r * DP + c] = pos < p.S ? v[o] : 0.f;
  }
  float ak[RPT], av[RPT];
#pragma unroll
  for (int x = 0; x < RPT; ++x) ak[x] = av[x] = 0.f;
  int q_begin, q_end;
  query_range(p, k0, kT, kT, &q_begin, &q_end);
  const int qi = tid / kT, kj = tid % kT;  // the thread's pair
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += kT) {
      __syncthreads();  // the last step is done with the query tiles
      for (int i = tid; i < kT * D; i += kF32Threads) {
        const int r = i / D, c = i % D, row = q0 + r;
        const size_t o = (static_cast<size_t>(b) * p.S + row) * p.Hq + hq;
        qs[r * DP + c] = row < p.S ? q[o * D + c] : 0.f;
        dos[r * DP + c] = row < p.S ? dout[o * D + c] : 0.f;
      }
      if (tid < kT) {
        const int row = q0 + tid;
        const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + row;
        ls[tid] = row < p.S ? p.lse[o] : 0.f;
        dl[tid] = row < p.S ? p.delta[o] : 0.f;
      }
      __syncthreads();
      float pr = 0.f, ds = 0.f;
      if (admit(p, q0 + qi, k0 + kj)) {
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < D; ++c) {
          s += qs[qi * DP + c] * ks[kj * DP + c];
          dp += dos[qi * DP + c] * vs[kj * DP + c];
        }
        pr = expf(s * p.scale - ls[qi]);
        ds = pr * (dp - dl[qi]);
      }
      ps[qi * (kT + 1) + kj] = pr;
      dss[qi * (kT + 1) + kj] = ds;
      __syncthreads();
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const int r = rg + x * NRG;
        float a = 0.f, c = 0.f;
        for (int i = 0; i < kT; ++i) {
          a += ps[i * (kT + 1) + r] * dos[i * DP + d];
          c += dss[i * (kT + 1) + r] * qs[i * DP + d];
        }
        av[x] += a;
        ak[x] += c;
      }
    }
  }
  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
#pragma unroll
  for (int x = 0; x < RPT; ++x) {
    const int pos = k0 + rg + x * NRG;
    if (pos < p.S) {
      const size_t o =
          ((static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk) * D + d;
      dk[o] = ak[x] * p.scale;
      dv[o] = av[x];
    }
  }
}

// (iii) fp32: grid (ceil(S / 16), B * Hq).  Thread tid owns column
// d = tid % D of query rows tid / D, + 256 / D, ...
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_q_f32_kernel(Args p) {
  constexpr int DP = D + 1, NRG = kF32Threads / D, RPT = kT / NRG;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kT * DP;
  float* qs = vs + kT * DP;
  float* dos = qs + kT * DP;
  float* dss = dos + kT * DP;       // dS (query x key)
  float* ls = dss + kT * (kT + 1);
  float* dl = ls + kT;
  const int G = p.Hq / p.Hkv;
  const int q0 = blockIdx.x * kT;
  const int b = blockIdx.y / p.Hq, hq = blockIdx.y % p.Hq, hk = hq / G;
  const int tid = threadIdx.x, d = tid % D, rg = tid / D;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  for (int i = tid; i < kT * D; i += kF32Threads) {
    const int r = i / D, c = i % D, row = q0 + r;
    const size_t o = (static_cast<size_t>(b) * p.S + row) * p.Hq + hq;
    qs[r * DP + c] = row < p.S ? q[o * D + c] : 0.f;
    dos[r * DP + c] = row < p.S ? dout[o * D + c] : 0.f;
  }
  if (tid < kT) {
    const int row = q0 + tid;
    const size_t o = (static_cast<size_t>(b) * p.Hq + hq) * p.S + row;
    ls[tid] = row < p.S ? p.lse[o] : 0.f;
    dl[tid] = row < p.S ? p.delta[o] : 0.f;
  }
  float aq[RPT];
#pragma unroll
  for (int x = 0; x < RPT; ++x) aq[x] = 0.f;
  int k_begin, k_end;
  key_range(p, q0, min(q0 + kT, p.S) - 1, kT, &k_begin, &k_end);
  const int qi = tid / kT, kj = tid % kT;
  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the last tile is read
    for (int i = tid; i < kT * D; i += kF32Threads) {
      const int r = i / D, c = i % D, pos = k0 + r;
      const size_t o =
          ((static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk) * D + c;
      ks[r * DP + c] = pos < p.S ? k[o] : 0.f;
      vs[r * DP + c] = pos < p.S ? v[o] : 0.f;
    }
    __syncthreads();
    float ds = 0.f;
    if (admit(p, q0 + qi, k0 + kj)) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s += qs[qi * DP + c] * ks[kj * DP + c];
        dp += dos[qi * DP + c] * vs[kj * DP + c];
      }
      ds = expf(s * p.scale - ls[qi]) * (dp - dl[qi]);
    }
    dss[qi * (kT + 1) + kj] = ds;
    __syncthreads();
#pragma unroll
    for (int x = 0; x < RPT; ++x) {
      const int r = rg + x * NRG;
      float a = 0.f;
      for (int j = 0; j < kT; ++j) a += dss[r * (kT + 1) + j] * ks[j * DP + d];
      aq[x] += a;
    }
  }
  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int x = 0; x < RPT; ++x) {
    const int row = q0 + rg + x * NRG;
    if (row < p.S)
      dq[((static_cast<size_t>(b) * p.S + row) * p.Hq + hq) * D + d] =
          aq[x] * p.scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_delta(const Args& a, int DV, cudaStream_t stream) {
  const long rows = static_cast<long>(a.B) * a.S * a.Hq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                              stream>>>(a, DV);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_bf16(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<bf16>(a, DV, stream);
  if (rc != 0) return rc;
  auto kv = flash_bwd_kv_kernel<DQK, DV>;
  size_t smem = kv_smem_bytes<DQK, DV>();
  cudaError_t e = allow_smem(kv, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int keys = kv_keys<DQK>();
  kv<<<dim3((a.S + keys - 1) / keys, a.B * a.Hkv), kKVThreads, smem,
       stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int KN = DQK > 128 ? 32 : 64;
  auto qk = flash_bwd_q_kernel<DQK, DV, KN>;
  smem = q_smem_bytes<DQK, DV, KN>();
  e = allow_smem(qk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (a.S + kQRows - 1) / kQRows;
  qk<<<n_qt * a.B * a.Hq, q_threads<DQK>(), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<float>(a, D, stream);
  if (rc != 0) return rc;
  const size_t smem = f32_smem_bytes<D>();
  const int n_t = (a.S + kT - 1) / kT;
  auto kv = flash_bwd_kv_f32_kernel<D>;
  cudaError_t e = allow_smem(kv, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(n_t, a.B * a.Hkv), kF32Threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto qk = flash_bwd_q_f32_kernel<D>;
  e = allow_smem(qk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  qk<<<dim3(n_t, a.B * a.Hq), kF32Threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; causal: 0 or 1; window <= 0: no window.
// lse: the forward's (B, Hq, S); delta: the wrapper's (B, Hq, S) fp32
// scratch.  Launches delta's kernel, then the dK/dV and the dQ kernels.
// Returns the CUDA error code of the launches (0 on success); the wrapper
// raises on anything else.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int S, int Hq, int Hkv, int Dqk,
                                   int Dv, int causal, int window, int dtype,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,  o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv, B, S, Hq, Hkv, causal,
         window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Dqk == 64 && Dv == 64) return launch_bf16<64, 64>(a, s);
    if (Dqk == 80 && Dv == 80) return launch_bf16<80, 80>(a, s);
    if (Dqk == 128 && Dv == 128) return launch_bf16<128, 128>(a, s);
    if (Dqk == 256 && Dv == 256) return launch_bf16<256, 256>(a, s);
    if (Dqk == 192 && Dv == 128) return launch_bf16<192, 128>(a, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 || Dqk != Dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dqk) {
    case 64: return launch_f32<64>(a, s);
    case 128: return launch_f32<128>(a, s);
    case 256: return launch_f32<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
