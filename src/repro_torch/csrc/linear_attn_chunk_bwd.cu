// The backward of chunked decay linear attention (K6) for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package has no backward kernel for K6
// (no custom_vjp in src/repro); its trainer differentiates the jnp
//   src/repro/models/ssm.py::decay_attention_chunked
// and this kernel computes that gradient, so that training on the card
// runs no plain PyTorch on a CUDA tensor.  Its plain version, in the same
// decomposition, is kernels/linear_attn_chunk/ref.py::
// decay_attention_chunked_bwd.
//
// What it computes, per (b, h) and chunk (the forward's notation,
// linear_attn_chunk.cu: L the inclusive cumulative log-decay of the chunk,
// E = L - w, L_last = L at the chunk's end, S_in the state entering it),
// given do and the final state's cotangent (or zero):
//   dS_out of the last chunk = d_state;
//   dS_in  = exp(L_last) * dS_out + sum_t (r_t exp(E_t)) do_t^T
//            (dS_in of chunk 0 is the initial state's gradient);
//   dA[t][s] = do_t . v_s (s < t);
//   dv_s = sum_{t>s} A[t][s] do_t + (r_s . u k_s) do_s + k2_s dS_out;
//   dr_t = sum_{s<t} dA[t][s] k_s exp(E_t - L_s) + exp(E_t) S_in do_t
//          + u k_t (do_t . v_t);
//   dk_s = sum_{t>s} dA[t][s] r_t exp(E_t - L_s)
//          + exp(L_last - L_s) dS_out v_s + u r_s (do_s . v_s);
//   dw_t = sum_{t' >= t} (gE + gL)_t' - gE_t, with gE = r * (dr less its
//          u-term), gL = -k * (dk less its u-term), and at the last
//          position gL += sum_s k_s exp(L_last - L_s) (dS_out v_s)
//          + exp(L_last) sum_e dS_out S_in;
//   du = sum over b and t of r_t k_t (do_t . v_t).
// Every exponent is <= 0, as in the forward: nothing overflows however
// strong the decay.  Positions at or past S read as zeros and get no
// gradient written.
//
// Layout: r, k, v, do, dr, dk, dv (B, S, H, 64) in one type, fp32 or
// bf16; w, dw (B, S, H, 64) fp32; u, du (H, 64) fp32 or null;
// states (B, H, n_chunks, 64, 64) fp32, the S_in the forward's scan wrote;
// d_state (B, H, 64, 64) fp32 or null; d_s0 (B, H, 64, 64) fp32.
// Scratch from the wrapper (fp32): dS_out of each chunk (B, H, n_chunks,
// 64, 64), each chunk's decay exp(L_last) (B, H, n_chunks, 64) and, with
// u, du's per-chunk partials (B, H, n_chunks, 64).
//
// Design, bf16 (redesigned for the H100: rwkv6-1.6b trains in bf16), four
// launches, no atomics, so two identical calls give the same bits:
//  (a) linear_attn_bwd_inc_kernel, one block of 8 warps per (chunk, h, b):
//      the chunk's increment of the state's gradient, q_eff^T do with
//      q_eff = r exp(E), computed once (its exponentials too) on the
//      tensor cores, into the chunk's dS_out slot, and exp(L_last).
//  (b) linear_attn_bwd_carry_kernel, one thread per state entry (b, h, d,
//      e), from the last chunk: dS_out written over the increment, then
//      dS <- exp(L_last) dS + increment (four chunks' loads in flight);
//      dS_in of chunk 0 is the initial state's gradient.  Every state
//      entry walks the chunks at once, and no exponential is taken twice:
//      8.4 MB read and written at rwkv6's (1, 1024).
//  (c) linear_attn_bwd_chunk_tc_kernel, one block of 8 warps per (chunk,
//      h, b), two blocks an SM (107 KB of shared memory: r, k, v, do in
//      bf16, L and E in fp32, one C x C tile that holds A and then dA, one
//      64 x 64 tile that holds S_in and then dS_out).  Warp w owns 16 rows
//      and C / 4 columns of each of dr, dk and dv in fp32 registers.  The
//      products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) in the
//      forward's decomposition: A rebuilt by secondary chunks of 16
//      (diagonal blocks pairwise on the CUDA cores, off-diagonal ones
//      factored through L at the end of the earlier sub-chunk, both
//      factors <= 1), dA = do v^T, A^T do, the decayed dA k and dA^T r
//      (their diagonal blocks pairwise for the thread's own elements), and
//      the S_in do, dS_out v and k2 dS_out terms.  An fp32 operand (the
//      states, A, dA, the decayed factors) enters as two bf16 parts (the
//      rounded value, then what the rounding dropped), r, k, v and do
//      whole; every exponent is <= 0.  dw by a reverse cumulative sum down
//      each channel, du's partial by column sums in a fixed order.
//  (d) linear_attn_bwd_du_kernel sums du's partials over b and the chunks
//      in a fixed order (launched only with u).
// fp32 (not redesigned): three launches on the CUDA cores in fp32.
//  (b') linear_attn_bwd_scan_kernel, one block per (16 state columns, h,
//      b), walks the chunks from the last: it writes each chunk's dS_out,
//      then dS <- exp(L_last) dS + q_eff^T do, recomputing q_eff =
//      r exp(E) from r and w, and writes dS_in of chunk 0.
//  (c') linear_attn_bwd_chunk_kernel, one block of 16 warps per (chunk, h,
//      b), as (c) with fp32 sums in shared memory (one block an SM); each
//      thread owns C * 64 / 512 (t, channel) elements of dr, dk and dv;
//  (d) as above.
//
// Bound: bytes.  At rwkv6-1.6b's (1, 1024), 32 heads, bf16, the function
// reads r, k, v, do (bf16) and w (fp32) and writes dr, dk, dv (bf16) and
// dw (fp32): ~46 MB, ~14 us at 3.35 TB/s (the kernel also reads the 8.4 MB
// of states the forward saved, which follow from k, v and w, so the bound
// leaves them out); its least products (8 dk dv a token: the gradients of
// the state's read-out and update) are 1.1 GFLOP, ~1 us on the tensor
// cores.  chip_smoke.py's phase 3m prints launch/op_cost.py::
// k6_bwd_charge.  The bf16 design's own traffic is above that: the
// increments and dS_out (8.4 MB each, written and read through the 50 MB
// L2) and the states; its exponentials (the diagonal blocks' pairs, three
// times: A, dr, dk) sit on the SFUs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;              // dk = dv
constexpr int kP = kD + 1;          // row stride (floats) of a (t, d) tile
constexpr int kSub = 16;            // secondary chunk
constexpr int kThreads = 512;       // (c): 16 warps
constexpr int kScanThreads = 256;   // (b)
constexpr int kSlice = 16;          // (b): state columns per block
constexpr int kSlices = kD / kSlice;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;        // null: no bonus, no du
  const float* states;   // (B, H, n_chunks, 64, 64): S entering each chunk
  const void* dout;
  const float* d_state;  // null: the final state takes no cotangent
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;             // (H, 64), or null
  float* d_s0;           // (B, H, 64, 64)
  float* ds_out;         // scratch (B, H, n_chunks, 64, 64)
  float* decay;          // scratch (B, H, n_chunks, 64): bf16's exp(L_last)
  float* du_part;        // scratch (B, H, n_chunks, 64), or null
  int B, S, H;
};

__device__ __forceinline__ size_t tok(const Args& p, int b, int t, int h) {
  return ((static_cast<size_t>(b) * p.S + t) * p.H + h) * kD;
}

// (b): grid (kSlices, H, B).  Thread tid holds dS[d][e0 + e] for e =
// tid % 16 and d = tid / 16 + 16 i, i < 4.
template <typename T, int C>
__global__ void __launch_bounds__(kScanThreads)
    linear_attn_bwd_scan_kernel(Args p) {
  __shared__ float qs[C * kP];      // r, then q_eff = r exp(E)
  __shared__ float ws[C * kP];      // w
  __shared__ float ds[C * (kSlice + 1)];  // do's slice
  __shared__ float dc[kD];          // exp(L_last)
  const int e0 = blockIdx.x * kSlice, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (p.S + C - 1) / C;
  const int tid = threadIdx.x, e = tid % kSlice, d0 = tid / kSlice;
  const size_t bh = static_cast<size_t>(b) * p.H + h;
  const T* r = static_cast<const T*>(p.r);
  const T* dout = static_cast<const T*>(p.dout);
  constexpr int NR = kD * kSlice / kScanThreads;
  float g[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i)
    g[i] = p.d_state ? p.d_state[(bh * kD + d0 + 16 * i) * kD + e0 + e] : 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * C;
    float* so = p.ds_out + (bh * n_chunks + c) * kD * kD + e0;
#pragma unroll
    for (int i = 0; i < NR; ++i) so[(d0 + 16 * i) * kD + e] = g[i];
    for (int i = tid; i < C * kD; i += kScanThreads) {
      const int t = i / kD, d = i % kD;
      const bool in = t0 + t < p.S;
      qs[t * kP + d] = in ? to_f32(r[tok(p, b, t0 + t, h) + d]) : 0.f;
      ws[t * kP + d] = in ? p.w[tok(p, b, t0 + t, h) + d] : 0.f;
    }
    for (int i = tid; i < C * kSlice; i += kScanThreads) {
      const int t = i / kSlice, x = i % kSlice;
      ds[t * (kSlice + 1) + x] =
          t0 + t < p.S ? to_f32(dout[tok(p, b, t0 + t, h) + e0 + x]) : 0.f;
    }
    __syncthreads();
    if (tid < kD) {  // the cumulative log-decay down channel tid
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wv = ws[t * kP + tid];
        acc += wv;
        qs[t * kP + tid] *= expf(acc - wv);
      }
      dc[tid] = expf(acc);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int d = d0 + 16 * i;
      float s = 0.f;
      for (int t = 0; t < C; ++t)
        s += qs[t * kP + d] * ds[t * (kSlice + 1) + e];
      g[i] = g[i] * dc[d] + s;
    }
    __syncthreads();  // the next chunk's loads overwrite the tiles
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
    p.d_s0[(bh * kD + d0 + 16 * i) * kD + e0 + e] = g[i];
}

// (c)'s shared memory at chunk C: r, k, v, do, L, E and a staging tile
// (C x kP each), A and dA (C x (C + 1) each), S_in and dS_out transposed
// (64 x kP each: [e][d]), the u-diagonal, do . v, u and a column sum
template <int C>
struct Grad {
  static constexpr int NS = C / kSub;
  static constexpr size_t floats = 7 * static_cast<size_t>(C) * kP +
                                   2 * static_cast<size_t>(C) * (C + 1) +
                                   2 * static_cast<size_t>(kD) * kP + 2 * C +
                                   2 * kD;
};

// (c): grid (n_chunks, H, B).  Thread tid owns the (t, d) elements
// i = tid + 512 m (t = i / 64, d = i % 64) of dr, dk, dv and dw.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    linear_attn_bwd_chunk_kernel(Args p) {
  constexpr int CP = C + 1;
  constexpr int NE = C * kD / kThreads;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* rs = smem;           // r
  float* ks = rs + C * kP;    // k
  float* vs = ks + C * kP;    // v
  float* gs = vs + C * kP;    // do
  float* ls = gs + C * kP;    // L (inclusive)
  float* xs = ls + C * kP;    // w, then E = L - w
  float* st = xs + C * kP;    // staged factors, then k2
  float* as = st + C * kP;    // A
  float* das = as + C * CP;   // dA
  float* si = das + C * CP;   // S_in^T
  float* so = si + kD * kP;   // dS_out^T
  float* dg = so + kD * kP;   // r[t] . (u * k[t])
  float* dov = dg + C;        // do[t] . v[t]
  float* us = dov + C;        // u
  float* col = us + kD;       // exp(L_last) sum_e dS_out S_in, per d

  const T* r = static_cast<const T*>(p.r);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int t0 = c * C;
  for (int i = tid; i < C * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    const bool in = t0 + t < p.S;
    const size_t o = in ? tok(p, b, t0 + t, h) + d : 0;
    rs[t * kP + d] = in ? to_f32(r[o]) : 0.f;
    ks[t * kP + d] = in ? to_f32(k[o]) : 0.f;
    vs[t * kP + d] = in ? to_f32(v[o]) : 0.f;
    gs[t * kP + d] = in ? to_f32(dout[o]) : 0.f;
    xs[t * kP + d] = in ? p.w[o] : 0.f;
  }
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  const float* s_in = p.states + bhc * kD * kD;
  const float* s_out = p.ds_out + bhc * kD * kD;
  for (int i = tid; i < kD * kD; i += kThreads) {
    const int d = i / kD, e = i % kD;
    si[e * kP + d] = s_in[i];
    so[e * kP + d] = s_out[i];
  }
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  __syncthreads();

  // the cumulative log-decay, one thread a channel; the u-diagonal and
  // do . v on the next threads meanwhile
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
    for (int d = 0; d < kD; ++d) s += rs[t * kP + d] * us[d] * ks[t * kP + d];
    dg[t] = s;
  } else if (tid < kD + 2 * C) {
    const int t = tid - kD - C;
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += gs[t * kP + e] * vs[t * kP + e];
    dov[t] = s;
  }
  __syncthreads();

  // dA (strict lower) and A's diagonal sub-blocks, pairwise
  for (int i = tid; i < C * C; i += kThreads) {
    const int t = i / C, s = i % C;
    float da = 0.f, a = 0.f;
    if (s < t) {
      for (int e = 0; e < kD; ++e) da += gs[t * kP + e] * vs[s * kP + e];
      if (s / kSub == t / kSub)
        for (int d = 0; d < kD; ++d)
          a += rs[t * kP + d] * ks[s * kP + d] *
               expf(fminf(xs[t * kP + d] - ls[s * kP + d], 0.f));
    }
    das[t * CP + s] = da;
    as[t * CP + s] = a;  // the off-diagonal blocks are set below
  }
  __syncthreads();

  // the decayed intra-chunk products of dr and dk: the diagonal blocks
  // pairwise, for the elements the thread owns
  float dr_a[NE], dk_a[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int i = tid + m * kThreads, t = i / kD, d = i % kD;
    const int s0 = t / kSub * kSub, s1 = s0 + kSub;
    const float xt = xs[t * kP + d], lt = ls[t * kP + d];
    float a = 0.f, bk = 0.f;
    for (int s = s0; s < t; ++s)
      a += das[t * CP + s] * ks[s * kP + d] *
           expf(fminf(xt - ls[s * kP + d], 0.f));
    for (int u = t + 1; u < s1; ++u)
      bk += das[u * CP + t] * rs[u * kP + d] *
            expf(fminf(xs[u * kP + d] - lt, 0.f));
    dr_a[m] = a;
    dk_a[m] = bk;
  }
  // the off-diagonal blocks, one reference at a time: L at the end of
  // sub-chunk j; r's factor for the rows past j, k's for the rows of j
  for (int j = 0; j + 1 < Grad<C>::NS; ++j) {
    const int j0 = j * kSub, j1 = j0 + kSub;
    for (int i = tid; i < C * kD; i += kThreads) {
      const int t = i / kD, d = i % kD;
      const float ref = ls[(j1 - 1) * kP + d];
      if (t >= j1)
        st[t * kP + d] =
            rs[t * kP + d] * expf(fminf(xs[t * kP + d] - ref, 0.f));
      else if (t >= j0)
        st[t * kP + d] =
            ks[t * kP + d] * expf(fminf(ref - ls[t * kP + d], 0.f));
    }
    __syncthreads();
    for (int i = tid; i < (C - j1) * kSub; i += kThreads) {
      const int t = j1 + i / kSub, s = j0 + i % kSub;
      float a = 0.f;
      for (int d = 0; d < kD; ++d) a += st[t * kP + d] * st[s * kP + d];
      as[t * CP + s] = a;
    }
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      const int i = tid + m * kThreads, t = i / kD, d = i % kD;
      const float ref = ls[(j1 - 1) * kP + d];
      if (t >= j1) {
        float x = 0.f;
        for (int s = j0; s < j1; ++s) x += das[t * CP + s] * st[s * kP + d];
        dr_a[m] += expf(fminf(xs[t * kP + d] - ref, 0.f)) * x;
      } else if (t >= j0) {
        float x = 0.f;
        for (int u = j1; u < C; ++u) x += das[u * CP + t] * st[u * kP + d];
        dk_a[m] += expf(fminf(ref - ls[t * kP + d], 0.f)) * x;
      }
    }
    __syncthreads();  // the next reference restages st; A is complete
  }

  // k2 = k exp(L_last - L) for dv's state term
  for (int i = tid; i < C * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    st[t * kP + d] =
        ks[t * kP + d] * expf(ls[(C - 1) * kP + d] - ls[t * kP + d]);
  }
  if (tid < kD) {  // the last position's S_in term of dw, per channel
    float x = 0.f;
    for (int e = 0; e < kD; ++e) x += so[e * kP + tid] * si[e * kP + tid];
    col[tid] = expf(ls[(C - 1) * kP + tid]) * x;
  }
  __syncthreads();

  T* dr = static_cast<T*>(p.dr);
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  float ge[NE], gl[NE], kds[NE], rkd[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int i = tid + m * kThreads, t = i / kD, d = i % kD;
    const bool in = t0 + t < p.S;
    const size_t o = in ? tok(p, b, t0 + t, h) + d : 0;
    // dv (row t, column e = d)
    float x = dg[t] * gs[t * kP + d];
    for (int u = t + 1; u < C; ++u) x += as[u * CP + t] * gs[u * kP + d];
    for (int f = 0; f < kD; ++f) x += st[t * kP + f] * so[d * kP + f];
    // the state terms of dr and dk
    float sd = 0.f, sk = 0.f;
    for (int e = 0; e < kD; ++e) {
      sd += si[e * kP + d] * gs[t * kP + e];
      sk += so[e * kP + d] * vs[t * kP + e];
    }
    const float drw = dr_a[m] + expf(xs[t * kP + d]) * sd;
    const float dks = expf(ls[(C - 1) * kP + d] - ls[t * kP + d]) * sk;
    const float dkw = dk_a[m] + dks;
    const float rt = rs[t * kP + d], kt = ks[t * kP + d];
    const float bonus = us[d] * dov[t];
    if (in) {
      dv[o] = from_f32<T>(x);
      dr[o] = from_f32<T>(drw + bonus * kt);
      dk[o] = from_f32<T>(dkw + bonus * rt);
    }
    ge[m] = rt * drw;
    gl[m] = -kt * dkw;
    kds[m] = kt * dks;
    rkd[m] = rt * kt * dov[t];
  }
  __syncthreads();  // every tile read: L, E, k2 and r take the sums
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int i = tid + m * kThreads, t = i / kD, d = i % kD;
    ls[t * kP + d] = gl[m];
    xs[t * kP + d] = ge[m] + gl[m];
    st[t * kP + d] = kds[m];
    rs[t * kP + d] = rkd[m];
  }
  __syncthreads();
  if (tid < kD) {  // dw down channel tid, from the chunk's end; du's partial
    const int d = tid;
    float last = col[d], du = 0.f;
    for (int t = 0; t < C; ++t) {
      last += st[t * kP + d];
      du += rs[t * kP + d];
    }
    float acc = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      const float add = t == C - 1 ? last : 0.f;
      if (t0 + t < p.S) p.dw[tok(p, b, t0 + t, h) + d] = acc + ls[t * kP + d] + add;
      acc += xs[t * kP + d] + add;
    }
    if (p.du_part) p.du_part[bhc * kD + d] = du;
  }
}

// (d): grid H, 64 threads; du[h][d] = sum over b, then chunks, in order
__global__ void __launch_bounds__(kD)
    linear_attn_bwd_du_kernel(const float* part, float* du, int B, int H,
                              int n_chunks) {
  const int h = blockIdx.x, d = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n_chunks; ++c)
      s += part[((static_cast<size_t>(b) * H + h) * n_chunks + c) * kD + d];
  du[h * kD + d] = s;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core design
// ---------------------------------------------------------------------------

constexpr int kTC = 256;        // (a), (c) bf16: 8 warps
constexpr int kQ = kD + 4;      // fp32 row stride: rows 16-byte aligned
constexpr int kB = kD + tc::kPad;  // bf16 row stride (72)

// exp on the special-function unit (ex2 of x log2 e): bf16's tolerance
// allows it, as in the forward's bf16 build
__device__ __forceinline__ float fex(float x) { return __expf(x); }

// A fragment (rows row0 + g, + 8; columns col0 + 2t, +1, + 8, + 9) of the
// matrix at(row, col): exact (its values are bf16 already) ...
template <typename At>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], int row0, int col0,
                                       At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int rr = row0 + g + 8 * (x & 1), cc = col0 + 2 * t + 8 * (x >> 1);
    a[x] = tc::pack_bf16(at(rr, cc), at(rr, cc + 1));
  }
}
// ... or as two bf16 parts (value, rounding residue) of an fp32 matrix
template <typename At>
__device__ __forceinline__ void frag_a2(uint32_t (&big)[4],
                                        uint32_t (&small)[4], int row0,
                                        int col0, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int rr = row0 + g + 8 * (x & 1), cc = col0 + 2 * t + 8 * (x >> 1);
    tc::split_bf16(at(rr, cc), at(rr, cc + 1), big[x], small[x]);
  }
}
// B fragment (k rows k0 + 2t, + 1, + 8, + 9; column n0 + g) of the matrix
// at(k, n): exact, or as two parts
template <typename At>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], int k0, int n0,
                                       At at) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  b[0] = tc::pack_bf16(at(k, n), at(k + 1, n));
  b[1] = tc::pack_bf16(at(k + 8, n), at(k + 9, n));
}
template <typename At>
__device__ __forceinline__ void frag_b2(uint32_t (&big)[2],
                                        uint32_t (&small)[2], int k0, int n0,
                                        At at) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  tc::split_bf16(at(k, n), at(k + 1, n), big[0], small[0]);
  tc::split_bf16(at(k + 8, n), at(k + 9, n), big[1], small[1]);
}

// c += A B with A and/or B as two bf16 parts: the products of the parts
// above fp32's rounding (small x small is dropped)
__device__ __forceinline__ void mma_a2(float (&c)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&b)[2]) {
  tc::mma_bf16(c, ab, b[0], b[1]);
  tc::mma_bf16(c, as, b[0], b[1]);
}
__device__ __forceinline__ void mma_b2(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&bb)[2],
                                       const uint32_t (&bs)[2]) {
  tc::mma_bf16(c, a, bb[0], bb[1]);
  tc::mma_bf16(c, a, bs[0], bs[1]);
}
__device__ __forceinline__ void mma_ab2(float (&c)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  tc::mma_bf16(c, ab, bb[0], bb[1]);
  tc::mma_bf16(c, ab, bs[0], bs[1]);
  tc::mma_bf16(c, as, bb[0], bb[1]);
}

__device__ __forceinline__ float bf(const bf16* m, int i) {
  return __bfloat162float(m[i]);
}

// C rows of fp32 (four a 16-byte copy) from row t0 on into shared memory
// (row stride kQ), zero past S
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              const Args& p, int b, int t0,
                                              int h, int C) {
  for (int i = threadIdx.x; i < C * (kD / 4); i += blockDim.x) {
    const int t = i / (kD / 4), ch = i % (kD / 4);
    const bool in = t0 + t < p.S;
    tc::cp_async16(dst + t * kQ + ch * 4,
                   in ? src + tok(p, b, t0 + t, h) + ch * 4 : src, in);
  }
}

// C rows of a bf16 operand into shared memory (row stride kB), zero past S
__device__ __forceinline__ void load_bf16_rows(bf16* dst, const bf16* src,
                                               const Args& p, int b, int t0,
                                               int h, int C) {
  for (int i = threadIdx.x; i < C * (kD / 8); i += blockDim.x) {
    const int t = i / (kD / 8), ch = i % (kD / 8);
    const bool in = t0 + t < p.S;
    tc::cp_async16(dst + t * kB + ch * 8,
                   in ? src + tok(p, b, t0 + t, h) + ch * 8 : src, in);
  }
}

// (a) bf16: grid (n_chunks, H, B).  The chunk's increment of the state's
// gradient, q_eff^T do with q_eff = r exp(E), into ds_out's slot of the
// chunk (the carry overwrites it with dS_out), and its decay exp(L_last).
template <int C>
__host__ __device__ constexpr size_t inc_smem_bytes() {
  return sizeof(float) * 2 * static_cast<size_t>(C) * kQ +
         sizeof(bf16) * 2 * static_cast<size_t>(C) * kB;
}

template <int C>
__global__ void __launch_bounds__(kTC) linear_attn_bwd_inc_kernel(Args p) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // w, then E
  float* qe = xs + C * kQ;                         // q_eff
  bf16* rb = reinterpret_cast<bf16*>(qe + C * kQ);
  bf16* gb = rb + C * kB;                          // do
  load_f32_rows(xs, p.w, p, b, t0, h, C);
  load_bf16_rows(rb, static_cast<const bf16*>(p.r), p, b, t0, h, C);
  load_bf16_rows(gb, static_cast<const bf16*>(p.dout), p, b, t0, h, C);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  if (tid < kD) {  // the cumulative log-decay down channel tid
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = xs[t * kQ + tid];
      acc += wv;
      xs[t * kQ + tid] = acc - wv;
    }
    p.decay[bhc * kD + tid] = expf(acc);
  }
  __syncthreads();
  for (int i = tid; i < C * kD; i += kTC) {
    const int t = i / kD, d = i % kD;
    qe[t * kQ + d] = bf(rb, t * kB + d) * fex(xs[t * kQ + d]);
  }
  __syncthreads();
  // inc[d][e] = sum_t q_eff[t][d] do[t][e]: warp w owns rows 16 (w % 4)
  // and columns 32 (w / 4) of the 64 x 64 increment
  const int rd = warp % 4, eg = warp / 4;
  float acc[4][4] = {};
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rd * 16, kc * 16,
            [&](int d, int t) { return qe[t * kQ + d]; });
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t bb[2];
      frag_b(bb, kc * 16, eg * 32 + n * 8,
             [&](int t, int e) { return bf(gb, t * kB + e); });
      mma_a2(acc[n], ab, as, bb);
    }
  }
  float* inc = p.ds_out + bhc * kD * kD;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(inc + (rd * 16 + g4 + 8 * hh) * kD +
                                 eg * 32 + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
}

// (b) bf16: one thread a state entry (b, h, d, e), from the last chunk:
// dS_out of chunk c written over its increment, then dS <- exp(L_last)
// dS + inc; dS_in of chunk 0 is the initial state's gradient.  Four
// chunks' loads are issued before their stores.
__global__ void __launch_bounds__(256)
    linear_attn_bwd_carry_kernel(Args p, int n_chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<size_t>(p.B) * p.H * kD * kD) return;
  const size_t bh = i / (kD * kD), de = i % (kD * kD);
  float g = p.d_state ? p.d_state[i] : 0.f;
  float* buf = p.ds_out + bh * n_chunks * kD * kD + de;
  const float* dec = p.decay + bh * n_chunks * kD + de / kD;
  for (int c0 = n_chunks - 1; c0 >= 0; c0 -= 4) {
    float x[4], dc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      x[j] = c >= 0 ? buf[static_cast<size_t>(c) * kD * kD] : 0.f;
      dc[j] = c >= 0 ? dec[c * kD] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      if (c < 0) break;
      buf[static_cast<size_t>(c) * kD * kD] = g;
      g = dc[j] * g + x[j];
    }
  }
  p.d_s0[i] = g;
}

// (c) bf16's shared memory at chunk C: r, k, v, do in bf16 (C x kB each);
// L and E (C x kQ fp32 each), the first L's rows w until the cumulative
// sum; X, A then dA (C x kQ); Z, S_in then dS_out (64 x kQ); u, the
// u-diagonal, do . v, the S_in term of dw, and two column sums per row
// tile (k dks, r k do.v)
template <int C>
struct GradTC {
  static constexpr int RT = C / 16;        // row tiles of the chunk
  static constexpr int NCG = 8 / RT;       // column groups of the 64
  static constexpr int CW = kD / NCG;      // columns of a group
  static constexpr int NT = CW / 8;        // 8-column tiles of a warp
  static constexpr int NS = C / kSub;      // sub-chunks
  static constexpr int NPAIR = NS * (NS - 1) / 2;
  static constexpr size_t bytes =
      sizeof(bf16) * 4 * static_cast<size_t>(C) * kB +
      sizeof(float) * (3 * static_cast<size_t>(C) * kQ +
                       static_cast<size_t>(kD) * kQ + 4 * kD +
                       2 * static_cast<size_t>(RT) * kD);
};

// off-diagonal block p -> (i, j), i > j: p = i (i - 1) / 2 + j
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int a = 1;
  while ((a + 1) * a / 2 <= p) ++a;
  *i = a;
  *j = p - a * (a - 1) / 2;
}

// (c) bf16: grid (n_chunks, H, B).  Warp w owns rows 16 (w % RT) .. + 15
// and columns CW (w / RT) .. of each of dr, dk and dv, whose fp32
// accumulators stay in its registers through every phase.
template <int C>
__global__ void __launch_bounds__(kTC, 2)
    linear_attn_bwd_chunk_tc_kernel(Args p) {
  using L = GradTC<C>;
  constexpr int NT = L::NT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int rt = warp % L::RT, col0 = (warp / L::RT) * L::CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rb = reinterpret_cast<bf16*>(smem_raw);
  bf16* kb = rb + C * kB;
  bf16* vb = kb + C * kB;
  bf16* gb = vb + C * kB;                          // do
  float* ls = reinterpret_cast<float*>(gb + C * kB);  // w, then L
  float* xs = ls + C * kQ;                         // E = L - w
  float* xa = xs + C * kQ;                         // A, then dA
  float* zs = xa + C * kQ;                         // S_in, then dS_out
  float* us = zs + kD * kQ;                        // u
  float* dg = us + kD;                             // r[t] . (u * k[t])
  float* dov = dg + kD;                            // do[t] . v[t]
  float* col = dov + kD;                           // dw's S_in term
  float* kd_red = col + kD;                        // sum_t k dks, per tile
  float* du_red = kd_red + L::RT * kD;             // sum_t r k do.v

  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  load_bf16_rows(rb, static_cast<const bf16*>(p.r), p, b, t0, h, C);
  load_bf16_rows(kb, static_cast<const bf16*>(p.k), p, b, t0, h, C);
  load_bf16_rows(vb, static_cast<const bf16*>(p.v), p, b, t0, h, C);
  load_bf16_rows(gb, static_cast<const bf16*>(p.dout), p, b, t0, h, C);
  load_f32_rows(ls, p.w, p, b, t0, h, C);
  const float* s_in = p.states + bhc * kD * kD;
  const float* s_out = p.ds_out + bhc * kD * kD;
  for (int i = tid; i < kD * (kD / 4); i += kTC)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_in + i * 4, true);
  tc::cp_async_commit();
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // the cumulative log-decay, one thread a channel; the u-diagonal and
  // do . v on the next threads meanwhile
  if (tid < kD) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = ls[t * kQ + tid];
      acc += wv;
      ls[t * kQ + tid] = acc;
      xs[t * kQ + tid] = acc - wv;
    }
  } else if (tid < kD + C) {
    const int t = tid - kD;
    float s = 0.f;
    for (int d = 0; d < kD; ++d)
      s += bf(rb, t * kB + d) * us[d] * bf(kb, t * kB + d);
    dg[t] = s;
  } else if (tid < kD + 2 * C) {
    const int t = tid - kD - C;
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += bf(gb, t * kB + e) * bf(vb, t * kB + e);
    dov[t] = s;
  }
  __syncthreads();
  auto at_l = [&](int t, int d) { return ls[t * kQ + d]; };
  auto at_e = [&](int t, int d) { return xs[t * kQ + d]; };
  const float* l_last = ls + (C - 1) * kQ;

  // A's diagonal sub-blocks pairwise (zero on and above the diagonal) and
  // its off-diagonal blocks factored through L at the end of the earlier
  // sub-chunk, both factors <= 1, as the forward builds A
  constexpr int kSubPairs = kSub * (kSub - 1) / 2;
  for (int i = tid; i < C * C; i += kTC) {
    const int t = i / C, s = i % C;
    if (s >= t) xa[t * kQ + s] = 0.f;
  }
  for (int pi = tid; pi < L::NS * kSubPairs; pi += kTC) {
    const int sb = pi / kSubPairs, q = pi % kSubPairs;
    int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    while (tt * (tt - 1) / 2 > q) --tt;
    while (tt * (tt + 1) / 2 <= q) ++tt;
    const int t = sb * kSub + tt, s = sb * kSub + q - tt * (tt - 1) / 2;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d)
      a += bf(rb, t * kB + d) * bf(kb, s * kB + d) *
           fex(fminf(at_e(t, d) - at_l(s, d), 0.f));
    xa[t * kQ + s] = a;
  }
  if (warp < L::NPAIR) {
    int bi, bj;
    pair_of(warp, &bi, &bj);
    const float* ref = ls + (bj * kSub + kSub - 1) * kQ;
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      uint32_t ab[4], as[4];
      frag_a2(ab, as, bi * kSub, kc * 16, [&](int t, int d) {
        return bf(rb, t * kB + d) * fex(fminf(at_e(t, d) - ref[d], 0.f));
      });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bb[2], bs[2];  // B[d][s] = k[s][d] exp(L_ref - L[s])
        frag_b2(bb, bs, kc * 16, bj * kSub + nt * 8, [&](int d, int s) {
          return bf(kb, s * kB + d) * fex(fminf(ref[d] - at_l(s, d), 0.f));
        });
        mma_ab2(acc[nt], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(bi * kSub + g4 + 8 * (e >> 1)) * kQ + bj * kSub + nt * 8 +
           2 * t4 + (e & 1)] = acc[nt][e];
  }

  // the state term of dr: exp(E) (do S_in^T), S_in^T's fp32 in two parts
  float dr[NT][4] = {}, dk[NT][4] = {};
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, rt * 16, kc * 16,
           [&](int t, int e) { return bf(gb, t * kB + e); });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];  // B[e][d] = S_in[d][e]
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int e, int d) { return zs[d * kQ + e]; });
      mma_b2(dr[n], a, bb, bs);
    }
  }
  // the thread's elements: rows rt*16 + g4 + 8 hh, columns col0 + 8 n +
  // 2 t4 + (e & 1)
  auto row_of = [&](int e) { return rt * 16 + g4 + 8 * (e >> 1); };
  auto col_of = [&](int n, int e) { return col0 + n * 8 + 2 * t4 + (e & 1); };
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dr[n][e] *= fex(at_e(row_of(e), col_of(n, e)));
  __syncthreads();  // S_in read: dS_out takes its place; A complete

  for (int i = tid; i < kD * (kD / 4); i += kTC)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_out + i * 4, true);
  tc::cp_async_commit();
  // dw's S_in term at the chunk's end, exp(L_last) sum_e dS_out S_in per
  // channel, read from device memory: four threads a channel
  {
    const int d = tid / 4, part = tid % 4;
    float x = 0.f;
    if (d < kD) {
#pragma unroll
      for (int e = part * 16; e < part * 16 + 16; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s_in + d * kD + e);
        const float4 o = *reinterpret_cast<const float4*>(s_out + d * kD + e);
        x += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0 && d < kD) col[d] = fex(l_last[d]) * x;
  }
  // dv = A^T do (A's fp32 in two parts; tiles of t on or below s's) ...
  float dv[NT][4] = {};
  for (int kc = rt; kc < L::RT; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, kc * 16,
            [&](int s, int t) { return xa[t * kQ + s]; });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2];
      frag_b(bb, kc * 16, col0 + n * 8,
             [&](int t, int e) { return bf(gb, t * kB + e); });
      mma_a2(dv[n], ab, as, bb);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // dS_out landed
  // ... + k2 dS_out, k2 = k exp(L_last - L), both in two parts
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, kc * 16, [&](int s, int f) {
      return bf(kb, s * kB + f) * fex(l_last[f] - at_l(s, f));
    });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int f, int e) { return zs[f * kQ + e]; });
      mma_ab2(dv[n], ab, as, bb, bs);
    }
  }
  // dv is complete with its u-diagonal: written now, its registers freed
  bf16* dv_o = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      const float g = dg[t];
      if (t0 + t < p.S)
        *reinterpret_cast<uint32_t*>(dv_o + tok(p, b, t0 + t, h) + d) =
            tc::pack_bf16(dv[n][2 * hh] + g * bf(gb, t * kB + d),
                          dv[n][2 * hh + 1] + g * bf(gb, t * kB + d + 1));
    }
  // the state term of dk, dks = exp(L_last - L) (v dS_out^T)
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, rt * 16, kc * 16,
           [&](int s, int e) { return bf(vb, s * kB + e); });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];  // B[e][d] = dS_out[d][e]
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int e, int d) { return zs[d * kQ + e]; });
      mma_b2(dk[n], a, bb, bs);
    }
  }
  // the column sums of k dks and of r k (do . v) over the warp's 16 rows
  // (a fixed order: the quad's rows by shuffles, then the row tiles)
  float kd[NT][2], rk[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      kd[n][x] = rk[n][x] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 2 * hh + x, t = row_of(e), d = col_of(n, e);
        dk[n][e] *= fex(l_last[d] - at_l(t, d));
        kd[n][x] += bf(kb, t * kB + d) * dk[n][e];
        rk[n][x] += bf(rb, t * kB + d) * bf(kb, t * kB + d) * dov[t];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        kd[n][x] += __shfl_xor_sync(0xffffffffu, kd[n][x], off);
        rk[n][x] += __shfl_xor_sync(0xffffffffu, rk[n][x], off);
      }
      if (g4 == 0) {
        kd_red[rt * kD + col_of(n, x)] = kd[n][x];
        du_red[rt * kD + col_of(n, x)] = rk[n][x];
      }
    }
  __syncthreads();  // A read: dA takes its place

  // dA = do v^T, the tiles on and below the diagonal (exact bf16 operands)
  for (int tile = warp; tile < L::RT * (L::RT + 1) / 2; tile += kTC / 32) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    const int tj = tile - ti * (ti + 1) / 2;
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      uint32_t a[4];
      frag_a(a, ti * 16, kc * 16,
             [&](int t, int e) { return bf(gb, t * kB + e); });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bb[2];  // B[e][s] = v[s][e]
        frag_b(bb, kc * 16, tj * 16 + nt * 8,
               [&](int e, int s) { return bf(vb, s * kB + e); });
        tc::mma_bf16(acc[nt], a, bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(ti * 16 + g4 + 8 * (e >> 1)) * kQ + tj * 16 + nt * 8 + 2 * t4 +
           (e & 1)] = acc[nt][e];
  }
  __syncthreads();

  // the decayed intra-chunk products of dr and dk: the diagonal sub-blocks
  // pairwise, one channel a lane (warp w: sub-chunk w % RT, the channels
  // of its column group), each pair's exponential serving both dr (row t)
  // and dk (row s); the sums reach the fragments' owners through zs, free
  // since dS_out's last product ...
  {
    const int b0 = (warp % L::RT) * kSub, d = col0 + lane;
    const bool on = lane < L::CW;
    float dra[kSub] = {}, dka[kSub] = {};
    if (on) {
      float lr[kSub], kr[kSub];
#pragma unroll
      for (int x = 0; x < kSub; ++x) {
        lr[x] = at_l(b0 + x, d);
        kr[x] = bf(kb, (b0 + x) * kB + d);
      }
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt) {
        const float et = at_e(b0 + tt, d), rv = bf(rb, (b0 + tt) * kB + d);
        const float* da = xa + (b0 + tt) * kQ + b0;
#pragma unroll
        for (int ss = 0; ss < tt; ++ss) {
          const float e = fex(fminf(et - lr[ss], 0.f)) * da[ss];
          dra[tt] += kr[ss] * e;
          dka[ss] += rv * e;
        }
      }
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dra[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dr[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
    __syncthreads();
    if (on) {
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dka[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
  }
  // ... and the off-diagonal blocks through L_ref at the end of sub-chunk
  // j: dr's rows (sub-chunk rt) over each earlier j, dA (two parts) times
  // k exp(L_ref - L) (two parts), then times exp(E - L_ref) ...
  for (int j = 0; j < rt; ++j) {
    const float* ref = ls + (j * kSub + kSub - 1) * kQ;
    float tmp[NT][4] = {};
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, j * 16,
            [&](int t, int s) { return xa[t * kQ + s]; });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      frag_b2(bb, bs, j * 16, col0 + n * 8, [&](int s, int d) {
        return bf(kb, s * kB + d) * fex(fminf(ref[d] - at_l(s, d), 0.f));
      });
      mma_ab2(tmp[n], ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dr[n][e] += fex(fminf(at_e(row_of(e), d) - ref[d], 0.f)) * tmp[n][e];
      }
  }
  // ... dk's rows (sub-chunk rt) over each later i: dA^T times r exp(E -
  // L_ref), then times exp(L_ref - L)
  if (rt + 1 < L::RT) {
    const float* ref = ls + (rt * kSub + kSub - 1) * kQ;
    float tmp[NT][4] = {};
    for (int i = rt + 1; i < L::RT; ++i) {
      uint32_t ab[4], as[4];
      frag_a2(ab, as, rt * 16, i * 16,
              [&](int s, int t) { return xa[t * kQ + s]; });
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2], bs[2];
        frag_b2(bb, bs, i * 16, col0 + n * 8, [&](int t, int d) {
          return bf(rb, t * kB + d) * fex(fminf(at_e(t, d) - ref[d], 0.f));
        });
        mma_ab2(tmp[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dk[n][e] += fex(fminf(ref[d] - at_l(row_of(e), d), 0.f)) * tmp[n][e];
      }
  }

  // dr and dk with their u-terms; dw's parts
  bf16* dr_o = static_cast<bf16*>(p.dr);
  bf16* dk_o = static_cast<bf16*>(p.dk);
  float ge[NT][4], gl[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      const float rt_ = bf(rb, t * kB + d), kt = bf(kb, t * kB + d);
      const float bonus = us[d] * dov[t];
      ge[n][e] = rt_ * dr[n][e];
      gl[n][e] = -kt * dk[n][e];
      dr[n][e] += bonus * kt;
      dk[n][e] += bonus * rt_;
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      if (t0 + t >= p.S) continue;
      const size_t o = tok(p, b, t0 + t, h) + d;
      *reinterpret_cast<uint32_t*>(dr_o + o) =
          tc::pack_bf16(dr[n][2 * hh], dr[n][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dk_o + o) =
          tc::pack_bf16(dk[n][2 * hh], dk[n][2 * hh + 1]);
    }
  __syncthreads();  // L and E read: they take gL and gE + gL
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      ls[t * kQ + d] = gl[n][e];
      xs[t * kQ + d] = ge[n][e] + gl[n][e];
    }
  __syncthreads();
  if (tid < kD) {  // dw down channel tid, from the chunk's end; du's partial
    const int d = tid;
    float last = col[d], du = 0.f;
    for (int r = 0; r < L::RT; ++r) {
      last += kd_red[r * kD + d];
      du += du_red[r * kD + d];
    }
    float acc = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      const float add = t == C - 1 ? last : 0.f;
      if (t0 + t < p.S)
        p.dw[tok(p, b, t0 + t, h) + d] = acc + ls[t * kQ + d] + add;
      acc += xs[t * kQ + d] + add;
    }
    if (p.du_part) p.du_part[bhc * kD + d] = du;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// fp32: the reverse scan, the gradient pass, du's sum
template <int C>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int n_chunks = (a.S + C - 1) / C;
  linear_attn_bwd_scan_kernel<float, C>
      <<<dim3(kSlices, a.H, a.B), kScanThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = Grad<C>::floats * sizeof(float);
  auto chunk = linear_attn_bwd_chunk_kernel<float, C>;
  e = allow_smem(chunk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk<<<dim3(n_chunks, a.H, a.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16: each chunk's increment, the carry of dS, the gradient pass
template <int C>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const int n_chunks = (a.S + C - 1) / C;
  const dim3 grid(n_chunks, a.H, a.B);
  auto inc = linear_attn_bwd_inc_kernel<C>;
  size_t smem = inc_smem_bytes<C>();
  cudaError_t e = allow_smem(inc, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  inc<<<grid, kTC, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long entries = static_cast<long>(a.B) * a.H * kD * kD;
  linear_attn_bwd_carry_kernel<<<static_cast<unsigned>((entries + 255) / 256),
                                 256, 0, stream>>>(a, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto chunk = linear_attn_bwd_chunk_tc_kernel<C>;
  smem = GradTC<C>::bytes;
  e = allow_smem(chunk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk<<<grid, kTC, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch(const Args& a, cudaStream_t stream) {
  const int rc = std::is_same<T, bf16>::value ? launch_bf16<C>(a, stream)
                                              : launch_f32<C>(a, stream);
  if (rc != 0 || a.u == nullptr) return rc;
  linear_attn_bwd_du_kernel<<<a.H, kD, 0, stream>>>(
      a.du_part, a.du, a.B, a.H, (a.S + C - 1) / C);
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

// dtype of r, k, v, do, dr, dk and dv: 0 float32, 1 bfloat16.  u, du and
// du_part are null together (no bonus); d_state may be null (zero).
// states: the S_in the forward's scan wrote for the same operands and
// chunk.  ds_out, decay and du_part: the wrapper's fp32 scratch (see the
// header).  Returns the CUDA error code of the launches (0 on success);
// the wrapper raises on anything else.
extern "C" int linear_attn_chunk_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* states, const void* dout, const void* d_state, void* dr,
    void* dk, void* dv, void* dw, void* du, void* d_s0, void* ds_out,
    void* decay, void* du_part, int B, int S, int H, int chunk, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (u == nullptr) != (du == nullptr) ||
      (u == nullptr) != (du_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r,
         k,
         v,
         static_cast<const float*>(w),
         static_cast<const float*>(u),
         static_cast<const float*>(states),
         dout,
         static_cast<const float*>(d_state),
         dr,
         dk,
         dv,
         static_cast<float*>(dw),
         static_cast<float*>(du),
         static_cast<float*>(d_s0),
         static_cast<float*>(ds_out),
         static_cast<float*>(decay),
         static_cast<float*>(du_part),
         B,
         S,
         H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunk<float>(a, chunk, s);
    case 1: return launch_chunk<bf16>(a, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
