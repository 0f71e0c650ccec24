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
// 64, 64) and, with u, du's per-chunk partials (B, H, n_chunks, 64).
//
// Design: three launches, all on the CUDA cores in fp32 (bf16 operands are
// widened as they load), no atomics, so two identical calls give the same
// bits.
//  (b) linear_attn_bwd_scan_kernel, one block per (16 state columns, h,
//      b), walks the chunks from the last: it writes each chunk's dS_out,
//      then dS <- exp(L_last) dS + q_eff^T do, recomputing q_eff =
//      r exp(E) from r and w, and writes dS_in of chunk 0.
//  (c) linear_attn_bwd_chunk_kernel, one block of 16 warps per (chunk, h,
//      b), as the forward's pass: A and dA, the intra-chunk products by
//      secondary chunks of 16 (diagonal blocks pairwise, off-diagonal
//      blocks factored through L at the end of the earlier sub-chunk, each
//      factor <= 1), the u-diagonal, the S_in and dS_out terms; each
//      thread owns C * 64 / 512 (t, channel) elements of dr, dk and dv;
//      dw by a reverse cumulative sum down each channel; du's partial.
//  (d) linear_attn_bwd_du_kernel sums du's partials over b and the chunks
//      in a fixed order (launched only with u).
//
// Bound: bytes.  At rwkv6-1.6b's (1, 1024), 32 heads, bf16, the function
// reads r, k, v, do (bf16) and w (fp32) and writes dr, dk, dv (bf16) and
// dw (fp32): ~46 MB, ~14 us at 3.35 TB/s (the kernel also reads the 8.4 MB
// of states the forward saved, which follow from k, v and w, so the bound
// leaves them out); its least
// products (8 dk dv a token: the gradients of the state's read-out and
// update) are 1.1 GFLOP, ~1 us on the tensor cores.  chip_smoke.py's
// phase 3m prints launch/op_cost.py::k6_bwd_charge.  This first design
// runs its products on the CUDA cores and keeps every tile in shared
// memory (one block an SM), so it sits well above the bound; tensor cores,
// as the forward's pass has, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, int C>
int launch(const Args& a, cudaStream_t stream) {
  const int n_chunks = (a.S + C - 1) / C;
  linear_attn_bwd_scan_kernel<T, C>
      <<<dim3(kSlices, a.H, a.B), kScanThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = Grad<C>::floats * sizeof(float);
  auto chunk = linear_attn_bwd_chunk_kernel<T, C>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk<<<dim3(n_chunks, a.H, a.B), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.u == nullptr) return static_cast<int>(e);
  linear_attn_bwd_du_kernel<<<a.H, kD, 0, stream>>>(a.du_part, a.du, a.B, a.H,
                                                    n_chunks);
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
// chunk.  ds_out and du_part: the wrapper's fp32 scratch (see the header).
// Returns the CUDA error code of the launches (0 on success); the wrapper
// raises on anything else.
extern "C" int linear_attn_chunk_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* states, const void* dout, const void* d_state, void* dr,
    void* dk, void* dv, void* dw, void* du, void* d_s0, void* ds_out,
    void* du_part, int B, int S, int H, int chunk, int dtype, void* stream) {
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
