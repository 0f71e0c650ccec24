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
// the chunk and lcw_excl = lcw - w:
//   A[t][s]  = sum_d r[t][d] k[s][d] exp(min(lcw_excl[t][d] - lcw[s][d], 0))
//              for s < t (strict lower), pairwise so no exponent is
//              positive, however strong the decay;
//   o[t]     = sum_{s<t} A[t][s] v[s] + (r[t] . (u * k[t])) v[t]
//              + (r[t] * exp(lcw_excl[t])) S;
//   S       <- S * exp(lcw[C-1]) (per row d)
//              + sum_s (k[s] * exp(lcw[C-1] - lcw[s])) v[s]^T.
// Positions at or past S (the sequence length) read as r = k = v = w = 0:
// decay 1 and nothing added, so the state passes them unchanged; this is
// the wrapper's chunk padding, done by the loads with no padded copy.
//
// Layout: r, k, v, o (B, S, H, 64) in one type, fp32 or bf16; w (B, S, H,
// 64) fp32; u (H, 64) fp32 or null; s0 (B, H, 64, 64) fp32 or null (zeros);
// s_out (B, H, 64, 64) fp32.  All contiguous.  dk = dv = 64 (RWKV6's head).
//
// Design (first, simple version): the TPU's sequential chunk axis becomes
// a loop inside one thread block per (b, h); the 64 x 64 fp32 state stays
// in shared memory across chunks.  A chunk's r, k, v and decay tiles are
// staged as fp32 in shared memory (row stride 65, so column walks are free
// of bank conflicts).  One thread per column scans the cumulative decay.
// Each thread computes whole entries A[t][s] by a loop over d, walking the
// strict lower triangle by pair index, so all lanes work; the (C, C, dk)
// tile of pairwise exponentials never exists (on the TPU it was a 1 MiB
// VMEM tile).  Then r and k are rescaled in place to q_eff and k2, and
// each thread owns one column e: the output rows t = rg, rg + 4, ... and
// the state rows d = rg, rg + 4, ... (rg = thread / 64).  No tensor cores,
// no TMA.
//
// Bound: operations.  At S = 1536, B = 1, H = 32 the function needs, over
// its exact forms, at least 0.91 GFLOP in fp32: the chunked form at
// chunk 4 (per token and head 4 dk dv in the state read-out and update,
// dk dv / 4 of state decay, 1.5 pairs x (5 dk + 2 dv), O(dk) for the
// decay and the u-bonus), below the recurrence (chunk 1, 1.03 GFLOP) and
// this kernel's chunk 64 (1.52 GFLOP: 2016 pairs x 64 channels at 5
// operations with the exponential a chunk).  That is 13.5 us at the CUDA
// cores' 67 TFLOP/s (chip_smoke.py's k6_flops / k6_bound).  The bytes
// (r, k, v, o in bf16, w in fp32, the states) are ~39 MB, ~11.6 us at
// 3.35 TB/s.  This version is far from either: a B = 1 prefill fills only
// 32 of the 132 SMs, one 256-thread block each, and every chunk runs its
// phases in series behind barriers; its 9.9e7 pairwise exponentials alone
// take ~27 us on the SFUs (16 per clock per SM, 132 SMs, 1.75 GHz).
// Splitting the dv columns of the state across blocks (each column's
// recurrence is independent) and tensor-core products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // dk = dv
constexpr int kP = kD + 1;     // shared row stride
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kD;  // 4

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  int B, S, H;
};

// Floats of shared memory at chunk length C: five C x kP tiles (r, k, v,
// lcw, lcw_excl), A (C x (C+1)), the state (kD x kP), the diagonal (C)
// and u (kD).
__host__ __device__ constexpr size_t smem_floats(int C) {
  return 5 * static_cast<size_t>(C) * kP + static_cast<size_t>(C) * (C + 1) +
         static_cast<size_t>(kD) * kP + C + kD;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    linear_attn_chunk_kernel(Args p) {
  constexpr int CP = C + 1;
  constexpr int kPairs = C * (C - 1) / 2;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int tid = threadIdx.x;
  const int e = tid % kD;        // column owned in the output/state phases
  const int rg = tid / kD;

  extern __shared__ float smem[];
  float* rs = smem;              // r, then q_eff = r * exp(lcw_excl)
  float* ks = rs + C * kP;       // k, then k2 = k * exp(lcw[C-1] - lcw)
  float* vs = ks + C * kP;
  float* ls = vs + C * kP;       // lcw, inclusive
  float* xs = ls + C * kP;       // w, then lcw_excl = lcw - w
  float* as = xs + C * kP;       // A, strict lower triangle
  float* st = as + C * CP;       // state S[d][e]
  float* dg = st + kD * kP;      // r[t] . (u * k[t])
  float* us = dg + C;            // u

  const T* r = static_cast<const T*>(p.r);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const size_t state_off = static_cast<size_t>(b * p.H + h) * kD * kD;
  const bool use_u = p.u != nullptr;

  for (int i = tid; i < kD * kD; i += kThreads)
    st[(i / kD) * kP + i % kD] = p.s0 ? p.s0[state_off + i] : 0.f;
  if (tid < kD) us[tid] = use_u ? p.u[h * kD + tid] : 0.f;

  const int n_chunks = (p.S + C - 1) / C;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    for (int i = tid; i < C * kD; i += kThreads) {
      const int t = i / kD, d = i % kD;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t0 + t < p.S) {
        const size_t off =
            ((static_cast<size_t>(b) * p.S + t0 + t) * p.H + h) * kD + d;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        wv = p.w[off];
      }
      rs[t * kP + d] = rv;
      ks[t * kP + d] = kv;
      vs[t * kP + d] = vv;
      xs[t * kP + d] = wv;
    }
    __syncthreads();

    // cumulative log-decay, one thread per column; the u-bonus diagonal
    // on the next C threads meanwhile
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
      if (use_u)
        for (int d = 0; d < kD; ++d)
          s += rs[t * kP + d] * us[d] * ks[t * kP + d];
      dg[t] = s;
    }
    __syncthreads();

    // intra-chunk scores over the strict lower triangle: pair index pi
    // -> (t, s) with t (t - 1) / 2 <= pi < t (t + 1) / 2, s = pi - t (t-1)/2
    for (int pi = tid; pi < kPairs; pi += kThreads) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * pi)) * 0.5f);
      while (t * (t - 1) / 2 > pi) --t;
      while (t * (t + 1) / 2 <= pi) ++t;
      const int s = pi - t * (t - 1) / 2;
      const float* rt = rs + t * kP;
      const float* xt = xs + t * kP;
      const float* kr = ks + s * kP;
      const float* lr = ls + s * kP;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d)
        a += rt[d] * kr[d] * expf(fminf(xt[d] - lr[d], 0.f));
      as[t * CP + s] = a;
    }
    __syncthreads();

    for (int i = tid; i < C * kD; i += kThreads) {
      const int t = i / kD, d = i % kD;
      rs[t * kP + d] *= expf(xs[t * kP + d]);
      ks[t * kP + d] *= expf(ls[(C - 1) * kP + d] - ls[t * kP + d]);
    }
    __syncthreads();

    // outputs: column e of rows rg, rg + 4, ...
    for (int t = rg; t < C; t += kRowGroups) {
      float acc = 0.f;
      for (int s = 0; s < t; ++s) acc += as[t * CP + s] * vs[s * kP + e];
      acc += dg[t] * vs[t * kP + e];
      float inter = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) inter += rs[t * kP + d] * st[d * kP + e];
      acc += inter;
      if (t0 + t < p.S)
        o[((static_cast<size_t>(b) * p.S + t0 + t) * p.H + h) * kD + e] =
            from_f32<T>(acc);
    }
    __syncthreads();

    // state update: column e of rows rg, rg + 4, ...
    for (int d = rg; d < kD; d += kRowGroups) {
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < C; ++s) acc += ks[s * kP + d] * vs[s * kP + e];
      st[d * kP + e] = st[d * kP + e] * expf(ls[(C - 1) * kP + d]) + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < kD * kD; i += kThreads)
    p.s_out[state_off + i] = st[(i / kD) * kP + i % kD];
}

template <typename T, int C>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        linear_attn_chunk_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  linear_attn_chunk_kernel<T, C><<<a.B * a.H, kThreads, smem, stream>>>(a);
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
// Returns the CUDA error code of the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int linear_attn_chunk(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_out, int B, int S, int H,
                                 int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
         static_cast<const float*>(s0), o, static_cast<float*>(s_out),
         B, S, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunk<float>(a, chunk, s);
    case 1: return launch_chunk<__nv_bfloat16>(a, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
