// Prefill attention for Hopper (sm_90a), plain C interface: S x S
// attention, causal, with an optional sliding window and GQA.
//
// Replaces the TPU kernel K3
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (-> attention_template/kernel.py::self_attention, TemplateSpec
//    kind="self").
//
// What it computes: for each (b, query head), query position i attends to
// key position k of the same sequence iff (not causal or k <= i) and
// (window <= 0 or i - k < window); query head h*G + g reads kv head h.
// Positions are the sequence indices 0..S-1: the port's prefill passes
// consecutive positions, so the masks depend only on index differences.
// Any S is taken: a ragged last tile is cut by its length (the TPU
// kernel's s_real tail mask), never padded.  fp32 online softmax with the
// template's conventions (online_softmax.cuh).  The window is a runtime
// int, so one build serves gemma3's local (512) and global (0) layers.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q, out (B, S, Hq, D)    k, v (B, S, Hkv, D)
// q, k, v and out share one type, fp32 or bf16; D is 64, 128 or 256.
//
// Design (first, simple version): one thread block per (b, kv head, tile
// of BQ query positions).  The block holds the G*BQ query rows that share
// the kv head (query head h*G + g at position q0 + i -> row g*BQ + i) as
// fp32 in shared memory, so each K/V tile is read once per kv head and
// query tile.  It walks the key tiles the tile's rows can see, 16 keys at
// a time: from max(0, q0 - window + 1) (window > 0) or 0, to the tile's
// last position (causal) or S.  Each row masks keys by its own position.
// BQ is 16, or fewer when G*16 rows would exceed the block's row cap
// (64 at D = 256, 128 below).  The tiles with the longest causal chains
// are launched first.
//
// Bound: operations at the prompt lengths gemma3-1b and minitron-4b
// prefill (S in the hundreds to thousands): 4*D flops per admitted
// (query head, query, key) against q, k, v and out read or written once.
// This version does its arithmetic on the fp32 CUDA cores, one block's
// key tiles one after another: far from that bound.  wgmma tiles, TMA and
// a query offset with kv_valid_len (for chunked prefill) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using attn::from_f32;
using attn::kKeyTile;
using attn::kNegInf;
using attn::kThreads;
using attn::Smem;
using attn::to_f32;

constexpr int kRowCap = 128;  // G * BQ query rows per block (D <= 128)
constexpr int kQTile = 16;    // query positions per block, at most

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, S, Hq, Hkv, bq, causal, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args p) {
  constexpr int DP = D + 1;
  constexpr int NRG = kThreads / D;
  constexpr int KMAX = attn::max_rows(D, kRowCap) / NRG;
  const int G = p.Hq / p.Hkv;
  const int BQ = p.bq;
  const int R = G * BQ;
  const int heads = p.B * p.Hkv;
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hkv;
  const int h = blockIdx.x % p.Hkv;
  const int q0 = qt * BQ;

  extern __shared__ float smem[];
  const Smem sm = attn::carve_smem<D>(smem, R);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / BQ, pos = q0 + r % BQ;
    float x = 0.f;  // rows past S are computed on zeros and never stored
    if (pos < p.S)
      x = to_f32(q[((static_cast<size_t>(b) * p.S + pos) * p.Hq + h * G + g) * D + d]) *
          p.scale;
    sm.q[r * DP + d] = x;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
    sm.pos[r] = q0 + r % BQ;
  }
  float acc[KMAX];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) acc[kk] = 0.f;
  __syncthreads();

  const bool causal = p.causal != 0;
  const int w = p.window;
  const int k_end = causal ? min(q0 + BQ, p.S) : p.S;
  const int k_begin = w > 0 ? max(0, q0 - w + 1) : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeyTile) {
    const int n = min(kKeyTile, k_end - k0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const size_t off = ((static_cast<size_t>(b) * p.S + k0 + kk) * p.Hkv + h) * D + d;
      sm.k[kk * DP + d] = to_f32(k[off]);
      sm.v[kk * DP + d] = to_f32(v[off]);
    }
    __syncthreads();
    auto admit = [sm, causal, w, k0](int r, int kk) {
      const int dq = sm.pos[r] - (k0 + kk);
      return (!causal || dq >= 0) && (w <= 0 || dq < w);
    };
    attn::tile_update<D, KMAX>(R, n, sm, acc, admit);
  }

  T* out = static_cast<T*>(p.out);
  const int d = threadIdx.x % D;
  const int rg = threadIdx.x / D;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    const int r = rg + kk * NRG;
    if (r < R) {
      const int g = r / BQ, pos = q0 + r % BQ;
      if (pos < p.S) {
        const size_t off =
            ((static_cast<size_t>(b) * p.S + pos) * p.Hq + h * G + g) * D + d;
        out[off] = from_f32<T>(acc[kk] / fmaxf(sm.l[r], 1e-30f));
      }
    }
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = attn::smem_bytes((a.Hq / a.Hkv) * a.bq, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (a.S + a.bq - 1) / a.bq;
  flash_attention_kernel<T, D>
      <<<n_qt * a.B * a.Hkv, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; causal: 0 or 1; window <= 0: no window.
// Returns the CUDA error code of the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Hq, int Hkv,
                               int D, int causal, int window, int dtype,
                               float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int fit = attn::max_rows(D, kRowCap) / G;
  const int bq = fit < kQTile ? fit : kQTile;
  if (bq < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, B, S, Hq, Hkv, bq, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(a, D, s);
    case 1: return launch_dim<__nv_bfloat16>(a, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
