// Device code shared by the fp32 bodies of the port's attention kernels:
//   tree_attention_paged.cu  (K1 paged tree verify, K4 windowed, K2 dense)
//   flash_attention.cu       (K3 prefill attention)
// (their bf16 bodies run on the tensor cores: attention_mma.cuh), and the
// constants and conversions mla_attention_paged.cu (K5) takes from here.
//
// One key tile of the fp32 online softmax, with the conventions of the
// Pallas template (src/repro/kernels/attention_template/kernel.py::
// _softmax_update): masked score -1e30, the denominator floored at 1e-30
// in the caller's epilogue, excluded keys removed by selection.
//
// A thread block holds R query rows as fp32 in shared memory (row stride
// D + 1, so row reads are free of bank conflicts); keys stream through
// shared memory kKeyTile at a time.  Thread t owns feature column
// d = t % D of rows rg, rg + NRG, ... (rg = t / D, NRG = kThreads / D), so
// its accumulator holds rows / NRG values in registers.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace attn {

constexpr int kThreads = 256;      // threads per block
constexpr int kKeyTile = 16;       // keys per shared-memory tile
constexpr float kNegInf = -1e30f;  // masked score

// Rows a block may hold at head dim D, given the cap for D <= 128.  At
// D = 256 a thread owns one column of every row, so the rows are capped
// at 64: 64 accumulator registers, as D = 128 has at 128 rows.
__host__ __device__ constexpr int max_rows(int D, int cap) {
  return D >= 256 && cap > 64 ? 64 : cap;
}

// Shared memory for R rows at head dim D: q (R x D+1), the K and V tiles
// (kKeyTile x D+1 each), scores (R x kKeyTile), running max, denominator
// and correction (R each) as floats, then R ints of row positions.
__host__ __device__ constexpr size_t smem_bytes(int R, int D) {
  return sizeof(float) * (static_cast<size_t>(R) * (D + 1) +
                          2 * static_cast<size_t>(kKeyTile) * (D + 1) +
                          static_cast<size_t>(R) * kKeyTile +
                          3 * static_cast<size_t>(R)) +
         sizeof(int) * static_cast<size_t>(R);
}

struct Smem {
  float* q;    // R x (D+1) query rows, pre-scaled
  float* k;    // kKeyTile x (D+1)
  float* v;    // kKeyTile x (D+1)
  float* s;    // R x kKeyTile scores, then weights
  float* m;    // R running max
  float* l;    // R running denominator
  float* c;    // R correction of the current tile
  int* pos;    // R absolute query positions
};

template <int D>
__device__ __forceinline__ Smem carve_smem(float* base, int R) {
  constexpr int DP = D + 1;
  Smem sm;
  sm.q = base;
  sm.k = sm.q + R * DP;
  sm.v = sm.k + kKeyTile * DP;
  sm.s = sm.v + kKeyTile * DP;
  sm.m = sm.s + R * kKeyTile;
  sm.l = sm.m + R;
  sm.c = sm.l + R;
  sm.pos = reinterpret_cast<int*>(sm.c + R);
  return sm;
}

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

// One key tile: scores, online-softmax update, accumulate.  `n` keys sit
// in sm.k / sm.v rows [0, n); key kk is admitted for row r iff
// `admit(r, kk)`.  A rejected key gets score -1e30 (its K is never read)
// and a weight selected to exactly 0, and the accumulate adds p * v for
// every key, as the template's p @ v does.  So the caller must load only
// finite values: it never loads a key of a NULL block or past cache_len,
// and loads a key out of every row's window as zeros (selection at load),
// so NaN or inf in such places cannot leak.
template <int D, int KMAX, typename Admit>
__device__ __forceinline__ void tile_update(int R, int n, const Smem& sm,
                                            float (&acc)[KMAX], Admit admit) {
  constexpr int DP = D + 1;
  constexpr int NRG = kThreads / D;
  for (int i = threadIdx.x; i < R * n; i += kThreads) {
    const int r = i / n, kk = i % n;
    float s = kNegInf;
    if (admit(r, kk)) {
      s = 0.f;
      const float* qr = sm.q + r * DP;
      const float* kr = sm.k + kk * DP;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
    }
    sm.s[r * kKeyTile + kk] = s;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float m_prev = sm.m[r];
    float m_new = m_prev;
    for (int kk = 0; kk < n; ++kk)
      m_new = fmaxf(m_new, sm.s[r * kKeyTile + kk]);
    float sum = 0.f;
    for (int kk = 0; kk < n; ++kk) {
      const float p =
          admit(r, kk) ? expf(sm.s[r * kKeyTile + kk] - m_new) : 0.f;
      sm.s[r * kKeyTile + kk] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    sm.l[r] = sm.l[r] * corr + sum;
    sm.m[r] = m_new;
    sm.c[r] = corr;
  }
  __syncthreads();
  const int d = threadIdx.x % D;
  const int rg = threadIdx.x / D;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int r = rg + k * NRG;
    if (r < R) acc[k] *= sm.c[r];
  }
  for (int kk = 0; kk < n; ++kk) {
    const float v = sm.v[kk * DP + d];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int r = rg + k * NRG;
      if (r < R) acc[k] += sm.s[r * kKeyTile + kk] * v;
    }
  }
  __syncthreads();  // the next tile overwrites sm.k, sm.v and sm.s
}

}  // namespace attn
