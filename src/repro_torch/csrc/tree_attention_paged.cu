// Paged tree-verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
//   src/repro/kernels/tree_attention/kernel.py::tree_attention_paged
//   (-> attention_template/kernel.py::tree_attention_template with
//    TemplateSpec(kind="tree", layout="paged")).
//
// What it computes: T tree queries per (b, query head) attend to the
// slot's committed K/V, read block by block from the global pool
// (N, bs, Hkv, D) through block_table[b, j], plus the T tree K/V under the
// (T, T) ancestor mask.  Cache positions >= cache_len[b] are masked; table
// entries that are NULL (block 0) or start at/after cache_len[b] are
// skipped outright, so whatever the NULL block holds (NaN, inf, garbage
// from dead rows) can never reach the output.  fp32 online softmax with
// the template's conventions: masked score -1e30, denominator floor 1e-30.
//
// Layout: every tensor is in the model layout the wrapper receives,
//   q, out       (B, T, Hq, D)     tree_k, tree_v  (B, T, Hkv, D)
//   pool_k/v     (N, bs, Hkv, D)   tree_mask (T, T) uint8
//   cache_len    (B,) int32        block_table (B, M) int32
// contiguous; q, pools, tree K/V and out share one type, fp32 or bf16.
//
// Design (first, simple version): the TPU's sequential grid axis over
// table entries becomes a loop inside one thread block per (b, kv head).
// The block holds the G*T query rows that share that kv head (query head
// h*G + g, tree token t -> row g*T + t) as fp32 in shared memory, so each
// K/V block is read from device memory once per kv head, not once per
// query head.  Keys stream through shared memory in tiles of 16; each
// tile does scores -> per-row online softmax -> accumulate, with the
// accumulator in registers (thread = one feature column d, a strided set
// of rows).
//
// Bound: bytes.  The work must move
//   sum_b ceil(len_b / bs) * bs * Hkv * D * 2 * elt + q + tree K/V + out
// bytes; at minitron-4b shapes (B=4, Hq=24, Hkv=8, D=128, T=16) that is a
// few MB per call against ~0.2 GFLOP, far below the tensor cores' ratio.
// This version does its arithmetic on the fp32 CUDA cores, and each block
// walks its slot's key tiles one after another, so a call lasts as long as
// the longest slot's chain of tiles: it is far from that bound.  Splitting
// the cache sweep across blocks, wgmma and TMA are later work.
//
// Measurement builds (never used by the wrapper):
//   -DK1_MAX_ROWS=n      size the per-thread accumulator for n rows, not 128;
//   -DK1_PHASE_CLOCKS    thread 0 of each block sums clock64() cycles per
//                        phase (prologue, K/V load, scores, softmax,
//                        accumulate, epilogue) and counts key tiles; read
//                        them with k1_phase_clocks().  See
//                        repro_torch/kernels/tree_attention/phases.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K1_MAX_ROWS
#define K1_MAX_ROWS 128
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = K1_MAX_ROWS;  // G * T query rows per (b, kv head)
constexpr int kKeyTile = 16;    // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

enum Phase { kPrologue, kLoad, kScore, kSoftmax, kAccum, kEpilogue, kPhases };
#ifdef K1_PHASE_CLOCKS
constexpr int kClockBlocks = 4096;           // thread blocks recorded
constexpr int kClockSlots = kPhases + 1;     // phase cycles, then tile count
__device__ long long g_clocks[kClockBlocks * kClockSlots];
__shared__ long long clk_s[kClockSlots + 1];  // + the last timestamp
// thread 0 charges the cycles since the previous mark to phase `ph`
#define K1_MARK(ph)                                \
  do {                                             \
    if (threadIdx.x == 0) {                        \
      const long long t_ = clock64();              \
      clk_s[ph] += t_ - clk_s[kClockSlots];        \
      clk_s[kClockSlots] = t_;                     \
    }                                              \
  } while (0)
#else
#define K1_MARK(ph) \
  do {              \
  } while (0)
#endif

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
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const void* tree_k;
  const void* tree_v;
  const uint8_t* tree_mask;
  const int* cache_len;
  const int* block_table;
  void* out;
  int B, n_tree, Hq, Hkv, bs, M;
  float scale;
};

// One key tile: scores, online-softmax update, accumulate.  `n` keys sit
// in k_s/v_s rows [0, n); key kk of row r is admitted iff
// `admit(r, kk)`.  Rejected keys are excluded by selection (score -1e30,
// weight 0 selected, never multiplied in), so their values are never
// combined with anything.
template <int D, int KMAX, typename Admit>
__device__ __forceinline__ void tile_update(
    int R, int n, const float* q_s, const float* k_s, const float* v_s,
    float* s_s, float* m_s, float* l_s, float* c_s, float (&acc)[KMAX],
    Admit admit) {
  constexpr int DP = D + 1;
  constexpr int NRG = kThreads / D;
  for (int i = threadIdx.x; i < R * n; i += kThreads) {
    const int r = i / n, kk = i % n;
    float s = kNegInf;
    if (admit(r, kk)) {
      s = 0.f;
      const float* qr = q_s + r * DP;
      const float* kr = k_s + kk * DP;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
    }
    s_s[r * kKeyTile + kk] = s;
  }
  __syncthreads();
  K1_MARK(kScore);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float m_prev = m_s[r];
    float m_new = m_prev;
    for (int kk = 0; kk < n; ++kk) m_new = fmaxf(m_new, s_s[r * kKeyTile + kk]);
    float sum = 0.f;
    for (int kk = 0; kk < n; ++kk) {
      const float p = admit(r, kk) ? expf(s_s[r * kKeyTile + kk] - m_new) : 0.f;
      s_s[r * kKeyTile + kk] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    l_s[r] = l_s[r] * corr + sum;
    m_s[r] = m_new;
    c_s[r] = corr;
  }
  __syncthreads();
  K1_MARK(kSoftmax);
  const int d = threadIdx.x % D;
  const int rg = threadIdx.x / D;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int r = rg + k * NRG;
    if (r < R) acc[k] *= c_s[r];
  }
  for (int kk = 0; kk < n; ++kk) {
    const float v = v_s[kk * DP + d];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int r = rg + k * NRG;
      if (r < R && admit(r, kk)) acc[k] += s_s[r * kKeyTile + kk] * v;
    }
  }
  __syncthreads();  // the next tile overwrites k_s, v_s and s_s
  K1_MARK(kAccum);
#ifdef K1_PHASE_CLOCKS
  if (threadIdx.x == 0) clk_s[kPhases] += 1;
#endif
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    tree_attention_paged_kernel(Args p) {
  constexpr int DP = D + 1;  // padded row stride: conflict-free row reads
  constexpr int NRG = kThreads / D;
  constexpr int KMAX = kMaxRows / NRG;
  const int b = blockIdx.x / p.Hkv;
  const int h = blockIdx.x % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int T_ = p.n_tree;
  const int R = G * T_;

  extern __shared__ float smem[];
  float* q_s = smem;                  // R x DP
  float* k_s = q_s + R * DP;          // kKeyTile x DP
  float* v_s = k_s + kKeyTile * DP;   // kKeyTile x DP
  float* s_s = v_s + kKeyTile * DP;   // R x kKeyTile
  float* m_s = s_s + R * kKeyTile;    // R running max
  float* l_s = m_s + R;               // R running denominator
  float* c_s = l_s + R;               // R correction of the current tile

  const T* q = static_cast<const T*>(p.q);
  const T* pool_k = static_cast<const T*>(p.pool_k);
  const T* pool_v = static_cast<const T*>(p.pool_v);
  const T* tree_k = static_cast<const T*>(p.tree_k);
  const T* tree_v = static_cast<const T*>(p.tree_v);
#ifdef K1_PHASE_CLOCKS
  if (threadIdx.x == 0) {
    for (int i = 0; i < kClockSlots; ++i) clk_s[i] = 0;
    clk_s[kClockSlots] = clock64();
  }
#endif

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / T_, t = r % T_;
    const size_t off = ((static_cast<size_t>(b) * T_ + t) * p.Hq + h * G + g) * D + d;
    q_s[r * DP + d] = to_f32(q[off]) * p.scale;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  __syncthreads();
  K1_MARK(kPrologue);

  // cache sweep: table entries below cache_len, NULL entries skipped
  const int len = p.cache_len[b];
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  auto all_keys = [](int, int) { return true; };
  for (int j = 0; j < p.M && j * p.bs < len; ++j) {
    const int blk = table[j];
    if (blk == 0) continue;  // uniform across the block: no divergence
    for (int k0 = 0; k0 < p.bs; k0 += kKeyTile) {
      const int pos0 = j * p.bs + k0;
      if (pos0 >= len) break;
      // only positions < cache_len are loaded and scored
      const int n = min(min(kKeyTile, p.bs - k0), len - pos0);
      for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int kk = i / D, d = i % D;
        const size_t off =
            ((static_cast<size_t>(blk) * p.bs + k0 + kk) * p.Hkv + h) * D + d;
        k_s[kk * DP + d] = to_f32(pool_k[off]);
        v_s[kk * DP + d] = to_f32(pool_v[off]);
      }
      __syncthreads();
      K1_MARK(kLoad);
      tile_update<D, KMAX>(R, n, q_s, k_s, v_s, s_s, m_s, l_s, c_s, acc,
                           all_keys);
    }
  }

  // tree step: the T new K/V under the ancestor mask
  for (int k0 = 0; k0 < T_; k0 += kKeyTile) {
    const int n = min(kKeyTile, T_ - k0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const size_t off =
          ((static_cast<size_t>(b) * T_ + k0 + kk) * p.Hkv + h) * D + d;
      k_s[kk * DP + d] = to_f32(tree_k[off]);
      v_s[kk * DP + d] = to_f32(tree_v[off]);
    }
    __syncthreads();
    K1_MARK(kLoad);
    const uint8_t* tm = p.tree_mask;
    auto ancestor = [tm, T_, k0](int r, int kk) {
      return tm[(r % T_) * T_ + k0 + kk] != 0;
    };
    tile_update<D, KMAX>(R, n, q_s, k_s, v_s, s_s, m_s, l_s, c_s, acc,
                         ancestor);
  }

  T* out = static_cast<T*>(p.out);
  const int d = threadIdx.x % D;
  const int rg = threadIdx.x / D;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int r = rg + k * NRG;
    if (r < R) {
      const int g = r / T_, t = r % T_;
      const size_t off = ((static_cast<size_t>(b) * T_ + t) * p.Hq + h * G + g) * D + d;
      out[off] = from_f32<T>(acc[k] / fmaxf(l_s[r], 1e-30f));
    }
  }
#ifdef K1_PHASE_CLOCKS
  __syncthreads();
  K1_MARK(kEpilogue);
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks)
    for (int i = 0; i < kClockSlots; ++i)
      g_clocks[blockIdx.x * kClockSlots + i] = clk_s[i];
#endif
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const int R = (a.Hq / a.Hkv) * a.n_tree;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(R) * (D + 1) + 2 * kKeyTile * (D + 1) +
                       static_cast<size_t>(R) * kKeyTile + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_attention_paged_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tree_attention_paged_kernel<T, D>
      <<<a.B * a.Hkv, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the CUDA error code of
// the launch (0 on success); the wrapper raises on anything else.
extern "C" int tree_attention_paged(
    const void* q, const void* pool_k, const void* pool_v, const void* tree_k,
    const void* tree_v, const void* tree_mask, const void* cache_len,
    const void* block_table, void* out, int B, int T, int Hq, int Hkv, int D,
    int bs, int M, int dtype, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Hq / Hkv) * T > kMaxRows || bs <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, pool_k, pool_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), out, B, T, Hq, Hkv, bs, M,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(a, D, s);
    case 1: return launch_dim<__nv_bfloat16>(a, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef K1_PHASE_CLOCKS
// Copies the last launch's per-block records, (blocks, kPhases + 1) int64,
// into host memory; returns the CUDA error code.
extern "C" int k1_phase_clocks(void* host, int blocks) {
  if (blocks <= 0 || blocks > kClockBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_clocks, sizeof(long long) * blocks * kClockSlots));
}
#endif
