// Paged tree-verify attention for Hopper (sm_90a), plain C interface, with
// its sliding-window form and its dense-cache form.
//
// Replaces three TPU kernels, all instantiations of
// src/repro/kernels/attention_template/kernel.py::tree_attention_template:
//   K1  tree_attention/kernel.py::tree_attention_paged (layout="paged")
//       -> entry point tree_attention_paged (windowed = false);
//   K4  attention_template/ops.py::tree_attention_paged_windowed_bshd
//       (TemplateSpec windowed=True)
//       -> entry point tree_attention_paged_windowed (windowed = true);
//   K2  tree_attention/kernel.py::tree_attention (layout="dense")
//       -> entry point tree_attention_dense (dense = true).
// As in the template, one kernel body carries all three: `kWindowed` and
// `kDense` are template flags, and a runtime window <= 0 is an exact
// no-op of the mask.
//
// What it computes: T tree queries per (b, query head) attend to the
// slot's committed K/V, read block by block from the global pool
// (N, bs, Hkv, D) through block_table[b, j], plus the T tree K/V under the
// (T, T) ancestor mask.  Cache positions >= cache_len[b] are masked; table
// entries that are NULL (block 0) or start at/after cache_len[b] are
// skipped outright, so whatever the NULL block holds (NaN, inf, garbage
// from dead rows) can never reach the output.  fp32 online softmax with
// the template's conventions (online_softmax.cuh).
//
// Windowed (K4): also q_pos (B, T) int32 absolute query positions and an
// int window w.  With w > 0, row r admits key position k only if
// q_pos[r] - k < w; tree token j sits at position cache_len + j.  Every
// real query row sits at q_pos >= cache_len (verify positions are
// cache_len + depth), so a table entry j whose last position
// (j+1)*bs - 1 <= cache_len - w is out of every row's reach and is skipped
// for the whole block (JAX kernel.py:284-290); inside a block still in
// reach, each row masks keys by its own q_pos, and keys at or behind
// cache_len - w are loaded as zeros (selected, never read from the pool),
// so whatever the pool holds there cannot reach the output.  Pad rows the
// wrapper adds carry q_pos 0 and break the precondition; their outputs are
// sliced away.
//
// Dense (K2): the same math over a per-slot cache (B, S, Hkv, D), the
// port's own layer view of its dense cache, read directly (no block table:
// an identity table could not stand in, since block 0 is NULL).  Keys
// below min(cache_len[b], S) stream in tiles of 16 as in K1; positions at
// or past cache_len are never read, whatever they hold (the tree K/V the
// caller scattered there come in as the tree operands).  No window: dense
// windowed verify has no TPU kernel and stays plain PyTorch.
//
// Layout: every tensor is in the model layout the wrapper receives,
//   q, out       (B, T, Hq, D)     tree_k, tree_v  (B, T, Hkv, D)
//   pool_k/v     (N, bs, Hkv, D)   tree_mask (T, T) uint8
//                (dense: the cache (B, S, Hkv, D))
//   cache_len    (B,) int32        block_table (B, M) int32 (paged only)
//   q_pos        (B, T) int32 (windowed only)
// contiguous; q, pools, tree K/V and out share one type, fp32 or bf16.
// D is 64, 128 or 256.
//
// Design (first, simple version): the TPU's sequential grid axis over
// table entries becomes a loop inside one thread block per (b, kv head).
// The block holds the G*T query rows that share that kv head (query head
// h*G + g, tree token t -> row g*T + t) as fp32 in shared memory, so each
// K/V block is read from device memory once per kv head, not once per
// query head.  Keys stream through shared memory in tiles of 16; each
// tile does scores -> per-row online softmax -> accumulate, with the
// accumulator in registers (thread = one feature column d, a strided set
// of rows).  At D = 256 a block holds at most 64 rows (gemma3-1b: G*T =
// 4*16), so the accumulator stays at 64 registers; its shared memory
// (about 104 KB) goes through the dynamic shared-memory opt-in.
//
// Bound: bytes.  The work must move
//   sum_b (keys read for b) * Hkv * D * 2 * elt + q + tree K/V + out
// bytes, where a windowed call reads at most w + bs keys per slot; at
// minitron-4b and gemma3-1b shapes that is a few MB per call against well
// under a GFLOP, far below the tensor cores' ratio.  This version does
// its arithmetic on the fp32 CUDA cores, and each block walks its slot's
// key tiles one after another, so a call lasts as long as the longest
// slot's chain of tiles: it is far from that bound.  Splitting the cache
// sweep across blocks, wgmma and TMA are later work.
//
// Measurement builds (never used by the wrapper):
//   -DK1_MAX_ROWS=n      cap a block's rows (and so the accumulator) at n,
//                        not 128;
//   -DK1_PHASE_CLOCKS    thread 0 of each block sums clock64() cycles per
//                        phase (prologue, K/V load, scores, softmax,
//                        accumulate, epilogue) and counts key tiles; read
//                        them with k1_phase_clocks().  See
//                        repro_torch/kernels/tree_attention/phases.py.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K1_MAX_ROWS
#define K1_MAX_ROWS 128
#endif

namespace {

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
#define K1_TILE_DONE()                             \
  do {                                             \
    if (threadIdx.x == 0) clk_s[kPhases] += 1;     \
  } while (0)
#else
#define K1_MARK(ph) \
  do {              \
  } while (0)
#define K1_TILE_DONE() \
  do {                 \
  } while (0)
#endif

}  // namespace

#define TILE_MARK(ph) K1_MARK(ph)
#include "online_softmax.cuh"

namespace {

using attn::from_f32;
using attn::kKeyTile;
using attn::kNegInf;
using attn::kThreads;
using attn::Smem;
using attn::to_f32;

constexpr int kRowCap = K1_MAX_ROWS;  // G * T query rows per (b, kv head)

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const void* tree_k;
  const void* tree_v;
  const uint8_t* tree_mask;
  const int* cache_len;
  const int* block_table;
  const int* q_pos;  // windowed only
  void* out;
  int B, n_tree, Hq, Hkv, bs, M, window;
  float scale;
  int S;  // dense only: the cache's length
};

template <typename T, int D, bool kWindowed, bool kDense>
__global__ void __launch_bounds__(kThreads)
    tree_attention_paged_kernel(Args p) {
  static_assert(!(kWindowed && kDense), "no dense windowed form");
  constexpr int DP = D + 1;
  constexpr int NRG = kThreads / D;
  constexpr int KMAX = attn::max_rows(D, kRowCap) / NRG;
  const int b = blockIdx.x / p.Hkv;
  const int h = blockIdx.x % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int T_ = p.n_tree;
  const int R = G * T_;

  extern __shared__ float smem[];
  const Smem sm = attn::carve_smem<D>(smem, R);

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
    sm.q[r * DP + d] = to_f32(q[off]) * p.scale;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
    sm.pos[r] = kWindowed ? p.q_pos[b * T_ + r % T_] : 0;
  }
  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  __syncthreads();
  K1_MARK(kPrologue);

  const int len = kDense ? min(p.cache_len[b], p.S) : p.cache_len[b];
  const int w = kWindowed ? p.window : 0;
  if constexpr (kDense) {
    // cache sweep (dense): the slot's row below cache_len, tile by tile
    for (int pos0 = 0; pos0 < len; pos0 += kKeyTile) {
      const int n = min(kKeyTile, len - pos0);
      for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int kk = i / D, d = i % D;
        const size_t off =
            ((static_cast<size_t>(b) * p.S + pos0 + kk) * p.Hkv + h) * D + d;
        sm.k[kk * DP + d] = to_f32(pool_k[off]);
        sm.v[kk * DP + d] = to_f32(pool_v[off]);
      }
      __syncthreads();
      K1_MARK(kLoad);
      attn::tile_update<D, KMAX>(R, n, sm, acc,
                                 [](int, int) { return true; });
      K1_TILE_DONE();
    }
  } else {
    // cache sweep: table entries below cache_len, NULL entries skipped, and
    // (windowed, w > 0) entries wholly at or behind cache_len - w skipped
    const int* table = p.block_table + static_cast<size_t>(b) * p.M;
    for (int j = 0; j < p.M && j * p.bs < len; ++j) {
      const int blk = table[j];
      if (blk == 0) continue;  // uniform across the block: no divergence
      if (w > 0 && (j + 1) * p.bs - 1 <= len - w) continue;
      for (int k0 = 0; k0 < p.bs; k0 += kKeyTile) {
        const int pos0 = j * p.bs + k0;
        if (pos0 >= len) break;
        // only positions < cache_len are loaded and scored; (windowed)
        // positions at or behind cache_len - w, out of every real row's
        // reach, are loaded as zeros, whatever the pool holds there
        const int n = min(min(kKeyTile, p.bs - k0), len - pos0);
        for (int i = threadIdx.x; i < n * D; i += kThreads) {
          const int kk = i / D, d = i % D;
          float kx = 0.f, vx = 0.f;
          if (w <= 0 || pos0 + kk > len - w) {
            const size_t off =
                ((static_cast<size_t>(blk) * p.bs + k0 + kk) * p.Hkv + h) *
                    D +
                d;
            kx = to_f32(pool_k[off]);
            vx = to_f32(pool_v[off]);
          }
          sm.k[kk * DP + d] = kx;
          sm.v[kk * DP + d] = vx;
        }
        __syncthreads();
        K1_MARK(kLoad);
        auto in_window = [sm, w, pos0](int r, int kk) {
          return w <= 0 || sm.pos[r] - (pos0 + kk) < w;
        };
        attn::tile_update<D, KMAX>(R, n, sm, acc, in_window);
        K1_TILE_DONE();
      }
    }
  }

  // tree step: the T new K/V under the ancestor mask; tree token j sits
  // at position cache_len + j
  for (int k0 = 0; k0 < T_; k0 += kKeyTile) {
    const int n = min(kKeyTile, T_ - k0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const size_t off =
          ((static_cast<size_t>(b) * T_ + k0 + kk) * p.Hkv + h) * D + d;
      sm.k[kk * DP + d] = to_f32(tree_k[off]);
      sm.v[kk * DP + d] = to_f32(tree_v[off]);
    }
    __syncthreads();
    K1_MARK(kLoad);
    const uint8_t* tm = p.tree_mask;
    auto ancestor = [sm, tm, T_, k0, w, len](int r, int kk) {
      return tm[(r % T_) * T_ + k0 + kk] != 0 &&
             (w <= 0 || sm.pos[r] - (len + k0 + kk) < w);
    };
    attn::tile_update<D, KMAX>(R, n, sm, acc, ancestor);
    K1_TILE_DONE();
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
      out[off] = from_f32<T>(acc[k] / fmaxf(sm.l[r], 1e-30f));
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

template <typename T, int D, bool kWindowed, bool kDense>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = attn::smem_bytes((a.Hq / a.Hkv) * a.n_tree, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_attention_paged_kernel<T, D, kWindowed, kDense>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tree_attention_paged_kernel<T, D, kWindowed, kDense>
      <<<a.B * a.Hkv, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWindowed, bool kDense>
int launch_dim(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, kWindowed, kDense>(a, stream);
    case 128: return launch<T, 128, kWindowed, kDense>(a, stream);
    case 256: return launch<T, 256, kWindowed, kDense>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Validates the shape, then launches the instantiation for dtype
// (0 float32, 1 bfloat16) and D.  Returns the CUDA error code.
template <bool kWindowed, bool kDense>
int dispatch(const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.n_tree <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      (a.Hq / a.Hkv) * a.n_tree > attn::max_rows(D, kRowCap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kDense ? a.S <= 0 : (a.bs <= 0 || a.M <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float, kWindowed, kDense>(a, D, s);
    case 1: return launch_dim<__nv_bfloat16, kWindowed, kDense>(a, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1.  dtype: 0 float32, 1 bfloat16.  Returns the CUDA error code of the
// launch (0 on success); the wrapper raises on anything else.
extern "C" int tree_attention_paged(
    const void* q, const void* pool_k, const void* pool_v, const void* tree_k,
    const void* tree_v, const void* tree_mask, const void* cache_len,
    const void* block_table, void* out, int B, int T, int Hq, int Hkv, int D,
    int bs, int M, int dtype, float scale, void* stream) {
  Args a{q, pool_k, pool_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), nullptr, out, B, T, Hq, Hkv,
         bs, M, 0, scale};
  return dispatch<false, false>(a, D, dtype, stream);
}

// K4: K1 plus q_pos (B, T) int32 and a window (<= 0: full attention).
extern "C" int tree_attention_paged_windowed(
    const void* q, const void* pool_k, const void* pool_v, const void* tree_k,
    const void* tree_v, const void* tree_mask, const void* cache_len,
    const void* block_table, const void* q_pos, void* out, int B, int T,
    int Hq, int Hkv, int D, int bs, int M, int window, int dtype, float scale,
    void* stream) {
  Args a{q, pool_k, pool_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table),
         static_cast<const int*>(q_pos), out, B, T, Hq, Hkv, bs, M, window,
         scale};
  return dispatch<true, false>(a, D, dtype, stream);
}

// K2: K1's contract over a dense per-slot cache (B, S, Hkv, D) instead of
// the pool and the block table.
extern "C" int tree_attention_dense(
    const void* q, const void* cache_k, const void* cache_v,
    const void* tree_k, const void* tree_v, const void* tree_mask,
    const void* cache_len, void* out, int B, int T, int Hq, int Hkv, int D,
    int S, int dtype, float scale, void* stream) {
  Args a{q, cache_k, cache_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len), nullptr, nullptr, out, B, T, Hq,
         Hkv, 0, 0, 0, scale, S};
  return dispatch<false, true>(a, D, dtype, stream);
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
