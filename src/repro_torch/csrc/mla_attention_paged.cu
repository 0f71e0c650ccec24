// Absorbed-MLA paged tree-verify attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel K5
//   src/repro/kernels/attention_template/ops.py::mla_attention_paged_bshd
//   (-> attention_template/kernel.py::tree_attention_template with
//    TemplateSpec(kind="tree", layout="paged", mla=True)).
//
// What it computes: DeepSeek-V2's multi-head latent attention in its
// absorbed form, one KV stream shared by every head.  For each (b, head),
// the T tree queries q = [q_lat (r) || q_rope (rd)] attend to the slot's
// committed keys K = [latent || rope key], read block by block from the
// two pools (N, bs, r) and (N, bs, rd) through block_table[b, j], plus
// the T tree keys under the (T, T) ancestor mask; V is the latent itself,
// so the output is o_lat (r wide), which the caller maps back to the head
// space through w_uv.  Cache positions >= cache_len[b] are masked; table
// entries that are NULL (block 0) or start at/after cache_len[b] are
// skipped outright, and no key at or past cache_len is ever loaded, so
// whatever the NULL block holds (NaN, inf, garbage from dead rows) cannot
// reach the output.  The score scale 1/sqrt(nd + rd) comes from the
// caller: it is not derivable from r and rd.  fp32 online softmax with the
// template's conventions: masked score -1e30, a rejected key's weight
// selected to 0, the denominator floored at 1e-30.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q      (B, T, H, r + rd) fp32      out (B, T, H, r) fp32
//   pool_lat (N, bs, r)   pool_rope (N, bs, rd)     in the KV type
//   tree_lat (B, T, r)    tree_rope (B, T, rd)      in the KV type
//   tree_mask (T, T) uint8   cache_len (B,) int32   block_table (B, M) int32
// The KV type is fp32 or bf16 (the cache's); q and out are fp32, as the
// JAX caller makes q_lat with an fp32 einsum.  r <= 512, r + rd a
// multiple of 4, T <= 16 (the trees of the configs have at most 16
// nodes; at a cap of 32 rows the accumulator spilled).
//
// Design (first, simple version): one thread block per (b, head), so a
// call has B * H blocks (64 at deepseek-v2-lite with 4 slots).  The TPU's
// sequential grid axis over table entries becomes a loop inside the
// block.  The block holds its T query rows (pre-scaled) in shared memory
// and streams keys 16 at a time through ONE shared tile of r + rd fp32
// columns: its first r columns are V, so no separate V tile is loaded.
// Per tile, each of the 16 x T (row, key) pairs is one thread's dot
// product in 16-byte shared loads; the row's max and sum are reduced
// across its 16 lanes by warp shuffles; then every thread owns two latent
// columns (t and t + 256) of every row, 2 x T accumulators in registers
// (32 at T = 16), and adds four keys' weights per 16-byte load.  The
// online_softmax.cuh tile of K1/K3/K4 is not used: it keeps one head dim
// for K and V and caps rows at 64 for D >= 256, and K5 has Dk = 576 and
// Dv = 512.
//
// Bound: bytes, narrowly, at deepseek-v2-lite's verify shapes.  Per key
// in reach the work reads 1152 bytes (bf16 latent and rope key) and does
// 16 heads x 16 rows x 1088 multiply-adds (score over r + rd, output over
// r): ~480 flops a byte, past the H100's ~295 in bf16.  But q and o_lat
// are fp32 and per head (4.5 MB at B = 4, T = 16), so at ~2200 keys a
// call moves ~7 MB (2.1 us) against ~1.3 GFLOP (1.3 us); the operations
// overtake the bytes past ~6000 keys per call.  This version does its
// arithmetic on the fp32 CUDA cores, each block walking its slot's key
// tiles one after another, so a call lasts as long as the longest slot's
// chain of tiles: far from either bound.  A split of the cache sweep
// across blocks with a merge, and tensor-core tiles, are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using attn::kKeyTile;
using attn::kNegInf;
using attn::kThreads;
using attn::to_f32;

constexpr int kMaxLat = 512;             // r
constexpr int kCols = kMaxLat / kThreads;  // latent columns per thread

struct Args {
  const float* q;
  const void* pool_lat;
  const void* pool_rope;
  const void* tree_lat;
  const void* tree_rope;
  const uint8_t* tree_mask;
  const int* cache_len;
  const int* block_table;
  float* out;
  int B, n_tree, H, r, rd, bs, M;
  float scale;
};

// Row stride (floats) of the query rows and the key tile: r + rd rounded
// up to a multiple of 4, with an odd count of float4s, so the 8 keys one
// quarter-warp reads with 16-byte loads fall in 8 different bank groups.
__host__ __device__ inline int row_stride(int dk) {
  const int ld = (dk + 3) / 4 * 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

__host__ __device__ inline size_t smem_bytes(int R, int dk) {
  const size_t ld = row_stride(dk);
  return sizeof(float) * (static_cast<size_t>(R) * ld +
                          static_cast<size_t>(kKeyTile) * ld +
                          static_cast<size_t>(R) * kKeyTile +
                          3 * static_cast<size_t>(R));
}

// Load n keys into the tile, one warp per key: columns [0, r) from the
// latent rows, [r, r + rd) from the rope rows.  lat/rope point at the
// first key's row.
template <typename TKV>
__device__ __forceinline__ void load_keys(float* tile, int ld, int n, int r,
                                          int rd, const TKV* lat,
                                          const TKV* rope) {
  const int lane = threadIdx.x % 32;
  for (int kk = threadIdx.x / 32; kk < n; kk += kThreads / 32) {
    float* row = tile + kk * ld;
    for (int d = lane; d < r; d += 32)
      row[d] = to_f32(lat[static_cast<size_t>(kk) * r + d]);
    for (int d = lane; d < rd; d += 32)
      row[r + d] = to_f32(rope[static_cast<size_t>(kk) * rd + d]);
  }
}

// The block's shared memory: query rows, the key tile, the tile's
// weights and the per-row softmax state.
struct Tile {
  float* q;  // R x ld query rows, pre-scaled
  float* k;  // kKeyTile x ld keys; columns [0, r) are V
  float* s;  // R x kKeyTile weights of the current tile
  float* m;  // R running max
  float* l;  // R running denominator
  float* c;  // R correction of the current tile
  int R, r, dk, ld;
};

// One tile of n keys in sm.k: scores, per-row online softmax (the 16
// lanes of a half-warp hold one row), accumulate.  Key kk is admitted for
// row t iff kk < n and admit(t, kk).  The accumulate adds w * v for every
// loaded key; a rejected key's weight is exactly 0 and every loaded key is
// finite, so a rejected key adds nothing.
template <int RMAX, typename Admit>
__device__ __forceinline__ void tile_update(const Tile& sm, int n,
                                            float (&acc)[kCols][RMAX],
                                            Admit admit) {
  const int R = sm.R, ld = sm.ld, dk4 = sm.dk / 4;
  for (int i = threadIdx.x; i < R * kKeyTile; i += kThreads) {
    // R is a multiple of 8, so whole warps enter or skip this body
    const int t = i / kKeyTile, kk = i % kKeyTile;
    const bool ok = kk < n && admit(t, kk);
    float s = kNegInf;
    if (ok) {
      const float4* qr = reinterpret_cast<const float4*>(sm.q + t * ld);
      const float4* kr = reinterpret_cast<const float4*>(sm.k + kk * ld);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int d = 0; d < dk4; ++d) {
        const float4 a = qr[d], b = kr[d];
        s0 = fmaf(a.x, b.x, s0);
        s1 = fmaf(a.y, b.y, s1);
        s2 = fmaf(a.z, b.z, s2);
        s3 = fmaf(a.w, b.w, s3);
      }
      s = (s0 + s1) + (s2 + s3);
    }
    float mx = s;
#pragma unroll
    for (int off = kKeyTile / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, kKeyTile));
    const float m_prev = sm.m[t];
    const float m_new = fmaxf(m_prev, mx);
    const float w = ok ? expf(s - m_new) : 0.f;
    float sum = w;
#pragma unroll
    for (int off = kKeyTile / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off, kKeyTile);
    sm.s[i] = w;
    __syncwarp();  // every lane has read sm.m[t] before lane 0 moves it
    if (kk == 0) {
      const float corr = expf(m_prev - m_new);
      sm.l[t] = sm.l[t] * corr + sum;
      sm.m[t] = m_new;
      sm.c[t] = corr;
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < RMAX; ++t) {
    if (t < R) {
      const float corr = sm.c[t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c][t] *= corr;
    }
  }
  // four keys at a time: keys n.. of the last group have weight 0 and
  // finite tile rows (zeros, or keys of an earlier tile)
  for (int kk = 0; kk < n; kk += 4) {
    float v[kCols][4];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = threadIdx.x + c * kThreads;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[c][j] = d < sm.r ? sm.k[(kk + j) * ld + d] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < RMAX; ++t) {
      if (t < R) {
        const float4 w =
            *reinterpret_cast<const float4*>(sm.s + t * kKeyTile + kk);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = acc[c][t];
          a = fmaf(w.x, v[c][0], a);
          a = fmaf(w.y, v[c][1], a);
          a = fmaf(w.z, v[c][2], a);
          a = fmaf(w.w, v[c][3], a);
          acc[c][t] = a;
        }
      }
    }
  }
  __syncthreads();  // the next tile overwrites sm.k and sm.s
}

template <typename TKV, int RMAX>
__global__ void __launch_bounds__(kThreads)
    mla_attention_paged_kernel(Args p) {
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int R = p.n_tree;
  const int r = p.r, rd = p.rd, dk = r + rd;
  const int ld = row_stride(dk);

  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* smem = reinterpret_cast<float*>(smem4);
  Tile sm;
  sm.q = smem;
  sm.k = sm.q + R * ld;
  sm.s = sm.k + kKeyTile * ld;
  sm.m = sm.s + R * kKeyTile;
  sm.l = sm.m + R;
  sm.c = sm.l + R;
  sm.R = R;
  sm.r = r;
  sm.dk = dk;
  sm.ld = ld;

  for (int i = threadIdx.x; i < R * dk; i += kThreads) {
    const int t = i / dk, d = i % dk;
    sm.q[t * ld + d] =
        p.q[((static_cast<size_t>(b) * R + t) * p.H + h) * dk + d] * p.scale;
  }
  for (int t = threadIdx.x; t < R; t += kThreads) {
    sm.m[t] = kNegInf;
    sm.l[t] = 0.f;
  }
  // the accumulate reads the tile's rows in groups of 4 keys: rows past a
  // partial tile's n must hold finite values
  for (int i = threadIdx.x; i < kKeyTile * ld; i += kThreads) sm.k[i] = 0.f;
  float acc[kCols][RMAX];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int t = 0; t < RMAX; ++t) acc[c][t] = 0.f;
  __syncthreads();

  const TKV* pool_lat = static_cast<const TKV*>(p.pool_lat);
  const TKV* pool_rope = static_cast<const TKV*>(p.pool_rope);
  const TKV* tree_lat = static_cast<const TKV*>(p.tree_lat);
  const TKV* tree_rope = static_cast<const TKV*>(p.tree_rope);

  // cache sweep: table entries below cache_len, NULL entries skipped, and
  // only positions below cache_len loaded
  const int len = p.cache_len[b];
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  auto all = [](int, int) { return true; };
  for (int j = 0; j < p.M && j * p.bs < len; ++j) {
    const int blk = table[j];
    if (blk == 0) continue;  // uniform across the block: no divergence
    for (int k0 = 0; k0 < p.bs; k0 += kKeyTile) {
      const int pos0 = j * p.bs + k0;
      if (pos0 >= len) break;
      const int n = min(min(kKeyTile, p.bs - k0), len - pos0);
      const size_t row0 = static_cast<size_t>(blk) * p.bs + k0;
      load_keys(sm.k, ld, n, r, rd, pool_lat + row0 * r,
                pool_rope + row0 * rd);
      __syncthreads();
      tile_update<RMAX>(sm, n, acc, all);
    }
  }

  // tree step: the T tree keys under the ancestor mask
  const uint8_t* tm = p.tree_mask;
  for (int k0 = 0; k0 < R; k0 += kKeyTile) {
    const int n = min(kKeyTile, R - k0);
    const size_t row0 = static_cast<size_t>(b) * R + k0;
    load_keys(sm.k, ld, n, r, rd, tree_lat + row0 * r,
              tree_rope + row0 * rd);
    __syncthreads();
    auto ancestor = [tm, R, k0](int t, int kk) {
      return tm[t * R + k0 + kk] != 0;
    };
    tile_update<RMAX>(sm, n, acc, ancestor);
  }

#pragma unroll
  for (int t = 0; t < RMAX; ++t) {
    if (t < R) {
      const float l = fmaxf(sm.l[t], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = threadIdx.x + c * kThreads;
        if (d < r)
          p.out[((static_cast<size_t>(b) * R + t) * p.H + h) * r + d] =
              acc[c][t] / l;
      }
    }
  }
}

template <typename TKV, int RMAX>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.n_tree, a.r + a.rd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mla_attention_paged_kernel<TKV, RMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mla_attention_paged_kernel<TKV, RMAX>
      <<<a.B * a.H, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_rows(const Args& a, cudaStream_t stream) {
  if (a.n_tree <= 8) return launch<TKV, 8>(a, stream);
  return launch<TKV, 16>(a, stream);
}

}  // namespace

// K5.  kv_dtype: 0 float32, 1 bfloat16 (pools and tree latents); q and out
// are float32.  T must be a multiple of 8, at most 16 (the wrapper pads);
// r at most 512.  Returns the CUDA error code of the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int mla_attention_paged(
    const void* q, const void* pool_lat, const void* pool_rope,
    const void* tree_lat, const void* tree_rope, const void* tree_mask,
    const void* cache_len, const void* block_table, void* out, int B, int T,
    int H, int r, int rd, int bs, int M, int kv_dtype, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T > 16 || T % 8 != 0 || r <= 0 ||
      r > kMaxLat || rd < 0 || (r + rd) % 4 != 0 || bs <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), pool_lat, pool_rope, tree_lat,
         tree_rope, static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), static_cast<float*>(out), B, T,
         H, r, rd, bs, M, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return launch_rows<float>(a, s);
    case 1: return launch_rows<__nv_bfloat16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
