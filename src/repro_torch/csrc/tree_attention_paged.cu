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
// (T, T) ancestor mask.  Cache positions >= cache_len[b] are never read;
// table entries that are NULL (block 0) are never read either, so
// whatever the NULL block holds (NaN, inf, garbage from dead rows) can
// never reach the output.
//
// Windowed (K4): also q_pos (B, T) int32 absolute query positions and an
// int window w.  With w > 0, row r admits key position k only if
// q_pos[r] - k < w; tree token j sits at position cache_len + j.  Every
// real query row sits at q_pos >= cache_len (verify positions are
// cache_len + depth), so a key at or behind cache_len - w is out of every
// row's reach: it is zero-filled (never read from the pool) and rejected,
// and a split lying wholly there exits at once.  Pad rows the wrapper adds
// carry q_pos 0; their outputs are sliced away.
//
// Dense (K2): the same math over a per-slot cache (B, S, Hkv, D), the
// port's own layer view of its dense cache, read directly (no block table:
// an identity table could not stand in, since block 0 is NULL).  Keys
// below min(cache_len[b], S) are read; positions at or past cache_len
// never are, whatever they hold (the tree K/V the caller scattered there
// come in as the tree operands).  No window: dense windowed verify has no
// TPU kernel and stays plain PyTorch.
//
// Layout: every tensor is in the model layout the wrapper receives,
//   q, out       (B, T, Hq, D)     tree_k, tree_v  (B, T, Hkv, D)
//   pool_k/v     (N, bs, Hkv, D)   tree_mask (T, T) uint8
//                (dense: the cache (B, S, Hkv, D))
//   cache_len    (B,) int32        block_table (B, M) int32 (paged only)
//   q_pos        (B, T) int32 (windowed only)
// contiguous; q, pools, tree K/V and out share one type, fp32 or bf16.
// D is 64, 128 or 256; the R = G*T query rows of a kv head may be any
// number (starcoder2-7b's 36 over 4 heads at T = 16: 144).
// Scratch from the wrapper (fp32): part_ml (B*Hkv, n_splits + 1, R, 2) and
// part_acc (B*Hkv, n_splits + 1, R, D).
//
// Bound: bytes.  The work must move each live cache key's K and V once
// (per kv head), plus q, the tree K/V and the output: a few MB per call at
// minitron-4b and gemma3-1b shapes against well under a GFLOP, far below
// the tensor cores' ratio of ~295 operations a byte.  So the design is
// about keeping every SM streaming keys.  Past 64 rows a K/V tile is read
// once per row group (below): 3 times at R = 144, twice at 80 and 128,
// the repeats mostly from L2.
//
// Design: a split cache sweep with a deterministic merge, two launches.
//  1. tree_attention_split_kernel, one block per (split, row group, b,
//     kv head), plus one per (row group, b, kv head) for the tree keys.
//     Split s covers cache positions [s*split_len, (s+1)*split_len) below
//     cache_len.  The R = G*T query rows that share the kv head (query
//     head h*G + g, tree token t -> row g*T + t) are cut into row groups
//     of 64, [64*y, 64*y + 64): each block holds one group, so each K/V
//     tile is read once per (kv head, row group), and writes its rows'
//     partial (m, l, acc) to the fp32 scratch.  A row's arithmetic never
//     depends on the other rows of its block, so at R <= 64 (one group)
//     the kernel is the one-group kernel it was, bit for bit, and the rows
//     of a group equal those of a call that holds only them.
//     A split that starts at or past cache_len, (K4, w > 0) lies wholly at
//     or behind cache_len - w, or holds only NULL entries, writes the
//     empty partial (m = -1e30, l = 0; its acc is never read) and exits.
//     bf16: four warps, 16 rows each; warps whose rows are all padding
//     only help load.  Q, then K/V tiles of 64 keys (16 at D = 256) come
//     in through cp.async into a double-buffered ring in shared memory
//     (the next tile loads while this one computes); Q K^T and P V run on
//     mma.sync.m16n8k16 and the online softmax in fp32 registers
//     (attention_mma.cuh); P enters P V as two bf16 parts (~16-bit
//     weights, at twice P V's products, which a load-bound kernel can
//     spare), so the verify stays close to the fp32-weight softmax of the
//     dense path it is compared with.
//     fp32 (split_tf32): the same grid, ring, flags, masks and partials,
//     with Q K^T and P V on mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh:
//     each operand a TF32 high part plus the TF32 of its residual, three
//     products summed in fp32: fp32 accuracy).  Tiles are fp32 in shared
//     memory at a row stride of D + 4 floats: 64 keys a tile at D = 64
//     and 128, 32 at D = 256 (q, the two-stage K/V ring, P, the row
//     values, flags and positions: 106,752, 188,672 and 210,944 bytes of
//     the 227 KB a block may take).  Each 16-row slice is shared by
//     kF32SliceWarps warps (tf::Slice): each computes the scores of its
//     share of the tile's keys, the slice trades row maxima and writes P
//     through shared memory (written from C fragments, read back as A
//     fragments on the permuted k axis), and each sums P V over all the
//     tile's keys for its share of the value columns; each P V sum is
//     taken in fresh accumulators a tile and added in fp32 (the tensor
//     cores' accumulation drifts over long chains).  The denominators'
//     shares are added in part order at the end.  Every score, weight and
//     column sum of a row reads only that row and the tile, so a row's
//     bits never depend on the slice's other rows.
//  2. tree_attention_merge_kernel, one block per (row, b, kv head): folds
//     the partials in split order, up to the last split below cache_len,
//     then the tree partial, then divides (denominator floored at 1e-30)
//     and stores.  No atomics: a call is bitwise the same from run to run.
//     Folding an empty partial is an exact identity: its correction
//     exp(-1e30 - m) is 0 and its acc is taken as 0 without a read.
//
// The split rule: split_len comes from the host (the wrapper's planner,
// kernels/tree_attention/split.py) and depends only on B*Hkv: never on
// cache_len (it stays on the device) nor on the capacity (M*bs or S).  So
// a paged call (K1, K4) and a dense call (K2) of equal B*Hkv split at the
// same positions, and tiles start at the same positions inside a split,
// whatever their capacities and whatever the pool block size: a paged
// split may start and end inside a pool block (the sweep clamps each
// block's keys to the split).  Inside a split, both bodies take tiles at
// positions lo + i * (keys a tile), gathering each key through the block
// table, so K1 over a pool of any block size (a multiple of 8) and K2
// over the same keys as a dense cache fold the same tiles in the same
// order, bit for bit, in bf16 and in fp32.  split_len is a multiple of
// 16; the grid covers the capacity, n_splits = ceil(capacity /
// split_len).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using tc::bf16;
using tc::kNegInf;

constexpr int kGroupRows = 64;    // query rows a split block holds
constexpr int kMmaThreads = 128;  // bf16: four warps of 16 rows
constexpr int kMaxGrid = 65535;   // the grid's y and z extents
constexpr int kSplitUnit = 16;    // split_len is a multiple of this
constexpr int kBoundThreads = 256;  // the bf16 kernel's launch bound
constexpr size_t kMaxSmem = 227 * 1024;  // opt-in shared memory a block

// fp32: each 16-row slice of the group is shared by kF32SliceWarps warps
// (tf::Slice), each taking that share of every key tile's scores and of
// the value columns.  On an H100 (scripts/time_bwd_kernels.py --set
// kF32SliceWarps=N), one warp a slice ran 1.10-1.39x slower than two
// (one warp a scheduler at the wide builds' one block an SM), and four
// (512 threads, registers capped at 128) within 7% either way, no faster
// over vicuna-tiny's calls
constexpr int kSlices = kGroupRows / tc::kWarpRows;
constexpr int kF32SliceWarps = 2;
constexpr int kF32Threads = kSlices * kF32SliceWarps * 32;
static_assert(kSlices == tf::Slice<kF32SliceWarps>::kSlices, "slices");

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// keys per bf16 tile: 16 at D = 256 keeps the accumulator (128 registers
// a thread), the scores and the split weights in registers
template <int D>
__host__ __device__ constexpr int mma_keys() {
  return D >= 256 ? 16 : 64;
}

// bf16 shared memory: q (64 rows), then K and V rings (2 tiles each), all
// rows D + 8 bf16; then 2 tiles of key flags and 64 row positions (int)
template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) *
             static_cast<size_t>(kGroupRows + 4 * mma_keys<D>()) *
             (D + tc::kPad) +
         sizeof(int) * static_cast<size_t>(2 * mma_keys<D>() + kGroupRows);
}

// keys per fp32 tile: 64, or 32 at D = 256, where a ring of 64 would not
// fit shared memory
template <int D>
__host__ __device__ constexpr int f32_keys() {
  return D >= 256 ? 32 : 64;
}

// fp32 shared memory: q (64 rows), then K and V rings (2 tiles each), all
// rows D + 4 floats; each slice's P (16 rows of keys + 8 floats); every
// warp's 16 row values; then 2 tiles of key flags and 64 row positions
// (int)
template <int D>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
             (static_cast<size_t>(kGroupRows + 4 * f32_keys<D>()) *
                  (D + tf::kPad) +
              static_cast<size_t>(kGroupRows) * (f32_keys<D>() + tf::kPadP) +
              static_cast<size_t>(kSlices * kF32SliceWarps) *
                  tc::kWarpRows) +
         sizeof(int) * static_cast<size_t>(2 * f32_keys<D>() + kGroupRows);
}
static_assert(f32_smem_bytes<64>() <= kMaxSmem &&
                  f32_smem_bytes<128>() <= kMaxSmem &&
                  f32_smem_bytes<256>() <= kMaxSmem,
              "an fp32 ring exceeds shared memory");

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
  float* part_ml;
  float* part_acc;
  int B, n_tree, Hq, Hkv, D, bs, M, window;
  float scale;
  int S;  // dense only: the cache's length
  int split_len, n_splits;
};

template <bool kDense>
__device__ __forceinline__ int live_len(const Args& p, int b) {
  return kDense ? min(p.cache_len[b], p.S) : p.cache_len[b];
}

// The cache positions [lo, hi) split s covers below cache_len; false if
// the split is empty (past cache_len, wholly behind the window, or only
// NULL entries).  Uniform across the block.
template <bool kWindowed, bool kDense>
__device__ bool split_range(const Args& p, int b, int s, int len, int* lo,
                            int* hi) {
  *lo = s * p.split_len;
  *hi = min(*lo + p.split_len, len);
  if (*lo >= *hi) return false;
  if (kWindowed && p.window > 0 && *hi - 1 <= len - p.window) return false;
  if (!kDense) {
    const int* table = p.block_table + static_cast<size_t>(b) * p.M;
    for (int j = *lo / p.bs; j * p.bs < *hi; ++j)
      if (table[j] != 0) return true;
    return false;
  }
  return true;
}

// the empty partial of the group's rows [row0, min(row0 + 64, R)): m =
// -1e30, l = 0 (acc is never read)
__device__ void write_empty(const Args& p, size_t base, int row0, int R) {
  for (int r = row0 + threadIdx.x; r < min(row0 + kGroupRows, R);
       r += blockDim.x) {
    p.part_ml[2 * (base + r)] = kNegInf;
    p.part_ml[2 * (base + r) + 1] = 0.f;
  }
}

// bf16 body of one split (or the tree block): tensor cores.
template <int D, bool kWindowed, bool kDense>
__device__ void split_mma(const Args& p, unsigned char* smem_raw) {
  constexpr int KN = mma_keys<D>();
  constexpr int RS = D + tc::kPad;  // shared row stride, bf16
  constexpr int kChunks = D / 8;    // 16-byte chunks per row
  const int s = blockIdx.x, row0 = blockIdx.y * kGroupRows, bh = blockIdx.z;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int G = p.Hq / p.Hkv, T_ = p.n_tree, R = G * T_;
  const int len = live_len<kDense>(p, b);
  const int w = kWindowed ? p.window : 0;
  const bool tree = s == p.n_splits;
  const size_t base = (static_cast<size_t>(bh) * (p.n_splits + 1) + s) * R;
  int lo = 0, hi = T_;
  if (!tree && !split_range<kWindowed, kDense>(p, b, s, len, &lo, &hi)) {
    write_empty(p, base, row0, R);
    return;
  }

  // shared row r holds the group's row row0 + r
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kGroupRows * RS;
  bf16* vs = ks + 2 * KN * RS;
  int* kok = reinterpret_cast<int*>(vs + 2 * KN * RS);  // key loaded
  int* qpos = kok + 2 * KN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* q = static_cast<const bf16*>(p.q);
  tc::load_rows<D, kGroupRows, kMmaThreads>(
      qs, tid, q, [&](int r) -> const bf16* {
        if (row0 + r >= R) return nullptr;  // padding: zeros
        const int g = (row0 + r) / T_, t = (row0 + r) % T_;
        return q + ((static_cast<size_t>(b) * T_ + t) * p.Hq + h * G + g) * D;
      });
  for (int r = tid; r < kGroupRows; r += kMmaThreads)
    qpos[r] =
        kWindowed && row0 + r < R ? p.q_pos[b * T_ + (row0 + r) % T_] : 0;

  const bf16* kb = static_cast<const bf16*>(tree ? p.tree_k : p.pool_k);
  const bf16* vb = static_cast<const bf16*>(tree ? p.tree_v : p.pool_v);
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  // a key below hi is loaded unless its entry is NULL or (w > 0) it sits
  // at or behind cache_len - w; its row in the (rows, Hkv, D) layout
  auto key_ok = [&](int pos) {
    if (tree) return true;
    if (!kDense && table[pos / p.bs] == 0) return false;
    return w <= 0 || pos > len - w;
  };
  auto key_row = [&](int pos) -> size_t {
    if (tree) return static_cast<size_t>(b) * T_ + pos;
    if (kDense) return static_cast<size_t>(b) * p.S + pos;
    return static_cast<size_t>(table[pos / p.bs]) * p.bs + pos % p.bs;
  };
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = lo + i * KN, n = min(KN, hi - pos0);
    for (int c = tid; c < KN * kChunks; c += kMmaThreads) {
      const int kk = c / kChunks, ch = c % kChunks;
      const bool ok = kk < n && key_ok(pos0 + kk);
      const size_t off =
          ok ? (key_row(pos0 + kk) * p.Hkv + h) * D + ch * 8 : 0;
      tc::cp_async16(ks + (sg * KN + kk) * RS + ch * 8, kb + off, ok);
      tc::cp_async16(vs + (sg * KN + kk) * RS + ch * 8, vb + off, ok);
    }
    for (int kk = tid; kk < KN; kk += kMmaThreads)
      kok[sg * KN + kk] = kk < n && key_ok(pos0 + kk);
    tc::cp_async_commit();
  };

  const float scale_log2 = p.scale * tc::kLog2e;
  tc::RowState<D> st;
  st.init();
  const bool live = row0 + warp * tc::kWarpRows < R;  // padding only?
  const int r0 = warp * tc::kWarpRows + lane / 4;
  const int ntiles = (hi - lo + KN - 1) / KN;
  issue(0);  // the first group carries q as well
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      issue(i + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int sg = i & 1, pos0 = lo + i * KN;
      const bf16* qw = qs + warp * tc::kWarpRows * RS;
      const int* ok = kok + sg * KN;
      if (tree) {
        // tree token j: the ancestor mask, and (w > 0) the window with
        // token j at position cache_len + j
        const uint8_t* tm = p.tree_mask;
        tc::tile_mma<D, D, KN, true>(
            qw, ks + sg * KN * RS, vs + sg * KN * RS, scale_log2, st, true,
            [&](int hh, int kk) {
              const int r = r0 + 8 * hh, j = pos0 + kk;
              return ok[kk] && tm[((row0 + r) % T_) * T_ + j] != 0 &&
                     (w <= 0 || qpos[r] - (len + j) < w);
            });
      } else {
        tc::tile_mma<D, D, KN, true>(
            qw, ks + sg * KN * RS, vs + sg * KN * RS, scale_log2, st, true,
            [&](int hh, int kk) {
              return ok[kk] && (w <= 0 || qpos[r0 + 8 * hh] - (pos0 + kk) < w);
            });
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }

  if (!live) return;
  st.reduce_l();
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + r0 + 8 * hh;
    if (r >= R) continue;
    float* acc = p.part_acc + (base + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
          make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
    if (t4 == 0) {  // the max back in natural units, as the merge takes
      p.part_ml[2 * (base + r)] =
          st.m[hh] == kNegInf ? kNegInf : st.m[hh] * tc::kLn2;
      p.part_ml[2 * (base + r) + 1] = st.l[hh];
    }
  }
}

// fp32 body of one split (or the tree block): split_mma's structure (the
// positional ring, the flags, the masks and the partials) with both
// products in 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh): 64 rows a block
// in four 16-row slices of kF32SliceWarps warps each; the warps of a slice
// split each key tile's scores and the value columns (tf::tile_slice).
template <int D, bool kWindowed, bool kDense>
__device__ void split_tf32(const Args& p, unsigned char* smem_raw) {
  constexpr int KN = f32_keys<D>();
  constexpr int NK = kF32SliceWarps;
  constexpr int RS = D + tf::kPad;  // shared row stride, floats
  constexpr int kChunks = D / 4;    // 16-byte chunks per row
  constexpr int NT = kF32Threads;
  const int s = blockIdx.x, row0 = blockIdx.y * kGroupRows, bh = blockIdx.z;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int G = p.Hq / p.Hkv, T_ = p.n_tree, R = G * T_;
  const int len = live_len<kDense>(p, b);
  const int w = kWindowed ? p.window : 0;
  const bool tree = s == p.n_splits;
  const size_t base = (static_cast<size_t>(bh) * (p.n_splits + 1) + s) * R;
  int lo = 0, hi = T_;
  if (!tree && !split_range<kWindowed, kDense>(p, b, s, len, &lo, &hi)) {
    write_empty(p, base, row0, R);
    return;
  }

  // shared row r holds the group's row row0 + r
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kGroupRows * RS;
  float* vs = ks + 2 * KN * RS;
  float* pb = vs + 2 * KN * RS;                    // P of each slice
  float* mb = pb + kGroupRows * (KN + tf::kPadP);  // row maxima, then sums
  int* kok = reinterpret_cast<int*>(mb + kSlices * NK * tc::kWarpRows);
  int* qpos = kok + 2 * KN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slice = warp % kSlices, part = warp / kSlices;
  const float* q = static_cast<const float*>(p.q);
  tf::load_rows<D, kGroupRows, NT>(qs, tid, q, [&](int r) -> const float* {
    if (row0 + r >= R) return nullptr;  // padding: zeros
    const int g = (row0 + r) / T_, t = (row0 + r) % T_;
    return q + ((static_cast<size_t>(b) * T_ + t) * p.Hq + h * G + g) * D;
  });
  for (int r = tid; r < kGroupRows; r += NT)
    qpos[r] =
        kWindowed && row0 + r < R ? p.q_pos[b * T_ + (row0 + r) % T_] : 0;

  const float* kb = static_cast<const float*>(tree ? p.tree_k : p.pool_k);
  const float* vb = static_cast<const float*>(tree ? p.tree_v : p.pool_v);
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  // as split_mma: a key below hi is loaded unless its entry is NULL or
  // (w > 0) it sits at or behind cache_len - w
  auto key_ok = [&](int pos) {
    if (tree) return true;
    if (!kDense && table[pos / p.bs] == 0) return false;
    return w <= 0 || pos > len - w;
  };
  auto key_row = [&](int pos) -> size_t {
    if (tree) return static_cast<size_t>(b) * T_ + pos;
    if (kDense) return static_cast<size_t>(b) * p.S + pos;
    return static_cast<size_t>(table[pos / p.bs]) * p.bs + pos % p.bs;
  };
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = lo + i * KN, n = min(KN, hi - pos0);
    for (int c = tid; c < KN * kChunks; c += NT) {
      const int kk = c / kChunks, ch = c % kChunks;
      const bool ok = kk < n && key_ok(pos0 + kk);
      const size_t off =
          ok ? (key_row(pos0 + kk) * p.Hkv + h) * D + ch * 4 : 0;
      tc::cp_async16(ks + (sg * KN + kk) * RS + ch * 4, kb + off, ok);
      tc::cp_async16(vs + (sg * KN + kk) * RS + ch * 4, vb + off, ok);
    }
    for (int kk = tid; kk < KN; kk += NT)
      kok[sg * KN + kk] = kk < n && key_ok(pos0 + kk);
    tc::cp_async_commit();
  };

  const float scale_log2 = p.scale * tc::kLog2e;
  tc::RowState<D / NK> st;  // this warp's value columns
  st.init();
  const bool live = row0 + slice * tc::kWarpRows < R;  // padding only?
  const int r0 = slice * tc::kWarpRows + lane / 4;
  const tf::Slice<NK> sl{pb + slice * tc::kWarpRows * (KN + tf::kPadP), mb,
                         warp, part, 1 + slice};
  const int ntiles = (hi - lo + KN - 1) / KN;
  issue(0);  // the first group carries q as well
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      issue(i + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int sg = i & 1, pos0 = lo + i * KN;
      const int* ok = kok + sg * KN;
      // a loaded key, under the ancestor mask for tree token j (which sits
      // at position cache_len + j), and (w > 0) within the row's window;
      // one call site for the cache and the tree (`tree` is uniform)
      const uint8_t* tm = p.tree_mask;
      tf::tile_slice<D, D, KN, NK>(
          qs + slice * tc::kWarpRows * RS, ks + sg * KN * RS,
          vs + sg * KN * RS, scale_log2, st, true,
          [&](int hh, int kk) {
            const int r = r0 + 8 * hh, j = pos0 + kk;
            if (!ok[kk] || (tree && tm[((row0 + r) % T_) * T_ + j] == 0))
              return false;
            return w <= 0 || qpos[r] - (tree ? len + j : j) < w;
          },
          sl);
    }
    __syncthreads();  // the next issue overwrites this stage
  }

  if (!live) return;  // a slice's warps are all live or all padding
  st.reduce_l();
  float l[2];
  sl.total(st.l, l);
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + r0 + 8 * hh;
    if (r >= R) continue;
    float* acc = p.part_acc + (base + r) * D + part * (D / NK);
#pragma unroll
    for (int n = 0; n < D / NK / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
          make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
    if (t4 == 0 && part == 0) {  // the max in natural units, as split_mma
      p.part_ml[2 * (base + r)] =
          st.m[hh] == kNegInf ? kNegInf : st.m[hh] * tc::kLn2;
      p.part_ml[2 * (base + r) + 1] = l[hh];
    }
  }
}

// grid (n_splits + 1, row groups, B * Hkv): blockIdx.x = split, the last
// is the tree; blockIdx.y = row group
template <typename T, int D, bool kWindowed, bool kDense>
__global__ void __launch_bounds__(
    std::is_same<T, float>::value ? kF32Threads : kBoundThreads)
    tree_attention_split_kernel(Args p) {
  static_assert(!(kWindowed && kDense), "no dense windowed form");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    split_tf32<D, kWindowed, kDense>(p, smem_raw);
  else
    split_mma<D, kWindowed, kDense>(p, smem_raw);
}

// grid (R, B * Hkv), D / 4 threads of 4 columns each: the partials of one
// row folded in split order (the live splits, then the tree), divided and
// stored.
template <typename T, bool kDense>
__global__ void __launch_bounds__(64) tree_attention_merge_kernel(Args p) {
  const int r = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int G = p.Hq / p.Hkv, T_ = p.n_tree, R = G * T_, D = p.D;
  const int len = live_len<kDense>(p, b);
  const int n_live = min(p.n_splits, (len + p.split_len - 1) / p.split_len);
  const int d = threadIdx.x * 4;
  float m = kNegInf, l = 0.f;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  auto fold = [&](int s) {
    const size_t idx =
        (static_cast<size_t>(bh) * (p.n_splits + 1) + s) * R + r;
    const float ms = p.part_ml[2 * idx], ls = p.part_ml[2 * idx + 1];
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ms != kNegInf)  // an empty partial's acc is 0, and never read
      as = *reinterpret_cast<const float4*>(p.part_acc + idx * D + d);
    const float mn = fmaxf(m, ms);
    const float c = expf(m - mn), cs = expf(ms - mn);
    l = l * c + ls * cs;
    a[0] = a[0] * c + as.x * cs;
    a[1] = a[1] * c + as.y * cs;
    a[2] = a[2] * c + as.z * cs;
    a[3] = a[3] * c + as.w * cs;
    m = mn;
  };
  for (int s = 0; s < n_live; ++s) fold(s);
  fold(p.n_splits);
  const float den = fmaxf(l, 1e-30f);
  const int g = r / T_, t = r % T_;
  T* out = static_cast<T*>(p.out) +
           ((static_cast<size_t>(b) * T_ + t) * p.Hq + h * G + g) * D + d;
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = from_f32<T>(a[e] / den);
}

template <typename T, int D, bool kWindowed, bool kDense>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int R = (a.Hq / a.Hkv) * a.n_tree;
  const int groups = (R + kGroupRows - 1) / kGroupRows;
  const size_t smem = kF32 ? f32_smem_bytes<D>() : mma_smem_bytes<D>();
  auto split = tree_attention_split_kernel<T, D, kWindowed, kDense>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split<<<dim3(a.n_splits + 1, groups, a.B * a.Hkv),
          kF32 ? kF32Threads : kMmaThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tree_attention_merge_kernel<T, kDense>
      <<<dim3(R, a.B * a.Hkv), D / 4, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWindowed, bool kDense>
int launch_dim(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 64: return launch<T, 64, kWindowed, kDense>(a, stream);
    case 128: return launch<T, 128, kWindowed, kDense>(a, stream);
    case 256: return launch<T, 256, kWindowed, kDense>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Validates the shape and the split, then launches the instantiation for
// dtype (0 float32, 1 bfloat16) and D.  Returns the CUDA error code.  Any
// number of rows per kv head is taken; only the grid's extents bound the
// (b, kv head) pairs and the row groups.
template <bool kWindowed, bool kDense>
int dispatch(const Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.n_tree <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.B * a.Hkv > kMaxGrid ||
      ((a.Hq / a.Hkv) * a.n_tree + kGroupRows - 1) / kGroupRows > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kDense ? a.S <= 0 : (a.bs <= 0 || a.M <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = kDense ? a.S : a.M * a.bs;
  if (a.split_len <= 0 || a.split_len % kSplitUnit != 0 ||
      a.n_splits != (cap + a.split_len - 1) / a.split_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float, kWindowed, kDense>(a, s);
    case 1: return launch_dim<__nv_bfloat16, kWindowed, kDense>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1.  dtype: 0 float32, 1 bfloat16.  part_ml / part_acc: the wrapper's
// fp32 scratch for n_splits + 1 partials (see the header).  Returns the
// CUDA error code of the two launches (0 on success); the wrapper raises
// on anything else.
extern "C" int tree_attention_paged(
    const void* q, const void* pool_k, const void* pool_v, const void* tree_k,
    const void* tree_v, const void* tree_mask, const void* cache_len,
    const void* block_table, void* out, void* part_ml, void* part_acc, int B,
    int T, int Hq, int Hkv, int D, int bs, int M, int split_len, int n_splits,
    int dtype, float scale, void* stream) {
  Args a{q, pool_k, pool_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), nullptr, out,
         static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, T,
         Hq, Hkv, D, bs, M, 0, scale, 0, split_len, n_splits};
  return dispatch<false, false>(a, dtype, stream);
}

// K4: K1 plus q_pos (B, T) int32 and a window (<= 0: full attention).
extern "C" int tree_attention_paged_windowed(
    const void* q, const void* pool_k, const void* pool_v, const void* tree_k,
    const void* tree_v, const void* tree_mask, const void* cache_len,
    const void* block_table, const void* q_pos, void* out, void* part_ml,
    void* part_acc, int B, int T, int Hq, int Hkv, int D, int bs, int M,
    int window, int split_len, int n_splits, int dtype, float scale,
    void* stream) {
  Args a{q, pool_k, pool_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table),
         static_cast<const int*>(q_pos), out, static_cast<float*>(part_ml),
         static_cast<float*>(part_acc), B, T, Hq, Hkv, D, bs, M, window,
         scale, 0, split_len, n_splits};
  return dispatch<true, false>(a, dtype, stream);
}

// K2: K1's contract over a dense per-slot cache (B, S, Hkv, D) instead of
// the pool and the block table.
extern "C" int tree_attention_dense(
    const void* q, const void* cache_k, const void* cache_v,
    const void* tree_k, const void* tree_v, const void* tree_mask,
    const void* cache_len, void* out, void* part_ml, void* part_acc, int B,
    int T, int Hq, int Hkv, int D, int S, int split_len, int n_splits,
    int dtype, float scale, void* stream) {
  Args a{q, cache_k, cache_v, tree_k, tree_v,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len), nullptr, nullptr, out,
         static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, T,
         Hq, Hkv, D, 0, 0, 0, scale, S, split_len, n_splits};
  return dispatch<false, true>(a, dtype, stream);
}
