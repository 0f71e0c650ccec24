// Absorbed-MLA paged tree-verify attention for Hopper (sm_90a), plain C
// interface, with its sliding-window form.
//
// Replaces the TPU kernel K5
//   src/repro/kernels/attention_template/ops.py::mla_attention_paged_bshd
//   (-> attention_template/kernel.py::tree_attention_template with
//    TemplateSpec(kind="tree", layout="paged", mla=True), windowed=True
//    where the caller passes q_pos and a window).
// One kernel body carries both forms: `kWindowed` is a template flag
// (entry points mla_attention_paged and mla_attention_paged_windowed), and
// a runtime window <= 0 is an exact no-op of the mask.
//
// What it computes: DeepSeek-V2's multi-head latent attention in its
// absorbed form, one KV stream shared by every head.  For each (b, head),
// the T tree queries q = [q_lat (DL) || q_rope (DR)] attend to the slot's
// committed keys K = [latent || rope key], read from the two pools
// (N, bs, DL) and (N, bs, DR) through block_table[b, j], plus the T tree
// keys under the (T, T) ancestor mask; V is the latent itself, so the
// output is o_lat (DL wide), which the caller maps back to the head space
// through w_uv.  Cache positions >= cache_len[b] and table entries that
// are NULL (block 0) are never read, so whatever the NULL block holds
// (NaN, inf, garbage from dead rows) cannot reach the output.  The score
// scale 1/sqrt(nd + rd) comes from the caller: it is not derivable from
// the latent widths.  Conventions of the Pallas template: masked score
// -1e30, a rejected key's weight selected to 0, the denominator floored at
// 1e-30.
//
// Windowed: also q_pos (B, T) int32 absolute query positions and an int
// window w.  With w > 0, tree token t's rows admit cache key position k
// only if q_pos[b, t] - k < w, and tree key j, which sits at position
// cache_len + j (its index, not its depth), only if q_pos[b, t] -
// (cache_len + j) < w.  Every real row sits at q_pos >= cache_len (verify
// positions are cache_len + depth), so a key at or behind cache_len - w is
// out of every row's reach: it is zero-filled (never read) and rejected,
// and a split lying wholly there writes the empty partial at once.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q_lat (B, T, H, DL) fp32   q_rope (B, T, H, DR) fp32   out (B, T, H, DL)
//   fp32; pool_lat (N, bs, DL), pool_rope (N, bs, DR), tree_lat (B, T, DL),
//   tree_rope (B, T, DR) in the KV type (fp32 or bf16); tree_mask (T, T)
//   uint8; cache_len (B,) int32; block_table (B, M) int32; q_pos (B, T)
//   int32 (windowed only).
// (DL, DR) is (512, 64), deepseek-v2-lite's, or (64, 16), its reduced
// config's; T <= 16 (no padding of T: any T is taken).  q and out are
// fp32, as the JAX caller makes q_lat with an fp32 einsum.  The R = T * H
// query rows of a slot are numbered token-major, row = t * H + h, so a
// row's q and out are contiguous and rows of one token are adjacent.
// Scratch from the wrapper (fp32): part_ml (B, n_splits + 1, R, 2) and
// part_acc (B, n_splits + 1, R, DL).
//
// Bound, at deepseek-v2-lite's verify shapes (B = 4, T = 16, H = 16,
// ~2200 live keys), 2 x H x T x (DL + DR + DL) operations per key, ~1.3
// GFLOP.  bf16 pools: bytes, narrowly: each live key's 1152 bytes of bf16
// latent and rope key read once, q (fp32, per head) and o_lat (fp32) ~4.5
// MB, ~7 MB in all (2.1 us at 3.35 TB/s), against 1.3 us at the tensor
// cores' 989 TFLOP/s.  fp32 pools: operations: each key's 2304 bytes,
// ~9.6 MB in all (2.9 us), against 7.6 us for the products as three TF32
// passes at 495 TFLOP/s (18.7 us at the CUDA cores' 67).  chip_smoke.py's
// mla_bound counts this run's keys.
//
// Design: the tree-verify kernel's split cache sweep and deterministic
// merge (tree_attention_paged.cu), with the heads packed, two launches.
//  1. mla_attention_split_kernel, one block per (split, row group, b),
//     plus one per (row group, b) for the tree keys.  MLA has one KV
//     stream, so all H heads pack as the G query heads of one kv head do:
//     a row group is 64 of the slot's R rows, and each latent tile is read
//     once per row group (4 times at deepseek's 256 rows), not once per
//     head.  Split s covers cache positions [s * split_len, (s + 1) *
//     split_len) below cache_len (split_len from the host,
//     kernels/tree_attention/split.py::plan_mla_split_len); a split past
//     cache_len, over NULL entries only or (windowed, w > 0) wholly at or
//     behind cache_len - w only writes the empty partial (m = -1e30, l =
//     0; acc never read) and exits.
//     Both bodies: 16 warps, four row tiles of 16 rows by four quarters.
//     Key tiles come in through cp.async into a double-buffered ring
//     (zero-filled, never read, where a key is excluded).  Quarter c
//     computes the row tile's partial scores over the k-chunks c, c + 4,
//     ... of the DL + DR contraction and the four quarters exchange them
//     through shared memory, each summing the same four partials in the
//     same order, so all four hold identical scores and softmax state;
//     then quarter c accumulates P V into its DL / 4 output columns (64
//     fp32 registers a thread at DL = 512).  The online softmax runs in
//     base 2 in fp32 registers (attention_mma.cuh's conventions).
//     bf16 pools: tiles of 16 keys x (DL + DR); q is fp32, so it is held
//     in shared memory as two bf16 parts (q rounded, then what the
//     rounding dropped) and the scores are two products
//     (mma.sync.m16n8k16), close to an fp32 q; P enters P V as two bf16
//     parts as in the tree-verify kernel.
//     fp32 pools (split_tf32): both products in 3xTF32 on
//     mma.sync.m16n8k8 (tf32_mma.cuh: each operand a TF32 high part plus
//     the TF32 of its residual, three products summed in fp32), tiles of
//     16 keys as in bf16.  q stays fp32 in shared memory (it comes in by
//     cp.async with the first key tile; the scores take the scale with
//     log2 e, as the other fp32 bodies) and is split as each fragment is
//     loaded.  Shared memory: 64 q rows of DL + DR floats take 147,456
//     bytes at (512, 64); with the bf16 body's 4-byte padding, a ring of
//     two 16-key tiles (74,240) and its score exchange (16,384) they
//     would pass the 232,448 a block may opt into (148,480 + 74,240 +
//     16,384 = 239,104).  So rows are unpadded, their 16-byte chunks
//     permuted within groups of 8 (key_swizzle, q_swizzle) to keep the
//     loads conflict-free, and the exchange passes one n8 block of keys
//     at a time through 8,192 bytes: q, two tiles (73,728), the exchange
//     and three tiles' key rows take 229,568 bytes at (512, 64), 45,248
//     at (64, 16) (rows padded to 96 floats), one block an SM.  The
//     scores run over k16-chunks with k permuted, so that q and K are
//     one 16-byte load a lane for two k8-steps: quarter c takes chunks
//     c, c + 4, ...: 9 of the 36 at (512, 64); at (64, 16) the 5 chunks
//     (10 k8-steps) fall 2, 1, 1, 1 on the quarters.  For each n8 block
//     of keys the small products and hi.hi run in accumulators of their
//     own, added before the exchange (a third accumulator, splitting
//     hi.hi as tf::dot_rows does, spills at the 128 registers a thread
//     may hold).  A score block's C fragment is P's A fragment for its 8
//     keys on the permuted k axis (tf32_mma.cuh), so P stays in
//     registers; V's rows 2t, 2t + 1 come from the tile as B.  Each P V
//     column block's sum over the tile is taken in 4 fresh accumulators
//     and added into the output in fp32 (the tensor cores' accumulation
//     drifts over long chains).  Warp 0 reads the block table for tile
//     i + 2 while tile i computes, so the issue of a tile never waits on
//     the table.
//  2. mla_attention_merge_kernel, one block per (row, b): folds the
//     partials in split order, up to the last split below cache_len, then
//     the tree's, divides and stores.  No atomics: a call is bitwise the
//     same from run to run, and an empty partial folds as an exact
//     identity.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using tc::kNegInf;
using tc::bf16;

constexpr int kKeys = 16;          // keys per tile (both bodies)
constexpr int kGroupRows = 64;     // rows per block (4 tiles of 16)
constexpr int kMmaThreads = 512;   // 4 row tiles x 4 quarters
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory a block

struct Args {
  const float* q_lat;
  const float* q_rope;
  const void* pool_lat;
  const void* pool_rope;
  const void* tree_lat;
  const void* tree_rope;
  const uint8_t* tree_mask;
  const int* cache_len;
  const int* block_table;
  float* out;
  float* part_ml;
  float* part_acc;
  int B, n_tree, H, bs, M;
  float scale;
  int split_len, n_splits;
  const int* q_pos;  // windowed only
  int window;
};

// The cache positions [lo, hi) split s covers below cache_len; false if
// it is empty (past cache_len, only NULL entries, or wholly behind the
// window).  Uniform across the block.
template <bool kWindowed>
__device__ bool split_range(const Args& p, int b, int s, int len, int* lo,
                            int* hi) {
  *lo = s * p.split_len;
  *hi = min(*lo + p.split_len, len);
  if (*lo >= *hi) return false;
  if constexpr (kWindowed)
    if (p.window > 0 && *hi - 1 <= len - p.window) return false;
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  for (int j = *lo / p.bs; j * p.bs < *hi; ++j)
    if (table[j] != 0) return true;
  return false;
}

// the empty partial of rows [row0, min(row0 + n, R)): m = -1e30, l = 0
__device__ void write_empty(const Args& p, size_t base, int row0, int n,
                            int R) {
  for (int r = row0 + threadIdx.x; r < min(row0 + n, R); r += blockDim.x) {
    p.part_ml[2 * (base + r)] = kNegInf;
    p.part_ml[2 * (base + r) + 1] = 0.f;
  }
}

// A key's row in the (rows, DL) / (rows, DR) layouts, or -1 where it is
// not loaded: a NULL entry or (windowed, w > 0) a cache position at or
// behind cache_len - w.  Tree keys are rows of (B * T, .).
template <bool kWindowed>
__device__ __forceinline__ long long key_row(const Args& p, bool tree, int b,
                                             const int* table, int len,
                                             int pos) {
  if (tree) return static_cast<long long>(b) * p.n_tree + pos;
  if constexpr (kWindowed)
    if (p.window > 0 && pos <= len - p.window) return -1;
  const int blk = table[pos / p.bs];
  return blk == 0 ? -1 : static_cast<long long>(blk) * p.bs + pos % p.bs;
}

// The q_pos of the thread's rows rho0 and rho0 + 8 (windowed; 0 past R),
// read where the mask needs them rather than held across the tile loop
__device__ __forceinline__ void row_pos(const Args& p, int b, int rho0,
                                        int R, int (&qp)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + 8 * h;
    qp[h] = rho < R ? p.q_pos[b * p.n_tree + rho / p.H] : 0;
  }
}

// bf16 shared memory: q as two bf16 parts (64 rows each), the key ring
// (2 tiles), the 16 warps' partial scores, 2 tiles of key flags
template <int DL, int DR>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * kGroupRows + 2 * kKeys) *
             (DL + DR + tc::kPad) +
         sizeof(float) * static_cast<size_t>(kMmaThreads / 32) * 8 * 32 +
         sizeof(int) * 2 * kKeys;
}

// bf16 pools: tensor cores.
template <int DL, int DR, bool kWindowed>
__device__ void split_mma(const Args& p, unsigned char* smem_raw) {
  constexpr int DK = DL + DR;
  constexpr int QS = DK + tc::kPad;  // shared row stride, bf16
  constexpr int KC = DK / 16;        // k-chunks of a score
  constexpr int NQ = DL / 4;         // output columns of a quarter
  constexpr int kChunks = DK / 8, kLatChunks = DL / 8;
  static_assert(DK % 16 == 0 && NQ % 16 == 0 && DR % 8 == 0, "widths");
  const int s = blockIdx.x, row0 = blockIdx.y * kGroupRows, b = blockIdx.z;
  const int T_ = p.n_tree, R = T_ * p.H;
  const int len = p.cache_len[b];
  const bool tree = s == p.n_splits;
  const size_t base = (static_cast<size_t>(b) * (p.n_splits + 1) + s) * R;
  int lo = 0, hi = T_;
  if (!tree && !split_range<kWindowed>(p, b, s, len, &lo, &hi)) {
    write_empty(p, base, row0, kGroupRows, R);
    return;
  }

  bf16* qh = reinterpret_cast<bf16*>(smem_raw);  // q rounded to bf16
  bf16* ql = qh + kGroupRows * QS;               // what the rounding dropped
  bf16* ks = ql + kGroupRows * QS;               // key ring
  float* xs = reinterpret_cast<float*>(ks + 2 * kKeys * QS);
  int* kok = reinterpret_cast<int*>(xs + (kMmaThreads / 32) * 8 * 32);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % 4, quarter = warp / 4;
  const bf16* lat = static_cast<const bf16*>(tree ? p.tree_lat : p.pool_lat);
  const bf16* rope =
      static_cast<const bf16*>(tree ? p.tree_rope : p.pool_rope);
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = lo + i * kKeys, n = min(kKeys, hi - pos0);
    for (int c = tid; c < kKeys * kChunks; c += kMmaThreads) {
      const int kk = c / kChunks, ch = c % kChunks;
      const long long row =
          kk < n ? key_row<kWindowed>(p, tree, b, table, len, pos0 + kk) : -1;
      const bool ok = row >= 0;
      const bf16* src =
          ch < kLatChunks ? lat + (ok ? row * DL + ch * 8 : 0)
                          : rope + (ok ? row * DR + (ch - kLatChunks) * 8 : 0);
      tc::cp_async16(ks + (sg * kKeys + kk) * QS + ch * 8, src, ok);
    }
    for (int kk = tid; kk < kKeys; kk += kMmaThreads)
      kok[sg * kKeys + kk] =
          kk < n && key_row<kWindowed>(p, tree, b, table, len, pos0 + kk) >= 0;
    tc::cp_async_commit();
  };
  const int ntiles = (hi - lo + kKeys - 1) / kKeys;
  issue(0);  // the first keys load while q is converted

  // q rows [row0, row0 + 64): fp32 -> two bf16 parts; zeros past R.
  // Loads go out kBatch at a time before their stores, so their latencies
  // overlap instead of adding up.
  constexpr int kPairs = kGroupRows * (DK / 2), kBatch = 12;
  static_assert(kPairs % kMmaThreads == 0, "whole passes");
  constexpr int kPass = kPairs / kMmaThreads;
  for (int i0 = 0; i0 < kPass; i0 += kBatch) {
    float2 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = tid + (i0 + u) * kMmaThreads;
      const int r = i / (DK / 2), c = 2 * (i % (DK / 2));
      x[u] = make_float2(0.f, 0.f);
      if (i0 + u < kPass && row0 + r < R) {
        const size_t row = static_cast<size_t>(b) * R + row0 + r;
        x[u] = c < DL
                   ? *reinterpret_cast<const float2*>(p.q_lat + row * DL + c)
                   : *reinterpret_cast<const float2*>(p.q_rope + row * DR +
                                                      c - DL);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = tid + (i0 + u) * kMmaThreads;
      if (i0 + u >= kPass) break;
      const int r = i / (DK / 2), c = 2 * (i % (DK / 2));
      uint32_t big, small;
      tc::split_bf16(x[u].x, x[u].y, big, small);
      *reinterpret_cast<uint32_t*>(qh + r * QS + c) = big;
      *reinterpret_cast<uint32_t*>(ql + r * QS + c) = small;
    }
  }

  const float scale_log2 = p.scale * tc::kLog2e;
  const bool live = row0 + rt * tc::kWarpRows < R;  // a tile of padding only
  const int g = lane / 4, t4 = lane & 3;
  const int rA = rt * tc::kWarpRows + g;  // the thread's rows: rA, rA + 8
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NQ / 8][4];
#pragma unroll
  for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    tc::cp_async_wait<0>();  // tile i, the one group in flight
    // tile i is visible, and every thread is done with tile i - 1 (its
    // stage, which the next issue overwrites, and xs)
    __syncthreads();
    if (i + 1 < ntiles) issue(i + 1);
    const int sg = i & 1, pos0 = lo + i * kKeys;
    const bf16* kt = ks + sg * kKeys * QS;

    // this quarter's partial scores: k-chunks quarter, quarter + 4, ...
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (live) {
#pragma unroll
      for (int kq = 0; kq < (KC + 3) / 4; ++kq) {
        const int kc = quarter + 4 * kq;
        if (kc < KC) {
          uint32_t ah[4], al[4], bk[4];
          const int qo = (rt * tc::kWarpRows + a_row) * QS + kc * 16 + a_col;
          tc::ldsm_x4(ah, qh + qo);
          tc::ldsm_x4(al, ql + qo);
          tc::ldsm_x4(bk, kt + b_row * QS + kc * 16 + b_col);
          tc::mma_bf16(sc[0], ah, bk[0], bk[1]);
          tc::mma_bf16(sc[0], al, bk[0], bk[1]);
          tc::mma_bf16(sc[1], ah, bk[2], bk[3]);
          tc::mma_bf16(sc[1], al, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(warp * 8 + j * 4 + e) * 32 + lane] = sc[j][e];
    __syncthreads();

    if (live) {
      // the four quarters' partials, summed in one order by all four
      float sco[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // quarter qq's warp is rt + 4 qq: its slots lie kQ floats on
          constexpr int kQ = 4 * 8 * 32;
          const float* x = xs + (rt * 8 + j * 4 + e) * 32 + lane;
          sco[j][e] = (x[0] + x[kQ]) + (x[2 * kQ] + x[3 * kQ]);
        }
      // online softmax (base 2): mask by selection, row max over the quad
      const int* ok = kok + sg * kKeys;
      int qp[2] = {0, 0};  // windowed: the rows' positions, read per tile
      if constexpr (kWindowed) row_pos(p, b, row0 + rA, R, qp);
      float mx[2] = {m[0], m[1]};
      uint32_t keep = 0xffu;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kk = j * 8 + 2 * t4 + (e & 1);
          const int rho = row0 + rA + 8 * h;
          bool admit = ok[kk] != 0;
          if (tree && rho < R)
            admit = admit && p.tree_mask[(rho / p.H) * T_ + pos0 + kk] != 0;
          if constexpr (kWindowed)
            if (p.window > 0)
              admit = admit &&
                      qp[h] - ((tree ? len : 0) + pos0 + kk) < p.window;
          float x = sco[j][e] * scale_log2;
          if (!admit) {
            x = kNegInf;
            keep &= ~(1u << (j * 4 + e));
          }
          sco[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = tc::ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float pw =
              (keep >> (j * 4 + e)) & 1u ? tc::ex2(sco[j][e] - mx[h]) : 0.f;
          sco[j][e] = pw;
          l[h] += pw;
        }
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V over this quarter's columns; P as two bf16 parts
      uint32_t a[4], a_lo[4];
      tc::split_bf16(sco[0][0], sco[0][1], a[0], a_lo[0]);
      tc::split_bf16(sco[0][2], sco[0][3], a[1], a_lo[1]);
      tc::split_bf16(sco[1][0], sco[1][1], a[2], a_lo[2]);
      tc::split_bf16(sco[1][2], sco[1][3], a[3], a_lo[3]);
      const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int v_col = (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NQ / 8; n += 2) {
        uint32_t bv[4];
        tc::ldsm_x4_trans(bv, kt + v_row * QS + quarter * NQ + n * 8 + v_col);
        tc::mma_bf16(o[n], a, bv[0], bv[1]);
        tc::mma_bf16(o[n + 1], a, bv[2], bv[3]);
        tc::mma_bf16(o[n], a_lo, bv[0], bv[1]);
        tc::mma_bf16(o[n + 1], a_lo, bv[2], bv[3]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + rA + 8 * h;
    if (rho >= R) continue;
    float* acc = p.part_acc + (base + rho) * DL + quarter * NQ;
#pragma unroll
    for (int n = 0; n < NQ / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (quarter == 0 && t4 == 0) {  // the max in natural units, as merged
      p.part_ml[2 * (base + rho)] = m[h] == kNegInf ? kNegInf : m[h] * tc::kLn2;
      p.part_ml[2 * (base + rho) + 1] = l[h];
    }
  }
}

// fp32 rows in shared memory: DL + DR floats padded to a multiple of 32
// (512 + 64 takes none; 64 + 16 takes 96), so every row starts on bank 0
// and its 16-byte chunks are permuted within aligned groups of 8 (the
// swizzles below) instead of padded
__host__ __device__ constexpr int f32_row(int dk) {
  return (dk + 31) / 32 * 32;
}

// The swizzle of a key tile's row kk: its 16-byte chunk ch is stored at
// ch ^ key_swizzle(kk).  The eight keys of an n8 block read as the B of
// the scores, one 16-byte load a lane (rows g, chunks 4c + t), and V's
// rows 2t and 2t + 1 read as the B of P V, one word a lane (columns
// 8n + g), both fall on 32 distinct banks: key_swizzle is 0, 4, 2, 6, 4,
// 0, 6, 2 for kk % 8 = 0 .. 7.
__device__ __forceinline__ int key_swizzle(int kk) {
  return (kk & 6) ^ ((kk & 1) << 2);
}
// a q row's: rows g and g + 1 of a 16-byte load phase differ in bit 2
__device__ __forceinline__ int q_swizzle(int r) { return (r & 1) << 2; }

// fp32 shared memory: q (64 rows), the key ring (2 tiles of kKeys), all
// rows f32_row(DL + DR) floats; one n8 block of the 16 warps' partial
// scores (16 x 8 each); the row indices of 3 tiles (int)
template <int DL, int DR>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
             (static_cast<size_t>(kGroupRows + 2 * kKeys) *
                  f32_row(DL + DR) +
              static_cast<size_t>(kMmaThreads / 32) * 4 * 32) +
         sizeof(int) * 3 * kKeys;
}
static_assert(f32_smem_bytes<512, 64>() == 229568 &&
                  f32_smem_bytes<64, 16>() == 45248 &&
                  f32_smem_bytes<512, 64>() <= kMaxSmem,
              "the fp32 block's shared memory (the header's figures)");

// fp32 pools: split_mma's grid, warps, tiles, masks and partials, with
// both products in 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh).
template <int DL, int DR, bool kWindowed>
__device__ void split_tf32(const Args& p, unsigned char* smem_raw) {
  constexpr int DK = DL + DR;
  constexpr int KN = kKeys;
  constexpr int RS = f32_row(DK);    // shared row stride, floats
  constexpr int KC = DK / 16;        // k16-chunks of a score (2 k8-steps)
  constexpr int KQ = (KC + 3) / 4;   // a quarter's chunks, at most
  constexpr int NQ = DL / 4;         // output columns of a quarter
  constexpr int kChunks = DK / 4, kLatChunks = DL / 4;  // 16-byte chunks
  static_assert(DK % 16 == 0 && NQ % 8 == 0 && DR % 4 == 0 && KN == 16,
                "widths");
  const int s = blockIdx.x, row0 = blockIdx.y * kGroupRows, b = blockIdx.z;
  const int T_ = p.n_tree, R = T_ * p.H;
  const int len = p.cache_len[b];
  const bool tree = s == p.n_splits;
  const size_t base = (static_cast<size_t>(b) * (p.n_splits + 1) + s) * R;
  int lo = 0, hi = T_;
  if (!tree && !split_range<kWindowed>(p, b, s, len, &lo, &hi)) {
    write_empty(p, base, row0, kGroupRows, R);
    return;
  }

  float* qs = reinterpret_cast<float*>(smem_raw);  // shared row r: row0 + r
  float* ks = qs + kGroupRows * RS;                // key ring
  float* xs = ks + 2 * KN * RS;                    // partial scores
  int* krow = reinterpret_cast<int*>(xs + (kMmaThreads / 32) * 4 * 32);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % 4, quarter = warp / 4;
  const float* lat = static_cast<const float*>(tree ? p.tree_lat : p.pool_lat);
  const float* rope =
      static_cast<const float*>(tree ? p.tree_rope : p.pool_rope);
  const int* table = p.block_table + static_cast<size_t>(b) * p.M;
  // tile i's key rows sit in krow[i % 3] (int: a pool of fp32 latents
  // holds under 2^31 positions): -1 where a key is not loaded (past hi,
  // NULL, behind the window).  Warp 0 reads the table for tile
  // i + 2 as tile i begins and stores the rows as it ends, so the table's
  // latency never stalls an issue.
  auto row_of = [&](int pos) -> int {
    return pos < hi ? static_cast<int>(
                          key_row<kWindowed>(p, tree, b, table, len, pos))
                    : -1;
  };
  for (int kk = tid; kk < 2 * KN; kk += kMmaThreads) krow[kk] = row_of(lo + kk);
  // q rows [row0, row0 + 64), zeros past R, in the first group
  for (int c = tid; c < kGroupRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = row0 + r < R;
    const size_t row = static_cast<size_t>(b) * R + row0 + r;
    const float* src =
        ch < kLatChunks
            ? p.q_lat + (ok ? row * DL + ch * 4 : 0)
            : p.q_rope + (ok ? row * DR + (ch - kLatChunks) * 4 : 0);
    tc::cp_async16(qs + r * RS + ((ch ^ q_swizzle(r)) << 2), src, ok);
  }
  __syncthreads();  // the first two tiles' rows
  const int ntiles = (hi - lo + KN - 1) / KN;
  auto issue = [&](int i) {
    const int* kr = krow + (i % 3) * KN;
    float* st = ks + (i & 1) * KN * RS;
    for (int c = tid; c < KN * kChunks && i < ntiles; c += kMmaThreads) {
      const int kk = c / kChunks, ch = c % kChunks;
      const int row = kr[kk];
      const bool ok = row >= 0;
      const float* src =
          ch < kLatChunks
              ? lat + (ok ? static_cast<size_t>(row) * DL + ch * 4 : 0)
              : rope + (ok ? static_cast<size_t>(row) * DR +
                                 (ch - kLatChunks) * 4
                           : 0);
      tc::cp_async16(st + kk * RS + ((ch ^ key_swizzle(kk)) << 2), src, ok);
    }
    tc::cp_async_commit();
  };
  issue(0);  // the first group carries q as well

  const float scale_log2 = p.scale * tc::kLog2e;
  const bool live = row0 + rt * tc::kWarpRows < R;  // a tile of padding only
  const int g = lane / 4, t4 = lane & 3;
  const int rA = rt * tc::kWarpRows + g;  // the thread's rows: rA, rA + 8
  const float* qa = qs + rA * RS;
  const float* qb = qa + 8 * RS;
  const int fq = q_swizzle(rA), fg = key_swizzle(g);
  const int fv0 = key_swizzle(2 * t4), fv1 = key_swizzle(2 * t4 + 1);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NQ / 8][4];
  tf::zero(o);

  for (int i = 0; i < ntiles; ++i) {
    tc::cp_async_wait<0>();  // tile i, the one group in flight
    // tile i is visible, and every thread is done with tile i - 1 (its
    // stage, which the next issue overwrites, and xs)
    __syncthreads();
    issue(i + 1);
    int next = -1;  // warp 0: tile i + 2's key rows, stored at the end
    if (warp == 0 && lane < KN) next = row_of(lo + (i + 2) * KN + lane);
    const int pos0 = lo + i * KN;
    const float* kt = ks + (i & 1) * KN * RS;
    const int* kr = krow + (i % 3) * KN;

    // this quarter's partial scores over k16-chunks quarter, quarter + 4,
    // ...: k permuted so that each operand is one 16-byte load a lane for
    // both k8-steps of a chunk (slots t, t + 4 take dims 4t, 4t + 1, then
    // 4t + 2, 4t + 3); for each n8 block the small products and hi.hi in
    // accumulators of their own (two n8 blocks: four mma chains)
    float sm[2][4], bg[2][4];
    tf::zero(sm);
    tf::zero(bg);
    if (live) {
      // rolled: unrolled, the windowed (512, 64) build spills
#pragma unroll 1
      for (int kq = 0; kq < KQ; ++kq) {
        const int ch = 4 * (quarter + 4 * kq) + t4;
        if (quarter + 4 * kq < KC) {
          const float4 x =
              *reinterpret_cast<const float4*>(qa + ((ch ^ fq) << 2));
          const float4 y =
              *reinterpret_cast<const float4*>(qb + ((ch ^ fq) << 2));
          float4 z[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            z[j] = *reinterpret_cast<const float4*>(kt + (8 * j + g) * RS +
                                                    ((ch ^ fg) << 2));
          tf::FragA fa;
          tf::FragB fb;
          tf::split(x.x, fa.hi[0], fa.lo[0]);
          tf::split(y.x, fa.hi[1], fa.lo[1]);
          tf::split(x.y, fa.hi[2], fa.lo[2]);
          tf::split(y.y, fa.hi[3], fa.lo[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tf::split(z[j].x, fb.hi[0], fb.lo[0]);
            tf::split(z[j].y, fb.hi[1], fb.lo[1]);
            tf::mma3(sm[j], bg[j], fa, fb);
          }
          tf::split(x.z, fa.hi[0], fa.lo[0]);
          tf::split(y.z, fa.hi[1], fa.lo[1]);
          tf::split(x.w, fa.hi[2], fa.lo[2]);
          tf::split(y.w, fa.hi[3], fa.lo[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tf::split(z[j].z, fb.hi[0], fb.lo[0]);
            tf::split(z[j].w, fb.hi[1], fb.lo[1]);
            tf::mma3(sm[j], bg[j], fa, fb);
          }
        }
      }
    }

    // the four quarters' partials through xs, one n8 block at a time,
    // summed in one order by all four
    float sco[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j > 0) __syncthreads();  // every warp has read block j - 1
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(warp * 4 + e) * 32 + lane] = bg[j][e] + sm[j][e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // quarter qq's warp is rt + 4 qq: its slots lie kQ floats on
        constexpr int kQ = 4 * 4 * 32;
        const float* x = xs + (rt * 4 + e) * 32 + lane;
        sco[j][e] = (x[0] + x[kQ]) + (x[2 * kQ] + x[3 * kQ]);
      }
    }

    if (live) {
      // online softmax (base 2): mask by selection, row max over the quad
      int qp[2] = {0, 0};  // windowed: the rows' positions, read per tile
      if constexpr (kWindowed) row_pos(p, b, row0 + rA, R, qp);
      float mx[2] = {m[0], m[1]};
      uint32_t keep = 0xffu;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kk = j * 8 + 2 * t4 + (e & 1);
          const int rho = row0 + rA + 8 * h;
          bool admit = kr[kk] >= 0;
          if (tree && rho < R)
            admit = admit && p.tree_mask[(rho / p.H) * T_ + pos0 + kk] != 0;
          if constexpr (kWindowed)
            if (p.window > 0)
              admit = admit &&
                      qp[h] - ((tree ? len : 0) + pos0 + kk) < p.window;
          float x = sco[j][e] * scale_log2;
          if (!admit) {
            x = kNegInf;
            keep &= ~(1u << (j * 4 + e));
          }
          sco[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = tc::ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
      // P's C fragment of block j is its A fragment for the k8-step over
      // keys 8j .. 8j + 7 with k permuted (slot t: key 2t, slot t + 4: key
      // 2t + 1)
      tf::FragA pa[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float pw = (keep >> (j * 4 + e)) & 1u
                               ? tc::ex2(sco[j][e] - mx[h])
                               : 0.f;
          sco[j][e] = pw;
          l[h] += pw;
        }
        tf::split(sco[j][0], pa[j].hi[0], pa[j].lo[0]);
        tf::split(sco[j][2], pa[j].hi[1], pa[j].lo[1]);
        tf::split(sco[j][1], pa[j].hi[2], pa[j].lo[2]);
        tf::split(sco[j][3], pa[j].hi[3], pa[j].lo[3]);
      }
      // O += P V over this quarter's columns, V's rows 2t and 2t + 1 of
      // each k8-step as B; each column block's sum over the tile in fresh
      // accumulators, added into the output in fp32
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        const int col = quarter * NQ + n * 8 + g;
        const int c4 = col >> 2, c1 = col & 3;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* v = kt + (8 * j + 2 * t4) * RS + c1;
          tf::FragB fb;
          tf::split(v[(c4 ^ fv0) << 2], fb.hi[0], fb.lo[0]);
          tf::split(v[RS + ((c4 ^ fv1) << 2)], fb.hi[1], fb.lo[1]);
          tf::mma3(pv, pa[j], fb);
        }
        o[n][0] = o[n][0] * corr[0] + pv[0];
        o[n][1] = o[n][1] * corr[0] + pv[1];
        o[n][2] = o[n][2] * corr[1] + pv[2];
        o[n][3] = o[n][3] * corr[1] + pv[3];
      }
    }
    if (warp == 0 && lane < KN) krow[((i + 2) % 3) * KN + lane] = next;
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + rA + 8 * h;
    if (rho >= R) continue;
    float* acc = p.part_acc + (base + rho) * DL + quarter * NQ;
#pragma unroll
    for (int n = 0; n < NQ / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (quarter == 0 && t4 == 0) {  // the max in natural units, as merged
      p.part_ml[2 * (base + rho)] = m[h] == kNegInf ? kNegInf : m[h] * tc::kLn2;
      p.part_ml[2 * (base + rho) + 1] = l[h];
    }
  }
}

// grid (n_splits + 1, row groups of 64, B), 512 threads: blockIdx.x =
// split, the last is the tree
template <typename TKV, int DL, int DR, bool kWindowed>
__global__ void __launch_bounds__(kMmaThreads)
    mla_attention_split_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<TKV, float>::value)
    split_tf32<DL, DR, kWindowed>(p, smem_raw);
  else
    split_mma<DL, DR, kWindowed>(p, smem_raw);
}

// grid (R, B), DL / 4 threads of 4 columns each: the partials of one row
// folded in split order (the live splits, then the tree), divided, stored.
template <int DL>
__global__ void __launch_bounds__(DL / 4) mla_attention_merge_kernel(Args p) {
  const int rho = blockIdx.x, b = blockIdx.y;
  const int R = p.n_tree * p.H;
  const int len = p.cache_len[b];
  const int n_live = min(p.n_splits, (len + p.split_len - 1) / p.split_len);
  const int d = threadIdx.x * 4;
  float m = kNegInf, l = 0.f;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  auto fold = [&](int s) {
    const size_t idx = (static_cast<size_t>(b) * (p.n_splits + 1) + s) * R +
                       rho;
    const float ms = p.part_ml[2 * idx], ls = p.part_ml[2 * idx + 1];
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ms != kNegInf)  // an empty partial's acc is 0, and never read
      as = *reinterpret_cast<const float4*>(p.part_acc + idx * DL + d);
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
  *reinterpret_cast<float4*>(p.out + (static_cast<size_t>(b) * R + rho) * DL +
                             d) =
      make_float4(a[0] / den, a[1] / den, a[2] / den, a[3] / den);
}

template <typename TKV, int DL, int DR, bool kWindowed>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<TKV, float>::value;
  const int R = a.n_tree * a.H;
  const size_t smem =
      kF32 ? f32_smem_bytes<DL, DR>() : mma_smem_bytes<DL, DR>();
  auto split = mla_attention_split_kernel<TKV, DL, DR, kWindowed>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split<<<dim3(a.n_splits + 1, (R + kGroupRows - 1) / kGroupRows, a.B),
          kMmaThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_attention_merge_kernel<DL><<<dim3(R, a.B), DL / 4, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool kWindowed>
int launch_widths(const Args& a, int r, int rd, cudaStream_t stream) {
  if (r == 512 && rd == 64) return launch<TKV, 512, 64, kWindowed>(a, stream);
  if (r == 64 && rd == 16) return launch<TKV, 64, 16, kWindowed>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Validates the shape and the split, then launches the instantiation for
// kv_dtype (0 float32, 1 bfloat16) and the widths (r, rd).
template <bool kWindowed>
int dispatch(const Args& a, int r, int rd, int kv_dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.n_tree <= 0 || a.n_tree > 16 || a.bs <= 0 ||
      a.M <= 0 || a.split_len <= 0 || a.split_len % kKeys != 0 ||
      a.n_splits != (a.M * a.bs + a.split_len - 1) / a.split_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return launch_widths<float, kWindowed>(a, r, rd, s);
    case 1: return launch_widths<__nv_bfloat16, kWindowed>(a, r, rd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K5.  kv_dtype: 0 float32, 1 bfloat16 (pools and tree latents); q and out
// are float32.  T at most 16; (r, rd) is (512, 64) or (64, 16); split_len
// a multiple of 16 with n_splits = ceil(M * bs / split_len); part_ml /
// part_acc the wrapper's fp32 scratch for n_splits + 1 partials (see the
// header).  Returns the CUDA error code of the two launches (0 on
// success); the wrapper raises on anything else.
extern "C" int mla_attention_paged(
    const void* q_lat, const void* q_rope, const void* pool_lat,
    const void* pool_rope, const void* tree_lat, const void* tree_rope,
    const void* tree_mask, const void* cache_len, const void* block_table,
    void* out, void* part_ml, void* part_acc, int B, int T, int H, int r,
    int rd, int bs, int M, int split_len, int n_splits, int kv_dtype,
    float scale, void* stream) {
  Args a{static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
         pool_lat, pool_rope, tree_lat, tree_rope,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), static_cast<float*>(out),
         static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, T, H,
         bs, M, scale, split_len, n_splits, nullptr, 0};
  return dispatch<false>(a, r, rd, kv_dtype, stream);
}

// K5 windowed: K5 plus q_pos (B, T) int32 and a window (<= 0: full
// attention).
extern "C" int mla_attention_paged_windowed(
    const void* q_lat, const void* q_rope, const void* pool_lat,
    const void* pool_rope, const void* tree_lat, const void* tree_rope,
    const void* tree_mask, const void* cache_len, const void* block_table,
    const void* q_pos, void* out, void* part_ml, void* part_acc, int B, int T,
    int H, int r, int rd, int bs, int M, int window, int split_len,
    int n_splits, int kv_dtype, float scale, void* stream) {
  Args a{static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
         pool_lat, pool_rope, tree_lat, tree_rope,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), static_cast<float*>(out),
         static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, T, H,
         bs, M, scale, split_len, n_splits, static_cast<const int*>(q_pos),
         window};
  return dispatch<true>(a, r, rd, kv_dtype, stream);
}
