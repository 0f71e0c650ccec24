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
// Layout (the model layout the wrapper receives), contiguous:
//   q_lat (B, T, H, DL) fp32   q_rope (B, T, H, DR) fp32   out (B, T, H, DL)
//   fp32; pool_lat (N, bs, DL), pool_rope (N, bs, DR), tree_lat (B, T, DL),
//   tree_rope (B, T, DR) in the KV type (fp32 or bf16); tree_mask (T, T)
//   uint8; cache_len (B,) int32; block_table (B, M) int32.
// (DL, DR) is (512, 64), deepseek-v2-lite's, or (64, 16), its reduced
// config's; T <= 16 (no padding of T: any T is taken).  q and out are
// fp32, as the JAX caller makes q_lat with an fp32 einsum.  The R = T * H
// query rows of a slot are numbered token-major, row = t * H + h, so a
// row's q and out are contiguous and rows of one token are adjacent.
// Scratch from the wrapper (fp32): part_ml (B, n_splits + 1, R, 2) and
// part_acc (B, n_splits + 1, R, DL).
//
// Bound: bytes, narrowly, at deepseek-v2-lite's verify shapes (B = 4,
// T = 16, H = 16, ~2200 live keys): each live key's 1152 bytes of bf16
// latent and rope key read once, q (fp32, per head) and o_lat (fp32)
// ~4.5 MB, ~7 MB in all (2.1 us at 3.35 TB/s), against 2 x H x T x
// (DL + DR + DL) operations per key, ~1.3 GFLOP (1.3 us at the tensor
// cores' 989 TFLOP/s).  chip_smoke.py's mla_bound counts this run's keys.
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
//     cache_len or over NULL entries only writes the empty partial (m =
//     -1e30, l = 0; acc never read) and exits.
//     bf16 pools: 16 warps, four row tiles of 16 rows by four quarters.
//     Key tiles of 16 keys x (DL + DR) come in through cp.async into a
//     double-buffered ring (zero-filled, never read, where a key is
//     excluded); q is fp32, so it is held in shared memory as two bf16
//     parts (q rounded, then what the rounding dropped) and the scores
//     are two products, close to an fp32 q.  Quarter c computes the
//     row tile's partial scores over the k-chunks c, c + 4, ...
//     (mma.sync.m16n8k16) and the four quarters exchange them through
//     shared memory, each summing the same four partials in the same
//     order, so all four hold identical scores and softmax state; then
//     quarter c accumulates P V into its DL / 4 output columns (64 fp32
//     registers a thread at DL = 512), P entering as two bf16 parts as in
//     the tree-verify kernel.  The online softmax runs in base 2 in fp32
//     registers (attention_mma.cuh's conventions).
//     fp32 pools: 256 threads on the CUDA cores, 16 rows a block, the
//     first design's 16-key fp32 tile, over the same splits and merge.
//  2. mla_attention_merge_kernel, one block per (row, b): folds the
//     partials in split order, up to the last split below cache_len, then
//     the tree's, divides and stores.  No atomics: a call is bitwise the
//     same from run to run, and an empty partial folds as an exact
//     identity.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "online_softmax.cuh"

namespace {

using attn::kNegInf;
using tc::bf16;

constexpr int kKeys = 16;          // keys per tile (both bodies)
constexpr int kGroupRows = 64;     // bf16: rows per block (4 tiles of 16)
constexpr int kMmaThreads = 512;   // bf16: 4 row tiles x 4 quarters
constexpr int kF32Rows = 16;       // fp32: rows per block
constexpr int kF32Threads = 256;
constexpr int kCols = 2;           // fp32: latent columns per thread

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
};

// The cache positions [lo, hi) split s covers below cache_len; false if
// it is empty (past cache_len, or only NULL entries).  Uniform across the
// block.
__device__ bool split_range(const Args& p, int b, int s, int len, int* lo,
                            int* hi) {
  *lo = s * p.split_len;
  *hi = min(*lo + p.split_len, len);
  if (*lo >= *hi) return false;
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
template <int DL, int DR>
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
  if (!tree && !split_range(p, b, s, len, &lo, &hi)) {
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
  // a key's row in the (rows, DL) / (rows, DR) layouts, or -1 where it is
  // not loaded (a NULL entry)
  auto key_row = [&](int pos) -> long long {
    if (tree) return static_cast<long long>(b) * T_ + pos;
    const int blk = table[pos / p.bs];
    return blk == 0 ? -1 : static_cast<long long>(blk) * p.bs + pos % p.bs;
  };
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = lo + i * kKeys, n = min(kKeys, hi - pos0);
    for (int c = tid; c < kKeys * kChunks; c += kMmaThreads) {
      const int kk = c / kChunks, ch = c % kChunks;
      const long long row = kk < n ? key_row(pos0 + kk) : -1;
      const bool ok = row >= 0;
      const bf16* src =
          ch < kLatChunks ? lat + (ok ? row * DL + ch * 8 : 0)
                          : rope + (ok ? row * DR + (ch - kLatChunks) * 8 : 0);
      tc::cp_async16(ks + (sg * kKeys + kk) * QS + ch * 8, src, ok);
    }
    for (int kk = tid; kk < kKeys; kk += kMmaThreads)
      kok[sg * kKeys + kk] = kk < n && key_row(pos0 + kk) >= 0;
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

// ---------------------------------------------------------------------------
// fp32 pools: CUDA cores, 16 rows a block, 16-key tiles of fp32
// ---------------------------------------------------------------------------

// Row stride (floats) of the query rows and the key tile: DL + DR rounded
// up to a multiple of 4, with an odd count of float4s, so the 8 keys one
// quarter-warp reads with 16-byte loads fall in 8 different bank groups.
__host__ __device__ constexpr int row_stride(int dk) {
  return ((dk + 3) / 4) % 2 ? (dk + 3) / 4 * 4 : (dk + 3) / 4 * 4 + 4;
}

__host__ __device__ constexpr size_t f32_smem_bytes(int dk) {
  return sizeof(float) * (static_cast<size_t>(kF32Rows + kKeys) *
                              row_stride(dk) +
                          static_cast<size_t>(kF32Rows) * kKeys +
                          3 * static_cast<size_t>(kF32Rows));
}

// The block's shared memory: query rows, the key tile, the tile's weights
// and the per-row softmax state.
struct Tile {
  float* q;  // kF32Rows x ld query rows, pre-scaled
  float* k;  // kKeys x ld keys; columns [0, r) are V
  float* s;  // kF32Rows x kKeys weights of the current tile
  float* m;  // running max
  float* l;  // running denominator
  float* c;  // correction of the current tile
  int r, dk, ld;
};

// Load n keys into the tile, one warp per key: columns [0, r) from the
// latent rows, [r, r + rd) from the rope rows.
__device__ __forceinline__ void load_keys(float* tile, int ld, int n, int r,
                                          int rd, const float* lat,
                                          const float* rope) {
  const int lane = threadIdx.x % 32;
  for (int kk = threadIdx.x / 32; kk < n; kk += kF32Threads / 32) {
    float* row = tile + kk * ld;
    for (int d = lane; d < r; d += 32)
      row[d] = lat[static_cast<size_t>(kk) * r + d];
    for (int d = lane; d < rd; d += 32)
      row[r + d] = rope[static_cast<size_t>(kk) * rd + d];
  }
}

// One tile of n keys in sm.k: scores, per-row online softmax (the 16
// lanes of a half-warp hold one row), accumulate.  Key kk is admitted for
// row t iff kk < n and admit(t, kk).  The accumulate adds w * v for every
// loaded key; a rejected key's weight is exactly 0 and every loaded key is
// finite, so a rejected key adds nothing.
template <typename Admit>
__device__ __forceinline__ void tile_update(const Tile& sm, int n,
                                            float (&acc)[kCols][kF32Rows],
                                            Admit admit) {
  const int ld = sm.ld, dk4 = sm.dk / 4;
  for (int i = threadIdx.x; i < kF32Rows * kKeys; i += kF32Threads) {
    const int t = i / kKeys, kk = i % kKeys;
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
    for (int off = kKeys / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, kKeys));
    const float m_prev = sm.m[t];
    const float m_new = fmaxf(m_prev, mx);
    const float w = ok ? expf(s - m_new) : 0.f;
    float sum = w;
#pragma unroll
    for (int off = kKeys / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off, kKeys);
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
  for (int t = 0; t < kF32Rows; ++t) {
    const float corr = sm.c[t];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c][t] *= corr;
  }
  // four keys at a time: keys n.. of the last group have weight 0 and
  // finite tile rows (zeros, or keys of an earlier tile)
  for (int kk = 0; kk < n; kk += 4) {
    float v[kCols][4];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = threadIdx.x + c * kF32Threads;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[c][j] = d < sm.r ? sm.k[(kk + j) * ld + d] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kF32Rows; ++t) {
      const float4 w =
          *reinterpret_cast<const float4*>(sm.s + t * kKeys + kk);
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
  __syncthreads();  // the next tile overwrites sm.k and sm.s
}

template <int DL, int DR>
__device__ void split_f32(const Args& p, float* smem) {
  constexpr int DK = DL + DR, ld = row_stride(DK);
  static_assert(DL <= kCols * kF32Threads, "latent columns per thread");
  const int s = blockIdx.x, row0 = blockIdx.y * kF32Rows, b = blockIdx.z;
  const int T_ = p.n_tree, R = T_ * p.H;
  const int len = p.cache_len[b];
  const bool tree = s == p.n_splits;
  const size_t base = (static_cast<size_t>(b) * (p.n_splits + 1) + s) * R;
  int lo = 0, hi = T_;
  if (!tree && !split_range(p, b, s, len, &lo, &hi)) {
    write_empty(p, base, row0, kF32Rows, R);
    return;
  }

  Tile sm;
  sm.q = smem;
  sm.k = sm.q + kF32Rows * ld;
  sm.s = sm.k + kKeys * ld;
  sm.m = sm.s + kF32Rows * kKeys;
  sm.l = sm.m + kF32Rows;
  sm.c = sm.l + kF32Rows;
  sm.r = DL;
  sm.dk = DK;
  sm.ld = ld;
  for (int i = threadIdx.x; i < kF32Rows * DK; i += kF32Threads) {
    const int t = i / DK, d = i % DK;
    const size_t row = static_cast<size_t>(b) * R + row0 + t;
    float x = 0.f;  // rows past R: zeros
    if (row0 + t < R)
      x = d < DL ? p.q_lat[row * DL + d] : p.q_rope[row * DR + d - DL];
    sm.q[t * ld + d] = x * p.scale;
  }
  for (int t = threadIdx.x; t < kF32Rows; t += kF32Threads) {
    sm.m[t] = kNegInf;
    sm.l[t] = 0.f;
  }
  // the accumulate reads the tile's rows in groups of 4 keys: rows past a
  // partial tile's n must hold finite values
  for (int i = threadIdx.x; i < kKeys * ld; i += kF32Threads) sm.k[i] = 0.f;
  float acc[kCols][kF32Rows];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int t = 0; t < kF32Rows; ++t) acc[c][t] = 0.f;
  __syncthreads();

  const float* lat = static_cast<const float*>(tree ? p.tree_lat : p.pool_lat);
  const float* rope =
      static_cast<const float*>(tree ? p.tree_rope : p.pool_rope);
  if (tree) {
    // the T tree keys under the ancestor mask; rows past R admit all
    const uint8_t* tm = p.tree_mask;
    const int H = p.H;
    const size_t row = static_cast<size_t>(b) * T_;
    load_keys(sm.k, ld, T_, DL, DR, lat + row * DL, rope + row * DR);
    __syncthreads();
    tile_update(sm, T_, acc, [tm, T_, H, R, row0](int t, int kk) {
      const int rho = row0 + t;
      return rho >= R || tm[(rho / H) * T_ + kk] != 0;
    });
  } else {
    // table entries of the split, NULL entries skipped; the split may
    // start and end inside an entry, so its keys are clamped to [lo, hi)
    const int* table = p.block_table + static_cast<size_t>(b) * p.M;
    auto all = [](int, int) { return true; };
    for (int j = lo / p.bs; j * p.bs < hi; ++j) {
      const int blk = table[j];
      if (blk == 0) continue;  // uniform across the block: no divergence
      for (int k0 = max(lo - j * p.bs, 0); k0 < p.bs; k0 += kKeys) {
        const int pos0 = j * p.bs + k0;
        if (pos0 >= hi) break;
        const int n = min(min(kKeys, p.bs - k0), hi - pos0);
        const size_t row = static_cast<size_t>(blk) * p.bs + k0;
        load_keys(sm.k, ld, n, DL, DR, lat + row * DL, rope + row * DR);
        __syncthreads();
        tile_update(sm, n, acc, all);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kF32Rows; ++t) {
    const int rho = row0 + t;
    if (rho >= R) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = threadIdx.x + c * kF32Threads;
      if (d < DL) p.part_acc[(base + rho) * DL + d] = acc[c][t];
    }
  }
  for (int t = threadIdx.x; t < kF32Rows && row0 + t < R; t += kF32Threads) {
    p.part_ml[2 * (base + row0 + t)] = sm.m[t];
    p.part_ml[2 * (base + row0 + t) + 1] = sm.l[t];
  }
}

// grid (n_splits + 1, row groups, B): blockIdx.x = split, the last is the
// tree; bf16 row groups are 64 rows (512 threads), fp32 ones 16 (256)
template <typename TKV, int DL, int DR>
__global__ void __launch_bounds__(kMmaThreads)
    mla_attention_split_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<TKV, float>::value)
    split_f32<DL, DR>(p, reinterpret_cast<float*>(smem_raw));
  else
    split_mma<DL, DR>(p, smem_raw);
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

template <typename TKV, int DL, int DR>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<TKV, float>::value;
  const int R = a.n_tree * a.H;
  const int rows = kF32 ? kF32Rows : kGroupRows;
  const size_t smem = kF32 ? f32_smem_bytes(DL + DR) : mma_smem_bytes<DL, DR>();
  auto split = mla_attention_split_kernel<TKV, DL, DR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split<<<dim3(a.n_splits + 1, (R + rows - 1) / rows, a.B),
          kF32 ? kF32Threads : kMmaThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_attention_merge_kernel<DL><<<dim3(R, a.B), DL / 4, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_widths(const Args& a, int r, int rd, cudaStream_t stream) {
  if (r == 512 && rd == 64) return launch<TKV, 512, 64>(a, stream);
  if (r == 64 && rd == 16) return launch<TKV, 64, 16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (B <= 0 || H <= 0 || T <= 0 || T > 16 || bs <= 0 || M <= 0 ||
      split_len <= 0 || split_len % kKeys != 0 ||
      n_splits != (M * bs + split_len - 1) / split_len)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
         pool_lat, pool_rope, tree_lat, tree_rope,
         static_cast<const uint8_t*>(tree_mask),
         static_cast<const int*>(cache_len),
         static_cast<const int*>(block_table), static_cast<float*>(out),
         static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, T, H,
         bs, M, scale, split_len, n_splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return launch_widths<float>(a, r, rd, s);
    case 1: return launch_widths<__nv_bfloat16>(a, r, rd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
