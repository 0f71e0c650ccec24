// Prefill attention for Hopper (sm_90a), plain C interface: causal or
// bidirectional attention with an optional sliding window and GQA, over a
// whole prompt or over one chunk of it (the chunked prefill's
// continuation); bidirectional is hubert-xlarge's encoder.
//
// Replaces the TPU kernel K3
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (-> attention_template/kernel.py::self_attention, TemplateSpec
//    kind="self").
//
// What it computes: Sq query rows of row b sit at absolute positions
// q_off[b] + i (i < Sq) and read Skv keys at positions 0..Skv-1; query i
// attends to key k iff k < kv_valid_len[b] and (not causal or
// k <= q_off[b] + i) and (window <= 0 or q_off[b] + i - k < window); query
// head h*G + g reads kv head h.  A whole prefill is q_off = 0, Skv = Sq and
// no kv_valid_len (null pointers: offset 0, every key valid).  A chunk of a
// resumable prefill (the JAX package runs jnp blocked_attention with a
// query offset and kv_valid_len there: models/attention.py::
// _prefill_continuation) passes the cache view as K/V, its start as q_off
// and start + Sq as kv_valid_len: keys at or past kv_valid_len (stale
// scratch, NULL blocks of a gathered pool view) are never read.  Any Sq and
// Skv are taken: a ragged last tile is cut by its length (keys past the
// end are zero-filled, never read, and rejected), never padded.  The
// window is a runtime int, so one build serves gemma3's local (512) and
// global (0) layers.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q (B, Sq, Hq, DQK)   k (B, Skv, Hkv, DQK)   v (B, Skv, Hkv, DV)
//   out (B, Sq, Hq, DV)  q_off, kv_valid_len (B,) int32 or null
//   lse (B, Hq, Sq) fp32 or null: where given (a whole prefill under
//   autograd), each row's log-sum-exp of its scaled scores, in natural
//   units, for the backward (flash_attention_bwd.cu); its stores change no
//   arithmetic, so out keeps its bits with or without it
// q, k, v and out share one type.  Builds, in bf16 and in fp32: (DQK, DV)
// in (64, 64), (80, 80), hubert-xlarge's heads (five k-steps of 16 for S =
// Q K^T, ten n-tiles of 8 for P V, key tiles of 64 and rows of 80 + 8 in
// shared memory: nothing padded to 128), (128, 128), (256, 256) and (192,
// 128), deepseek-v2-lite's MLA prefill (nope 128 + rope 64 for q/k, 128
// for v) at its own widths; fp32 also (48, 32), its reduced MLA widths
// (the narrow fp32 runs on the card).
//
// Bound: operations at the prompt lengths the models prefill (S in the
// hundreds to thousands): 2*(DQK + DV) flops per admitted (query head,
// query, key) against q, k, v and out read or written once.
//
// Design (bf16), FlashAttention-2 on mma.sync: one block of four warps
// per (tile of 64 query rows, b, query head); each warp owns 16 query
// rows.  Q comes in once; key tiles of KN keys come in through cp.async
// into a double-buffered ring in shared memory, so the next tile loads
// while this one computes.  KN is a template parameter chosen at run time
// (the `key_tile` argument; the wrapper resolves it through the
// autotuner's cache, kernels/flash_attention/ops.py): 32, 64 or 128
// wherever the ring fits the card's 227 KiB of shared memory a block
// (every build but 128 at DQK = 256); by default 64, or 32 at DQK = 256
// to keep the accumulator in registers.  S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate); P is re-packed to bf16 in registers as the A operand;
// the online softmax and the accumulator stay in fp32 registers, with the
// template's conventions (attention_mma.cuh).  GQA: the G query heads of
// kv head h read the same K/V tiles, which their blocks (launched side by
// side) share through L2.  Key tiles start at absolute multiples of the
// key tile, from position 0, whatever q_off: a query row walks the same
// tiles in the same order in a chunk as in the whole prefill, so where
// q_off is a multiple of the query tile (64) the chunk's rows equal the
// whole prefill's rows bit for bit.  Tiles are skipped in
// absolute positions: causal tiles past the query tile's last position,
// with a window tiles wholly before q0 - window + 1, and tiles wholly at
// or past kv_valid_len; only the tiles that cross a mask boundary (or the
// valid end) are masked element by element.  Query tiles are launched
// longest causal chain first.
//
// Design (fp32, redesigned for the H100): the bf16 body's grid, query
// tiles, cp.async ring and masks, with both products on the tensor cores
// at fp32 accuracy: mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh: each operand
// split into a TF32 high part and the TF32 of its residual, hi lo + lo hi
// + hi hi summed in fp32; single-pass TF32 would keep three digits).
// Tiles are fp32 in shared memory, rows padded by 4 floats, so the wide
// builds fill it at one block an SM; four warps would then leave one warp
// a scheduler and the mma chains' latency bare (measured: 1.2-1.5x
// slower at the wide builds).  So a block runs 8 warps in 4 pairs: the
// two warps of a pair
// share 16 query rows and split each key tile, each computing S over its
// half of the keys, the pair exchanging row maxima and its halves of P
// through shared memory (two 64-thread barriers a tile), each summing P V
// over all the tile's keys for its half of the value columns; each keeps
// its keys' share of the denominator, and the two are added at the end.
// One key tile a build, the widest whose ring fits: 64 keys, 32 at (256,
// 256) and (192, 128) (195 and 131 KiB of ring; every build that fits 64
// ran as fast or faster at 64 than at 32).  Bound: operations; the tensor
// cores' TF32 rate (495 TFLOP/s) over three passes is 165 TFLOP/s of fp32
// work, above the CUDA cores' 67.  The fp32 body has no limit on G (its
// blocks are per query head) and no padding: every (DQK, DV) above is its
// own build.  As in bf16, a chunk's rows equal the whole prefill's rows
// bit for bit where q_off is a multiple of the query tile, 64 (the first
// version's fp32 tile was 16).
//
// Every warp reads each K/V tile from shared memory (ldmatrix) for its 16
// rows, so a block's key tiles cost shared-memory bandwidth in proportion
// to its rows; with few heads (gemma3-1b: 4) the causal critical path, the
// last query tile's whole chain of key tiles, sits on one SM.  wgmma (one
// read of K/V per 64 rows) and splitting long query tiles' key ranges
// across blocks are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using tc::bf16;

constexpr int kMmaRows = 64;   // query positions per block
constexpr int kMmaThreads = 128;  // bf16: 4 warps
constexpr int kF32Threads = 256;  // fp32: 4 pairs of warps

template <typename T>
__host__ __device__ constexpr int threads() {
  return std::is_same<T, float>::value ? kF32Threads : kMmaThreads;
}

constexpr size_t kMaxSmem = 227 * 1024;  // opt-in shared memory a block

// shared memory of the (T, DQK, DV) build at key tile KN: q (64 rows of
// DQK), K ring (2 tiles of KN keys of DQK), V ring (2 tiles of KN keys of
// DV); rows padded by 8 bf16 or 4 floats; fp32 adds each pair's P (16
// rows of KN + 8) and the 8 warps' row maxima (16 each)
template <typename T, int DQK, int DV, int KN>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int pad = f32 ? tf::kPad : tc::kPad;
  return sizeof(T) *
         (static_cast<size_t>(kMmaRows + 2 * KN) * (DQK + pad) +
          static_cast<size_t>(2 * KN) * (DV + pad) +
          (f32 ? 4 * 16 * (KN + tf::kPadP) + 8 * 16 : 0));
}

// whether a (T, DQK, DV) build has a key tile of KN: its ring fits (and,
// in fp32, its keep mask: at most 64 keys)
template <typename T, int DQK, int DV, int KN>
__host__ __device__ constexpr bool mma_fits() {
  return mma_smem_bytes<T, DQK, DV, KN>() <= kMaxSmem &&
         (!std::is_same<T, float>::value || KN <= 64);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;               // (B, Hq, Sq) row log-sum-exp, or null
  const int* q_off;         // (B,) first query position, or null: 0
  const int* kv_valid_len;  // (B,) keys at or past it masked, or null
  int B, Sq, Skv, Hq, Hkv, causal, window;
  float scale;
};

// The absolute key range [k_begin, k_end) that query rows at absolute
// positions [q_first, q_last] of row b may read: causal keys end after
// q_last, valid keys at kv_valid_len, and a window starts at
// q_first - window + 1, rounded down to a multiple of the key tile `kt`
// (tiles start at absolute multiples of kt from position 0).
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(const Args& p, int b,
                                              int q_first, int q_last,
                                              int kt) {
  int valid = p.Skv;
  if (p.kv_valid_len != nullptr) valid = min(valid, max(p.kv_valid_len[b], 0));
  KeyRange r;
  r.end = p.causal != 0 ? min(q_last + 1, valid) : valid;
  r.begin = p.window > 0 ? max(0, q_first - p.window + 1) / kt * kt : 0;
  return r;
}

__device__ __forceinline__ int query_offset(const Args& p, int b) {
  return p.q_off != nullptr ? p.q_off[b] : 0;
}

// bf16 body: grid n_qt * B * Hq, the last query tile first; key tiles of
// KN keys.
template <int DQK, int DV, int KN>
__device__ void flash_mma(const Args& p, unsigned char* smem_raw) {
  static_assert(mma_fits<bf16, DQK, DV, KN>(),
                "the K/V ring exceeds shared memory");
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.Sq + kMmaRows - 1) / kMmaRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq;
  const int hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * kMmaRows;                 // first row of the tile
  const int off = query_offset(p, b);           // row i sits at off + i

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kMmaRows * QS;
  bf16* vs = ks + 2 * KN * QS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  // rows past Sq are computed on zeros and never stored
  tc::load_rows<DQK, kMmaRows, kMmaThreads>(
      qs, tid, q, [&](int r) -> const bf16* {
        const int i = q0 + r;
        if (i >= p.Sq) return nullptr;
        return q + ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + hq) * DQK;
      });

  const bool causal = p.causal != 0;
  const int w = p.window;
  const int q_first = off + q0;                             // absolute
  const int q_last = off + min(q0 + kMmaRows, p.Sq) - 1;    // absolute
  const KeyRange kr = key_range(p, b, q_first, q_last, KN);
  const int k_begin = kr.begin, k_end = kr.end;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + KN - 1) / KN : 0;
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.Skv + pos) * p.Hkv + hk;
  };
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = k_begin + i * KN;
    tc::load_rows<DQK, KN, kMmaThreads>(
        ks + sg * KN * QS, tid, k, [&](int kk) -> const bf16* {
          const int pos = pos0 + kk;
          return pos < k_end ? k + kv_row(pos) * DQK : nullptr;
        });
    tc::load_rows<DV, KN, kMmaThreads>(
        vs + sg * KN * VS, tid, v, [&](int kk) -> const bf16* {
          const int pos = pos0 + kk;
          return pos < k_end ? v + kv_row(pos) * DV : nullptr;
        });
    tc::cp_async_commit();
  };

  tc::RowState<DV> st;
  st.init();
  const int i0 = warp * tc::kWarpRows + lane / 4;  // local row g; g+8: +8
  const int a0 = q_first + i0;                      // its absolute position
  const float scale_log2 = p.scale * tc::kLog2e;
  if (ntiles > 0) {
    issue(0);  // the first group carries q as well
  } else {     // no key to read (kv_valid_len 0): the rows stay zero
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      issue(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int sg = it & 1, pos0 = k_begin + it * KN;
    // a tile needs element masks only where it crosses the key range's
    // end, the diagonal or the window's far edge
    const bool masked = pos0 + KN > k_end ||
                        (causal && pos0 + KN - 1 > q_first) ||
                        (w > 0 && q_last - pos0 >= w);
    tc::tile_mma<DQK, DV, KN>(
        qs + warp * tc::kWarpRows * QS, ks + sg * KN * QS, vs + sg * KN * VS,
        scale_log2, st, masked, [&](int hh, int kk) {
          const int key = pos0 + kk, dq = a0 + 8 * hh - key;
          return key < k_end && (!causal || dq >= 0) && (w <= 0 || dq < w);
        });
    __syncthreads();  // the next issue overwrites this stage
  }

  st.reduce_l();
  bf16* out = static_cast<bf16*>(p.out);
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    if (i >= p.Sq) continue;
    const float inv = 1.f / fmaxf(st.l[hh], 1e-30f);
    bf16* o = out + ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + hq) * DV;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) = tc::pack_bf16(
          st.o[n][2 * hh] * inv, st.o[n][2 * hh + 1] * inv);
    // the running max is in base-2 units of the scaled scores
    if (p.lse != nullptr && t4 == 0)
      p.lse[(static_cast<size_t>(b) * p.Hq + hq) * p.Sq + i] =
          (st.m[hh] + log2f(st.l[hh])) * tc::kLn2;
  }
}

// fp32 body (3xTF32 on the tensor cores): grid n_qt * B * Hq, the last
// query tile first; 64 query rows a block of 8 warps in 4 pairs: warps w
// and w + 4 share rows 16 (w % 4).. and split each key tile of KN keys
// (half h = w / 4 takes keys h KN / 2..): each computes its half of S,
// the pair exchanges its row maxima and its half of P through shared
// memory (two pair barriers a tile), and each sums O += P V over all KN
// keys for its half of the value columns.  Both warps of a pair hold the
// same running max; each keeps its keys' share of the denominator, and
// the two are added at the end.  Twice the warps of a 4-warp body at the
// same shared memory: the fp32 tiles fill it at one block an SM for the
// wide builds, and one warp a scheduler leaves the mma chains' latency
// bare.
template <int DQK, int DV, int KN>
__device__ void flash_tf32(const Args& p, unsigned char* smem_raw) {
  static_assert(mma_fits<float, DQK, DV, KN>(),
                "the K/V ring exceeds shared memory");
  constexpr int QS = DQK + tf::kPad, VS = DV + tf::kPad;
  constexpr int NT = kF32Threads;
  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.Sq + kMmaRows - 1) / kMmaRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq;
  const int hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * kMmaRows;                 // first row of the tile
  const int off = query_offset(p, b);           // row i sits at off + i

  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kMmaRows * QS;
  float* vs = ks + 2 * KN * QS;
  float* pb = vs + 2 * KN * VS;                 // P of each pair's rows
  float* mb = pb + 4 * 16 * (KN + tf::kPadP);   // maxima, then sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = warp % 4, half = warp / 4;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  // rows past Sq are computed on zeros and never stored
  tf::load_rows<DQK, kMmaRows, NT>(qs, tid, q, [&](int r) -> const float* {
    const int i = q0 + r;
    if (i >= p.Sq) return nullptr;
    return q + ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + hq) * DQK;
  });

  const bool causal = p.causal != 0;
  const int w = p.window;
  const int q_first = off + q0;                             // absolute
  const int q_last = off + min(q0 + kMmaRows, p.Sq) - 1;    // absolute
  const KeyRange kr = key_range(p, b, q_first, q_last, KN);
  const int k_begin = kr.begin, k_end = kr.end;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + KN - 1) / KN : 0;
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.Skv + pos) * p.Hkv + hk;
  };
  auto issue = [&](int i) {
    const int sg = i & 1, pos0 = k_begin + i * KN;
    tf::load_rows<DQK, KN, NT>(
        ks + sg * KN * QS, tid, k, [&](int kk) -> const float* {
          const int pos = pos0 + kk;
          return pos < k_end ? k + kv_row(pos) * DQK : nullptr;
        });
    tf::load_rows<DV, KN, NT>(
        vs + sg * KN * VS, tid, v, [&](int kk) -> const float* {
          const int pos = pos0 + kk;
          return pos < k_end ? v + kv_row(pos) * DV : nullptr;
        });
    tc::cp_async_commit();
  };

  tc::RowState<DV / 2> st;   // the half's value columns
  st.init();
  const int i0 = pair * tc::kWarpRows + lane / 4;  // local row g; g+8: +8
  const int a0 = q_first + i0;                      // its absolute position
  const float scale_log2 = p.scale * tc::kLog2e;
  const tf::Slice<2> pr{pb + pair * 16 * (KN + tf::kPadP), mb, warp, half,
                    1 + pair};
  if (ntiles > 0) {
    issue(0);  // the first group carries q as well
  } else {     // no key to read (kv_valid_len 0): the rows stay zero
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      issue(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int sg = it & 1, pos0 = k_begin + it * KN;
    // a tile needs element masks only where it crosses the key range's
    // end, the diagonal or the window's far edge
    const bool masked = pos0 + KN > k_end ||
                        (causal && pos0 + KN - 1 > q_first) ||
                        (w > 0 && q_last - pos0 >= w);
    auto admit = [&](int hh, int kk) {
      const int key = pos0 + kk, dq = a0 + 8 * hh - key;
      return key < k_end && (!causal || dq >= 0) && (w <= 0 || dq < w);
    };
    tf::tile_slice<DQK, DV, KN, 2>(qs + pair * tc::kWarpRows * QS,
                                   ks + sg * KN * QS, vs + sg * KN * VS,
                                   scale_log2, st, masked, admit, pr);
    __syncthreads();  // the next issue overwrites this stage
  }

  st.reduce_l();
  float l[2];
  pr.total(st.l, l);
  float* out = static_cast<float*>(p.out);
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + i0 + 8 * hh;
    if (i >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + hq) * DV +
               half * (DV / 2);
#pragma unroll
    for (int n = 0; n < DV / 16; ++n)
      *reinterpret_cast<float2*>(o + n * 8 + 2 * t4) = make_float2(
          st.o[n][2 * hh] * inv, st.o[n][2 * hh + 1] * inv);
    // the running max is in base-2 units of the scaled scores
    if (p.lse != nullptr && t4 == 0 && half == 0)
      p.lse[(static_cast<size_t>(b) * p.Hq + hq) * p.Sq + i] =
          (st.m[hh] + log2f(l[hh])) * tc::kLn2;
  }
}

template <typename T, int DQK, int DV, int KN>
__global__ void __launch_bounds__(threads<T>())
    flash_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    flash_tf32<DQK, DV, KN>(p, smem_raw);
  else
    flash_mma<DQK, DV, KN>(p, smem_raw);
}

template <typename T, int DQK, int DV, int KN>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<T, DQK, DV, KN>();
  auto kern = flash_attention_kernel<T, DQK, DV, KN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (a.Sq + kMmaRows - 1) / kMmaRows;
  kern<<<n_qt * a.B * a.Hq, threads<T>(), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the (T, DQK, DV) build: bf16 at key tile `key_tile`, 32, 64, or 128
// where its ring fits (mma_fits), anything else refused; fp32 at its one
// key tile, the widest that fits up to 64 (32 at (256, 256) and (192,
// 128)), `key_tile` ignored
template <typename T, int DQK, int DV>
int launch_build(const Args& a, int key_tile, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kn = mma_fits<T, DQK, DV, 64>() ? 64 : 32;
    return launch<T, DQK, DV, kn>(a, stream);
  } else {
    switch (key_tile) {
      case 32: return launch<T, DQK, DV, 32>(a, stream);
      case 64:
        if constexpr (mma_fits<T, DQK, DV, 64>())
          return launch<T, DQK, DV, 64>(a, stream);
        break;
      case 128:
        if constexpr (mma_fits<T, DQK, DV, 128>())
          return launch<T, DQK, DV, 128>(a, stream);
        break;
      default: break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dims(const Args& a, int Dqk, int Dv, int key_tile,
                cudaStream_t s) {
  if (Dqk == 64 && Dv == 64) return launch_build<T, 64, 64>(a, key_tile, s);
  if (Dqk == 80 && Dv == 80) return launch_build<T, 80, 80>(a, key_tile, s);
  if (Dqk == 128 && Dv == 128)
    return launch_build<T, 128, 128>(a, key_tile, s);
  if (Dqk == 256 && Dv == 256)
    return launch_build<T, 256, 256>(a, key_tile, s);
  if (Dqk == 192 && Dv == 128)
    return launch_build<T, 192, 128>(a, key_tile, s);
  if constexpr (std::is_same<T, float>::value)
    if (Dqk == 48 && Dv == 32) return launch_build<T, 48, 32>(a, key_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; causal: 0 or 1; window <= 0: no window.
// lse: (B, Hq, Sq) fp32, or null (see the layout above).
// q_off and kv_valid_len: (B,) int32 device arrays, or null (a whole
// prefill: offset 0, every key valid).  key_tile: the bf16 body's keys a
// tile (32, 64 or 128 where the build's ring fits; ignored by fp32).
// Returns the CUDA error code of the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, const void* q_off,
                               const void* kv_valid_len, int B, int Sq,
                               int Skv, int Hq, int Hkv, int Dqk, int Dv,
                               int causal, int window, int dtype,
                               int key_tile, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, static_cast<float*>(lse),
         static_cast<const int*>(q_off),
         static_cast<const int*>(kv_valid_len),
         B, Sq, Skv, Hq, Hkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dims<bf16>(a, Dqk, Dv, key_tile, s);
  if (dtype == 0) return launch_dims<float>(a, Dqk, Dv, key_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
