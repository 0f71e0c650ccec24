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
// q, k, v and out share one type.  bf16 builds: (DQK, DV) in (64, 64),
// (80, 80), hubert-xlarge's heads (five k-steps of 16 for S = Q K^T, ten
// n-tiles of 8 for P V, key tiles of 64 and rows of 80 + 8 in shared
// memory: nothing padded to 128), (128, 128), (256, 256) and (192, 128),
// deepseek-v2-lite's MLA prefill (nope 128 + rope 64 for q/k, 128 for v)
// at its own widths.  fp32 builds take DQK = DV in {64, 128, 256}; the
// wrapper pads other widths (80 to 128) for fp32 alone.
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
// q_off is a multiple of the query tile (64; 16 for fp32) the chunk's rows
// equal the whole prefill's rows bit for bit.  Tiles are skipped in
// absolute positions: causal tiles past the query tile's last position,
// with a window tiles wholly before q0 - window + 1, and tiles wholly at
// or past kv_valid_len; only the tiles that cross a mask boundary (or the
// valid end) are masked element by element.  Query tiles are launched
// longest causal chain first.
//
// fp32 keeps the first version's CUDA-core body: one thread block per
// (b, kv head, tile of at most 16 query positions) holding the G*BQ rows
// that share the kv head, 16-key tiles through online_softmax.cuh.
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
#include "online_softmax.cuh"

namespace {

using attn::kKeyTile;
using attn::kNegInf;
using attn::kThreads;
using attn::Smem;
using tc::bf16;

constexpr int kRowCap = 128;   // fp32: G * BQ query rows per block
constexpr int kQTile = 16;     // fp32: query positions per block, at most
constexpr int kMmaRows = 64;   // bf16: query positions per block
constexpr int kMmaThreads = 128;

constexpr size_t kMaxSmem = 227 * 1024;  // opt-in shared memory a block

// bf16 shared memory: q (64 rows of DQK), K ring (2 tiles of KN keys of
// DQK), V ring (2 tiles of KN keys of DV); rows padded by 8 bf16
template <int DQK, int DV, int KN>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) *
         (static_cast<size_t>(kMmaRows + 2 * KN) * (DQK + tc::kPad) +
          static_cast<size_t>(2 * KN) * (DV + tc::kPad));
}

// whether a (DQK, DV) build has a key tile of KN: its ring fits
template <int DQK, int DV, int KN>
__host__ __device__ constexpr bool mma_fits() {
  return mma_smem_bytes<DQK, DV, KN>() <= kMaxSmem;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;               // (B, Hq, Sq) row log-sum-exp, or null
  const int* q_off;         // (B,) first query position, or null: 0
  const int* kv_valid_len;  // (B,) keys at or past it masked, or null
  int B, Sq, Skv, Hq, Hkv, bq, causal, window;
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
  static_assert(mma_fits<DQK, DV, KN>(), "the K/V ring exceeds shared memory");
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

// fp32 body (CUDA cores): grid n_qt * B * Hkv, the last query tile first.
template <int D>
__device__ void flash_f32(const Args& p, float* smem) {
  constexpr int DP = D + 1;
  constexpr int NRG = kThreads / D;
  constexpr int KMAX = attn::max_rows(D, kRowCap) / NRG;
  const int G = p.Hq / p.Hkv;
  const int BQ = p.bq;
  const int R = G * BQ;
  const int heads = p.B * p.Hkv;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hkv;
  const int h = blockIdx.x % p.Hkv;
  const int q0 = qt * BQ;
  const int off = query_offset(p, b);

  const Smem sm = attn::carve_smem<D>(smem, R);
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / BQ, row = q0 + r % BQ;
    float x = 0.f;  // rows past Sq are computed on zeros and never stored
    if (row < p.Sq)
      x = q[((static_cast<size_t>(b) * p.Sq + row) * p.Hq + h * G + g) * D +
            d] *
          p.scale;
    sm.q[r * DP + d] = x;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
    sm.pos[r] = off + q0 + r % BQ;  // absolute
  }
  float acc[KMAX];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) acc[kk] = 0.f;
  __syncthreads();

  const bool causal = p.causal != 0;
  const int w = p.window;
  const KeyRange kr = key_range(p, b, off + q0,
                                off + min(q0 + BQ, p.Sq) - 1, kKeyTile);
  const int k_end = kr.end;
  for (int k0 = kr.begin; k0 < k_end; k0 += kKeyTile) {
    const int n = min(kKeyTile, k_end - k0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const size_t o =
          ((static_cast<size_t>(b) * p.Skv + k0 + kk) * p.Hkv + h) * D + d;
      sm.k[kk * DP + d] = k[o];
      sm.v[kk * DP + d] = v[o];
    }
    __syncthreads();
    auto admit = [sm, causal, w, k0](int r, int kk) {
      const int dq = sm.pos[r] - (k0 + kk);
      return (!causal || dq >= 0) && (w <= 0 || dq < w);
    };
    attn::tile_update<D, KMAX>(R, n, sm, acc, admit);
  }

  float* out = static_cast<float*>(p.out);
  const int d = threadIdx.x % D;
  const int rg = threadIdx.x / D;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    const int r = rg + kk * NRG;
    if (r < R) {
      const int g = r / BQ, row = q0 + r % BQ;
      if (row < p.Sq) {
        const size_t o =
            ((static_cast<size_t>(b) * p.Sq + row) * p.Hq + h * G + g) * D +
            d;
        out[o] = acc[kk] / fmaxf(sm.l[r], 1e-30f);
      }
    }
  }
  if (p.lse != nullptr)
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const int g = r / BQ, row = q0 + r % BQ;
      if (row < p.Sq)
        p.lse[(static_cast<size_t>(b) * p.Hq + h * G + g) * p.Sq + row] =
            sm.m[r] + logf(sm.l[r]);
    }
}

// KN: the bf16 body's key tile; the fp32 body's is kKeyTile (16)
template <typename T, int DQK, int DV, int KN>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value) {
    static_assert(DQK == DV && KN == kKeyTile,
                  "the fp32 body takes one head dim and 16-key tiles");
    flash_f32<DQK>(p, reinterpret_cast<float*>(smem_raw));
  } else {
    flash_mma<DQK, DV, KN>(p, smem_raw);
  }
}

template <typename T, int DQK, int DV, int KN>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  size_t smem;
  if constexpr (kF32)
    smem = attn::smem_bytes((a.Hq / a.Hkv) * a.bq, DQK);
  else
    smem = mma_smem_bytes<DQK, DV, KN>();
  auto kern = flash_attention_kernel<T, DQK, DV, KN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = kF32 ? a.bq : kMmaRows;
  const int n_qt = (a.Sq + rows - 1) / rows;
  const int blocks = n_qt * a.B * (kF32 ? a.Hkv : a.Hq);
  kern<<<blocks, kF32 ? kThreads : kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 (DQK, DV) build at key tile `key_tile`: 32, 64, or 128 where
// its ring fits (mma_fits); anything else is refused
template <int DQK, int DV>
int launch_bf16(const Args& a, int key_tile, cudaStream_t stream) {
  switch (key_tile) {
    case 32: return launch<bf16, DQK, DV, 32>(a, stream);
    case 64: return launch<bf16, DQK, DV, 64>(a, stream);
    case 128:
      if constexpr (mma_fits<DQK, DV, 128>())
        return launch<bf16, DQK, DV, 128>(a, stream);
      break;
    default: break;
  }
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
         B, Sq, Skv, Hq, Hkv, 0, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Dqk == 64 && Dv == 64) return launch_bf16<64, 64>(a, key_tile, s);
    if (Dqk == 80 && Dv == 80) return launch_bf16<80, 80>(a, key_tile, s);
    if (Dqk == 128 && Dv == 128)
      return launch_bf16<128, 128>(a, key_tile, s);
    if (Dqk == 256 && Dv == 256)
      return launch_bf16<256, 256>(a, key_tile, s);
    if (Dqk == 192 && Dv == 128)
      return launch_bf16<192, 128>(a, key_tile, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 || Dqk != Dv) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = attn::max_rows(Dqk, kRowCap) / (Hq / Hkv);
  a.bq = fit < kQTile ? fit : kQTile;
  if (a.bq < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dqk) {
    case 64: return launch<float, 64, 64, kKeyTile>(a, s);
    case 128: return launch<float, 128, 128, kKeyTile>(a, s);
    case 256: return launch<float, 256, 256, kKeyTile>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
