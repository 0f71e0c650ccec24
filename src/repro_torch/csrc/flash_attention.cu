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
// scratch, NULL blocks of a gathered pool view) get weight 0 and enter
// P V as zeros, whatever the view holds there.  Any Sq and Skv are taken:
// a ragged last tile is cut by its length, never padded.  The window is a
// runtime int, so one build serves gemma3's local (512) and global (0)
// layers.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q (B, Sq, Hq, DQK)   k (B, Skv, Hkv, DQK)   v (B, Skv, Hkv, DV)
//   out (B, Sq, Hq, DV)  q_off, kv_valid_len (B,) int32 or null
//   lse (B, Hq, Sq) fp32 or null: where given (a whole prefill under
//   autograd), each row's log-sum-exp of its scaled scores, in natural
//   units, for the backward (flash_attention_bwd.cu); its stores change no
//   arithmetic, so out keeps its bits with or without it
// q, k, v and out share one type.  Builds, in bf16 and in fp32: (DQK, DV)
// in (64, 64), (80, 80), hubert-xlarge's heads, (128, 128), (256, 256)
// and (192, 128), deepseek-v2-lite's MLA prefill (nope 128 + rope 64 for
// q/k, 128 for v) at its own widths; fp32 also (48, 32), its reduced MLA
// widths (the narrow fp32 runs on the card).
//
// Bound: operations at the prompt lengths the models prefill (S in the
// hundreds to thousands): 2*(DQK + DV) flops per admitted (query head,
// query, key) against q, k, v and out read or written once; on Hopper
// only wgmma reaches the tensor cores' full bf16 rate.
//
// Design (bf16), warp-specialised on wgmma and TMA.  What bounded the
// mma.sync body (FlashAttention-2: four warps of 16 rows, each reading
// every K/V tile from shared memory through ldmatrix): Ampere's
// instruction set, so at most a fraction of the tensor cores' rate, and
// per-warp reads of each tile.  A block is one or two consumer
// warpgroups (`warpgroups`: two where O, S and P fit the registers of a
// 288-thread block; one at (256, 256), at 128-key tiles, and at (64, 64),
// whose 64-row blocks fit two an SM), each
// owning 64 query positions with its own key range, and one producer
// warp; blocks of 64 or 128 positions per (b, query head), the longest
// causal chain first.  One thread of the producer warp issues every load
// as a TMA copy (cp.async.bulk.tensor, 4-d tensor maps over the model
// layout, encoded by the C entry point through cudaGetDriverEntryPoint,
// passed as __grid_constant__ parameters): q's tiles once, then each key
// tile's K and V into a ring of kStages (2) stages (deeper rings timed
// no faster), arrivals reported through mbarriers (`full_k`, `full_v`), each
// stage given back by every consumer warp through others (`empty_k`,
// `empty_v`): K once S is read, V once P V is summed.  Tiles land
// 128-byte swizzled in blocks of 64 columns (wgmma.cuh); TMA zero-fills
// what lies past the tensors' edges (rows past Sq or Skv, columns
// 80..127 of the (80, 80) build's second block).  A consumer warpgroup
// runs S = Q K^T as wgmma.m64nKNk16 with both operands in shared memory
// (K-major), and O += P V as m64nDVk16 with P re-packed to bf16 in
// registers and V an MN-major B under the transpose bit; S of tile t and
// P V of tile t - 1 are issued together, and tile t's softmax (fp32, the
// template's conventions, attention_mma.cuh: masked scores -1e30,
// weights selected to an exact 0, denominator floored at 1e-30) runs
// while P V is on the tensor cores; the two warpgroups of a block
// overlap each other's softmax too.  Only tiles that cross a mask
// boundary evaluate masks; the others take the row max on the raw
// scores and each weight as ex2 of one fma, with no branch in the
// unrolled loops (a branch an element would serialise them).  A K/V
// tile is read from shared memory once per 64 rows, loaded once per 128
// rows with two warpgroups.  The output leaves through shared memory in
// 16-byte stores (a fragment's own 4-byte stores touch eight rows an
// instruction).  KN, the key tile, is a template
// parameter chosen at run time (the `key_tile` argument; the wrapper
// resolves it through the autotuner's cache, kernels/flash_attention/
// ops.py): 32, 64 or 128 wherever the ring fits the card's 227 KiB of
// shared memory a block and O, S and P take at most 176 fp32 registers a
// thread (every build but 128 at DQK = 256); by default 64.  Keys at or
// past kv_valid_len inside the cache view (the chunk form's stale
// scratch) are zeroed in the V stage by the consumers before P V, in the
// one tile that crosses kv_valid_len.  GQA: the G query heads of kv head
// h read the same K/V tiles, which their blocks (launched side by side)
// share through L2.  Key tiles start at absolute multiples of the key
// tile, from position 0, whatever q_off, and a warpgroup's rows walk
// their own range: a query row walks the same tiles in the same order
// in a chunk as in the whole prefill, so where q_off is a multiple of
// the query tile (64) the chunk's rows equal the whole prefill's rows
// bit for bit.  Tiles are skipped in absolute positions: causal tiles
// past the query tile's last position, with a window tiles wholly before
// q0 - window + 1, and tiles wholly at or past kv_valid_len.
//
// Design (fp32, redesigned for the H100): FlashAttention-2's grid, query
// tiles and masks, K/V tiles through cp.async into a double-buffered ring,
// with both products on the tensor cores at fp32 accuracy:
// mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh: each operand split into a
// TF32 high part and the TF32 of its residual, hi lo + lo hi + hi hi
// summed in fp32; single-pass TF32 would keep three digits).
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
// What is left (bf16): the blocks' fixed costs (launch, barriers, q's
// load, the output) are exposed at one block an SM, which the wide-GQA
// prefills (480 and 768 blocks) feel most; a persistent block walking
// several tiles would hide them.  With few heads (gemma3-1b: 4) the
// causal critical path, the last query tile's whole chain of key tiles,
// sits on one SM; splitting long query tiles' key ranges across blocks
// (with the same split in a chunk as in the whole prefill, so the bits
// hold) is later work.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

using tc::bf16;

constexpr int kMmaRows = 64;   // query positions per tile (a warpgroup's)
constexpr int kMaxWarpgroups = 2;  // bf16: consumer warpgroups a block, at most
constexpr int kProducerWarps = 1;  // bf16: the TMA warp
constexpr int kStages = 2;         // bf16: the K/V ring's stages
constexpr int kF32Threads = 256;   // fp32: 4 pairs of warps

constexpr size_t kMaxSmem = 227 * 1024;  // opt-in shared memory a block
// the fp32 registers a bf16 thread may give O, S and P (packed) together:
// with one consumer warpgroup (a block of 160 threads, one an SM), and
// with two (288 threads count as three warpgroups: 168 registers a thread)
constexpr int kAccFloats = 176;
constexpr int kTwoWgFloats = 120;

// the registers O, S and P take a bf16 thread at key tile KN: O, S, and P
// in bf16 pairs (64 rows over the warpgroup's 128 threads)
template <int DV, int KN>
__host__ __device__ constexpr int acc_floats() {
  return DV / 2 + KN / 2 + KN / 4;
}

// a bf16 instance's consumer warpgroups: two (128 query positions
// reading each K/V tile once) where the accumulators fit the registers
// of two, else one; one at DV = 64 too, whose 64-row blocks fit two an SM
// (measured faster there)
template <int DV, int KN>
__host__ __device__ constexpr int warpgroups() {
  return DV > 64 && acc_floats<DV, KN>() <= kTwoWgFloats ? kMaxWarpgroups
                                                          : 1;
}
template <int DV, int KN>
__host__ __device__ constexpr int wg_threads() {
  return 128 * warpgroups<DV, KN>() + 32 * kProducerWarps;
}

// the bf16 body's shared memory at key tile KN, byte offsets from a
// 1024-byte boundary: each warpgroup's 64 rows of q, then kStages stages
// of K and of V (KN rows each), each tile in blocks of 64 columns of KN
// (q: 64) rows x 128 bytes, 128-byte swizzled (wgmma.cuh), the last block
// of an 80-wide tile half zeros; then the mbarriers (K and V arrived, K
// and V given back, of each stage; q's)
template <int DQK, int DV, int KN>
struct WgLayout {
  static constexpr int kQb = (DQK + 63) / 64;   // blocks of q and k
  static constexpr int kVb = (DV + 63) / 64;    // blocks of v
  static constexpr uint32_t kQBlk = kMmaRows * 128;
  static constexpr uint32_t kKBlk = KN * 128;
  static constexpr uint32_t kQBytes = kQb * kQBlk;  // a warpgroup's q
  static constexpr uint32_t oQ = 0;
  static constexpr uint32_t oK = oQ + warpgroups<DV, KN>() * kQBytes;
  static constexpr uint32_t oV = oK + kStages * kQb * kKBlk;
  static constexpr uint32_t oBar = oV + kStages * kVb * kKBlk;
  // 1024 bytes of slack to align the start
  static constexpr size_t bytes = 1024 + oBar + 8 * (4 * kStages + 1);
};

// shared memory of the (T, DQK, DV) build at key tile KN.  bf16:
// WgLayout.  fp32: q (64 rows of DQK), K ring (2 tiles of KN keys of
// DQK), V ring (2 tiles of KN keys of DV), rows padded by 4 floats, each
// pair's P (16 rows of KN + 8) and the 8 warps' row maxima (16 each)
template <typename T, int DQK, int DV, int KN>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int pad = tf::kPad;
    return sizeof(T) *
           (static_cast<size_t>(kMmaRows + 2 * KN) * (DQK + pad) +
            static_cast<size_t>(2 * KN) * (DV + pad) +
            4 * 16 * (KN + tf::kPadP) + 8 * 16);
  } else {
    return WgLayout<DQK, DV, KN>::bytes;
  }
}

// whether a (T, DQK, DV) build has a key tile of KN: its ring fits, and
// in fp32 its keep mask (at most 64 keys), in bf16 its accumulators
// (acc_floats, kAccFloats at most: 128 keys at DV = 256 would spill)
template <typename T, int DQK, int DV, int KN>
__host__ __device__ constexpr bool mma_fits() {
  if constexpr (std::is_same<T, float>::value)
    return mma_smem_bytes<T, DQK, DV, KN>() <= kMaxSmem && KN <= 64;
  else
    return mma_smem_bytes<T, DQK, DV, KN>() <= kMaxSmem &&
           acc_floats<DV, KN>() <= kAccFloats;
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

// mbarriers and TMA copies (shared addresses as 32-bit ints)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the inits made visible to the async proxy (TMA's completions)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive, and expect `bytes` more of TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// bf16 body: grid n_bt * B * Hq over blocks of 64 WGS query positions
// (WGS = warpgroups<DV, KN>()), the last first; key tiles of KN keys.
// Threads 0..128 WGS - 1 are the consumer warpgroups, warpgroup w owning
// positions 64 w.. of the block with its own key range (so its rows are
// those of a 64-row tile, whatever block holds them); the last warp is
// the producer.  tq, tk, tv: the tensor maps of q, k and v (encode_rows).
// The producer walks the union of the warpgroups' key ranges (tiles at
// absolute multiples of KN, so each range is a run of the union's
// tiles); every consumer warp gives every union tile back, read or not.
// K and V stages have barriers of their own: K tile t is given back once
// S_t is read, V tile t once P_t V_t is summed, so each loads a whole
// tile's time ahead of its use.  A warpgroup keeps two products in
// flight: S_t = Q K_t^T and O += P_{t-1} V_{t-1} are issued together,
// and the softmax of S_t runs while P_{t-1} V_{t-1} is on the tensor
// cores; O is rescaled by tile t's correction once that product is
// summed.  Two warpgroups overlap each other's softmax as well.
template <int DQK, int DV, int KN>
__device__ void flash_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                            const CUtensorMap& tv, const Args& p,
                            unsigned char* smem_raw) {
  static_assert(mma_fits<bf16, DQK, DV, KN>(),
                "the K/V ring or the accumulators exceed the block");
  using L = WgLayout<DQK, DV, KN>;
  constexpr int WGS = warpgroups<DV, KN>();
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (s0 - raw);
  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_bt = (p.Sq + WGS * kMmaRows - 1) / (WGS * kMmaRows);
  const int bt = n_bt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq;
  const int hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = bt * WGS * kMmaRows;           // the block's first row
  const int off = query_offset(p, b);           // row i sits at off + i
  // the warpgroups holding rows, and the union of their key ranges: the
  // first's begin, the last's end
  const int n_wg = min(WGS, (p.Sq - q0 + kMmaRows - 1) / kMmaRows);
  auto range_of = [&](int w) {
    const int r0 = q0 + w * kMmaRows;
    return key_range(p, b, off + r0, off + min(r0 + kMmaRows, p.Sq) - 1,
                     KN);
  };
  const int kb_u = range_of(0).begin, ke_u = range_of(n_wg - 1).end;
  const int n_u = ke_u > kb_u ? (ke_u - kb_u + KN - 1) / KN : 0;

  // stage i's barriers at + 8 i: K and V arrived, K and V given back
  const uint32_t full_k = s0 + L::oBar, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t qbar = empty_v + 8 * kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty_k + 8 * i, 4 * WGS);  // each consumer warp
      mbar_init(empty_v + 8 * i, 4 * WGS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warp: one thread loads
    if (lane == 0 && n_u > 0) {
      mbar_expect_tx(qbar, n_wg * L::kQBytes);
      for (int w = 0; w < n_wg; ++w)
#pragma unroll
        for (int j = 0; j < L::kQb; ++j)
          tma_load(s0 + L::oQ + w * L::kQBytes + j * L::kQBlk, &tq, qbar,
                   64 * j, hq, q0 + w * kMmaRows, b);
      for (int t = 0; t < n_u; ++t) {
        const int sg = t % kStages, pos0 = kb_u + t * KN;
        const uint32_t round = (t / kStages - 1) & 1;  // tile t - kStages's
        if (t >= kStages) mbar_wait(empty_k + 8 * sg, round);
        mbar_expect_tx(full_k + 8 * sg, L::kQb * L::kKBlk);
#pragma unroll
        for (int j = 0; j < L::kQb; ++j)
          tma_load(s0 + L::oK + (sg * L::kQb + j) * L::kKBlk, &tk,
                   full_k + 8 * sg, 64 * j, hk, pos0, b);
        if (t >= kStages) mbar_wait(empty_v + 8 * sg, round);
        mbar_expect_tx(full_v + 8 * sg, L::kVb * L::kKBlk);
#pragma unroll
        for (int j = 0; j < L::kVb; ++j)
          tma_load(s0 + L::oV + (sg * L::kVb + j) * L::kKBlk, &tv,
                   full_v + 8 * sg, 64 * j, hk, pos0, b);
      }
    }
    return;
  }

  // a consumer warpgroup: warp w4 of warpgroup wgi owns its rows 16 w4 + g
  // and 16 w4 + g + 8; its tiles are the union's f.. f + ntiles - 1
  const int wgi = warp / 4, wtid = tid % 128;
  const int q0w = q0 + wgi * kMmaRows;            // its first row
  const bool has_rows = wgi < n_wg;
  const bool causal = p.causal != 0;
  const int w = p.window;
  const int q_first = off + q0w;                              // absolute
  const int q_last = off + min(q0w + kMmaRows, p.Sq) - 1;     // absolute
  const KeyRange kr = range_of(wgi);
  const int k_begin = kr.begin, k_end = kr.end;
  const int ntiles = has_rows && k_end > k_begin
                         ? (k_end - k_begin + KN - 1) / KN
                         : 0;
  const int f = ntiles > 0 ? (k_begin - kb_u) / KN : 0;
  const int valid = p.kv_valid_len != nullptr
                        ? min(p.Skv, max(p.kv_valid_len[b], 0))
                        : p.Skv;
  const int t4 = lane & 3;
  const int i0 = (warp % 4) * tc::kWarpRows + lane / 4;  // local row g
  const int a0 = q_first + i0;                      // its absolute position
  const float scale_log2 = p.scale * tc::kLog2e;
  const uint32_t qs = s0 + L::oQ + wgi * L::kQBytes;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {tc::kNegInf, tc::kNegInf}, l[2] = {0.f, 0.f};
  float s[KN / 2];       // S_t, then its weights (the first k-step of S
#pragma unroll           // overwrites them)
  for (int i = 0; i < KN / 2; ++i) s[i] = 0.f;
  uint32_t pk[KN / 4];   // P_{t-1}, bf16 pairs: the A fragments of P V

  // each warp gives union tile u's K or V stage back
  auto give_k = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k + 8 * (u % kStages));
  };
  auto give_v = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v + 8 * (u % kStages));
  };
  // a union tile outside the warpgroup's range: waited for, given back
  auto pass = [&](int u) {
    const uint32_t ph = (u / kStages) & 1;
    mbar_wait(full_k + 8 * (u % kStages), ph);
    give_k(u);
    mbar_wait(full_v + 8 * (u % kStages), ph);
    give_v(u);
  };
  // S_t = Q K_t^T over the head dim, 16 at a time (issued, not waited)
  auto issue_s = [&](int t) {
    const uint32_t kt = s0 + L::oK + ((f + t) % kStages) * L::kQb * L::kKBlk;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wg::ss_t0<KN>(
          s, wg::desc(qs + (kk / 4) * L::kQBlk + (kk % 4) * 32, 16, 1024),
          wg::desc(kt + (kk / 4) * L::kKBlk + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wg::commit();
  };
  // O += P_t V_t (issued, not waited), once V_t has arrived; the view's
  // keys at or past kv_valid_len hold anything: their weights are 0 and
  // their values become 0 here, so P V reads finite values only (rows
  // past Skv TMA zero-filled; a second warpgroup reading the stage writes
  // the same zeros before its own product)
  auto issue_pv = [&](int t) {
    const int sg = (f + t) % kStages, pos0 = k_begin + t * KN;
    mbar_wait(full_v + 8 * sg, ((f + t) / kStages) & 1);
    if (pos0 + KN > valid && valid < p.Skv) {
      const int r0 = valid - pos0, n = KN - r0;
      for (int c = wtid; c < L::kVb * n * 8; c += 128) {
        const int line = c / 8, j = line / n, r = r0 + line % n;
        *reinterpret_cast<uint4*>(sm + L::oV +
                                  (sg * L::kVb + j) * L::kKBlk + r * 128 +
                                  (c % 8) * 16) = make_uint4(0, 0, 0, 0);
      }
      wg::fence_async_smem();  // ... visible to wgmma
      wg::bar_sync(1 + wgi, 128);
    }
    const uint32_t vt = s0 + L::oV + sg * L::kVb * L::kKBlk;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)  // pk's own registers, no copies
      wg::rs_t1<DV>(o, *reinterpret_cast<const uint32_t(*)[4]>(pk + 4 * kk),
                     wg::desc(vt + kk * 16 * 128, L::kKBlk, 1024));
    wg::commit();
  };
  // the online softmax of S_t, its weights left in s, the denominator
  // updated and the correction O takes returned in corr.  A tile needs
  // element masks only where it crosses the key range's end, the diagonal
  // or the window's far edge (kMasked): there row h (absolute position a)
  // admits keys lo <= key < hi, a masked score is -1e30 and its weight
  // exactly 0.  Any other tile takes its max on the raw scores (the scale
  // is positive, so it commutes with the max) and each weight as ex2 of
  // one fma, with no branch in the unrolled loops.
  auto softmax = [&](int t, float (&corr)[2], auto masked_tag) {
    constexpr bool kMasked = decltype(masked_tag)::value;
    const int pos0 = k_begin + t * KN + 2 * t4;   // key of s[4j] is + 8j
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = a0 + 8 * h;
      lo[h] = w > 0 ? a - w + 1 : 0;
      hi[h] = causal ? min(k_end, a + 1) : k_end;
    }
    auto admit = [&](int i) {
      const int h = (i >> 1) & 1, key = pos0 + (i >> 2) * 8 + (i & 1);
      return key >= lo[h] && key < hi[h];
    };
    float mx[2] = {m[0], m[1]};
    if constexpr (kMasked) {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = admit(i) ? s[i] * scale_log2 : tc::kNegInf;
        mx[h] = fmaxf(mx[h], s[i]);
      }
    } else {
      float raw[2] = {s[0], s[2]};
#pragma unroll
      for (int i = 0; i < KN / 2; ++i)
        raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
      mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
      mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = tc::ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int h = (i >> 1) & 1;
      float pw;
      if constexpr (kMasked)
        pw = admit(i) ? tc::ex2(s[i] - mx[h]) : 0.f;
      else
        pw = tc::ex2(fmaf(s[i], scale_log2, -mx[h]));
      s[i] = pw;
      l[h] += pw;
    }
  };
  // tile t's masks, as above
  auto masked_tile = [&](int t) {
    const int pos0 = k_begin + t * KN;
    return pos0 + KN > k_end || (causal && pos0 + KN - 1 > q_first) ||
           (w > 0 && q_last - pos0 >= w);
  };
  // tile t's weights as the A fragments of P V, once P_{t-1} V_{t-1} no
  // longer reads pk (writing pk under that product would serialise the
  // wgmma chain)
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < KN / 4; ++i)
      pk[i] = tc::pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  // the union's tiles before the warpgroup's range; then step t issues
  // S_t and P_{t-1} V_{t-1} and runs tile t's softmax while the second
  // product is summed; then the union's tiles past the range
  for (int u = 0; u < f; ++u) pass(u);
  if (ntiles > 0) {
    mbar_wait(qbar, 0);
    mbar_wait(full_k + 8 * (f % kStages), (f / kStages) & 1);
    issue_s(0);
    wg::wait<0>();
    wg::fence_regs(s);
    give_k(f);  // K_0 is read
    float corr[2];     // O is zero: nothing to rescale
    if (masked_tile(0))
      softmax(0, corr, std::true_type{});
    else
      softmax(0, corr, std::false_type{});
    pack();
  }
  for (int t = 1; t < ntiles; ++t) {
    const int u = f + t;
    mbar_wait(full_k + 8 * (u % kStages), (u / kStages) & 1);
    issue_s(t);
    issue_pv(t - 1);
    wg::wait<1>();    // S_t is summed; P_{t-1} V_{t-1} may run on
    wg::fence_regs(s);
    give_k(u);        // K_t is read
    float corr[2];
    if (masked_tile(t))
      softmax(t, corr, std::true_type{});
    else
      softmax(t, corr, std::false_type{});
    wg::wait<0>();    // P_{t-1} V_{t-1} is summed
    wg::fence_regs(o);
    give_v(u - 1);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack();
  }
  if (ntiles > 0) {
    issue_pv(ntiles - 1);
    wg::wait<0>();
    wg::fence_regs(o);
    give_v(f + ntiles - 1);
  }
  for (int u = f + ntiles; u < n_u; ++u) pass(u);
  if (!has_rows) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // the output tile leaves through shared memory (the warpgroup's q
  // region, which no product reads any more), so each row goes out in
  // 16-byte stores: row r's 16-byte chunk c sits at slot c ^ (r % 8), so
  // neither the fragment writes nor the row reads meet on a bank
  constexpr int kCh = DV / 8;  // 16-byte chunks a row
  constexpr int kSlots = kCh <= 8 ? 8 : kCh <= 16 ? 16 : 32;
  static_assert(kMmaRows * kSlots * 16 <= L::kQBytes,
                "the output tile exceeds the q region");
  if (ntiles == 0 && n_u > 0) mbar_wait(qbar, 0);  // q's copy has landed
  unsigned char* os = sm + L::oQ + wgi * L::kQBytes;
  float* lse = p.lse;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = i0 + 8 * hh, i = q0w + r;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int n = 0; n < kCh; ++n)
      *reinterpret_cast<uint32_t*>(os + (r * kSlots + (n ^ (r & 7))) * 16 +
                                   4 * t4) =
          tc::pack_bf16(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
    // the running max is in base-2 units of the scaled scores
    if (lse != nullptr && t4 == 0 && i < p.Sq)
      lse[(static_cast<size_t>(b) * p.Hq + hq) * p.Sq + i] =
          (m[hh] + log2f(l[hh])) * tc::kLn2;
  }
  wg::bar_sync(1 + wgi, 128);
  bf16* out = static_cast<bf16*>(p.out);
  for (int c = wtid; c < kMmaRows * kCh; c += 128) {
    const int r = c / kCh, ch = c % kCh, i = q0w + r;
    if (i < p.Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + hq) * DV +
          8 * ch) = *reinterpret_cast<const uint4*>(
          os + (r * kSlots + (ch ^ (r & 7))) * 16);
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

// the fp32 kernel, and the bf16 one (an overload of the same name, so a
// build is named flash_attention_kernel<type, DQK, DV, KN> either way)
template <typename T, int DQK, int DV, int KN>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_kernel(Args p) {
  static_assert(std::is_same<T, float>::value, "the fp32 body");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash_tf32<DQK, DV, KN>(p, smem_raw);
}

template <typename T, int DQK, int DV, int KN>
__global__ void __launch_bounds__(wg_threads<DV, KN>(), 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Args p) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 body");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash_wgmma<DQK, DV, KN>(tq, tk, tv, p, smem_raw);
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a contiguous (B, S, H, D) bf16 tensor at `base`, read
// in boxes of 64 columns of one head by `rows` positions, 128-byte
// swizzled; what lies past the tensor's edge (positions past S, columns
// past D) arrives as zeros.  False if it cannot be encoded (the wrapper
// checks the base and the strides, multiples of 16 bytes).
bool encode_rows(CUtensorMap* map, const void* base, int B, int S, int H,
                 int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's dynamic shared memory opted in past 48 KiB
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int DQK, int DV, int KN>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<T, DQK, DV, KN>();
  if constexpr (std::is_same<T, float>::value) {
    const int grid = (a.Sq + kMmaRows - 1) / kMmaRows * a.B * a.Hq;
    void (*kern)(Args) = flash_attention_kernel<T, DQK, DV, KN>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, kF32Threads, smem, stream>>>(a);
  } else {
    CUtensorMap tq, tk, tv;
    if (!encode_rows(&tq, a.q, a.B, a.Sq, a.Hq, DQK, kMmaRows) ||
        !encode_rows(&tk, a.k, a.B, a.Skv, a.Hkv, DQK, KN) ||
        !encode_rows(&tv, a.v, a.B, a.Skv, a.Hkv, DV, KN))
      return static_cast<int>(cudaErrorInvalidValue);
    void (*kern)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 Args) = flash_attention_kernel<T, DQK, DV, KN>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    constexpr int rows = warpgroups<DV, KN>() * kMmaRows;  // a block's
    const int grid = (a.Sq + rows - 1) / rows * a.B * a.Hq;
    kern<<<grid, wg_threads<DV, KN>(), smem, stream>>>(tq, tk, tv, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the (T, DQK, DV) build: bf16 at key tile `key_tile`, 32, 64, or 128
// where its ring and accumulators fit (mma_fits), anything else refused;
// fp32 at its one
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
