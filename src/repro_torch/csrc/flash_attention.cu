// Prefill attention for Hopper (sm_90a), plain C interface: S x S
// attention, causal, with an optional sliding window and GQA.
//
// Replaces the TPU kernel K3
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (-> attention_template/kernel.py::self_attention, TemplateSpec
//    kind="self").
//
// What it computes: for each (b, query head), query position i attends to
// key position k of the same sequence iff (not causal or k <= i) and
// (window <= 0 or i - k < window); query head h*G + g reads kv head h.
// Positions are the sequence indices 0..S-1: the port's prefill passes
// consecutive positions, so the masks depend only on index differences.
// Any S is taken: a ragged last tile is cut by its length (keys past S
// are zero-filled, never read, and rejected), never padded.  The window is
// a runtime int, so one build serves gemma3's local (512) and global (0)
// layers.
//
// Layout (the model layout the wrapper receives), contiguous:
//   q (B, S, Hq, DQK)   k (B, S, Hkv, DQK)   v (B, S, Hkv, DV)
//   out (B, S, Hq, DV)
// q, k, v and out share one type.  bf16 builds: (DQK, DV) in (64, 64),
// (128, 128), (256, 256) and (192, 128), deepseek-v2-lite's MLA prefill
// (nope 128 + rope 64 for q/k, 128 for v) at its own widths.  fp32 builds
// take DQK = DV in {64, 128, 256}; the wrapper pads other widths for fp32
// alone.
//
// Bound: operations at the prompt lengths the models prefill (S in the
// hundreds to thousands): 2*(DQK + DV) flops per admitted (query head,
// query, key) against q, k, v and out read or written once.
//
// Design (bf16), FlashAttention-2 on mma.sync: one block of four warps
// per (tile of 64 query positions, b, query head); each warp owns 16
// query rows.  Q comes in once; key tiles of 64 (32 at DQK = 256, to keep
// the accumulator in registers) come in through cp.async into a
// double-buffered ring in shared memory, so the next tile loads while this
// one computes.  S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate); P is re-packed to bf16 in registers as the A operand;
// the online softmax and the accumulator stay in fp32 registers, with the
// template's conventions (attention_mma.cuh).  GQA: the G query heads of
// kv head h read the same K/V tiles, which their blocks (launched side by
// side) share through L2.  Causal key tiles past the query tile's last
// position are never visited; with a window, tiles wholly before
// q0 - window + 1 are skipped; only the tiles that cross a mask boundary
// (or S) are masked element by element.  Query tiles are launched longest
// causal chain first.
//
// fp32 keeps the first version's CUDA-core body: one thread block per
// (b, kv head, tile of at most 16 query positions) holding the G*BQ rows
// that share the kv head, 16-key tiles through online_softmax.cuh.
//
// Every warp reads each K/V tile from shared memory (ldmatrix) for its 16
// rows, so a block's key tiles cost shared-memory bandwidth in proportion
// to its rows; with few heads (gemma3-1b: 4) the causal critical path, the
// last query tile's whole chain of key tiles, sits on one SM.  wgmma (one
// read of K/V per 64 rows), splitting long query tiles' key ranges across
// blocks and chunked prefill (a query offset with kv_valid_len) are later
// work.
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

template <int DQK>
__host__ __device__ constexpr int mma_keys() {
  return DQK >= 256 ? 32 : 64;
}

// bf16 shared memory: q (64 rows of DQK), K ring (2 tiles of DQK), V ring
// (2 tiles of DV); rows padded by 8 bf16
template <int DQK, int DV>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) *
         (static_cast<size_t>(kMmaRows + 2 * mma_keys<DQK>()) *
              (DQK + tc::kPad) +
          static_cast<size_t>(2 * mma_keys<DQK>()) * (DV + tc::kPad));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, S, Hq, Hkv, bq, causal, window;
  float scale;
};

// bf16 body: grid n_qt * B * Hq, the last query tile first.
template <int DQK, int DV>
__device__ void flash_mma(const Args& p, unsigned char* smem_raw) {
  constexpr int KN = mma_keys<DQK>();
  constexpr int QS = DQK + tc::kPad, VS = DV + tc::kPad;
  const int G = p.Hq / p.Hkv;
  const int heads = p.B * p.Hq;
  const int n_qt = (p.S + kMmaRows - 1) / kMmaRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hq;
  const int hq = blockIdx.x % p.Hq;
  const int hk = hq / G;
  const int q0 = qt * kMmaRows;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kMmaRows * QS;
  bf16* vs = ks + 2 * KN * QS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  // rows past S are computed on zeros and never stored
  tc::load_rows<DQK, kMmaRows, kMmaThreads>(
      qs, tid, q, [&](int r) -> const bf16* {
        const int i = q0 + r;
        if (i >= p.S) return nullptr;
        return q + ((static_cast<size_t>(b) * p.S + i) * p.Hq + hq) * DQK;
      });

  const bool causal = p.causal != 0;
  const int w = p.window;
  const int q_last = min(q0 + kMmaRows, p.S) - 1;
  const int k_end = causal ? q_last + 1 : p.S;
  const int k_begin = w > 0 ? max(0, q0 - w + 1) / KN * KN : 0;
  const int ntiles = (k_end - k_begin + KN - 1) / KN;
  auto kv_row = [&](int pos) {
    return (static_cast<size_t>(b) * p.S + pos) * p.Hkv + hk;
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
  const int i0 = q0 + warp * tc::kWarpRows + lane / 4;  // row g; g+8: +8
  const float scale_log2 = p.scale * tc::kLog2e;
  issue(0);  // the first group carries q as well
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      issue(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int sg = it & 1, pos0 = k_begin + it * KN;
    // a tile needs element masks only where it crosses S (or the causal
    // end), the diagonal or the window's far edge
    const bool masked = pos0 + KN > k_end ||
                        (causal && pos0 + KN - 1 > q0) ||
                        (w > 0 && q_last - pos0 >= w);
    tc::tile_mma<DQK, DV, KN>(
        qs + warp * tc::kWarpRows * QS, ks + sg * KN * QS, vs + sg * KN * VS,
        scale_log2, st, masked, [&](int hh, int kk) {
          const int key = pos0 + kk, dq = i0 + 8 * hh - key;
          return key < k_end && (!causal || dq >= 0) && (w <= 0 || dq < w);
        });
    __syncthreads();  // the next issue overwrites this stage
  }

  st.reduce_l();
  bf16* out = static_cast<bf16*>(p.out);
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + 8 * hh;
    if (i >= p.S) continue;
    const float inv = 1.f / fmaxf(st.l[hh], 1e-30f);
    bf16* o = out + ((static_cast<size_t>(b) * p.S + i) * p.Hq + hq) * DV;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) = tc::pack_bf16(
          st.o[n][2 * hh] * inv, st.o[n][2 * hh + 1] * inv);
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
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int b = (blockIdx.x % heads) / p.Hkv;
  const int h = blockIdx.x % p.Hkv;
  const int q0 = qt * BQ;

  const Smem sm = attn::carve_smem<D>(smem, R);
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / BQ, pos = q0 + r % BQ;
    float x = 0.f;  // rows past S are computed on zeros and never stored
    if (pos < p.S)
      x = q[((static_cast<size_t>(b) * p.S + pos) * p.Hq + h * G + g) * D +
            d] *
          p.scale;
    sm.q[r * DP + d] = x;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
    sm.pos[r] = q0 + r % BQ;
  }
  float acc[KMAX];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) acc[kk] = 0.f;
  __syncthreads();

  const bool causal = p.causal != 0;
  const int w = p.window;
  const int k_end = causal ? min(q0 + BQ, p.S) : p.S;
  const int k_begin = w > 0 ? max(0, q0 - w + 1) : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeyTile) {
    const int n = min(kKeyTile, k_end - k0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const size_t off =
          ((static_cast<size_t>(b) * p.S + k0 + kk) * p.Hkv + h) * D + d;
      sm.k[kk * DP + d] = k[off];
      sm.v[kk * DP + d] = v[off];
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
      const int g = r / BQ, pos = q0 + r % BQ;
      if (pos < p.S) {
        const size_t off =
            ((static_cast<size_t>(b) * p.S + pos) * p.Hq + h * G + g) * D + d;
        out[off] = acc[kk] / fmaxf(sm.l[r], 1e-30f);
      }
    }
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value) {
    static_assert(DQK == DV, "the fp32 body takes one head dim");
    flash_f32<DQK>(p, reinterpret_cast<float*>(smem_raw));
  } else {
    flash_mma<DQK, DV>(p, smem_raw);
  }
}

template <typename T, int DQK, int DV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const size_t smem = kF32 ? attn::smem_bytes((a.Hq / a.Hkv) * a.bq, DQK)
                           : mma_smem_bytes<DQK, DV>();
  auto kern = flash_attention_kernel<T, DQK, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = kF32 ? a.bq : kMmaRows;
  const int n_qt = (a.S + rows - 1) / rows;
  const int blocks = n_qt * a.B * (kF32 ? a.Hkv : a.Hq);
  kern<<<blocks, kF32 ? kThreads : kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; causal: 0 or 1; window <= 0: no window.
// Returns the CUDA error code of the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Hq, int Hkv,
                               int Dqk, int Dv, int causal, int window,
                               int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, B, S, Hq, Hkv, 0, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Dqk == 64 && Dv == 64) return launch<bf16, 64, 64>(a, s);
    if (Dqk == 128 && Dv == 128) return launch<bf16, 128, 128>(a, s);
    if (Dqk == 256 && Dv == 256) return launch<bf16, 256, 256>(a, s);
    if (Dqk == 192 && Dv == 128) return launch<bf16, 192, 128>(a, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 || Dqk != Dv) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = attn::max_rows(Dqk, kRowCap) / (Hq / Hkv);
  a.bq = fit < kQTile ? fit : kQTile;
  if (a.bq < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dqk) {
    case 64: return launch<float, 64, 64>(a, s);
    case 128: return launch<float, 128, 128>(a, s);
    case 256: return launch<float, 256, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
