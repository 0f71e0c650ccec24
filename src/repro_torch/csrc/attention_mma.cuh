// Tensor-core pieces shared by the port's bf16 attention kernels:
//   tree_attention_paged.cu  (K1 paged tree verify, K4 windowed, K2 dense)
//   flash_attention.cu       (K3 prefill attention)
//
// A warp owns 16 query rows.  Q, K and V tiles sit in shared memory as
// bf16, row-major with rows padded by 8 elements (16 bytes), so the eight
// row addresses of one ldmatrix phase fall on distinct banks.  Tiles come
// in through cp.async (16 bytes a thread, zero-filled without a read where
// a position is excluded), double-buffered by the callers.
//
// S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate).  Register layouts (PTX ISA; g = lane / 4, t = lane % 4):
//   A (16 rows x 16 k):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                        a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B (16 k x 8 cols):   b0 (2t..2t+1, g)   b1 (2t+8.., g)
//   C (16 x 8, fp32):    c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// So the score accumulators of two adjacent 8-key tiles are, packed to
// bf16, the A operand of P V: P never leaves the registers.
//
// The online softmax stays in fp32 registers, with the conventions of the
// Pallas template (src/repro/kernels/attention_template/kernel.py::
// _softmax_update), which the fp32 bodies keep as well (tf32_mma.cuh): a
// rejected key scores -1e30 and gets weight exactly 0 by selection, the
// running max starts at -1e30, and the caller floors the denominator at
// 1e-30.  Row max and sum are reduced over the 4 threads of a quad.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpRows = 16;      // query rows per warp (one mma M tile)
constexpr int kPad = 8;            // bf16 elements of row padding
constexpr float kNegInf = -1e30f;  // masked score

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; when `pred` is false nothing is
// read and the 16 bytes are zero-filled (`src` must still be a valid
// address: callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b: one m16n8k16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 pair of (x0, x1) and the bf16 pair of what it rounded off, so
// that big + small carries x to about 16 bits of mantissa
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t& big, uint32_t& small) {
  __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 bf = __bfloat1622float2(b);
  big = *reinterpret_cast<uint32_t*>(&b);
  small = pack_bf16(x0 - bf.x, x1 - bf.y);
}

// Copies ROWS rows of DW bf16 (a multiple of 8) from global memory to
// shared memory (row stride DW + kPad) with NT threads, 16 bytes each:
// `src(r)` gives row r's global address, or nullptr for a row to
// zero-fill without a read.  The trip count is a constant, so the loop
// unrolls without branches.
template <int DW, int ROWS, int NT, typename Src>
__device__ __forceinline__ void load_rows(bf16* dst, int tid,
                                          const bf16* base, Src src) {
  constexpr int kChunks = DW / 8, kAll = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kAll + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (kAll % NT != 0 && c >= kAll) break;
    const int r = c / kChunks, ch = c % kChunks;
    const bf16* g = src(r);
    cp_async16(dst + r * (DW + kPad) + ch * 8, g ? g + ch * 8 : base,
               g != nullptr);
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (flushes denormals; 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The running state of a warp's two rows per thread (g and g + 8): max
// (of the scores in base-2 units, see tile_mma), this thread's share of
// the denominator, and the output accumulator o[n][.] for value columns
// 8n..8n+7.
template <int DV>
struct RowState {
  float m[2];
  float l[2];
  float o[DV / 8][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // the denominator summed over the quad (call once, at the end)
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// One key tile of KN keys for a warp's 16 rows: scores on the tensor
// cores, the online-softmax update in registers, then P V on the tensor
// cores.  q: the warp's 16 rows (stride DQK + kPad); k: KN rows (stride
// DQK + kPad); v: KN rows (stride DV + kPad).  `scale_log2` is the score
// scale times log2(e): the softmax runs in base 2 (exp(x) = 2^(x log2 e)),
// so each weight is one ex2, and the running max is in those units.
// Key kk is admitted for the
// thread's row half h (0: row g, 1: row g + 8) iff `admit(h, kk)`; with
// `masked` false every key is admitted and `admit` is not called.  The
// caller zero-fills every key it did not load, so P V reads only finite
// values (a rejected key's weight is an exact 0, selected).  With
// kSplitP, P enters P V as two bf16 parts (P rounded, then what the
// rounding dropped), so the weights keep ~16 bits instead of bf16's 8 at
// twice the P V products: the tree-verify kernel, bound by its loads,
// takes it to stay close to an fp32-weight softmax.
template <int DQK, int DV, int KN, bool kSplitP = false, typename Admit>
__device__ __forceinline__ void tile_mma(const bf16* q, const bf16* k,
                                         const bf16* v, float scale_log2,
                                         RowState<DV>& st, bool masked,
                                         Admit admit) {
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && KN % 16 == 0, "tiles");
  constexpr int QS = DQK + kPad, VS = DV + kPad;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  // S = Q K^T over the head dim, 16 at a time
  float s[KN / 8][4];
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < DQK / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, q + a_row * QS + kc * 16 + a_col);
#pragma unroll
    for (int j = 0; j < KN / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, k + (j * 8 + b_row) * QS + kc * 16 + b_col);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }

  // online softmax: scale, mask by selection, row max over the quad;
  // bit 4j + e of `keep` says whether s[j][e] was admitted (64 bits past
  // 64 keys, K3's key tile of 128)
  using Keep = std::conditional_t<(KN > 64), uint64_t, uint32_t>;
  static_assert(KN / 8 * 4 <= 64, "one bit per score of the thread");
  float mx[2] = {st.m[0], st.m[1]};
  Keep keep = ~Keep(0);
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, kk = j * 8 + 2 * t + (e & 1);
      float x = s[j][e] * scale_log2;
      if (masked && !admit(h, kk)) {
        x = kNegInf;
        keep &= ~(Keep(1) << (j * 4 + e));
      }
      s[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = ex2(st.m[h] - mx[h]);
    st.m[h] = mx[h];
    st.l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p =
          (keep >> (j * 4 + e)) & Keep(1) ? ex2(s[j][e] - mx[h]) : 0.f;
      s[j][e] = p;
      st.l[h] += p;
    }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }

  // O += P V: P re-packed to bf16 A fragments in registers
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KN / 16; ++kc) {
    uint32_t a[4], a_lo[4];
    if constexpr (kSplitP) {
      split_bf16(s[2 * kc][0], s[2 * kc][1], a[0], a_lo[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], a[1], a_lo[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], a[2], a_lo[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], a[3], a_lo[3]);
    } else {
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < DV / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, v + (kc * 16 + v_row) * VS + n * 8 + v_col);
      mma_bf16(st.o[n], a, b[0], b[1]);
      mma_bf16(st.o[n + 1], a, b[2], b[3]);
      if constexpr (kSplitP) {
        mma_bf16(st.o[n], a_lo, b[0], b[1]);
        mma_bf16(st.o[n + 1], a_lo, b[2], b[3]);
      }
    }
  }
}

}  // namespace tc
