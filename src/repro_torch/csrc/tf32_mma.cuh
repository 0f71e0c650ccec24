// Tensor-core pieces of the port's fp32 attention kernels at fp32
// accuracy ("3xTF32", CUTLASS's OpMultiplyAddFastF32):
//   flash_attention.cu       (K3 prefill attention, fp32 builds)
//   flash_attention_bwd.cu   (K3's backward, fp32 builds)
//   tree_attention_paged.cu  (the tree-verify kernel K1 / K4 / K2, fp32
//                             builds)
//   mla_attention_paged.cu   (K5 and its windowed form, fp32 builds)
//   linear_attn_chunk.cu     (K6, fp32 builds)
//   linear_attn_chunk_bwd.cu (K6's backward, fp32 builds)
//
// Each fp32 operand x is split into a TF32 high part hi and the TF32 of
// its residual lo = x - hi (`split`), so hi + lo carries x to about 21
// bits of mantissa.  A product a b is summed as lo_a hi_b + hi_a lo_b +
// hi_a hi_b on mma.sync.m16n8k8 (tf32 in, fp32 accumulate): only lo_a lo_b
// (under 2^-20 relative) is dropped.  One TF32 pass alone keeps about
// three decimal digits, too few for the fp32 tolerances.
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands K-major only, so
// P V would need V transposed in shared memory each key tile (and dV, dK
// and dQ their B operands likewise); mma.sync's fragments are built from
// plain row-major fp32 tiles with conflict-free 32-bit loads (the layouts
// below), and a permuted k axis lets a C fragment's layout serve as an A
// fragment's.
//
// Register layouts of m16n8k8.tf32 (PTX ISA; g = lane / 4, t = lane % 4):
//   A (16 rows x 8 k):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 k x 8 cols):   b0 (t, g)  b1 (t+4, g)
//   C (16 x 8, fp32):   c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// A C fragment holds columns 2t and 2t+1, an A fragment columns t and t+4.
// So where the k axis is a sum's index (P V: the keys; dV, dK, dQ: the
// queries or keys), k is PERMUTED: the mma's k slot t takes index 2t and
// slot t+4 index 2t+1 of the 8.  The sum is the same (its order within one
// mma is the hardware's either way); a tile written from C fragments
// (P, dS) is read back as A fragments with one 8-byte load a row, and B's
// rows 2t, 2t+1 are read in place of t, t+4.
//
// Shared memory: fp32 rows padded to a stride of D + 4 floats (kPad), so
// that the 32 lanes' loads of (row g, column t) and of (row 2t, column g)
// fall on 32 distinct banks at any D that is a multiple of 8; a permuted
// A operand from shared memory (rows g, columns 2t, 2t+1) is one 8-byte
// load from rows of stride 8 mod 32 (kPadP: 40 for 32 columns).  Tiles
// come in through cp.async, 16 bytes a thread, zero-filled without a read
// where a position is excluded.
#pragma once

#include <stdint.h>

#include "attention_mma.cuh"

namespace tf {

constexpr int kPad = 4;   // floats of row padding of an operand tile
constexpr int kPadP = 8;  // floats of row padding of a permuted A tile

// the TF32 bits of x (its sign, exponent and top 10 mantissa bits; the
// low 13 bits cleared): x truncated toward zero, one logic instruction
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// hi + lo = x to ~21 bits: hi = x truncated to TF32, lo = the residual x -
// hi (exact in fp32) truncated to TF32.  Truncation drops under 2^-10 of
// x into lo and under 2^-21 of x past it; cvt.rna.tf32.f32 would round
// instead, at several instructions a conversion on sm_90 (measured: the
// whole fp32 body 1.3x slower with it)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b: one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment's high and low TF32 parts
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a b at fp32 accuracy: the small products first, then hi hi
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi[0], b.hi[1]);
  mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

// the same into two accumulators, the small products into `small` and hi
// hi into `big` (summed by the caller, big + small): two independent mma
// chains where one accumulator would chain all three.
//
// Accumulation: the tensor cores add each product into the fp32
// accumulator without IEEE rounding, so a long chain of mma on one
// accumulator drifts (measured: output errors growing with the keys a row
// reads, 1.2e-5 relative at 1536 bidirectional keys, and a gradient check
// 2.2e-5 off where the CUDA-core kernel read 1.8e-6).  So every sum over
// more than one tile is taken in fresh accumulators a tile (or step) and
// added into its running total with an fp32 add, and the hi hi chain of a
// long dot product (S over the head dim) is split over two accumulators.
__device__ __forceinline__ void mma3(float (&small)[4], float (&big)[4],
                                     const FragA& a, const FragB& b) {
  mma(small, a.lo, b.hi[0], b.hi[1]);
  mma(small, a.hi, b.lo[0], b.lo[1]);
  mma(big, a.hi, b.hi[0], b.hi[1]);
}

// A from 16 rows x 8 columns at `p` (row stride S, k not permuted):
// (g, t), (g+8, t), (g, t+4), (g+8, t+4)
template <int S>
__device__ __forceinline__ void load_a(FragA& f, const float* p, int g,
                                       int t) {
  split(p[g * S + t], f.hi[0], f.lo[0]);
  split(p[(g + 8) * S + t], f.hi[1], f.lo[1]);
  split(p[g * S + t + 4], f.hi[2], f.lo[2]);
  split(p[(g + 8) * S + t + 4], f.hi[3], f.lo[3]);
}

// A with k permuted, from 16 rows x 8 columns at `p` (row stride S, 8 mod
// 32): (g, 2t..2t+1) and (g+8, 2t..2t+1), one 8-byte load each
template <int S>
__device__ __forceinline__ void load_a_perm(FragA& f, const float* p, int g,
                                            int t) {
  const float2 x = *reinterpret_cast<const float2*>(p + g * S + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(p + (g + 8) * S + 2 * t);
  split(x.x, f.hi[0], f.lo[0]);
  split(y.x, f.hi[1], f.lo[1]);
  split(x.y, f.hi[2], f.lo[2]);
  split(y.y, f.hi[3], f.lo[3]);
}

// B = X^T for X's 8 rows (the product's columns) x 8 k at `p` (row
// stride S): (t, g) = X[g][t], (t+4, g) = X[g][t+4]
template <int S>
__device__ __forceinline__ void load_b_t(FragB& f, const float* p, int g,
                                         int t) {
  split(p[g * S + t], f.hi[0], f.lo[0]);
  split(p[g * S + t + 4], f.hi[1], f.lo[1]);
}

// B with k permuted, from 8 rows (k) x 8 columns at `p` (row stride S):
// rows 2t and 2t+1 of column g
template <int S>
__device__ __forceinline__ void load_b_perm(FragB& f, const float* p, int g,
                                            int t) {
  split(p[2 * t * S + g], f.hi[0], f.lo[0]);
  split(p[(2 * t + 1) * S + g], f.hi[1], f.lo[1]);
}

// The fragments of a matrix read through `at`, the 16 x 8 block at(i, j)
// of A (i the row, j the k index) or the 8 x 8 block at(j, n) of B: for
// operands computed as they are read (a decayed factor) or read through an
// index map of their own (a transpose).  kPerm: k permuted as above (slot
// t takes index 2t, slot t + 4 index 2t + 1); A and B of one product
// must agree.
template <bool kPerm, typename At>
__device__ __forceinline__ void frag_a(FragA& f, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kPerm ? 2 * t : t, k1 = kPerm ? 2 * t + 1 : t + 4;
  split(at(g, k0), f.hi[0], f.lo[0]);
  split(at(g + 8, k0), f.hi[1], f.lo[1]);
  split(at(g, k1), f.hi[2], f.lo[2]);
  split(at(g + 8, k1), f.hi[3], f.lo[3]);
}
template <bool kPerm, typename At>
__device__ __forceinline__ void frag_b(FragB& f, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split(at(kPerm ? 2 * t : t, g), f.hi[0], f.lo[0]);
  split(at(kPerm ? 2 * t + 1 : t + 4, g), f.hi[1], f.lo[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc += x, in fp32 adds
template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4],
                                    const float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += x[n][e];
}

// acc += big + small, in fp32 adds: a sum's fresh accumulators (the hi
// hi products and the small ones) into its running total
template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4],
                                    const float (&big)[N][4],
                                    const float (&small)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += big[n][e] + small[n][e];
}

// (small, big) = A B^T over K (a multiple of 16) in 3xTF32: A the warp's
// 16 rows at `a`, B the NS x 8 rows at `b`, both fp32 row-major of stride
// S in shared memory; the hi hi products in two accumulators (even and
// odd k-steps) added at the end
template <int K, int S, int NS>
__device__ __forceinline__ void dot_rows(float (&small)[NS][4],
                                         float (&big)[NS][4], const float* a,
                                         const float* b, int g, int t) {
  static_assert(K % 16 == 0, "k-steps in pairs");
  float big1[NS][4];
  zero(small);
  zero(big);
  zero(big1);
#pragma unroll 2
  for (int kc = 0; kc < K / 8; kc += 2) {
    FragA fa;
    load_a<S>(fa, a + kc * 8, g, t);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragB fb;
      load_b_t<S>(fb, b + j * 8 * S + kc * 8, g, t);
      mma3(small[j], big[j], fa, fb);
    }
    load_a<S>(fa, a + kc * 8 + 8, g, t);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragB fb;
      load_b_t<S>(fb, b + j * 8 * S + kc * 8 + 8, g, t);
      mma3(small[j], big1[j], fa, fb);
    }
  }
  add(big, big1);
}

// Copies ROWS rows of DW floats (a multiple of 4) from global memory to
// shared memory (row stride DW + kPad) with NT threads, 16 bytes each:
// `src(r)` gives row r's global address, or nullptr for a row to
// zero-fill without a read (tc::load_rows for fp32).
template <int DW, int ROWS, int NT, typename Src>
__device__ __forceinline__ void load_rows(float* dst, int tid,
                                          const float* base, Src src) {
  constexpr int kChunks = DW / 4, kAll = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kAll + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (kAll % NT != 0 && c >= kAll) break;
    const int r = c / kChunks, ch = c % kChunks;
    const float* g = src(r);
    tc::cp_async16(dst + r * (DW + kPad) + ch * 4, g ? g + ch * 4 : base,
                   g != nullptr);
  }
}

// NK warps sharing 16 query rows, a "slice" (NK = 2: flash_attention.cu's
// fp32 body, its pairs; tree_attention_paged.cu's fp32 body): a block holds
// kSlices slices, and warp w is part w / kSlices of slice w % kSlices.
// `p`, the slice's P (16 rows of KN + kPadP floats); `m`, every warp's
// row values (16 each: maxima, then denominators); this warp, its part of
// each key tile (0 .. NK - 1) and the slice's named barrier (NK warps).
template <int NK>
struct Slice {
  static constexpr int kSlices = 4;
  float* p;
  float* m;
  int warp, part, bar;

  __device__ __forceinline__ void sync() const {
    if constexpr (NK == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * NK) : "memory");
  }
  // the value of part i for this thread's rows g and g + 8 (the same in
  // its quad), once `put` and a meeting have passed
  __device__ __forceinline__ void put(const float (&x)[2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    if ((lane & 3) == 0) {
      m[warp * 16 + g] = x[0];
      m[warp * 16 + g + 8] = x[1];
    }
  }
  __device__ __forceinline__ float got(int i, int h) const {
    const int g = (threadIdx.x & 31) >> 2;
    return m[(warp % kSlices + kSlices * i) * 16 + g + 8 * h];
  }
  // x becomes the slice's maximum of it.  All NK warps write, meet, then
  // read; a warp writes again only after the slice's next meeting, which
  // the others reach after their reads.
  __device__ __forceinline__ void row_max(float (&x)[2]) const {
    if constexpr (NK > 1) {
      put(x);
      sync();
#pragma unroll
      for (int i = 0; i < NK; ++i)
        if (i != part)
#pragma unroll
          for (int h = 0; h < 2; ++h) x[h] = fmaxf(x[h], got(i, h));
    }
  }
  // the rows' denominators: the NK warps' shares of the keys added in
  // part order (the same bits in every warp of the slice)
  __device__ __forceinline__ void total(const float (&l)[2],
                                        float (&sum)[2]) const {
    if constexpr (NK == 1) {
      sum[0] = l[0];
      sum[1] = l[1];
    } else {
      put(l);
      sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = part == 0 ? l[h] : got(0, h);
#pragma unroll
        for (int i = 1; i < NK; ++i) sum[h] += i == part ? l[h] : got(i, h);
      }
    }
  }
};

// One key tile of KN keys for a slice's 16 rows in fp32, this warp's share
// (the counterpart of tc::tile_mma, with its softmax conventions): S = Q
// K^T over its KN / NK of the keys in 3xTF32 (the small products and hi
// hi in accumulators of their own: twice the independent mma chains), the
// slice's row maxima exchanged, its part of P written for all NK warps,
// then O += P V over all KN keys for its DV / NK of the value columns (P's
// A fragments from shared memory, k permuted; V's rows 2t, 2t+1 as B).
// q: the slice's 16 rows (stride DQK + kPad); k: KN rows (stride DQK +
// kPad); v: KN rows (stride DV + kPad); st: the running max, this warp's
// keys' share of the denominator, and its DV / NK value columns.  A row's
// arithmetic reads only its own scores and the tile's keys: it never
// depends on the slice's other rows.
template <int DQK, int DV, int KN, int NK, typename Admit>
__device__ __forceinline__ void tile_slice(const float* q, const float* k,
                                           const float* v, float scale_log2,
                                           tc::RowState<DV / NK>& st,
                                           bool masked, Admit admit,
                                           const Slice<NK>& sl) {
  constexpr int QS = DQK + kPad, VS = DV + kPad, PS = KN + kPadP;
  constexpr int KH = KN / NK, DW = DV / NK;
  static_assert(DQK % 16 == 0 && DW % 8 == 0 && KH % 8 == 0, "tiles");
  static_assert(KH / 8 * 4 <= 32, "one bit per score of the thread");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kh = k + sl.part * KH * QS;

  // S = Q K^T over the head dim, 8 at a time
  float s[KH / 8][4], sb[KH / 8][4];
  dot_rows<DQK, QS, KH / 8>(s, sb, q, kh, g, t);

  // online softmax: scale, mask by selection, row max over the quad and
  // the slice; bit 4j + e of `keep` says whether s[j][e] was admitted
  float mx[2] = {st.m[0], st.m[1]};
  uint32_t keep = ~0u;
#pragma unroll
  for (int j = 0; j < KH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, kk = sl.part * KH + j * 8 + 2 * t + (e & 1);
      float x = (sb[j][e] + s[j][e]) * scale_log2;
      if (masked && !admit(h, kk)) {
        x = tc::kNegInf;
        keep &= ~(1u << (j * 4 + e));
      }
      s[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  sl.row_max(mx);
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    corr[h] = tc::ex2(st.m[h] - mx[h]);
    st.m[h] = mx[h];
    st.l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < KH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float pe =
          (keep >> (j * 4 + e)) & 1u ? tc::ex2(s[j][e] - mx[h]) : 0.f;
      s[j][e] = pe;
      st.l[h] += pe;
    }
    const int col = sl.part * KH + j * 8 + 2 * t;
    *reinterpret_cast<float2*>(sl.p + g * PS + col) =
        make_float2(s[j][0], s[j][1]);
    *reinterpret_cast<float2*>(sl.p + (g + 8) * PS + col) =
        make_float2(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }
  sl.sync();  // every part of P is written

  // O += P V over the tile's KN keys, 8 at a time, for this warp's
  // columns: the tile's sum in fresh accumulators, then one fp32 add
  const float* vh = v + sl.part * DW;
  float pv[DW / 8][4];
  zero(pv);
#pragma unroll
  for (int j = 0; j < KN / 8; ++j) {
    FragA a;
    load_a_perm<PS>(a, sl.p + j * 8, g, t);
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      FragB b;
      load_b_perm<VS>(b, vh + j * 8 * VS + n * 8, g, t);
      mma3(pv[n], a, b);
    }
  }
  add(st.o, pv);
}

}  // namespace tf
