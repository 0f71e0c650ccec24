// The backward of chunked decay linear attention (K6) for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package has no backward kernel for K6
// (no custom_vjp in src/repro); its trainer differentiates the jnp
//   src/repro/models/ssm.py::decay_attention_chunked
// and this kernel computes that gradient, so that training on the card
// runs no plain PyTorch on a CUDA tensor.  Its plain version, in the same
// decomposition, is kernels/linear_attn_chunk/ref.py::
// decay_attention_chunked_bwd.
//
// What it computes, per (b, h) and chunk (the forward's notation,
// linear_attn_chunk.cu: L the inclusive cumulative log-decay of the chunk,
// E = L - w, L_last = L at the chunk's end, S_in the state entering it),
// given do and the final state's cotangent (or zero):
//   dS_out of the last chunk = d_state;
//   dS_in  = exp(L_last) * dS_out + sum_t (r_t exp(E_t)) do_t^T
//            (dS_in of chunk 0 is the initial state's gradient);
//   dA[t][s] = do_t . v_s (s < t);
//   dv_s = sum_{t>s} A[t][s] do_t + (r_s . u k_s) do_s + k2_s dS_out;
//   dr_t = sum_{s<t} dA[t][s] k_s exp(E_t - L_s) + exp(E_t) S_in do_t
//          + u k_t (do_t . v_t);
//   dk_s = sum_{t>s} dA[t][s] r_t exp(E_t - L_s)
//          + exp(L_last - L_s) dS_out v_s + u r_s (do_s . v_s);
//   dw_t = sum_{t' >= t} (gE + gL)_t' - gE_t, with gE = r * (dr less its
//          u-term), gL = -k * (dk less its u-term), and at the last
//          position gL += sum_s k_s exp(L_last - L_s) (dS_out v_s)
//          + exp(L_last) sum_e dS_out S_in;
//   du = sum over b and t of r_t k_t (do_t . v_t).
// Every exponent is <= 0, as in the forward: nothing overflows however
// strong the decay.  Positions at or past S read as zeros and get no
// gradient written.
//
// Layout: r, k, v, do, dr, dk, dv (B, S, H, 64) in one type, fp32 or
// bf16; w, dw (B, S, H, 64) fp32; u, du (H, 64) fp32 or null;
// states (B, H, n_chunks, 64, 64) fp32, the S_in the forward's scan wrote;
// d_state (B, H, 64, 64) fp32 or null; d_s0 (B, H, 64, 64) fp32.
// Scratch from the wrapper (fp32): dS_out of each chunk (B, H, n_chunks,
// 64, 64), each chunk's decay exp(L_last) (B, H, n_chunks, 64) and, with
// u, du's per-chunk partials (B, H, n_chunks, 64).
//
// Design, four launches in either dtype, no atomics, so two identical
// calls give the same bits:
//  (a) the increment, one block of 8 warps per (chunk, h, b): the chunk's
//      increment of the state's gradient, q_eff^T do with q_eff = r
//      exp(E), computed once (its exponentials too) on the tensor cores,
//      into the chunk's dS_out slot, and exp(L_last).
//  (b) linear_attn_bwd_carry_kernel, one thread per state entry (b, h, d,
//      e), from the last chunk: dS_out written over the increment, then
//      dS <- exp(L_last) dS + increment (four chunks' loads in flight);
//      dS_in of chunk 0 is the initial state's gradient.  Every state
//      entry walks the chunks at once, and no exponential is taken twice:
//      8.4 MB read and written at rwkv6's (1, 1024).  Both dtypes.
//  (c) the gradient pass, one block per (chunk, h, b).  Warp w owns 16
//      rows and a group of columns of each of dr, dk and dv in fp32
//      registers.  The products run on the tensor cores in the forward's
//      decomposition: A rebuilt by secondary chunks of 16 (diagonal blocks
//      pairwise on the CUDA cores, off-diagonal ones factored through L at
//      the end of the earlier sub-chunk, both factors <= 1), dA = do v^T,
//      A^T do, the decayed dA k and dA^T r (their diagonal blocks pairwise,
//      each pair's exponential serving both), and the S_in do, dS_out v
//      and k2 dS_out terms; every exponent is <= 0.  dw by a reverse
//      cumulative sum down each channel, du's partial by column sums in a
//      fixed order.
//  (d) linear_attn_bwd_du_kernel sums du's partials over b and the chunks
//      in a fixed order (launched only with u).
// bf16 (redesigned for the H100: rwkv6-1.6b trains in bf16):
//  linear_attn_bwd_inc_kernel and linear_attn_bwd_chunk_tc_kernel on
//  mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  (c) runs two blocks of 8
//  warps an SM (107 KB of shared memory: r, k, v, do in bf16, L and E in
//  fp32, one C x C tile that holds A and then dA, one 64 x 64 tile that
//  holds S_in and then dS_out); an fp32 operand (the states, A, dA, the
//  decayed factors) enters as two bf16 parts (the rounded value, then what
//  the rounding dropped), r, k, v and do whole; exponentials on the SFUs.
// fp32: linear_attn_bwd_inc_f32_kernel and linear_attn_bwd_chunk_f32_kernel
//  on mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh): every operand, r, k, v
//  and do too, enters as a TF32 high part and the TF32 of its residual,
//  in three products; a sum over the channels keeps the small products and
//  hi hi in accumulators of their own, a sum over positions takes fresh
//  ones every 16 and adds them in fp32 (the tensor cores accumulate
//  without IEEE rounding); the accurate expf.  (c) keeps every tile in
//  fp32: 142 KB at C = 64, so one block an SM, and 16 warps a block, four
//  to a row tile, each with 16 columns of dr, dk and dv (at C = 16, 49 KB
//  and 8 warps, as bf16).
//
// Bound: bytes.  At rwkv6-1.6b's (1, 1024), 32 heads, bf16, the function
// reads r, k, v, do (bf16) and w (fp32) and writes dr, dk, dv (bf16) and
// dw (fp32): ~46 MB, ~14 us at 3.35 TB/s; in fp32 at (1, 500), ~37 MB,
// 11.0 us.  The kernel also reads the 8.4 MB of states the forward saved,
// which follow from k, v and w, so the bound leaves them out.  Its least
// products (8 dk dv a token: the gradients of the state's read-out and
// update) are 1.1 GFLOP, ~1 us on the tensor cores in bf16, ~7 us in three
// TF32 passes at (1, 1024).  chip_smoke.py's phase 3m prints
// launch/op_cost.py::k6_bwd_charge.  The design's own traffic is above
// that: the increments and dS_out (8.4 MB each at (1, 1024), written and
// read through the 50 MB L2) and the states; its exponentials (the
// diagonal blocks' pairs, three times: A, dr, dk) sit on the SFUs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;              // dk = dv
constexpr int kSub = 16;            // secondary chunk

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;        // null: no bonus, no du
  const float* states;   // (B, H, n_chunks, 64, 64): S entering each chunk
  const void* dout;
  const float* d_state;  // null: the final state takes no cotangent
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;             // (H, 64), or null
  float* d_s0;           // (B, H, 64, 64)
  float* ds_out;         // scratch (B, H, n_chunks, 64, 64)
  float* decay;          // scratch (B, H, n_chunks, 64): exp(L_last)
  float* du_part;        // scratch (B, H, n_chunks, 64), or null
  int B, S, H;
};

__device__ __forceinline__ size_t tok(const Args& p, int b, int t, int h) {
  return ((static_cast<size_t>(b) * p.S + t) * p.H + h) * kD;
}

// (d): grid H, 64 threads; du[h][d] = sum over b, then chunks, in order
__global__ void __launch_bounds__(kD)
    linear_attn_bwd_du_kernel(const float* part, float* du, int B, int H,
                              int n_chunks) {
  const int h = blockIdx.x, d = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n_chunks; ++c)
      s += part[((static_cast<size_t>(b) * H + h) * n_chunks + c) * kD + d];
  du[h * kD + d] = s;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core design
// ---------------------------------------------------------------------------

constexpr int kTC = 256;        // (a), (c) bf16: 8 warps
constexpr int kQ = kD + 4;      // fp32 row stride: rows 16-byte aligned
constexpr int kB = kD + tc::kPad;  // bf16 row stride (72)

// exp on the special-function unit (ex2 of x log2 e): bf16's tolerance
// allows it, as in the forward's bf16 build
__device__ __forceinline__ float fex(float x) { return __expf(x); }

// A fragment (rows row0 + g, + 8; columns col0 + 2t, +1, + 8, + 9) of the
// matrix at(row, col): exact (its values are bf16 already) ...
template <typename At>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], int row0, int col0,
                                       At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int rr = row0 + g + 8 * (x & 1), cc = col0 + 2 * t + 8 * (x >> 1);
    a[x] = tc::pack_bf16(at(rr, cc), at(rr, cc + 1));
  }
}
// ... or as two bf16 parts (value, rounding residue) of an fp32 matrix
template <typename At>
__device__ __forceinline__ void frag_a2(uint32_t (&big)[4],
                                        uint32_t (&small)[4], int row0,
                                        int col0, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int rr = row0 + g + 8 * (x & 1), cc = col0 + 2 * t + 8 * (x >> 1);
    tc::split_bf16(at(rr, cc), at(rr, cc + 1), big[x], small[x]);
  }
}
// B fragment (k rows k0 + 2t, + 1, + 8, + 9; column n0 + g) of the matrix
// at(k, n): exact, or as two parts
template <typename At>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], int k0, int n0,
                                       At at) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  b[0] = tc::pack_bf16(at(k, n), at(k + 1, n));
  b[1] = tc::pack_bf16(at(k + 8, n), at(k + 9, n));
}
template <typename At>
__device__ __forceinline__ void frag_b2(uint32_t (&big)[2],
                                        uint32_t (&small)[2], int k0, int n0,
                                        At at) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  tc::split_bf16(at(k, n), at(k + 1, n), big[0], small[0]);
  tc::split_bf16(at(k + 8, n), at(k + 9, n), big[1], small[1]);
}

// c += A B with A and/or B as two bf16 parts: the products of the parts
// above fp32's rounding (small x small is dropped)
__device__ __forceinline__ void mma_a2(float (&c)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&b)[2]) {
  tc::mma_bf16(c, ab, b[0], b[1]);
  tc::mma_bf16(c, as, b[0], b[1]);
}
__device__ __forceinline__ void mma_b2(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&bb)[2],
                                       const uint32_t (&bs)[2]) {
  tc::mma_bf16(c, a, bb[0], bb[1]);
  tc::mma_bf16(c, a, bs[0], bs[1]);
}
__device__ __forceinline__ void mma_ab2(float (&c)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  tc::mma_bf16(c, ab, bb[0], bb[1]);
  tc::mma_bf16(c, ab, bs[0], bs[1]);
  tc::mma_bf16(c, as, bb[0], bb[1]);
}

__device__ __forceinline__ float bf(const bf16* m, int i) {
  return __bfloat162float(m[i]);
}

// C rows of fp32 (four a 16-byte copy) from row t0 on into shared memory
// (row stride kQ), zero past S
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              const Args& p, int b, int t0,
                                              int h, int C) {
  for (int i = threadIdx.x; i < C * (kD / 4); i += blockDim.x) {
    const int t = i / (kD / 4), ch = i % (kD / 4);
    const bool in = t0 + t < p.S;
    tc::cp_async16(dst + t * kQ + ch * 4,
                   in ? src + tok(p, b, t0 + t, h) + ch * 4 : src, in);
  }
}

// C rows of a bf16 operand into shared memory (row stride kB), zero past S
__device__ __forceinline__ void load_bf16_rows(bf16* dst, const bf16* src,
                                               const Args& p, int b, int t0,
                                               int h, int C) {
  for (int i = threadIdx.x; i < C * (kD / 8); i += blockDim.x) {
    const int t = i / (kD / 8), ch = i % (kD / 8);
    const bool in = t0 + t < p.S;
    tc::cp_async16(dst + t * kB + ch * 8,
                   in ? src + tok(p, b, t0 + t, h) + ch * 8 : src, in);
  }
}

// (a) bf16: grid (n_chunks, H, B).  The chunk's increment of the state's
// gradient, q_eff^T do with q_eff = r exp(E), into ds_out's slot of the
// chunk (the carry overwrites it with dS_out), and its decay exp(L_last).
template <int C>
__host__ __device__ constexpr size_t inc_smem_bytes() {
  return sizeof(float) * 2 * static_cast<size_t>(C) * kQ +
         sizeof(bf16) * 2 * static_cast<size_t>(C) * kB;
}

template <int C>
__global__ void __launch_bounds__(kTC) linear_attn_bwd_inc_kernel(Args p) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // w, then E
  float* qe = xs + C * kQ;                         // q_eff
  bf16* rb = reinterpret_cast<bf16*>(qe + C * kQ);
  bf16* gb = rb + C * kB;                          // do
  load_f32_rows(xs, p.w, p, b, t0, h, C);
  load_bf16_rows(rb, static_cast<const bf16*>(p.r), p, b, t0, h, C);
  load_bf16_rows(gb, static_cast<const bf16*>(p.dout), p, b, t0, h, C);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  if (tid < kD) {  // the cumulative log-decay down channel tid
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = xs[t * kQ + tid];
      acc += wv;
      xs[t * kQ + tid] = acc - wv;
    }
    p.decay[bhc * kD + tid] = expf(acc);
  }
  __syncthreads();
  for (int i = tid; i < C * kD; i += kTC) {
    const int t = i / kD, d = i % kD;
    qe[t * kQ + d] = bf(rb, t * kB + d) * fex(xs[t * kQ + d]);
  }
  __syncthreads();
  // inc[d][e] = sum_t q_eff[t][d] do[t][e]: warp w owns rows 16 (w % 4)
  // and columns 32 (w / 4) of the 64 x 64 increment
  const int rd = warp % 4, eg = warp / 4;
  float acc[4][4] = {};
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rd * 16, kc * 16,
            [&](int d, int t) { return qe[t * kQ + d]; });
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t bb[2];
      frag_b(bb, kc * 16, eg * 32 + n * 8,
             [&](int t, int e) { return bf(gb, t * kB + e); });
      mma_a2(acc[n], ab, as, bb);
    }
  }
  float* inc = p.ds_out + bhc * kD * kD;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(inc + (rd * 16 + g4 + 8 * hh) * kD +
                                 eg * 32 + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
}

// (b) bf16: one thread a state entry (b, h, d, e), from the last chunk:
// dS_out of chunk c written over its increment, then dS <- exp(L_last)
// dS + inc; dS_in of chunk 0 is the initial state's gradient.  Four
// chunks' loads are issued before their stores.
__global__ void __launch_bounds__(256)
    linear_attn_bwd_carry_kernel(Args p, int n_chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<size_t>(p.B) * p.H * kD * kD) return;
  const size_t bh = i / (kD * kD), de = i % (kD * kD);
  float g = p.d_state ? p.d_state[i] : 0.f;
  float* buf = p.ds_out + bh * n_chunks * kD * kD + de;
  const float* dec = p.decay + bh * n_chunks * kD + de / kD;
  for (int c0 = n_chunks - 1; c0 >= 0; c0 -= 4) {
    float x[4], dc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      x[j] = c >= 0 ? buf[static_cast<size_t>(c) * kD * kD] : 0.f;
      dc[j] = c >= 0 ? dec[c * kD] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      if (c < 0) break;
      buf[static_cast<size_t>(c) * kD * kD] = g;
      g = dc[j] * g + x[j];
    }
  }
  p.d_s0[i] = g;
}

// (c) bf16's shared memory at chunk C: r, k, v, do in bf16 (C x kB each);
// L and E (C x kQ fp32 each), the first L's rows w until the cumulative
// sum; X, A then dA (C x kQ); Z, S_in then dS_out (64 x kQ); u, the
// u-diagonal, do . v, the S_in term of dw, and two column sums per row
// tile (k dks, r k do.v)
template <int C>
struct GradTC {
  static constexpr int RT = C / 16;        // row tiles of the chunk
  static constexpr int NCG = 8 / RT;       // column groups of the 64
  static constexpr int CW = kD / NCG;      // columns of a group
  static constexpr int NT = CW / 8;        // 8-column tiles of a warp
  static constexpr int NS = C / kSub;      // sub-chunks
  static constexpr int NPAIR = NS * (NS - 1) / 2;
  static constexpr size_t bytes =
      sizeof(bf16) * 4 * static_cast<size_t>(C) * kB +
      sizeof(float) * (3 * static_cast<size_t>(C) * kQ +
                       static_cast<size_t>(kD) * kQ + 4 * kD +
                       2 * static_cast<size_t>(RT) * kD);
};

// off-diagonal block p -> (i, j), i > j: p = i (i - 1) / 2 + j
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int a = 1;
  while ((a + 1) * a / 2 <= p) ++a;
  *i = a;
  *j = p - a * (a - 1) / 2;
}

// (c) bf16: grid (n_chunks, H, B).  Warp w owns rows 16 (w % RT) .. + 15
// and columns CW (w / RT) .. of each of dr, dk and dv, whose fp32
// accumulators stay in its registers through every phase.
template <int C>
__global__ void __launch_bounds__(kTC, 2)
    linear_attn_bwd_chunk_tc_kernel(Args p) {
  using L = GradTC<C>;
  constexpr int NT = L::NT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int rt = warp % L::RT, col0 = (warp / L::RT) * L::CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rb = reinterpret_cast<bf16*>(smem_raw);
  bf16* kb = rb + C * kB;
  bf16* vb = kb + C * kB;
  bf16* gb = vb + C * kB;                          // do
  float* ls = reinterpret_cast<float*>(gb + C * kB);  // w, then L
  float* xs = ls + C * kQ;                         // E = L - w
  float* xa = xs + C * kQ;                         // A, then dA
  float* zs = xa + C * kQ;                         // S_in, then dS_out
  float* us = zs + kD * kQ;                        // u
  float* dg = us + kD;                             // r[t] . (u * k[t])
  float* dov = dg + kD;                            // do[t] . v[t]
  float* col = dov + kD;                           // dw's S_in term
  float* kd_red = col + kD;                        // sum_t k dks, per tile
  float* du_red = kd_red + L::RT * kD;             // sum_t r k do.v

  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  load_bf16_rows(rb, static_cast<const bf16*>(p.r), p, b, t0, h, C);
  load_bf16_rows(kb, static_cast<const bf16*>(p.k), p, b, t0, h, C);
  load_bf16_rows(vb, static_cast<const bf16*>(p.v), p, b, t0, h, C);
  load_bf16_rows(gb, static_cast<const bf16*>(p.dout), p, b, t0, h, C);
  load_f32_rows(ls, p.w, p, b, t0, h, C);
  const float* s_in = p.states + bhc * kD * kD;
  const float* s_out = p.ds_out + bhc * kD * kD;
  for (int i = tid; i < kD * (kD / 4); i += kTC)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_in + i * 4, true);
  tc::cp_async_commit();
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // the cumulative log-decay, one thread a channel; the u-diagonal and
  // do . v on the next threads meanwhile
  if (tid < kD) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = ls[t * kQ + tid];
      acc += wv;
      ls[t * kQ + tid] = acc;
      xs[t * kQ + tid] = acc - wv;
    }
  } else if (tid < kD + C) {
    const int t = tid - kD;
    float s = 0.f;
    for (int d = 0; d < kD; ++d)
      s += bf(rb, t * kB + d) * us[d] * bf(kb, t * kB + d);
    dg[t] = s;
  } else if (tid < kD + 2 * C) {
    const int t = tid - kD - C;
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += bf(gb, t * kB + e) * bf(vb, t * kB + e);
    dov[t] = s;
  }
  __syncthreads();
  auto at_l = [&](int t, int d) { return ls[t * kQ + d]; };
  auto at_e = [&](int t, int d) { return xs[t * kQ + d]; };
  const float* l_last = ls + (C - 1) * kQ;

  // A's diagonal sub-blocks pairwise (zero on and above the diagonal) and
  // its off-diagonal blocks factored through L at the end of the earlier
  // sub-chunk, both factors <= 1, as the forward builds A
  constexpr int kSubPairs = kSub * (kSub - 1) / 2;
  for (int i = tid; i < C * C; i += kTC) {
    const int t = i / C, s = i % C;
    if (s >= t) xa[t * kQ + s] = 0.f;
  }
  for (int pi = tid; pi < L::NS * kSubPairs; pi += kTC) {
    const int sb = pi / kSubPairs, q = pi % kSubPairs;
    int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    while (tt * (tt - 1) / 2 > q) --tt;
    while (tt * (tt + 1) / 2 <= q) ++tt;
    const int t = sb * kSub + tt, s = sb * kSub + q - tt * (tt - 1) / 2;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d)
      a += bf(rb, t * kB + d) * bf(kb, s * kB + d) *
           fex(fminf(at_e(t, d) - at_l(s, d), 0.f));
    xa[t * kQ + s] = a;
  }
  if (warp < L::NPAIR) {
    int bi, bj;
    pair_of(warp, &bi, &bj);
    const float* ref = ls + (bj * kSub + kSub - 1) * kQ;
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      uint32_t ab[4], as[4];
      frag_a2(ab, as, bi * kSub, kc * 16, [&](int t, int d) {
        return bf(rb, t * kB + d) * fex(fminf(at_e(t, d) - ref[d], 0.f));
      });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bb[2], bs[2];  // B[d][s] = k[s][d] exp(L_ref - L[s])
        frag_b2(bb, bs, kc * 16, bj * kSub + nt * 8, [&](int d, int s) {
          return bf(kb, s * kB + d) * fex(fminf(ref[d] - at_l(s, d), 0.f));
        });
        mma_ab2(acc[nt], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(bi * kSub + g4 + 8 * (e >> 1)) * kQ + bj * kSub + nt * 8 +
           2 * t4 + (e & 1)] = acc[nt][e];
  }

  // the state term of dr: exp(E) (do S_in^T), S_in^T's fp32 in two parts
  float dr[NT][4] = {}, dk[NT][4] = {};
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, rt * 16, kc * 16,
           [&](int t, int e) { return bf(gb, t * kB + e); });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];  // B[e][d] = S_in[d][e]
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int e, int d) { return zs[d * kQ + e]; });
      mma_b2(dr[n], a, bb, bs);
    }
  }
  // the thread's elements: rows rt*16 + g4 + 8 hh, columns col0 + 8 n +
  // 2 t4 + (e & 1)
  auto row_of = [&](int e) { return rt * 16 + g4 + 8 * (e >> 1); };
  auto col_of = [&](int n, int e) { return col0 + n * 8 + 2 * t4 + (e & 1); };
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dr[n][e] *= fex(at_e(row_of(e), col_of(n, e)));
  __syncthreads();  // S_in read: dS_out takes its place; A complete

  for (int i = tid; i < kD * (kD / 4); i += kTC)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_out + i * 4, true);
  tc::cp_async_commit();
  // dw's S_in term at the chunk's end, exp(L_last) sum_e dS_out S_in per
  // channel, read from device memory: four threads a channel
  {
    const int d = tid / 4, part = tid % 4;
    float x = 0.f;
    if (d < kD) {
#pragma unroll
      for (int e = part * 16; e < part * 16 + 16; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s_in + d * kD + e);
        const float4 o = *reinterpret_cast<const float4*>(s_out + d * kD + e);
        x += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0 && d < kD) col[d] = fex(l_last[d]) * x;
  }
  // dv = A^T do (A's fp32 in two parts; tiles of t on or below s's) ...
  float dv[NT][4] = {};
  for (int kc = rt; kc < L::RT; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, kc * 16,
            [&](int s, int t) { return xa[t * kQ + s]; });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2];
      frag_b(bb, kc * 16, col0 + n * 8,
             [&](int t, int e) { return bf(gb, t * kB + e); });
      mma_a2(dv[n], ab, as, bb);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // dS_out landed
  // ... + k2 dS_out, k2 = k exp(L_last - L), both in two parts
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, kc * 16, [&](int s, int f) {
      return bf(kb, s * kB + f) * fex(l_last[f] - at_l(s, f));
    });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int f, int e) { return zs[f * kQ + e]; });
      mma_ab2(dv[n], ab, as, bb, bs);
    }
  }
  // dv is complete with its u-diagonal: written now, its registers freed
  bf16* dv_o = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      const float g = dg[t];
      if (t0 + t < p.S)
        *reinterpret_cast<uint32_t*>(dv_o + tok(p, b, t0 + t, h) + d) =
            tc::pack_bf16(dv[n][2 * hh] + g * bf(gb, t * kB + d),
                          dv[n][2 * hh + 1] + g * bf(gb, t * kB + d + 1));
    }
  // the state term of dk, dks = exp(L_last - L) (v dS_out^T)
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, rt * 16, kc * 16,
           [&](int s, int e) { return bf(vb, s * kB + e); });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];  // B[e][d] = dS_out[d][e]
      frag_b2(bb, bs, kc * 16, col0 + n * 8,
              [&](int e, int d) { return zs[d * kQ + e]; });
      mma_b2(dk[n], a, bb, bs);
    }
  }
  // the column sums of k dks and of r k (do . v) over the warp's 16 rows
  // (a fixed order: the quad's rows by shuffles, then the row tiles)
  float kd[NT][2], rk[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      kd[n][x] = rk[n][x] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 2 * hh + x, t = row_of(e), d = col_of(n, e);
        dk[n][e] *= fex(l_last[d] - at_l(t, d));
        kd[n][x] += bf(kb, t * kB + d) * dk[n][e];
        rk[n][x] += bf(rb, t * kB + d) * bf(kb, t * kB + d) * dov[t];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        kd[n][x] += __shfl_xor_sync(0xffffffffu, kd[n][x], off);
        rk[n][x] += __shfl_xor_sync(0xffffffffu, rk[n][x], off);
      }
      if (g4 == 0) {
        kd_red[rt * kD + col_of(n, x)] = kd[n][x];
        du_red[rt * kD + col_of(n, x)] = rk[n][x];
      }
    }
  __syncthreads();  // A read: dA takes its place

  // dA = do v^T, the tiles on and below the diagonal (exact bf16 operands)
  for (int tile = warp; tile < L::RT * (L::RT + 1) / 2; tile += kTC / 32) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    const int tj = tile - ti * (ti + 1) / 2;
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      uint32_t a[4];
      frag_a(a, ti * 16, kc * 16,
             [&](int t, int e) { return bf(gb, t * kB + e); });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bb[2];  // B[e][s] = v[s][e]
        frag_b(bb, kc * 16, tj * 16 + nt * 8,
               [&](int e, int s) { return bf(vb, s * kB + e); });
        tc::mma_bf16(acc[nt], a, bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(ti * 16 + g4 + 8 * (e >> 1)) * kQ + tj * 16 + nt * 8 + 2 * t4 +
           (e & 1)] = acc[nt][e];
  }
  __syncthreads();

  // the decayed intra-chunk products of dr and dk: the diagonal sub-blocks
  // pairwise, one channel a lane (warp w: sub-chunk w % RT, the channels
  // of its column group), each pair's exponential serving both dr (row t)
  // and dk (row s); the sums reach the fragments' owners through zs, free
  // since dS_out's last product ...
  {
    const int b0 = (warp % L::RT) * kSub, d = col0 + lane;
    const bool on = lane < L::CW;
    float dra[kSub] = {}, dka[kSub] = {};
    if (on) {
      float lr[kSub], kr[kSub];
#pragma unroll
      for (int x = 0; x < kSub; ++x) {
        lr[x] = at_l(b0 + x, d);
        kr[x] = bf(kb, (b0 + x) * kB + d);
      }
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt) {
        const float et = at_e(b0 + tt, d), rv = bf(rb, (b0 + tt) * kB + d);
        const float* da = xa + (b0 + tt) * kQ + b0;
#pragma unroll
        for (int ss = 0; ss < tt; ++ss) {
          const float e = fex(fminf(et - lr[ss], 0.f)) * da[ss];
          dra[tt] += kr[ss] * e;
          dka[ss] += rv * e;
        }
      }
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dra[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dr[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
    __syncthreads();
    if (on) {
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dka[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
  }
  // ... and the off-diagonal blocks through L_ref at the end of sub-chunk
  // j: dr's rows (sub-chunk rt) over each earlier j, dA (two parts) times
  // k exp(L_ref - L) (two parts), then times exp(E - L_ref) ...
  for (int j = 0; j < rt; ++j) {
    const float* ref = ls + (j * kSub + kSub - 1) * kQ;
    float tmp[NT][4] = {};
    uint32_t ab[4], as[4];
    frag_a2(ab, as, rt * 16, j * 16,
            [&](int t, int s) { return xa[t * kQ + s]; });
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      frag_b2(bb, bs, j * 16, col0 + n * 8, [&](int s, int d) {
        return bf(kb, s * kB + d) * fex(fminf(ref[d] - at_l(s, d), 0.f));
      });
      mma_ab2(tmp[n], ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dr[n][e] += fex(fminf(at_e(row_of(e), d) - ref[d], 0.f)) * tmp[n][e];
      }
  }
  // ... dk's rows (sub-chunk rt) over each later i: dA^T times r exp(E -
  // L_ref), then times exp(L_ref - L)
  if (rt + 1 < L::RT) {
    const float* ref = ls + (rt * kSub + kSub - 1) * kQ;
    float tmp[NT][4] = {};
    for (int i = rt + 1; i < L::RT; ++i) {
      uint32_t ab[4], as[4];
      frag_a2(ab, as, rt * 16, i * 16,
              [&](int s, int t) { return xa[t * kQ + s]; });
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2], bs[2];
        frag_b2(bb, bs, i * 16, col0 + n * 8, [&](int t, int d) {
          return bf(rb, t * kB + d) * fex(fminf(at_e(t, d) - ref[d], 0.f));
        });
        mma_ab2(tmp[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dk[n][e] += fex(fminf(ref[d] - at_l(row_of(e), d), 0.f)) * tmp[n][e];
      }
  }

  // dr and dk with their u-terms; dw's parts
  bf16* dr_o = static_cast<bf16*>(p.dr);
  bf16* dk_o = static_cast<bf16*>(p.dk);
  float ge[NT][4], gl[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      const float rt_ = bf(rb, t * kB + d), kt = bf(kb, t * kB + d);
      const float bonus = us[d] * dov[t];
      ge[n][e] = rt_ * dr[n][e];
      gl[n][e] = -kt * dk[n][e];
      dr[n][e] += bonus * kt;
      dk[n][e] += bonus * rt_;
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      if (t0 + t >= p.S) continue;
      const size_t o = tok(p, b, t0 + t, h) + d;
      *reinterpret_cast<uint32_t*>(dr_o + o) =
          tc::pack_bf16(dr[n][2 * hh], dr[n][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dk_o + o) =
          tc::pack_bf16(dk[n][2 * hh], dk[n][2 * hh + 1]);
    }
  __syncthreads();  // L and E read: they take gL and gE + gL
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      ls[t * kQ + d] = gl[n][e];
      xs[t * kQ + d] = ge[n][e] + gl[n][e];
    }
  __syncthreads();
  if (tid < kD) {  // dw down channel tid, from the chunk's end; du's partial
    const int d = tid;
    float last = col[d], du = 0.f;
    for (int r = 0; r < L::RT; ++r) {
      last += kd_red[r * kD + d];
      du += du_red[r * kD + d];
    }
    float acc = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      const float add = t == C - 1 ? last : 0.f;
      if (t0 + t < p.S)
        p.dw[tok(p, b, t0 + t, h) + d] = acc + ls[t * kQ + d] + add;
      acc += xs[t * kQ + d] + add;
    }
    if (p.du_part) p.du_part[bhc * kD + d] = du;
  }
}

// ---------------------------------------------------------------------------
// fp32: the same design in 3xTF32 (tf32_mma.cuh)
// ---------------------------------------------------------------------------

// (a) fp32's shared memory at chunk C: w then E, r then q_eff, do (C x kQ
// fp32 each)
template <int C>
__host__ __device__ constexpr size_t inc_f32_smem_bytes() {
  return sizeof(float) * 3 * static_cast<size_t>(C) * kQ;
}

// (a) fp32: grid (n_chunks, H, B), as (a) bf16 with r and do in fp32 and
// the product in 3xTF32 (k = t permuted: q_eff^T's and do's rows 2t, 2t +
// 1, stride 4 mod 32, conflict-free), each 16 positions summed in fresh
// accumulators, then added in fp32
template <int C>
__global__ void __launch_bounds__(kTC) linear_attn_bwd_inc_f32_kernel(Args p) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // w, then E
  float* qe = xs + C * kQ;                         // r, then q_eff
  float* gs = qe + C * kQ;                         // do
  load_f32_rows(xs, p.w, p, b, t0, h, C);
  load_f32_rows(qe, static_cast<const float*>(p.r), p, b, t0, h, C);
  load_f32_rows(gs, static_cast<const float*>(p.dout), p, b, t0, h, C);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  if (tid < kD) {  // the cumulative log-decay down channel tid
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = xs[t * kQ + tid];
      acc += wv;
      xs[t * kQ + tid] = acc - wv;
    }
    p.decay[bhc * kD + tid] = expf(acc);
  }
  __syncthreads();
  for (int i = tid; i < C * kD; i += kTC) {
    const int t = i / kD, d = i % kD;
    qe[t * kQ + d] *= expf(xs[t * kQ + d]);
  }
  __syncthreads();
  // inc[d][e] = sum_t q_eff[t][d] do[t][e]: warp w owns rows 16 (w % 4)
  // and columns 32 (w / 4) of the 64 x 64 increment
  const int rd = warp % 4, eg = warp / 4;
  float acc[4][4] = {};
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc) {
    float small[4][4] = {}, big[4][4] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s0 = kc * 16 + hh * 8;
      tf::FragA fa;  // A[d][t] = q_eff[t][d]
      tf::frag_a<true>(fa, [&](int i, int j) {
        return qe[(s0 + j) * kQ + rd * 16 + i];
      });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        tf::FragB fb;
        tf::load_b_perm<kQ>(fb, gs + s0 * kQ + eg * 32 + n * 8, g4, t4);
        tf::mma3(small[n], big[n], fa, fb);
      }
    }
    tf::add(acc, big, small);
  }
  float* inc = p.ds_out + bhc * kD * kD;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(inc + (rd * 16 + g4 + 8 * hh) * kD +
                                 eg * 32 + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
}

// (c) fp32's shared memory at chunk C: r, k, v, do, L (w until the
// cumulative sum), E and X, A then dA (C x kQ fp32 each); Z, S_in then
// dS_out (64 x kQ); u, the u-diagonal, do . v, the S_in term of dw, and
// two column sums per row tile.  142 KB at C = 64, so one block an SM,
// and so 16 warps, four to a row tile (two blocks of 8 warps at C = 16)
template <int C>
struct GradF32 {
  static constexpr int W = C == 64 ? 16 : 8;  // warps
  static constexpr int RT = C / 16;           // row tiles of the chunk
  static constexpr int NCG = W / RT;          // column groups of the 64
  static constexpr int CW = kD / NCG;         // columns of a group
  static constexpr int NT = CW / 8;           // 8-column tiles of a warp
  static constexpr int NS = C / kSub;         // sub-chunks
  static constexpr int NPAIR = NS * (NS - 1) / 2;
  static constexpr size_t bytes =
      sizeof(float) * (7 * static_cast<size_t>(C) * kQ +
                       static_cast<size_t>(kD) * kQ + 4 * kD +
                       2 * static_cast<size_t>(RT) * kD);
  static_assert(CW % 8 == 0 && NPAIR <= W && RT * (RT + 1) / 2 <= W &&
                    NS * kD <= W * 32,
                "a warp for each block and tile, a thread a channel");
};

// (c) fp32: grid (n_chunks, H, B), as (c) bf16 with every operand in fp32
// and every product in 3xTF32.  Warp w owns rows 16 (w % RT) .. + 15 and
// columns CW (w / RT) .. of each of dr, dk and dv in fp32 registers.  A
// sum over the channels (or state columns) keeps the small products and hi
// hi in accumulators of their own; a sum over positions takes fresh ones
// every 16 and adds them in fp32.  Where a product's k axis is a row
// index of its tiles it is permuted (tf32_mma.cuh), so that the loads of
// both operands fall on distinct banks (stride 4 mod 32); the decayed
// factors of the off-diagonal dr products and the dS_out operand of dv
// are read with two-way conflicts.
template <int C>
__global__ void __launch_bounds__(GradF32<C>::W * 32, 1)
    linear_attn_bwd_chunk_f32_kernel(Args p) {
  using L = GradF32<C>;
  constexpr int NT = L::NT, kN = L::W * 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, t0 = c * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int rt = warp % L::RT, col0 = (warp / L::RT) * L::CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);
  float* ks = rs + C * kQ;
  float* vs = ks + C * kQ;
  float* gs = vs + C * kQ;                         // do
  float* ls = gs + C * kQ;                         // w, then L
  float* xs = ls + C * kQ;                         // E = L - w
  float* xa = xs + C * kQ;                         // A, then dA
  float* zs = xa + C * kQ;                         // S_in, then dS_out
  float* us = zs + kD * kQ;                        // u
  float* dg = us + kD;                             // r[t] . (u * k[t])
  float* dov = dg + kD;                            // do[t] . v[t]
  float* col = dov + kD;                           // dw's S_in term
  float* kd_red = col + kD;                        // sum_t k dks, per tile
  float* du_red = kd_red + L::RT * kD;             // sum_t r k do.v

  const size_t bhc = (static_cast<size_t>(b) * p.H + h) * n_chunks + c;
  load_f32_rows(rs, static_cast<const float*>(p.r), p, b, t0, h, C);
  load_f32_rows(ks, static_cast<const float*>(p.k), p, b, t0, h, C);
  load_f32_rows(vs, static_cast<const float*>(p.v), p, b, t0, h, C);
  load_f32_rows(gs, static_cast<const float*>(p.dout), p, b, t0, h, C);
  load_f32_rows(ls, p.w, p, b, t0, h, C);
  const float* s_in = p.states + bhc * kD * kD;
  const float* s_out = p.ds_out + bhc * kD * kD;
  for (int i = tid; i < kD * (kD / 4); i += kN)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_in + i * 4, true);
  tc::cp_async_commit();
  if (tid < kD) us[tid] = p.u ? p.u[h * kD + tid] : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // the cumulative log-decay, one thread a channel; the u-diagonal and
  // do . v on the next threads meanwhile
  if (tid < kD) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float wv = ls[t * kQ + tid];
      acc += wv;
      ls[t * kQ + tid] = acc;
      xs[t * kQ + tid] = acc - wv;
    }
  } else if (tid < kD + C) {
    const int t = tid - kD;
    float s = 0.f;
    for (int d = 0; d < kD; ++d) s += rs[t * kQ + d] * us[d] * ks[t * kQ + d];
    dg[t] = s;
  } else if (tid < kD + 2 * C) {
    const int t = tid - kD - C;
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += gs[t * kQ + e] * vs[t * kQ + e];
    dov[t] = s;
  }
  __syncthreads();
  auto at_l = [&](int t, int d) { return ls[t * kQ + d]; };
  auto at_e = [&](int t, int d) { return xs[t * kQ + d]; };
  const float* l_last = ls + (C - 1) * kQ;
  // the thread's elements: rows rt*16 + g4 + 8 hh, columns col0 + 8 n +
  // 2 t4 + (e & 1)
  auto row_of = [&](int e) { return rt * 16 + g4 + 8 * (e >> 1); };
  auto col_of = [&](int n, int e) { return col0 + n * 8 + 2 * t4 + (e & 1); };
  // C[rows][cols] (small, big) = sum over 64 k of a(i, k) b(k, n): the
  // warp's 16 rows and NC tiles of 8 columns, k not permuted
  auto dot64 = [&](auto a, auto bt, auto& small, auto& big) {
    tf::zero(small);
    tf::zero(big);
#pragma unroll 2
    for (int k0 = 0; k0 < kD; k0 += 8) {
      tf::FragA fa;
      tf::frag_a<false>(fa, [&](int i, int j) { return a(i, k0 + j); });
#pragma unroll
      for (int n = 0; n < static_cast<int>(sizeof(small) / sizeof(small[0]));
           ++n) {
        tf::FragB fb;
        tf::frag_b<false>(fb, [&](int j, int nn) { return bt(k0 + j, n, nn); });
        tf::mma3(small[n], big[n], fa, fb);
      }
    }
  };

  // A's diagonal sub-blocks pairwise (zero on and above the diagonal) and
  // its off-diagonal blocks factored through L at the end of the earlier
  // sub-chunk, both factors <= 1, as the forward builds A
  constexpr int kSubPairs = kSub * (kSub - 1) / 2;
  for (int i = tid; i < C * C; i += kN) {
    const int t = i / C, s = i % C;
    if (s >= t) xa[t * kQ + s] = 0.f;
  }
  for (int pi = tid; pi < L::NS * kSubPairs; pi += kN) {
    const int sb = pi / kSubPairs, q = pi % kSubPairs;
    int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    while (tt * (tt - 1) / 2 > q) --tt;
    while (tt * (tt + 1) / 2 <= q) ++tt;
    const int t = sb * kSub + tt, s = sb * kSub + q - tt * (tt - 1) / 2;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d)
      a += rs[t * kQ + d] * ks[s * kQ + d] *
           expf(fminf(at_e(t, d) - at_l(s, d), 0.f));
    xa[t * kQ + s] = a;
  }
  if (warp < L::NPAIR) {
    int bi, bj;
    pair_of(warp, &bi, &bj);
    const float* ref = ls + (bj * kSub + kSub - 1) * kQ;
    float small[2][4], big[2][4];
    dot64([&](int i, int d) {
      const int t = bi * kSub + i;
      return rs[t * kQ + d] * expf(fminf(at_e(t, d) - ref[d], 0.f));
    }, [&](int d, int n, int nn) {  // B[d][s] = k[s][d] exp(L_ref - L[s])
      const int s = bj * kSub + n * 8 + nn;
      return ks[s * kQ + d] * expf(fminf(ref[d] - at_l(s, d), 0.f));
    }, small, big);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(bi * kSub + g4 + 8 * (e >> 1)) * kQ + bj * kSub + nt * 8 +
           2 * t4 + (e & 1)] = big[nt][e] + small[nt][e];
  }

  // the state term of dr: exp(E) (do S_in^T)
  float dr[NT][4], dk[NT][4], dv[NT][4] = {};
  {
    float small[NT][4], big[NT][4];
    dot64([&](int i, int e) { return gs[(rt * 16 + i) * kQ + e]; },
          [&](int e, int n, int nn) {  // B[e][d] = S_in[d][e]
            return zs[(col0 + n * 8 + nn) * kQ + e];
          }, small, big);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dr[n][e] = (big[n][e] + small[n][e]) *
                   expf(at_e(row_of(e), col_of(n, e)));
  }
  __syncthreads();  // S_in read: dS_out takes its place; A complete

  for (int i = tid; i < kD * (kD / 4); i += kN)
    tc::cp_async16(zs + (i / 16) * kQ + i % 16 * 4, s_out + i * 4, true);
  tc::cp_async_commit();
  // dw's S_in term at the chunk's end, exp(L_last) sum_e dS_out S_in per
  // channel, read from device memory: four threads a channel
  {
    const int d = tid / 4, part = tid % 4;
    float x = 0.f;
    if (d < kD) {
#pragma unroll
      for (int e = part * 16; e < part * 16 + 16; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s_in + d * kD + e);
        const float4 o = *reinterpret_cast<const float4*>(s_out + d * kD + e);
        x += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0 && d < kD) col[d] = expf(l_last[d]) * x;
  }
  // dv = A^T do (tiles of t on or below s's; k = t permuted) ...
  for (int kc = rt; kc < L::RT; ++kc) {
    float small[NT][4] = {}, big[NT][4] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s0 = kc * 16 + hh * 8;
      tf::FragA fa;  // A^T[s][t] = A[t][s]
      tf::frag_a<true>(fa, [&](int i, int j) {
        return xa[(s0 + j) * kQ + rt * 16 + i];
      });
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        tf::FragB fb;
        tf::load_b_perm<kQ>(fb, gs + s0 * kQ + col0 + n * 8, g4, t4);
        tf::mma3(small[n], big[n], fa, fb);
      }
    }
    tf::add(dv, big, small);
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // dS_out landed
  // ... + k2 dS_out, k2 = k exp(L_last - L)
  {
    float small[NT][4], big[NT][4];
    dot64([&](int i, int f) {
      const int s = rt * 16 + i;
      return ks[s * kQ + f] * expf(l_last[f] - at_l(s, f));
    }, [&](int f, int n, int nn) { return zs[f * kQ + col0 + n * 8 + nn]; },
          small, big);
    tf::add(dv, big, small);
  }
  // dv is complete with its u-diagonal: written now
  float* dv_o = static_cast<float*>(p.dv);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      const float g = dg[t];
      if (t0 + t < p.S)
        *reinterpret_cast<float2*>(dv_o + tok(p, b, t0 + t, h) + d) =
            make_float2(dv[n][2 * hh] + g * gs[t * kQ + d],
                        dv[n][2 * hh + 1] + g * gs[t * kQ + d + 1]);
    }
  // the state term of dk, dks = exp(L_last - L) (v dS_out^T)
  {
    float small[NT][4], big[NT][4];
    dot64([&](int i, int e) { return vs[(rt * 16 + i) * kQ + e]; },
          [&](int e, int n, int nn) {  // B[e][d] = dS_out[d][e]
            return zs[(col0 + n * 8 + nn) * kQ + e];
          }, small, big);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = big[n][e] + small[n][e];
  }
  // the column sums of k dks and of r k (do . v) over the warp's 16 rows
  // (a fixed order: the quad's rows by shuffles, then the row tiles)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float kd = 0.f, rk = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 2 * hh + x, t = row_of(e), d = col_of(n, e);
        dk[n][e] *= expf(l_last[d] - at_l(t, d));
        kd += ks[t * kQ + d] * dk[n][e];
        rk += rs[t * kQ + d] * ks[t * kQ + d] * dov[t];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        kd += __shfl_xor_sync(0xffffffffu, kd, off);
        rk += __shfl_xor_sync(0xffffffffu, rk, off);
      }
      if (g4 == 0) {
        kd_red[rt * kD + col_of(n, x)] = kd;
        du_red[rt * kD + col_of(n, x)] = rk;
      }
    }
  __syncthreads();  // A read: dA takes its place

  // dA = do v^T, the tiles on and below the diagonal
  for (int tile = warp; tile < L::RT * (L::RT + 1) / 2; tile += L::W) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    const int tj = tile - ti * (ti + 1) / 2;
    float small[2][4], big[2][4];
    dot64([&](int i, int e) { return gs[(ti * 16 + i) * kQ + e]; },
          [&](int e, int n, int nn) {  // B[e][s] = v[s][e]
            return vs[(tj * 16 + n * 8 + nn) * kQ + e];
          }, small, big);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[(ti * 16 + g4 + 8 * (e >> 1)) * kQ + tj * 16 + nt * 8 + 2 * t4 +
           (e & 1)] = big[nt][e] + small[nt][e];
  }
  __syncthreads();

  // the decayed intra-chunk products of dr and dk: the diagonal sub-blocks
  // pairwise, thread i on channel i % 64 of sub-chunk i / 64, each pair's
  // exponential serving both dr (row t) and dk (row s); the sums reach
  // the fragments' owners through zs, free since dS_out's last product ...
  {
    const bool on = tid < L::NS * kD;
    const int b0 = (tid / kD) * kSub, d = tid % kD;
    float dra[kSub] = {}, dka[kSub] = {};
    if (on) {
      float lr[kSub], kr[kSub];
#pragma unroll
      for (int x = 0; x < kSub; ++x) {
        lr[x] = at_l(b0 + x, d);
        kr[x] = ks[(b0 + x) * kQ + d];
      }
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt) {
        const float et = at_e(b0 + tt, d), rv = rs[(b0 + tt) * kQ + d];
        const float* da = xa + (b0 + tt) * kQ + b0;
#pragma unroll
        for (int ss = 0; ss < tt; ++ss) {
          const float e = expf(fminf(et - lr[ss], 0.f)) * da[ss];
          dra[tt] += kr[ss] * e;
          dka[ss] += rv * e;
        }
      }
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dra[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dr[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
    __syncthreads();
    if (on) {
#pragma unroll
      for (int x = 0; x < kSub; ++x) zs[(b0 + x) * kQ + d] = dka[x];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += zs[row_of(e) * kQ + col_of(n, e)];
  }
  // ... and the off-diagonal blocks through L_ref at the end of sub-chunk
  // j: dr's rows (sub-chunk rt) over each earlier j, dA times k exp(L_ref
  // - L), then times exp(E - L_ref) ...
  for (int j = 0; j < rt; ++j) {
    const float* ref = ls + (j * kSub + kSub - 1) * kQ;
    float small[NT][4] = {}, big[NT][4] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s0 = j * 16 + hh * 8;
      tf::FragA fa;
      tf::frag_a<false>(fa, [&](int i, int jj) {
        return xa[(rt * 16 + i) * kQ + s0 + jj];
      });
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        tf::FragB fb;
        tf::frag_b<false>(fb, [&](int jj, int nn) {
          const int s = s0 + jj, d = col0 + n * 8 + nn;
          return ks[s * kQ + d] * expf(fminf(ref[d] - at_l(s, d), 0.f));
        });
        tf::mma3(small[n], big[n], fa, fb);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dr[n][e] += expf(fminf(at_e(row_of(e), d) - ref[d], 0.f)) *
                    (big[n][e] + small[n][e]);
      }
  }
  // ... dk's rows (sub-chunk rt) over each later i: dA^T times r exp(E -
  // L_ref) (k = t permuted), summed over i, then times exp(L_ref - L)
  if (rt + 1 < L::RT) {
    const float* ref = ls + (rt * kSub + kSub - 1) * kQ;
    float tmp[NT][4] = {};
    for (int i = rt + 1; i < L::RT; ++i) {
      float small[NT][4] = {}, big[NT][4] = {};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s0 = i * 16 + hh * 8;
        tf::FragA fa;  // dA^T[s][t]
        tf::frag_a<true>(fa, [&](int ii, int jj) {
          return xa[(s0 + jj) * kQ + rt * 16 + ii];
        });
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          tf::FragB fb;
          tf::frag_b<true>(fb, [&](int jj, int nn) {
            const int t = s0 + jj, d = col0 + n * 8 + nn;
            return rs[t * kQ + d] * expf(fminf(at_e(t, d) - ref[d], 0.f));
          });
          tf::mma3(small[n], big[n], fa, fb);
        }
      }
      tf::add(tmp, big, small);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col_of(n, e);
        dk[n][e] += expf(fminf(ref[d] - at_l(row_of(e), d), 0.f)) * tmp[n][e];
      }
  }

  // dr and dk with their u-terms; dw's parts
  float* dr_o = static_cast<float*>(p.dr);
  float* dk_o = static_cast<float*>(p.dk);
  float ge[NT][4], gl[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      const float rt_ = rs[t * kQ + d], kt = ks[t * kQ + d];
      const float bonus = us[d] * dov[t];
      ge[n][e] = rt_ * dr[n][e];
      gl[n][e] = -kt * dk[n][e];
      dr[n][e] += bonus * kt;
      dk[n][e] += bonus * rt_;
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g4 + 8 * hh, d = col_of(n, 2 * hh);
      if (t0 + t >= p.S) continue;
      const size_t o = tok(p, b, t0 + t, h) + d;
      *reinterpret_cast<float2*>(dr_o + o) =
          make_float2(dr[n][2 * hh], dr[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dk_o + o) =
          make_float2(dk[n][2 * hh], dk[n][2 * hh + 1]);
    }
  __syncthreads();  // L and E read: they take gL and gE + gL
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row_of(e), d = col_of(n, e);
      ls[t * kQ + d] = gl[n][e];
      xs[t * kQ + d] = ge[n][e] + gl[n][e];
    }
  __syncthreads();
  if (tid < kD) {  // dw down channel tid, from the chunk's end; du's partial
    const int d = tid;
    float last = col[d], du = 0.f;
    for (int r = 0; r < L::RT; ++r) {
      last += kd_red[r * kD + d];
      du += du_red[r * kD + d];
    }
    float acc = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      const float add = t == C - 1 ? last : 0.f;
      if (t0 + t < p.S)
        p.dw[tok(p, b, t0 + t, h) + d] = acc + ls[t * kQ + d] + add;
      acc += xs[t * kQ + d] + add;
    }
    if (p.du_part) p.du_part[bhc * kD + d] = du;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// each chunk's increment, the carry of dS, the gradient pass; du's sum
// with u
template <typename T, int C>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kBF = std::is_same<T, bf16>::value;
  const int n_chunks = (a.S + C - 1) / C;
  const dim3 grid(n_chunks, a.H, a.B);
  auto inc = kBF ? linear_attn_bwd_inc_kernel<C>
                 : linear_attn_bwd_inc_f32_kernel<C>;
  size_t smem = kBF ? inc_smem_bytes<C>() : inc_f32_smem_bytes<C>();
  cudaError_t e = allow_smem(inc, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  inc<<<grid, kTC, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long entries = static_cast<long>(a.B) * a.H * kD * kD;
  linear_attn_bwd_carry_kernel<<<static_cast<unsigned>((entries + 255) / 256),
                                 256, 0, stream>>>(a, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto chunk = kBF ? linear_attn_bwd_chunk_tc_kernel<C>
                   : linear_attn_bwd_chunk_f32_kernel<C>;
  smem = kBF ? GradTC<C>::bytes : GradF32<C>::bytes;
  e = allow_smem(chunk, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk<<<grid, kBF ? kTC : GradF32<C>::W * 32, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.u == nullptr) return static_cast<int>(e);
  linear_attn_bwd_du_kernel<<<a.H, kD, 0, stream>>>(a.du_part, a.du, a.B,
                                                    a.H, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk(const Args& a, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of r, k, v, do, dr, dk and dv: 0 float32, 1 bfloat16.  u, du and
// du_part are null together (no bonus); d_state may be null (zero).
// states: the S_in the forward's scan wrote for the same operands and
// chunk.  ds_out, decay and du_part: the wrapper's fp32 scratch (see the
// header).  Returns the CUDA error code of the launches (0 on success);
// the wrapper raises on anything else.
extern "C" int linear_attn_chunk_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* states, const void* dout, const void* d_state, void* dr,
    void* dk, void* dv, void* dw, void* du, void* d_s0, void* ds_out,
    void* decay, void* du_part, int B, int S, int H, int chunk, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (u == nullptr) != (du == nullptr) ||
      (u == nullptr) != (du_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r,
         k,
         v,
         static_cast<const float*>(w),
         static_cast<const float*>(u),
         static_cast<const float*>(states),
         dout,
         static_cast<const float*>(d_state),
         dr,
         dk,
         dv,
         static_cast<float*>(dw),
         static_cast<float*>(du),
         static_cast<float*>(d_s0),
         static_cast<float*>(ds_out),
         static_cast<float*>(decay),
         static_cast<float*>(du_part),
         B,
         S,
         H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunk<float>(a, chunk, s);
    case 1: return launch_chunk<bf16>(a, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
