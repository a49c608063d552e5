// Pieces shared by the bf16 tensor-core kernels (flash_attn_bf16_fwd.cu,
// flash_attn_bf16_bwd.cu): the m16n8k16 bf16 product with float32
// accumulation, ldmatrix loads of its operands from shared memory, packing
// float32 accumulators into bf16 A fragments, 2^x, and the tile loaders. The
// cp.async helpers and the quad reductions come from tf32_mma.cuh.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t):
//   A 16 x 16, row-major: a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
//     a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8, cols 2t + 8, 2t + 9)
//   B 16 x 8: b0 (k 2t, 2t + 1; column g), b1 (k 2t + 8, 2t + 9)
//   C 16 x 8, float32: c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8)
// so the accumulators of two neighbouring 8-column tiles are, packed two by
// two into bf16, the A fragment of one 16-deep k-step: P and dS move from
// accumulator to operand in registers, with no shuffle.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace ptt {

typedef __nv_bfloat16 bf16;

// two floats rounded to nearest-even bf16, ``lo`` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a · b for one m16n8k16 tile, bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Row stride, in bf16, of a tile of DH-wide rows in shared memory: DH + 8
// puts the eight 16-byte rows of one ldmatrix in distinct banks.
template <int DH>
constexpr int kLdB = DH + 8;

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major tile (lanes 0-15 give rows r0.., column c0; lanes 16-31 the
// same rows at column c0 + 8).
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * kLdB<DH> + c0 + (lane >> 4) * 8);
}

// B fragments of the product X · T^T for two 8-row blocks of T: T rows
// [n0, n0 + 16) (the product's columns) over columns [c0, c0 + 16) (its
// depth). b[0], b[1] serve the block n0, b[2], b[3] the block n0 + 8.
template <int DH>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile,
                                            int n0, int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kLdB<DH> +
                     c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of the product C · T for a T tile read N-major: T rows
// [k0, k0 + 16) (the product's depth) and columns [n0, n0 + 16) (its
// columns), b[0], b[1] for columns n0.., b[2], b[3] for n0 + 8.
template <int DH>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile,
                                            int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kLdB<DH> +
                           n0 + (lane >> 4) * 8);
}

// The A fragment of k-step s from two neighbouring accumulator tiles
// c[2s], c[2s + 1] (16 rows x 16 columns of float32), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (*c)[4],
                                       int s) {
  a[0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
  a[1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
  a[2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
  a[3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
}

// 2^x as one instruction of the special-function unit (`ex2.approx.ftz`:
// about 2^-22 relative error; a result below 2^-126, or x = -inf, gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + ROWS) of a [L, DH] bf16 matrix into a tile of padded rows,
// zeros past L, 16 bytes a copy. A thread's copies lie at one column and
// rows THREADS / (DH / 8) apart, so each costs an offset and a compare (a
// loader that spends a division and a 64-bit index a copy costs, in an
// issue-bound loop of mma.sync, about as much as a softmax).
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int L, int tid) {
  constexpr int CH = DH / 8;          // 16-byte chunks a row
  constexpr int STEP = THREADS / CH;  // rows between a thread's chunks
  constexpr int N = (ROWS + STEP - 1) / STEP;
  const int rr = tid / CH, cc = (tid % CH) * 8;
  bf16* d = dst + rr * kLdB<DH> + cc;
  const bf16* g = src + static_cast<int64_t>(r0 + rr) * DH + cc;
  const int left = L - r0 - rr;  // rows below L from this thread's first
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (ROWS % STEP == 0 || rr + i * STEP < ROWS) {
      const bool in = i * STEP < left;
      cp_async16(d + i * STEP * kLdB<DH>, in ? g + i * STEP * DH : src, in);
    }
}

// n float32 values [r0, r0 + n) of a length-L vector, zeros past L
template <int THREADS>
__device__ __forceinline__ void load_vec_f32(float* dst, const float* src,
                                             int r0, int n, int L, int tid) {
  for (int c = tid; c < n; c += THREADS) {
    const bool in = r0 + c < L;
    cp_async4(dst + c, in ? src + r0 + c : src, in);
  }
}

}  // namespace ptt
