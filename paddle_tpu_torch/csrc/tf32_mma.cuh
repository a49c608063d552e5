// Pieces shared by the tensor-core kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, ffn_gemm.cu): cp.async copies into shared memory, the
// 3xTF32 split and product, reductions over the four lanes of a quad, and
// the flash kernels' split of a wide head's output columns.
// `native` hashes a source together with the headers it includes, so an edit
// here rebuilds every library that includes this file.
#pragma once
#include <stdint.h>

namespace ptt {

// The output columns one block of a flash kernel owns at head width DH: all
// of them, or at DH 256 one 128-wide half, so that its accumulators keep the
// DH 128 register budget. The block's scores (and in the backward dP) still
// span all DH columns; the grid takes kHalves<DH> blocks a row tile, one a
// half, in one launch (the float32 dK/dV kernel twice that: dK's halves
// and dV's).
template <int DH>
constexpr int kOutCols = DH > 128 ? 128 : DH;
template <int DH>
constexpr int kHalves = DH / kOutCols<DH>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small: big is x cut to tf32 (its low 13 mantissa bits cleared),
// small = x - big exactly; the tensor cores read small's top 10 mantissa
// bits. A masked AND and an FADD: cheaper on the card than two `cvt.rna`
// conversions, and still within 2^-20 of x, where one tf32 pass keeps 2^-10
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a · b for one m16n8k8 tile (A row-major 16 x 8, B col-major 8 x 8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a · b[n] for N tiles in 3xTF32, the small cross terms first, pass
// by pass so that consecutive products are independent
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (*bb)[2],
                                           const uint32_t (*bs)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], as, bb[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ab, bb[n]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace ptt
