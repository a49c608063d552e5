// Multi-tensor Adam, in place, with Paddle's placement of eps:
//
//   lr_t = lr * sqrt(1 - beta2_pow[0]) / (1 - beta1_pow[0])
//   m1 = b1 * m1 + (1 - b1) * g
//   m2 = b2 * m2 + (1 - b2) * g * g
//   p  = p - lr_t * m1 / (sqrt(m2) + eps)
//   beta1_pow[i] *= b1;  beta2_pow[i] *= b2      (for every tensor i)
//
// lr_t comes from the FIRST tensor's beta powers, as the JAX package's fused
// op takes it; every accumulator starts and advances alike.
//
// Replaces paddle_tpu/ops/optimizer_ops.py `_fused_adam_flat` (kernel body
// `_fused_adam_kernel`), which runs one elementwise pass over the whole
// parameter set flattened, concatenated and padded to (R, 128) tiles: the
// JAX side pays a copy of p, g, m1 and m2 into that vector and back.
//
// Bound on an H100: bytes. Per element it reads p, g, m1, m2 and writes p,
// m1, m2 (28 bytes) for about a dozen flops; at the flagship's 51.7 M
// parameters that is 1.45 GB.
//
// Design: no copies. A launch takes a table of up to kChunk tensors (their
// p, g, m1, m2 and beta-power pointers, sizes and prefix offsets) in its
// parameter block, which lives in the card's constant bank: nothing is
// allocated or copied for it, and the launch stays capturable in a CUDA
// graph. The grid strides over the concatenated index space of the chunk in
// units of four elements; a thread walks the prefix offsets with a cursor
// (its indices only grow), updates four elements with 16-byte accesses when
// the tensor's pointers are aligned, and the tail of each tensor one by one.
// lr_t is computed on the card by a one-thread launch ahead of the chunks,
// from device tensors, so no step reads a value back to the host; block 0
// of each chunk then advances that chunk's beta powers. Every operation is
// the correctly rounded IEEE one (no contraction into fused multiply-adds),
// so the result is the plain PyTorch version's, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// tensors per launch: keeps the parameter block under the 4 KB that every
// CUDA driver accepts
constexpr int kChunk = 48;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;

struct Chunk {
  float* p[kChunk];
  const float* g[kChunk];
  float* m1[kChunk];
  float* m2[kChunk];
  float* b1p[kChunk];
  float* b2p[kChunk];
  int64_t numel[kChunk];
  int64_t qstart[kChunk + 1];  // prefix offsets in units of 4 elements
  uint64_t vec;                // bit i: tensor i takes 16-byte accesses
  int n;
};

__global__ void adam_lr_t(const float* __restrict__ lr,
                          const float* __restrict__ b1p,
                          const float* __restrict__ b2p,
                          float* __restrict__ lr_t) {
  lr_t[0] = __fdiv_rn(__fmul_rn(lr[0], __fsqrt_rn(__fsub_rn(1.f, b2p[0]))),
                      __fsub_rn(1.f, b1p[0]));
}

struct Coef {
  float lr_t, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m1,
                                          float& m2, const Coef& k) {
  m1 = __fadd_rn(__fmul_rn(k.b1, m1), __fmul_rn(k.omb1, g));
  m2 = __fadd_rn(__fmul_rn(k.b2, m2), __fmul_rn(__fmul_rn(k.omb2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.lr_t, m1),
                             __fadd_rn(__fsqrt_rn(m2), k.eps)));
}

__global__ void __launch_bounds__(kThreads)
    adam_update(const Chunk t, const float* __restrict__ lr_t, float b1,
                float omb1, float b2, float omb2, float eps) {
  const Coef k{lr_t[0], b1, omb1, b2, omb2, eps};
  const int64_t total = t.qstart[t.n];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int ti = 0;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < total; q += stride) {
    while (q >= t.qstart[ti + 1]) ++ti;
    const int64_t e = (q - t.qstart[ti]) * 4;
    const int64_t n = t.numel[ti];
    float* p = t.p[ti] + e;
    const float* g = t.g[ti] + e;
    float* m1 = t.m1[ti] + e;
    float* m2 = t.m2[ti] + e;
    if (((t.vec >> ti) & 1u) && e + 4 <= n) {
      float4 pv = *reinterpret_cast<float4*>(p);
      const float4 gv = *reinterpret_cast<const float4*>(g);
      float4 av = *reinterpret_cast<float4*>(m1);
      float4 bv = *reinterpret_cast<float4*>(m2);
      adam_elem(pv.x, gv.x, av.x, bv.x, k);
      adam_elem(pv.y, gv.y, av.y, bv.y, k);
      adam_elem(pv.z, gv.z, av.z, bv.z, k);
      adam_elem(pv.w, gv.w, av.w, bv.w, k);
      *reinterpret_cast<float4*>(p) = pv;
      *reinterpret_cast<float4*>(m1) = av;
      *reinterpret_cast<float4*>(m2) = bv;
    } else {
      for (int j = 0; j < 4 && e + j < n; ++j) {
        float pj = p[j];
        float aj = m1[j];
        float bj = m2[j];
        adam_elem(pj, g[j], aj, bj, k);
        p[j] = pj;
        m1[j] = aj;
        m2[j] = bj;
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < t.n; i += blockDim.x) {
      *t.b1p[i] = __fmul_rn(*t.b1p[i], b1);
      *t.b2p[i] = __fmul_rn(*t.b2p[i], b2);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Tensor i has numel[i] f32 elements at p[i], g[i], m1[i], m2[i] and the
// one-element f32 beta powers b1p[i], b2p[i]; lr is a one-element f32
// tensor on the card and lr_t one element of scratch there. omb1 and omb2
// are (1 - b1) and (1 - b2) as the caller rounds them. Updates p, m1, m2
// and the beta powers in place. Returns the first cudaGetLastError() that
// is not 0, else 0.
extern "C" int ptt_fused_adam(void* const* p, void* const* g,
                              void* const* m1, void* const* m2,
                              void* const* b1p, void* const* b2p,
                              const int64_t* numel, int64_t n_tensors,
                              const void* lr, void* lr_t, float b1,
                              float omb1, float b2, float omb2, float eps,
                              void* stream) {
  if (n_tensors <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lrt = static_cast<float*>(lr_t);
  adam_lr_t<<<1, 1, 0, st>>>(static_cast<const float*>(lr),
                             static_cast<const float*>(b1p[0]),
                             static_cast<const float*>(b2p[0]), lrt);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  for (int64_t base = 0; base < n_tensors; base += kChunk) {
    Chunk t;
    t.n = static_cast<int>(n_tensors - base < kChunk ? n_tensors - base
                                                     : kChunk);
    t.vec = 0;
    t.qstart[0] = 0;
    for (int i = 0; i < t.n; ++i) {
      const int64_t j = base + i;
      t.p[i] = static_cast<float*>(p[j]);
      t.g[i] = static_cast<const float*>(g[j]);
      t.m1[i] = static_cast<float*>(m1[j]);
      t.m2[i] = static_cast<float*>(m2[j]);
      t.b1p[i] = static_cast<float*>(b1p[j]);
      t.b2p[i] = static_cast<float*>(b2p[j]);
      t.numel[i] = numel[j];
      t.qstart[i + 1] = t.qstart[i] + (numel[j] + 3) / 4;
      if (aligned16(p[j]) && aligned16(g[j]) && aligned16(m1[j]) &&
          aligned16(m2[j]))
        t.vec |= uint64_t(1) << i;
    }
    const int64_t quads = t.qstart[t.n];
    int64_t blocks = (quads + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;  // block 0 still advances the beta powers
    adam_update<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        t, lrt, b1, omb1, b2, omb2, eps);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}
