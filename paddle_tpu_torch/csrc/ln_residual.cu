// Fused residual add + LayerNorm, forward and backward.
//
//   forward:  s = x + r;  mean = mean(s);  rstd = 1 / sqrt(mean((s - mean)^2)
//             + eps);  y = (s - mean) * rstd * scale + bias
//   backward: x_hat = (s - mean) * rstd, recomputed;  dyw = dy * scale;
//             dx = rstd * (dyw - mean(dyw) - x_hat * mean(dyw * x_hat)) + ds
//
// over rows of [N, D]. The forward emits s, y and the per-row f32 mean and
// rstd, the statistics the backward recomputes x_hat from; the backward's dx
// is the gradient of both x and r (ds is the cotangent of s, the residual
// stream). The scale and bias gradients are column sums over all rows and
// stay plain reductions outside the kernel, as in the JAX package.
//
// Replaces paddle_tpu/ops/nn_ops.py `_ln_res_fwd_pallas` (kernel body
// `_ln_res_fwd_kernel`) and `_ln_res_bwd_pallas` (`_ln_res_bwd_kernel`),
// which hold a (bn, D) row block in VMEM.
//
// Bound on an H100: bytes. Per row the forward reads 2·D floats and writes
// 2·D floats (plus 8 bytes of statistics) for about 8·D flops; the backward
// reads 3·D floats (s, dy, ds) and writes D for about 12·D flops. Both are
// far below the card's ratio of flops to bytes.
//
// Design: one warp per row, eight rows per block. Each lane owns the
// elements lane + 32·k of its row (k < K = ceil(D / 32)), so a warp's loads
// and stores cover contiguous 128-byte lines. The forward keeps its K
// elements of s in registers, so s is read from x and r exactly once; its
// statistics are two warp-shuffle reductions in the TPU kernel's two-pass
// order (the mean first, then the mean of the squared deviations, which does
// not cancel the way E[s^2] - E[s]^2 does). The backward keeps its K values
// of dy·scale in registers (one array, the forward's register budget, so D
// 4096 still fits), reduces the two row means with warp shuffles and, in
// its second sweep, reads s again (from L1 or L2: the warp has just read
// it) to recompute x_hat. No shared memory, no block-level synchronisation.
// Rows wider than 4096 (up to 8192, the JAX package's Pallas limit) take
// the `_wide` kernels: the same lanes, sums and order, with each sweep a
// strided loop that reads its row again (s written by the forward's first
// sweep, dy and s in the backward's second) instead of holding it in
// registers, so the bits equal what a register-resident row would give.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxD = 8192;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int K>
__global__ void ln_res_fwd(const float* __restrict__ x,
                           const float* __restrict__ r,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ s_out, float* __restrict__ y_out,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int64_t n, int D,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row: no shuffle is cut
  const int64_t base = row * D;
  float v[K];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    float t = 0.f;
    if (c < D) {
      t = x[base + c] + r[base + c];
      s_out[base + c] = t;
    }
    v[k] = t;
    sum += t;
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    const float d = (c < D) ? v[k] - mean : 0.f;
    v[k] = d;
    sq += d * d;
  }
  const float rstd =
      1.f / sqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < D) y_out[base + c] = v[k] * rstd * scale[c] + bias[c];
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// the forward of a row too wide for registers: s written in the first sweep
// and read back (by the same thread) in the second and third
__global__ void ln_res_fwd_wide(const float* __restrict__ x,
                                const float* __restrict__ r,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* __restrict__ s_out,
                                float* __restrict__ y_out,
                                float* __restrict__ mean_out,
                                float* __restrict__ rstd_out, int64_t n, int D,
                                float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row: no shuffle is cut
  const int64_t base = row * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float t = x[base + c] + r[base + c];
    s_out[base + c] = t;
    sum += t;
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = s_out[base + c] - mean;
    sq += d * d;
  }
  const float rstd =
      1.f / sqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  for (int c = lane; c < D; c += 32)
    y_out[base + c] = (s_out[base + c] - mean) * rstd * scale[c] + bias[c];
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <int K>
void launch(const float* x, const float* r, const float* scale,
            const float* bias, float* s, float* y, float* mean, float* rstd,
            int64_t n, int D, float eps, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ln_res_fwd<K><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      x, r, scale, bias, s, y, mean, rstd, n, D, eps);
}

template <int K>
__global__ void ln_res_bwd(const float* __restrict__ s,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const float* __restrict__ scale,
                           const float* __restrict__ dy,
                           const float* __restrict__ ds,
                           float* __restrict__ dx, int64_t n, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row: no shuffle is cut
  const int64_t base = row * D;
  const float m = mean[row];
  const float rs = rstd[row];
  float dyw[K];
  float sum1 = 0.f;
  float sum2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    float t = 0.f;
    if (c < D) {
      t = dy[base + c] * scale[c];
      sum2 += t * ((s[base + c] - m) * rs);
    }
    dyw[k] = t;
    sum1 += t;
  }
  const float mean1 = warp_sum(sum1) / static_cast<float>(D);
  const float mean2 = warp_sum(sum2) / static_cast<float>(D);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < D) {
      const float xhat = (s[base + c] - m) * rs;
      dx[base + c] = rs * (dyw[k] - mean1 - xhat * mean2) + ds[base + c];
    }
  }
}

// the backward of a row too wide for registers: dy·scale recomputed in the
// second sweep
__global__ void ln_res_bwd_wide(const float* __restrict__ s,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                const float* __restrict__ scale,
                                const float* __restrict__ dy,
                                const float* __restrict__ ds,
                                float* __restrict__ dx, int64_t n, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row: no shuffle is cut
  const int64_t base = row * D;
  const float m = mean[row];
  const float rs = rstd[row];
  float sum1 = 0.f;
  float sum2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float t = dy[base + c] * scale[c];
    sum2 += t * ((s[base + c] - m) * rs);
    sum1 += t;
  }
  const float mean1 = warp_sum(sum1) / static_cast<float>(D);
  const float mean2 = warp_sum(sum2) / static_cast<float>(D);
  for (int c = lane; c < D; c += 32) {
    const float xhat = (s[base + c] - m) * rs;
    const float t = dy[base + c] * scale[c];
    dx[base + c] = rs * (t - mean1 - xhat * mean2) + ds[base + c];
  }
}

template <int K>
void launch_bwd(const float* s, const float* mean, const float* rstd,
                const float* scale, const float* dy, const float* ds,
                float* dx, int64_t n, int D, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ln_res_bwd<K><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      s, mean, rstd, scale, dy, ds, dx, n, D);
}

}  // namespace

// Largest row width the kernels take (the JAX package's Pallas limit);
// rows up to 4096 are register-resident.
extern "C" int ptt_ln_residual_max_d() { return kMaxD; }

// x, r, s, y [n, D] f32; scale, bias [D] f32; mean, rstd [n] f32; all
// contiguous. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a D the kernel does not take).
extern "C" int ptt_ln_residual_fwd(const void* x, const void* r,
                                   const void* scale, const void* bias,
                                   void* s, void* y, void* mean, void* rstd,
                                   int64_t n, int64_t D, float eps,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(r);
  const float* sc = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(s);
  float* yp = static_cast<float*>(y);
  float* mp = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const int d = static_cast<int>(D);
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 4096) {
    const unsigned blocks =
        static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
    ln_res_fwd_wide<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps);
  } else if (D <= 128) {
    launch<4>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  } else if (D <= 256) {
    launch<8>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  } else if (D <= 512) {
    launch<16>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  } else if (D <= 1024) {
    launch<32>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  } else if (D <= 2048) {
    launch<64>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  } else {
    launch<128>(xp, rp, sc, bp, sp, yp, mp, rs, n, d, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// s, dy, ds, dx [n, D] f32; mean, rstd [n] f32; scale [D] f32; all
// contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a D the kernel does not take).
extern "C" int ptt_ln_residual_bwd(const void* s, const void* mean,
                                   const void* rstd, const void* scale,
                                   const void* dy, const void* ds, void* dx,
                                   int64_t n, int64_t D, void* stream) {
  if (n <= 0) return 0;
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  const float* sc = static_cast<const float*>(scale);
  const float* dyp = static_cast<const float*>(dy);
  const float* dsp = static_cast<const float*>(ds);
  float* dxp = static_cast<float*>(dx);
  const int d = static_cast<int>(D);
  if (D > 4096) {
    const unsigned blocks =
        static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
    ln_res_bwd_wide<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        sp, mp, rp, sc, dyp, dsp, dxp, n, d);
  } else if (D <= 128) {
    launch_bwd<4>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  } else if (D <= 256) {
    launch_bwd<8>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  } else if (D <= 512) {
    launch_bwd<16>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  } else if (D <= 1024) {
    launch_bwd<32>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  } else if (D <= 2048) {
    launch_bwd<64>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  } else {
    launch_bwd<128>(sp, mp, rp, sc, dyp, dsp, dxp, n, d, st);
  }
  return static_cast<int>(cudaGetLastError());
}
