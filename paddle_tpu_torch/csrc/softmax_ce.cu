// Fused softmax cross-entropy over [N, V] logits with hard labels.
//
//   forward:  lse = m + log(max(l, 1e-30)) over the row (m the row max, l the
//             denominator rescaled to it); loss = lse - x[label]; a label
//             equal to ignore_index gives loss 0 (its lse is still written);
//             a label outside [0, V) picks nothing, so its pick is 0.
//   backward: dx = (exp(x - lse) - [col == label]) * ct, with ct forced to 0
//             on ignored rows, so those rows come out exactly 0.
//
// Replaces paddle_tpu/ops/ce_ops.py `_fused_ce_fwd_pallas` (kernel body
// `_fwd_kernel`) and `_fused_ce_bwd_pallas` (`_bwd_kernel`). The TPU kernels
// walk a (256-row, 2048-column) block grid and carry the running max,
// denominator and picked logit in VMEM scratch along the sequential vocab
// axis of the grid.
//
// Bound on an H100: bytes. The forward reads the logits once (N·V·4 bytes)
// for a few operations per element; the backward reads them once and writes
// dx once. At N 8192, V 32000 that is 1.05 GB and 2.1 GB.
//
// Design: one block of 256 threads per row; CUDA blocks run in no order, so
// the loop inside the block takes the place of the TPU's sequential vocab
// axis. In the forward each thread streams its share of the row once with
// 16-byte loads, keeping its own running max and rescaled denominator
// (online softmax); the (max, denominator) pairs then merge by warp shuffles
// and one shared-memory step, and thread 0 reads the label's logit directly
// (one more load, where the TPU kernel compared every column with the
// label). The backward is elementwise with a per-row broadcast of lse, ct
// and the label. Labels arrive as int64 and are narrowed to int32, as the
// TPU kernel casts them. When V is not a multiple of 4 (or a pointer is not
// 16-byte aligned) the same kernels run with scalar accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's running-max seed

// fold (m2, l2) into the running pair (m, l): l is a sum of exp(x - m)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_fwd(const float* __restrict__ x, const int64_t* __restrict__ labels,
           float* __restrict__ loss, float* __restrict__ lse, int64_t V,
           int ignore_index) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * V;
  float m = kNegInf;
  float l = 0.f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int64_t V4 = V / 4;
    for (int64_t c = threadIdx.x; c < V4; c += kThreads) {
      const float4 v = x4[c];
      const float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
      if (mx > m) {
        l *= expf(m - mx);
        m = mx;
      }
      l += expf(v.x - m) + expf(v.y - m) + expf(v.z - m) + expf(v.w - m);
    }
  } else {
    for (int64_t c = threadIdx.x; c < V; c += kThreads) {
      const float v = xr[c];
      if (v > m) {
        l *= expf(m - v);
        m = v;
      }
      l += expf(v - m);
    }
  }
  warp_merge(m, l);
  __shared__ float sm[kWarps];
  __shared__ float sl[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < kWarps ? sm[lane] : kNegInf;
  l = lane < kWarps ? sl[lane] : 0.f;
  warp_merge(m, l);
  if (lane == 0) {
    const float row_lse = m + logf(fmaxf(l, 1e-30f));
    const int lab = static_cast<int>(labels[row]);
    const float pick = (lab >= 0 && lab < V) ? xr[lab] : 0.f;
    lse[row] = row_lse;
    loss[row] = lab != ignore_index ? row_lse - pick : 0.f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_bwd(const float* __restrict__ x, const int64_t* __restrict__ labels,
           const float* __restrict__ lse, const float* __restrict__ ct,
           float* __restrict__ dx, int64_t V, int ignore_index) {
  const int64_t row = blockIdx.x;
  const int lab = static_cast<int>(labels[row]);
  const float c = lab != ignore_index ? ct[row] : 0.f;
  const float r = lse[row];
  const float* xr = x + row * V;
  float* dr = dx + row * V;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* d4 = reinterpret_cast<float4*>(dr);
    const int64_t V4 = V / 4;
    for (int64_t i = threadIdx.x; i < V4; i += kThreads) {
      const float4 v = x4[i];
      const int64_t col = 4 * i;
      float4 o;
      o.x = (expf(v.x - r) - (col == lab ? 1.f : 0.f)) * c;
      o.y = (expf(v.y - r) - (col + 1 == lab ? 1.f : 0.f)) * c;
      o.z = (expf(v.z - r) - (col + 2 == lab ? 1.f : 0.f)) * c;
      o.w = (expf(v.w - r) - (col + 3 == lab ? 1.f : 0.f)) * c;
      d4[i] = o;
    }
  } else {
    for (int64_t col = threadIdx.x; col < V; col += kThreads) {
      dr[col] = (expf(xr[col] - r) - (col == lab ? 1.f : 0.f)) * c;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x [n, V] f32, labels [n] int64, loss and lse [n] f32; all contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_softmax_ce_fwd(const void* x, const void* labels,
                                  void* loss, void* lse, int64_t n,
                                  int64_t V, int64_t ignore_index,
                                  void* stream) {
  if (n <= 0) return 0;
  if (V <= 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int64_t* lp = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  const int ig = static_cast<int>(ignore_index);
  const unsigned blocks = static_cast<unsigned>(n);
  if (V % 4 == 0 && aligned16(x)) {
    ce_fwd<true><<<blocks, kThreads, 0, st>>>(xp, lp, lo, ls, V, ig);
  } else {
    ce_fwd<false><<<blocks, kThreads, 0, st>>>(xp, lp, lo, ls, V, ig);
  }
  return static_cast<int>(cudaGetLastError());
}

// x and dx [n, V] f32, labels [n] int64, lse and ct [n] f32; all
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int ptt_softmax_ce_bwd(const void* x, const void* labels,
                                  const void* lse, const void* ct, void* dx,
                                  int64_t n, int64_t V, int64_t ignore_index,
                                  void* stream) {
  if (n <= 0) return 0;
  if (V <= 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int64_t* lp = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* cp = static_cast<const float*>(ct);
  float* dp = static_cast<float*>(dx);
  const int ig = static_cast<int>(ignore_index);
  const unsigned blocks = static_cast<unsigned>(n);
  if (V % 4 == 0 && aligned16(x) && aligned16(dx)) {
    ce_bwd<true><<<blocks, kThreads, 0, st>>>(xp, lp, ls, cp, dp, V, ig);
  } else {
    ce_bwd<false><<<blocks, kThreads, 0, st>>>(xp, lp, ls, cp, dp, V, ig);
  }
  return static_cast<int>(cudaGetLastError());
}
