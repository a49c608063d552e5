// Flash attention backward (the FlashAttention-2 split), f32: two kernels
// over q, k, v, dO [BH, L, DH], the forward's LSE [BH, L] and
// delta = rowsum(dO * O) [BH, L]. Both recompute, per (q tile, k tile),
//   P  = exp(scale · Q K^T + bias - LSE)     (0 where masked or dropped)
//   dP = dO V^T
//   dS = P · (dP - delta) · scale
// and then
//   dQ = dS K            (ptt_flash_attn_bwd_dq:  summed over k tiles)
//   dK = dS^T Q, dV = P^T dO   (ptt_flash_attn_bwd_dkv: summed over q tiles)
// The mask is causal (key j > query i) or none; the optional bias [B, L] is
// per key (row b of [BH, ...] reads bias row b / n_heads), and a key whose
// bias is -1e8 or lower is dropped. P of a masked or dropped entry is made 0
// by a select, not by the exponential: in a row whose keys are all dropped
// LSE is about -1e9 + log(1e-30) and exp(s - LSE) would be ~e^69.
//
// Replaces paddle_tpu/ops/attention_ops.py `_flash_bwd_pallas`: its first
// pallas_call (body `_bwd_dq_kernel`) and its second (body
// `_bwd_dkv_kernel`), with and without `has_bias`. On the TPU each is a
// grid (bh, outer tile, inner tile) whose inner axis is sequential, the
// accumulator carried across it in VMEM scratch.
//
// Bound on an H100: operations. dQ does three products per (query, key)
// pair (6·DH flops), dK/dV four (8·DH), against 4 bytes per element of six
// [BH, L, DH] operands: at L 128..512 and DH 64 the f32 flops outweigh the
// bytes several times. This first version runs on the f32 CUDA cores;
// tensor cores are later work.
//
// Design: the TPU's two-kernel split is kept, so every output element is
// summed by exactly one block in a fixed order: no atomics, and the result
// is the same from run to run. A CUDA grid has no order, so the sequential
// grid axis becomes a loop inside the block. dQ: one block of 256 threads
// per (bh, 64-row q tile) keeps Q, dO, LSE and delta resident and streams
// 64-row K, V tiles up to the diagonal. dK/dV: one block per (bh, 64-row k
// tile) keeps K, V and the tile's bias resident and streams Q, dO, LSE and
// delta tiles from the diagonal down. Each thread computes a 4 x 4 patch of
// S and dP in one sweep over DH (rows padded by one float, so the lanes of a
// warp read distinct banks), writes P and dS to shared memory, and then owns
// a 4 x (DH/16) slice of each accumulator in registers. Shared memory: 84 KB
// (dQ) and 100 KB (dK/dV) at DH 64, 149 KB and 165 KB at DH 128, so the
// launches raise the dynamic shared-memory limit. Rows and keys past L load
// as zeros and are masked, so any L works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped

// rows [r0, r0 + 64) of a [L, DH] matrix into a padded shared tile, zeros
// past L
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int L, int tid) {
  constexpr int RS = DH + 1;
  for (int e = tid; e < 64 * DH; e += kThreads) {
    const int rr = e / DH, c = e % DH, g = r0 + rr;
    dst[rr * RS + c] = g < L ? src[static_cast<int64_t>(g) * DH + c] : 0.f;
  }
}

// The thread's 4 x 4 patch (q rows ty*4+i, keys tx+16*jj) of P and dS for
// one (q tile, k tile) pair, from tiles in shared memory.
template <int DH>
__device__ __forceinline__ void p_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, const float* b_s, int q0, int k0,
    int L, float scale, int causal, int tx, int ty, float p[4][4],
    float ds[4][4]) {
  constexpr int RS = DH + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * RS + d];
      gv[i] = dOs[(ty * 4 + i) * RS + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      kv[jj] = Ks[(tx + 16 * jj) * RS + d];
      vv[jj] = Vs[(tx + 16 * jj) * RS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] += qv[i] * kv[jj];
        dp[i][jj] += gv[i] * vv[jj];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i, gr = q0 + rr;
    const float row_lse = lse_s[rr], row_delta = delta_s[rr];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int cc = tx + 16 * jj, gc = k0 + cc;
      const float b = b_s[cc];
      const bool keep = gr < L && gc < L && (!causal || gc <= gr) &&
                        b > kBiasDrop;
      const float pv = keep ? expf(s[i][jj] * scale + b - row_lse) : 0.f;
      p[i][jj] = pv;
      ds[i][jj] = pv * (dp[i][jj] - row_delta) * scale;
    }
  }
}

template <int DH>
constexpr size_t dq_smem_floats() {
  return static_cast<size_t>(4) * 64 * (DH + 1) + kBQ * (kBK + 1) + 2 * kBQ +
         kBK;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dq, int L,
                 int n_heads, float scale, int causal) {
  constexpr int RS = DH + 1;   // padded tile row stride
  constexpr int SS = kBK + 1;  // padded dS row stride
  constexpr int CPT = DH / 16; // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * RS;
  float* Ks = dOs + kBQ * RS;
  float* Vs = Ks + kBK * RS;
  float* dSs = Vs + kBK * RS;
  float* lse_s = dSs + kBQ * SS;
  float* delta_s = lse_s + kBQ;
  float* b_s = delta_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;
  const int64_t off = row0 * DH;
  const float* brow =
      bias ? bias + static_cast<int64_t>(blockIdx.y / n_heads) * L : nullptr;

  load_tile<DH>(Qs, q + off, q0, L, tid);
  load_tile<DH>(dOs, dout + off, q0, L, tid);
  if (tid < kBQ) {
    const int g = q0 + tid;
    lse_s[tid] = g < L ? lse[row0 + g] : 0.f;
    delta_s[tid] = g < L ? delta[row0 + g] : 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int last_row = min(q0 + kBQ, L) - 1;
  const int nk = causal ? last_row / kBK + 1 : (L + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<DH>(Ks, k + off, k0, L, tid);
    load_tile<DH>(Vs, v + off, k0, L, tid);
    if (tid < kBK) b_s[tid] = (brow && k0 + tid < L) ? brow[k0 + tid] : 0.f;
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<DH>(Qs, dOs, Ks, Vs, lse_s, delta_s, b_s, q0, k0, L, scale,
                 causal, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        dSs[(ty * 4 + i) * SS + tx + 16 * jj] = ds[i][jj];
    __syncthreads();

    // dQ += dS @ K
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kk * RS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dSs[(ty * 4 + i) * SS + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += d * kv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty * 4 + i;
    if (gr >= L) continue;
    float* row = dq + off + static_cast<int64_t>(gr) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  return static_cast<size_t>(4) * 64 * (DH + 1) + 2 * kBQ * (kBK + 1) +
         2 * kBQ + kBK;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ bias, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int n_heads, float scale,
                  int causal) {
  constexpr int RS = DH + 1;
  constexpr int SS = kBK + 1;
  constexpr int CPT = DH / 16;  // dK and dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * RS;
  float* Qs = Vs + kBK * RS;
  float* dOs = Qs + kBQ * RS;
  float* Ps = dOs + kBQ * RS;
  float* dSs = Ps + kBQ * SS;
  float* lse_s = dSs + kBQ * SS;
  float* delta_s = lse_s + kBQ;
  float* b_s = delta_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;
  const int64_t off = row0 * DH;

  load_tile<DH>(Ks, k + off, k0, L, tid);
  load_tile<DH>(Vs, v + off, k0, L, tid);
  if (tid < kBK) {
    const int g = k0 + tid;
    b_s[tid] =
        (bias && g < L)
            ? bias[static_cast<int64_t>(blockIdx.y / n_heads) * L + g]
            : 0.f;
  }
  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // a q tile sees this k tile iff its last row >= the tile's first key
  const int nq = (L + kBQ - 1) / kBQ;
  for (int j = causal ? k0 / kBQ : 0; j < nq; ++j) {
    const int q0 = j * kBQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<DH>(Qs, q + off, q0, L, tid);
    load_tile<DH>(dOs, dout + off, q0, L, tid);
    if (tid < kBQ) {
      const int g = q0 + tid;
      lse_s[tid] = g < L ? lse[row0 + g] : 0.f;
      delta_s[tid] = g < L ? delta[row0 + g] : 0.f;
    }
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<DH>(Qs, dOs, Ks, Vs, lse_s, delta_s, b_s, q0, k0, L, scale,
                 causal, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        Ps[(ty * 4 + i) * SS + tx + 16 * jj] = p[i][jj];
        dSs[(ty * 4 + i) * SS + tx + 16 * jj] = ds[i][jj];
      }
    __syncthreads();

    // dV += P^T @ dO and dK += dS^T @ Q, for keys ty*4+i
#pragma unroll 2
    for (int rr = 0; rr < kBQ; ++rr) {
      float gv[CPT], qv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        gv[c] = dOs[rr * RS + tx + 16 * c];
        qv[c] = Qs[rr * RS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[rr * SS + ty * 4 + i];
        const float d = dSs[rr * SS + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc_v[i][c] += pv * gv[c];
          acc_k[i][c] += d * qv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
    if (gk >= L) continue;
    const int64_t at = off + static_cast<int64_t>(gk) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[at + tx + 16 * c] = acc_k[i][c];
      dv[at + tx + 16 * c] = acc_v[i][c];
    }
  }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  int64_t bh, L;
  int n_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit once (idempotent, so a
// racing second call is harmless); keeping it out of later launches lets
// them be captured in CUDA graphs.
template <typename Kernel>
int configure(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *configured = true;
  return 0;
}

template <int DH>
int launch_dq(const Args& a, float* dq) {
  const size_t bytes = dq_smem_floats<DH>() * sizeof(float);
  static bool configured = false;
  if (const int rc = configure(flash_bwd_dq<DH>, bytes, &configured)) return rc;
  const dim3 grid(static_cast<unsigned>((a.L + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.bh));
  flash_bwd_dq<DH><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, dq,
      static_cast<int>(a.L), a.n_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv(const Args& a, float* dk, float* dv) {
  const size_t bytes = dkv_smem_floats<DH>() * sizeof(float);
  static bool configured = false;
  if (const int rc = configure(flash_bwd_dkv<DH>, bytes, &configured))
    return rc;
  const dim3 grid(static_cast<unsigned>((a.L + kBK - 1) / kBK),
                  static_cast<unsigned>(a.bh));
  flash_bwd_dkv<DH><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, dk, dv,
      static_cast<int>(a.L), a.n_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias,
               int64_t bh, int64_t L, int64_t n_heads, float scale,
               int causal, void* stream) {
  return Args{static_cast<const float*>(q),     static_cast<const float*>(k),
              static_cast<const float*>(v),     static_cast<const float*>(dout),
              static_cast<const float*>(lse),   static_cast<const float*>(delta),
              static_cast<const float*>(bias),  bh,
              L,                                static_cast<int>(n_heads),
              scale,                            causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, k, v, dout, dq [bh, L, dh] f32; lse, delta [bh, L] f32; bias null or
// [bh / n_heads, L] f32; all contiguous; dh in {16, 32, 64, 128}. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// width the kernel does not take).
extern "C" int ptt_flash_attn_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* bias, void* dq, int64_t bh,
                                     int64_t L, int64_t dh, int64_t n_heads,
                                     float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (n_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  float* out = static_cast<float*>(dq);
  switch (dh) {
    case 16: return launch_dq<16>(a, out);
    case 32: return launch_dq<32>(a, out);
    case 64: return launch_dq<64>(a, out);
    case 128: return launch_dq<128>(a, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As ptt_flash_attn_bwd_dq, with outputs dk, dv [bh, L, dh] f32.
extern "C" int ptt_flash_attn_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dk, void* dv,
                                      int64_t bh, int64_t L, int64_t dh,
                                      int64_t n_heads, float scale, int causal,
                                      void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (n_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  float* outk = static_cast<float*>(dk);
  float* outv = static_cast<float*>(dv);
  switch (dh) {
    case 16: return launch_dkv<16>(a, outk, outv);
    case 32: return launch_dkv<32>(a, outk, outv);
    case 64: return launch_dkv<64>(a, outk, outv);
    case 128: return launch_dkv<128>(a, outk, outv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
