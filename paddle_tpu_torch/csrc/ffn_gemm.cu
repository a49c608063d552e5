// FFN tail forward, f32 in and out:
//   pre1 = x @ W1 + b1                  (written when asked for)
//   h    = 0.5 · pre1 · erfc(-pre1 / sqrt(2))
//   y    = (h @ W2 + b2) · mask         (mask optional)
// Row-major operands in the JAX layout (y = x @ W): x [M, d_in], W1 [d_in,
// d_ff], W2 [d_ff, d_out], biases [N], mask and y [M, d_out].
//
// Replaces paddle_tpu/ops/ffn_ops.py `_ffn_fwd_pallas` (kernel body
// `_ffn_fwd_kernel`). The TPU kernel keeps both weight panels in VMEM and
// runs a row block through both matmuls without h leaving the core. Here the
// wrapper (ops/ffn_ops.py `_plan`) picks one of two routes by the row count
// M alone, so that a row's bits depend only on that row and on M, and both
// routes sum in a fixed order (no float atomics): the decode engine's
// concurrent = sequential contract is bitwise.
//
// Skinny route (M <= 8, the decode step's M = slots; the limit is measured,
// see ops/ffn_ops.py, and the kernel takes up to 32). Bound by bytes: the
// 8.4 MB of weights at d 512 / d_ff 2048 are read for 33 MFLOP. As on the
// TPU, h never leaves the chip: each block owns a 16-column slice of d_ff,
// computes h[:, slice] = gelu(x @ W1[:, slice] + b1[slice]) for all rows
// (x sits in shared memory), multiplies it by W2[slice, :] (prefetched into
// shared memory by cp.async while the first product runs) and writes a
// partial [M, d_out] to a workspace; a second small launch sums the partials
// in slice order and adds b2 and the mask. 128 slices at d_ff 2048 and 192
// at 3072 cover the 132 SMs; weights stream as 16-byte loads. CUDA-core FMAs
// are enough there.
//
// Tile route (larger M: prefill, training, BERT). Bound by operations. Each
// product is a tensor-core GEMM with the f32-accurate 3xTF32 split: a = big
// + small with big = a cut to tf32 and small = a - big (see split_tf32), and
// a·b ~ small_a·big_b + big_a·small_b + big_a·big_b, accumulated in f32
// (the small cross terms first; each 32-deep tile in a fresh fragment, added
// to the running sum with a rounded FADD, because the tensor cores' own
// accumulation truncates and its bias would grow with K). One TF32 pass
// keeps 10 mantissa bits, which at K 512-3072 misses the kernels' 1e-4
// tolerance; three passes keep f32 accuracy at an effective 165 TFLOP/s, 2.5x the 67 TFLOP/s SIMT peak. The
// products are `mma.sync.aligned.m16n8k8` with .tf32 operands: their
// fragments come from registers, so W's row-major [K, N] layout needs no
// transpose. `wgmma` with tf32 wants both operands K-major in shared memory
// and W is N-major, so it waits for a later step (a transposing TMA load or
// a stored transposed copy of the weights). Tiles stream through a 3-stage
// cp.async ring: 64 x 128 blocks of 8 warps (32 x 32 each, 126 registers,
// two blocks an SM) where they fill the card, else 64 x 64 blocks of 4
// warps, with a deterministic
// split-K (partials summed in split order by the second launch, which then
// runs the epilogue) where even those leave SMs idle. The epilogues (bias +
// erf-GELU writing h and pre1, or bias + mask) run on the accumulators.
// Ragged M, N and K edges load as zeros and are never stored; where a width
// is not a multiple of 4 (or a pointer is not 16-byte aligned) the copies
// are 4-byte instead of 16-byte, a template choice inside the same kernels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kSmemMax = 232448;  // the opt-in limit of one block on sm_90

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * erfcf(-v * 0.70710678118654752440f);
}

using namespace ptt;

// ---------------------------------------------------------------- tile GEMM

constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kPadA = 4;  // A rows of 36 floats: fragment reads hit 32 banks
constexpr int kPadB = 8;  // B rows of BN + 8: likewise

template <int BM, int BN>
constexpr int gemm_smem_bytes() {
  return kStages * (BM * (kBK + kPadA) + kBK * (BN + kPadB)) * 4;
}

// C tile [BM, BN] of A [M, K] @ B [K, N] over k in [z·kchunk, (z+1)·kchunk).
// ws != null: write the raw sum to ws[z] ([splits, M, N]); else run the
// epilogue (gelu: bias, pre1, GELU; else bias and mask) into C.
template <int BM, int BN, int WM, int WN, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gemm_tf32x3(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias,
                const float* __restrict__ mask, float* __restrict__ C,
                float* __restrict__ pre1, float* __restrict__ ws, int M,
                int N, int K, int kchunk, int gelu) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int LDA = kBK + kPadA;
  constexpr int LDB = BN + kPadB;
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                            // [kStages][BM][LDA]
  float* Bs = smem + kStages * BM * LDA;       // [kStages][kBK][LDB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / (BN / WN)) * WM;
  const int wn0 = (warp % (BN / WN)) * WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nk = (kend - kbeg + kBK - 1) / kBK;

  auto load_tile = [&](int stage, int k0) {
    float* as = As + stage * BM * LDA;
    float* bs = Bs + stage * kBK * LDB;
    if (VEC) {
      // widths are multiples of 4 and kend is K or a multiple of 32, so a
      // 4-float chunk lies wholly inside or wholly outside
#pragma unroll
      for (int c = tid; c < BM * kBK / 4; c += kThreads) {
        const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
        const int gm = m0 + r, gk = k0 + kc;
        const bool in = gm < M && gk < kend;
        cp_async16(as + r * LDA + kc,
                   in ? A + static_cast<int64_t>(gm) * K + gk : A, in);
      }
#pragma unroll
      for (int c = tid; c < kBK * BN / 4; c += kThreads) {
        const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
        const int gk = k0 + r, gn = n0 + nc;
        const bool in = gk < kend && gn < N;
        cp_async16(bs + r * LDB + nc,
                   in ? B + static_cast<int64_t>(gk) * N + gn : B, in);
      }
    } else {
      for (int c = tid; c < BM * kBK; c += kThreads) {
        const int r = c / kBK, kc = c % kBK;
        const int gm = m0 + r, gk = k0 + kc;
        const bool in = gm < M && gk < kend;
        cp_async4(as + r * LDA + kc,
                  in ? A + static_cast<int64_t>(gm) * K + gk : A, in);
      }
      for (int c = tid; c < kBK * BN; c += kThreads) {
        const int r = c / BN, nc = c % BN;
        const int gk = k0 + r, gn = n0 + nc;
        const bool in = gk < kend && gn < N;
        cp_async4(bs + r * LDB + nc,
                  in ? B + static_cast<int64_t>(gk) * N + gn : B, in);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, kbeg + s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    {
      const int nxt = kt + kStages - 1;
      if (nxt < nk) load_tile(nxt % kStages, kbeg + nxt * kBK);
      cp_async_commit();
    }
    const float* as = As + (kt % kStages) * BM * LDA;
    const float* bs = Bs + (kt % kStages) * kBK * LDB;
    // the tensor cores' f32 accumulation truncates; summing each 32-deep
    // tile in a fresh fragment and adding it to acc with a rounded FADD
    // keeps that bias from growing with K
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[MT][4], asm_[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = as + (wm0 + i * 16 + g) * LDA + kk + t;
        split_tf32(p[0], ab[i][0], asm_[i][0]);
        split_tf32(p[8 * LDA], ab[i][1], asm_[i][1]);
        split_tf32(p[4], ab[i][2], asm_[i][2]);
        split_tf32(p[8 * LDA + 4], ab[i][3], asm_[i][3]);
      }
      uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = bs + (kk + t) * LDB + wn0 + j * 8 + g;
        split_tf32(p[0], bb[j][0], bsm[j][0]);
        split_tf32(p[4 * LDB], bb[j][1], bsm[j][1]);
      }
      // pass by pass, so that consecutive products are independent
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], asm_[i], bb[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bsm[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bb[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // accumulator element e of tile (i, j): row g (+8 for e >= 2), column
  // 2t (+1 for odd e)
  float* out = ws ? ws + static_cast<int64_t>(blockIdx.z) * M * N : C;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int gn = n0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (gm >= M || gn >= N) continue;
        const int64_t idx = static_cast<int64_t>(gm) * N + gn;
        float val = acc[i][j][e];
        if (!ws) {
          val += bias[gn];
          if (gelu) {
            if (pre1 != nullptr) pre1[idx] = val;
            val = gelu_erf(val);
          } else if (mask != nullptr) {
            val *= mask[idx];
          }
        }
        out[idx] = val;
      }
}

// --------------------------------------------------- partial sums, epilogue

// out[m, n] = epilogue(sum over z in order of ws[z, m, n] + bias[n]). A block
// is 8 warps over 32 columns of one row: warp w sums z = w, w + 8, ... and
// warp 0 adds the eight in order, so the order is fixed.
__global__ void __launch_bounds__(256)
    sum_partials(const float* __restrict__ ws, int S, int M, int N,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask, float* __restrict__ out,
                 float* __restrict__ pre1, int gelu) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m = blockIdx.y;
  float s = 0.f;
  if (n < N)
    for (int z = w; z < S; z += 8)
      s += ws[(static_cast<int64_t>(z) * M + m) * N + n];
  red[w][lane] = s;
  __syncthreads();
  if (w != 0 || n >= N) return;
  float v = red[0][lane];
#pragma unroll
  for (int p = 1; p < 8; ++p) v += red[p][lane];
  v += bias[n];
  const int64_t idx = static_cast<int64_t>(m) * N + n;
  if (gelu) {
    if (pre1 != nullptr) pre1[idx] = v;
    v = gelu_erf(v);
  } else if (mask != nullptr) {
    v *= mask[idx];
  }
  out[idx] = v;
}

// -------------------------------------------------------------- skinny FFN

constexpr int kSlice = 16;      // d_ff columns per block
constexpr int kSkinnyThreads = 256;

// partial[slice, m, :] = gelu(x[m] @ W1[:, slice] + b1[slice]) @ W2[slice, :]
// for rows m < M (MB >= M rows of registers; rows past M are zeros and
// never stored). Shared memory: x [MB, d_in], the W2 slice [16, ldw2], the
// per-warp sums [8, MB, 16] and h [MB, 16].
template <int MB, bool VEC>
__global__ void __launch_bounds__(kSkinnyThreads)
    ffn_skinny(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               float* __restrict__ pre1, float* __restrict__ ws, int M,
               int d_in, int d_ff, int d_out) {
  extern __shared__ __align__(16) float smem[];
  const int ldw2 = (d_out + 3) & ~3;
  float* xs = smem;                        // [MB][d_in]
  float* w2s = xs + MB * ((d_in + 3) & ~3);  // [kSlice][ldw2], 16-aligned
  float* red = w2s + kSlice * ldw2;        // [8][MB][kSlice]
  float* hs = red + 8 * MB * kSlice;       // [MB][kSlice]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kSlice;

  // the W2 slice streams in while the first product runs
  if (VEC) {
    for (int c = tid; c < kSlice * ldw2 / 4; c += kSkinnyThreads) {
      const int r = c / (ldw2 / 4), nc = (c % (ldw2 / 4)) * 4;
      const bool in = f0 + r < d_ff && nc < d_out;
      cp_async16(w2s + r * ldw2 + nc,
                 in ? w2 + static_cast<int64_t>(f0 + r) * d_out + nc : w2, in);
    }
  } else {
    for (int c = tid; c < kSlice * ldw2; c += kSkinnyThreads) {
      const int r = c / ldw2, nc = c % ldw2;
      const bool in = f0 + r < d_ff && nc < d_out;
      cp_async4(w2s + r * ldw2 + nc,
                in ? w2 + static_cast<int64_t>(f0 + r) * d_out + nc : w2, in);
    }
  }
  cp_async_commit();
  for (int e = tid; e < MB * d_in; e += kSkinnyThreads) {
    const int m = e / d_in;
    xs[e] = m < M ? x[static_cast<int64_t>(m) * d_in + e % d_in] : 0.f;
  }
  __syncthreads();

  // first product: thread (k group kg, column quad c4) sums k = kg, kg + 64,
  // ... for columns f0 + 4·c4 .. + 3 of every row
  const int c4 = tid & 3, kg = tid >> 2;
  const int fc = f0 + 4 * c4;
  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll 2
  for (int k = kg; k < d_in; k += kSkinnyThreads / 4) {
    float wv[4];
    const float* wp = w1 + static_cast<int64_t>(k) * d_ff + fc;
    if (VEC) {
      // d_ff is a multiple of 4: the quad lies wholly inside or outside
      const float4 q4 = fc < d_ff ? __ldg(reinterpret_cast<const float4*>(wp))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      wv[0] = q4.x; wv[1] = q4.y; wv[2] = q4.z; wv[3] = q4.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = fc + c < d_ff ? __ldg(wp + c) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float xv = xs[m * d_in + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] += xv * wv[c];
    }
  }
  // lanes c4, c4 + 4, ..., c4 + 28 of a warp hold one column quad: fold
  // them in a fixed order, then the eight warps through shared memory
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * MB + m) * kSlice + 4 * lane + c] = acc[m][c];
  }
  __syncthreads();
  for (int e = tid; e < MB * kSlice; e += kSkinnyThreads) {
    const int m = e / kSlice, f = e % kSlice;
    float v = red[m * kSlice + f];
#pragma unroll
    for (int w = 1; w < 8; ++w) v += red[(w * MB + m) * kSlice + f];
    float h = 0.f;
    if (f0 + f < d_ff) {
      v += b1[f0 + f];
      if (m < M && pre1 != nullptr)
        pre1[static_cast<int64_t>(m) * d_ff + f0 + f] = v;
      h = gelu_erf(v);
    }
    hs[m * kSlice + f] = h;
  }
  cp_async_wait<0>();
  __syncthreads();

  // second product: thread owns output columns 4·q .. 4·q + 3
  float* part = ws + static_cast<int64_t>(blockIdx.x) * M * d_out;
  for (int q = tid; q < ldw2 / 4; q += kSkinnyThreads) {
    float o[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[m][c] = 0.f;
    // a rolled loop: h's MB x 16 values are not all held in registers
#pragma unroll 2
    for (int f = 0; f < kSlice; ++f) {
      const float4 wq = *reinterpret_cast<const float4*>(w2s + f * ldw2 +
                                                          4 * q);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float hv = hs[m * kSlice + f];
        o[m][0] += hv * wq.x;
        o[m][1] += hv * wq.y;
        o[m][2] += hv * wq.z;
        o[m][3] += hv * wq.w;
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if (m >= M) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * q + c < d_out)
          part[static_cast<int64_t>(m) * d_out + 4 * q + c] = o[m][c];
    }
  }
}

// ----------------------------------------------------------------- launch

// raise a kernel's dynamic shared-memory limit once (idempotent, so a
// racing second call is harmless); keeping it out of later launches lets
// them be captured in CUDA graphs
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int BM, int BN, int WM, int WN, bool VEC>
int launch_gemm(const float* a, const float* b, const float* bias,
                const float* mask, float* c, float* pre1, float* ws, int M,
                int N, int K, int splits, int kchunk, int gelu,
                cudaStream_t s) {
  static bool done = false;
  auto kernel = gemm_tf32x3<BM, BN, WM, WN, VEC>;
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  constexpr int threads = (BM / WM) * (BN / WN) * 32;
  kernel<<<grid, threads, gemm_smem_bytes<BM, BN>(), s>>>(
      a, b, bias, mask, c, pre1, splits > 1 ? ws : nullptr, M, N, K, kchunk,
      gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  sum_partials<<<dim3((N + 31) / 32, M), 256, 0, s>>>(ws, splits, M, N, bias,
                                                      mask, c, pre1, gelu);
  return static_cast<int>(cudaGetLastError());
}

template <int MB, bool VEC>
int launch_skinny(const float* x, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* mask,
                  float* y, float* pre1, float* ws, int M, int d_in,
                  int d_ff, int d_out, cudaStream_t s) {
  static bool done = false;
  auto kernel = ffn_skinny<MB, VEC>;
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (d_ff + kSlice - 1) / kSlice;
  const int ldw2 = (d_out + 3) & ~3;
  const size_t bytes =
      (static_cast<size_t>(MB) * ((d_in + 3) & ~3) + kSlice * ldw2 +
       9 * MB * kSlice) * 4;
  if (bytes > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<slices, kSkinnyThreads, bytes, s>>>(x, w1, b1, w2, pre1, ws, M,
                                               d_in, d_ff, d_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<dim3((d_out + 31) / 32, M), 256, 0, s>>>(
      ws, slices, M, d_out, b2, mask, y, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One GEMM of the tile route: c [M, N] = epilogue(a [M, K] @ b [K, N]),
// bias [N], mask [M, N] or null, pre1 [M, N] or null (gelu launches only),
// all f32 and contiguous. gelu != 0 selects the bias + erf-GELU epilogue,
// else bias (+ mask). tile 1: 64 x 128 blocks, tile 0: 64 x 64. splits > 1
// splits K into chunks of kchunk (a multiple of 32) and needs ws [splits, M,
// N]. Returns cudaGetLastError() after the launches.
extern "C" int ptt_ffn_gemm(const void* a, const void* b, const void* bias,
                            const void* mask, void* c, void* pre1, void* ws,
                            int64_t M, int64_t N, int64_t K, int gelu,
                            int tile, int splits, int64_t kchunk,
                            void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > INT32_MAX / 2 || N > 65535 * 64 || K > INT32_MAX / 2 ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
      kchunk <= 0 || kchunk % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const float* biasp = static_cast<const float*>(bias);
  const float* maskp = static_cast<const float*>(mask);
  float* cp = static_cast<float*>(c);
  float* pp = static_cast<float*>(pre1);
  float* wp = static_cast<float*>(ws);
  const int m = static_cast<int>(M), n = static_cast<int>(N),
            k = static_cast<int>(K), kc = static_cast<int>(kchunk);
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b);
  if (tile == 1)
    return vec ? launch_gemm<64, 128, 32, 32, true>(ap, bp, biasp, maskp, cp,
                                                     pp, wp, m, n, k, splits,
                                                     kc, gelu, s)
               : launch_gemm<64, 128, 32, 32, false>(ap, bp, biasp, maskp,
                                                      cp, pp, wp, m, n, k,
                                                      splits, kc, gelu, s);
  return vec ? launch_gemm<64, 64, 32, 32, true>(ap, bp, biasp, maskp, cp, pp,
                                                 wp, m, n, k, splits, kc,
                                                 gelu, s)
             : launch_gemm<64, 64, 32, 32, false>(ap, bp, biasp, maskp, cp, pp,
                                                  wp, m, n, k, splits, kc,
                                                  gelu, s);
}

// The skinny route, M <= 32: y [M, d_out] and pre1 [M, d_ff] (or null) from
// x [M, d_in], w1 [d_in, d_ff], b1 [d_ff], w2 [d_ff, d_out], b2 [d_out],
// mask [M, d_out] or null, with ws [ceil(d_ff / 16), M, d_out] for the
// partials. Two launches. Returns cudaGetLastError() after them
// (cudaErrorInvalidValue for M > 32 or widths whose x and W2 slice overflow
// shared memory).
extern "C" int ptt_ffn_skinny(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2,
                              const void* mask, void* y, void* pre1, void* ws,
                              int64_t M, int64_t d_in, int64_t d_ff,
                              int64_t d_out, void* stream) {
  if (M <= 0 || d_out <= 0) return 0;
  if (M > 32 || d_in <= 0 || d_ff <= 0 || d_in > 65536 || d_out > 65536 ||
      d_ff > 65535 * kSlice)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* w1p = static_cast<const float*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const float* w2p = static_cast<const float*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  const float* mp = static_cast<const float*>(mask);
  float* yp = static_cast<float*>(y);
  float* pp = static_cast<float*>(pre1);
  float* wp = static_cast<float*>(ws);
  const int m = static_cast<int>(M), di = static_cast<int>(d_in),
            df = static_cast<int>(d_ff), dn = static_cast<int>(d_out);
  const bool vec = d_ff % 4 == 0 && d_out % 4 == 0 && aligned16(w1) &&
                   aligned16(w2);
#define PTT_SKINNY(MB)                                                      \
  (vec ? launch_skinny<MB, true>(xp, w1p, b1p, w2p, b2p, mp, yp, pp, wp, m, \
                                 di, df, dn, s)                             \
       : launch_skinny<MB, false>(xp, w1p, b1p, w2p, b2p, mp, yp, pp, wp, m, \
                                  di, df, dn, s))
  if (M <= 8) return PTT_SKINNY(8);
  if (M <= 16) return PTT_SKINNY(16);
  return PTT_SKINNY(32);
#undef PTT_SKINNY
}
