// Flash attention forward (FlashAttention-2 style online softmax), f32:
//   O[b, i, :] = sum_j softmax_j(scale · q_i·k_j  masked) · v_j
//   LSE[b, i]  = m_i + log(l_i)
// over q, k, v [BH, L, DH], with an optional causal mask (key j > query i is
// dropped) and an optional per-key bias [B, L] added to the scaled scores
// (row b of the [BH, ...] operands reads bias row b / n_heads). Masked
// entries, and keys whose bias is -1e8 or lower (the -1e9 padding
// convention), get exactly zero probability, by a select and not by the
// exponential's underflow: a row whose keys are all dropped ends with l = 0,
// O = 0 and LSE = m + log(1e-30).
//
// Replaces paddle_tpu/ops/attention_ops.py `_flash_fwd_pallas` (kernel body
// `_fwd_kernel`), with and without `has_bias`. On the TPU the grid is
// (bh, q_block, k_block) with the k axis sequential, and the running max m,
// the denominator l and the accumulator carry across k blocks in VMEM
// scratch.
//
// Bound on an H100: operations. At the prefill shapes (L up to 256, DH 64),
// the training shape (BH 128, L 512) and BERT's (BH 1536, L 128)
// the scores cost 4·DH flops per (query, visible key) pair against 16·DH
// bytes per query row of q, k, v and o, so the f32 flops outweigh the bytes
// (see chip_smoke.py's bound_ms). This first version runs on the f32 CUDA
// cores; tensor cores (TF32 or bf16 wgmma) are later work.
//
// Design: one block of 256 threads per (bh, 64-row q tile). The TPU's
// sequential k axis becomes a loop inside the block over 64-row k tiles, up
// to the diagonal when causal (tiles wholly above it are never loaded). The
// Q tile, the current K and V tiles and the 64x64 score tile sit in shared
// memory (67 KB at DH 64, so the launch raises the dynamic shared-memory
// limit); m, l and the rescale factor of each row, and the bias of the
// current key tile, sit in shared memory too,
// and each thread keeps a 4 x (DH/16) slice of the output accumulator in
// registers. Q and K rows are padded by one float so that the threads of a
// warp read distinct banks. Rows and keys past L (prompt buckets need not be
// multiples of 64) load as zeros and are masked, so any L works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DH>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (DH + 1) + kBK * (DH + 1) + kBK * DH +
         kBQ * (kBK + 1) + 3 * kBQ + kBK;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ o, float* __restrict__ lse, int L,
              int n_heads, float scale, int causal) {
  constexpr int QS = DH + 1;   // padded Q/K row stride
  constexpr int SS = kBK + 1;  // padded score row stride
  constexpr int CPT = DH / 16; // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ss = Vs + kBK * DH;
  float* m_s = Ss + kBQ * SS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  float* b_s = a_s + kBQ;  // bias of the current key tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * L * DH;
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;
  const float* brow =
      bias ? bias + static_cast<int64_t>(blockIdx.y / n_heads) * L : nullptr;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int rr = e / DH, c = e % DH, g = q0 + rr;
    Qs[rr * QS + c] = g < L ? qb[static_cast<int64_t>(g) * DH + c] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
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
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int rr = e / DH, c = e % DH, g = k0 + rr;
      const bool in = g < L;
      const int64_t gi = static_cast<int64_t>(g) * DH + c;
      Ks[rr * QS + c] = in ? kb[gi] : 0.f;
      Vs[rr * DH + c] = in ? vb[gi] : 0.f;
    }
    if (tid < kBK) b_s[tid] = (brow && k0 + tid < L) ? brow[k0 + tid] : 0.f;
    __syncthreads();

    // scores for rows ty*4+i, keys tx+16*jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] += qv[i] * kv[jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty * 4 + i, gr = q0 + rr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = tx + 16 * jj, gc = k0 + cc;
        const bool keep = gc < L && (!causal || gc <= gr);
        Ss[rr * SS + cc] = keep ? sc[i][jj] * scale + b_s[cc] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, each lane 2 keys of a row
    for (int rr = warp * 8; rr < warp * 8 + 8; ++rr) {
      const int gr = q0 + rr;
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      const bool ok0 =
          c0 < L && (!causal || c0 <= gr) && b_s[lane] > kBiasDrop;
      const bool ok1 =
          c1 < L && (!causal || c1 <= gr) && b_s[lane + 32] > kBiasDrop;
      const float s0 = Ss[rr * SS + lane];
      const float s1 = Ss[rr * SS + lane + 32];
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      // a fully masked row slice has m_new == -1e30 and exp(0) == 1, and a
      // row of dropped keys has m_new ~ -1e9 with exp(s - m_new) ~ 1: the
      // select, not the exponential, is what makes such a key exactly 0
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      Ss[rr * SS + lane] = p0;
      Ss[rr * SS + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[rr] = alpha;
        l_s[rr] = alpha * l_s[rr] + psum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty * 4 + i) * SS + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i, gr = q0 + rr;
    if (gr >= L) continue;
    const float l = fmaxf(l_s[rr], 1e-30f);
    float* orow = o + off + static_cast<int64_t>(gr) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] / l;
    if (tx == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + gr] = m_s[rr] + logf(l);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int64_t bh, int64_t L, int n_heads,
           float scale, int causal, cudaStream_t stream) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  // once per head width (idempotent, so a racing second call is harmless);
  // keeping it out of later launches lets them be captured in CUDA graphs
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((L + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  flash_fwd<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, o, lse, static_cast<int>(L), n_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o [bh, L, dh] f32 and lse [bh, L] f32, all contiguous; dh in
// {16, 32, 64, 128}; bias null or [bh / n_heads, L] f32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// width the kernel does not take).
extern "C" int ptt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse,
                                  int64_t bh, int64_t L, int64_t dh,
                                  int64_t n_heads, float scale, int causal,
                                  void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (n_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  const float* bp = static_cast<const float*>(bias);
  const int nh = static_cast<int>(n_heads);
  switch (dh) {
    case 16:
      return launch<16>(qp, kp, vp, bp, op, lp, bh, L, nh, scale, causal, s);
    case 32:
      return launch<32>(qp, kp, vp, bp, op, lp, bh, L, nh, scale, causal, s);
    case 64:
      return launch<64>(qp, kp, vp, bp, op, lp, bh, L, nh, scale, causal, s);
    case 128:
      return launch<128>(qp, kp, vp, bp, op, lp, bh, L, nh, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
