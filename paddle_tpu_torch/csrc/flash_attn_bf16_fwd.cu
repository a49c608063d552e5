// Flash attention forward (FlashAttention-2 online softmax) on bf16 q, k, v
// with float32 accumulation, the bf16 form of flash_attn_fwd.cu:
//   S = scale · Q K^T (+ bias, masked)      float32
//   m, l, LSE = m + log(l)                  float32, online over key tiles
//   O = (sum_j bf16(exp(S - m)) · V) / l    bf16 out
// over q, k, v, o [BH, L, DH] bf16 and LSE [BH, L] float32, with an optional
// causal mask and an optional per-key bias [B, L] float32 (row b of the
// [BH, ...] operands reads bias row b / n_heads). Masked entries, and keys
// whose bias is -1e8 or lower, get exactly zero probability by a select: a
// row whose keys are all dropped ends with l = 0, O = 0 and LSE = m +
// log(1e-30).
//
// Replaces paddle_tpu/ops/attention_ops.py `_flash_fwd_pallas` (kernel body
// `_fwd_kernel`, :77) as the JAX package runs it under bf16 AMP: the products
// take the bf16 operands with float32 accumulation (`preferred_element_type`,
// :100, :125), P is cast to V's bf16 before P·V (:125), the running max, sum
// and LSE stay float32, and O is written in the input dtype (:168).
//
// Bound on an H100: bytes at the shapes of the models (L 128 to 512, DH 64):
// a query row reads 3·DH bf16 of q, k, v (k and v once per head) and writes
// DH bf16 and one float32, against 4·DH flops per visible (query, key) pair
// at 989 TFLOP/s: at L 512 causal and DH 64 a row's 516 bytes take 0.15 ns
// and its 256 pairs' 66 kflop 0.07 ns. What it does about it: each q, k, v
// element is read from memory once per block that needs it (K and V tiles
// double-buffered by cp.async into shared memory), and the scores never
// leave registers.
//
// Design (the f32 kernel's, on the bf16 tile). Each warp owns 16 query
// rows; a block has 1, 2 or 4 warps, the most that still gives >= 132
// blocks. Key tiles of 64 rows of K and V double-buffer through cp.async;
// Q's rows are staged in shared memory once and read as A fragments by
// ldmatrix. S = Q·K^T is `mma.sync.m16n8k16` with K's rows as B (ldmatrix),
// landing in registers in the accumulator layout; the online softmax runs
// there, a row's max and sum over the four lanes that share it by quad
// shuffles. P, rounded to bf16, is the A operand of P·V as it stands (two
// neighbouring 8-key accumulator tiles are one 16-deep A fragment), and V
// is read N-major by ldmatrix.trans. Causal tiles wholly above the
// diagonal are never loaded; rows and keys past L load as zeros and are
// masked, so any L works. One owner per output and a fixed order: two
// calls give the same bits. Blocks are numbered (bh, query tile) on
// gridDim.x alone, so batch × heads may exceed 65535.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace ptt;

constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr int kSms = 132;

// [NW·16][LD] Q rows, [2][kBK][LD] K and V tiles (bf16), [2][kBK] bias
template <int DH, int NW>
constexpr int smem_bytes() {
  return (NW * 16 + 4 * kBK) * kLdB<DH> * 2 + 2 * kBK * 4;
}

template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ o, float* __restrict__ lse, int L,
                   int n_heads, float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int LD = kLdB<DH>;
  constexpr int KS = DH / 16;  // k-steps of Q·K^T
  constexpr int NO = DH / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [NW·16][LD]
  bf16* Ks = Qs + NW * 16 * LD;                  // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kBK * LD);  // [2][kBK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * NW * 16;
  const int64_t off = bh * L * DH;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const float* brow = bias ? bias + (bh / n_heads) * L : nullptr;
  const int wr = warp * 16;        // the warp's first row in Qs
  const int row0 = q0 + wr + g;    // this thread's rows: row0, row0 + 8

  const int last_row = min(q0 + NW * 16, L) - 1;
  const int nk = causal ? last_row / kBK + 1 : (L + kBK - 1) / kBK;

  auto load_tile = [&](int buf, int j) {
    const int k0 = j * kBK;
    load_rows_bf16<DH, kBK, kThreads>(Ks + buf * kBK * LD, kb, k0, L, tid);
    load_rows_bf16<DH, kBK, kThreads>(Vs + buf * kBK * LD, vb, k0, L, tid);
    if (brow != nullptr)
      load_vec_f32<kThreads>(Bs + buf * kBK, brow, k0, kBK, L, tid);
  };

  load_rows_bf16<DH, NW * 16, kThreads>(Qs, q + off, q0, L, tid);
  load_tile(0, 0);
  cp_async_commit();

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int warp_last = min(q0 + wr + 15, L - 1);

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {
      load_tile(buf ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q) is in for every thread
    const int k0 = j * kBK;
    if (!causal || k0 <= warp_last) {  // else above this warp's diagonal
      const bf16* ks = Ks + buf * kBK * LD;
      const bf16* vs = Vs + buf * kBK * LD;
      const float* bs = Bs + buf * kBK;

      // S = Q K^T: sacc[n] holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
      float sacc[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        load_a<DH>(a, Qs, wr, 16 * s, lane);
#pragma unroll
        for (int n = 0; n < kBK / 8; n += 2) {
          uint32_t b[4];
          load_b_rows<DH>(b, ks, 8 * n, 16 * s, lane);
          mma_bf16(sacc[n], a, b[0], b[1]);
          mma_bf16(sacc[n + 1], a, b[2], b[3]);
        }
      }

      // scale, bias and mask; the tile's row max
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * n + 2 * t + (e & 1), key = k0 + kc;
          const int row = row0 + (e >> 1) * 8;
          const bool vis = key < L && (!causal || key <= row);
          const float bv = brow ? bs[kc] : 0.f;
          const float sv = vis ? sacc[n][e] * scale + bv : kNegInf;
          sacc[n][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_r[h], quad_max(mx[h]));
        alpha[h] = expf(m_r[h] - m_new);
        m_r[h] = m_new;
      }
      // the select, not the exponential, makes a masked or dropped key
      // exactly 0 (a fully masked slice has m == -1e30 and exp(0) == 1)
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * n + 2 * t + (e & 1), key = k0 + kc;
          const int row = row0 + (e >> 1) * 8;
          const bool keep = key < L && (!causal || key <= row) &&
                            (!brow || bs[kc] > kBiasDrop);
          const float p = keep ? expf(sacc[n][e] - m_r[e >> 1]) : 0.f;
          sacc[n][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_r[h] = alpha[h] * l_r[h] + quad_sum(psum[h]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];

      // O += bf16(P) V over the tile's four 16-key steps
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        uint32_t a[4];
        pack_a(a, sacc, s);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          load_b_cols<DH>(b, vs, 16 * s, 8 * n, lane);
          mma_bf16(oacc[n], a, b[0], b[1]);
          mma_bf16(oacc[n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= L) continue;
    const float l = fmaxf(l_r[h], 1e-30f);
    bf16* orow = o + off + static_cast<int64_t>(row) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(oacc[n][2 * h] / l, oacc[n][2 * h + 1] / l);
    if (t == 0) lse[bh * L + row] = m_r[h] + logf(l);
  }
}

template <int DH, int NW>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias,
           bf16* o, float* lse, int64_t bh, int64_t L, int n_heads,
           float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, NW>();
  // once per instantiation (idempotent, so a racing second call is
  // harmless); keeping it out of later launches lets them be captured in
  // CUDA graphs
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<DH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t blocks = bh * ((L + NW * 16 - 1) / (NW * 16));
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_bf16<DH, NW><<<static_cast<unsigned>(blocks), NW * 32, bytes,
                           stream>>>(q, k, v, bias, o, lse,
                                     static_cast<int>(L), n_heads, scale,
                                     causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_rows(const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* o, float* lse, int64_t bh, int64_t L,
                int n_heads, float scale, int causal, cudaStream_t s) {
  // 64 query rows a block where that fills the card, else 32, else 16
  if (bh * ((L + 63) / 64) >= kSms)
    return launch<DH, 4>(q, k, v, bias, o, lse, bh, L, n_heads, scale,
                         causal, s);
  if (bh * ((L + 31) / 32) >= kSms)
    return launch<DH, 2>(q, k, v, bias, o, lse, bh, L, n_heads, scale,
                         causal, s);
  return launch<DH, 1>(q, k, v, bias, o, lse, bh, L, n_heads, scale, causal,
                       s);
}

}  // namespace

// q, k, v, o [bh, L, dh] bf16 and lse [bh, L] float32, all contiguous and
// q, k, v 16-byte aligned; dh in {16, 32, 64, 128}; bias null or
// [bh / n_heads, L] float32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head width the kernel does not take).
extern "C" int ptt_flash_attn_bf16_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int64_t bh,
                                       int64_t L, int64_t dh, int64_t n_heads,
                                       float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (n_heads <= 0 || L > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  const float* bp = static_cast<const float*>(bias);
  const int nh = static_cast<int>(n_heads);
  switch (dh) {
    case 16:
      return launch_rows<16>(qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 32:
      return launch_rows<32>(qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 64:
      return launch_rows<64>(qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 128:
      return launch_rows<128>(qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                              causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
