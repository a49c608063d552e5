// Flash attention forward (FlashAttention-2 online softmax), f32 in and out:
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
// scratch; here that axis is a loop inside the block.
//
// Bound on an H100: operations. The scores and P·V cost 4·DH flops per
// visible (query, key) pair against 16·DH bytes per query row of q, k, v and
// o. Both products run on the tensor cores with the f32-accurate 3xTF32
// split: a = big + small, big = a cut to tf32, small = a - big (split_tf32),
// and a·b ~ small_a·big_b + big_a·small_b + big_a·big_b accumulated in f32,
// an effective 165 TFLOP/s (495 / 3) against 67 for f32 on the CUDA cores;
// one TF32 pass (10 mantissa bits) would miss the kernels' 1e-4 tolerance.
// The products are `mma.sync.aligned.m16n8k8` with .tf32 operands. `wgmma`
// with tf32 needs both operands K-major in shared memory; V (the B operand
// of P·V) is N-major there, so `wgmma` waits for a later step.
//
// Design: each warp owns 16 query rows; a block has 1, 2 or 4 warps (16, 32
// or 64 query rows), the most that still gives BH·ceil(L/rows) >= 132
// blocks, so the prefill's small grids (BH 8) fill the card. The Q
// fragments are split once, and held in registers (DH <= 64) or in shared
// memory in fragment order (DH 128, where registers run short). Key tiles
// of 64 rows of K and V double-buffer through cp.async, the next tile
// loading while this one computes; the key tile stays 64 whatever the query
// tile, so a row's sequence of rescalings does not depend on that choice.
// At DH 256 a block owns one 128-wide half of O's columns (kOutCols,
// tf32_mma.cuh; two blocks a query tile, one launch): it computes the
// scores over all 256 columns, loads only its half of V and accumulates
// only its half of O, so O and the P·V fragment keep DH 128's registers;
// half 0 writes LSE. The score products are done twice, once a half: 6·DH
// flops a visible pair in place of 4·DH. Key tiles are 32 rows there, and Q
// stays in shared memory as f32 rows split as each k-step reads them (its
// split fragments, twice the bytes, with two 256-wide K tiles would pass
// the 227 KB a block may have).
// S = Q·K^T lands in registers in the accumulator layout (thread (g, t) of
// a quad row holds rows g and g + 8, keys 2t and 2t + 1 of each 8-key
// block); the online softmax runs there, a row's max and sum taken over the
// four lanes that share it by shuffles, with no shared score tile and no
// block-wide barrier between phases. For tf32 the m16n8k8 accumulator
// layout is not the A-operand layout (A wants keys t and t + 4), so P is
// moved into A fragments by shuffles within each quad. Each key tile's P·V
// lands in a fresh fragment and joins O by rounded FMAs (O = alpha·O +
// P·V): the tensor cores' f32 accumulation truncates, and one chain of it
// over the whole key loop would bias O as L grows. Causal tiles wholly
// above the diagonal are never loaded; rows and keys past L load as zeros
// and are masked, so any L works. Each output has one owner and a fixed
// summation order: two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// keys a tile: 64, or 32 at DH 256 (shared memory)
template <int DH>
constexpr int kBK = DH > 128 ? 32 : 64;
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr int kSms = 132;

using namespace ptt;

// row strides: K rows of DH + 4 floats and V rows of kOutCols + 8 put the
// eight rows of a B fragment's reads in distinct banks; then Q's split
// fragments (DH 128) or its f32 rows of DH + 4 (DH 256)
template <int DH, int NW>
constexpr int smem_bytes() {
  return (2 * kBK<DH> * ((DH + 4) + (kOutCols<DH> + 8)) + 2 * kBK<DH>) * 4 +
         (DH > 64 && DH <= 128 ? NW * (DH / 8) * 32 * 32 : 0) +
         (DH > 128 ? NW * 16 * (DH + 4) * 4 : 0);
}

template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_tc(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int L,
                 int n_heads, float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int BK = kBK<DH>;
  constexpr int DO = kOutCols<DH>;  // O's columns this block owns
  constexpr int LDK = DH + 4, LDV = DO + 8, LDQ = DH + 4;
  constexpr int KS = DH / 8;       // k-steps of Q·K^T
  constexpr int NO = DO / 8;       // n-tiles of P·V
  constexpr bool kQRegs = DH <= 64;
  constexpr bool kQRows = DH > 128;  // else split fragments in smem
  constexpr int NG = NO < 4 ? NO : 4;  // output column blocks per mma group
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // [2][BK][LDK]
  float* Vs = Ks + 2 * BK * LDK;         // [2][BK][LDV], the block's columns
  float* Bs = Vs + 2 * BK * LDV;         // [2][BK] bias of the key tile
  uint4* Qf = reinterpret_cast<uint4*>(Bs + 2 * BK);  // DH 128 only
  float* Qs = Bs + 2 * BK;               // [NW·16][LDQ], DH 256 only

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, query tile), half): the halves of a tile are
  // neighbours on the grid and share its Q, K and V in L2
  const int half = blockIdx.x % kHalves<DH>;
  const unsigned blk = blockIdx.x / kHalves<DH>;
  const int col0 = half * DO;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blk / tiles;
  const int q0 = (blk % tiles) * NW * 16;
  const int64_t off = bh * L * DH;
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;
  const float* brow =
      bias ? bias + (bh / n_heads) * L : nullptr;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const int last_row = min(q0 + NW * 16, L) - 1;
  const int nk = causal ? last_row / BK + 1 : (L + BK - 1) / BK;

  auto load_tile = [&](int buf, int j) {
    const int k0 = j * BK;
    float* ks = Ks + buf * BK * LDK;
    float* vs = Vs + buf * BK * LDV;
    for (int c = tid; c < BK * DH / 4; c += kThreads) {
      const int r = c / (DH / 4), cc = (c % (DH / 4)) * 4;
      const bool in = k0 + r < L;
      const int64_t gi = static_cast<int64_t>(k0 + r) * DH + cc;
      cp_async16(ks + r * LDK + cc, in ? kb + gi : kb, in);
      // a plain `if` on a constant (nvcc's front end rejects this lambda
      // with `if constexpr` in it)
      if (DO == DH) cp_async16(vs + r * LDV + cc, in ? vb + gi : vb, in);
    }
    if (DO != DH)
      for (int c = tid; c < BK * DO / 4; c += kThreads) {
        const int r = c / (DO / 4), cc = (c % (DO / 4)) * 4;
        const bool in = k0 + r < L;
        const int64_t gi = static_cast<int64_t>(k0 + r) * DH + col0 + cc;
        cp_async16(vs + r * LDV + cc, in ? vb + gi : vb, in);
      }
    if (brow != nullptr)
      for (int c = tid; c < BK; c += kThreads) {
        const bool in = k0 + c < L;
        cp_async4(Bs + buf * BK + c, in ? brow + k0 + c : brow, in);
      }
  };

  // at DH 256 the block's Q rows, zeros past L, in the first tile's group
  if constexpr (kQRows)
    for (int c = tid; c < NW * 16 * DH / 4; c += kThreads) {
      const int r = c / (DH / 4), cc = (c % (DH / 4)) * 4;
      const bool in = q0 + r < L;
      cp_async16(Qs + r * LDQ + cc,
                 in ? qb + static_cast<int64_t>(q0 + r) * DH + cc : qb, in);
    }
  load_tile(0, 0);
  cp_async_commit();

  // Q's A fragments for k-step s: a0 (row g, col 8s + t), a1 (row g + 8),
  // a2 (col + 4), a3 (row g + 8, col + 4), split once (at DH 256 as read)
  uint32_t qr[kQRegs ? KS : 1][8];
#pragma unroll
  for (int s = 0; s < (kQRows ? 0 : KS); ++s) {
    uint32_t f[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e & 1) * 8, c = 8 * s + t + (e >> 1) * 4;
      const float val = r < L ? qb[static_cast<int64_t>(r) * DH + c] : 0.f;
      split_tf32(val, f[e], f[4 + e]);
    }
    if constexpr (kQRegs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[s][e] = f[e];
    } else {
      uint4* dst = Qf + ((warp * KS + s) * 32 + lane) * 2;
      dst[0] = make_uint4(f[0], f[1], f[2], f[3]);
      dst[1] = make_uint4(f[4], f[5], f[6], f[7]);
    }
  }

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {
      load_tile(buf ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in for every thread
    const float* ks = Ks + buf * BK * LDK;
    const float* vs = Vs + buf * BK * LDV;
    const float* bs = Bs + buf * BK;
    const int k0 = j * BK;

    // S = Q K^T: sacc[n] holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float sacc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t ab[4], as[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qr[s][e];
          as[e] = qr[s][4 + e];
        }
      } else if constexpr (kQRows) {
        const float* qp = Qs + (warp * 16 + g) * LDQ + 8 * s + t;
        split_tf32(qp[0], ab[0], as[0]);
        split_tf32(qp[8 * LDQ], ab[1], as[1]);
        split_tf32(qp[4], ab[2], as[2]);
        split_tf32(qp[8 * LDQ + 4], ab[3], as[3]);
      } else {
        const uint4* src = Qf + ((warp * KS + s) * 32 + lane) * 2;
        const uint4 b4 = src[0], s4 = src[1];
        ab[0] = b4.x; ab[1] = b4.y; ab[2] = b4.z; ab[3] = b4.w;
        as[0] = s4.x; as[1] = s4.y; as[2] = s4.z; as[3] = s4.w;
      }
#pragma unroll
      for (int n0 = 0; n0 < BK / 8; n0 += 4) {
        // B = K^T: b0 (k 8s + t, key 8n + g), b1 (k + 4); four key blocks
        // at a time
        uint32_t bb[4][2], bsm[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* kp = ks + (8 * (n0 + n) + g) * LDK + 8 * s + t;
          split_tf32(kp[0], bb[n][0], bsm[n][0]);
          split_tf32(kp[4], bb[n][1], bsm[n][1]);
        }
        mma_3xtf32<4>(sacc + n0, ab, as, bb, bsm);
      }
    }

    // scale, bias and mask; the tile's row max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
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
    // a fully masked row slice has m == -1e30 and exp(0) == 1, and a row of
    // dropped keys has m ~ -1e9 with exp(s - m) ~ 1: the select, not the
    // exponential, is what makes such a key exactly 0
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
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
    for (int h = 0; h < 2; ++h) l_r[h] = alpha[h] * l_r[h] + quad_sum(psum[h]);
    // this tile's P V in a fresh fragment, then O = alpha O + P V with
    // rounded FMAs: the tensor cores' f32 accumulation truncates, and a
    // chain of it over every key tile would bias O as L grows
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;

    // O += P V over the tile's 8 key steps. P's A fragment for key step s
    // wants keys 8s + t and 8s + t + 4; lane (g, t') holds keys 8s + 2t'
    // and + 1, so key 8s + t lives in lane (g, t / 2), element t & 1
    const int src_lo = (lane & ~3) | (t >> 1);
    const int src_hi = src_lo + 2;
    const bool odd = t & 1;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      float pa[4];
      {
        const float x0 = __shfl_sync(0xffffffffu, sacc[s][0], src_lo);
        const float x1 = __shfl_sync(0xffffffffu, sacc[s][1], src_lo);
        const float y0 = __shfl_sync(0xffffffffu, sacc[s][2], src_lo);
        const float y1 = __shfl_sync(0xffffffffu, sacc[s][3], src_lo);
        const float z0 = __shfl_sync(0xffffffffu, sacc[s][0], src_hi);
        const float z1 = __shfl_sync(0xffffffffu, sacc[s][1], src_hi);
        const float w0 = __shfl_sync(0xffffffffu, sacc[s][2], src_hi);
        const float w1 = __shfl_sync(0xffffffffu, sacc[s][3], src_hi);
        pa[0] = odd ? x1 : x0;  // row g,     key 8s + t
        pa[1] = odd ? y1 : y0;  // row g + 8, key 8s + t
        pa[2] = odd ? z1 : z0;  // row g,     key 8s + t + 4
        pa[3] = odd ? w1 : w0;  // row g + 8, key 8s + t + 4
      }
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[e], ab[e], as[e]);
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NG) {
        // B = V: b0 (key 8s + t, column 8n + g), b1 (key + 4)
        uint32_t bb[NG][2], bsm[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float* vp = vs + (8 * s + t) * LDV + 8 * (n0 + n) + g;
          split_tf32(vp[0], bb[n][0], bsm[n][0]);
          split_tf32(vp[4 * LDV], bb[n][1], bsm[n][1]);
        }
        mma_3xtf32<NG>(pv + n0, ab, as, bb, bsm);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[n][e] = fmaf(oacc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= L) continue;
    const float l = fmaxf(l_r[h], 1e-30f);
    float* orow = o + off + static_cast<int64_t>(row) * DH + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(oacc[n][2 * h] / l, oacc[n][2 * h + 1] / l);
    if (t == 0 && half == 0)
      lse[bh * L + row] = m_r[h] + logf(l);
  }
}

template <int DH, int NW>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int64_t bh, int64_t L, int n_heads,
           float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, NW>();
  // once per instantiation (idempotent, so a racing second call is
  // harmless); keeping it out of later launches lets them be captured in
  // CUDA graphs
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc<DH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // blocks numbered (bh, query tile, half) on gridDim.x alone: bh may
  // exceed the 65535 of gridDim.y
  const int64_t blocks =
      bh * ((L + NW * 16 - 1) / (NW * 16)) * kHalves<DH>;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_tc<DH, NW><<<static_cast<unsigned>(blocks), NW * 32, bytes,
                         stream>>>(
      q, k, v, bias, o, lse, static_cast<int>(L), n_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_rows(const float* q, const float* k, const float* v,
                const float* bias, float* o, float* lse, int64_t bh,
                int64_t L, int n_heads, float scale, int causal,
                cudaStream_t s) {
  // 64 query rows a block where that fills the card, else 32, else 16
  const int64_t cols = bh * kHalves<DH>;
  if (cols * ((L + 63) / 64) >= kSms)
    return launch<DH, 4>(q, k, v, bias, o, lse, bh, L, n_heads, scale,
                         causal, s);
  if (cols * ((L + 31) / 32) >= kSms)
    return launch<DH, 2>(q, k, v, bias, o, lse, bh, L, n_heads, scale,
                         causal, s);
  return launch<DH, 1>(q, k, v, bias, o, lse, bh, L, n_heads, scale, causal,
                       s);
}

}  // namespace

// q, k, v, o [bh, L, dh] f32 and lse [bh, L] f32, all contiguous and q, k,
// v 16-byte aligned; dh in {16, 32, 64, 128, 256}; bias null or
// [bh / n_heads, L] f32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head width the kernel does not take).
extern "C" int ptt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse,
                                  int64_t bh, int64_t L, int64_t dh,
                                  int64_t n_heads, float scale, int causal,
                                  void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (n_heads <= 0 || L > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
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
    case 256:
      return launch_rows<256>(qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                              causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
