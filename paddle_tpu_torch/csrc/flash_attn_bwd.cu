// Flash attention backward (the FlashAttention-2 split), f32: two kernels
// over q, k, v, dO [BH, L, DH], the forward's LSE [BH, L] and
// delta = rowsum(dO * O) [BH, L]. Both recompute, per (q tile, k tile),
//   S  = scale · Q K^T + bias
//   P  = exp(S - LSE)           (0 where masked or dropped)
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
// pallas_call (body `_bwd_dq_kernel`, :184) and its second (body
// `_bwd_dkv_kernel`, :232), with and without `has_bias`. On the TPU each is
// a grid (bh, outer tile, inner tile) whose inner axis is sequential, the
// accumulator carried across it in VMEM scratch; here that axis is a loop
// inside the block.
//
// Bound on an H100: operations. dQ does three products per visible (query,
// key) pair (6·DH flops), dK/dV four (8·DH), against 4 bytes per element of
// six [BH, L, DH] operands. Every product runs on the tensor cores in the
// f32-accurate 3xTF32 split of tf32_mma.cuh (an effective 165 TFLOP/s, 495
// / 3, against 67 for f32 on the CUDA cores), as `mma.sync.m16n8k8` with
// .tf32 operands: the forward's tile. `wgmma` with tf32 wants both operands
// K-major in shared memory, and dS·K, P^T·dO and dS^T·Q read K, dO and Q
// N-major.
//
// Design. The TPU's two-kernel split is kept, so every output element is
// summed by exactly one warp in a fixed order: no atomics, and two calls
// give the same bits.
// - dQ: each warp owns 16 query rows (a block has 1, 2 or 4 warps, the most
//   that still gives >= 132 blocks). Per key tile it computes S = Q K^T and
//   dP = dO V^T into accumulator fragments (thread (g, t) of a quad row
//   holds rows g and g + 8, keys 2t and 2t + 1 of each 8-key block), forms
//   P and dS there with the row's LSE and delta in registers, moves dS into
//   A fragments by shuffles within each quad (the forward's move of P), and
//   adds dS K with K read N-major.
// - dK/dV: each warp owns 16 keys and works in the transposed form: S^T =
//   K Q^T and dP^T = V dO^T, P^T and dS^T formed with LSE and delta indexed
//   by column (the query, from the tile's shared copy) and the two keys'
//   bias held in registers; then dV += P^T dO and dK += dS^T Q with dO and Q
//   read N-major. Nothing goes through shared memory between the products,
//   and no barrier separates them.
// - The streamed operand (K, V and the bias for dQ; Q, dO, LSE and delta for
//   dK/dV) comes in tiles, double-buffered through cp.async so that the
//   next tile loads while this one computes; causal tiles wholly above the
//   diagonal are never loaded. dQ streams 32 keys a tile, dK/dV 64 queries
//   (32 at DH 128): at DH 64 dQ's smaller tile holds it to about 170
//   registers and 70 KB, three blocks an SM, and made it faster on an H100;
//   dK/dV, at about 240 registers, gets two blocks an SM either way, and
//   the smaller tile made it slower at BERT's shape.
// - Registers are what limits a warp: split fragments of its two 16-row
//   operands would take 128 at DH 64 on top of the 128-192 that the
//   accumulators and the S and dP tiles need. So those operands stay in
//   shared memory as f32 and are split as each k-step reads them: four
//   32-bit loads and eight integer and float operations a k-step, against
//   two 16-byte loads for a pre-split copy (twice the shared-memory traffic
//   and space).
// - Instructions, not the tensor cores, are what limits the kernels: the
//   mma instructions are a small share of a tile's instructions, most of
//   the rest being the operands' split, their loads and their addresses.
//   Two choices follow.
//   Tile rows are padded to DH + 4 floats: a row-wise read (the B operand
//   of Q K^T, lanes on 8 rows and 4 columns) hits 32 distinct banks and a
//   column-wise read (the N-major B operand of dS K, lanes on 4 rows and 8
//   columns) conflicts two ways, but every address is a base plus a
//   constant; a swizzle that freed both reads cost more time on an H100 in
//   address arithmetic than the conflicts do. And P is
//   exp(S - LSE) by `__expf` (ex2.approx), whose error, under 2e-6 of P
//   for the arguments that matter, is far inside the tolerance.
// - The tensor cores' f32 accumulation truncates, so each tile's product
//   lands in a fresh fragment that joins the running sum by a rounded FADD;
//   one chain over every tile would bias dQ, dK and dV as L grows. The
//   fresh fragment spans at most 64 columns (two passes at DH 128).
// - At DH 256 a block owns one 128-wide half of one output's columns
//   (kOutCols, tf32_mma.cuh; one launch): dQ's kernel has two blocks a
//   query tile, dK/dV's four a key tile, dV's halves and dK's (a half of
//   each in one block would hold 128 accumulator registers, and spill as
//   the DH 128 instantiations do). A block computes S (and dP where it
//   needs it) over all 256 columns and accumulates its half, 64
//   registers. dQ does 10·DH flops a visible pair in place of 6·DH; dK/dV
//   16·DH in place of 8·DH (a dV block S and P^T dO, a dK block S, dP and
//   dS^T Q). The streamed tile is 16 rows there: two 256-wide tiles of
//   each streamed operand beside the block's own rows fit 227 KB at 4
//   warps.
// Rows and keys past L load as zeros and are masked, so any L works.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace ptt;

constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr int kSms = 132;

// rows of a streamed tile: keys for dQ, queries for dK/dV
template <int DH>
constexpr int kKeyTile = DH > 128 ? 16 : 32;
template <int DH>
constexpr int kQueryTile = DH > 128 ? 16 : DH > 64 ? 32 : 64;

// row stride of a tile in shared memory: lanes (g, t) reading (row 8n + g,
// column 8s + t) hit 32 distinct banks
template <int DH>
constexpr int kLD = DH + 4;

// rows [r0, r0 + ROWS) of a [L, DH] matrix into a tile of padded rows,
// zeros past L
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int L, int tid) {
  for (int c = tid; c < ROWS * DH / 4; c += THREADS) {
    const int r = c / (DH / 4), cc = (c % (DH / 4)) * 4;
    const bool in = r0 + r < L;
    cp_async16(dst + r * kLD<DH> + cc,
               in ? src + static_cast<int64_t>(r0 + r) * DH + cc : src, in);
  }
}

// n values [r0, r0 + n) of a length-L vector, zeros past L
template <int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n, int L, int tid) {
  for (int c = tid; c < n; c += THREADS) {
    const bool in = r0 + c < L;
    cp_async4(dst + c, in ? src + r0 + c : src, in);
  }
}

// acc[n] += X T^T over DH, for the warp's 16 rows of X (rows xr.. of a
// [.][kLD] tile) and NT 8-row blocks of T: X's A fragment for
// k-step s (rows g, g + 8; columns 8s + t, 8s + t + 4) is split as it is
// read, T's B fragments (row 8n + g; columns 8s + t, + 4) likewise
template <int DH, int NT>
__device__ __forceinline__ void mma_xt(float (*acc)[4], const float* xs,
                                       int xr, const float* ts, int g,
                                       int t) {
  constexpr int NG = NT < 4 ? NT : 4;  // 8-row blocks per mma group
#pragma unroll
  for (int s = 0; s < DH / 8; ++s) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(xs[(xr + g + (e & 1) * 8) * kLD<DH> + 8 * s + t +
                    (e >> 1) * 4],
                 ab[e], as[e]);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bb[NG][2], bsm[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int r = 8 * (n0 + n) + g;
        const float* tp = ts + r * kLD<DH> + 8 * s + t;
        split_tf32(tp[0], bb[n][0], bsm[n][0]);
        split_tf32(tp[4], bb[n][1], bsm[n][1]);
      }
      mma_3xtf32<NG>(acc + n0, ab, as, bb, bsm);
    }
  }
}

// out[n] += C T for the warp's 16 x (8 KT) tile C, held in accumulator
// fragments, and T the first DO columns of an [8 KT][kLD] tile (``ts``
// points at its first column), read N-major (B fragment of key step s,
// column block n: rows 8s + t and + 4, column 8n + g). C's A fragment for
// step s wants columns 8s + t and 8s + t + 4; lane (g, t') holds 8s + 2t'
// and + 1, so column 8s + t lives in lane (g, t / 2), element t & 1: eight
// shuffles within the quad. Each 64-column block of the result sums in a
// fresh fragment, added to `out` by rounded FADDs.
template <int DH, int KT, int DO>
__device__ __forceinline__ void mma_ct(float (*out)[4], const float (*c)[4],
                                       const float* ts, int lane, int g,
                                       int t) {
  constexpr int KS = DO / 8;
  constexpr int NC = KS < 8 ? KS : 8;  // column blocks per fresh fragment
  constexpr int NG = NC < 4 ? NC : 4;  // column blocks per mma group
  const int src_lo = (lane & ~3) | (t >> 1);
  const int src_hi = src_lo + 2;
  const bool odd = t & 1;
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += NC) {
    float f[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      float pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // h: rows g (0) and g + 8 (1)
        const float x0 = __shfl_sync(0xffffffffu, c[s][2 * h], src_lo);
        const float x1 = __shfl_sync(0xffffffffu, c[s][2 * h + 1], src_lo);
        const float z0 = __shfl_sync(0xffffffffu, c[s][2 * h], src_hi);
        const float z1 = __shfl_sync(0xffffffffu, c[s][2 * h + 1], src_hi);
        pa[h] = odd ? x1 : x0;       // column 8s + t
        pa[2 + h] = odd ? z1 : z0;   // column 8s + t + 4
      }
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[e], ab[e], as[e]);
#pragma unroll
      for (int n0 = 0; n0 < NC; n0 += NG) {
        uint32_t bb[NG][2], bsm[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float* tp =
              ts + (8 * s + t) * kLD<DH> + 8 * (c0 + n0 + n) + g;
          split_tf32(tp[0], bb[n][0], bsm[n][0]);
          split_tf32(tp[4 * kLD<DH>], bb[n][1], bsm[n][1]);
        }
        mma_3xtf32<NG>(f + n0, ab, as, bb, bsm);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[c0 + n][e] += f[n][e];
  }
}

// dQ: [2][NW·16][kLD] Q and dO rows, [2][2][BT][kLD] K and V tiles,
// [2][BT] bias
template <int DH, int NW>
constexpr int dq_smem_bytes() {
  return (2 * NW * 16 * kLD<DH> + 4 * kKeyTile<DH> * kLD<DH> +
          2 * kKeyTile<DH>) * 4;
}

template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dq, int L,
                 int n_heads, float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int DO = kOutCols<DH>;  // dQ's columns this block owns
  constexpr int NO = DO / 8;
  constexpr int BT = kKeyTile<DH>;
  constexpr int NT = BT / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [NW·16][kLD]
  float* Gs = Qs + NW * 16 * kLD<DH>;   // dO, the same rows
  float* Ks = Gs + NW * 16 * kLD<DH>;   // [2][BT][kLD]
  float* Vs = Ks + 2 * BT * kLD<DH>;    // [2][BT][kLD]
  float* Bs = Vs + 2 * BT * kLD<DH>;    // [2][BT] bias of the key tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, query tile), half)
  const int half = blockIdx.x % kHalves<DH>;
  const unsigned blk = blockIdx.x / kHalves<DH>;
  const int col0 = half * DO;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blk / tiles;
  const int q0 = (blk % tiles) * NW * 16;
  const int64_t row0 = bh * L;
  const int64_t off = row0 * DH;
  const float* kb = k + off;
  const float* vb = v + off;
  const float* brow =
      bias ? bias + (bh / n_heads) * L : nullptr;
  const int wr = warp * 16;          // the warp's first row in Qs and Gs
  const int r0 = q0 + wr + g;        // this thread's rows: r0, r0 + 8

  auto load_tile = [&](int buf, int j) {
    const int k0 = j * BT;
    load_rows<DH, BT, kThreads>(Ks + buf * BT * kLD<DH>, kb, k0, L, tid);
    load_rows<DH, BT, kThreads>(Vs + buf * BT * kLD<DH>, vb, k0, L, tid);
    if (brow != nullptr)
      load_vec<kThreads>(Bs + buf * BT, brow, k0, BT, L, tid);
  };

  load_rows<DH, NW * 16, kThreads>(Qs, q + off, q0, L, tid);
  load_rows<DH, NW * 16, kThreads>(Gs, dout + off, q0, L, tid);
  load_tile(0, 0);
  cp_async_commit();

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    lse_r[h] = r < L ? lse[row0 + r] : 0.f;
    dl_r[h] = r < L ? delta[row0 + r] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int last_row = min(q0 + NW * 16, L) - 1;
  const int nk = causal ? last_row / BT + 1 : (L + BT - 1) / BT;
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
    __syncthreads();  // tile j is in for every thread
    const int k0 = j * BT;
    if (!causal || k0 <= warp_last) {  // else the tile is above the diagonal
      const float* ks = Ks + buf * BT * kLD<DH>;
      const float* bs = Bs + buf * BT;
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      mma_xt<DH, NT>(sc, Qs, wr, ks, g, t);
      mma_xt<DH, NT>(dp, Gs, wr, Vs + buf * BT * kLD<DH>, g, t);
      // P and dS in place of S
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 b2 = brow ? *reinterpret_cast<const float2*>(
                                     bs + 8 * n + 2 * t)
                               : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int h = e >> 1;
          const float bv = (e & 1) ? b2.y : b2.x;
          const bool keep = key < L && (!causal || key <= r0 + 8 * h) &&
                            bv > kBiasDrop;
          const float p =
              keep ? __expf(sc[n][e] * scale + bv - lse_r[h]) : 0.f;
          sc[n][e] = p * (dp[n][e] - dl_r[h]) * scale;
        }
      }
      mma_ct<DH, NT, DO>(acc, sc, ks + col0, lane, g, t);
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    if (r >= L) continue;
    float* out = dq + off + static_cast<int64_t>(r) * DH + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// blocks of the dK/dV kernel a key tile: 1, or at DH 256 four, one for
// each half of dV's columns and of dK's
template <int DH>
constexpr int kDkvParts = DH > 128 ? 2 * kHalves<DH> : 1;

// dK/dV: [2][NW·16][kLD] K and V rows, [2][2][BT][kLD] Q and dO tiles,
// [2][2][BT] LSE and delta
template <int DH, int NW>
constexpr int dkv_smem_bytes() {
  return (2 * NW * 16 * kLD<DH> + 4 * kQueryTile<DH> * kLD<DH> +
          4 * kQueryTile<DH>) * 4;
}

template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ bias, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int n_heads, float scale,
                  int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int DO = kOutCols<DH>;  // dK's and dV's columns this block owns
  constexpr int NO = DO / 8;
  constexpr int BT = kQueryTile<DH>;
  constexpr int NT = BT / 8;
  // at DH 256 a block sums dV's half or dK's half alone, in acc_k
  constexpr bool kApart = kDkvParts<DH> > 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // [NW·16][kLD]
  float* Vs = Ks + NW * 16 * kLD<DH>;   // the same rows of V
  float* Qs = Vs + NW * 16 * kLD<DH>;   // [2][BT][kLD]
  float* Gs = Qs + 2 * BT * kLD<DH>;    // [2][BT][kLD] dO
  float* Ls = Gs + 2 * BT * kLD<DH>;    // [2][BT] LSE of the query tile
  float* Ds = Ls + 2 * BT;            // [2][BT] delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, key tile), part): at DH 256 parts 0 and 1 are
  // dV's column halves, 2 and 3 dK's
  const int part = blockIdx.x % kDkvParts<DH>;
  const unsigned blk = blockIdx.x / kDkvParts<DH>;
  const int col0 = (part % kHalves<DH>) * DO;
  const bool want_k = !kApart || part >= kHalves<DH>;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blk / tiles;
  const int kb0 = (blk % tiles) * NW * 16;
  const int64_t row0 = bh * L;
  const int64_t off = row0 * DH;
  const float* qb = q + off;
  const float* gb = dout + off;
  const float* brow =
      bias ? bias + (bh / n_heads) * L : nullptr;
  const int wr = warp * 16;          // the warp's first row in Ks and Vs
  const int key0 = kb0 + wr + g;     // this thread's keys: key0, key0 + 8

  auto load_tile = [&](int buf, int j) {
    const int q0 = j * BT;
    load_rows<DH, BT, kThreads>(Qs + buf * BT * kLD<DH>, qb, q0, L, tid);
    load_rows<DH, BT, kThreads>(Gs + buf * BT * kLD<DH>, gb, q0, L, tid);
    load_vec<kThreads>(Ls + buf * BT, lse + row0, q0, BT, L, tid);
    load_vec<kThreads>(Ds + buf * BT, delta + row0, q0, BT, L, tid);
  };

  // a query tile sees this block's keys iff its last row >= the first key
  const int nq = (L + BT - 1) / BT;
  const int j0 = causal ? kb0 / BT : 0;
  load_rows<DH, NW * 16, kThreads>(Ks, k + off, kb0, L, tid);
  load_rows<DH, NW * 16, kThreads>(Vs, v + off, kb0, L, tid);
  load_tile(0, j0);
  cp_async_commit();

  // the two keys' bias and whether they are kept, for the whole kernel
  float bk[2];
  bool kk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    bk[h] = (brow != nullptr && key < L) ? brow[key] : 0.f;
    kk[h] = key < L && bk[h] > kBiasDrop;
  }
  float acc_k[NO][4], acc_v[kApart ? 1 : NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (kApart ? 1 : NO); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.f;

  const int warp_first = kb0 + wr;
  for (int j = j0; j < nq; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < nq) {
      load_tile(buf ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in for every thread
    const int q0 = j * BT;
    // else every query of the tile is before the warp's keys
    if (!causal || q0 + BT - 1 >= warp_first) {
      const float* qs = Qs + buf * BT * kLD<DH>;
      const float* gs = Gs + buf * BT * kLD<DH>;
      const float* ls = Ls + buf * BT;
      const float* ds = Ds + buf * BT;
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      mma_xt<DH, NT>(sc, Ks, wr, qs, g, t);   // S^T = K Q^T
      if (want_k) mma_xt<DH, NT>(dp, Vs, wr, gs, g, t);   // dP^T = V dO^T
      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int qc = 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + qc + (e & 1);
          const int h = e >> 1;
          const bool keep = kk[h] && query < L &&
                            (!causal || key0 + 8 * h <= query);
          const float p =
              keep ? __expf(sc[n][e] * scale + bk[h] - ((e & 1) ? l2.y : l2.x))
                   : 0.f;
          sc[n][e] = p;
          dp[n][e] = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x)) * scale;
        }
      }
      if constexpr (kApart) {
        if (want_k)
          mma_ct<DH, NT, DO>(acc_k, dp, qs + col0, lane, g, t);  // dK
        else
          mma_ct<DH, NT, DO>(acc_k, sc, gs + col0, lane, g, t);  // dV
      } else {
        mma_ct<DH, NT, DO>(acc_v, sc, gs + col0, lane, g, t);  // dV += P^T dO
        mma_ct<DH, NT, DO>(acc_k, dp, qs + col0, lane, g, t);  // dK += dS^T Q
      }
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= L) continue;
    const int64_t at = off + static_cast<int64_t>(key) * DH + col0;
    if constexpr (kApart) {
      float* out = (want_k ? dk : dv) + at;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
            make_float2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
    } else {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(dk + at + 8 * n + 2 * t) =
            make_float2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + at + 8 * n + 2 * t) =
            make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      }
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

// Raise the kernel's dynamic shared-memory limit once per instantiation
// (idempotent, so a racing second call is harmless), then launch one block
// per (bh, ROWS-row tile, one of ``parts``), numbered on gridDim.x
// alone so that bh may exceed the 65535 of gridDim.y; keeping the attribute
// out of later launches lets them be captured in CUDA graphs.
template <int ROWS, typename Kernel, typename... Out>
int launch(Kernel kernel, int bytes, bool* configured, const Args& a,
           int parts, Out... out) {
  if (!*configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = true;
  }
  const int64_t blocks = a.bh * ((a.L + ROWS - 1) / ROWS) * parts;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), ROWS * 2, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, out...,
      static_cast<int>(a.L), a.n_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int NW>
int launch_dq(const Args& a, float* dq) {
  static bool configured = false;
  return launch<NW * 16>(flash_bwd_dq<DH, NW>, dq_smem_bytes<DH, NW>(),
                         &configured, a, kHalves<DH>, dq);
}

template <int DH, int NW>
int launch_dkv(const Args& a, float* dk, float* dv) {
  static bool configured = false;
  return launch<NW * 16>(flash_bwd_dkv<DH, NW>, dkv_smem_bytes<DH, NW>(),
                         &configured, a, kDkvParts<DH>, dk, dv);
}

// 4 warps (64 rows) a block where that fills the card, else 2, else 1;
// ``parts`` blocks a row tile
int warps_for(const Args& a, int parts) {
  if (a.bh * parts * ((a.L + 63) / 64) >= kSms) return 4;
  if (a.bh * parts * ((a.L + 31) / 32) >= kSms) return 2;
  return 1;
}

template <int DH>
int launch_dq_rows(const Args& a, float* dq) {
  switch (warps_for(a, kHalves<DH>)) {
    case 4: return launch_dq<DH, 4>(a, dq);
    case 2: return launch_dq<DH, 2>(a, dq);
    default: return launch_dq<DH, 1>(a, dq);
  }
}

template <int DH>
int launch_dkv_rows(const Args& a, float* dk, float* dv) {
  switch (warps_for(a, kDkvParts<DH>)) {
    case 4: return launch_dkv<DH, 4>(a, dk, dv);
    case 2: return launch_dkv<DH, 2>(a, dk, dv);
    default: return launch_dkv<DH, 1>(a, dk, dv);
  }
}

// 0 when the call can launch, else the CUDA error to return
int check_args(const void* q, const void* k, const void* v, const void* dout,
               int64_t L, int64_t n_heads) {
  if (n_heads <= 0 || L > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
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

// q, k, v, dout, dq [bh, L, dh] f32, q, k, v and dout 16-byte aligned; lse,
// delta [bh, L] f32; bias null or [bh / n_heads, L] f32; all contiguous; dh
// in {16, 32, 64, 128, 256}. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head width the kernel does not take).
extern "C" int ptt_flash_attn_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* bias, void* dq, int64_t bh,
                                     int64_t L, int64_t dh, int64_t n_heads,
                                     float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check_args(q, k, v, dout, L, n_heads)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  float* out = static_cast<float*>(dq);
  switch (dh) {
    case 16: return launch_dq_rows<16>(a, out);
    case 32: return launch_dq_rows<32>(a, out);
    case 64: return launch_dq_rows<64>(a, out);
    case 128: return launch_dq_rows<128>(a, out);
    case 256: return launch_dq_rows<256>(a, out);
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
  if (const int rc = check_args(q, k, v, dout, L, n_heads)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  float* outk = static_cast<float*>(dk);
  float* outv = static_cast<float*>(dv);
  switch (dh) {
    case 16: return launch_dkv_rows<16>(a, outk, outv);
    case 32: return launch_dkv_rows<32>(a, outk, outv);
    case 64: return launch_dkv_rows<64>(a, outk, outv);
    case 128: return launch_dkv_rows<128>(a, outk, outv);
    case 256: return launch_dkv_rows<256>(a, outk, outv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
