// Flash attention backward (the FlashAttention-2 split) on bf16 operands
// with float32 accumulation, the bf16 form of flash_attn_bwd.cu: two kernels
// over q, k, v, dO [BH, L, DH] bf16, the forward's LSE [BH, L] float32 and
// delta = rowsum(dO * O) [BH, L] float32 (taken over the bf16 values).
// Both recompute, per (query tile, key tile),
//   S  = scale · Q K^T + bias          float32
//   P  = exp(S - LSE)                  float32 (0 where masked or dropped)
//   dP = dO V^T                        float32
//   dS = P · (dP - delta) · scale      float32
// and then, with P and dS rounded to bf16 before their products,
//   dQ = bf16(dS) K                    (ptt_flash_attn_bf16_bwd_dq)
//   dK = bf16(dS)^T Q, dV = bf16(P)^T dO   (ptt_flash_attn_bf16_bwd_dkv)
// summed in float32 and written in bf16. The mask is causal (key j > query
// i) or none; the optional bias [B, L] float32 is per key (row b of
// [BH, ...] reads bias row b / n_heads), and a key whose bias is -1e8 or
// lower is dropped: P of a masked or dropped entry is made 0 by a select,
// so a wholly padded batch element gets exactly zero dQ, dK and dV.
//
// Replaces paddle_tpu/ops/attention_ops.py `_flash_bwd_pallas` as the JAX
// package runs it under bf16 AMP: its first pallas_call (body
// `_bwd_dq_kernel`, :184; dS cast to K's dtype before dS·K, :219) and its
// second (body `_bwd_dkv_kernel`, :232; P cast to dO's dtype before P^T·dO,
// :263, dS to Q's before dS^T·Q, :269), with and without `has_bias`; the
// outputs in the input dtype (:312, :334-335).
//
// Bound on an H100: bytes at the models' shapes. dQ reads q, k, v, dO (bf16)
// and writes dQ, 10·DH bytes a row, against 6·DH flops per visible pair at
// 989 TFLOP/s; dK/dV reads the same and writes two outputs (12·DH bytes a
// row) for 8·DH flops a pair. At L 512 causal and DH 64 a row's bytes take
// ~0.19 / 0.23 ns and its 256 pairs' flops ~0.10 / 0.13 ns.
//
// Design: the f32 kernels' split on the bf16 tile. Every output element is
// summed by exactly one warp in a fixed order: no atomics, and two calls
// give the same bits. On this card a loop of mma.sync is paced by its
// instruction count (a sub-partition hardly overlaps other instructions
// with a stream of mma.sync), so both kernels spend as few as they can.
// - dQ: each warp owns 16 query rows (1, 2 or 4 warps a block, the most that
//   still gives >= 132 blocks; a head's last query rows, the most key tiles
//   under causal, first). The warp's Q and dO A fragments are read into
//   registers once (DH <= 64; at DH 128 they stay in shared memory). Key
//   tiles of 64 rows (32 at DH 128) of K, V and the bias stream through a
//   three-slot cp.async ring (two at DH 128), one barrier a tile, by
//   load_rows. Each tile is worked in chunks of 16 keys, one at a time: S =
//   Q K^T and dP = dO V^T into accumulator fragments (`mma.sync.m16n8k16`,
//   K and V rows as B fragments by ldmatrix), P and dS there with the row's
//   LSE and delta in registers, and dQ += bf16(dS) K: dS, packed two
//   accumulator tiles at a time, is the A fragment as it stands, and K is
//   read N-major by ldmatrix.trans. p = 2^(s c + x), as for dK/dV below,
//   with x per row (and key, with a bias); dS leaves the scale out and dQ
//   takes it once at the end, exact for a power-of-two scale (else SDS,
//   below). A warp takes a tile's chunks by one of four paths, each a loop
//   of its own (one loop holding every path ran 1.5-3.5% slower): interior
//   (every key of the tile kept and below L, the chunk at or before the
//   warp's first row: no index, compare or select),
//   dropped-key (a select on each key: dropped, or past L, where the loader
//   puts a bias of -inf; without a bias one compare with L, the edge), the
//   causal diagonal (the chunk that crosses the warp's rows: one compare of
//   key and row) and the diagonal with dropped keys. A chunk that keeps no
//   key (a vote of the warp once the bias lands), or lies wholly after the
//   warp's rows under causal, is skipped; the block's key loop ends at the
//   last tile that keeps a key (a scan of the bias row first), so an
//   element that keeps no key loads nothing and writes zeros.
// - dK/dV: each warp owns 16 keys (blocks as for dQ) and works in the
//   transposed form: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T formed
//   with LSE and delta indexed by column (the query, from the tile's shared
//   copy) and the two keys' bias in registers; then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q, dO and Q read N-major. Query tiles of 64 rows (32
//   at DH 128) of Q, dO, LSE and delta stream through a three-slot cp.async
//   ring (two at DH 128), one barrier a tile, by bf16_mma.cuh's load_rows
//   (a thread's copies at fixed strides, an offset and a compare each), and
//   are worked in chunks of 16 queries, one at a time, which at DH <= 64
//   fits 168 registers and three blocks of 4 warps an SM (dQ's 16-key
//   chunks fit 128 and four blocks); K's and V's A fragments are read into
//   registers once (DH <= 64).
//   p = 2^(s c + x): log2(e) and the scale folded into one FFMA a score,
//   x = -LSE · log2(e) per query (with a bias (bias - LSE) · log2(e) per key
//   and query). dS^T leaves the scale out and dK takes it once at the end
//   (exact for a power-of-two scale, as at DH 16 and 64; else SDS, below).
//   Each tile takes one of five paths, uniform over a warp: interior
//   (every query at or after every key of the warp, all below L, no key
//   dropped: no index, compare or select), the same with a dropped key (a
//   select on the key's flag), the causal diagonal with and without that
//   select (one compare of key and query), and the edge (past L: every
//   test). A warp whose keys are all dropped skips every product, and a
//   block whose keys are all dropped loads nothing; both write zeros. A
//   head's key blocks are neighbours on the grid (they share Q and dO in
//   L2), its first keys, the most query tiles under causal, first.
// - Rows and keys past L load as zeros (a dQ row past L gets an LSE of
//   +inf, so that its p is 0) and are masked, so any L works.
// - Blocks are numbered (bh, tile) on gridDim.x alone, so batch × heads may
//   exceed 65535.
// - At DH 256 a block owns one 128-wide half of its outputs' columns
//   (kOutCols, tf32_mma.cuh; two blocks a tile, neighbours on the grid, one
//   launch): dQ's half, or dK's and dV's. It computes S and dP over all 256
//   columns and accumulates only its half, which keeps DH 128's
//   accumulator registers and its plan (32-row tiles, a two-slot ring, the
//   fixed operands read by ldmatrix as used). The halves recompute S and dP
//   each: dQ 10·DH flops a visible pair in place of 6·DH, dK/dV 12·DH in
//   place of 8·DH.
// - SDS: the reference rounds the scaled dS to bf16 (ds = p (dp - delta)
//   scale, then ds.astype). Leaving the scale out of dS and taking it once
//   at the end gives the same bits only when the scale is a power of two
//   (as dh^-0.5 is at DH 16 and 64), so the host launches that form only
//   then; for any other scale it launches the instantiation with SDS true,
//   which multiplies dS by the scale before rounding it and skips the final
//   multiply.
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace ptt;

constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSms = 132;

// rows of a streamed tile: keys for dQ, queries for dK/dV
template <int DH>
constexpr int kTile = DH > 64 ? 32 : 64;

// Both kernels stream their tiles through a ring of kStages slots, each
// holding two [BT][LD] bf16 tiles (K and V for dQ, Q and dO for dK/dV), then
// VECS [BT] float32 vectors (the bias; LSE and delta). At DH <= 64 the A
// fragments of the warp's fixed operands (Q and dO for dQ, K and V for
// dK/dV) stay in registers (32 at DH 64), so those operands are staged in
// the last slot and read out before the ring first fills it; at DH 128 (64
// registers beside 128 accumulators) they stay in shared memory after the
// ring and are read by ldmatrix when used.
template <int DH>
constexpr bool kInRegs = DH <= 64;
template <int DH>
constexpr int kStages = DH > 64 ? 2 : 3;
template <int DH, int VECS>
constexpr int kSlot = 2 * kTile<DH> * kLdB<DH> * 2 + VECS * kTile<DH> * 4;
template <int DH, int VECS>
constexpr int kFixedAt =
    (kInRegs<DH> ? kStages<DH> - 1 : kStages<DH>) * kSlot<DH, VECS>;
template <int DH, int NW, int VECS>
constexpr int ring_smem_bytes() {
  constexpr int ring = kStages<DH> * kSlot<DH, VECS>;
  constexpr int fixed = kFixedAt<DH, VECS> + 2 * NW * 16 * kLdB<DH> * 2;
  return ring > fixed ? ring : fixed;
}

// n bias values [r0, r0 + n) of a length-L row, -inf past L, so that a key
// past L fails the test of a kept key as a dropped one does
template <int THREADS>
__device__ __forceinline__ void load_bias(float* dst, const float* src,
                                          int r0, int n, int L, int tid) {
  for (int c = tid; c < n; c += THREADS) {
    if (r0 + c < L)
      cp_async4(dst + c, src + r0 + c, true);
    else
      dst[c] = -__int_as_float(0x7f800000);
  }
}

// Chunks of 16 keys, [k0 + c0, k0 + c0 + 16) for c0 in [from, to), of a key
// tile in shared memory (ks, vs, bs: its K and V rows and its bias), one at
// a time, for a warp's 16 query rows, this thread's rows r0 and r0 + 8 (h =
// 0, 1): S = Q K^T and dP = dO V^T, then P and dS / scale in place of dP,
// then dQ += bf16(dS / scale) K, K read N-major (with SDS dS itself, scaled
// before it is rounded). With a bias (BIAS) a chunk that keeps no key (its
// bits of ``any``, the tile's vote) is skipped. P = 2^(s c + x) with c =
// scale · log2(e) and x = lx[h] = -LSE · log2(e), or with a bias (lx[h] =
// LSE) x = (bias - LSE) · log2(e), the difference taken first so that a
// bias and an LSE of one size cancel exactly, as in the plain version's
// s - LSE.
//   MASK  the causal diagonal: one compare of key and row;
//   DROP  a select on each key, kept where its bias is above -1e8 (the
//         loader's -inf past L fails it) or, without a bias, below L.
// Neither: the interior path, no index, compare or select. kr = r0 - k0 -
// 2t and kl = L - k0 - 2t fold the thread's offsets, so that each test is
// one compare with a constant.
template <int DH, bool MASK, bool DROP, bool BIAS, bool SDS>
__device__ __forceinline__ void dq_chunks(
    int from, int to, uint32_t any,
    const uint32_t (&qf)[kInRegs<DH> ? DH / 16 : 1][4],
    const uint32_t (&gf)[kInRegs<DH> ? DH / 16 : 1][4], const bf16* Qs,
    const bf16* Gs, int wr, float (&acc)[kOutCols<DH> / 8][4],
    const bf16* ks, const bf16* vs, const float* bs, const float (&lx)[2],
    const float (&dl)[2], int kr, int kl, float c, float scale, int col0,
    int lane) {
  constexpr int KS = DH / 16;            // k-steps of Q K^T
  constexpr int NO = kOutCols<DH> / 8;   // 8-column tiles of dQ's block
  constexpr int KPL = kTile<DH> / 32;    // keys a lane in the tile's vote
  constexpr uint32_t kChunk = (1u << (16 / KPL)) - 1;  // a chunk's bits
  const int t = lane & 3;
  // one chunk at a time: unrolled, the chunks' products would overlap and
  // take the registers that more blocks an SM need
#pragma unroll 1
  for (int c0 = from; c0 < to; c0 += 16) {
    if (BIAS && ((any >> (c0 / KPL)) & kChunk) == 0) continue;
    float sc[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t aq[4], ag[4];
      if constexpr (kInRegs<DH>) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qf[s][i], ag[i] = gf[s][i];
      } else {
        load_a<DH>(aq, Qs, wr, 16 * s, lane);
        load_a<DH>(ag, Gs, wr, 16 * s, lane);
      }
      uint32_t b[4];
      load_b_rows<DH>(b, ks, c0, 16 * s, lane);
      mma_bf16(sc[0], aq, b[0], b[1]);
      mma_bf16(sc[1], aq, b[2], b[3]);
      load_b_rows<DH>(b, vs, c0, 16 * s, lane);
      mma_bf16(dp[0], ag, b[0], b[1]);
      mma_bf16(dp[1], ag, b[2], b[3]);
    }
    // the bias of this thread's four keys
    float kb[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 b2 = BIAS ? *reinterpret_cast<const float2*>(
                                   bs + c0 + 8 * n + 2 * t)
                             : make_float2(0.f, 0.f);
      kb[n][0] = b2.x;
      kb[n][1] = b2.y;
    }
    // P, and dS / scale in place of dP
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, x = e & 1;
        const float xo = BIAS ? (kb[n][x] - lx[h]) * kLog2e : lx[h];
        float p = ex2(fmaf(sc[n][e], c, xo));
        bool keep = true;
        if (MASK) keep = c0 + 8 * n + x <= kr + 8 * h;
        if (DROP)
          keep = keep && (BIAS ? kb[n][x] > kBiasDrop : c0 + 8 * n + x < kl);
        if (MASK || DROP) p = keep ? p : 0.f;
        const float grad = p * (dp[n][e] - dl[h]);
        dp[n][e] = SDS ? grad * scale : grad;
      }
    // dQ += bf16(dS / scale) K, K's columns [col0, ..) read N-major
    uint32_t a[4];
    pack_a(a, dp, 0);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t b[4];
      load_b_cols<DH>(b, ks, c0, col0 + 8 * n, lane);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// dQ of NW · 16 query rows a block, 16 a warp; BIAS: the call has a key
// bias. At DH <= 64 with 2 or 4 warps it is held to 128 registers, 512
// threads an SM: four blocks of 4 warps at the models' shapes, whose 56 KB
// rings fill the SM's 228 KB of shared memory (4-8% faster than three
// blocks, no spill); one warp a block (grids too small to fill the card)
// takes what it needs.
template <int DH, int NW, bool BIAS, bool SDS>
__global__ void __launch_bounds__(NW * 32, DH <= 64 && NW > 1 ? 16 / NW : 1)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, bf16* __restrict__ dq,
                      int L, int n_heads, float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int LD = kLdB<DH>;
  constexpr int BT = kTile<DH>;
  constexpr int S = kStages<DH>;
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int DO = kOutCols<DH>;  // dQ's columns this block owns
  constexpr int NO = DO / 8;   // 8-column tiles of dQ
  constexpr int SLOT = kSlot<DH, 1>;
  constexpr int KPL = BT / 32;  // keys a lane in the tile's votes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + kFixedAt<DH, 1>);
  bf16* Gs = Qs + NW * 16 * LD;  // [NW·16][LD] each

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, query tile), half)
  const int half = blockIdx.x % kHalves<DH>;
  const unsigned blk = blockIdx.x / kHalves<DH>;
  const int col0 = half * DO;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blk / tiles;
  // a head's last query rows (under causal the most key tiles) first
  const int q0 = (tiles - 1 - static_cast<int>(blk % tiles)) * NW * 16;
  const int64_t row0 = bh * L;
  const int64_t off = row0 * DH;
  const float* brow = BIAS ? bias + (bh / n_heads) * L : nullptr;
  const int wr = warp * 16;   // the warp's first row in Qs and Gs
  const int wq0 = q0 + wr;    // the warp's first row
  const int r0 = wq0 + g;     // this thread's rows: r0, r0 + 8

  // the keys the block sees: under causal up to its last row; with a bias
  // up to its last kept key (every warp scans the row and gets the same
  // answer), so that an element that keeps no key visits no tile
  const int last_row = min(q0 + NW * 16, L) - 1;
  int kend = causal ? last_row + 1 : L;
  if constexpr (BIAS) {
    int last = 0;
#pragma unroll 4
    for (int c = lane; c < kend; c += 32)
      if (brow[c] > kBiasDrop) last = c + 1;
    kend = __reduce_max_sync(0xffffffffu, last);
  }
  const int nk = (kend + BT - 1) / BT;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (nk > 0) {
    auto load_tile = [&](int buf, int j) {
      const int k0 = j * BT;
      bf16* ks = reinterpret_cast<bf16*>(smem_raw + buf * SLOT);
      load_rows<DH, BT, kThreads>(ks, k + off, k0, L, tid);
      load_rows<DH, BT, kThreads>(ks + BT * LD, v + off, k0, L, tid);
      if constexpr (BIAS)
        load_bias<kThreads>(reinterpret_cast<float*>(ks + 2 * BT * LD), brow,
                            k0, BT, L, tid);
    };
    load_rows<DH, NW * 16, kThreads>(Qs, q + off, q0, L, tid);
    load_rows<DH, NW * 16, kThreads>(Gs, dout + off, q0, L, tid);
    cp_async_commit();
    // one commit group a tile (empty past the last), so that waiting for
    // all but the newest S - 2 groups waits for exactly the oldest tile
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < nk) load_tile(i, i);
      cp_async_commit();
    }
    cp_async_wait<S - 1>();
    __syncthreads();  // Q and dO are in for every thread
    uint32_t qf[kInRegs<DH> ? KS : 1][4], gf[kInRegs<DH> ? KS : 1][4];
    if constexpr (kInRegs<DH>) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        load_a<DH>(qf[s], Qs, wr, 16 * s, lane);
        load_a<DH>(gf[s], Gs, wr, 16 * s, lane);
      }
    }
    // this thread's rows' LSE (-LSE · log2(e) without a bias) and delta; a
    // row past L takes an LSE of +inf, so that its p is 0
    float lx[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      const float l = r < L ? lse[row0 + r] : __int_as_float(0x7f800000);
      lx[h] = BIAS ? l : -l * kLog2e;
      dl[h] = r < L ? delta[row0 + r] : 0.f;
    }
    const float c = scale * kLog2e;
    // the warp's keys end at its last row under causal, else at L
    const int kmax = causal ? min(wq0 + 15, L - 1) + 1 : L;
    for (int j = 0; j < nk; ++j) {
      cp_async_wait<S - 2>();
      // tile j is in for every thread, and every warp is done with tile
      // j - 1 (and with the Q and dO staged in the last slot)
      __syncthreads();
      if (j + S - 1 < nk) load_tile((j + S - 1) % S, j + S - 1);
      cp_async_commit();
      const int k0 = j * BT;
      const int cend = min(kmax, k0 + BT) - k0;  // the warp's keys in it
      if (wq0 >= L || cend <= 0) continue;
      const bf16* ks =
          reinterpret_cast<const bf16*>(smem_raw + (j % S) * SLOT);
      const bf16* vs = ks + BT * LD;
      const float* bs = reinterpret_cast<const float*>(vs + BT * LD);
      // which keys the tile keeps: bit i of ``any`` (``all``) says that
      // some (every) key of lane i's KPL keys k0 + KPL·i.. is kept; the
      // tile drops a key (or has one past L) unless every bit of ``all``
      uint32_t any = 0;
      bool drop = k0 + BT > L;
      if constexpr (BIAS) {
        uint32_t all;
        if constexpr (KPL == 2) {
          const float2 b2 = reinterpret_cast<const float2*>(bs)[lane];
          const bool a0 = b2.x > kBiasDrop, a1 = b2.y > kBiasDrop;
          any = __ballot_sync(0xffffffffu, a0 || a1);
          all = __ballot_sync(0xffffffffu, a0 && a1);
        } else {
          any = all = __ballot_sync(0xffffffffu, bs[lane] > kBiasDrop);
        }
        drop = all != 0xffffffffu;
      }
      // the tile's chunks before cmid lie at or before the warp's first
      // row; under causal the rest cross its diagonal
      const int cmid = causal ? max(0, min(cend, wq0 - k0)) : cend;
      const int kr = r0 - k0 - 2 * t, kl = L - k0 - 2 * t;
      if (drop) {
        dq_chunks<DH, false, true, BIAS, SDS>(0, cmid, any, qf, gf, Qs, Gs,
                                              wr, acc, ks, vs, bs, lx, dl, kr,
                                              kl, c, scale, col0, lane);
        dq_chunks<DH, true, true, BIAS, SDS>(cmid, cend, any, qf, gf, Qs, Gs,
                                             wr, acc, ks, vs, bs, lx, dl, kr,
                                             kl, c, scale, col0, lane);
      } else {
        dq_chunks<DH, false, false, BIAS, SDS>(0, cmid, any, qf, gf, Qs, Gs,
                                               wr, acc, ks, vs, bs, lx, dl,
                                               kr, kl, c, scale, col0, lane);
        dq_chunks<DH, true, false, BIAS, SDS>(cmid, cend, any, qf, gf, Qs,
                                              Gs, wr, acc, ks, vs, bs, lx, dl,
                                              kr, kl, c, scale, col0, lane);
      }
    }
  }

  // dQ takes the scale that dS left out (with SDS dS took it)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    if (r >= L) continue;
    bf16* out = dq + off + static_cast<int64_t>(r) * DH + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if constexpr (SDS)
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
      else
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// One query tile, queries [q0, q0 + BT) in shared memory (qs, gs: Q and dO;
// ls, ds: LSE and delta), for a warp's 16 keys, this thread's keys key0 and
// key0 + 8 (h = 0, 1; bias kb[h], kept kk[h]): in chunks of 16 queries,
// S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T / scale in place, then
// dV += bf16(P^T) dO and dK += bf16(dS^T / scale) Q (with SDS dS^T itself,
// scaled before it is rounded). P = 2^(s c + x) with
// c = scale · log2(e) and x = -LSE · log2(e), or with a bias (BIAS) x =
// (bias - LSE) · log2(e), the difference taken first so that a bias and an
// LSE of one size cancel exactly, as in the plain version's s - LSE.
//   MASK 0  the tile is wholly at or after the warp's keys and below L: no
//           index, compare or select;
//   MASK 1  the causal diagonal (below L): one compare of key and query;
//   MASK 2  the edge: every score's query against L and, under causal, the
//           key against the query.
// DROP selects p = 0 for a dropped key (or one past L). kq = key0 - q0 - 2t
// and qr = L - q0 - 2t fold the thread's offsets, so that each test is one
// compare with a constant.
template <int DH, int MASK, bool DROP, bool BIAS, bool SDS>
__device__ __forceinline__ void dkv_tile(
    const uint32_t (&kf)[kInRegs<DH> ? DH / 16 : 1][4],
    const uint32_t (&vf)[kInRegs<DH> ? DH / 16 : 1][4], const bf16* Ks,
    const bf16* Vs, int wr, float (&acc_k)[kOutCols<DH> / 8][4],
    float (&acc_v)[kOutCols<DH> / 8][4], const bf16* qs, const bf16* gs,
    const float* ls, const float* ds, const float (&kb)[2],
    const bool (&kk)[2], int kq, int qr, int causal, float c, float scale,
    int col0, int lane) {
  constexpr int BT = kTile<DH>;
  constexpr int QC = 16;       // queries a chunk
  constexpr int NC = QC / 8;   // 8-query tiles of a chunk
  constexpr int KS = DH / 16;  // k-steps of K Q^T
  constexpr int NO = kOutCols<DH> / 8;  // 8-column tiles of dK and dV
  const int t = lane & 3;
  // one chunk at a time: unrolled, the chunks' products would overlap and
  // take the registers that a third block an SM needs
#pragma unroll 1
  for (int c0 = 0; c0 < BT; c0 += QC) {
    float sc[NC][4], dp[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t ak[4], av[4];
      if constexpr (kInRegs<DH>) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[i] = kf[s][i], av[i] = vf[s][i];
      } else {
        load_a<DH>(ak, Ks, wr, 16 * s, lane);
        load_a<DH>(av, Vs, wr, 16 * s, lane);
      }
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t b[4];
        load_b_rows<DH>(b, qs, c0 + 8 * n, 16 * s, lane);
        mma_bf16(sc[n], ak, b[0], b[1]);
        mma_bf16(sc[n + 1], ak, b[2], b[3]);
        load_b_rows<DH>(b, gs, c0 + 8 * n, 16 * s, lane);
        mma_bf16(dp[n], av, b[0], b[1]);
        mma_bf16(dp[n + 1], av, b[2], b[3]);
      }
    }
    // the exponent's offset and delta of this thread's queries
    float xo[BIAS ? 2 : 1][NC][2], dl[NC][2];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c0 + 8 * n +
                                                         2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + c0 + 8 * n +
                                                         2 * t);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float l = x ? l2.y : l2.x;
        dl[n][x] = x ? d2.y : d2.x;
        if constexpr (BIAS) {
          xo[0][n][x] = (kb[0] - l) * kLog2e;
          xo[1][n][x] = (kb[1] - l) * kLog2e;
        } else {
          xo[0][n][x] = -l * kLog2e;
        }
      }
    }
    // P^T in place of S^T, dS^T / scale in place of dP^T
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, x = e & 1;
        const int col = c0 + 8 * n + x;  // the query, less q0 + 2t
        float p = ex2(fmaf(sc[n][e], c, xo[BIAS ? h : 0][n][x]));
        bool keep = true;
        if (MASK == 1) keep = kq + 8 * h <= col;
        if (MASK == 2) keep = col < qr && (!causal || kq + 8 * h <= col);
        if (DROP) keep = keep && kk[h];
        if (MASK != 0 || DROP) p = keep ? p : 0.f;
        sc[n][e] = p;
        const float grad = p * (dp[n][e] - dl[n][x]);
        dp[n][e] = SDS ? grad * scale : grad;
      }
    // dV += bf16(P^T) dO, dK += bf16(dS^T / scale) Q; dO and Q (their
    // columns [col0, ..)) read N-major
#pragma unroll
    for (int s = 0; s < QC / 16; ++s) {
      uint32_t ap[4], ad[4];
      pack_a(ap, sc, s);
      pack_a(ad, dp, s);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        load_b_cols<DH>(b, gs, c0 + 16 * s, col0 + 8 * n, lane);
        mma_bf16(acc_v[n], ap, b[0], b[1]);
        mma_bf16(acc_v[n + 1], ap, b[2], b[3]);
        load_b_cols<DH>(b, qs, c0 + 16 * s, col0 + 8 * n, lane);
        mma_bf16(acc_k[n], ad, b[0], b[1]);
        mma_bf16(acc_k[n + 1], ad, b[2], b[3]);
      }
    }
  }
}

// dK and dV of NW · 16 keys a block, 16 a warp; BIAS: the call has a key
// bias. At DH <= 64 and 2 or 4 warps it fits 168 registers, 384 threads an
// SM (three blocks of 4 warps at the models' shapes), without a spill; one
// warp a block (grids too small to fill the card) copies 16 rows a thread
// per tile and would spill there, so it takes what it needs.
template <int DH, int NW, bool BIAS, bool SDS>
__global__ void __launch_bounds__(NW * 32, DH <= 64 && NW > 1 ? 12 / NW : 1)
    flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int L, int n_heads,
                       float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int LD = kLdB<DH>;
  constexpr int BT = kTile<DH>;
  constexpr int S = kStages<DH>;
  constexpr int KS = DH / 16;  // k-steps of K Q^T
  constexpr int DO = kOutCols<DH>;  // dK's and dV's columns this block owns
  constexpr int NO = DO / 8;   // 8-column tiles of dK and dV
  constexpr int SLOT = kSlot<DH, 2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + kFixedAt<DH, 2>);
  bf16* Vs = Ks + NW * 16 * LD;  // [NW·16][LD] each

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, key tile), half)
  const int half = blockIdx.x % kHalves<DH>;
  const unsigned blk = blockIdx.x / kHalves<DH>;
  const int col0 = half * DO;
  const int tiles = (L + NW * 16 - 1) / (NW * 16);
  const int64_t bh = blk / tiles;
  const int kb0 = (blk % tiles) * NW * 16;
  const int64_t row0 = bh * L;
  const int64_t off = row0 * DH;
  const int wr = warp * 16;        // the warp's first row in Ks and Vs
  const int wk0 = kb0 + wr;        // the warp's first key
  const int key0 = wk0 + g;        // this thread's keys: key0, key0 + 8

  // the two keys' bias and whether they are kept, for the whole kernel
  float kb[2];
  bool kk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    kb[h] = (BIAS && key < L) ? bias[(bh / n_heads) * L + key] : 0.f;
    kk[h] = key < L && kb[h] > kBiasDrop;
  }
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // a block whose keys are all dropped loads nothing and writes zeros
  if (__syncthreads_or(kk[0] || kk[1])) {
    auto load_tile = [&](int buf, int j) {
      const int q0 = j * BT;
      bf16* qs = reinterpret_cast<bf16*>(smem_raw + buf * SLOT);
      float* ls = reinterpret_cast<float*>(qs + 2 * BT * LD);
      load_rows<DH, BT, kThreads>(qs, q + off, q0, L, tid);
      load_rows<DH, BT, kThreads>(qs + BT * LD, dout + off, q0, L, tid);
      load_vec_f32<kThreads>(ls, lse + row0, q0, BT, L, tid);
      load_vec_f32<kThreads>(ls + BT, delta + row0, q0, BT, L, tid);
    };
    // a query tile sees this block's keys iff its last row >= the first
    // key; under causal the tiles start at the block's own
    const int nq = (L + BT - 1) / BT;
    const int j0 = causal ? kb0 / BT : 0;
    load_rows<DH, NW * 16, kThreads>(Ks, k + off, kb0, L, tid);
    load_rows<DH, NW * 16, kThreads>(Vs, v + off, kb0, L, tid);
    cp_async_commit();
    // one commit group a tile (empty past the last), so that waiting for
    // all but the newest S - 2 groups waits for exactly the oldest tile
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (j0 + i < nq) load_tile(i, j0 + i);
      cp_async_commit();
    }
    cp_async_wait<S - 1>();
    __syncthreads();  // K and V are in for every thread
    uint32_t kf[kInRegs<DH> ? KS : 1][4], vf[kInRegs<DH> ? KS : 1][4];
    if constexpr (kInRegs<DH>) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        load_a<DH>(kf[s], Ks, wr, 16 * s, lane);
        load_a<DH>(vf[s], Vs, wr, 16 * s, lane);
      }
    }
    // whether the warp keeps any key, and drops any (past L counts)
    const bool live = __any_sync(0xffffffffu, kk[0] || kk[1]);
    const bool drops = __any_sync(0xffffffffu, !(kk[0] && kk[1]));
    const float c = scale * kLog2e;
    for (int j = j0; j < nq; ++j) {
      const int i = j - j0;
      cp_async_wait<S - 2>();
      // tile j is in for every thread, and every warp is done with tile
      // j - 1 (and with the K and V staged in the last slot)
      __syncthreads();
      if (j + S - 1 < nq) load_tile((i + S - 1) % S, j + S - 1);
      cp_async_commit();
      const int q0 = j * BT;
      // a warp that keeps no key, or a tile wholly before its keys
      if (!live || (causal && q0 + BT - 1 < wk0)) continue;
      const bf16* qs =
          reinterpret_cast<const bf16*>(smem_raw + (i % S) * SLOT);
      const bf16* gs = qs + BT * LD;
      const float* ls = reinterpret_cast<const float*>(gs + BT * LD);
      const float* ds = ls + BT;
      const int kq = key0 - q0 - 2 * t, qr = L - q0 - 2 * t;
      if (q0 + BT > L)
        dkv_tile<DH, 2, true, BIAS, SDS>(kf, vf, Ks, Vs, wr, acc_k, acc_v, qs,
                                         gs, ls, ds, kb, kk, kq, qr, causal,
                                         c, scale, col0, lane);
      else if (causal && q0 < wk0 + 15 && drops)
        dkv_tile<DH, 1, true, BIAS, SDS>(kf, vf, Ks, Vs, wr, acc_k, acc_v, qs,
                                         gs, ls, ds, kb, kk, kq, qr, causal,
                                         c, scale, col0, lane);
      else if (causal && q0 < wk0 + 15)
        dkv_tile<DH, 1, false, BIAS, SDS>(kf, vf, Ks, Vs, wr, acc_k, acc_v,
                                          qs, gs, ls, ds, kb, kk, kq, qr,
                                          causal, c, scale, col0, lane);
      else if (drops)
        dkv_tile<DH, 0, true, BIAS, SDS>(kf, vf, Ks, Vs, wr, acc_k, acc_v, qs,
                                         gs, ls, ds, kb, kk, kq, qr, causal,
                                         c, scale, col0, lane);
      else
        dkv_tile<DH, 0, false, BIAS, SDS>(kf, vf, Ks, Vs, wr, acc_k, acc_v,
                                          qs, gs, ls, ds, kb, kk, kq, qr,
                                          causal, c, scale, col0, lane);
    }
  }

  // dK takes the scale that dS^T left out (with SDS dS^T took it)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= L) continue;
    const int64_t at = off + static_cast<int64_t>(key) * DH + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if constexpr (SDS)
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n + 2 * t) =
            pack_bf16(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      else
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n + 2 * t) = pack_bf16(
            acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n + 2 * t) =
          pack_bf16(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  int64_t bh, L;
  int n_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit once per instantiation
// (idempotent, so a racing second call is harmless), then launch one block
// per (bh, ROWS-row tile, column half of ``halves``); keeping the attribute
// out of later launches lets them be captured in CUDA graphs.
template <int ROWS, typename Kernel, typename... Out>
int launch(Kernel kernel, int bytes, bool* configured, const Args& a,
           int halves, Out... out) {
  if (!*configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = true;
  }
  const int64_t blocks = a.bh * ((a.L + ROWS - 1) / ROWS) * halves;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), ROWS * 2, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, out...,
      static_cast<int>(a.L), a.n_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int NW, bool BIAS, bool SDS>
int launch_dq(const Args& a, bf16* dq) {
  static bool configured = false;
  return launch<NW * 16>(flash_bwd_dq_bf16<DH, NW, BIAS, SDS>,
                         ring_smem_bytes<DH, NW, 1>(), &configured, a,
                         kHalves<DH>, dq);
}

template <int DH, int NW, bool BIAS, bool SDS>
int launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  static bool configured = false;
  return launch<NW * 16>(flash_bwd_dkv_bf16<DH, NW, BIAS, SDS>,
                         ring_smem_bytes<DH, NW, 2>(), &configured, a,
                         kHalves<DH>, dk, dv);
}

// 4 warps (64 rows) a block where that fills the card, else 2, else 1;
// ``halves`` blocks a row tile
int warps_for(const Args& a, int halves) {
  if (a.bh * halves * ((a.L + 63) / 64) >= kSms) return 4;
  if (a.bh * halves * ((a.L + 31) / 32) >= kSms) return 2;
  return 1;
}

template <int DH, bool BIAS, bool SDS>
int launch_dq_rows(const Args& a, bf16* dq) {
  switch (warps_for(a, kHalves<DH>)) {
    case 4: return launch_dq<DH, 4, BIAS, SDS>(a, dq);
    case 2: return launch_dq<DH, 2, BIAS, SDS>(a, dq);
    default: return launch_dq<DH, 1, BIAS, SDS>(a, dq);
  }
}

// whether the scale is a power of two: then dS / scale rounds to the bits
// of dS, scaled, and the kernels may take the scale once at the end
bool pow2(float scale) {
  int e;
  return std::frexp(scale, &e) == 0.5f;
}

template <int DH>
int launch_dq_bias(const Args& a, bf16* dq) {
  if (pow2(a.scale))
    return a.bias ? launch_dq_rows<DH, true, false>(a, dq)
                  : launch_dq_rows<DH, false, false>(a, dq);
  return a.bias ? launch_dq_rows<DH, true, true>(a, dq)
                : launch_dq_rows<DH, false, true>(a, dq);
}

template <int DH, bool BIAS, bool SDS>
int launch_dkv_rows(const Args& a, bf16* dk, bf16* dv) {
  switch (warps_for(a, kHalves<DH>)) {
    case 4: return launch_dkv<DH, 4, BIAS, SDS>(a, dk, dv);
    case 2: return launch_dkv<DH, 2, BIAS, SDS>(a, dk, dv);
    default: return launch_dkv<DH, 1, BIAS, SDS>(a, dk, dv);
  }
}

template <int DH>
int launch_dkv_bias(const Args& a, bf16* dk, bf16* dv) {
  if (pow2(a.scale))
    return a.bias ? launch_dkv_rows<DH, true, false>(a, dk, dv)
                  : launch_dkv_rows<DH, false, false>(a, dk, dv);
  return a.bias ? launch_dkv_rows<DH, true, true>(a, dk, dv)
                : launch_dkv_rows<DH, false, true>(a, dk, dv);
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
  return Args{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),      static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),   static_cast<const float*>(delta),
              static_cast<const float*>(bias),  bh,
              L,                                static_cast<int>(n_heads),
              scale,                            causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Rows a block of a launch of either kernel with these arguments: plan[0]
// query rows (dQ) or keys (dK/dV), 16 a warp. Returns cudaErrorInvalidValue
// for a head width the kernels do not take.
extern "C" int ptt_flash_attn_bf16_bwd_plan(int64_t bh, int64_t L,
                                            int64_t dh, int* plan) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128 && dh != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.bh = bh;
  a.L = L;
  plan[0] = warps_for(a, dh > 128 ? 2 : 1) * 16;
  return 0;
}

// q, k, v, dout, dq [bh, L, dh] bf16, q, k, v and dout 16-byte aligned; lse,
// delta [bh, L] float32; bias null or [bh / n_heads, L] float32; all
// contiguous; dh in {16, 32, 64, 128, 256}. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head width the kernel does
// not take).
extern "C" int ptt_flash_attn_bf16_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* bias, void* dq,
                                          int64_t bh, int64_t L, int64_t dh,
                                          int64_t n_heads, float scale,
                                          int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check_args(q, k, v, dout, L, n_heads)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  bf16* out = static_cast<bf16*>(dq);
  switch (dh) {
    case 16: return launch_dq_bias<16>(a, out);
    case 32: return launch_dq_bias<32>(a, out);
    case 64: return launch_dq_bias<64>(a, out);
    case 128: return launch_dq_bias<128>(a, out);
    case 256: return launch_dq_bias<256>(a, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As ptt_flash_attn_bf16_bwd_dq, with outputs dk, dv [bh, L, dh] bf16.
extern "C" int ptt_flash_attn_bf16_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int64_t bh, int64_t L, int64_t dh, int64_t n_heads, float scale,
    int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check_args(q, k, v, dout, L, n_heads)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, bias, bh, L, n_heads,
                           scale, causal, stream);
  bf16* outk = static_cast<bf16*>(dk);
  bf16* outv = static_cast<bf16*>(dv);
  switch (dh) {
    case 16: return launch_dkv_bias<16>(a, outk, outv);
    case 32: return launch_dkv_bias<32>(a, outk, outv);
    case 64: return launch_dkv_bias<64>(a, outk, outv);
    case 128: return launch_dkv_bias<128>(a, outk, outv);
    case 256: return launch_dkv_bias<256>(a, outk, outv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
