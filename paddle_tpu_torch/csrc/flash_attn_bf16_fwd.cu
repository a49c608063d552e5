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
// Bound on an H100: bytes. At the AMP LM step's shape (BH 512, L 512, DH 64,
// causal) q, k, v and o are 134 MB, 0.040 ms at 3.35 TB/s, against 17
// GFLOP of products, 0.017 ms at 989 TFLOP/s (wgmma's rate; mma.sync, used
// here, reaches about half of it). What holds a straightforward FA-2 loop
// back is instruction issue: an SM sub-partition streams the loop's mma.sync
// and hardly overlaps other instructions with them, so every instruction of
// the softmax and of the tile loads adds to the tile's time.
//
// Design: spend as few instructions a score as possible. A warp owns 32
// query rows (two m16 row tiles) at DH <= 64 without causal, 16 otherwise
// (at DH 128 32 would not fit 255 registers; under causal a 64-row block
// loses less to the diagonal and three fit an SM); a block 4 warps, or 2 or
// 1 where 4 would give fewer blocks than the card's 132 SMs. Q's A
// fragments are read into registers once, before the key loop. Key tiles
// of 64 rows of K, V and the bias stream through a three-slot cp.async ring
// (two at DH 128) in shared memory (rows padded to DH + 8, so that ldmatrix
// is conflict-free); a thread's 16-byte copies sit at fixed strides, an
// offset and a compare each. Each ldmatrix.x4 of K or V feeds four mma.sync
// (m16n8k16, bf16 in, float32 out) at 32 rows a warp, two at 16. The scores
// stay in registers, and each key tile takes one of four paths, uniform over
// a warp:
//   interior  the tile's keys all lie below L, under causal at or below the
//             warp's first row, and none is dropped: per score a max, one
//             FFMA and one ex2 for p, an add to the row sum (and at 16 rows
//             a warp without a bias not even the scaling: the max is taken
//             on the products, the scale folded into the exponent); no
//             index arithmetic, compare or select;
//   dropped   as interior, but some key's bias is <= -1e8 (a flag the block
//             takes with __syncthreads_or when the bias tile lands): p is
//             set to 0 by a select on that key;
//   diagonal  a causal tile below L that crosses the warp's rows, no key
//             dropped: one compare of key and row, two selects;
//   edge      the rest (past L): every score's key and row are tested,
//             masked scores selected to -1e30 and p to 0.
// The exponent is base 2 with log2(e) folded into one FFMA: p = ex2(s c -
// fl(m c)) (inline `ex2.approx.ftz`), c = log2(e), or scale · log2(e) for
// the raw products; m is the max of s, whose natural form (s itself, or s ·
// scale, which keeps the max) is the max the backward kernels recompute P
// from; LSE = m + log(l), less the rounding of m c that the p's carry. The
// row sum l stays a per-thread partial, rescaled with O, and is reduced over
// the row's four lanes once, after the loop; O is scaled by one reciprocal a
// row, staged in the warp's rows of Q's shared memory and written in 16-byte
// stores of whole rows. Causal tiles wholly above a warp's diagonal are
// skipped, and a head's query tiles run last first (the heaviest under
// causal), its tiles neighbours on the grid so that they share K and V in
// L2. One owner per output and a fixed order: two calls give the same bits.
// Blocks are numbered (bh, query tile) on gridDim.x alone, so batch × heads
// may exceed 65535.
// At DH 256 a block owns one 128-wide half of O's columns (kOutCols,
// tf32_mma.cuh; two blocks a query tile, neighbours on the grid, one
// launch): it computes the scores over all 256 columns and accumulates only
// its half of O (DH 128's 64 accumulator registers), reading its half of V;
// half 0 writes LSE. Q's A fragments (64 registers there) are read from
// shared memory by ldmatrix at each k-step instead of held. The score
// products are done twice, once a half: 6·DH flops a visible pair in place
// of 4·DH.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace ptt;

constexpr int kBK = 64;     // keys per tile
// key tiles in the cp.async ring: 3, or 2 at DH >= 128, where a third
// would leave room for one block an SM
template <int DH>
constexpr int kStages = DH > 64 ? 2 : 3;
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSms = 132;
// Q's A fragments held in registers (else read from shared memory as used)
template <int DH>
constexpr bool kQInRegs = DH <= 128;

// [BM][LD] Q rows, [S][kBK][LD] K and V tiles (bf16), [S][kBK] bias, S =
// kStages<DH>
template <int DH, int BM>
constexpr int smem_bytes() {
  return (BM + 2 * kStages<DH> * kBK) * kLdB<DH> * 2 + kStages<DH> * kBK * 4;
}

// a key below L and, under causal, at or before the row
__device__ __forceinline__ bool visible(int key, int row, int L, int causal) {
  return key < L && (!causal || key <= row);
}

// One key tile of keys [k0, k0 + kBK) from shared memory (ks, vs, bs: its
// K and V rows and its bias) for a warp's MT m16 row tiles, this thread's
// rows row0 + 16 mt + 8 h (held at r = 2 mt + h). MASK 2: test each
// score's key against L and, under causal, its row; MASK 1: its key against
// its row alone (a causal tile below L); DROP: zero p where the key's bias
// drops it. MASK 0 without DROP: the interior path, no index, compare or
// select. RAW (no bias, 0 < scale < 1e4): the scores are the products
// themselves, the max is taken on them and the scale goes into c; else s =
// product · scale + bias. Either way p = 2^(s c - fl(m c)), c = scale ·
// log2(e) (RAW) or log2(e).
// Q's A fragments come from ``qa`` (kQInRegs) or from the warp's rows of
// ``qs``; the tile's P·V takes V's columns [col0, col0 + kOutCols).
template <int DH, int MT, int MASK, bool DROP, bool RAW>
__device__ __forceinline__ void tile_step(
    const uint32_t (&qa)[MT][kQInRegs<DH> ? DH / 16 : 1][4],
    const bf16* qs, float (&oacc)[MT][kOutCols<DH> / 8][4],
    float (&m_r)[2 * MT], float (&l_r)[2 * MT], const bf16* ks,
    const bf16* vs, const float* bs, int k0, int L, int causal, int row0,
    float scale, float c, int col0, int lane) {
  constexpr int KS = DH / 16;  // k-steps of Q·K^T
  constexpr int NS = kBK / 8;  // 8-key tiles of S
  constexpr int NO = kOutCols<DH> / 8;  // 8-column tiles of O
  const int t = lane & 3;

  // S = Q K^T: sacc[mt][n] holds keys 8n + 2t, 8n + 2t + 1 of rows
  // 16 mt + g, 16 mt + g + 8
  float sacc[MT][NS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mt][n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (kQInRegs<DH>) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mt][i] = qa[mt][s][i];
      } else {
        load_a<DH>(a[mt], qs, 16 * mt, 16 * s, lane);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t b[4];
      load_b_rows<DH>(b, ks, 8 * n, 16 * s, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(sacc[mt][n], a[mt], b[0], b[1]);
        mma_bf16(sacc[mt][n + 1], a[mt], b[2], b[3]);
      }
    }
  }
  // the bias of this thread's 16 keys, once a tile
  float bb[NS][2];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float2 b2 = RAW ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
    bb[n][0] = b2.x;
    bb[n][1] = b2.y;
  }
  // scale and bias (masked scores to -1e30); the tile's row max
  float mx[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) mx[r] = kNegInf;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int row = row0 + 16 * mt + 8 * (e >> 1);
        float sv = RAW ? sacc[mt][n][e]
                       : fmaf(sacc[mt][n][e], scale, bb[n][e & 1]);
        if (MASK == 1) sv = key <= row ? sv : kNegInf;
        if (MASK == 2) sv = visible(key, row, L, causal) ? sv : kNegInf;
        sacc[mt][n][e] = sv;
        mx[2 * mt + (e >> 1)] = fmaxf(mx[2 * mt + (e >> 1)], sv);
      }
  // a row's p's share the rounding of m c (O's division cancels it; LSE
  // takes it back out), and alpha rescales the old sums by the change of
  // that same rounded value
  float ml[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
    ml[r] = __fmul_rn(m_new, c);
    const float alpha = ex2(__fmul_rn(m_r[r], c) - ml[r]);
    m_r[r] = m_new;
    l_r[r] *= alpha;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[r >> 1][n][2 * (r & 1)] *= alpha;
      oacc[r >> 1][n][2 * (r & 1) + 1] *= alpha;
    }
  }
  // the select, not the exponential, makes a masked or dropped key
  // exactly 0 (a fully masked slice has m == -1e30 and 2^0 == 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * mt + (e >> 1);
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int row = row0 + 16 * mt + 8 * (e >> 1);
        float p = ex2(fmaf(sacc[mt][n][e], c, -ml[r]));
        if (MASK == 1) p = key <= row ? p : 0.f;
        if (MASK == 2 || DROP) {
          const bool keep = (MASK != 2 || visible(key, row, L, causal)) &&
                            (RAW || bb[n][e & 1] > kBiasDrop);
          p = keep ? p : 0.f;
        }
        sacc[mt][n][e] = p;
        l_r[r] += p;
      }

  // O += bf16(P) V over the tile's four 16-key steps
#pragma unroll
  for (int s = 0; s < kBK / 16; ++s) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], sacc[mt], s);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t b[4];
      load_b_cols<DH>(b, vs, 16 * s, col0 + 8 * n, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(oacc[mt][n], a[mt], b[0], b[1]);
        mma_bf16(oacc[mt][n + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// NW warps of MT m16 row tiles each: NW · MT · 16 query rows a block; RAW
// as in tile_step. RAW at 16 rows a warp and DH <= 64 fits 168 registers,
// three blocks an SM (the causal LM's launch).
template <int DH, int NW, int MT, bool RAW>
__global__ void __launch_bounds__(NW * 32, RAW && MT == 1 && DH <= 64 ? 3 : 1)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ o, float* __restrict__ lse, int L,
                   int n_heads, float scale, int causal) {
  constexpr int kThreads = NW * 32;
  constexpr int RW = MT * 16;  // rows a warp
  constexpr int BM = NW * RW;  // rows a block
  constexpr int LD = kLdB<DH>;
  constexpr int KS = DH / 16;  // k-steps of Q·K^T
  constexpr int DO = kOutCols<DH>;  // O's columns this block owns
  constexpr int NO = DO / 8;   // 8-column tiles of O
  constexpr int S = kStages<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* Ks = Qs + BM * LD;                       // [S][kBK][LD]
  bf16* Vs = Ks + S * kBK * LD;                  // [S][kBK][LD]
  float* Bs = reinterpret_cast<float*>(Vs + S * kBK * LD);  // [S][kBK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, query tile), half)
  const int half = blockIdx.x % kHalves<DH>;
  const unsigned blk = blockIdx.x / kHalves<DH>;
  const int col0 = half * DO;
  const int tiles = (L + BM - 1) / BM;
  const int64_t bh = blk / tiles;
  const int q0 = (tiles - 1 - static_cast<int>(blk % tiles)) * BM;
  const int64_t off = bh * L * DH;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const float* brow = bias ? bias + (bh / n_heads) * L : nullptr;
  const int wq0 = q0 + warp * RW;  // the warp's first row
  // this thread's rows: wq0 + 16 mt + 8 h + g, held at r = 2 mt + h

  const int last_row = min(q0 + BM, L) - 1;
  const int nk = causal ? last_row / kBK + 1 : (L + kBK - 1) / kBK;
  const int warp_last = min(wq0 + RW - 1, L - 1);

  auto load_tile = [&](int buf, int j) {
    const int k0 = j * kBK;
    load_rows<DH, kBK, kThreads>(Ks + buf * kBK * LD, kb, k0, L, tid);
    load_rows<DH, kBK, kThreads>(Vs + buf * kBK * LD, vb, k0, L, tid);
    if (brow != nullptr)
      load_vec_f32<kThreads>(Bs + buf * kBK, brow, k0, kBK, L, tid);
  };

  // without a bias every path reads a bias of 0 (never dropped)
  if (brow == nullptr)
    for (int i = tid; i < S * kBK; i += kThreads) Bs[i] = 0.f;
  load_rows<DH, BM, kThreads>(Qs, q + off, q0, L, tid);
  cp_async_commit();
  // one commit group a tile (empty past the last), so that waiting for all
  // but the newest S - 1 groups waits for exactly the oldest tile
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) load_tile(j, j);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();
  __syncthreads();  // Q (and a zero bias) is in for every thread
  uint32_t qa[MT][kQInRegs<DH> ? KS : 1][4];
  if constexpr (kQInRegs<DH>) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int s = 0; s < KS; ++s)
        load_a<DH>(qa[mt][s], Qs, warp * RW + 16 * mt, 16 * s, lane);
  }
  const bf16* qw = Qs + warp * RW * LD;  // the warp's Q rows

  float oacc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][n][e] = 0.f;
  float m_r[2 * MT], l_r[2 * MT];  // row max (of s), partial sum
  const float c = RAW ? scale * kLog2e : kLog2e;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) m_r[r] = kNegInf, l_r[r] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int buf = j % S;
    // into the slot that tile j - 1 left (every warp finished it before
    // the barrier that ended the last iteration)
    if (j + S - 1 < nk) load_tile((j + S - 1) % S, j + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    const float* bs = Bs + buf * kBK;
    // does the tile drop a key? Each thread reads the bias values it
    // copied itself; the vote is also the barrier after which tile j is in
    // for every thread
    int dropped = 0;
    if (brow != nullptr)
      for (int i = tid; i < kBK; i += kThreads) dropped |= bs[i] <= kBiasDrop;
    dropped = __syncthreads_or(dropped);
    const int k0 = j * kBK;
    if (wq0 < L && (!causal || k0 <= warp_last)) {  // else nothing to see
      const bf16* ks = Ks + buf * kBK * LD;
      const bf16* vs = Vs + buf * kBK * LD;
      const bool inside = k0 + kBK <= L && (!causal || k0 + kBK - 1 <= wq0);
      const int row0 = wq0 + g;
      if (inside && !dropped)
        tile_step<DH, MT, 0, false, RAW>(qa, qw, oacc, m_r, l_r, ks, vs, bs,
                                         k0, L, causal, row0, scale, c, col0,
                                         lane);
      else if (inside)
        tile_step<DH, MT, 0, !RAW, RAW>(qa, qw, oacc, m_r, l_r, ks, vs, bs,
                                        k0, L, causal, row0, scale, c, col0,
                                        lane);
      else if (k0 + kBK <= L && !dropped)  // on the causal diagonal
        tile_step<DH, MT, 1, false, RAW>(qa, qw, oacc, m_r, l_r, ks, vs, bs,
                                         k0, L, causal, row0, scale, c, col0,
                                         lane);
      else
        tile_step<DH, MT, 2, !RAW, RAW>(qa, qw, oacc, m_r, l_r, ks, vs, bs,
                                        k0, L, causal, row0, scale, c, col0,
                                        lane);
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

  // O / l into the warp's own rows of Qs (read by no other warp, and by
  // this one no more), then out in 16-byte stores of whole rows
  bf16* os = Qs + warp * RW * LD;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const float sum = quad_sum(l_r[r]);
    const float l = fmaxf(sum, 1e-30f);
    const int lr = 16 * (r >> 1) + 8 * (r & 1) + g;  // row in the warp
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(os + lr * LD + 8 * n + 2 * t) =
          pack_bf16(oacc[r >> 1][n][2 * (r & 1)] * inv,
                    oacc[r >> 1][n][2 * (r & 1) + 1] * inv);
    const int row = wq0 + lr;
    if (t == 0 && row < L && half == 0) {
      // l sums 2^(s c - fl(m c)), fl(m c) = m c - err: a factor 2^err that
      // LSE takes back out (a row that kept no key keeps m + log(1e-30));
      // the natural max is m (m · scale for RAW, as the plain version
      // rounds it: scaling by a positive factor keeps the max)
      const float ml = __fmul_rn(m_r[r], c);
      const float err = sum > 0.f ? fmaf(m_r[r], c, -ml) : 0.f;
      const float m = RAW ? __fmul_rn(m_r[r], scale) : m_r[r];
      lse[bh * L + row] = m + logf(l) - kLn2 * err;
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < RW * NO; c += 32) {
    const int lr = c / NO, cc = (c % NO) * 8;
    if (wq0 + lr < L)
      *reinterpret_cast<uint4*>(o + off + static_cast<int64_t>(wq0 + lr) * DH +
                                col0 + cc) =
          *reinterpret_cast<const uint4*>(os + lr * LD + cc);
  }
}

// The launch's shape: NW warps of MT m16 row tiles a block, and RAW. The
// first of these whose blocks (two a row tile at DH 256) give each of the
// card's 132 SMs one, else the last: at DH <= 64 without causal 4 x 32
// rows (MT 2), 2 x 32, 2 x 16, 1 x 16; else 4 x 16, 2 x 16, 1 x 16 (at DH
// 128 32 rows a warp would not fit 255 registers; under causal a 64-row
// block loses less to the diagonal, and three fit an SM). RAW where there
// is no bias and 0 < scale < 1e4, at 16 rows a warp (at 32 it spills).
// At DH 256 a block has 2 warps at least: one warp copying its 256-wide
// tiles alone spills.
struct Plan {
  int nw, mt;
  bool raw;
};

Plan plan_for(int64_t bh, int64_t L, int64_t dh, int causal, bool biased,
              float scale) {
  const bool wide = dh <= 64 && !causal;
  const bool raw = !biased && scale > 0.f && scale < 1e4f;
  const int least = dh > 128 ? 2 : 1;  // warps a block
  const Plan plans[4] = {{4, wide ? 2 : 1, raw && !wide},
                         {2, wide ? 2 : 1, raw && !wide},
                         {wide ? 2 : least, 1, raw},
                         {least, 1, raw}};
  const int64_t halves = dh > 128 ? 2 : 1;
  for (const Plan& p : plans) {
    const int64_t rows = p.nw * p.mt * 16;
    if (bh * halves * ((L + rows - 1) / rows) >= kSms) return p;
  }
  return plans[3];
}

template <int DH, int NW, int MT, bool RAW>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias,
           bf16* o, float* lse, int64_t bh, int64_t L, int n_heads,
           float scale, int causal, cudaStream_t stream) {
  constexpr int BM = NW * MT * 16;
  constexpr int bytes = smem_bytes<DH, BM>();
  // once per instantiation (idempotent, so a racing second call is
  // harmless); keeping it out of later launches lets them be captured in
  // CUDA graphs
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<DH, NW, MT, RAW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t blocks = bh * ((L + BM - 1) / BM) * kHalves<DH>;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_bf16<DH, NW, MT, RAW>
      <<<static_cast<unsigned>(blocks), NW * 32, bytes, stream>>>(
          q, k, v, bias, o, lse, static_cast<int>(L), n_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool RAW>
int launch_rows(Plan p, const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* o, float* lse, int64_t bh, int64_t L,
                int n_heads, float scale, int causal, cudaStream_t s) {
  if constexpr (DH <= 64 && !RAW) {
    if (p.mt == 2 && p.nw == 4)
      return launch<DH, 4, 2, false>(q, k, v, bias, o, lse, bh, L, n_heads,
                                     scale, causal, s);
    if (p.mt == 2)
      return launch<DH, 2, 2, false>(q, k, v, bias, o, lse, bh, L, n_heads,
                                     scale, causal, s);
  }
  if (p.nw == 4)
    return launch<DH, 4, 1, RAW>(q, k, v, bias, o, lse, bh, L, n_heads,
                                 scale, causal, s);
  if (p.nw == 2 || DH > 128)  // DH 256 has no 1-warp plan
    return launch<DH, 2, 1, RAW>(q, k, v, bias, o, lse, bh, L, n_heads,
                                 scale, causal, s);
  if constexpr (DH <= 128)
    return launch<DH, 1, 1, RAW>(q, k, v, bias, o, lse, bh, L, n_heads,
                                 scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int launch_plan(Plan p, const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* o, float* lse, int64_t bh, int64_t L,
                int n_heads, float scale, int causal, cudaStream_t s) {
  return p.raw ? launch_rows<DH, true>(p, q, k, v, bias, o, lse, bh, L,
                                       n_heads, scale, causal, s)
               : launch_rows<DH, false>(p, q, k, v, bias, o, lse, bh, L,
                                        n_heads, scale, causal, s);
}

}  // namespace

// The plan a launch with these arguments takes: plan[0] query rows a block,
// plan[1] a warp, plan[2] 1 where the scores are the raw products (no bias,
// 0 < scale < 1e4). Returns cudaErrorInvalidValue for a head width the
// kernel does not take.
extern "C" int ptt_flash_attn_bf16_fwd_plan(int64_t bh, int64_t L,
                                            int64_t dh, int causal,
                                            int biased, float scale,
                                            int* plan) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128 && dh != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(bh, L, dh, causal, biased != 0, scale);
  plan[0] = p.nw * p.mt * 16;
  plan[1] = p.mt * 16;
  plan[2] = p.raw;
  return 0;
}

// q, k, v, o [bh, L, dh] bf16 and lse [bh, L] float32, all contiguous and
// q, k, v 16-byte aligned; dh in {16, 32, 64, 128, 256}; bias null or
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
  const Plan p = plan_for(bh, L, dh, causal, bias != nullptr, scale);
  switch (dh) {
    case 16:
      return launch_plan<16>(p, qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 32:
      return launch_plan<32>(p, qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 64:
      return launch_plan<64>(p, qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                             causal, s);
    case 128:
      return launch_plan<128>(p, qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                              causal, s);
    case 256:
      return launch_plan<256>(p, qp, kp, vp, bp, op, lp, bh, L, nh, scale,
                              causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
