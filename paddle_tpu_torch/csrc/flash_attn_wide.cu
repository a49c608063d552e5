// Flash attention at head widths above 256: forward (O, LSE), dQ, and dK
// with dV, over q, k, v, dO [BH, L, DP] in f32 or bf16 with f32 sums,
// where DP is the head width zero-padded to a multiple of 128 (the wrapper
// pads and slices back: a zero column adds 0 to every score and gives 0
// output columns). The arithmetic is that of the narrower flash kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu and their bf16 forms): an optional
// causal mask (key j > query i dropped) and an optional per-key bias
// [B, L] added to the scaled scores (row b of the [BH, ...] operands reads
// bias row b / n_heads); masked entries and keys whose bias is -1e8 or
// lower get exactly zero probability by a select; a row whose keys are all
// dropped ends with O = 0 and LSE = m + log(1e-30).
//   forward: online softmax over key tiles, O = sum_j p_j v_j / l,
//            LSE = m + log(l);
//   dQ:      P = exp(S - LSE), dS = P (dO V^T - delta) scale, dQ = dS K;
//   dK/dV:   dK = dS^T Q, dV = P^T dO.
// In the bf16 form P and dS are rounded to bf16 before their products and
// O, dQ, dK and dV are stored in bf16; the scores, the softmax state and
// LSE stay f32.
//
// Replaces paddle_tpu/ops/attention_ops.py `_flash_fwd_pallas` (kernel body
// `_fwd_kernel`) and `_flash_bwd_pallas` (`_bwd_dq_kernel`,
// `_bwd_dkv_kernel`) at head widths above 256, where the Pallas blocks span
// the whole head width. The narrower kernels keep their Q, O and
// accumulator fragments in registers over the full width; above 256 no
// register budget holds them, so these kernels own 128-wide column chunks
// of their outputs and stream the head width through shared memory.
//
// Bound on an H100: a visible (query, key) pair costs 4·DH flops forward,
// 6·DH for dQ and 8·DH for dK/dV against 16·DH bytes a row (half that in
// bf16): at L 512, causal, f32 is bound by operations (3xTF32 at 165
// TFLOP/s) and bf16 by bytes (989 TFLOP/s against 3.35 TB/s).
//
// All three kernels run their products on the tensor cores with mma.sync:
// the f32 form in 3xTF32 (m16n8k8, as flash_attn_fwd.cu; 165 TFLOP/s
// effective), the bf16 form as m16n8k16 with f32 sums (as
// flash_attn_bf16_fwd.cu).
// The forward's block has four warps and 16 query rows, and computes the
// scores once for a group of up to four 128-wide column chunks of O:
// - S = Q K^T over the whole width is split by depth: warp w takes the
//   128-column chunks w, w + 4, ... of Q and K, so that at DH 512 each warp
//   takes one and the scores cost 4·DH flops a visible pair, not the
//   10·DH of one block a column chunk. Each warp puts its partial S tile
//   (16 queries x 32 keys) into shared memory; after one barrier a tile,
//   every warp that owns a column chunk sums the partials in warp order
//   (the same bits in every warp) and runs the online softmax itself, so
//   P reaches its products from registers, with no second barrier.
// - Warp w owns O's column chunk 4 group + w for the block's 16 rows: 64
//   f32 accumulators a thread, the narrow kernels' DH-128 budget. The f32
//   form adds each tile's P V, summed in a fresh fragment, to O with
//   rounded FMAs (the tensor cores' f32 sums truncate; a chain over the
//   whole key loop would bias O as L grows), and each warp's S partial in a
//   fresh fragment a 128-column chunk for the same reason.
// - Nothing is sized by the width: each warp streams its own K and Q
//   columns (32 keys x 32 columns of K and 16 rows of Q in f32, 64 columns
//   in bf16) and then the V slab of its chunk (the same widths) through a
//   private two-slot cp.async ring in shared memory (the next unit loads
//   while this one computes), rows padded so that the fragment reads
//   (ldmatrix in bf16) are conflict-free; V is read once a key tile for
//   the whole group. The block holds 72 KB (f32) or 74 KB (bf16) of
//   shared memory at any width, and 165-168 registers a thread: three
//   blocks an SM. The loads, not the products, bound it: 16-row query
//   tiles read K and V again for every 16 rows, and the kernel runs near
//   the L2 cache's rate (PERF.md); 32-row blocks of eight warps, which
//   halve that traffic, ran faster in bf16 but slower in f32 and at small
//   grids, at two fewer blocks an SM.
// - The softmax runs in base 2, as flash_attn_bf16_fwd.cu's does: p =
//   2^((s - m) log2 e) by `ex2.approx`, and LSE = m + log(l).
// - Above four chunks (DH > 512) further blocks take the next groups and
//   compute the scores again, once a group; a warp without a column chunk
//   in the last group still takes its share of the scores (at DH 384 the
//   fourth warp has neither, and its partial is zeros).
// - Causal key tiles wholly above the block's last query are skipped; a
//   head's query tiles run last first (the heaviest under causal), and the
//   groups of a query tile are neighbours on the grid, sharing its Q and K
//   in L2; blocks are numbered on gridDim.x alone, so BH may exceed 65535.
// dQ and dK/dV take the forward's structure, in one kernel template: a
// block owns kRows = 16 rows (queries for dQ, keys for dK/dV) and one group
// of up to four column chunks of its outputs, and steps over tiles of kBK =
// 32 rows (keys for dQ, queries for dK/dV). It has eight warps. Per tile
// warps 0-3 compute the score tile S = Q K^T (S^T = K Q^T for dK/dV) and
// warps 4-7 dP = dO V^T (dP^T = V dO^T), both split by depth as the
// forward's scores are (warp w and 4 + w take depth chunks w, w + 4, ...),
// and leave their partial tiles in shared memory; after one barrier a warp
// that owns an output chunk sums the partials in warp order, forms P = 2^((s
// - LSE) log2 e) (0 by a select where masked or dropped) and, for dQ and
// dK, dS = P (dP - delta) scale itself, and adds its chunk's product, P or
// dS reaching the tensor cores as A fragments read from the summed tiles.
// Warp w owns chunk 4 group + w of dQ (dQ += dS K) or of dK (dK += dS^T Q);
// for dK/dV warp 4 + w owns that chunk of dV (dV += P^T dO): 64 f32
// accumulators a thread, where one warp owning both dK and dV of a chunk
// would hold 128. So at DH 512 dQ costs 6·DH flops a visible pair and dK/dV
// 8·DH, not the 18·DH and 20·DH of one block a column chunk.
// - The output operand is the owning warp's own tile operand over its output
//   chunk (K for dQ, Q for dK, dO for dV), and that chunk is one of the
//   warp's depth chunks: the warp works it last and keeps its units in
//   shared memory for the output product, which so reads nothing from L2
//   (at L 512, DH 512, BH 64 that took dK/dV from 1.43 to 1.26 ms (f32)
//   and from 0.66 to 0.54 (bf16), and dQ, with its move from four warps
//   that each computed S and dP to this shape, from 1.05 to 0.99 and from
//   0.48 to 0.42; PERF.md). In bf16 a chunk's two A units (the block's own
//   rows) fit their two slots, so a warp with one depth chunk (DP <= 512)
//   loads them at its first tile only (there dK/dV 0.54 -> 0.44 ms, dQ
//   0.42 -> 0.38); in f32 four units do not fit beside the kept B units.
// - Each warp streams its units through its own cp.async ring, one unit
//   ahead (two ahead made f32 slower at the registers it took); rows are
//   padded so that the score products' fragment reads are conflict-free
//   (the f32 output product's N-major reads of the kept units conflict two
//   ways); ldmatrix in bf16. The block holds 216 KB (f32) or 148 KB (bf16)
//   of shared memory at any width, one block an SM.
// - The f32 form sums each 128-column chunk of a partial and each tile's
//   product in a fresh fragment, added by rounded FADDs (dK and dV sum L /
//   32 query tiles, dQ L / 32 key tiles; a chain of tensor-core sums
//   truncates).
// - What bounds them is the loads: at DH 512 a form that ran two units
//   ahead took 24-26% (f32) and 38-39% (bf16) less time with no loads at
//   all, and 1-11% less with no barrier; one block of eight warps an SM
//   hides little of either.
// - Under causal dQ skips the key tiles wholly after its last query and
//   dK/dV the query tiles wholly before its first key; a head's heaviest
//   tiles run first (dQ's last query tiles, dK/dV's first key tiles).
// Every output element has one owner and a fixed summation order, with no
// atomics: two calls give the same bits. Only group 0's warp 0 of the
// forward writes LSE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace ptt;

// rows a block owns: queries (forward, dQ) or keys (dK/dV)
constexpr int kRows = 16;
constexpr int kCols = 128;  // columns an output chunk
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr float kLog2e = 1.4426950408889634f;

// one score of a (query, key) pair: the scaled and biased score (-1e30
// where the pair is masked) and whether the pair keeps a probability
struct Score {
  float x;
  bool keep;
};

__device__ __forceinline__ Score score(float s, int query, int key, int L,
                                       int causal, const float* brow,
                                       float scale) {
  const bool vis = query < L && key < L && (!causal || key <= query);
  float x = s * scale;
  bool keep = vis;
  if (brow != nullptr && key < L) {
    const float bv = brow[key];
    x += bv;
    keep = keep && bv > kBiasDrop;
  }
  return Score{vis ? x : kNegInf, keep};
}

// The forward's block: kGroup warps, one a column chunk of O, and kRows
// query rows; key tiles of kBK; each warp's ring of kSlots staged units,
// each in a slot of kSlotBytes
constexpr int kGroup = 4;
constexpr int kBK = 32;
constexpr int kSlots = 2;
constexpr int kSlotBytes = 6912;

// Per form: kDS, the head columns of a staged unit (K and Q, or V); the
// row strides of K and Q (kLdKQ) and of V (kLdV) in a unit, and of the
// score partials (kLdS), which put each fragment read in distinct banks
// (in bf16 the eight 16-byte rows of an ldmatrix)
template <typename T>
struct Form;
template <>
struct Form<float> {
  static constexpr int kDS = 32, kLdKQ = kDS + 4, kLdV = kDS + 8;
  static constexpr int kLdS = kBK + 4;  // read in the m16n8k8 A layout
};
template <>
struct Form<bf16> {
  static constexpr int kDS = 64, kLdKQ = kLdB<64>, kLdV = kLdB<64>;
  static constexpr int kLdS = kBK + 8;  // read as float2 pairs of keys
};

template <typename T>
constexpr int fwd_smem_bytes() {
  return kGroup * kSlots * kSlotBytes +
         2 * kGroup * kRows * Form<T>::kLdS * 4;
}

// One warp's staged units, in the order the warp works them: per key tile
// its K and Q units (32 keys of K and the block's 16 rows of Q over kDS
// columns of its depth chunks w, w + 4, ...), then, when it owns a column
// chunk of O, that chunk's V units (32 keys over kDS columns). Rows past L
// load as zeros. `next` hands out the oldest unit once it has landed and
// starts the one kSlots - 1 ahead in the slot the last one freed.
template <typename T>
struct Ring {
  static constexpr int kE = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kUnits = kCols / Form<T>::kDS;  // units a chunk
  T* slots;
  const T *q, *k, *v;  // the head's operands at the lane's copy column
  int L, dp, q0, warp, oc, nkq, nu, nk;
  int rr, cc;          // the lane's first row and its column in a unit
  int j = 0, i = 0;    // the next unit to start: unit i of key tile j
  int slot = 0;        // the slot of the next unit to hand out

  // rows r0, r0 + 4, ... (N of them) of one column of a [L, dp] operand
  template <int N>
  __device__ __forceinline__ void rows(T* dst, int ld, const T* src,
                                       int r0) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int r = r0 + 4 * n;
      const bool in = r < L;
      cp_async16(dst + 4 * n * ld,
                 in ? src + static_cast<int64_t>(r) * dp : src, in);
    }
  }

  __device__ __forceinline__ void start(T* dst) {
    if (j < nk) {
      constexpr int LD = Form<T>::kLdKQ, LDV = Form<T>::kLdV;
      const int k0 = j * kBK;
      if (i < nkq) {
        const int d = (warp + kGroup * (i / kUnits)) * kCols +
                      (i % kUnits) * Form<T>::kDS;
        rows<kBK / 4>(dst + rr * LD + cc, LD, k + d, k0 + rr);
        rows<kRows / 4>(dst + (kBK + rr) * LD + cc, LD, q + d, q0 + rr);
      } else {
        rows<kBK / 4>(dst + rr * LDV + cc, LDV,
                      v + oc + (i - nkq) * Form<T>::kDS, k0 + rr);
      }
      if (++i == nu) i = 0, ++j;
    }
    cp_async_commit();  // one group a unit, empty past the last
  }

  static constexpr int kSlot = kSlotBytes / sizeof(T);  // elements a slot
  static_assert((kBK + kRows) * Form<T>::kLdKQ <= kSlot &&
                    kBK * Form<T>::kLdV <= kSlot,
                "a unit outgrows its slot");

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int s = 0; s < kSlots - 1; ++s) start(slots + s * kSlot);
  }

  __device__ __forceinline__ const T* next() {
    __syncwarp();  // every lane is done with the slot the last unit held
    start(slots + (slot == 0 ? kSlots - 1 : slot - 1) * kSlot);
    cp_async_wait<kSlots - 1>();
    __syncwarp();  // the unit is in for every lane
    const T* unit = slots + slot * kSlot;
    slot = slot == kSlots - 1 ? 0 : slot + 1;
    return unit;
  }
};

// sc[n] += Q K^T over one K and Q unit (K's kBK rows at `unit`, Q's kRows
// at `qs`): keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8 (the accumulator
// layout), 3xTF32
__device__ __forceinline__ void unit_scores(float (&sc)[kBK / 8][4],
                                            const float* unit,
                                            const float* qs, int lane) {
  constexpr int LD = Form<float>::kLdKQ;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < Form<float>::kDS / 8; ++s) {
    // A = Q: a0 (row g, col 8s + t), a1 (row g + 8), a2 (col + 4), a3
    uint32_t ab[4], as[4];
    const float* qp = qs + g * LD + 8 * s + t;
    split_tf32(qp[0], ab[0], as[0]);
    split_tf32(qp[8 * LD], ab[1], as[1]);
    split_tf32(qp[4], ab[2], as[2]);
    split_tf32(qp[8 * LD + 4], ab[3], as[3]);
    // B = K^T: b0 (col 8s + t, key 8n + g), b1 (col + 4)
    uint32_t bb[kBK / 8][2], bs[kBK / 8][2];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float* kp = unit + (8 * n + g) * LD + 8 * s + t;
      split_tf32(kp[0], bb[n][0], bs[n][0]);
      split_tf32(kp[4], bb[n][1], bs[n][1]);
    }
    mma_3xtf32<kBK / 8>(sc, ab, as, bb, bs);
  }
}

// the same in bf16 (m16n8k16, f32 sums)
__device__ __forceinline__ void unit_scores(float (&sc)[kBK / 8][4],
                                            const bf16* unit,
                                            const bf16* qs, int lane) {
#pragma unroll
  for (int s = 0; s < Form<bf16>::kDS / 16; ++s) {
    uint32_t a[4];
    load_a<64>(a, qs, 0, 16 * s, lane);
#pragma unroll
    for (int n = 0; n < kBK / 8; n += 2) {
      uint32_t b[4];
      load_b_rows<64>(b, unit, 8 * n, 16 * s, lane);
      mma_bf16(sc[n], a, b[0], b[1]);
      mma_bf16(sc[n + 1], a, b[2], b[3]);
    }
  }
}

// the same over one forward unit, Q's rows right after K's
template <typename T>
__device__ __forceinline__ void unit_scores(float (&sc)[kBK / 8][4],
                                            const T* unit, int lane) {
  unit_scores(sc, unit, unit + kBK * Form<T>::kLdKQ, lane);
}

// The softmax state of this thread's rows g (h = 0) and g + 8 (h = 1)
struct Rows {
  float m[2], l[2];
};

// One key tile of a warp that owns a column chunk, f32 form: the summed
// scores (read in the A layout of m16n8k8: [s][e] is row g + 8 (e & 1),
// key 8s + t + 4 (e >> 1)), the online softmax, and O = alpha O + P V over
// the chunk's V units, each unit's product in a fresh fragment
__device__ __forceinline__ void tile_pv(float (&oacc)[kCols / 8][4],
                                        Rows& st, const float* sp,
                                        Ring<float>& ring, int k0, int q0,
                                        int L, int causal, const float* brow,
                                        float scale, int lane) {
  constexpr int LDS = Form<float>::kLdS, LDV = Form<float>::kLdV;
  constexpr int NS = kBK / 8;
  const int g = lane >> 2, t = lane & 3;
  float x[NS][4];
  uint32_t keep = 0;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (g + 8 * (e & 1)) * LDS + 8 * s + t + 4 * (e >> 1);
      float sum = sp[at];
#pragma unroll
      for (int w = 1; w < kGroup; ++w) sum += sp[w * kRows * LDS + at];
      const Score sc = score(sum, q0 + g + 8 * (e & 1),
                             k0 + 8 * s + t + 4 * (e >> 1), L, causal, brow,
                             scale);
      x[s][e] = sc.x;
      keep |= static_cast<uint32_t>(sc.keep) << (4 * s + e);
      mx[e & 1] = fmaxf(mx[e & 1], sc.x);
    }
  float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(st.m[h], quad_max(mx[h]));
    alpha[h] = ex2((st.m[h] - mn) * kLog2e);
    st.m[h] = mn;
  }
  uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          (keep >> (4 * s + e)) & 1 ? ex2((x[s][e] - st.m[e & 1]) * kLog2e)
                                  : 0.f;
      psum[e & 1] += p;
      split_tf32(p, pb[s][e], ps[s][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    st.l[h] = st.l[h] * alpha[h] + quad_sum(psum[h]);
#pragma unroll
  for (int u = 0; u < kCols / Form<float>::kDS; ++u) {
    constexpr int NO = Form<float>::kDS / 8;  // 8-column tiles a unit
    const float* vs = ring.next();
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      // B = V: b0 (key 8s + t, column 8n + g), b1 (key + 4)
      uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float* vp = vs + (8 * s + t) * LDV + 8 * n + g;
        split_tf32(vp[0], bb[n][0], bs[n][0]);
        split_tf32(vp[4 * LDV], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<NO>(pv, pb[s], ps[s], bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[NO * u + n][e] =
            fmaf(oacc[NO * u + n][e], alpha[e >> 1], pv[n][e]);
  }
}

// The same in bf16: the summed scores in the accumulator layout ([n][e]
// is row g + 8 (e >> 1), key 8n + 2t + (e & 1)), P rounded to bf16 into
// the A fragments of m16n8k16 in registers, O rescaled and summed in place
__device__ __forceinline__ void tile_pv(float (&oacc)[kCols / 8][4],
                                        Rows& st, const float* sp,
                                        Ring<bf16>& ring, int k0, int q0,
                                        int L, int causal, const float* brow,
                                        float scale, int lane) {
  constexpr int LDS = Form<bf16>::kLdS;
  constexpr int NS = kBK / 8;
  const int g = lane >> 2, t = lane & 3;
  float x[NS][4];
  uint32_t keep = 0;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (g + 8 * h) * LDS + 8 * n + 2 * t;
      float2 sum = *reinterpret_cast<const float2*>(sp + at);
#pragma unroll
      for (int w = 1; w < kGroup; ++w) {
        const float2 y =
            *reinterpret_cast<const float2*>(sp + w * kRows * LDS + at);
        sum.x += y.x;
        sum.y += y.y;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Score sc = score(c ? sum.y : sum.x, q0 + g + 8 * h,
                               k0 + 8 * n + 2 * t + c, L, causal, brow,
                               scale);
        x[n][2 * h + c] = sc.x;
        keep |= static_cast<uint32_t>(sc.keep) << (4 * n + 2 * h + c);
        mx[h] = fmaxf(mx[h], sc.x);
      }
    }
  float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(st.m[h], quad_max(mx[h]));
    alpha[h] = ex2((st.m[h] - mn) * kLog2e);
    st.m[h] = mn;
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          (keep >> (4 * n + e)) & 1 ? ex2((x[n][e] - st.m[e >> 1]) * kLog2e)
                                  : 0.f;
      psum[e >> 1] += p;
      x[n][e] = p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    st.l[h] = st.l[h] * alpha[h] + quad_sum(psum[h]);
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int s = 0; s < kBK / 16; ++s) pack_a(pa[s], x, s);
#pragma unroll
  for (int u = 0; u < kCols / Form<bf16>::kDS; ++u) {
    constexpr int NO = Form<bf16>::kDS / 8;
    const bf16* vs = ring.next();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        load_b_cols<64>(b, vs, 16 * s, 8 * n, lane);
        mma_bf16(oacc[NO * u + n], pa[s], b[0], b[1]);
        mma_bf16(oacc[NO * u + n + 1], pa[s], b[2], b[3]);
      }
  }
}

template <typename T>
__global__ void
    flash_wide_fwd(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ o, float* __restrict__ lse, int L, int dp,
                   int n_heads, float scale, int causal) {
  constexpr int LDS = Form<T>::kLdS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [kGroup][kSlots] unit slots, then [2][kGroup][kRows][LDS] S partials
  float* Sp = reinterpret_cast<float*>(smem_raw +
                                       kGroup * kSlots * kSlotBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks numbered ((bh, query tile), group), a head's tiles last first
  const int nc = dp / kCols, groups = (nc + kGroup - 1) / kGroup;
  const int group = static_cast<int>(blockIdx.x % groups);
  const unsigned rest = blockIdx.x / groups;
  const int tiles = (L + kRows - 1) / kRows;
  const int64_t bh = rest / tiles;
  const int q0 = (tiles - 1 - static_cast<int>(rest % tiles)) * kRows;
  const int64_t off = bh * L * dp;
  const float* brow = bias ? bias + (bh / n_heads) * L : nullptr;
  const int last = min(q0 + kRows, L) - 1;
  const int nk = causal ? last / kBK + 1 : (L + kBK - 1) / kBK;
  // the warp's depth chunks w, w + 4, ..., and its column chunk of O
  const int nd = warp < nc ? (nc - 1 - warp) / kGroup + 1 : 0;
  const int oc = (group * kGroup + warp) * kCols;
  const bool owns = oc < dp;
  const int cc = (lane & 7) * Ring<T>::kE;
  Ring<T> ring;
  ring.slots = reinterpret_cast<T*>(smem_raw + warp * kSlots * kSlotBytes);
  ring.q = q + off + cc;
  ring.k = k + off + cc;
  ring.v = v + off + cc;
  ring.L = L;
  ring.dp = dp;
  ring.q0 = q0;
  ring.warp = warp;
  ring.oc = oc;
  ring.nkq = nd * Ring<T>::kUnits;
  ring.nu = ring.nkq + (owns ? Ring<T>::kUnits : 0);
  ring.nk = ring.nu > 0 ? nk : 0;
  ring.rr = lane >> 3;
  ring.cc = cc;
  ring.begin();

  float oacc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  Rows st{{kNegInf, kNegInf}, {0.f, 0.f}};

  for (int j = 0; j < nk; ++j) {
    // this warp's partial S over its depth chunks, a fresh fragment a chunk
    float sacc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
    for (int c = 0; c < nd; ++c) {
      float sc[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      for (int u = 0; u < Ring<T>::kUnits; ++u)
        unit_scores(sc, ring.next(), lane);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] += sc[n][e];
    }
    // partials of tile j in buffer j & 1 (zeros from a warp without a
    // depth chunk): a warp writes tile j + 2's only after the barrier of
    // tile j + 1, which every warp reaches after its reads of tile j
    float* sp = Sp + (j & 1) * kGroup * kRows * LDS;
    float* mine = sp + warp * kRows * LDS;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (g + 8 * h) * LDS + 8 * n +
                                   2 * t) =
            make_float2(sacc[n][2 * h], sacc[n][2 * h + 1]);
    __syncthreads();
    if (owns)
      tile_pv(oacc, st, sp, ring, j * kBK, q0, L, causal, brow, scale,
              lane);
  }
  if (!owns) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    if (row >= L) continue;
    const float l = fmaxf(st.l[h], 1e-30f);
    T* orow = o + off + static_cast<int64_t>(row) * dp + oc;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const float a = oacc[n][2 * h] / l, b = oacc[n][2 * h + 1] / l;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pack_bf16(a, b);
    }
    if (group == 0 && warp == 0 && t == 0)
      lse[bh * L + row] = st.m[h] + logf(l);
  }
}

// One backward warp's staged units, in the order the warp works them: per
// tile of kBK rows (keys for dQ, queries for dK/dV), a unit for each kDS
// columns of each of its depth chunks w, w + 4, ...: kBK rows of its score
// product's tile operand B and the block's kRows rows of the block operand
// A (laid out as the forward's K and Q units). A warp that owns an output
// chunk works that depth chunk last: its B units there are the output
// operand over the output chunk (K for dQ, Q for dK, dO for dV), and they
// stay in shared memory for the tile's output product, handed out once
// more as the tile's output units. So B units take kUnits slots (the
// unit's column in its chunk picks the slot) and A units two; in bf16 a
// chunk has two units, and a warp with one depth chunk (DP <= 512) loads
// its A units, the same every tile, at its first tile only. Rows past L
// load as zeros. `next` hands out the oldest unit once it has landed and
// starts the next one (its slots were freed by the units before the one
// handed out).
template <typename T>
struct BwdRing {
  static constexpr int kE = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kUnits = kCols / Form<T>::kDS;  // units a chunk
  static constexpr int LD = Form<T>::kLdKQ;
  static constexpr int kB = kBK * LD, kA = kRows * LD;  // elements a slot
  static constexpr int kBytes = (kUnits * kB + 2 * kA) * sizeof(T);
  T* slots;           // [kUnits] B slots, then [2] A slots
  const T *b, *a;     // the head's B and A at the lane's copy column
  int L, dp, r0, dc;  // dc: the warp's first depth chunk
  int nd, om;         // depth chunks; the output chunk's place among them
                      // (-1: none)
  int nkq, nu, nt;    // score units and all units a tile; the tiles' end
  int ja;             // bf16: the last tile that loads A units
  int rr, cc;         // the lane's first row and its column in a unit
  int j, i = 0;       // the next unit to start: unit i of tile j
  int h = 0;          // the unit of its tile to hand out next

  struct Unit {
    const T *b, *a;
  };

  // rows r0, r0 + 4, ... (N of them) of one column of a [L, dp] operand
  template <int N>
  __device__ __forceinline__ void rows(T* dst, const T* src, int r0) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int r = r0 + 4 * n;
      const bool in = r < L;
      cp_async16(dst + 4 * n * LD,
                 in ? src + static_cast<int64_t>(r) * dp : src, in);
    }
  }

  // the ring for tiles [j0, j1); `ja` follows from nd
  __device__ __forceinline__ void begin(int j0, int j1) {
    j = j0;
    nt = nu > 0 ? j1 : 0;
    ja = kUnits == 2 && nd == 1 ? j0 : j1;
    start();
  }

  __device__ __forceinline__ void start() {
    if (j < nt) {
      if (i < nkq) {  // an output unit is already in
        const int c = i / kUnits, u = i % kUnits;
        const int m = om < 0 ? c : c == nd - 1 ? om : c + (c >= om);
        const int d = (dc + kGroup * m) * kCols + u * Form<T>::kDS;
        rows<kBK / 4>(slots + u * kB + rr * LD + cc, b + d, j * kBK + rr);
        if (kUnits != 2 || j <= ja)
          rows<kRows / 4>(slots + kUnits * kB + (i & 1) * kA + rr * LD + cc,
                          a + d, r0 + rr);
      }
      if (++i == nu) i = 0, ++j;
    }
    cp_async_commit();  // one group a unit, empty for an output unit
  }

  __device__ __forceinline__ Unit next() {
    __syncwarp();  // every lane is done with the units before the last
    start();
    cp_async_wait<1>();
    __syncwarp();  // the unit is in for every lane
    const Unit unit{slots + (h % kUnits) * kB,
                    slots + kUnits * kB + (h & 1) * kA};
    if (++h == nu) h = 0;
    return unit;
  }
};

// sacc += one depth chunk's partial scores (a fresh fragment over its
// kUnits units: the tensor cores' f32 sums truncate)
template <typename T>
__device__ __forceinline__ void chunk_scores(float (&sacc)[kBK / 8][4],
                                             BwdRing<T>& ring, int lane) {
  float sc[kBK / 8][4];
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
  for (int u = 0; u < BwdRing<T>::kUnits; ++u) {
    const typename BwdRing<T>::Unit unit = ring.next();
    unit_scores(sc, unit.b, unit.a, lane);
  }
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] += sc[n][e];
}

// a warp's partial tile into its shared-memory rows (row g + 8 h, columns
// 8 n + 2 t and + 1: the accumulator layout)
template <int LDS>
__device__ __forceinline__ void put_partial(float* mine,
                                            const float (&sacc)[kBK / 8][4],
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(mine + (g + 8 * h) * LDS + 8 * n + 2 * t) =
          make_float2(sacc[n][2 * h], sacc[n][2 * h + 1]);
}

// What a backward warp needs to form P and dS of a pair: the bias row (null
// when none), the head's LSE and delta [L], and the call's constants
struct Grad {
  const float* brow;
  const float* lse;
  const float* delta;
  int L, causal;
  float scale;
};

// P, or with GRAD dS = P (dP - delta) scale, of a (query, key) pair from
// its summed S and dP: P = 2^((s - LSE) log2 e), exactly 0 by a select
// where the pair is masked or the key dropped (in a row whose keys are all
// dropped LSE is about -1e9, and the exponential alone would be ~e^69)
template <bool GRAD>
__device__ __forceinline__ float p_or_ds(float s, float dpv, int query,
                                         int key, const Grad& gr) {
  const Score sc = score(s, query, key, gr.L, gr.causal, gr.brow, gr.scale);
  if (!sc.keep) return 0.f;
  const float p = ex2((sc.x - gr.lse[query]) * kLog2e);
  return GRAD ? p * (dpv - gr.delta[query]) * gr.scale : p;
}

// The f32 form's A operand of a tile's product, P or (GRAD) dS, in the
// m16n8k8 A layout ([s][e]: row r0 + g + 8 (e & 1), column c0 + 8 s + t +
// 4 (e >> 1)) from the summed partials (S at sp, dP at dpp; the kGroup
// partials of each kRows x LDS apart, summed in warp order), split for
// 3xTF32. DQ: the rows are queries and the columns keys; else the rows
// are keys and the columns queries.
template <bool DQ, bool GRAD>
__device__ __forceinline__ void operand(uint32_t (&ab)[kBK / 8][4],
                                        uint32_t (&as)[kBK / 8][4],
                                        const float* sp, const float* dpp,
                                        int r0, int c0, const Grad& gr,
                                        int lane) {
  constexpr int LDS = Form<float>::kLdS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (g + 8 * (e & 1)) * LDS + 8 * s + t + 4 * (e >> 1);
      float sum = sp[at], dsum = 0.f;
#pragma unroll
      for (int w = 1; w < kGroup; ++w) sum += sp[w * kRows * LDS + at];
      if (GRAD) {
        dsum = dpp[at];
#pragma unroll
        for (int w = 1; w < kGroup; ++w) dsum += dpp[w * kRows * LDS + at];
      }
      const int row = r0 + g + 8 * (e & 1);
      const int col = c0 + 8 * s + t + 4 * (e >> 1);
      const float x = p_or_ds<GRAD>(sum, dsum, DQ ? row : col,
                                    DQ ? col : row, gr);
      split_tf32(x, ab[s][e], as[s][e]);
    }
}

// acc += A B over a tile for the warp's output chunk, f32 form: A from
// `operand`, B the chunk's kUnits output units read N-major (b0: row 8 s +
// t, column 8 n + g; b1: row + 4), each unit's product in a fresh fragment
// added by rounded FADDs
__device__ __forceinline__ void out_product(
    float (&acc)[kCols / 8][4], const uint32_t (&ab)[kBK / 8][4],
    const uint32_t (&as)[kBK / 8][4], BwdRing<float>& ring, int lane) {
  constexpr int LD = BwdRing<float>::LD, NO = Form<float>::kDS / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < BwdRing<float>::kUnits; ++u) {
    const float* vs = ring.next().b;
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float* vp = vs + (8 * s + t) * LD + 8 * n + g;
        split_tf32(vp[0], bb[n][0], bs[n][0]);
        split_tf32(vp[4 * LD], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<NO>(pv, ab[s], as[s], bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[NO * u + n][e] += pv[n][e];
  }
}

// The bf16 form's A operand: the summed partials read in the accumulator
// layout ([n][e]: row r0 + g + 8 (e >> 1), column c0 + 8 n + 2 t + (e & 1))
// as float2 pairs, P or dS formed in f32 and rounded to bf16 into the A
// fragments of m16n8k16
template <bool DQ, bool GRAD>
__device__ __forceinline__ void operand(uint32_t (&pa)[kBK / 16][4],
                                        const float* sp, const float* dpp,
                                        int r0, int c0, const Grad& gr,
                                        int lane) {
  constexpr int LDS = Form<bf16>::kLdS;
  const int g = lane >> 2, t = lane & 3;
  float x[kBK / 8][4];
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (g + 8 * h) * LDS + 8 * n + 2 * t;
      float2 sum = *reinterpret_cast<const float2*>(sp + at);
      float2 dsum = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 1; w < kGroup; ++w) {
        const float2 y =
            *reinterpret_cast<const float2*>(sp + w * kRows * LDS + at);
        sum.x += y.x;
        sum.y += y.y;
      }
      if (GRAD) {
        dsum = *reinterpret_cast<const float2*>(dpp + at);
#pragma unroll
        for (int w = 1; w < kGroup; ++w) {
          const float2 y =
              *reinterpret_cast<const float2*>(dpp + w * kRows * LDS + at);
          dsum.x += y.x;
          dsum.y += y.y;
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = r0 + g + 8 * h, col = c0 + 8 * n + 2 * t + c;
        x[n][2 * h + c] =
            p_or_ds<GRAD>(c ? sum.y : sum.x, c ? dsum.y : dsum.x,
                          DQ ? row : col, DQ ? col : row, gr);
      }
    }
#pragma unroll
  for (int s = 0; s < kBK / 16; ++s) pack_a(pa[s], x, s);
}

// acc += A B in bf16: the output units read N-major by ldmatrix.trans,
// summed in place in f32
__device__ __forceinline__ void out_product(float (&acc)[kCols / 8][4],
                                            const uint32_t (&pa)[kBK / 16][4],
                                            BwdRing<bf16>& ring, int lane) {
  constexpr int NO = Form<bf16>::kDS / 8;
  static_assert(BwdRing<bf16>::LD == kLdB<64>, "ldmatrix reads kLdB rows");
#pragma unroll
  for (int u = 0; u < BwdRing<bf16>::kUnits; ++u) {
    const bf16* vs = ring.next().b;
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        load_b_cols<64>(b, vs, 16 * s, 8 * n, lane);
        mma_bf16(acc[NO * u + n], pa[s], b[0], b[1]);
        mma_bf16(acc[NO * u + n + 1], pa[s], b[2], b[3]);
      }
  }
}

// One tile's product of a warp that owns an output chunk, in either form:
// its operand (P, or with GRAD dS) from the summed partials, then acc +=
// operand x the chunk's output units
template <bool DQ, bool GRAD, typename T>
__device__ __forceinline__ void tile_grad(float (&acc)[kCols / 8][4],
                                          const float* sp, const float* dpp,
                                          BwdRing<T>& ring, int r0, int c0,
                                          const Grad& gr, int lane) {
  if constexpr (sizeof(T) == 4) {
    uint32_t ab[kBK / 8][4], as[kBK / 8][4];
    operand<DQ, GRAD>(ab, as, sp, dpp, r0, c0, gr, lane);
    out_product(acc, ab, as, ring, lane);
  } else {
    uint32_t pa[kBK / 16][4];
    operand<DQ, GRAD>(pa, sp, dpp, r0, c0, gr, lane);
    out_product(acc, pa, ring, lane);
  }
}

// the block's kRows rows of a warp's output chunk (row r0 + g + 8 h,
// columns 8 n + 2 t and + 1 of the accumulators), rows past L left out
template <typename T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[kCols / 8][4],
                                           int r0, int L, int dp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= L) continue;
    T* orow = out + static_cast<int64_t>(row) * dp;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const float a = acc[n][2 * h], b = acc[n][2 * h + 1];
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pack_bf16(a, b);
    }
  }
}

// The backward's shared memory: each of its 2 kGroup warps' slots, then
// two buffers (tile j in buffer j & 1) of the S and dP partials, [2]
// [kGroup][kRows][LDS] each
template <typename T>
constexpr int bwd_smem_bytes() {
  return 2 * kGroup * BwdRing<T>::kBytes +
         2 * 2 * kGroup * kRows * Form<T>::kLdS * 4;
}

// dQ (DQ: out0 = dQ) or dK and dV (out0 = dK, out1 = dV) of a block's
// kRows rows (queries or keys) and one group of up to four column chunks.
// Warps 0-3 (role 0) compute the partial S (S^T for dK/dV) over depth
// chunks w, w + 4, ..., warps 4-7 (role 1) dP (dP^T) over the same; warp w
// of role 0 owns chunk 4 group + w of dQ or dK, and for dK/dV warp 4 + w
// owns that chunk of dV.
template <typename T, bool DQ>
__global__ void
    flash_wide_bwd(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ bias, T* __restrict__ out0,
                   T* __restrict__ out1, int L, int dp, int n_heads,
                   float scale, int causal) {
  constexpr int LDS = Form<T>::kLdS, kPart = kGroup * kRows * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* parts = reinterpret_cast<float*>(smem_raw +
                                          2 * kGroup * BwdRing<T>::kBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int role = warp / kGroup, lw = warp % kGroup;
  // blocks numbered ((bh, row tile), group), a head's heaviest tiles under
  // causal first: dQ's last query tiles, dK/dV's first key tiles
  const int nc = dp / kCols, groups = (nc + kGroup - 1) / kGroup;
  const int group = static_cast<int>(blockIdx.x % groups);
  const unsigned rest = blockIdx.x / groups;
  const int tiles = (L + kRows - 1) / kRows;
  const int64_t bh = rest / tiles;
  const int tile = static_cast<int>(rest % tiles);
  const int r0 = (DQ ? tiles - 1 - tile : tile) * kRows;
  const int64_t off = bh * L * dp;
  const Grad gr{bias ? bias + (bh / n_heads) * L : nullptr, lse + bh * L,
                delta + bh * L, L, causal, scale};
  // causal: dQ skips the key tiles wholly after its last query, dK/dV the
  // query tiles wholly before its first key
  const int nt = (L + kBK - 1) / kBK;
  const int j0 = !DQ && causal ? r0 / kBK : 0;
  const int j1 = DQ && causal ? (min(r0 + kRows, L) - 1) / kBK + 1 : nt;
  // the warp's depth chunks w, w + 4, ..., and its column chunk
  const int nd = lw < nc ? (nc - 1 - lw) / kGroup + 1 : 0;
  const int oc = (group * kGroup + lw) * kCols;
  const bool owns = oc < dp && (!DQ || role == 0);
  // B, the tile operand, and A, the block's: S = Q K^T and dP = dO V^T for
  // dQ; S^T = K Q^T and dP^T = V dO^T for dK/dV
  const T* B = DQ ? (role ? v : k) : (role ? dout : q);
  const T* A = DQ ? (role ? dout : q) : (role ? v : k);
  const int cc = (lane & 7) * BwdRing<T>::kE;
  BwdRing<T> ring;
  ring.slots = reinterpret_cast<T*>(smem_raw + warp * BwdRing<T>::kBytes);
  ring.b = B + off + cc;
  ring.a = A + off + cc;
  ring.L = L;
  ring.dp = dp;
  ring.r0 = r0;
  ring.dc = lw;
  ring.nd = nd;
  ring.om = owns ? group : -1;
  ring.nkq = nd * BwdRing<T>::kUnits;
  ring.nu = ring.nkq + (owns ? BwdRing<T>::kUnits : 0);
  ring.rr = lane >> 3;
  ring.cc = cc;
  ring.begin(j0, j1);

  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    float sacc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
    for (int c = 0; c < nd; ++c) chunk_scores(sacc, ring, lane);
    // the S partials, then dP's, of tile j in buffer j & 1 (zeros from a
    // warp without a depth chunk): a warp writes tile j + 2's only after
    // the barrier of tile j + 1, which every warp reaches after its reads
    // of tile j
    float* sp = parts + (j & 1) * 2 * kPart;
    put_partial<LDS>(sp + role * kPart + lw * kRows * LDS, sacc, lane);
    __syncthreads();
    if (owns) {
      const int c0 = j * kBK;
      if (DQ)
        tile_grad<true, true>(acc, sp, sp + kPart, ring, r0, c0, gr, lane);
      else if (role == 0)  // dK += dS^T Q
        tile_grad<false, true>(acc, sp, sp + kPart, ring, r0, c0, gr, lane);
      else  // dV += P^T dO
        tile_grad<false, false>(acc, sp, nullptr, ring, r0, c0, gr, lane);
    }
  }
  if (owns) store_rows((role ? out1 : out0) + off + oc, acc, r0, L, dp, lane);
}

// blocks of a launch: (row tile) x (group of four column chunks) x BH on
// gridDim.x; 0 when the call cannot launch
int64_t grid(int64_t bh, int64_t L, int64_t dh) {
  const int64_t groups = (dh / kCols + kGroup - 1) / kGroup;
  const int64_t blocks = bh * ((L + kRows - 1) / kRows) * groups;
  return blocks > INT32_MAX ? 0 : blocks;
}

// 0 when the arguments can launch, else the CUDA error to return: the
// operands (q, k, v and, in the backward, dO) must be 16-byte aligned for
// cp.async
int check(int64_t bh, int64_t L, int64_t dh, int64_t n_heads,
          const void* q, const void* k, const void* v, const void* dout) {
  if (n_heads <= 0 || L > INT32_MAX / 2 || dh <= 256 || dh % kCols != 0 ||
      dh > INT32_MAX / 2 || grid(bh, L, dh) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once an
// instantiation (idempotent, so a racing second call is harmless); keeping
// it out of later launches lets them be captured in CUDA graphs
template <typename Kernel>
int configure(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* bias,
        void* o, void* lse, int64_t bh, int64_t L, int64_t dh,
        int64_t n_heads, float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check(bh, L, dh, n_heads, q, k, v, q)) return rc;
  constexpr int bytes = fwd_smem_bytes<T>();
  static bool configured = false;
  if (const int rc = configure(flash_wide_fwd<T>, bytes, &configured))
    return rc;
  flash_wide_fwd<T><<<static_cast<unsigned>(grid(bh, L, dh)), kGroup * 32,
                      bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<int>(L),
      static_cast<int>(dh), static_cast<int>(n_heads), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dQ (DQ: out0) or dK and dV (out0, out1)
template <typename T, bool DQ>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* bias, void* out0,
        void* out1, int64_t bh, int64_t L, int64_t dh, int64_t n_heads,
        float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check(bh, L, dh, n_heads, q, k, v, dout)) return rc;
  constexpr int bytes = bwd_smem_bytes<T>();
  static_assert(bytes <= 232448, "a block takes at most 227 KB");
  static bool configured = false;
  if (const int rc = configure(flash_wide_bwd<T, DQ>, bytes, &configured))
    return rc;
  flash_wide_bwd<T, DQ><<<static_cast<unsigned>(grid(bh, L, dh)),
                          2 * kGroup * 32, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(out0),
      static_cast<T*>(out1), static_cast<int>(L), static_cast<int>(dh),
      static_cast<int>(n_heads), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o [bh, L, dh] (f32, or bf16 for the _bf16 entry points), lse
// [bh, L] f32, all contiguous and q, k, v 16-byte aligned; dh a multiple
// of 128 above 256; bias null or [bh / n_heads, L] f32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// width or grid the kernel does not take, cudaErrorMisalignedAddress for
// a misaligned operand).
extern "C" int ptt_flash_wide_fwd(const void* q, const void* k,
                                  const void* v, const void* bias, void* o,
                                  void* lse, int64_t bh, int64_t L,
                                  int64_t dh, int64_t n_heads, float scale,
                                  int causal, void* stream) {
  return fwd<float>(q, k, v, bias, o, lse, bh, L, dh, n_heads, scale, causal,
                    stream);
}

extern "C" int ptt_flash_wide_bf16_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int64_t bh,
                                       int64_t L, int64_t dh, int64_t n_heads,
                                       float scale, int causal,
                                       void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, bias, o, lse, bh, L, dh, n_heads,
                            scale, causal, stream);
}

// As the forward, with dout [bh, L, dh], delta [bh, L] f32 and output dq.
extern "C" int ptt_flash_wide_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* bias, void* dq, int64_t bh,
                                     int64_t L, int64_t dh, int64_t n_heads,
                                     float scale, int causal, void* stream) {
  return bwd<float, true>(q, k, v, dout, lse, delta, bias, dq, nullptr, bh,
                          L, dh, n_heads, scale, causal, stream);
}

extern "C" int ptt_flash_wide_bf16_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* bias, void* dq,
                                          int64_t bh, int64_t L, int64_t dh,
                                          int64_t n_heads, float scale,
                                          int causal, void* stream) {
  return bwd<__nv_bfloat16, true>(q, k, v, dout, lse, delta, bias, dq,
                                  nullptr, bh, L, dh, n_heads, scale, causal,
                                  stream);
}

// As dQ, with outputs dk, dv [bh, L, dh].
extern "C" int ptt_flash_wide_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dk, void* dv,
                                      int64_t bh, int64_t L, int64_t dh,
                                      int64_t n_heads, float scale,
                                      int causal, void* stream) {
  return bwd<float, false>(q, k, v, dout, lse, delta, bias, dk, dv, bh, L,
                           dh, n_heads, scale, causal, stream);
}

extern "C" int ptt_flash_wide_bf16_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta,
                                           const void* bias, void* dk,
                                           void* dv, int64_t bh, int64_t L,
                                           int64_t dh, int64_t n_heads,
                                           float scale, int causal,
                                           void* stream) {
  return bwd<__nv_bfloat16, false>(q, k, v, dout, lse, delta, bias, dk, dv,
                                   bh, L, dh, n_heads, scale, causal,
                                   stream);
}
