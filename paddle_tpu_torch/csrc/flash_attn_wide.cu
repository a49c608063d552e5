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
// The forward runs its products on the tensor cores with mma.sync: the f32
// form in 3xTF32 (m16n8k8, as flash_attn_fwd.cu; 165 TFLOP/s effective),
// the bf16 form as m16n8k16 with f32 sums (as flash_attn_bf16_fwd.cu).
// A block has four warps and 16 query rows, and computes the scores once
// for a group of up to four 128-wide column chunks of O:
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
// dQ and dK/dV own one 128-wide column chunk of their outputs a block, one
// output column a thread (128 threads), for 16 rows: 16 query rows (dQ) or
// 16 keys (dK/dV); their score products (and dP = dO V^T) stream the whole
// width in 64-wide chunks through shared memory on the CUDA cores (67
// TFLOP/s in f32; a bf16 product is exact in f32), once a column chunk,
// and each thread adds its column's products reading K, Q or dO straight
// from device memory. Only column chunk (or group) 0 writes LSE. Every
// output element has one owner and a fixed summation order, with no
// atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace ptt;

// rows a block owns: queries (forward, dQ) or keys (dK/dV)
constexpr int kRows = 16;
constexpr int kTile = 32;   // keys (forward, dQ) or queries (dK/dV) a step
constexpr int kChunk = 64;  // head columns a staging pass of the scores
constexpr int kCols = 128;  // columns a chunk: a backward block's threads
constexpr int kLd = kChunk + 1;  // staged row stride: conflict-free reads
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P and dS as their products take them: rounded to bf16 in the bf16 form
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// the block's row tile and column chunk
struct Tile {
  int64_t bh;
  int r0;
  int col0;
  int chunk;
};

__device__ __forceinline__ Tile tile_of(int L, int chunks) {
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const unsigned rest = blockIdx.x / chunks;
  const unsigned tiles = (L + kRows - 1) / kRows;
  return Tile{static_cast<int64_t>(rest / tiles),
              static_cast<int>(rest % tiles) * kRows, chunk * kCols, chunk};
}

// rows [r0, r0 + ROWS) and columns [d0, d0 + 64) of a [L, dp] operand into
// shared memory as f32 rows of kLd, rows past L as zeros
template <int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int d0, int L, int dp) {
  for (int e = threadIdx.x; e < ROWS * kChunk; e += kCols) {
    const int r = e / kChunk, c = e % kChunk;
    dst[r * kLd + c] =
        r0 + r < L ? to_f(src[static_cast<int64_t>(r0 + r) * dp + d0 + c])
                   : 0.f;
  }
}

// acc[j] += A[a] . B[b + 8 j] over one staged chunk, for this thread's
// score row a = tid / 8 and columns b + 8 j, b = tid % 8
__device__ __forceinline__ void dots(float (&acc)[4], const float* A,
                                     const float* B) {
  const int a = threadIdx.x >> 3, b = threadIdx.x & 7;
#pragma unroll 8
  for (int d = 0; d < kChunk; ++d) {
    const float x = A[a * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = fmaf(x, B[(b + 8 * j) * kLd + d], acc[j]);
  }
}

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

// sc[n] += Q K^T over one K and Q unit: keys 8n + 2t, 8n + 2t + 1 of rows
// g, g + 8 (the accumulator layout), 3xTF32
__device__ __forceinline__ void unit_scores(float (&sc)[kBK / 8][4],
                                            const float* unit, int lane) {
  constexpr int LD = Form<float>::kLdKQ;
  const int g = lane >> 2, t = lane & 3;
  const float* qs = unit + kBK * LD;
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
                                            const bf16* unit, int lane) {
  const bf16* qs = unit + kBK * Form<bf16>::kLdKQ;
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

template <typename T>
__global__ void
    flash_wide_dq(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ bias, T* __restrict__ dq, int L,
                  int dp, int n_heads, float scale, int causal) {
  __shared__ float Qs[kRows * kLd];
  __shared__ float Ds[kRows * kLd];  // dO
  __shared__ float Ks[kTile * kLd];
  __shared__ float Vs[kTile * kLd];
  __shared__ float Ss[kRows][kTile];  // dS
  const Tile tl = tile_of(L, dp / kCols);
  const int64_t off = tl.bh * L * dp;
  q += off;
  k += off;
  v += off;
  dout += off;
  dq += off;
  const float* brow = bias ? bias + (tl.bh / n_heads) * L : nullptr;
  const int tid = threadIdx.x, a = tid >> 3, b = tid & 7;
  const int row = tl.r0 + a;
  const int c = tl.col0 + tid;
  const float lr = row < L ? lse[tl.bh * L + row] : 0.f;
  const float dr = row < L ? delta[tl.bh * L + row] : 0.f;
  const int last = min(tl.r0 + kRows, L) - 1;
  const int nk = causal ? last / kTile + 1 : (L + kTile - 1) / kTile;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kTile;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < dp; d0 += kChunk) {
      __syncthreads();
      stage<kRows>(Qs, q, tl.r0, d0, L, dp);
      stage<kRows>(Ds, dout, tl.r0, d0, L, dp);
      stage<kTile>(Ks, k, k0, d0, L, dp);
      stage<kTile>(Vs, v, k0, d0, L, dp);
      __syncthreads();
      dots(s, Qs, Ks);
      dots(dpv, Ds, Vs);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Score sc = score(s[j], row, k0 + b + 8 * j, L, causal, brow,
                             scale);
      const float p = sc.keep ? expf(sc.x - lr) : 0.f;
      Ss[a][b + 8 * j] = round_t<T>(p * (dpv[j] - dr) * scale);
    }
    __syncthreads();
    const int nkeys = min(kTile, L - k0);
    for (int kk = 0; kk < nkeys; ++kk) {
      const float x = to_f(k[static_cast<int64_t>(k0 + kk) * dp + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(Ss[r][kk], x, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (tl.r0 + r < L)
      dq[static_cast<int64_t>(tl.r0 + r) * dp + c] = from_f<T>(acc[r]);
}

template <typename T>
__global__ void
    flash_wide_dkv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ bias, T* __restrict__ dk,
                   T* __restrict__ dv, int L, int dp, int n_heads,
                   float scale, int causal) {
  __shared__ float Ks[kRows * kLd];
  __shared__ float Vs[kRows * kLd];
  __shared__ float Qs[kTile * kLd];
  __shared__ float Ds[kTile * kLd];  // dO
  __shared__ float Ps[kRows][kTile];  // P^T
  __shared__ float Ss[kRows][kTile];  // dS^T
  __shared__ float lse_s[kTile], delta_s[kTile];
  const Tile tl = tile_of(L, dp / kCols);
  const int64_t off = tl.bh * L * dp;
  q += off;
  k += off;
  v += off;
  dout += off;
  dk += off;
  dv += off;
  lse += tl.bh * L;
  delta += tl.bh * L;
  const float* brow = bias ? bias + (tl.bh / n_heads) * L : nullptr;
  const int tid = threadIdx.x, a = tid >> 3, b = tid & 7;
  const int key = tl.r0 + a;  // this thread's score row is a key
  const int c = tl.col0 + tid;
  float acc_k[kRows], acc_v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_k[r] = acc_v[r] = 0.f;
  // causal: query tiles wholly above the block's first key see none of it
  const int first = causal ? (tl.r0 / kTile) * kTile : 0;
  for (int q0 = first; q0 < L; q0 += kTile) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < dp; d0 += kChunk) {
      __syncthreads();
      stage<kRows>(Ks, k, tl.r0, d0, L, dp);
      stage<kRows>(Vs, v, tl.r0, d0, L, dp);
      stage<kTile>(Qs, q, q0, d0, L, dp);
      stage<kTile>(Ds, dout, q0, d0, L, dp);
      if (d0 == 0 && tid < kTile) {
        const bool in = q0 + tid < L;
        lse_s[tid] = in ? lse[q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[q0 + tid] : 0.f;
      }
      __syncthreads();
      dots(s, Ks, Qs);   // S^T: this key against queries b + 8 j
      dots(dpv, Vs, Ds);  // dP^T
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = b + 8 * j;
      const Score sc = score(s[j], q0 + i, key, L, causal, brow, scale);
      const float p = sc.keep ? expf(sc.x - lse_s[i]) : 0.f;
      Ps[a][i] = round_t<T>(p);
      Ss[a][i] = round_t<T>(p * (dpv[j] - delta_s[i]) * scale);
    }
    __syncthreads();
    const int nq = min(kTile, L - q0);
    for (int i = 0; i < nq; ++i) {
      const int64_t at = static_cast<int64_t>(q0 + i) * dp + c;
      const float xo = to_f(dout[at]), xq = to_f(q[at]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc_v[r] = fmaf(Ps[r][i], xo, acc_v[r]);
        acc_k[r] = fmaf(Ss[r][i], xq, acc_k[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (tl.r0 + r < L) {
      const int64_t at = static_cast<int64_t>(tl.r0 + r) * dp + c;
      dk[at] = from_f<T>(acc_k[r]);
      dv[at] = from_f<T>(acc_v[r]);
    }
}

// blocks of a backward launch: (row tile) x (column chunk) x BH on
// gridDim.x; 0 when the call cannot launch (the forward's, a block a group
// of four chunks, are fewer)
int64_t grid(int64_t bh, int64_t L, int64_t dh) {
  const int64_t blocks = bh * ((L + kRows - 1) / kRows) * (dh / kCols);
  return blocks > INT32_MAX ? 0 : blocks;
}

// 0 when the arguments can launch, else the CUDA error to return
int check(int64_t bh, int64_t L, int64_t dh, int64_t n_heads) {
  if (n_heads <= 0 || L > INT32_MAX / 2 || dh <= 256 || dh % kCols != 0 ||
      dh > INT32_MAX / 2 || grid(bh, L, dh) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* bias,
        void* o, void* lse, int64_t bh, int64_t L, int64_t dh,
        int64_t n_heads, float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check(bh, L, dh, n_heads)) return rc;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int bytes = fwd_smem_bytes<T>();
  // once per instantiation (idempotent, so a racing second call is
  // harmless); keeping it out of later launches lets them be captured in
  // CUDA graphs
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wide_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t groups = (dh / kCols + kGroup - 1) / kGroup;
  const int64_t blocks = bh * ((L + kRows - 1) / kRows) * groups;
  flash_wide_fwd<T><<<static_cast<unsigned>(blocks), kGroup * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<int>(L),
      static_cast<int>(dh), static_cast<int>(n_heads), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* bias, void* dq,
           int64_t bh, int64_t L, int64_t dh, int64_t n_heads, float scale,
           int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check(bh, L, dh, n_heads)) return rc;
  flash_wide_dq<T><<<static_cast<unsigned>(grid(bh, L, dh)), kCols, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dq),
      static_cast<int>(L), static_cast<int>(dh), static_cast<int>(n_heads),
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* bias, void* dk,
            void* dv, int64_t bh, int64_t L, int64_t dh, int64_t n_heads,
            float scale, int causal, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (const int rc = check(bh, L, dh, n_heads)) return rc;
  flash_wide_dkv<T><<<static_cast<unsigned>(grid(bh, L, dh)), kCols, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<int>(L), static_cast<int>(dh),
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
  return bwd_dq<float>(q, k, v, dout, lse, delta, bias, dq, bh, L, dh,
                       n_heads, scale, causal, stream);
}

extern "C" int ptt_flash_wide_bf16_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* bias, void* dq,
                                          int64_t bh, int64_t L, int64_t dh,
                                          int64_t n_heads, float scale,
                                          int causal, void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dq, bh, L,
                               dh, n_heads, scale, causal, stream);
}

// As dQ, with outputs dk, dv [bh, L, dh].
extern "C" int ptt_flash_wide_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dk, void* dv,
                                      int64_t bh, int64_t L, int64_t dh,
                                      int64_t n_heads, float scale,
                                      int causal, void* stream) {
  return bwd_dkv<float>(q, k, v, dout, lse, delta, bias, dk, dv, bh, L, dh,
                        n_heads, scale, causal, stream);
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
  return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dk, dv, bh,
                                L, dh, n_heads, scale, causal, stream);
}
