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
// register budget holds them, so this source trades speed for a width
// without limit.
//
// Bound on an H100: operations. A visible (query, key) pair costs 4·DH
// flops forward, 6·DH for dQ and 8·DH for dK/dV against 16·DH bytes a row;
// here every product runs on the CUDA cores in f32 (67 TFLOP/s; a bf16
// product is exact in f32), no tensor cores.
//
// Design, chosen to be simple and right at any width:
// - Each block owns one 128-wide column chunk of its outputs, one output
//   column a thread (128 threads), for 16 rows: 16 query rows (forward,
//   dQ) or 16 keys (dK/dV). The grid is (row tile) x (column chunk) x BH,
//   numbered on gridDim.x alone so that BH may exceed gridDim.y's 65535;
//   the chunks of a row tile are neighbours and share its operands in L2.
// - The score products (and dP = dO V^T in the backward) run over the
//   whole padded width in 64-wide chunks staged through shared memory: a
//   block holds a 16 x 32 score tile (four scores a thread) and its 16 x
//   128 outputs in registers, whatever the width. Every column chunk
//   repeats the score products: (DP / 128) times the flops of one.
// - Then the tile's P (or dS) goes through shared memory and each thread
//   adds its column's products, reading V, K, Q or dO straight from device
//   memory (neighbouring threads on neighbouring columns).
// - Only column chunk 0 writes LSE. Every output element has one owner and
//   a fixed summation order, with no atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// rows a block owns: queries (forward, dQ) or keys (dK/dV)
constexpr int kRows = 16;
constexpr int kTile = 32;   // keys (forward, dQ) or queries (dK/dV) a step
constexpr int kChunk = 64;  // head columns a staging pass of the scores
constexpr int kCols = 128;  // output columns a block owns = its threads
constexpr int kLd = kChunk + 1;  // staged row stride: conflict-free reads
constexpr float kNegInf = -1e30f;
constexpr float kBiasDrop = -1e8f;  // a key with bias <= this is dropped

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

// max and sum over the 8 lanes that share a score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

template <typename T>
__global__ void
    flash_wide_fwd(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ o, float* __restrict__ lse, int L, int dp,
                   int n_heads, float scale, int causal) {
  __shared__ float Qs[kRows * kLd];
  __shared__ float Ks[kTile * kLd];
  __shared__ float Ps[kRows][kTile];
  __shared__ float As[kRows];  // each row's rescale of the tile
  __shared__ float Ls[kRows];  // each row's final l
  const Tile tl = tile_of(L, dp / kCols);
  const int64_t off = tl.bh * L * dp;
  q += off;
  k += off;
  v += off;
  o += off;
  const float* brow = bias ? bias + (tl.bh / n_heads) * L : nullptr;
  const int tid = threadIdx.x, a = tid >> 3, b = tid & 7;
  const int row = tl.r0 + a;  // this thread's score row
  const int c = tl.col0 + tid;  // this thread's output column
  const int last = min(tl.r0 + kRows, L) - 1;
  const int nk = causal ? last / kTile + 1 : (L + kTile - 1) / kTile;
  float m = kNegInf, l = 0.f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kTile;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < dp; d0 += kChunk) {
      __syncthreads();
      stage<kRows>(Qs, q, tl.r0, d0, L, dp);
      stage<kTile>(Ks, k, k0, d0, L, dp);
      __syncthreads();
      dots(s, Qs, Ks);
    }
    Score sc[4];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = score(s[j], row, k0 + b + 8 * j, L, causal, brow, scale);
      mt = fmaxf(mt, sc[j].x);
    }
    const float mn = fmaxf(m, row_max(mt));
    const float alpha = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = sc[j].keep ? expf(sc[j].x - mn) : 0.f;
      ps += p;
      Ps[a][b + 8 * j] = round_t<T>(p);
    }
    l = l * alpha + row_sum(ps);
    m = mn;
    if (b == 0) As[a] = alpha;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] *= As[r];
    const int nkeys = min(kTile, L - k0);
    for (int kk = 0; kk < nkeys; ++kk) {
      const float x = to_f(v[static_cast<int64_t>(k0 + kk) * dp + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(Ps[r][kk], x, acc[r]);
    }
  }
  if (b == 0) {
    Ls[a] = l;
    if (tl.chunk == 0 && row < L)
      lse[tl.bh * L + row] = m + logf(fmaxf(l, 1e-30f));
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (tl.r0 + r < L)
      o[static_cast<int64_t>(tl.r0 + r) * dp + c] =
          from_f<T>(acc[r] / fmaxf(Ls[r], 1e-30f));
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

// blocks of a launch: (row tile) x (column chunk) x BH on gridDim.x;
// 0 when the call cannot launch
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
  flash_wide_fwd<T><<<static_cast<unsigned>(grid(bh, L, dh)), kCols, 0,
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
// [bh, L] f32, all contiguous; dh a multiple of 128 above 256; bias null or
// [bh / n_heads, L] f32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head width or grid the kernel does not take).
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
