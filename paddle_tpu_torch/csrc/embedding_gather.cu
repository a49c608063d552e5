// Embedding gather: out[i, :] = w[clamp(ids[i], 0, V - 1), :] (+ bias[:]).
//
// Replaces paddle_tpu/ops/embedding_ops.py `_gather_pallas` (kernel body
// `_gather_kernel`), which scalar-prefetches the ids so each grid step DMAs
// one [1, D] table row into VMEM.
//
// Bound on an H100: bytes. Every output row is one table row read and one
// row written (plus 8 bytes of id), with no arithmetic beyond the optional
// bias add, so the kernel can at best run at device-memory bandwidth:
// (2 n D * 4 + 8 n) bytes at 3.35 TB/s.
//
// What held the first design (one block per id) back at narrow rows:
//  - a block of ((D/4 + 31)/32)*32 threads per id, so at D 16 one warp in
//    which 4 of 32 lanes load (8 at D 32);
//  - each block loaded its own id, waited for it (a trip to DRAM), then
//    loaded the row (a second trip), then stored: two dependent latencies
//    with one row in flight per block;
//  - an SM holds at most 32 blocks, so 13312 one-warp blocks ran in about
//    3.2 waves on 132 SMs, each wave waiting out both latencies.
//
// This design keeps many rows in flight on every SM with no idle lane:
//  - row groups: G lanes serve one row, G = min(32, next power of two >=
//    the row's width in 16-byte float4s), so a warp serves 32/G rows at once
//    (8 at D 16, 4 at D 32, 1 at D >= 128, where a lane moves several
//    float4s, unrolled). Consecutive groups write consecutive output rows:
//    at D 16 one store instruction of a warp covers 512 contiguous bytes;
//  - a block of 128 threads serves 128/G consecutive rows, one a group: each
//    id load instruction of a warp reads its 32/G consecutive ids at once,
//    and a lane starts all its row loads (`ld.global.nc`) before any store;
//    the grid covers every row (at the path shapes about one wave: CTR D 16
//    gives 416 blocks, 12.6 warps an SM); 4-warp blocks rather than 8 give
//    decode's 8 to 256 rows of D 512 the first design's launch, one row a
//    block, which was 0.02 us faster at 256 rows;
//  - few wide rows (decode's 8 to 256 rows of D 512) would leave most of
//    the card idle with a warp a row, each lane moving four float4s one
//    after another: there a row group spans up to kGroupMax threads (a
//    block) while the card has warps to spare, down to one float4 a lane;
//  - at decode's few rows a warp's instructions before its first load are
//    on the critical path, and each kernel parameter line a launch first
//    reads costs a trip to L2: the parameters fit in 48 bytes (one line of
//    the constant bank), the kernel reads neither blockDim nor gridDim (no
//    grid-stride loop), the column offsets are 32-bit and each row's
//    pointers are formed once (a 64-bit product each);
//  - where D % 4 != 0 or a pointer is not 16-byte aligned, the scalar path
//    takes the same scheme with one float a lane;
//  - the bias is loaded once a column chunk and added in registers.
// No shared memory and no block-wide synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;              // a block's
// the most elements a lane moves a chunk (4 float4s: 8 lost at BERT's
// [2, 768], and 2 add a serial chunk at decode)
constexpr int kKMax = 4;
// the most threads a row group spans (a power of two, at most a block), and
// the warps an SM holds at most (Hopper): a row group widens while the
// grid's warps still fit in one wave of them
constexpr int kGroupMax = 128;
constexpr int kSmWarps = 64;
static_assert(kGroupMax <= kThreads, "a block holds a whole row group");
// n, V and D stay below this, so that a row index and a column plus a
// chunk fit in an int
constexpr int64_t kMaxRows = (int64_t(1) << 31) - (1 << 24);

__device__ __forceinline__ int64_t clamp_id(int64_t id, int64_t V) {
  return id < 0 ? 0 : (id >= V ? V - 1 : id);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// T is float4 (the vector path) or float (the scalar path); DT is the row
// width in T, and G = 1 << lg threads serve a row, each moving up to K
// elements of it a chunk. Row i of a block is its (threadIdx.x >> lg)-th.
// A row's two pointers take the only 64-bit products; the column offsets
// are 32-bit (n, V and DT below kMaxRows, by the entry).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gather_rows(const T* __restrict__ w, const int64_t* __restrict__ ids,
            const T* __restrict__ bias, T* __restrict__ out, int n, int V,
            int DT, int lg) {
  const int i = blockIdx.x * (kThreads >> lg) + (threadIdx.x >> lg);
  if (i >= n) return;
  const int G = 1 << lg;
  const T* src = w + clamp_id(__ldg(ids + i), V) * DT;
  T* dst = out + int64_t(i) * DT;
  for (int c0 = threadIdx.x & (G - 1); c0 < DT; c0 += K * G) {
    T b[K];
    if (bias != nullptr) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c0 + k * G < DT) b[k] = __ldg(bias + c0 + k * G);
    }
    // every row load of the chunk before any store
    T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k * G < DT) v[k] = __ldg(src + c0 + k * G);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k * G < DT) {
        T x = v[k];
        if (bias != nullptr) x = add(x, b[k]);
        dst[c0 + k * G] = x;
      }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, int K>
void launch(const T* w, const int64_t* ids, const T* bias, T* out, int n,
            int V, int DT, int lg, cudaStream_t s) {
  const int rows = kThreads >> lg;         // a block's
  gather_rows<T, K><<<static_cast<unsigned>((n + rows - 1) / rows),
                      kThreads, 0, s>>>(w, ids, bias, out, n, V, DT, lg);
}

// Rows of width DT (in T): G = 1 << lg threads a row, G = min(32, next
// power of two >= DT), widened past a warp (up to kGroupMax threads) while
// the widened grid's warps still fit on the card at once; then the K
// instantiation for the elements a thread moves.
template <typename T>
void dispatch(const T* w, const int64_t* ids, const T* bias, T* out, int n,
              int V, int DT, cudaStream_t s) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < DT) ++lg;
  while ((1 << lg) < kGroupMax && (1 << lg) < DT &&
         int64_t(n) * (2 << lg) <= int64_t(sm_count()) * kSmWarps * 32)
    ++lg;
  const int L = (DT + (1 << lg) - 1) >> lg;   // elements a thread moves
  if (L == 1) launch<T, 1>(w, ids, bias, out, n, V, DT, lg, s);
  else if (L == 2) launch<T, 2>(w, ids, bias, out, n, V, DT, lg, s);
  else launch<T, kKMax>(w, ids, bias, out, n, V, DT, lg, s);
}

}  // namespace

// w [V, D] f32, ids [n] int64, bias [D] f32 or null, out [n, D] f32; all
// contiguous; 0 < V and n, V and D under 2^31 - 2^24 (cudaErrorInvalidValue
// otherwise). Returns cudaGetLastError() after the launch.
extern "C" int ptt_embedding_gather(const void* w, const void* ids,
                                    const void* bias, void* out, int64_t n,
                                    int64_t V, int64_t D, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (V <= 0 || n >= kMaxRows || D >= kMaxRows || V >= kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* id = static_cast<const int64_t*>(ids);
  if (D % 4 == 0 && aligned16(w) && aligned16(bias) && aligned16(out)) {
    dispatch(static_cast<const float4*>(w), id,
             static_cast<const float4*>(bias), static_cast<float4*>(out),
             static_cast<int>(n), static_cast<int>(V), static_cast<int>(D / 4),
             s);
  } else {
    dispatch(static_cast<const float*>(w), id,
             static_cast<const float*>(bias), static_cast<float*>(out),
             static_cast<int>(n), static_cast<int>(V), static_cast<int>(D), s);
  }
  return static_cast<int>(cudaGetLastError());
}
