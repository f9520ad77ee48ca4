// Fused LoRA matmul forward for Hopper (sm_90a), one adapter or a pool:
//     y = x W + scale * (x A^T) B^T                        (lora_matmul)
//     y[m] = x[m] W + scale * (x[m] A[idx[m]]^T) B[idx[m]]^T  (gather)
// x (M, K), W (K, N) in its native layout, A (r, K), B (N, r), y (M, N);
// the gather takes pools A (P, r, K), B (P, N, r) and idx (M,) int32.
// f32 or bf16 operands, f32 accumulation, y in x's dtype.
//
// Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_matmul_kernel
// and ::lora_matmul_gather_kernel (Pallas, TPU).  There the grid's
// innermost K axis ran in order and VMEM scratch carried the (bm, bn) and
// (bm, r) accumulators from one K step to the next; the gather kernel's
// scalar-prefetched idx drove the A/B BlockSpec index maps, one grid row
// per slot.  Here a loop over K inside the block takes the K axis's place,
// and the gather is an addressing policy of the same body: the block loads
// its rows' indices into shared memory once and each (row, rank) pair of
// the rank path reads its own adapter's A row, each epilogue entry its own
// adapter's B row.  W is still read once per block and shared by every
// row whatever its adapter, so the gather costs only the rank-r reads.
//
// What bounds it on the H100: at the serving shapes (M = 8 decode slots or
// 16 chunk rows, K = N = 768, r = 4) the work is ~2 * M * K * N flops on
// K * N weights, about 4 to 8 flops per byte of W, far below the card's
// ridge.  It is bound by reading W once: 2.36 MB in f32, ~0.7 us at
// 3.35 TB/s (plus the A and B rows of the adapters used, 8 x 24.6 KB for
// the gather at 8 distinct adapters of rank 4).
//
// Design:
//  * one block per (BM-row tile, BN-column tile): 32 lanes across n, so a
//    warp reads 32 neighbouring W entries of one row (coalesced), and
//    KG = 16 warps split K between them;
//  * x is staged chunk by chunk (KC columns) in shared memory as f32;
//    first the rank path z = x A^T (BM x r, f32) is reduced into shared
//    memory, one warp per (row, rank) pair with a shuffle reduction;
//  * each thread keeps BM row accumulators in registers for its column,
//    the KG partial sums are added in shared memory, and the epilogue
//    adds scale * z B^T and writes y once;
//  * ragged M, N and K edges are masked here (no padding copies), and any
//    rank 1 <= r <= RMAX = 64 is taken;
//  * the adapter policy (OneAdapter, Pool) only says where row m's A and
//    B rows lie: the arithmetic and its order are the same for both, so
//    the single-adapter kernel keeps its results bit for bit, and a
//    gathered row equals the single-adapter kernel on that row alone.
//    Pool indices follow the reference's jnp.take: -P <= i < 0 counts
//    from the end, anything else outside the pool gives a NaN row, and
//    the pool is never read there.
// Not yet: wgmma/TMA, cp.async pipelining, split-K across blocks.  At
// N = 768 the grid is only 24 blocks, so one block per SM streams W; a
// later PR makes this faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;          // rows per block (register accumulators)
constexpr int BN = 32;          // columns per block: one lane per column
constexpr int KG = 16;          // warps splitting K inside the block
constexpr int KC = 128;         // x chunk along K staged in shared memory
constexpr int RMAX = 64;        // largest adapter rank taken
constexpr int NT = BN * KG;     // 512 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One adapter for every row.
template <typename T>
struct OneAdapter {
  const T* a;
  const T* b;
  __device__ __forceinline__ bool live(int) const { return true; }
  __device__ __forceinline__ const T* a_row(int, int j, int K, int) const {
    return a + (size_t)j * K;
  }
  __device__ __forceinline__ const T* b_row(int, int n, int, int r) const {
    return b + (size_t)n * r;
  }
};

// Row m wears adapter slot[m] of the pool; slot[m] < 0 marks a row with no
// adapter to read (past M, or an index outside the pool: a NaN row).
template <typename T>
struct Pool {
  const T* a;
  const T* b;
  const int* slot;                      // shared memory, BM entries
  __device__ __forceinline__ bool live(int m) const { return slot[m] >= 0; }
  __device__ __forceinline__ const T* a_row(int m, int j, int K, int r) const {
    return a + ((size_t)slot[m] * r + j) * K;
  }
  __device__ __forceinline__ const T* b_row(int m, int n, int N, int r) const {
    return b + ((size_t)slot[m] * N + n) * r;
  }
};

constexpr int NO_ROW = -2;              // past M: never written
constexpr int NAN_ROW = -1;             // index outside the pool

template <typename T, typename Adapter>
__device__ __forceinline__ void lora_matmul_body(
    const T* __restrict__ x, const T* __restrict__ w, const Adapter& ad,
    T* __restrict__ y, int M, int K, int N, int r, float scale) {
  __shared__ float xs[BM][KC];          //  8 KB
  __shared__ float zs[BM][RMAX];        //  4 KB
  __shared__ float red[KG][BM][BN];     // 32 KB

  const int lane = threadIdx.x;         // column within the tile
  const int warp = threadIdx.y;         // k group
  const int tid = warp * BN + lane;
  const int m0 = blockIdx.y * BM;
  const int n = blockIdx.x * BN + lane;
  const bool n_ok = n < N;

  for (int i = tid; i < BM * RMAX; i += NT) zs[i / RMAX][i % RMAX] = 0.f;
  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int i = tid; i < BM * KC; i += NT) {
      const int m = i / KC, kk = i % KC;
      float v = 0.f;
      if (m0 + m < M && kk < kc) v = to_f(x[(size_t)(m0 + m) * K + k0 + kk]);
      xs[m][kk] = v;
    }
    __syncthreads();

    // rank path: warp `warp` owns pairs p = warp, warp + KG, ... of the
    // BM x r grid; its lanes split the chunk and shuffle-reduce
    for (int p = warp; p < BM * r; p += KG) {
      const int m = p / r, j = p % r;
      if (!ad.live(m)) continue;        // uniform across the warp
      const T* arow = ad.a_row(m, j, K, r) + k0;
      float s = 0.f;
      for (int kk = lane; kk < kc; kk += 32) s += xs[m][kk] * to_f(arow[kk]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) zs[m][j] += s;
    }

    // base path: this warp's rows of the chunk, W in its (K, N) layout
    if (n_ok) {
#pragma unroll 8
      for (int kk = warp; kk < kc; kk += KG) {
        const float wv = to_f(w[(size_t)(k0 + kk) * N + n]);
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m] += xs[m][kk] * wv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();

  for (int i = tid; i < BM * BN; i += NT) {
    const int m = i / BN, c = i % BN;
    const int gm = m0 + m, gn = blockIdx.x * BN + c;
    if (gm < M && gn < N) {
      if (!ad.live(m)) {                // an index outside the pool
        store(y + (size_t)gm * N + gn, __int_as_float(0x7fc00000));
        continue;
      }
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) s += red[g][m][c];
      float d = 0.f;
      const T* brow = ad.b_row(m, gn, N, r);
      for (int j = 0; j < r; ++j) d += zs[m][j] * to_f(brow[j]);
      store(y + (size_t)gm * N + gn, s + scale * d);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) lora_matmul_fwd(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ b, T* __restrict__ y, int M, int K, int N, int r,
    float scale) {
  lora_matmul_body(x, w, OneAdapter<T>{a, b}, y, M, K, N, r, scale);
}

template <typename T>
__global__ void __launch_bounds__(NT) lora_matmul_gather(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a_pool,
    const T* __restrict__ b_pool, const int* __restrict__ idx, T* __restrict__ y,
    int M, int K, int N, int r, int P, float scale) {
  __shared__ int slot[BM];
  const int tid = threadIdx.y * BN + threadIdx.x;
  if (tid < BM) {
    const int gm = blockIdx.y * BM + tid;
    int s = NO_ROW;
    if (gm < M) {
      s = idx[gm];
      if (s < 0) s += P;                // jnp.take: negative counts from the end
      if (s < 0 || s >= P) s = NAN_ROW;
    }
    slot[tid] = s;
  }
  // the body's first barrier (after staging x, or before the epilogue when
  // K = 0) orders these writes before any read of slot[]
  lora_matmul_body(x, w, Pool<T>{a_pool, b_pool, slot}, y, M, K, N, r, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
int lora_matmul_fwd_launch(const void* x, const void* w, const void* a,
                           const void* b, void* y, int M, int K, int N, int r,
                           float scale, int dtype, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 block(BN, KG);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lora_matmul_fwd<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(y), M, K, N, r, scale);
  } else if (dtype == 1) {
    lora_matmul_fwd<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(y), M, K, N, r, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The gather: a_pool (P, r, K), b_pool (P, N, r), idx (M,) int32 on the
// device (read there, never by the host).  Same return convention.
int lora_matmul_gather_launch(const void* x, const void* w, const void* a_pool,
                              const void* b_pool, const void* idx, void* y, int M,
                              int K, int N, int r, int P, float scale, int dtype,
                              void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 block(BN, KG);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0) {
    lora_matmul_gather<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a_pool), static_cast<const float*>(b_pool), ix,
        static_cast<float*>(y), M, K, N, r, P, scale);
  } else if (dtype == 1) {
    lora_matmul_gather<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(a_pool),
        static_cast<const __nv_bfloat16*>(b_pool), ix,
        static_cast<__nv_bfloat16*>(y), M, K, N, r, P, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
