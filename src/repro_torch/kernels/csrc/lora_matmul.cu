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
// scalar-prefetched idx drove the A/B BlockSpec index maps.  Here the
// gather is an adapter policy (OneAdapter, Pool) of one body per regime:
// the block loads its rows' indices once, and the policy says where row
// m's A and B rows lie, in the rank path and the epilogue only.  W is read
// once per block and shared by every row whatever its adapter.
//
// Two regimes behind each entry, chosen by M alone (the plan comes from
// repro_torch/kernels/lora_matmul/plan.py, which the launcher trusts):
//
// 1. decode (M <= 16: decode slots, prefill chunks).  What bounds it on the
//    H100: reading W once, 2 M flops per 4-byte weight: 2.36 MB at K = N =
//    768 (0.7 us at 3.35 TB/s), 108 MB at Mamba2's ssm_in (32.5 us), 52 MB
//    at ssm_out (15.8 us).  Design:
//     * the column tile (32, 64 or 128 columns) is split along K over S =
//       1-8 blocks of one thread-block cluster, so the grid has >= 132
//       blocks at every shape of the main paths, in one wave (192 at K = N
//       = 768, 166 at ssm_in, 160 at ssm_out);
//     * each of 256 threads owns 4 neighbouring columns and BM = 8 or 16
//       rows (sized to M): W streams straight to registers with 16-byte
//       ld.global.nc loads, 8 rows in flight per thread (4-byte loads
//       where N is not a multiple of 4), and
//       each x value, read from shared memory as a float4 over rows, feeds
//       4 FMAs; the block's k lanes split its K slice;
//     * x's K slice is staged in shared memory as f32, transposed (row
//       pitch BM + 4); the rank path x A^T is reduced per (row, rank) pair
//       by one warp with a shuffle reduction, per split;
//     * the k lanes' partials are added in shared memory in lane order,
//       then the S splits' partials (and the rank path's) through
//       distributed shared memory (cluster.map_shared_rank) in rank order;
//       the epilogue is spread over the cluster's blocks.  No float
//       atomics, no workspace, no second launch.
// 2. tile (M > 16: prefill, training): the 3xTF32 mma.sync tile on a
//    cp.async ring of csrc/lora_mma.cuh (see its note), 64 x 64 or 32 x 32
//    from plan.py, 64 x 128 or 32 x 64 (16-byte copies only) where the
//    tuner's timing picks them.
//
// A row's terms are summed in an order fixed by the regime, K and N alone,
// never by M or the other rows: so a gathered row equals the
// single-adapter kernel on that row in the same regime, bit for bit, and
// two runs give equal bits.  Ragged M, N and K edges are masked (no
// padding copies), any rank 1 <= r <= RMAX = 64 is taken, and pool
// indices follow the reference's jnp.take: -P <= i < 0 counts from the
// end, anything else outside the pool gives a NaN row, and the pool is
// never read there.

#include "lora_mma.cuh"

namespace {

// One adapter for every row.
template <typename T>
struct OneAdapter {
  static constexpr bool SHARED = true;  // every row reads the same A and B
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

// Block row m wears adapter slot[m] of the pool; slot[m] < 0 marks a row
// with no adapter to read (past M, or an index outside the pool: NaN).
template <typename T>
struct Pool {
  static constexpr bool SHARED = false;
  const T* a;
  const T* b;
  const int* slot;                      // shared memory, one entry per block row
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

// Load the block's rows' pool slots (jnp.take's meaning of idx).
__device__ __forceinline__ void load_slots(int* slot, const int* __restrict__ idx, int m0,
                                           int rows, int M, int P) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int gm = m0 + t;
    int s = NO_ROW;
    if (gm < M) {
      s = idx[gm];
      if (s < 0) s += P;                // negative counts from the end
      if (s < 0 || s >= P) s = NAN_ROW;
    }
    slot[t] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// decode regime
// ---------------------------------------------------------------------------

constexpr int DNT = 256;                // threads per block
constexpr int DKC = 640;                // rows of K staged per chunk
constexpr int DUNROLL = 8;              // W rows in flight per thread

// Floats of the region that holds the staged x chunk and, after the K
// loop, the k lanes' partials (4 * DNT * BM floats whatever the column tile).
template <int BM>
__host__ __device__ constexpr size_t decode_region() {
  constexpr size_t xs = size_t(DKC) * (BM + 4), red = size_t(4) * DNT * BM;
  return xs > red ? xs : red;
}

// Dynamic shared memory: the region, the split's rank partial, the sum.
template <int BM>
constexpr size_t decode_smem_bytes(int r) {
  return (decode_region<BM>() + 2 * size_t(BM) * r) * sizeof(float);
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_w4(float (&v)[4], const T* __restrict__ row, int n,
                                        int N) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + n));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (VEC) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + n));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo), v[1] = __high2float(lo);
    v[2] = __low2float(hi), v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = n + c < N ? to_f(row[n + c]) : 0.f;
  }
}

// Block (split s, column tile, row tile) of a cluster of S blocks along K.
template <typename T, int BM, int BN, bool VEC, typename Adapter>
__device__ __forceinline__ void decode_body(const T* __restrict__ x,
                                            const T* __restrict__ w, const Adapter& ad,
                                            T* __restrict__ y, int M, int K, int N, int r,
                                            float scale) {
  constexpr int CG = BN / 4;            // column groups of 4
  constexpr int KL = DNT / CG;          // k lanes
  constexpr int XP = BM + 4;            // staged x row pitch (floats)
  extern __shared__ __align__(16) float dsm[];
  float* xs = dsm;                      // [DKC][XP], then red [KL][BM][BN]
  float* zp = dsm + decode_region<BM>();  // [BM][r]: this split's rank partial
  float* zf = zp + BM * r;              // [BM][r]: summed over the splits

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cgi = tid % CG, kl = tid / CG;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int n = n0 + cgi * 4;
  const bool n_ok = n < N;
  const int slice = (K + S - 1) / S;
  const int k_lo = min(K, s * slice), k_hi = min(K, k_lo + slice);

  for (int i = tid; i < BM * r; i += DNT) zp[i] = 0.f;
  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int c0 = k_lo; c0 < k_hi; c0 += DKC) {
    const int kc = min(DKC, k_hi - c0);
    if (c0 != k_lo) __syncthreads();   // the last chunk's readers are done
    for (int i = tid; i < BM * kc; i += DNT) {
      const int m = i / kc, kk = i % kc;
      xs[kk * XP + m] = m0 + m < M ? to_f(x[(size_t)(m0 + m) * K + c0 + kk]) : 0.f;
    }
    __syncthreads();

    // rank path: warp `warp` owns pairs p = warp, warp + 8, ... of BM x r
    for (int p = warp; p < BM * r; p += DNT / 32) {
      const int m = p / r, j = p % r;
      if (!ad.live(m)) continue;        // uniform across the warp
      const T* arow = ad.a_row(m, j, K, r) + c0;
      float t = 0.f;
      for (int kk = lane; kk < kc; kk += 32) t += xs[kk * XP + m] * to_f(arow[kk]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) zp[p] += t;
    }

    // base path: k lane kl takes rows kl, kl + KL, ... of the chunk
    if (n_ok) {
#pragma unroll DUNROLL
      for (int kk = kl; kk < kc; kk += KL) {
        float wv[4];
        load_w4<T, VEC>(wv, w + (size_t)(c0 + kk) * N, n, N);
        const float4* xr = reinterpret_cast<const float4*>(xs + kk * XP);
#pragma unroll
        for (int m4 = 0; m4 < BM / 4; ++m4) {
          const float4 xv = xr[m4];
          const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m4 * 4 + i][c] += xm[i] * wv[c];
        }
      }
    }
  }
  __syncthreads();                      // x readers are done: reuse as red

  float* red = xs;                      // [KL][BM][BN]; lane 0's slice becomes the sum
#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(red + ((size_t)kl * BM + m) * BN + cgi * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += DNT) {
    float v = red[i];
    for (int g = 1; g < KL; ++g) v += red[(size_t)g * BM * BN + i];
    red[i] = v;
  }
  cluster.sync();                       // every split's partials are in place

  // the rank tile, summed over the splits in rank order
  for (int i = tid; i < BM * r; i += DNT) {
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(zp, q)[i];
    zf[i] = v;
  }
  __syncthreads();

  // epilogue: this block's share of the tile's outputs
  for (int i = s * DNT + tid; i < BM * BN; i += S * DNT) {
    const int m = i / BN, c = i % BN;
    const int gm = m0 + m, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    T* dst = y + (size_t)gm * N + gn;
    if (!ad.live(m)) {                  // an index outside the pool
      store(dst, nan_f());
      continue;
    }
    float v = cluster.map_shared_rank(red, 0)[i];
    for (int q = 1; q < S; ++q) v += cluster.map_shared_rank(red, q)[i];
    float d = 0.f;
    const T* brow = ad.b_row(m, gn, N, r);
    for (int j = 0; j < r; ++j) d += zf[m * r + j] * to_f(brow[j]);
    store(dst, v + scale * d);
  }
  cluster.sync();                       // keep this block's partials until all have read
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(DNT, 2) decode_one(const T* __restrict__ x,
                                                  const T* __restrict__ w,
                                                  const T* __restrict__ a,
                                                  const T* __restrict__ b, T* __restrict__ y,
                                                  int M, int K, int N, int r, float scale) {
  decode_body<T, BM, BN, VEC>(x, w, OneAdapter<T>{a, b}, y, M, K, N, r, scale);
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(DNT, 2) decode_pool(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a_pool,
    const T* __restrict__ b_pool, const int* __restrict__ idx, T* __restrict__ y, int M,
    int K, int N, int r, int P, float scale) {
  __shared__ int slot[BM];
  load_slots(slot, idx, blockIdx.z * BM, BM, M, P);
  decode_body<T, BM, BN, VEC>(x, w, Pool<T>{a_pool, b_pool, slot}, y, M, K, N, r, scale);
}

// ---------------------------------------------------------------------------
// tile regime: the forward's operand policy for csrc/lora_mma.cuh
// ---------------------------------------------------------------------------

template <typename T, typename Adapter>
struct FwdOp : MmaDefaults<T> {
  static constexpr bool RQ = false;     // W (K, N) is R[k][n], n-major
  static constexpr bool US = Adapter::SHARED;
  const T* w;
  Adapter ad;
  int K, N, r;
  __device__ __forceinline__ bool live(int m) const { return ad.live(m); }
  // us[j][q] = A[j][q0 + q] (one adapter for the tile)
  __device__ __forceinline__ void stage_u(T* us, int q0, int Q, int, int tid) const {
    stage_u_rank_major(us, ad.a, K, q0, Q, r, tid);
  }
  __device__ __forceinline__ float u(int m, int j, int k) const {
    return to_f(ad.a_row(m, j, K, r)[k]);
  }
  __device__ __forceinline__ float v(int m, int j, int n) const {
    return to_f(ad.b_row(m, n, N, r)[j]);
  }
};

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_NT) tile_one(const T* __restrict__ x,
                                                   const T* __restrict__ w,
                                                   const T* __restrict__ a,
                                                   const T* __restrict__ b, T* __restrict__ y,
                                                   int M, int K, int N, int r, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const FwdOp<T, OneAdapter<T>> op{{}, w, OneAdapter<T>{a, b}, K, N, r};
  mma_tile<T, BM, BN, VEC>(x, op, y, M, K, N, r, scale, tsm);
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_NT) tile_pool(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a_pool,
    const T* __restrict__ b_pool, const int* __restrict__ idx, T* __restrict__ y, int M,
    int K, int N, int r, int P, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  __shared__ int slot[BM];
  load_slots(slot, idx, blockIdx.y * BM, BM, M, P);
  const FwdOp<T, Pool<T>> op{{}, w, Pool<T>{a_pool, b_pool, slot}, K, N, r};
  mma_tile<T, BM, BN, VEC>(x, op, y, M, K, N, r, scale, tsm);
}

// ---------------------------------------------------------------------------
// dispatch: the plan's (regime, row tile, column tile, splits, vec) to an
// instantiated kernel.  `Pooled` selects the gather; its extra arguments
// (idx, P) ride in `pool`.
// ---------------------------------------------------------------------------

struct PoolArgs {
  const int* idx;
  int P;
};

template <typename T, bool Pooled, int BM, int BN, bool VEC>
cudaError_t run_decode(const T* x, const T* w, const T* a, const T* b, PoolArgs pool, T* y,
                       int M, int K, int N, int r, float scale, int S, cudaStream_t st) {
  const dim3 grid(S, (N + BN - 1) / BN, (M + BM - 1) / BM);
  const size_t bytes = decode_smem_bytes<BM>(r);
  if constexpr (Pooled)
    return cluster_launch<decode_pool<T, BM, BN, VEC>, DNT>(grid, S, bytes, st, x, w, a, b,
                                                            pool.idx, y, M, K, N, r, pool.P,
                                                            scale);
  else
    return cluster_launch<decode_one<T, BM, BN, VEC>, DNT>(grid, S, bytes, st, x, w, a, b,
                                                           y, M, K, N, r, scale);
}

template <typename T, bool Pooled, int BM, int BN, bool VEC>
cudaError_t run_tile(const T* x, const T* w, const T* a, const T* b, PoolArgs pool, T* y,
                     int M, int K, int N, int r, float scale, int S, cudaStream_t st) {
  const dim3 grid(S, (M + BM - 1) / BM, (N + BN - 1) / BN);
  const size_t bytes = mma_smem_bytes<T, BM, BN, false, !Pooled>(r);
  if constexpr (Pooled)
    return cluster_launch<tile_pool<T, BM, BN, VEC>, MMA_NT>(grid, S, bytes, st, x, w, a, b,
                                                             pool.idx, y, M, K, N, r,
                                                             pool.P, scale);
  else
    return cluster_launch<tile_one<T, BM, BN, VEC>, MMA_NT>(grid, S, bytes, st, x, w, a, b,
                                                            y, M, K, N, r, scale);
}

template <typename T, bool Pooled, bool VEC>
cudaError_t run_vec(const T* x, const T* w, const T* a, const T* b, PoolArgs pool, T* y,
                    int M, int K, int N, int r, float scale, int regime, int bm, int bn,
                    int S, cudaStream_t st) {
  if (S < 1 || S > 8 || (S & (S - 1))) return cudaErrorInvalidValue;
  if (regime == 0) {
#define DECODE_CASE(BM_, BN_)                                                           \
  if (bm == BM_ && bn == BN_)                                                           \
    return run_decode<T, Pooled, BM_, BN_, VEC>(x, w, a, b, pool, y, M, K, N, r, scale, \
                                                S, st);
    DECODE_CASE(8, 32) DECODE_CASE(8, 64) DECODE_CASE(8, 128)
    DECODE_CASE(16, 32) DECODE_CASE(16, 64) DECODE_CASE(16, 128)
#undef DECODE_CASE
  } else if (regime == 1) {
    if (bm == 64 && bn == 64)
      return run_tile<T, Pooled, 64, 64, VEC>(x, w, a, b, pool, y, M, K, N, r, scale, S, st);
    if (bm == 32 && bn == 32)
      return run_tile<T, Pooled, 32, 32, VEC>(x, w, a, b, pool, y, M, K, N, r, scale, S, st);
    if constexpr (VEC) {        // the tuner's shapes: ptxas spills some at element copies
      if (bm == 64 && bn == 128)
        return run_tile<T, Pooled, 64, 128, true>(x, w, a, b, pool, y, M, K, N, r, scale, S,
                                                  st);
      if (bm == 32 && bn == 64)
        return run_tile<T, Pooled, 32, 64, true>(x, w, a, b, pool, y, M, K, N, r, scale, S,
                                                 st);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool Pooled>
int run(const void* x, const void* w, const void* a, const void* b, PoolArgs pool, void* y,
        int M, int K, int N, int r, float scale, int regime, int bm, int bn, int S, int vec,
        cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  return (int)(vec ? run_vec<T, Pooled, true>(xp, wp, ap, bp, pool, yp, M, K, N, r, scale,
                                              regime, bm, bn, S, st)
                   : run_vec<T, Pooled, false>(xp, wp, ap, bp, pool, yp, M, K, N, r, scale,
                                               regime, bm, bn, S, st));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The plan (regime 0 = decode, 1 =
// tile; row tile, column tile, splits, vec) is plan.py's.  Returns the
// launch's cudaError_t (0 = launched); the caller raises on anything else.
int lora_matmul_fwd_launch(const void* x, const void* w, const void* a, const void* b,
                           void* y, int M, int K, int N, int r, float scale, int dtype,
                           int regime, int bm, int bn, int splits, int vec, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PoolArgs none{nullptr, 0};
  if (dtype == 0)
    return run<float, false>(x, w, a, b, none, y, M, K, N, r, scale, regime, bm, bn, splits,
                             vec, st);
  if (dtype == 1)
    return run<__nv_bfloat16, false>(x, w, a, b, none, y, M, K, N, r, scale, regime, bm, bn,
                                     splits, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The gather: a_pool (P, r, K), b_pool (P, N, r), idx (M,) int32 on the
// device (read there, never by the host).  Same plan and return convention.
int lora_matmul_gather_launch(const void* x, const void* w, const void* a_pool,
                              const void* b_pool, const void* idx, void* y, int M, int K,
                              int N, int r, int P, float scale, int dtype, int regime,
                              int bm, int bn, int splits, int vec, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PoolArgs pool{static_cast<const int*>(idx), P};
  if (dtype == 0)
    return run<float, true>(x, w, a_pool, b_pool, pool, y, M, K, N, r, scale, regime, bm,
                            bn, splits, vec, st);
  if (dtype == 1)
    return run<__nv_bfloat16, true>(x, w, a_pool, b_pool, pool, y, M, K, N, r, scale,
                                    regime, bm, bn, splits, vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
