// Fused LoRA matmul backward for Hopper (sm_90a): the two kernels behind
// the autograd backward of y = x W + scale * (x A^T) B^T.
//
// 1. lora_matmul_dx:      dX = dY W^T + scale * (dY B) A
//      dY (M, N), W (K, N) in its forward layout, A (r, K), B (N, r);
//      dX (M, K) in dY's dtype (f32 or bf16), f32 accumulation.
//    Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_matmul_dx_kernel
//    (Pallas, TPU).  There the grid's innermost N axis ran in order and
//    VMEM scratch carried the (bm, bk) and (bm, r) accumulators across it.
//    Here a loop over N inside the block takes that place.
//    What bounds it on the H100: at training shapes (M = K * b * S = 768
//    rows on the server, 256 per client, K = N = 768) it is a real GEMM,
//    2 * M * K * N flops on ~(M + K) * N * 4 bytes: about 190 flops per
//    byte at M = 768, above the f32 ridge.  On the tensor cores in 3xTF32
//    (three TF32 mma per product, 495 TFLOP/s) the bound is 5.5 us at
//    M = 768 and 1.8 us at M = 256 (13.7 and 4.6 us at f32 FFMA's 67).
//    Design: the 3xTF32 mma.sync tile on a cp.async ring of
//    csrc/lora_mma.cuh (see its note), with L = dY, the reduction over N
//    and R[n][k] = W[k][n]: W is read in its (K, N) layout, rows of N that
//    the ring stages as they lie (q-major), no transposed copy.  The rank
//    tile dY B (BM x r) is summed in f32 in the same N loop and the
//    epilogue adds scale * (dY B) A.  64 x 64 tiles at M = 768 (144
//    blocks), 32 x 32 at M = 256 (192 blocks); ragged M, N and K edges are
//    masked, element copies where N is not a multiple of 16 bytes; any
//    rank 1 <= r <= RMAX = 64; no atomics: two runs give equal bits.
//
// 2. lora_rank_reduce:    out (r, N) f32 = u^T v
//      u (M, r) f32, v (M, N) f32 or bf16 (upcast per element).
//    Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_rank_reduce_kernel
//    (Pallas, TPU), which kept the (r, bn) accumulator in VMEM across a
//    sequential M grid axis.
//    What bounds it on the H100: reading v once (2.36 MB at M = N = 768
//    in f32, ~0.7 us); 2 r flops per element of v is far below the ridge.
//    At the training shapes the call is short enough that latency (one
//    launch, one pass of loads, the reductions) decides its time.
//    Design (the plan, from kernels/lora_matmul/plan.py::rank_reduce_plan,
//    comes in as ints):
//     * the kernel is templated on RP, the smallest power of two >= r
//       (1 ... 64); u is staged in shared memory zero-padded to RP (cp.async,
//       in flight with v's first loads), so no per-element rank predicate
//       remains and a row of u is read as broadcast 16-byte loads;
//     * each thread owns C neighbouring columns of v read with one load of
//       C elements (16 bytes: 4 f32 or 8 bf16 columns, fewer at large
//       ranks: C * RP <= 64 f32 accumulators), element loads where N is
//       not a multiple of C or v is not 16-byte aligned; 32 lanes take 32 C
//       neighbouring columns, 8 warps split the block's rows (warp w takes
//       rows w, w + 8, ...), 16 rows' loads in flight at once, the first
//       16 requested before u is staged;
//     * M is split over the S <= 8 blocks of one thread-block cluster;
//       inside a block the 8 warps' sums are added in shared memory in warp
//       order, across the cluster the blocks' partials are added through
//       distributed shared memory in rank order, and the epilogue is
//       spread over the cluster's blocks, each element of (r, N) written
//       once: one launch, no workspace, no atomics; the order of every
//       addition follows from (M, r, N, dtype) alone, so two runs give
//       equal bits.

#include "lora_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// dX: the operand policy of csrc/lora_mma.cuh
// ---------------------------------------------------------------------------

template <typename T>
struct DxOp : MmaDefaults<T> {
  static constexpr bool RQ = true;      // R[n][k] = W[k][n]: rows of W run along n
  static constexpr bool US = true;      // U = B, one adapter for every row
  const T* w;
  const T* a;
  const T* b;
  int K, r;
  __device__ __forceinline__ bool live(int) const { return true; }
  // us[j][q] = B[n0 + q][j]
  __device__ __forceinline__ void stage_u(T* us, int n0, int N, int, int tid) const {
    stage_u_rows(us, b, n0, N, r, tid);
  }
  __device__ __forceinline__ float u(int, int j, int n) const { return to_f(b[(size_t)n * r + j]); }
  __device__ __forceinline__ float v(int, int j, int k) const { return to_f(a[(size_t)j * K + k]); }
};

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_NT) dx_tile(const T* __restrict__ dy,
                                                  const T* __restrict__ w,
                                                  const T* __restrict__ a,
                                                  const T* __restrict__ b, T* __restrict__ dx,
                                                  int M, int K, int N, int r, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  mma_tile<T, BM, BN, VEC>(dy, DxOp<T>{{}, w, a, b, K, r}, dx, M, N, K, r, scale, tsm);
}

template <typename T, int BM, int BN, bool VEC>
cudaError_t run_dx(const void* dy, const void* w, const void* a, const void* b, void* dx,
                   int M, int K, int N, int r, float scale, int S, cudaStream_t st) {
  const dim3 grid(S, (M + BM - 1) / BM, (K + BN - 1) / BN);
  return cluster_launch<dx_tile<T, BM, BN, VEC>, MMA_NT>(
      grid, S, mma_smem_bytes<T, BM, BN, true, true>(r), st, static_cast<const T*>(dy),
      static_cast<const T*>(w), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(dx), M, K, N, r, scale);
}

template <typename T>
cudaError_t run_dx_plan(const void* dy, const void* w, const void* a, const void* b,
                        void* dx, int M, int K, int N, int r, float scale, int bm, int bn,
                        int S, int vec, cudaStream_t st) {
  if (S < 1 || S > 8 || (S & (S - 1))) return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return vec ? run_dx<T, 64, 64, true>(dy, w, a, b, dx, M, K, N, r, scale, S, st)
               : run_dx<T, 64, 64, false>(dy, w, a, b, dx, M, K, N, r, scale, S, st);
  if (bm == 32 && bn == 32)
    return vec ? run_dx<T, 32, 32, true>(dy, w, a, b, dx, M, K, N, r, scale, S, st)
               : run_dx<T, 32, 32, false>(dy, w, a, b, dx, M, K, N, r, scale, S, st);
  // the tuner's shape, 16-byte copies only (ptxas spills it at element
  // copies, and a 32 x 64 dX tile in f32)
  if (bm == 64 && bn == 128 && vec)
    return run_dx<T, 64, 128, true>(dy, w, a, b, dx, M, K, N, r, scale, S, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// rank reduce
// ---------------------------------------------------------------------------

constexpr int RR_NT = 256;      // threads per block
constexpr int RR_WARPS = RR_NT / 32;    // warps splitting the block's rows
constexpr int RR_U = 16;        // rows a thread loads before it adds them
constexpr int RR_US = 8192;     // floats of staged u: 8192 / RP rows a pass

// C elements of v from row `row`, columns n .. n + C - 1, as f32 (zero past N)
template <typename V, int C, bool VEC>
__device__ __forceinline__ void load_cols(const V* __restrict__ row, int n, int N,
                                          float (&x)[C]) {
  if constexpr (VEC) {                  // N % C == 0: all C columns or none
    constexpr int W = C * sizeof(V) / 4;        // 32-bit words of one load
    if (n >= N) {
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = 0.f;
    } else if constexpr (W == 0) {             // one bf16 column
      x[0] = to_f(row[n]);
    } else {
      uint32_t w[W];
      if constexpr (W == 4) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + n));
        w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
      } else if constexpr (W == 2) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(row + n));
        w[0] = t.x, w[1] = t.y;
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(row + n));
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(V) == 4) x[i] = __uint_as_float(w[i]);
        else bf16x2_to_f(w[i], x[2 * i], x[2 * i + 1]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = n + c < N ? to_f(row[n + c]) : 0.f;
  }
}

// One launch over a cluster of S blocks along x (the splits of M); blockIdx.y
// is the column tile of 32 * C columns.
template <typename V, int RP, int C, bool VEC>
__global__ void __launch_bounds__(RR_NT) lora_rank_reduce(
    const float* __restrict__ u, const V* __restrict__ v, float* __restrict__ out,
    int M, int r, int N) {
  static_assert(C * RP <= 64, "at most 64 accumulators a thread");
  constexpr int RC = RR_US / RP;        // u rows staged per pass
  constexpr int K = C * RP;             // sums per thread
  extern __shared__ __align__(16) float rsm[];   // u rows, then the warps' sums

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.y * 32 * C;
  const int n = col0 + lane * C;        // this thread's first column
  const int per = (M + S - 1) / S;      // rows of a split
  const int lo = min(M, split * per), hi = min(M, lo + per);

  float acc[C][RP];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[c][j] = 0.f;

  for (int c0 = lo; c0 < hi; c0 += RC) {
    const int rows = min(RC, hi - c0);
    // the warp's first RR_U rows of v are requested before u is staged
    float x[RR_U][C];
    auto load = [&](int m0) {
#pragma unroll
      for (int k = 0; k < RR_U; ++k) {
        const int m = m0 + k * RR_WARPS;
        if (m < rows) load_cols<V, C, VEC>(v + (size_t)(c0 + m) * N, n, N, x[k]);
      }
    };
    load(warp);
    for (int i = tid; i < rows * RP; i += RR_NT) {     // zero past r
      const int m = i / RP, j = i % RP;
      cp_async4(rsm + i, j < r ? u + (size_t)(c0 + m) * r + j : u, j < r);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int m0 = warp; m0 < rows; m0 += RR_WARPS * RR_U) {
      if (m0 != warp) load(m0);
#pragma unroll
      for (int k = 0; k < RR_U; ++k) {
        const int m = m0 + k * RR_WARPS;
        if (m >= rows) break;
        const float* ur = rsm + m * RP;
        float uj[RP];
        if constexpr (RP >= 4) {
#pragma unroll
          for (int j = 0; j < RP; j += 4) {
            const float4 t = *reinterpret_cast<const float4*>(ur + j);
            uj[j] = t.x, uj[j + 1] = t.y, uj[j + 2] = t.z, uj[j + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < RP; ++j) uj[j] = ur[j];
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int j = 0; j < RP; ++j) acc[c][j] += uj[j] * x[k][c];
      }
    }
    __syncthreads();            // the staged rows are consumed
  }

  // the warps' sums, red[w][k][lane] (k = c * RP + j), added in warp order
  float* red = rsm;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < RP; ++j) red[(warp * K + c * RP + j) * 32 + lane] = acc[c][j];
  __syncthreads();
  for (int i = tid; i < K * 32; i += RR_NT) {
    float t = red[i];
    for (int w = 1; w < RR_WARPS; ++w) t += red[w * K * 32 + i];
    red[i] = t;
  }
  cluster.sync();               // every split's partial is in place

  // epilogue spread over the cluster: the splits added in rank order
  for (int i = split * RR_NT + tid; i < K * 32; i += S * RR_NT) {
    const int l = i % 32, k = i / 32;
    const int c = k / RP, j = k % RP;
    const int col = col0 + l * C + c;
    if (j >= r || col >= N) continue;
    float t = cluster.map_shared_rank(red, 0)[i];
    for (int q = 1; q < S; ++q) t += cluster.map_shared_rank(red, q)[i];
    out[(size_t)j * N + col] = t;
  }
  cluster.sync();               // keep this block's partial until all have read
}

// Dynamic shared memory: the staged u (a split's rows, at most RR_US
// floats), then, reused, the warps' sums.
template <int RP, int C>
size_t rank_reduce_bytes(int rows_per_split) {
  const size_t us = size_t(rows_per_split < RR_US / RP ? rows_per_split : RR_US / RP) * RP;
  const size_t red = size_t(RR_WARPS) * C * RP * 32;
  return sizeof(float) * (us > red ? us : red);
}

template <typename V, int RP, int C>
cudaError_t run_rank_reduce(const float* u, const V* v, float* out, int M, int r, int N,
                            int S, bool vec, cudaStream_t st) {
  const dim3 grid(S, (N + 32 * C - 1) / (32 * C));
  const size_t bytes = rank_reduce_bytes<RP, C>((M + S - 1) / S);
  return vec ? cluster_launch<lora_rank_reduce<V, RP, C, true>, RR_NT>(grid, S, bytes, st, u,
                                                                        v, out, M, r, N)
             : cluster_launch<lora_rank_reduce<V, RP, C, false>, RR_NT>(grid, S, bytes, st,
                                                                         u, v, out, M, r, N);
}

// The instantiated (RP, C) of element type V: C = min(16 / sizeof(V), 64 / RP).
template <typename V>
cudaError_t run_rank_reduce_plan(const void* u, const void* v, void* out, int M, int r,
                                 int N, int rp, int cols, int S, int vec, cudaStream_t st) {
  // rp: the smallest power of two >= r (the switch takes powers of two)
  if (S < 1 || S > 8 || (S & (S - 1)) || rp < r || (rp > 1 && rp / 2 >= r))
    return cudaErrorInvalidValue;
  constexpr int CV = 16 / sizeof(V);
  const float* up = static_cast<const float*>(u);
  const V* vp = static_cast<const V*>(v);
  float* op = static_cast<float*>(out);
  switch (rp) {
#define RR_CASE(R)                                                                       \
  case R: {                                                                              \
    constexpr int C = CV < 64 / R ? CV : 64 / R;                                         \
    if (cols != C) return cudaErrorInvalidValue;                                         \
    return run_rank_reduce<V, R, C>(up, vp, op, M, r, N, S, vec != 0, st);               \
  }
    RR_CASE(1) RR_CASE(2) RR_CASE(4) RR_CASE(8) RR_CASE(16) RR_CASE(32) RR_CASE(64)
#undef RR_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dy, w, a, b and dx share it); the
// tile (bm, bn), the splits along N and vec are plan.py's dx_plan.
// Returns the launch's cudaError_t (0 = launched).
int lora_matmul_dx_launch(const void* dy, const void* w, const void* a, const void* b,
                          void* dx, int M, int K, int N, int r, float scale, int dtype,
                          int bm, int bn, int splits, int vec, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || K < 1 || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dx_plan<float>(dy, w, a, b, dx, M, K, N, r, scale, bm, bn, splits, vec,
                                   st);
  if (dtype == 1)
    return (int)run_dx_plan<__nv_bfloat16>(dy, w, a, b, dx, M, K, N, r, scale, bm, bn,
                                           splits, vec, st);
  return (int)cudaErrorInvalidValue;
}

// u (M, r) f32; v (M, N) of v_dtype (0 = float32, 1 = bfloat16); out
// (r, N) f32.  rp (the padded rank), cols (columns per thread), splits
// and vec are plan.py's rank_reduce_plan; a plan that names no
// instantiated kernel is refused.  Returns the launch's cudaError_t.
int lora_rank_reduce_launch(const void* u, const void* v, void* out, int M, int r, int N,
                            int v_dtype, int rp, int cols, int splits, int vec,
                            void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_dtype == 0)
    return (int)run_rank_reduce_plan<float>(u, v, out, M, r, N, rp, cols, splits, vec, st);
  if (v_dtype == 1)
    return (int)run_rank_reduce_plan<__nv_bfloat16>(u, v, out, M, r, N, rp, cols, splits,
                                                    vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* lora_matmul_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
