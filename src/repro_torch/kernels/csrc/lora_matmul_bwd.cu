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
//    Design:
//     * grid (N / 32, S): 32 lanes on neighbouring columns n (coalesced
//       reads of v), 8 warps splitting the block's M range, each thread
//       holding r f32 sums in registers; u is staged 64 rows at a time in
//       shared memory and read as a broadcast;
//     * the 8 warps' sums are added in shared memory in a fixed order;
//       with S > 1 splits over M, each split writes its partial (r, N)
//       and a second kernel adds the S partials in order.  No atomics:
//       the result is the same bit for bit on every run.

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
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// rank reduce
// ---------------------------------------------------------------------------

constexpr int RR_LANES = 32;    // columns per block
constexpr int RR_WARPS = 8;     // warps splitting the block's M range
constexpr int RR_MC = 64;       // u rows staged per step
constexpr int RR_JC = 8;        // ranks reduced across warps per pass

template <typename V>
__global__ void __launch_bounds__(RR_LANES * RR_WARPS) lora_rank_reduce(
    const float* __restrict__ u, const V* __restrict__ v, float* __restrict__ out,
    int M, int r, int N, int rows_per_split) {
  __shared__ float us[RR_MC][RMAX];
  __shared__ float red[RR_WARPS][RR_JC][RR_LANES];

  const int lane = threadIdx.x % RR_LANES;
  const int warp = threadIdx.x / RR_LANES;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * RR_LANES + lane;
  const int split = blockIdx.y;
  const int m_lo = split * rows_per_split;
  const int m_hi = min(M, m_lo + rows_per_split);

  float acc[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.f;

  for (int c0 = m_lo; c0 < m_hi; c0 += RR_MC) {
    const int mc = min(RR_MC, m_hi - c0);
    for (int i = tid; i < mc * r; i += RR_LANES * RR_WARPS)
      us[i / r][i % r] = u[(size_t)(c0 + i / r) * r + i % r];
    __syncthreads();
    if (n < N) {
      for (int mm = warp; mm < mc; mm += RR_WARPS) {
        const float vv = to_f(v[(size_t)(c0 + mm) * N + n]);
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
          if (j < r) acc[j] += us[mm][j] * vv;
      }
    }
    __syncthreads();
  }

  // add the warps' sums in a fixed order (warp 0 first)
  float* dst = out + (size_t)split * r * N;
#pragma unroll
  for (int j0 = 0; j0 < RMAX; j0 += RR_JC) {
    if (j0 >= r) break;
#pragma unroll
    for (int jj = 0; jj < RR_JC; ++jj) red[warp][jj][lane] = acc[j0 + jj];
    __syncthreads();
    if (tid < RR_JC * RR_LANES) {
      const int jj = tid / RR_LANES, l = tid % RR_LANES;
      const int gn = blockIdx.x * RR_LANES + l;
      if (j0 + jj < r && gn < N) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < RR_WARPS; ++g) s += red[g][jj][l];
        dst[(size_t)(j0 + jj) * N + gn] = s;
      }
    }
    __syncthreads();
  }
}

// out (r, N) = sum over s of part (S, r, N), in order s = 0, 1, ...
__global__ void rank_reduce_splits(const float* __restrict__ part,
                                   float* __restrict__ out, int S, int rn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rn) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * rn + i];
  out[i] = s;
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

// The number of M splits the rank reduce uses for these shapes; the
// caller sizes the (splits, r, N) f32 workspace from it (none when 1).
int lora_rank_reduce_splits(int M, int N) {
  const int col_blocks = (N + RR_LANES - 1) / RR_LANES;
  int s = (M + 63) / 64;                    // at least 64 rows per split
  const int want = (264 + col_blocks - 1) / col_blocks;   // ~2 waves
  if (s > want) s = want;
  if (s > 32) s = 32;
  return s < 1 ? 1 : s;
}

// u (M, r) f32; v (M, N) of v_dtype (0 = float32, 1 = bfloat16);
// out (r, N) f32; work (splits, r, N) f32 when splits > 1, else unused.
int lora_rank_reduce_launch(const void* u, const void* v, void* out, void* work,
                            int M, int r, int N, int v_dtype, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int S = lora_rank_reduce_splits(M, N);
  if (S > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const int rows = (M + S - 1) / S;
  const dim3 grid((N + RR_LANES - 1) / RR_LANES, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = S > 1 ? static_cast<float*>(work) : static_cast<float*>(out);
  if (v_dtype == 0) {
    lora_rank_reduce<float><<<grid, RR_LANES * RR_WARPS, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(v), dst, M, r, N, rows);
  } else if (v_dtype == 1) {
    lora_rank_reduce<__nv_bfloat16><<<grid, RR_LANES * RR_WARPS, 0, st>>>(
        static_cast<const float*>(u), static_cast<const __nv_bfloat16*>(v), dst, M, r,
        N, rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (S > 1) {
    const int rn = r * N;
    rank_reduce_splits<<<(rn + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(work), static_cast<float*>(out), S, rn);
  }
  return (int)cudaGetLastError();
}

const char* lora_matmul_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
