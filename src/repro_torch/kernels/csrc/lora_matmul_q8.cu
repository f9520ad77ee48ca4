// Fused LoRA matmul over a weight-only int8 base, for Hopper (sm_90a): the
// forward and the dX of y = x (W_q * s) + scale * (x A^T) B^T, where W_q is
// int8 (K, N) and s its f32 per-output-channel scale (N,).
//
// 1. lora_matmul_q8:      y = x (W_q * s) + scale * (x A^T) B^T
//      x (M, K), W_q int8 (K, N) in its native layout, s f32 (N,),
//      A (r, K), B (N, r); y (M, N) in x's dtype (f32 or bf16), f32
//      accumulation.
//    Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_matmul_q8_kernel
//    (Pallas, TPU).  There the grid's innermost K axis ran in order, each
//    step dequantized its (bk, bn) W tile in VMEM (w * s) before the dot,
//    and VMEM scratch carried the (bm, bn) and (bm, r) accumulators.
// 2. lora_matmul_q8_dx:   dX = dY (W_q * s)^T + scale * (dY B) A
//      dY (M, N), W_q int8 (K, N) in its forward layout, s f32 (N,),
//      A (r, K), B (N, r); dX (M, K) in dY's dtype, f32 accumulation.
//    Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_matmul_q8_dx_kernel
//    (Pallas, TPU), which dequantized its (bk, bn) W tile per N step and
//    carried the (bm, bk) and (bm, r) accumulators across the sequential
//    N grid axis.
//
// What bounds them on the H100: on the fleets' path they run at training
// shapes (M = b * S = 256 rows per client, 768 pooled on the server,
// K = N = 768): 2 M K N flops on M K + K N / 4 + M N floats, ~250 flops
// per byte at M = 768, above every ridge.  On the tensor cores in two
// TF32 passes (below) the bound is 2 * 2 M K N / 495 TFLOP/s: 3.66 us at
// M = 768 and 1.22 us at M = 256 (13.8 and 4.6 us at f32 FFMA's 67).
//
// Design: the TF32 mma.sync tile on a cp.async ring of csrc/lora_mma.cuh
// (see its note), with two operand policies:
//  * W_q needs no split and no dequantized copy: every int8 value,
//    -128..127, has at most 8 significant bits and is exact in TF32.  So
//    W_q rides the ring as int8 (16 values per 16-byte cp.async, a
//    quarter of an f32 W's bytes), becomes f32 at the fragment read
//    ((float)q, no rounding), and only the f32 operand is split into big
//    + small: two passes, small*W_q + big*W_q, instead of 3xTF32's three.
//    A bf16 x is exact too, so the bf16 forward takes one pass;
//  * forward: L = x, R = W_q as it lies (p-major), U = A, V = B.  s is
//    constant along the K reduction, so it stays out of the tensor-core
//    product and multiplies the split-summed column once (the policy's
//    finish), before + scale * Z B^T: y_n = s_n sum_k x_k q_kn + ...  The
//    rounding then differs from JAX's dequantize-first reference by a few
//    f32 ulps of the sum;
//  * dX: L = dY, R[n][k] = W_q[k][n] (q-major: rows of W_q along n, no
//    transposed copy), U = B, V = A.  s lies on the N reduction axis and
//    cannot be factored out, so it rides the ring beside dY (32 floats a
//    stage) and multiplies dY's fragment value, rounded once in f32,
//    before the split: two passes in f32 and in bf16 (dY * s is not bf16).
//    The rank tile dY B reads the raw dY;
//  * the plan (tile, splits along the reduction from K and N alone, vec)
//    comes from kernels/lora_matmul/plan.py; ragged M, N and K edges are
//    masked, element copies where a pitch is not a multiple of 16 bytes;
//    any rank 1 <= r <= RMAX = 64; no atomics: two runs give equal bits.
// Serving M (8-16 rows) takes the same tile (the int8 base is not on a
// serving path of the port yet).

#include "lora_mma.cuh"

namespace {

// forward: R[k][n] = W_q[k][n], U = A, V = B, s[n] after the reduction
template <typename T>
struct FwdQ8Op : MmaDefaults<T> {
  using TR = int8_t;
  static constexpr bool RQ = false;     // W_q (K, N) is R[k][n], n-major
  static constexpr bool US = true;      // U = A, one adapter for every row
  const int8_t* w;
  const float* ws;
  const T* a;
  const T* b;
  int K, r;
  __device__ __forceinline__ bool live(int) const { return true; }
  // us[j][q] = A[j][k0 + q]
  __device__ __forceinline__ void stage_u(T* us, int k0, int, int, int tid) const {
    stage_u_rank_major(us, a, K, k0, K, r, tid);
  }
  __device__ __forceinline__ float v(int, int j, int n) const { return to_f(b[(size_t)n * r + j]); }
  __device__ __forceinline__ float finish(float v, int n) const { return ws[n] * v; }
};

// dX: R[n][k] = W_q[k][n], L = dY times c = s along n, U = B, V = A
template <typename T>
struct DxQ8Op : MmaDefaults<T> {
  using TR = int8_t;
  static constexpr bool L_SCALE = true;
  static constexpr bool RQ = true;      // rows of W_q run along n
  static constexpr bool US = true;      // U = B, one adapter for every row
  const int8_t* w;
  const float* ls;
  const T* a;
  const T* b;
  int K, r;
  __device__ __forceinline__ bool live(int) const { return true; }
  // us[j][q] = B[n0 + q][j]
  __device__ __forceinline__ void stage_u(T* us, int n0, int N, int, int tid) const {
    stage_u_rows(us, b, n0, N, r, tid);
  }
  __device__ __forceinline__ float v(int, int j, int k) const { return to_f(a[(size_t)j * K + k]); }
};

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_NT) q8_fwd_tile(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ y, int M, int K, int N,
    int r, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  mma_tile<T, BM, BN, VEC>(x, FwdQ8Op<T>{{}, wq, ws, a, b, K, r}, y, M, K, N, r, scale, tsm);
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_NT) q8_dx_tile(
    const T* __restrict__ dy, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ dx, int M, int K, int N,
    int r, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  mma_tile<T, BM, BN, VEC>(dy, DxQ8Op<T>{{}, wq, ws, a, b, K, r}, dx, M, N, K, r, scale, tsm);
}

// One of the two kernels (DX: the dX, over an (M, K) output; else the
// forward, over (M, N)) on a (splits, row tiles, column tiles) grid.
template <typename T, bool DX, int BM, int BN, bool VEC>
cudaError_t run_q8(const void* l, const void* wq, const void* ws, const void* a,
                   const void* b, void* out, int M, int K, int N, int r, float scale, int S,
                   cudaStream_t st) {
  const int P = DX ? K : N;
  const dim3 grid(S, (M + BM - 1) / BM, (P + BN - 1) / BN);
  const size_t bytes = mma_smem_bytes<T, BM, BN, DX, true, int8_t, DX>(r);
  const T* lp = static_cast<const T*>(l);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* sp = static_cast<const float*>(ws);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if constexpr (DX)
    return cluster_launch<q8_dx_tile<T, BM, BN, VEC>, MMA_NT>(grid, S, bytes, st, lp, wp, sp,
                                                              ap, bp, op, M, K, N, r, scale);
  else
    return cluster_launch<q8_fwd_tile<T, BM, BN, VEC>, MMA_NT>(grid, S, bytes, st, lp, wp, sp,
                                                               ap, bp, op, M, K, N, r, scale);
}

// The plan's (row tile, column tile, splits, vec) to an instantiated kernel.
template <typename T, bool DX>
cudaError_t run_q8_plan(const void* l, const void* wq, const void* ws, const void* a,
                        const void* b, void* out, int M, int K, int N, int r, float scale,
                        int bm, int bn, int S, int vec, cudaStream_t st) {
  if (S < 1 || S > 8 || (S & (S - 1))) return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return vec ? run_q8<T, DX, 64, 64, true>(l, wq, ws, a, b, out, M, K, N, r, scale, S, st)
               : run_q8<T, DX, 64, 64, false>(l, wq, ws, a, b, out, M, K, N, r, scale, S, st);
  if (bm == 32 && bn == 32)
    return vec ? run_q8<T, DX, 32, 32, true>(l, wq, ws, a, b, out, M, K, N, r, scale, S, st)
               : run_q8<T, DX, 32, 32, false>(l, wq, ws, a, b, out, M, K, N, r, scale, S, st);
  return cudaErrorInvalidValue;
}

template <bool DX>
int run_q8_dtype(const void* l, const void* wq, const void* ws, const void* a, const void* b,
                 void* out, int M, int K, int N, int r, float scale, int dtype, int bm, int bn,
                 int S, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_q8_plan<float, DX>(l, wq, ws, a, b, out, M, K, N, r, scale, bm, bn, S,
                                       vec, st);
  if (dtype == 1)
    return (int)run_q8_plan<__nv_bfloat16, DX>(l, wq, ws, a, b, out, M, K, N, r, scale, bm,
                                               bn, S, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, a, b and y share it); wq int8,
// ws float32 (N,).  The tile (bm, bn), the splits along K and vec are
// plan.py's q8_forward_plan.  Returns the launch's cudaError_t (0 =
// launched); the caller raises on anything else.
int lora_matmul_q8_fwd_launch(const void* x, const void* wq, const void* ws, const void* a,
                              const void* b, void* y, int M, int K, int N, int r, float scale,
                              int dtype, int bm, int bn, int splits, int vec, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  return run_q8_dtype<false>(x, wq, ws, a, b, y, M, K, N, r, scale, dtype, bm, bn, splits,
                             vec, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (dy, a, b and dx share it); the plan
// is plan.py's q8_dx_plan (splits along N).
int lora_matmul_q8_dx_launch(const void* dy, const void* wq, const void* ws, const void* a,
                             const void* b, void* dx, int M, int K, int N, int r, float scale,
                             int dtype, int bm, int bn, int splits, int vec, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || K < 1 || N < 0) return (int)cudaErrorInvalidValue;
  return run_q8_dtype<true>(dy, wq, ws, a, b, dx, M, K, N, r, scale, dtype, bm, bn, splits,
                            vec, stream);
}

const char* lora_matmul_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
