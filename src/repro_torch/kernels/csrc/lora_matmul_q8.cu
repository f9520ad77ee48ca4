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
//    Here a loop over K inside the block takes that place.
//    What bounds it on the H100: on this slice's path it runs at training
//    shapes (M = b * S = 256 rows per client, 768 pooled on the server,
//    K = N = 768): 2 M K N flops on M K + K N / 4 + M N floats, ~250
//    flops per byte at M = 768 — above the f32 ridge (67 TFLOP/s over
//    3.35 TB/s = 20).  Bound by f32 operations without tensor cores:
//    ~13.8 us at M = 768, ~4.6 us at M = 256.
//    Design (the 64 x 64 register tile of csrc/lora_tile.cuh), with P = N
//    output columns per block and the loop over K inside the block:
//     * x and W stream through shared memory in 32-deep K chunks.  W is
//       read as int8 in its (K, N) layout, four neighbouring columns per
//       thread (one char4): a warp reads two 64-byte row pieces, whole
//       32-byte sectors, and a quarter of the f32 kernel's bytes;
//     * the per-output-channel scale is constant along the K reduction,
//       so the kernel sums x_k q_kn and applies s_n once after the K
//       loop: y_n = s_n sum_k x_k q_kn + scale (z B^T)_n.  The rounding
//       then differs from JAX's dequantize-first reference by a few f32
//       ulps of the sum, far inside the f32 tolerance;
//     * the rank tile z = x A^T (64 x r) is summed in the same K loop from
//       an A chunk staged beside the others; the epilogue adds
//       scale * z B^T and writes y once;
//     * ragged M, N and K are masked here (the JAX wrapper pads); a W
//       whose rows do not start on 4-byte boundaries is read byte by
//       byte; any rank 1 <= r <= RMAX = 64.
//    Serving M (8-16 rows) works too, on few blocks (the int8 base is not
//    on a serving path of the port yet).
//
// 2. lora_matmul_q8_dx:   dX = dY (W_q * s)^T + scale * (dY B) A
//      dY (M, N), W_q int8 (K, N) in its forward layout, s f32 (N,),
//      A (r, K), B (N, r); dX (M, K) in dY's dtype, f32 accumulation.
//    Replaces: src/repro/kernels/lora_matmul/kernel.py::lora_matmul_q8_dx_kernel
//    (Pallas, TPU), which dequantized its (bk, bn) W tile per N step and
//    carried the (bm, bk) and (bm, r) accumulators across the sequential
//    N grid axis.
//    What bounds it: the same GEMM work as the forward, f32 operations:
//    ~13.8 us at M = 768, ~4.6 us at M = 256.
//    Design: the dX product of csrc/lora_tile.cuh (its DxOp with an int8
//    weight stage: 64 x 64 per block, 4 x 4 per thread, N loop inside
//    the block, the rank tile dY B summed in the same loop).  The scale
//    sits on the N reduction axis and cannot be factored out, so W is
//    dequantized while it is staged: each thread reads a char4 of int8 W
//    along n, multiplies by s_n and stores the four products transposed
//    into padded shared memory.  The products equal the reference's
//    w_q * s exactly; only the summation order differs.
//
// Not yet (both): wgmma / TF32 tensor cores, cp.async double buffering.

#include <stdint.h>

#include "lora_tile.cuh"

namespace {

// W is read four int8 columns at a time (one char4) when every row starts
// on a 4-byte boundary; otherwise byte by byte.
bool char4_rows(const void* wq, int N) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
}

// ---------------------------------------------------------------------------
// forward: Q = K, P = N; R = W_q as it lies, U = A^T, V = B^T, s after the
// K loop
// ---------------------------------------------------------------------------

template <typename T>
struct FwdQ8Op {
  static constexpr int RPAD = 0;   // rows of 64 floats: float4 stores
  const int8_t* __restrict__ wq;
  const float* __restrict__ ws;
  const T* __restrict__ a;
  const T* __restrict__ b;
  int K, N, r;
  bool vec;

  __device__ __forceinline__ void stage_r(float (&rs)[TILE_Q][TILE_P + RPAD], int k0,
                                          int n0, int tid) const {
    // neighbouring threads on neighbouring n, one char4 each
    if (vec) {
      for (int i = tid; i < TILE_Q * (TILE_P / 4); i += TILE_NT) {
        const int k = i / (TILE_P / 4), c = 4 * (i % (TILE_P / 4));
        const int gk = k0 + k, gn = n0 + c;
        char4 v = make_char4(0, 0, 0, 0);
        if (gk < K && gn < N)               // N % 4 == 0: all four in range
          v = *reinterpret_cast<const char4*>(wq + (size_t)gk * N + gn);
        *reinterpret_cast<float4*>(&rs[k][c]) =
            make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
      }
    } else {
      for (int i = tid; i < TILE_Q * TILE_P; i += TILE_NT) {
        const int k = i / TILE_P, n = i % TILE_P;
        const int gk = k0 + k, gn = n0 + n;
        rs[k][n] = (gk < K && gn < N) ? (float)wq[(size_t)gk * N + gn] : 0.f;
      }
    }
  }
  __device__ __forceinline__ void stage_u(float (&us)[TILE_Q][RMAX + 1], int k0,
                                          int tid) const {
    for (int i = tid; i < r * TILE_Q; i += TILE_NT) {
      const int j = i / TILE_Q, k = i % TILE_Q;
      const int gk = k0 + k;
      us[k][j] = gk < K ? to_f(a[(size_t)j * K + gk]) : 0.f;
    }
  }
  __device__ __forceinline__ float v(int j, int n) const { return to_f(b[(size_t)n * r + j]); }
  __device__ __forceinline__ float finish(float acc, int n) const { return ws[n] * acc; }
};

// ---------------------------------------------------------------------------
// dX: DxOp with an int8 weight stage, rs[n][k] = W_q[k][n] * s[n]
// ---------------------------------------------------------------------------

struct WRowsQ8 {
  const int8_t* __restrict__ wq;
  const float* __restrict__ ws;
  bool vec;

  __device__ __forceinline__ void stage(float (&rs)[TILE_Q][TILE_P + 1], int n0, int k0,
                                        int K, int N, int tid) const {
    if (vec) {
      for (int i = tid; i < TILE_P * (TILE_Q / 4); i += TILE_NT) {
        const int k = i / (TILE_Q / 4), c = 4 * (i % (TILE_Q / 4));
        const int gk = k0 + k, gn = n0 + c;
        if (gk < K && gn < N) {
          const char4 v = *reinterpret_cast<const char4*>(wq + (size_t)gk * N + gn);
          rs[c][k] = (float)v.x * ws[gn];
          rs[c + 1][k] = (float)v.y * ws[gn + 1];
          rs[c + 2][k] = (float)v.z * ws[gn + 2];
          rs[c + 3][k] = (float)v.w * ws[gn + 3];
        } else {
          rs[c][k] = rs[c + 1][k] = rs[c + 2][k] = rs[c + 3][k] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < TILE_P * TILE_Q; i += TILE_NT) {
        const int k = i / TILE_Q, n = i % TILE_Q;
        const int gk = k0 + k, gn = n0 + n;
        rs[n][k] = (gk < K && gn < N) ? (float)wq[(size_t)gk * N + gn] * ws[gn] : 0.f;
      }
    }
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, a, b and y share it); wq int8,
// ws float32 (N,).  Returns cudaGetLastError() after the launch (0 =
// launched); the caller raises on anything else.
int lora_matmul_q8_fwd_launch(const void* x, const void* wq, const void* ws,
                              const void* a, const void* b, void* y, int M, int K,
                              int N, int r, float scale, int dtype, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TILE_P - 1) / TILE_P, (M + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(ws);
  const bool vec = char4_rows(wq, N);
  if (dtype == 0) {
    const FwdQ8Op<float> op{q, sc, static_cast<const float*>(a),
                            static_cast<const float*>(b), K, N, r, vec};
    lora_tile<float, FwdQ8Op<float>><<<grid, TILE_NT, 0, s>>>(
        static_cast<const float*>(x), op, static_cast<float*>(y), M, K, N, r, scale);
  } else if (dtype == 1) {
    const FwdQ8Op<__nv_bfloat16> op{q, sc, static_cast<const __nv_bfloat16*>(a),
                                    static_cast<const __nv_bfloat16*>(b), K, N, r, vec};
    lora_tile<__nv_bfloat16, FwdQ8Op<__nv_bfloat16>><<<grid, TILE_NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), op, static_cast<__nv_bfloat16*>(y), M, K, N,
        r, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (dy, a, b and dx share it).
int lora_matmul_q8_dx_launch(const void* dy, const void* wq, const void* ws,
                             const void* a, const void* b, void* dx, int M, int K,
                             int N, int r, float scale, int dtype, void* stream) {
  if (r < 1 || r > RMAX || M < 1 || K < 1 || N < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + TILE_P - 1) / TILE_P, (M + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WRowsQ8 wst{static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
                    char4_rows(wq, N)};
  if (dtype == 0) {
    using Op = DxOp<float, WRowsQ8>;
    const Op op{wst, static_cast<const float*>(a), static_cast<const float*>(b), K, N, r};
    lora_tile<float, Op><<<grid, TILE_NT, 0, s>>>(
        static_cast<const float*>(dy), op, static_cast<float*>(dx), M, N, K, r, scale);
  } else if (dtype == 1) {
    using Op = DxOp<__nv_bfloat16, WRowsQ8>;
    const Op op{wst, static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), K, N, r};
    lora_tile<__nv_bfloat16, Op><<<grid, TILE_NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), op, static_cast<__nv_bfloat16*>(dx), M, N,
        K, r, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* lora_matmul_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
