// The register tile of the int8-base LoRA GEMM kernels for Hopper
// (sm_90a): lora_matmul_q8 and lora_matmul_q8_dx (csrc/lora_matmul_q8.cu).
// Each of the two is
//
//   out[m][p] = op.finish(sum_q L[m][q] R[q][p], p)
//               + scale * sum_j Z[m][j] V[j][p],   Z[m][j] = sum_q L[m][q] U[q][j]
//
// with L (M, Q) row-major in T (x for the forward, dY for dX), R the
// frozen weight seen along the reduction q, U and V the two adapter
// factors.  The kernel body below is written once; an operand policy
// `Op` says where R, U and V live and how R is staged:
//
//   product      Q  P  R[q][p]          U[q][j]   V[j][p]   finish
//   q8 dX        N  K  W_q[p][q] s[q]   B[q][j]   A[j][p]   acc
//   q8 forward   K  N  W_q[q][p]        A[j][q]   B[p][j]   s[p] acc
//
// Design:
//  * one block of 256 threads per (64-row M tile, 64-column P tile);
//    each thread owns a 4 x 4 register tile, rows ty + 16 i and columns
//    tx + 16 j (strided, so shared-memory reads never conflict);
//  * L and R stream through shared memory in 32-deep Q chunks, L stored
//    transposed with one float of padding per row, R as `Op::stage_r`
//    writes it (Op::RPAD floats of padding per row);
//  * the rank tile Z (64 x r) is summed in the same Q loop from a U chunk
//    staged beside the others; the epilogue adds scale * Z V and writes
//    the output once;
//  * ragged M, Q and P edges are masked here; any rank 1 <= r <= RMAX.
// Not yet: tensor cores, cp.async.  The f32 and bf16 dX moved to the
// 3xTF32 mma.sync tile of csrc/lora_mma.cuh; this pair is next.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int RMAX = 64;        // largest adapter rank taken

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int TILE_M = 64;      // output rows per block
constexpr int TILE_P = 64;      // output columns per block
constexpr int TILE_Q = 32;      // reduction chunk staged per step
constexpr int TILE_NT = 256;    // 16 x 16 threads, 4 x 4 outputs each

template <typename T, typename Op>
__global__ void __launch_bounds__(TILE_NT) lora_tile(
    const T* __restrict__ lhs, const Op op, T* __restrict__ out, int M, int Q,
    int P, int r, float scale) {
  __shared__ float ls[TILE_Q][TILE_M + 1];                         // L chunk, transposed
  __shared__ __align__(16) float rs[TILE_Q][TILE_P + Op::RPAD];    // R chunk
  __shared__ float us[TILE_Q][RMAX + 1];                           // U chunk
  __shared__ float zs[TILE_M][RMAX];                               // rank tile Z

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TILE_M;
  const int p0 = blockIdx.x * TILE_P;

  for (int i = tid; i < TILE_M * RMAX; i += TILE_NT) zs[i / RMAX][i % RMAX] = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += TILE_Q) {
    // stage: neighbouring threads on neighbouring q (coalesced)
    for (int i = tid; i < TILE_M * TILE_Q; i += TILE_NT) {
      const int m = i / TILE_Q, q = i % TILE_Q;
      const int gm = m0 + m, gq = q0 + q;
      ls[q][m] = (gm < M && gq < Q) ? to_f(lhs[(size_t)gm * Q + gq]) : 0.f;
    }
    op.stage_r(rs, q0, p0, tid);
    op.stage_u(us, q0, tid);
    __syncthreads();

#pragma unroll 4
    for (int q = 0; q < TILE_Q; ++q) {
      float lv[4], rv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lv[i] = ls[q][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) rv[j] = rs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += lv[i] * rv[j];
    }
    // rank tile: pair p = (row, rank) is always owned by the same thread
    for (int p = tid; p < TILE_M * r; p += TILE_NT) {
      const int m = p / r, j = p % r;
      float s = 0.f;
      for (int q = 0; q < TILE_Q; ++q) s += ls[q][m] * us[q][j];
      zs[m][j] += s;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i, gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gp = p0 + tx + 16 * j;
      if (gp >= P) continue;
      float d = 0.f;
      for (int q = 0; q < r; ++q) d += zs[m][q] * op.v(q, gp);
      store(out + (size_t)gm * P + gp, op.finish(acc[i][j], gp) + scale * d);
    }
  }
}

// The dX side of the table above: R is a (K, N) weight read along its
// rows' N axis, U = B (N, r), V = A (r, K).  `WStage` stages the weight
// chunk transposed, rs[n][k] = W[k][n] (times s[n] for an int8 W).
template <typename T, typename WStage>
struct DxOp {
  static constexpr int RPAD = 1;
  WStage w;
  const T* __restrict__ a;
  const T* __restrict__ b;
  int K, N, r;

  __device__ __forceinline__ void stage_r(float (&rs)[TILE_Q][TILE_P + RPAD], int n0,
                                          int k0, int tid) const {
    w.stage(rs, n0, k0, K, N, tid);
  }
  __device__ __forceinline__ void stage_u(float (&us)[TILE_Q][RMAX + 1], int n0,
                                          int tid) const {
    for (int i = tid; i < TILE_Q * r; i += TILE_NT) {
      const int n = i / r, j = i % r;
      const int gn = n0 + n;
      us[n][j] = gn < N ? to_f(b[(size_t)gn * r + j]) : 0.f;
    }
  }
  __device__ __forceinline__ float v(int j, int k) const { return to_f(a[(size_t)j * K + k]); }
  __device__ __forceinline__ float finish(float acc, int) const { return acc; }
};

}  // namespace
