// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a).
//   q    (B, Sq, H, D)    the model layout: no transposed copies
//   k/v  (B, Sk, KH, D)   query head h reads KV head h / (H / KH)
//   out  (B, Sq, H, D)    softmax(q k^T * D^-0.5 + mask) v, f32 inside
// Query row i sits at absolute position q_offset + i, key j at j; key j is
// visible to row i iff j <= q_pos, q_pos - j < window (window > 0) and
// j < Sk.  A row that sees no key returns zeros (l floored at 1e-30).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (Pallas, TPU).  There the grid's innermost Sk
// axis ran in order with m, l and the output accumulator in VMEM scratch,
// and a `pl.when` skipped the score work of unreachable tiles.  Here a
// loop over KV tiles inside the block takes that place, and it only walks
// the tiles its query tile can reach (the causal skip, plus tiles wholly
// before the window), so no block spends time on masked tiles.
//
// What bounds it on the H100: 4 * B * H * Sq * Sk_visible * D flops on
// (B * (Sq * H + 2 * Sk * KH) * D) elements read once.  At the GPT-2-S
// shapes (D = 64, S = 64 to 1024) that is 16 to 256 flops per byte in
// f32, above the f32 ridge (~20) once S passes ~128: operation bound
// without tensor cores.
//
// Design:
//  * one block of 256 threads per (64-row query tile, head h, batch b);
//  * each KV tile of 64 keys is staged in shared memory as f32 (padded
//    rows for K, so the 16 threads of a query row hit distinct banks);
//  * scores: each thread owns a 4 x 4 tile (rows ty + 16 i, keys
//    tx + 16 j); the 16 threads of a row are one half-warp, so the row
//    max and row sum of the online softmax are shuffle reductions, and
//    m and l live in registers;
//  * the probabilities go through shared memory to the P V product, where
//    each thread owns 4 rows x ceil(D / 16) output columns in registers;
//  * m, l and the accumulator stay f32 for f32 and bf16 inputs; any D up
//    to 128, any Sq and Sk (ragged edges masked), any group size G >= 1.
// Not yet: wgmma / mma.sync tensor cores, cp.async double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // 16 x 16 threads
constexpr int DMAX = 128;       // largest head dim taken
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * (BK + 1));
}

// DC: output columns per thread, ceil(D / 16) rounded up to 4 or 8
template <typename T, int DC>
__global__ void __launch_bounds__(NT) flash_attention_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KH, int D, int q_offset,
    int window, float scale) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* qs = sm;                       // BQ x DP
  float* ks = qs + BQ * DP;             // BK x DP
  float* vs = ks + BK * DP;             // BK x D
  float* ps = vs + BK * D;              // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);

  const size_t q_row = (size_t)H * D;           // stride between positions
  const size_t kv_row = (size_t)KH * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] = q0 + r < Sq ? to_f(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  // tiles this query tile can reach: keys up to its last row's position,
  // and (windowed) from its first row's window start
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = min(Sk, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / BK * BK;

  float m_run[4], l_run[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                    // previous tile fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < Sk;
      ks[r * DP + d] = ok ? to_f(kb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
      vs[r * D + d] = ok ? to_f(vb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int q_pos = q_offset + q0 + row;
      const bool row_ok = q0 + row < Sq;
      bool valid[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool ok = row_ok && k_pos <= q_pos && k_pos < Sk;
        if (window > 0) ok = ok && (q_pos - k_pos) < window;
        valid[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of this row are lanes 16 * (ty % 2) + 0..15
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run[i], mt);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[row * (BK + 1) + tx + 16 * j] = p;
        ls += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + ls;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kc = min(BK, k_end - k0);
    for (int kk = 0; kk < kc; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? vs[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(ob + (size_t)(q0 + row) * q_row + d, acc[i][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int KH, int D, int q_offset, int window, float scale,
           cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  auto kern = D <= 64 ? flash_attention_fwd<T, 4> : flash_attention_fwd<T, 8>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KH, D, q_offset, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int B, int Sq, int Sk, int H, int KH, int D, int q_offset,
                           int window, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || D < 1 || D > DMAX ||
      q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, KH, D, q_offset, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, q_offset, window,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
