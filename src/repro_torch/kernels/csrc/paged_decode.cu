// Paged decode attention for Hopper (sm_90a): one query token per slot,
// GQA, over a block-table page pool.
//   q            (B, KH, G, D)     the G query heads of each KV head
//   k/v pools    (KH, NP, PS, D)   page 0 is the null page, never read
//   lengths      (B,)   int32      live entries per slot, [0, length)
//   block tables (B, MP) int32     entry j names the page of positions
//                                  [j*PS, (j+1)*PS)
//   out          (B, KH, G, D)     softmax(q k^T * D^-0.5) v, f32 inside
//
// Replaces: src/repro/kernels/flash_attention/paged_decode.py::
// paged_decode_kernel (Pallas, TPU).  There the lengths and block tables
// were scalar-prefetched so the BlockSpec index map could name each KV
// tile's page, and the logical-length grid axis ran in order with m/l/acc
// in VMEM scratch.  Here the block reads its own length and table row, and
// a loop over the live tiles inside the block carries m/l/acc in shared
// memory.
//
// What bounds it on the H100: each slot's live K and V are read once,
// 2 * KH * length * D * bytes per slot, for ~4 * G * D flops per entry per
// KV head: memory bound (and at serving batch sizes, latency bound).
//
// Design:
//  * one block per (slot b, KV head h), no split-K across blocks and no
//    atomics (split-K is later work);
//  * the block walks only the logical tiles that hold live entries
//    (ceil(length / TK) of them), gathers each tile's K/V rows through the
//    block table into shared memory as f32 (neighbouring threads on
//    neighbouring d: coalesced), and never touches entries past the
//    length, so table entries past the live prefix (page 0) are never read;
//  * scores for all G query heads of the KV head come from the same tile;
//    the K tile is padded by one float per row so the (g, j) score threads
//    hit distinct banks;
//  * online softmax in f32 across tiles; a slot of length 0 never enters
//    the loop and writes exact zeros (acc 0 / max(l, 1e-30)), matching the
//    dead-slot contract of the Pallas kernel;
//  * any page size, any length (not only multiples of the page size), and
//    any D: shared memory is sized at launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;          // logical positions per tile
constexpr int NT = 128;         // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_fwd(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ lengths, const int* __restrict__ block_tables,
    T* __restrict__ out, int KH, int G, int D, int NP, int PS, int MP,
    float scale) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* ks = sm;                   // TK x DP
  float* vs = ks + TK * DP;         // TK x D
  float* qs = vs + TK * D;          // G x D (pre-scaled)
  float* ps = qs + G * D;           // G x TK: scores, then probabilities
  float* acc = ps + G * TK;         // G x D
  float* mrow = acc + G * D;        // G
  float* lrow = mrow + G;           // G
  float* alpha = lrow + G;          // G

  const int b = blockIdx.x / KH;
  const int h = blockIdx.x % KH;
  const int tid = threadIdx.x;
  const int len = max(0, min(lengths[b], MP * PS));
  const int* row = block_tables + (size_t)b * MP;
  const size_t head = (size_t)h * NP * PS * D;
  const T* qb = q + ((size_t)b * KH + h) * G * D;

  for (int i = tid; i < G * D; i += NT) {
    qs[i] = to_f(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    mrow[g] = NEG_INF;
    lrow[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int nt = min(TK, len - t0);
    for (int i = tid; i < TK * D; i += NT) {
      const int j = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nt) {
        const int pos = t0 + j;
        const size_t off = head + ((size_t)row[pos / PS] * PS + pos % PS) * D + d;
        kv = to_f(kp[off]);
        vv = to_f(vp[off]);
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, j = i % TK;
      float s = NEG_INF;
      if (j < nt) {
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qs[g * D + d] * ks[j * DP + d];
      }
      ps[i] = s;
    }
    __syncthreads();

    for (int g = tid; g < G; g += NT) {
      float mx = mrow[g];
      for (int j = 0; j < nt; ++j) mx = fmaxf(mx, ps[g * TK + j]);
      alpha[g] = expf(mrow[g] - mx);
      mrow[g] = mx;
    }
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, j = i % TK;
      ps[i] = (j < nt) ? expf(ps[i] - mrow[g]) : 0.f;
    }
    __syncthreads();

    for (int g = tid; g < G; g += NT) {
      float s = 0.f;
      for (int j = 0; j < nt; ++j) s += ps[g * TK + j];
      lrow[g] = lrow[g] * alpha[g] + s;
    }
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      float o = acc[i] * alpha[g];
      for (int j = 0; j < nt; ++j) o += ps[g * TK + j] * vs[j * D + d];
      acc[i] = o;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * KH + h) * G * D;
  for (int i = tid; i < G * D; i += NT) {
    store(ob + i, acc[i] / fmaxf(lrow[i / D], 1e-30f));
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)TK * (D + 1) + (size_t)TK * D + 2 * (size_t)G * D +
                          (size_t)G * TK + 3 * (size_t)G);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* lengths, const int* bt, void* out, int B, int KH,
                   int G, int D, int NP, int PS, int MP, float scale,
                   size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_fwd<T><<<B * KH, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      lengths, bt, static_cast<T*>(out), KH, G, D, NP, PS, MP, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).  Returns
// cudaGetLastError() after the launch (0 = launched).
int paged_decode_launch(const void* q, const void* kp, const void* vp,
                        const void* lengths, const void* block_tables, void* out,
                        int B, int KH, int G, int D, int NP, int PS, int MP,
                        float scale, int dtype, void* stream) {
  if (B < 1 || KH < 1 || G < 1 || D < 1 || NP < 1 || PS < 1 || MP < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, D);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* bt = static_cast<const int*>(block_tables);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, kp, vp, len, bt, out, B, KH, G, D, NP, PS, MP, scale, smem, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, kp, vp, len, bt, out, B, KH, G, D, NP, PS, MP, scale,
                              smem, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
