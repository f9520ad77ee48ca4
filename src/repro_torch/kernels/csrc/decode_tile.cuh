// The earlier one-token decode body for Hopper (sm_90a), kept for the
// int8-KV pair until it moves onto csrc/decode_split.cuh's split-K body
// through an int8 element policy: paged_decode_q8 (csrc/paged_decode.cu)
// and flash_decode_q8 (csrc/flash_decode.cu).  Each computes, for slot b
// and KV head h,
//
//   out[b, h, g, :] = softmax_j(q[b, h, g, :] . K_j * D^-0.5) V_j
//
// over the slot's live positions j in [lo, hi), f32 inside, with hi, lo
// and the addressing policies (SlabAddr, PagedAddr) of decode_split.cuh,
// and one element policy:
//
//   KV     Int8KV      int8 entries times the KV head's f32 scale, applied
//                      as the tile is staged (int8 -> f32 * scale, the plain
//                      version's dequantization); rows are read four bytes
//                      at a time (one char4) when every row starts on a
//                      4-byte boundary, byte by byte otherwise
//
// What bounds it on the H100: each slot's live K and V are read once,
// KH * (hi - lo) * D * 2 bytes per slot, for ~4 * G * D flops per entry
// per KV head: memory bound, and at serving batch sizes latency bound
// (one block per (slot, head) walking its tiles in series).
//
// Design:
//  * one block of 128 threads per (slot b, KV head h); no split-K across
//    blocks and no atomics;
//  * the block walks only the 32-position tiles that hold live entries,
//    from the tile holding lo to the one holding hi - 1, and stages each
//    tile's K/V rows into shared memory as f32 (neighbouring threads on
//    neighbouring d: coalesced); entries outside [lo, hi) are never read;
//  * scores for all G query heads of the KV head come from the same tile;
//    the K tile is padded by one float per row so the (g, j) score threads
//    hit distinct banks;
//  * online softmax in f32 across tiles; a slot with no live entry never
//    enters the loop and writes exact zeros (acc 0 / max(l, 1e-30)), the
//    dead-slot contract of the Pallas kernels;
//  * any length, page size and D: shared memory is sized at launch.

#pragma once

#include "decode_split.cuh"     // TK, NEG_INF, SlabAddr, PagedAddr; to_f, store

namespace {

constexpr int NT = 128;         // threads per block

// ---------------------------------------------------------------------------
// elements: stage one tile's K rows (padded, DP = D + 1 floats apart) and V
// rows (D apart) into shared memory as f32; entries j outside [jlo, nt)
// are staged as zeros without being read
// ---------------------------------------------------------------------------

struct Int8Head {
  const int8_t* k;
  const int8_t* v;
  float ksc, vsc;
  bool vec4;
  template <typename Rows>
  __device__ __forceinline__ void stage(float* ks, float* vs, const Rows& rows, int t0,
                                        int jlo, int nt, int D, int tid) const {
    const int DP = D + 1;
    if (vec4) {
      // neighbouring threads on neighbouring 4-byte pieces of a row
      const int D4 = D >> 2;
      for (int i = tid; i < TK * D4; i += NT) {
        const int j = i / D4, d = (i % D4) * 4;
        char4 kc = make_char4(0, 0, 0, 0), vc = make_char4(0, 0, 0, 0);
        if (j >= jlo && j < nt) {
          const size_t off = rows(t0 + j) + d;
          kc = *reinterpret_cast<const char4*>(k + off);
          vc = *reinterpret_cast<const char4*>(v + off);
        }
        float* kr = ks + j * DP + d;
        float* vr = vs + j * D + d;
        kr[0] = (float)kc.x * ksc;
        kr[1] = (float)kc.y * ksc;
        kr[2] = (float)kc.z * ksc;
        kr[3] = (float)kc.w * ksc;
        vr[0] = (float)vc.x * vsc;
        vr[1] = (float)vc.y * vsc;
        vr[2] = (float)vc.z * vsc;
        vr[3] = (float)vc.w * vsc;
      }
      return;
    }
    for (int i = tid; i < TK * D; i += NT) {
      const int j = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j >= jlo && j < nt) {
        const size_t off = rows(t0 + j) + d;
        kv = (float)k[off] * ksc;
        vv = (float)v[off] * vsc;
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
  }
};

struct Int8KV {                 // int8 entries, f32 (KH,) scales
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  bool vec4;
  __device__ __forceinline__ Int8Head head(int h) const {
    return {k, v, k_scale[h], v_scale[h], vec4};
  }
};

// Every row starts on a 4-byte boundary iff D % 4 == 0 and both bases do
// (row offsets are multiples of D in either layout).
inline bool char4_rows(const void* k, const void* v, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 4 == 0;
}

// ---------------------------------------------------------------------------
// the kernel: q and out (B, KH, G, D) in T; lengths (B,) int32
// ---------------------------------------------------------------------------

template <typename T, typename KV, typename Addr>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const KV kv, const Addr addr,
    const int* __restrict__ lengths, T* __restrict__ out, int KH, int G, int D,
    int window, float scale) {
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
  const int len = lengths[b];
  const int hi = max(0, min(len, addr.capacity()));
  const int lo = window > 0 ? min(max(0, len - window), hi) : 0;
  const auto rows = addr.rows(b, h);
  const auto kvh = kv.head(h);
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

  for (int t0 = (lo / TK) * TK; t0 < hi; t0 += TK) {
    const int nt = min(TK, hi - t0);
    const int jlo = max(lo - t0, 0);
    kvh.stage(ks, vs, rows, t0, jlo, nt, D, tid);
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, j = i % TK;
      float s = NEG_INF;
      if (j >= jlo && j < nt) {
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
      ps[i] = (j >= jlo && j < nt) ? expf(ps[i] - mrow[g]) : 0.f;
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

inline size_t decode_smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)TK * (D + 1) + (size_t)TK * D + 2 * (size_t)G * D +
                          (size_t)G * TK + 3 * (size_t)G);
}

// Launch one decode grid of B * KH blocks on stream s.  Returns
// cudaGetLastError() after the launch (0 = launched).
template <typename T, typename KV, typename Addr>
cudaError_t launch_decode(const void* q, const KV& kv, const Addr& addr,
                          const void* lengths, void* out, int B, int KH, int G, int D,
                          int window, float scale, cudaStream_t s) {
  if (B < 1 || KH < 1 || G < 1 || D < 1) return cudaErrorInvalidValue;
  const size_t smem = decode_smem_bytes(G, D);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, KV, Addr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_kernel<T, KV, Addr><<<B * KH, NT, smem, s>>>(
      static_cast<const T*>(q), kv, addr, static_cast<const int*>(lengths),
      static_cast<T*>(out), KH, G, D, window, scale);
  return cudaGetLastError();
}

}  // namespace
