// Chunked SSD (Mamba2 state-space duality) forward for Hopper (sm_90a).
//   xdt (B, nh, S, hd)  x * dt, pre-scaled by the wrapper
//   g   (B, nh, S)      A * dt, the per-token log decay (<= 0)
//   Bm  (B, S, N)       the input projection of the state, shared by heads
//   Cm  (B, S, N)       the output projection of the state
//   y   (B, nh, S, hd)  y_t = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) xdt_s
//                             + exp(cum_t) C_t . h_prev      (per chunk)
//   h   (B, nh, hd, N)  the state after the last token, in the model layout
// all f32.  S is a multiple of the chunk length Q (the wrapper pads with
// g = 0 and xdt = 0, which leave the state unchanged); cum is the prefix
// sum of g inside the chunk, and across chunks the state carries over:
//   h <- h exp(cum_Q) + B^T (xdt * exp(cum_Q - cum)).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel (Pallas,
// TPU).  There the grid (B, nh, S/Q) ran the chunk axis in order with the
// (N, hd) state in VMEM scratch, and each step held one whole chunk: the
// (Q, Q) C B^T block (256 KB at Q = 256), B and C (128 KB each at N = 128).
// That is more than a block's 227 KB of shared memory, so here:
//  * one block per (column tile of 64 head dims, head, batch) walks the
//    chunks in order in a loop, the state (N x 64 f32, 32 KB at N = 128)
//    kept in shared memory across them; y[:, d] and h[:, d] depend on
//    column d of xdt alone, so the column split is exact;
//  * a chunk is walked in sub-tiles of 64 rows: for each 64-row query
//    tile, C's rows are staged once, then for each key tile at or before
//    it B's rows and xdt's are staged, the 64 x 64 C B^T tile is formed,
//    masked and scaled, and multiplied into the query tile's 64 x 64
//    accumulator; the exponential is taken only where t >= s (for t < s
//    cum_t - cum_s is positive and could overflow, and inf * 0 is NaN);
//  * cum is a block-wide prefix sum of the chunk's g (warp shuffles), kept
//    in double: the model's decays put cum in the thousands inside a
//    chunk, where an f32 ulp is ~5e-4, and every exponent the kernel takes
//    is a difference of two cum entries (exp(cum_t - cum_s) and the decay
//    to the chunk's end, exp(cum_Q - cum_s)); in f32 both ends round
//    independently, and a zero-padded last chunk does not even give the
//    last real token its exact decay of 1.  In double each difference is
//    rounded once, to f32, before expf;
//  * Q is a runtime value (the wrapper uses Q = min(chunk, S), so a prompt
//    shorter than the chunk is one chunk of its own length); a ragged last
//    sub-tile is masked, N up to 256 and any hd are taken;
//  * every thread owns a 4 x 4 tile of each 64 x 64 product (rows
//    ty + 16 i, columns tx + 16 j), so each shared-memory load feeds two
//    FMAs; rows of C, B and the masked tile are padded against bank
//    conflicts.
//
// What the function needs on the H100, in f32 without tensor cores (67
// TFLOP/s): per (batch, chunk) the causal half of C B^T, 2 (Q (Q + 1) / 2) N
// flops, shared by every head; per (batch, head, chunk) the causal half of
// the masked product, 2 (Q (Q + 1) / 2) hd, the state update 2 Q N hd, and
// C h 2 Q N hd where the incoming state is not zero (not the first chunk);
// against (B nh S (2 hd + 1) + 2 B S N + B nh hd N) * 4 bytes.  At the
// full-width prefill (nh = 80, hd = 64, N = 128) S = 200 is ~0.47 GFLOP,
// ~7 us, and S = 512 ~1.7 GFLOP, ~25 us, both bound by operations.  This
// kernel forms C B^T once per column tile and head (the Pallas kernel once
// per head): sharing it across the heads of a batch and chunk is the first
// lever left open, then tensor cores (TF32 mma) for the three products.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // 16 x 16 threads
constexpr int TR = 64;          // rows per sub-tile (query and key)
constexpr int DC = 64;          // head-dim columns per block
constexpr int HP = DC + 1;      // padded state row (N x HP)
constexpr int MP = TR + 1;      // padded row of the masked C B^T tile
constexpr int NMAX = 256;       // largest state size taken

// shared floats: cum (Q doubles, first, so 8-byte aligned), state, C tile,
// B tile, masked tile, xdt tile
size_t smem_floats(int N, int Q) {
  return 2 * (size_t)Q + (size_t)N * HP + 2 * (size_t)TR * (N + 1) + (size_t)TR * MP +
         (size_t)TR * DC;
}

// cum[0..Q) = inclusive prefix sum of g[0..Q) in double, NT entries at a time.
__device__ void chunk_cumsum(const float* __restrict__ g, double* cum, int Q,
                             double* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < Q; base += NT) {
    const int i = base + tid;
    double v = i < Q ? (double)g[i] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[w] = v;
    __syncthreads();
    double off = carry, seg = 0.0;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) {
      if (k < w) off += warp_tot[k];
      seg += warp_tot[k];
    }
    if (i < Q) cum[i] = v + off;
    carry += seg;
    __syncthreads();                    // warp_tot is rewritten next round
  }
}

// rows [r0, r0 + TR) of a (rows, N) matrix into a TR x (N + 1) tile, rows
// at or past `rows` as zeros
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int r0, int rows, int N) {
  for (int i = threadIdx.x; i < TR * N; i += NT) {
    const int r = i / N, n = i % N;
    dst[r * (N + 1) + n] = r0 + r < rows ? src[(size_t)(r0 + r) * N + n] : 0.f;
  }
}

// NK: state rows per thread in the update, ceil(N / 16) rounded up to 8 or 16;
// one block per SM (its shared memory alone asks for ~132 KB at N = 128),
// so every thread may take up to 255 registers
template <int NK>
__global__ void __launch_bounds__(NT, 1) ssd_scan_fwd(
    const float* __restrict__ xdt, const float* __restrict__ g,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ h_last, int nh, int S, int hd, int N, int Q) {
  extern __shared__ double smd[];
  __shared__ double warp_tot[NT / 32];
  const int NP = N + 1;
  double* cum = smd;                    // Q           prefix sums of g
  float* hs = reinterpret_cast<float*>(smd + Q);   // N x HP  state, rows n, columns d
  float* cs = hs + N * HP;              // TR x NP     C rows of the query tile
  float* bs = cs + TR * NP;             // TR x NP     B rows of the key tile
  float* ms = bs + TR * NP;             // TR x MP     masked, scaled C B^T
  float* xs = ms + TR * MP;             // TR x DC     xdt rows of the key tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * DC;
  const int dc = min(DC, hd - d0);
  const int head = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + head;
  const float* xb = xdt + bh * S * hd + d0;
  const float* gb = g + bh * S;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  float* yb = y + bh * S * hd + d0;

  for (int i = tid; i < N * HP; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    chunk_cumsum(gb + c0, cum, Q, warp_tot);   // also orders the state update

    // ---- outputs, one 64-row query tile at a time ------------------------
    for (int q0 = 0; q0 < Q; q0 += TR) {
      __syncthreads();                  // cs of the previous tile consumed
      stage_rows(cs, Cb + (size_t)c0 * N, q0, Q, N);
      __syncthreads();
      // inter-chunk: exp(cum_t) * C_t . h_prev
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[n * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty + 16 * i;
        const float e = t < Q ? expf((float)cum[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // intra-chunk: the key tiles at or before this query tile
      for (int k0 = 0; k0 <= q0; k0 += TR) {
        __syncthreads();                // bs, xs and ms of the previous tile consumed
        stage_rows(bs, Bb + (size_t)c0 * N, k0, Q, N);
        for (int i = tid; i < TR * DC; i += NT) {
          const int r = i / DC, d = i % DC;
          xs[i] = (k0 + r < Q && d < dc) ? xb[(size_t)(c0 + k0 + r) * hd + d] : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sk = k0 + tx + 16 * j;
            // mask before exp: cum_t - cum_s > 0 for t < s
            ms[(ty + 16 * i) * MP + tx + 16 * j] =
                (t < Q && sk <= t) ? s[i][j] * expf((float)(cum[t] - cum[sk])) : 0.f;
          }
        }
        __syncthreads();
        const int kc = min(TR, Q - k0);
        for (int sk = 0; sk < kc; ++sk) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ms[(ty + 16 * i) * MP + sk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[sk * DC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty + 16 * i;
        if (t >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx + 16 * j;
          if (d < dc) yb[(size_t)(c0 + t) * hd + d] = acc[i][j];
        }
      }
    }

    // ---- state: h <- h exp(cum_Q) + B^T (xdt * exp(cum_Q - cum)) ----------
    const double total = cum[Q - 1];
    float upd[NK][4];
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) upd[k][j] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += TR) {
      __syncthreads();                  // bs and xs consumed
      stage_rows(bs, Bb + (size_t)c0 * N, k0, Q, N);
      for (int i = tid; i < TR * DC; i += NT) {
        const int r = i / DC, d = i % DC;
        xs[i] = (k0 + r < Q && d < dc)
                    ? xb[(size_t)(c0 + k0 + r) * hd + d] * expf((float)(total - cum[k0 + r]))
                    : 0.f;
      }
      __syncthreads();
      const int kc = min(TR, Q - k0);
      for (int sk = 0; sk < kc; ++sk) {
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[sk * DC + tx + 16 * j];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = ty + 16 * k;
          const float bv = n < N ? bs[sk * NP + n] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) upd[k][j] += bv * xv[j];
        }
      }
    }
    // each thread owns its (n, d) entries: no other thread reads hs until
    // the next chunk's prefix sum has synchronised the block
    const float decay = expf((float)total);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = ty + 16 * k;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* hp = hs + n * HP + tx + 16 * j;
        *hp = *hp * decay + upd[k][j];
      }
    }
  }

  // the state in the model layout (hd, N): rows d, N contiguous
  __syncthreads();
  float* hb = h_last + (bh * hd + d0) * N;
  for (int i = tid; i < dc * N; i += NT) {
    const int d = i / N, n = i % N;
    hb[(size_t)d * N + n] = hs[n * HP + d];
  }
}

}  // namespace

extern "C" {

// All pointers f32 on the device; S % Q == 0.  Returns cudaGetLastError()
// after the launch (0 = launched).
int ssd_scan_launch(const void* xdt, const void* g, const void* Bm, const void* Cm,
                    void* y, void* h_last, int B, int nh, int S, int hd, int N, int Q,
                    void* stream) {
  if (B < 1 || nh < 1 || S < 1 || hd < 1 || N < 1 || N > NMAX || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  if (smem > 232448 - (NT / 32) * sizeof(double)) return (int)cudaErrorInvalidValue;
  auto kern = N <= 128 ? ssd_scan_fwd<8> : ssd_scan_fwd<16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((hd + DC - 1) / DC, nh, B);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(g),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(h_last), nh, S, hd, N, Q);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
