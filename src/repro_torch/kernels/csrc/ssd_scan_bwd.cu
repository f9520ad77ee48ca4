// The backward of the chunked SSD scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), in the forward's kernel layout:
//   xdt (B, nh, S, hd)   x * dt            g   (B, nh, S)   A * dt <= 0
//   Bm  (B, S, N)        shared by heads   Cm  (B, S, N)
//   dy  (B, nh, S, hd)   the cotangent of y
//   dh  (B, nh, hd, N)   the cotangent of the final state, or none (zero)
// -> dxdt (B, nh, S, hd), dg (B, nh, S), dBm (B, S, N), dCm (B, S, N)
// (dBm and dCm summed over heads), all f32, S a multiple of the chunk Q.
//
// Within a chunk, cum is the prefix sum of g, h0 the incoming state, dh_end
// the cotangent of the outgoing one (the next chunk's dh0; dh for the last
// chunk) and E[t, s] = exp(cum_t - cum_s) for s <= t, else 0:
//   dh0    = exp(cum_Q) dh_end + sum_t exp(cum_t) dy_t C_t^T
//   dxdt_s = sum_t (C_t . B_s) E[t, s] dy_t + exp(cum_Q - cum_s) dh_end B_s
//   dB_s   = sum_heads [sum_t E[t, s] (dy_t . xdt_s) C_t + exp(cum_Q - cum_s) dh_end^T xdt_s]
//   dC_t   = sum_heads [sum_s E[t, s] (dy_t . xdt_s) B_s + exp(cum_t) h0^T dy_t]
//   dg_u   = sum_{t >= u} (sum_s P[t, s] - sum_s P[s, t] + I_t) + sum_{s < u} R_s
//            + exp(cum_Q) <dh_end, h0>
// with P[t, s] = (C_t . B_s) E[t, s] (dy_t . xdt_s), I_t = exp(cum_t) C_t .
// (h0^T dy_t), R_s = exp(cum_Q - cum_s) B_s . (dh_end^T xdt_s), per head
// (kernels/ssd_scan/ref.py::ssd_scan_bwd_ref is the plain version).
//
// Replaces no Pallas kernel: src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_kernel is forward only, and repro trains Mamba2 by jax.grad
// through its jnp src/repro/models/ssm.py::ssd_chunked.  The port's
// forward on the card is csrc/ssd_scan.cu, so its gradient is a kernel too.
//
// What bounds it on the H100: per (batch, head, chunk) the causal halves of
// four Q x Q products, dy xdt^T (K = hd), (C B^T o E)^T dy (hd), (E o G)^T C
// and (E o G) B (N), 2 (Q (Q + 1) / 2) (2 hd + 2 N) flops, and five
// Q x hd x N products (the two state terms of dxdt and dB, the inter-chunk
// term of dC and the two state recurrences), 10 Q hd N; per (batch, chunk)
// C B^T, Q (Q + 1) N.  At Mamba2-2.7B's training shape (B 2, S 512, 80
// heads of 64, N 128, Q 256) that is ~14.8 GFLOP against ~70 MB: bound by
// its operations, ~0.22 ms in f32 FFMA at 67 TFLOP/s.
//
// Design (simple and right first; the tensor cores and fewer passes are
// later work): seven launches on the caller's stream, no atomics, every sum
// in a fixed order, so two runs give equal bits.
//  1. cum: each chunk's prefix sums of g in double (one thread a chunk).
//     Every exponent is a difference of these, taken in double and rounded
//     once to f32: at Mamba2-2.7B's decays cum reaches the thousands inside
//     a chunk, where an f32 ulp is ~5e-4 (the forward's rule).  With g <= 0
//     every factor is <= 1;
//  2. C B^T of each (batch, chunk), its causal 64 x 64 tiles, shared by
//     every head;
//  3. the forward's state recurrence again (the state entering each chunk
//     and the last one), then 4. the reverse recurrence of dh (dh_end of
//     each chunk): one block per (batch, head, 32 x 32 tile of the state),
//     each thread four entries in registers, rows staged through shared
//     memory 32 at a time;
//  5. per (batch, head, chunk, 64-row tile i) one block of 256 threads: the
//     tile's dxdt rows, its rows of the head's dB and dC (partials), and
//     its per-row terms of dg (the pairs' row sums for t in i and column
//     sums for s in i, I_t and R_s, in double), from the precomputed C B^T,
//     states and dh_end; the per-head dy xdt^T tiles are formed in the
//     block (the pair (j, i) once for the column sums and once for the row
//     sums, with the same operands in the same order, so both see the
//     same P and the pairs' rounding cancels over the chunk).  Every
//     product is a 64 x 64 FFMA tile (each thread 4 x 4 outputs) over
//     operand slabs of 32 staged in shared memory, the staging order
//     chosen so that each global read is coalesced; dB's and dC's 64 x N
//     accumulators live in shared memory, each entry owned by one thread;
//  6. dB and dC summed over heads in order, one thread an entry;
//  7. dg: the reverse prefix sum of each chunk's row terms plus the prefix
//     sum of R over s < u and the carried state's term, in double.
// Not yet: mma.sync / wgmma, the chunk states saved by the forward instead
// of recomputed, passes 3-7 fused.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BT = 256;          // threads of every block
constexpr int TR = 64;           // rows of a row tile; side of an output tile
constexpr int KS = 32;           // depth of a staged operand slab
constexpr int AP = KS + 1;       // pitch of the A slab
constexpr int BP = TR + 1;       // pitch of the B slab and of a P tile
constexpr int SD = 32;           // side of a state tile (passes 3, 4)
constexpr int NMAX = 256;        // largest state size taken

// acc (64 x 64, each thread its 4 x 4: rows ty + 16 a, columns tx + 16 b)
// += A (64 x K) B (K x 64), the operands' entries from fa(r, k) and fb(k, c)
// (each 0 outside its operand).  A_K / B_K: stage with k the fastest index
// (for a source whose k is contiguous in memory), else r or c.
template <bool A_K, bool B_K, class FA, class FB>
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], int K, FA fa, FB fb, float* As,
                                         float* Bs) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += KS) {
    for (int e = tid; e < TR * KS; e += BT) {
      const int r = A_K ? e / KS : e % TR, k = A_K ? e % KS : e / TR;
      As[r * AP + k] = k0 + k < K ? fa(r, k0 + k) : 0.f;
    }
    for (int e = tid; e < KS * TR; e += BT) {
      const int k = B_K ? e % KS : e / TR, c = B_K ? e / KS : e % TR;
      Bs[k * BP + c] = k0 + k < K ? fb(k0 + k, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KS; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * AP + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * BP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// 1. cum of each (batch, head, chunk): rows = B nh nc
__global__ void __launch_bounds__(BT) bwd_cum(const float* __restrict__ g, double* cum,
                                              long long rows, int Q) {
  const long long u = (long long)blockIdx.x * BT + threadIdx.x;
  if (u >= rows) return;
  const float* gp = g + u * Q;
  double* cp = cum + u * Q;
  double s = 0.0;
  for (int t = 0; t < Q; ++t) {
    s += (double)gp[t];
    cp[t] = s;
  }
}

// 2. cb[b, c] (Q x Q, row t, column s) = C_t . B_s for the causal tiles
__global__ void __launch_bounds__(BT) bwd_cb(const float* __restrict__ Bm,
                                             const float* __restrict__ Cm, float* cb, int nc,
                                             int Q, int N, int T) {
  int u = blockIdx.x;
  const int tj = u % T;
  u /= T;
  const int ti = u % T;
  u /= T;
  const int c = u % nc, b = u / nc;
  if (tj > ti) return;
  __shared__ float As[TR * AP], Bs[KS * BP];
  const size_t row = ((size_t)b * nc + c) * Q;          // (b S + c Q)
  const float* Bc = Bm + row * N;
  const float* Cc = Cm + row * N;
  const int t0 = ti * TR, s0 = tj * TR;
  const int nt = min(TR, Q - t0), ns = min(TR, Q - s0);
  float acc[4][4];
  zero(acc);
  tile_fma<true, true>(
      acc, N, [&](int r, int k) { return r < nt ? Cc[(size_t)(t0 + r) * N + k] : 0.f; },
      [&](int k, int s) { return s < ns ? Bc[(size_t)(s0 + s) * N + k] : 0.f; }, As, Bs);
  float* out = cb + ((size_t)b * nc + c) * Q * Q;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      if (t < nt && s < ns) out[(size_t)(t0 + t) * Q + s0 + s] = acc[i][j];
    }
}

// 3. (REV false) the state entering each chunk, out (B, nh, nc + 1, hd, N),
//    the last entry the final state:
//      h <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) xdt_s B_s^T
// 4. (REV true) dh_end of each chunk, out (B, nh, nc, hd, N), from dh:
//      dh <- exp(cum_Q) dh + sum_t exp(cum_t) dy_t C_t^T
// One block per (batch, head, 32 x 32 state tile); thread tid holds the
// entries (d0 + tid / 8, n0 + 4 (tid % 8) + j), j < 4.
template <bool REV>
__global__ void __launch_bounds__(BT) bwd_states(const float* __restrict__ src,
                                                 const float* __restrict__ proj,
                                                 const double* __restrict__ cum,
                                                 const float* __restrict__ init, float* out,
                                                 int nh, int S, int hd, int N, int Q,
                                                 int dtiles, int ntiles) {
  int u = blockIdx.x;
  const int nt = u % ntiles;
  u /= ntiles;
  const int dtl = u % dtiles;
  const int bh = u / dtiles, b = bh / nh;
  const int nc = S / Q, tid = threadIdx.x;
  const int d0 = dtl * SD, n0 = nt * SD;
  const int d = d0 + tid / 8, nb = n0 + 4 * (tid % 8);
  __shared__ float ws[SD];
  __shared__ __align__(16) float xs[SD][SD];
  __shared__ __align__(16) float ps[SD][SD];
  float h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = (REV && init != nullptr && d < hd && nb + j < N)
               ? init[((size_t)bh * hd + d) * N + nb + j]
               : 0.f;
  const size_t hdn = (size_t)hd * N;
  for (int step = 0; step < nc; ++step) {
    const int c = REV ? nc - 1 - step : step;
    float* o = out + ((size_t)bh * (REV ? nc : nc + 1) + c) * hdn;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d < hd && nb + j < N) o[(size_t)d * N + nb + j] = h[j];
    const double* cc = cum + (size_t)bh * S + (size_t)c * Q;
    const double cq = cc[Q - 1];
    const float decay = __expf((float)cq);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] *= decay;
    const float* sp = src + ((size_t)bh * S + (size_t)c * Q) * hd;
    const float* pp = proj + ((size_t)b * S + (size_t)c * Q) * N;
    for (int r0 = 0; r0 < Q; r0 += SD) {
      if (tid < SD) {
        const int s = r0 + tid;
        ws[tid] = s < Q ? (REV ? __expf((float)cc[s]) : __expf((float)(cq - cc[s]))) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < SD * SD; e += BT) {
        const int r = e / SD, k = e % SD, s = r0 + r;
        xs[r][k] = (s < Q && d0 + k < hd) ? sp[(size_t)s * hd + d0 + k] * ws[r] : 0.f;
        ps[r][k] = (s < Q && n0 + k < N) ? pp[(size_t)s * N + n0 + k] : 0.f;
      }
      __syncthreads();
      const int dl = tid / 8, nl = 4 * (tid % 8);
#pragma unroll 8
      for (int r = 0; r < SD; ++r) {
        const float xv = xs[r][dl];
        const float4 p = *reinterpret_cast<const float4*>(&ps[r][nl]);
        h[0] = fmaf(xv, p.x, h[0]);
        h[1] = fmaf(xv, p.y, h[1]);
        h[2] = fmaf(xv, p.z, h[2]);
        h[3] = fmaf(xv, p.w, h[3]);
      }
      __syncthreads();
    }
  }
  if (!REV) {
    float* o = out + ((size_t)bh * (nc + 1) + nc) * hdn;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d < hd && nb + j < N) o[(size_t)d * N + nb + j] = h[j];
  }
}

struct ChunkArgs {
  const float *xdt, *dy, *Bm, *Cm, *cb, *H, *DH;
  const double* cum;
  float *dx, *pb, *pc;
  double *d1, *rs, *kc;               // per-row terms of dg; per-chunk carried term
  int nh, S, hd, N, Q, T;
};

// 5. one block per (batch, head, chunk, row tile i).  Dynamic shared memory:
// the 64 x N accumulator of dB or dC rows.
__global__ void __launch_bounds__(BT) bwd_chunk(ChunkArgs a) {
  extern __shared__ __align__(16) float acc_s[];
  __shared__ double cum_i[TR], cum_j[TR];
  __shared__ float wend[TR], win[TR];
  __shared__ float As[TR * AP], Bs[KS * BP], pt[TR * BP];
  __shared__ double red[16 * TR];
  __shared__ double rowp[TR], colp[TR], inter[TR], rterm[TR];

  const int N = a.N, hd = a.hd, Q = a.Q, T = a.T, nc = a.S / Q;
  int u = blockIdx.x;
  const int i = u % T;
  u /= T;
  const int c = u % nc, bh = u / nc, b = bh / a.nh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = i * TR, ni = min(TR, Q - r0);
  const size_t rowbase = (size_t)bh * a.S + (size_t)c * Q;   // chunk's first row, (B, nh, S)
  const size_t brow = (size_t)b * a.S + (size_t)c * Q;       // and in (B, S)
  const float* xg = a.xdt + rowbase * hd;
  const float* yg = a.dy + rowbase * hd;
  const float* Bg = a.Bm + brow * N;
  const float* Cg = a.Cm + brow * N;
  const double* cg = a.cum + rowbase;
  const float* cbg = a.cb + ((size_t)b * nc + c) * Q * Q;
  const size_t hdn = (size_t)hd * N;
  const float* h0 = a.H + ((size_t)bh * (nc + 1) + c) * hdn;
  const float* dh = a.DH + ((size_t)bh * nc + c) * hdn;
  const double cq = cg[Q - 1];

  if (tid < TR) {
    const bool ok = tid < ni;
    const double ci = ok ? cg[r0 + tid] : 0.0;
    cum_i[tid] = ci;
    wend[tid] = ok ? __expf((float)(cq - ci)) : 0.f;
    win[tid] = ok ? __expf((float)ci) : 0.f;
  }
  auto load_cum_j = [&](int j) {
    __syncthreads();
    if (tid < TR) cum_j[tid] = j * TR + tid < Q ? cg[j * TR + tid] : 0.0;
    __syncthreads();
  };
  // a thread's own entries of the 64 x N accumulator, column block n0
  auto own_load = [&](float (&acc)[4][4], int n0) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int n = n0 + tx + 16 * y;
        acc[x][y] = n < N ? acc_s[(ty + 16 * x) * N + n] : 0.f;
      }
  };
  auto own_store = [&](const float (&acc)[4][4], int n0) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int n = n0 + tx + 16 * y;
        if (n < N) acc_s[(ty + 16 * x) * N + n] = acc[x][y];
      }
  };
  // the (t tile, s tile) pair's P = (C_t . B_s) E[t, s] G[t, s] into pt
  // (thread-owned entries), G = dy_t . xdt_s over hd; returns nothing but
  // leaves E o G in `eg` for the products
  auto pair_tile = [&](float (&eg)[4][4], int t0, int nt, const double* cum_t, int s0,
                       int ns, const double* cum_s) {
    zero(eg);
    tile_fma<true, true>(
        eg, hd, [&](int t, int k) { return t < nt ? yg[(size_t)(t0 + t) * hd + k] : 0.f; },
        [&](int k, int s) { return s < ns ? xg[(size_t)(s0 + s) * hd + k] : 0.f; }, As, Bs);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int t = ty + 16 * x, s = tx + 16 * y;
        const bool ok = t < nt && s < ns && t0 + t >= s0 + s;
        eg[x][y] = ok ? eg[x][y] * __expf((float)(cum_t[t] - cum_s[s])) : 0.f;
        pt[t * BP + s] = ok ? eg[x][y] * cbg[(size_t)(t0 + t) * Q + s0 + s] : 0.f;
      }
  };
  // sums of thread partials part[x] (row ty + 16 x) over the 16 tx, in order
  auto row_reduce = [&](const double (&part)[4], double* dst) {
#pragma unroll
    for (int x = 0; x < 4; ++x) red[(ty + 16 * x) * 16 + tx] = part[x];
    __syncthreads();
    if (tid < TR) {
      double s = 0.0;
      for (int k = 0; k < 16; ++k) s += red[tid * 16 + k];
      dst[tid] = s;
    }
    __syncthreads();
  };

  // ---- dxdt_s, s in tile i -------------------------------------------------
  for (int d0 = 0; d0 < hd; d0 += TR) {
    float acc[4][4];
    zero(acc);
    for (int j = i; j < T; ++j) {
      load_cum_j(j);
      const int t0 = j * TR, nj = min(TR, Q - t0);
      tile_fma<false, false>(
          acc, nj,
          [&](int s, int t) {
            return (s < ni && t0 + t >= r0 + s)
                       ? cbg[(size_t)(t0 + t) * Q + r0 + s] *
                             __expf((float)(cum_j[t] - cum_i[s]))
                       : 0.f;
          },
          [&](int t, int dd) { return d0 + dd < hd ? yg[(size_t)(t0 + t) * hd + d0 + dd] : 0.f; },
          As, Bs);
    }
    tile_fma<true, true>(
        acc, N, [&](int s, int n) { return s < ni ? Bg[(size_t)(r0 + s) * N + n] * wend[s] : 0.f; },
        [&](int n, int dd) { return d0 + dd < hd ? dh[(size_t)(d0 + dd) * N + n] : 0.f; }, As,
        Bs);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int s = ty + 16 * x, dd = d0 + tx + 16 * y;
        if (s < ni && dd < hd) a.dx[(rowbase + r0 + s) * hd + dd] = acc[x][y];
      }
  }

  // ---- dB_s (this head's), s in tile i: pairs with t in tiles j >= i --------
  for (int e = tid; e < TR * N; e += BT) acc_s[e] = 0.f;
  double cpart[4] = {0.0, 0.0, 0.0, 0.0};     // column sums of P, columns tx + 16 y
  for (int j = i; j < T; ++j) {
    load_cum_j(j);
    const int t0 = j * TR, nj = min(TR, Q - t0);
    float eg[4][4];
    pair_tile(eg, t0, nj, cum_j, r0, ni, cum_i);
    __syncthreads();
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) cpart[y] += (double)pt[(ty + 16 * x) * BP + tx + 16 * y];
    // pt now holds P; the product needs E o G: write it over pt
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) pt[(ty + 16 * x) * BP + tx + 16 * y] = eg[x][y];
    __syncthreads();
    for (int n0 = 0; n0 < N; n0 += TR) {
      float acc[4][4];
      own_load(acc, n0);
      tile_fma<false, false>(
          acc, nj, [&](int s, int t) { return pt[t * BP + s]; },
          [&](int t, int n) { return n0 + n < N ? Cg[(size_t)(t0 + t) * N + n0 + n] : 0.f; }, As,
          Bs);
      own_store(acc, n0);
    }
  }
  // column sums: partials of rows (ty, x) for column tx + 16 y, over ty
  {
#pragma unroll
    for (int y = 0; y < 4; ++y) red[(tx + 16 * y) * 16 + ty] = cpart[y];
    __syncthreads();
    if (tid < TR) {
      double s = 0.0;
      for (int k = 0; k < 16; ++k) s += red[tid * 16 + k];
      colp[tid] = s;
    }
    __syncthreads();
  }
  {
    double rpart[4] = {0.0, 0.0, 0.0, 0.0};
    for (int n0 = 0; n0 < N; n0 += TR) {
      float st[4][4], acc[4][4];
      zero(st);
      tile_fma<true, false>(
          st, hd, [&](int s, int k) { return s < ni ? xg[(size_t)(r0 + s) * hd + k] * wend[s] : 0.f; },
          [&](int k, int n) { return n0 + n < N ? dh[(size_t)k * N + n0 + n] : 0.f; }, As, Bs);
      own_load(acc, n0);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int s = ty + 16 * x, n = n0 + tx + 16 * y;
          if (s < ni && n < N) {
            const float bv = Bg[(size_t)(r0 + s) * N + n];
            rpart[x] += (double)(st[x][y] * bv);
            a.pb[(rowbase + r0 + s) * N + n] = acc[x][y] + st[x][y];
          }
        }
    }
    row_reduce(rpart, rterm);
  }

  // ---- dC_t (this head's), t in tile i: pairs with s in tiles j <= i --------
  __syncthreads();
  for (int e = tid; e < TR * N; e += BT) acc_s[e] = 0.f;
  double rpart[4] = {0.0, 0.0, 0.0, 0.0};     // row sums of P, rows ty + 16 x
  for (int j = 0; j <= i; ++j) {
    load_cum_j(j);
    const int s0 = j * TR, nj = min(TR, Q - s0);
    float eg[4][4];
    pair_tile(eg, r0, ni, cum_i, s0, nj, cum_j);
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) rpart[x] += (double)pt[(ty + 16 * x) * BP + tx + 16 * y];
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) pt[(ty + 16 * x) * BP + tx + 16 * y] = eg[x][y];
    __syncthreads();
    for (int n0 = 0; n0 < N; n0 += TR) {
      float acc[4][4];
      own_load(acc, n0);
      tile_fma<true, false>(
          acc, nj, [&](int t, int s) { return pt[t * BP + s]; },
          [&](int s, int n) { return n0 + n < N ? Bg[(size_t)(s0 + s) * N + n0 + n] : 0.f; }, As,
          Bs);
      own_store(acc, n0);
    }
  }
  row_reduce(rpart, rowp);
  {
    double ipart[4] = {0.0, 0.0, 0.0, 0.0};
    for (int n0 = 0; n0 < N; n0 += TR) {
      float it[4][4], acc[4][4];
      zero(it);
      tile_fma<true, false>(
          it, hd, [&](int t, int k) { return t < ni ? yg[(size_t)(r0 + t) * hd + k] * win[t] : 0.f; },
          [&](int k, int n) { return n0 + n < N ? h0[(size_t)k * N + n0 + n] : 0.f; }, As, Bs);
      own_load(acc, n0);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int t = ty + 16 * x, n = n0 + tx + 16 * y;
          if (t < ni && n < N) {
            const float cv = Cg[(size_t)(r0 + t) * N + n];
            ipart[x] += (double)(it[x][y] * cv);
            a.pc[(rowbase + r0 + t) * N + n] = acc[x][y] + it[x][y];
          }
        }
    }
    row_reduce(ipart, inter);
  }

  if (tid < ni) {
    a.d1[rowbase + r0 + tid] = rowp[tid] - colp[tid] + inter[tid];
    a.rs[rowbase + r0 + tid] = rterm[tid];
  }
  // the carried state's exp(cum_Q) <dh_end, h0>, by the chunk's last tile
  if (i == T - 1) {
    double s = 0.0;
    for (size_t e = tid; e < hdn; e += BT) s += (double)dh[e] * (double)h0[e];
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int k = 0; k < BT; ++k) t += red[k];
      a.kc[(size_t)bh * nc + c] = t * (double)__expf((float)cq);
    }
  }
}

// 6. dB, dC = the heads' partials summed in order; one thread an entry of
// (B, S, N)
__global__ void __launch_bounds__(BT) bwd_head_sum(const float* __restrict__ pb,
                                                   const float* __restrict__ pc, float* dB,
                                                   float* dC, int nh, long long SN,
                                                   long long total) {
  const long long e = (long long)blockIdx.x * BT + threadIdx.x;
  if (e >= total) return;
  const long long b = e / SN, r = e % SN;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < nh; ++h) {
    const size_t o = (size_t)(b * nh + h) * SN + r;
    sb += pb[o];
    sc += pc[o];
  }
  dB[e] = sb;
  dC[e] = sc;
}

// 7. dg_u = sum_{t >= u} d1_t + sum_{s < u} R_s + kc, per (batch, head,
// chunk), in double; d1 (scratch) takes the reverse sums in place
__global__ void __launch_bounds__(BT) bwd_dg(double* d1, const double* __restrict__ rs,
                                             const double* __restrict__ kc, float* dg,
                                             long long rows, int Q) {
  const long long u = (long long)blockIdx.x * BT + threadIdx.x;
  if (u >= rows) return;
  double* dp = d1 + u * Q;
  const double* rp = rs + u * Q;
  float* gp = dg + u * Q;
  double tail = 0.0;
  for (int t = Q - 1; t >= 0; --t) {
    tail += dp[t];
    dp[t] = tail;
  }
  double head = 0.0;
  const double k = kc[u];
  for (int t = 0; t < Q; ++t) {
    gp[t] = (float)(dp[t] + head + k);
    head += rp[t];
  }
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

struct Workspace {
  size_t cum, cb, H, DH, pb, pc, d1, rs, kc, bytes;
};

Workspace workspace(int B, int nh, int S, int hd, int N, int Q) {
  const size_t nc = S / Q, rows = (size_t)B * nh * S;
  Workspace w;
  size_t off = 0;
  w.cum = off;
  off = align256(off + rows * sizeof(double));
  w.cb = off;
  off = align256(off + (size_t)B * nc * Q * Q * sizeof(float));
  w.H = off;
  off = align256(off + (size_t)B * nh * (nc + 1) * hd * N * sizeof(float));
  w.DH = off;
  off = align256(off + (size_t)B * nh * nc * hd * N * sizeof(float));
  w.pb = off;
  off = align256(off + rows * N * sizeof(float));
  w.pc = off;
  off = align256(off + rows * N * sizeof(float));
  w.d1 = off;
  off = align256(off + rows * sizeof(double));
  w.rs = off;
  off = align256(off + rows * sizeof(double));
  w.kc = off;
  off = align256(off + (size_t)B * nh * nc * sizeof(double));
  w.bytes = off;
  return w;
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer ssd_scan_bwd_launch needs (0 for a shape it
// refuses).
long long ssd_scan_bwd_workspace(int B, int nh, int S, int hd, int N, int Q) {
  if (B < 1 || nh < 1 || S < 1 || hd < 1 || N < 1 || N > NMAX || Q < 1 || S % Q != 0) return 0;
  return (long long)workspace(B, nh, S, hd, N, Q).bytes;
}

// All pointers f32 on the device but `ws` (ssd_scan_bwd_workspace bytes,
// 256-byte aligned); dh may be null (a zero cotangent of the final state).
// Launches the seven passes on `stream`; returns cudaErrorInvalidValue for
// a shape it does not take, else the first launch error (0 = launched).
int ssd_scan_bwd_launch(const void* xdt, const void* g, const void* Bm, const void* Cm,
                        const void* dy, const void* dh, void* dxdt, void* dg, void* dBm,
                        void* dCm, void* ws, int B, int nh, int S, int hd, int N, int Q,
                        void* stream) {
  if (B < 1 || nh < 1 || S < 1 || hd < 1 || N < 1 || N > NMAX || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const long long T_ = (Q + TR - 1) / TR, chunks_ = (long long)B * nh * (S / Q);
  if (chunks_ * T_ > 0x7fffffffLL || (long long)B * (S / Q) * T_ * T_ > 0x7fffffffLL ||
      (long long)B * S * N > 0x7fffffffLL * BT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = workspace(B, nh, S, hd, N, Q);
  char* base = static_cast<char*>(ws);
  double* cum = reinterpret_cast<double*>(base + w.cum);
  float* cb = reinterpret_cast<float*>(base + w.cb);
  float* H = reinterpret_cast<float*>(base + w.H);
  float* DH = reinterpret_cast<float*>(base + w.DH);
  float* pb = reinterpret_cast<float*>(base + w.pb);
  float* pc = reinterpret_cast<float*>(base + w.pc);
  double* d1 = reinterpret_cast<double*>(base + w.d1);
  double* rs = reinterpret_cast<double*>(base + w.rs);
  double* kc = reinterpret_cast<double*>(base + w.kc);
  const float* x = static_cast<const float*>(xdt);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float* yp = static_cast<const float*>(dy);
  const float* hp = static_cast<const float*>(dh);
  const int nc = S / Q, T = (Q + TR - 1) / TR;
  const long long chunks = (long long)B * nh * nc;
  cudaError_t e;

  bwd_cum<<<(unsigned)((chunks + BT - 1) / BT), BT, 0, st>>>(gp, cum, chunks, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_cb<<<(unsigned)((long long)B * nc * T * T), BT, 0, st>>>(bp, cp, cb, nc, Q, N, T);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int dtiles = (hd + SD - 1) / SD, ntiles = (N + SD - 1) / SD;
  const unsigned sgrid = (unsigned)((long long)B * nh * dtiles * ntiles);
  bwd_states<false><<<sgrid, BT, 0, st>>>(x, bp, cum, nullptr, H, nh, S, hd, N, Q, dtiles,
                                          ntiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_states<true><<<sgrid, BT, 0, st>>>(yp, cp, cum, hp, DH, nh, S, hd, N, Q, dtiles, ntiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t dyn = (size_t)TR * N * sizeof(float);
  static size_t opted = 0;
  if (dyn > opted) {
    if ((e = cudaFuncSetAttribute(bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dyn)) != cudaSuccess)
      return (int)e;
    opted = dyn;
  }
  ChunkArgs ca{x,  yp, bp, cp, cb, H,  DH, cum, static_cast<float*>(dxdt), pb, pc,
               d1, rs, kc, nh, S,  hd, N,  Q,   T};
  bwd_chunk<<<(unsigned)(chunks * T), BT, dyn, st>>>(ca);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long SN = (long long)S * N, total = (long long)B * SN;
  bwd_head_sum<<<(unsigned)((total + BT - 1) / BT), BT, 0, st>>>(
      pb, pc, static_cast<float*>(dBm), static_cast<float*>(dCm), nh, SN, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_dg<<<(unsigned)((chunks + BT - 1) / BT), BT, 0, st>>>(d1, rs, kc, static_cast<float*>(dg),
                                                          chunks, Q);
  return (int)cudaGetLastError();
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
