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
// (kernels/ssd_scan/ref.py::ssd_scan_bwd_ref is the plain version).  The
// gradient does not depend on where the chunks end, so a chunk longer than
// SEG = 256 rows is taken as segments of at most 256 (as the forward takes
// sub-chunks); below, "segment" is the chunk or such a piece of it.
//
// Replaces no Pallas kernel: src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_kernel is forward only, and repro trains Mamba2 by jax.grad
// through its jnp src/repro/models/ssm.py::ssd_chunked.  The port's
// forward on the card is csrc/ssd_scan.cu, so its gradient is a kernel too.
//
// What bounds it on the H100: per (batch, head, chunk) the causal halves of
// four Q x Q products, dy xdt^T (K = hd), (C B^T o E)^T dy (hd), (E o G)^T C
// and (E o G) B (N), 2 (Q (Q + 1) / 2) (2 hd + 2 N) flops, and the Q x hd
// x N products, 2 Q hd N each: the state terms of dxdt and dB in every
// chunk, dC's inter-chunk term and dh's recurrence in all but the first,
// the state recurrence in all but the last; per (batch, chunk) C B^T, Q (Q
// + 1) N.  At Mamba2-2.7B's training shape (B 2, S 512, 80 heads of 64, N
// 128, Q 256) that is 12.8 GFLOP against 71 MB: bound by its operations,
// 0.19 ms in f32 FFMA at 67 TFLOP/s, 0.078 ms on the tensor cores in
// 3xTF32 (three TF32 products per f32 product at 495 TFLOP/s).
//
// Design: four launches on the caller's stream, the plan from
// kernels/ssd_scan/plan.py::ssd_bwd_plan as ints (`heads`, `dtiles`).
// Every product runs on mma.sync.m16n8k8 TF32 in 3xTF32 (an f32 operand v
// split into big = rna(v) and small = rna(v - big); small*big + big*small +
// big*big), each 32-deep K-chunk's three passes into a zeroed fragment that
// is then added to the accumulator in f32 (the tensor core truncates what
// it adds), as in csrc/ssd_scan.cu and csrc/lora_mma.cuh; one TF32 pass
// misses the checks (tests/test_torch_ssd_bwd_mma.py).  Blocks of 8 warps;
// a warp owns a 16 x 32 piece of each 64 x 64 output tile (rows 16 (w % 4),
// columns 32 (w / 4)).  No atomics, every sum in a fixed order: two runs
// give equal bits.
//  1. prep: one block per causal 64 x 64 tile of C B^T of a (batch,
//     segment), shared by every head; and one per (batch, head, direction,
//     64 x 64 state tile) that runs the state recurrence over the segments
//     (the state entering each) or dh's reverse one (dh at each one's end),
//     the state in registers, its products over 32-row slices of the
//     segment through a cp.async ring.  The segment's prefix sums of g are
//     taken in double by the block (warp shuffles), here and in every pass
//     that needs them: no pass runs one thread per chunk;
//  2. pairs: one block per (batch, segment, head group, 64-row key tile r).
//     For each head of the group it forms the pair tiles (i, r), i >= r,
//     ONCE: G = dy_i xdt_r^T on the tensor cores, E from the forward's
//     anchored mask (exp(cum_t - cum_a) exp(cum_a - cum_s) at the query
//     tile's first row a left of the diagonal, the warp's first row on it,
//     exp(cum_t - cum_s) itself for a warp's own 16 keys: one exponential
//     per row and per key, every factor <= 1, each difference of the double
//     prefix sums rounded once), then from the same registers E o G (to the
//     workspace), P = C B^T o E o G (over the staged C B^T tile, whose row
//     sums and column sums both read it: dg is their difference, so both
//     must see the same P) and M = C B^T o E; dxdt_r = sum_i M^T dy_i + the
//     state term in registers;
//  3. rows: one block per (batch, segment, head group, 64-row tile r), for
//     64 columns of N at a time: dB_r = sum_{i >= r} (E o G)(i, r)^T C_i +
//     the state term, then dC_r = sum_{j <= r} (E o G)(r, j) B_j + the
//     inter-chunk term, E o G read back from the workspace; R and I (the
//     state terms' products with B_r and C_r) and dg's per-row terms, the
//     row sums of P gathered from the pairs pass in order;
//  4. finish: dB and dC summed over the head groups in order (a group's
//     heads were added up in place by its rows block, so this reads nh /
//     heads partials, not nh), and dg's reverse and forward scans per
//     (batch, head, segment) in double by one block.
// The pairs and rows blocks hold at most 128 registers and ~80 KB of
// shared memory at hd 64, so that two share an SM: at one block an SM the
// barriers between a pair's phases left the tensor cores idle.  The
// operands stream through cp.async rings (16-byte copies where every pitch
// is a multiple of 4 floats and every pointer 16-byte aligned), the pitches
// chosen so that the dominant use's fragment reads are free of bank
// conflicts (4 or 8 mod 32).  Workspace: ssd_scan_bwd_workspace.
// Not yet: wgmma / TMA; E o G shared over a cluster instead of the
// workspace; each operand split once per block instead of once per warp
// that reads it.

#include "mma_ptx.cuh"

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BT = 256;          // threads of every block: 8 warps
constexpr int NW = BT / 32;
constexpr int TR = 64;           // rows of a row tile; side of a pair tile
constexpr int SEG = 256;         // rows of the longest segment
constexpr int NMAX = 256;        // largest state size taken
constexpr int HDMAX = 128;       // largest head dim taken
constexpr int KC = 32;           // depth of a zeroed K-chunk
constexpr int SP = KC + 4;       // pitch of a 32-column slice
constexpr int P8 = TR + 8;       // pitch of 64-column tiles (B or transposed reads: row tig)
constexpr size_t SMEM_MAX = 232448;

__host__ __device__ inline int pair_index(int i, int j) { return i * (i + 1) / 2 + j; }

struct Seg {
  int start, len, tiles;
};

// segment k of a batch row: chunk k / spc, piece k % spc of at most SEG rows
__host__ __device__ inline Seg segment(int k, int Q, int spc) {
  const int c = k / spc, m = k % spc;
  Seg s;
  s.start = c * Q + m * SEG;
  s.len = min(SEG, Q - m * SEG);
  s.tiles = (s.len + TR - 1) / TR;
  return s;
}

struct Lane {
  int lane, gid, tig, rb, ch;
  __device__ Lane() {
    const int tid = threadIdx.x, w = tid >> 5;
    lane = tid & 31;
    gid = lane >> 2;
    tig = lane & 3;
    rb = w & 3;
    ch = w >> 2;
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// acc (the warp's NT m16n8 tiles) += A (16 x KC) B (KC x 8 NT) in 3xTF32,
// the K-chunk's three passes into a zeroed fragment first.  fa(r, k): A at
// the warp's row r < 16 and depth k < KC; fb(k, j): B at depth k and the
// warp's column j = 8 nt + gid.
template <int NT, class FA, class FB>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4], const FA& fa, const FB& fb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float tmp[NT][4];
  zero(tmp);
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    const float av[4] = {fa(gid, kk + tig), fa(gid + 8, kk + tig), fa(gid, kk + tig + 4),
                         fa(gid + 8, kk + tig + 4)};
    uint32_t ab[4], as[4];
    split4(av, ab, as);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma3(tmp[nt], ab, as, fb(kk + tig, nt * 8 + gid), fb(kk + tig + 4, nt * 8 + gid));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
}

// rows [0, R) x columns [0, W) (W a multiple of 4) of src (row pitch ld)
// into dst (pitch dp), zero where row >= rows or column >= cols; one
// cp.async per 16 bytes when `vec`, else per element
__device__ __forceinline__ void stage(float* dst, int dp, const float* __restrict__ src,
                                      size_t ld, int R, int W, int rows, int cols, bool vec) {
  if (vec) {
    const int w4 = W / 4;
    for (int e = threadIdx.x; e < R * w4; e += BT) {
      const int r = e / w4, c = (e % w4) * 4;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * dp + c, src + (ok ? r * ld + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += BT) {
      const int r = e / W, c = e % W;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * dp + c, src + (ok ? r * ld + c : 0), ok);
    }
  }
}

// A two-stage cp.async ring over items 0 .. n - 1: issue(q, slot) stages
// item q, use(q, slot) consumes it while item q + 1 is in flight
template <class IS, class US>
__device__ __forceinline__ void ring(int n, const IS& issue, const US& use) {
  if (n > 0) issue(0, 0);
  cp_async_commit();
  for (int q = 0; q < n; ++q) {
    if (q + 1 < n) issue(q + 1, (q + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    use(q, q & 1);
    __syncthreads();
  }
}

// the inclusive prefix sum of the block's values (one a thread, in thread
// order) in double: warp shuffles, then the warps' totals in order; ends in
// a barrier, so wtot may be reused at once
__device__ double block_scan(double v, double* wtot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wtot[w] = v;
  __syncthreads();
  double off = 0.0;
  for (int k = 0; k < w; ++k) off += wtot[k];
  __syncthreads();
  return v + off;
}

// cum[0..L) = inclusive prefix sum of g[0..L) in double, L <= BT; ends in
// a barrier
__device__ void block_cumsum(const float* __restrict__ g, double* cum, int L, double* wtot) {
  const double v = block_scan(threadIdx.x < L ? (double)g[threadIdx.x] : 0.0, wtot);
  if ((int)threadIdx.x < L) cum[threadIdx.x] = v;
  __syncthreads();
}

// the row sums of a warp's 16 x 32 piece, per row (gid, gid + 8), over the
// quad (tig), in double: every lane ends with its rows' sums
__device__ __forceinline__ void quad_sum(double (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
  }
}

// per-row partials of the two column halves (rowpw[ch][t]) into dst[t],
// half 0 first; a barrier before and after
__device__ __forceinline__ void half_sum(const double (&v)[2], double* rowpw, double* dst,
                                         int rows) {
  const Lane L;
  __syncthreads();
  if (L.tig == 0) {
    rowpw[L.ch * TR + 16 * L.rb + L.gid] = v[0];
    rowpw[L.ch * TR + 16 * L.rb + L.gid + 8] = v[1];
  }
  __syncthreads();
  if (threadIdx.x < rows) dst[threadIdx.x] = rowpw[threadIdx.x] + rowpw[TR + threadIdx.x];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. prep
// ---------------------------------------------------------------------------

struct PrepArgs {
  const float *xdt, *g, *Bm, *Cm, *dy, *dh;
  float *cb, *H, *DH;
  int nh, S, hd, N, Q, spc, nseg, T, npairs, cb_blocks, dtl, ntl, vec;
};

__global__ void __launch_bounds__(BT, 2) bwd_prep(PrepArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ double cum[SEG];
  __shared__ double wtot[NW];
  __shared__ float wv[SEG];
  const Lane L;
  const int N = a.N, hd = a.hd, S = a.S;
  const bool vec = a.vec != 0;
  float acc[4][4];
  zero(acc);

  if ((int)blockIdx.x < a.cb_blocks) {
    // C B^T tile (i, j) of segment k: rows t of C_i, columns s of B_j, K = N
    int u = blockIdx.x;
    const int p = u % a.npairs;
    u /= a.npairs;
    const int k = u % a.nseg, b = u / a.nseg;
    int i = 0;
    while (pair_index(i + 1, 0) <= p) ++i;
    const int j = p - pair_index(i, 0);
    const Seg sg = segment(k, a.Q, a.spc);
    if (i >= sg.tiles) return;
    const float* Ci = a.Cm + ((size_t)b * S + sg.start + i * TR) * N;
    const float* Bj = a.Bm + ((size_t)b * S + sg.start + j * TR) * N;
    const int ri = min(TR, sg.len - i * TR), rj = min(TR, sg.len - j * TR);
    const int stg = 2 * TR * SP;
    ring((N + KC - 1) / KC,
         [&](int q, int slot) {
           stage(sm + slot * stg, SP, Ci + q * KC, N, TR, KC, ri, N - q * KC, vec);
           stage(sm + slot * stg + TR * SP, SP, Bj + q * KC, N, TR, KC, rj, N - q * KC, vec);
         },
         [&](int, int slot) {
           const float* cs = sm + slot * stg;
           const float* bs = cs + TR * SP;
           mma_chunk(acc, [&](int r, int kk) { return cs[(16 * L.rb + r) * SP + kk]; },
                     [&](int kk, int c) { return bs[(32 * L.ch + c) * SP + kk]; });
         });
    const int pitch = TR * a.T;
    float* out = a.cb + ((size_t)b * a.nseg + k) * pitch * pitch + (size_t)i * TR * pitch + j * TR;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * L.rb + L.gid + 8 * h, s = 32 * L.ch + 8 * nt + 2 * L.tig;
        *reinterpret_cast<float2*>(out + (size_t)t * pitch + s) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    return;
  }

  // a 64 x 64 tile (rows d0.., columns n0..) of the state (dir 0) or of dh
  // (dir 1) of one (batch, head), over the segments
  int u = blockIdx.x - a.cb_blocks;
  const int ntile = u % a.ntl;
  u /= a.ntl;
  const int dtile = u % a.dtl;
  u /= a.dtl;
  const int dir = u % 2, bh = u / 2, b = bh / a.nh;
  const int d0 = dtile * TR, n0 = ntile * TR;
  const size_t hdn = (size_t)hd * N;
  auto at = [&](int nt, int e, int& d, int& n) {
    d = d0 + 16 * L.rb + L.gid + 8 * (e >> 1);
    n = n0 + 32 * L.ch + 8 * nt + 2 * L.tig + (e & 1);
  };
  auto put = [&](float* o) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int d, n;
        at(nt, e, d, n);
        if (d < hd && n < N) o[(size_t)d * N + n] = acc[nt][e];
      }
  };
  if (dir == 1 && a.dh != nullptr) {
    const float* dh = a.dh + (size_t)bh * hdn;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int d, n;
        at(nt, e, d, n);
        acc[nt][e] = d < hd && n < N ? dh[(size_t)d * N + n] : 0.f;
      }
  }
  // the state entering segment k + 1 from the one entering k (dir 0);
  // dh at the end of segment k - 1 from dh at the end of k (dir 1):
  //   h  <- exp(cum_L) h  + sum_s exp(cum_L - cum_s) xdt_s^T B_s
  //   dh <- exp(cum_L) dh + sum_t exp(cum_t) dy_t^T C_t
  const float* src = (dir == 0 ? a.xdt : a.dy) + (size_t)bh * S * hd;
  const float* prj = (dir == 0 ? a.Bm : a.Cm) + (size_t)b * S * N;
  for (int step = 0; step < a.nseg; ++step) {
    const int k = dir == 0 ? step : a.nseg - 1 - step;
    if (dir == 1) put(a.DH + ((size_t)bh * a.nseg + k) * hdn);
    if (dir == 0 ? k == a.nseg - 1 : k == 0) break;
    const Seg sg = segment(k, a.Q, a.spc);
    __syncthreads();                    // the previous segment's cum and wv are read
    block_cumsum(a.g + (size_t)bh * S + sg.start, cum, sg.len, wtot);
    const double cl = cum[sg.len - 1];
    // the rows' weights, zero past the segment (its last slice may be ragged)
    for (int s = threadIdx.x; s < SEG; s += BT)
      wv[s] = s < sg.len ? __expf((float)(dir == 0 ? cl - cum[s] : cum[s])) : 0.f;
    const float decay = __expf((float)cl);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= decay;
    const int stg = 2 * KC * P8;
    ring((sg.len + KC - 1) / KC,
         [&](int q, int slot) {
           const int r0 = sg.start + q * KC, rows = sg.len - q * KC;
           stage(sm + slot * stg, P8, src + (size_t)r0 * hd + d0, hd, KC, TR, rows, hd - d0, vec);
           stage(sm + slot * stg + KC * P8, P8, prj + (size_t)r0 * N + n0, N, KC, TR, rows,
                 N - n0, vec);
         },
         [&](int q, int slot) {
           const float* xs = sm + slot * stg;
           const float* ps = xs + KC * P8;
           const float* w = wv + q * KC;
           mma_chunk(acc, [&](int r, int kk) { return xs[kk * P8 + 16 * L.rb + r] * w[kk]; },
                     [&](int kk, int c) { return ps[kk * P8 + 32 * L.ch + c]; });
         });
    if (dir == 0) put(a.H + ((size_t)bh * a.nseg + k + 1) * hdn);
  }
}

// ---------------------------------------------------------------------------
// 2. pairs and 3. rows
// ---------------------------------------------------------------------------

struct ChunkArgs {
  const float *xdt, *g, *Bm, *Cm, *dy, *cb, *H, *DH;
  float *eg, *dx, *pb, *pc;
  double *rowp, *cs, *rs, *d1, *kc;
  int nh, S, hd, N, Q, spc, nseg, T, npairs, heads, groups, hdp, vec;
};

// byte offsets of the pairs block's dynamic shared memory: xdt_r, the ring
// (dy_i; or 32 columns of B_r and of dh_end), the pair's C B^T tile (then
// P, in place) and M
struct PairsSmem {
  size_t ring, pm, mt, bytes;
  int px, py, stage;
};

__host__ __device__ inline PairsSmem pairs_smem(int hdp) {
  PairsSmem L;
  L.px = hdp + 4;
  L.py = hdp + 8;
  L.stage = max(TR * L.py, (TR + hdp) * SP);
  L.ring = (size_t)TR * L.px * sizeof(float);
  L.pm = L.ring + (size_t)2 * L.stage * sizeof(float);
  L.mt = L.pm + (size_t)TR * P8 * sizeof(float);
  L.bytes = L.mt + (size_t)TR * P8 * sizeof(float);
  return L;
}

// the rows block's dynamic shared memory is its two-stage ring: a stage
// holds a tile of E o G and 64 columns of C or B, or 32 columns of xdt_r
// (dy_r) and 32 rows of dh_end (h0)
constexpr int ROWS_STAGE = 2 * TR * P8;
static_assert(TR * SP + KC * P8 <= ROWS_STAGE, "a rows slice item fits a stage");

// the group's partial of dB or dC rows: the first head stores, the others
// add in order (each entry read and written by one thread)
__device__ __forceinline__ void accumulate(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// 2. one block per (batch, segment, head group, key tile r)
template <int DTW>
__global__ void __launch_bounds__(BT, 2) bwd_pairs(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double cum[SEG];
  __shared__ double wtot[NW];
  __shared__ double colsum[TR];
  __shared__ float wend[TR], cf[TR], cfw[4 * TR];
  const Lane L;
  const int N = a.N, hd = a.hd, S = a.S, T = a.T, hdp = a.hdp;
  const bool vec = a.vec != 0;
  int u = blockIdx.x;
  const int r = u % T;
  u /= T;
  const int grp = u % a.groups;
  u /= a.groups;
  const int k = u % a.nseg, b = u / a.nseg;
  const Seg sg = segment(k, a.Q, a.spc);
  if (r >= sg.tiles) return;
  const PairsSmem M = pairs_smem(hdp);
  float* xs = reinterpret_cast<float*>(smem);
  float* rg = reinterpret_cast<float*>(smem + M.ring);
  float* pm = reinterpret_cast<float*>(smem + M.pm);
  float* mt = reinterpret_cast<float*>(smem + M.mt);
  const int PX = M.px, PY = M.py, ST = M.stage;
  const int rr = min(TR, sg.len - r * TR);                  // rows of tile r
  const size_t brow = (size_t)b * S + sg.start;              // the segment's first row in (B, S)
  const int pitch = TR * T;
  const float* cbk = a.cb + ((size_t)b * a.nseg + k) * pitch * pitch;
  const size_t hdn = (size_t)hd * N;
  // dxdt's column of the warp's j-th column: its n tiles interleave by half
  auto dcol = [&](int j) { return 8 * (2 * (j >> 3) + L.ch) + (j & 7); };

  for (int hh = 0; hh < a.heads; ++hh) {
    const int head = grp * a.heads + hh;
    if (head >= a.nh) break;
    const size_t bh = (size_t)b * a.nh + head;
    const size_t rowbase = bh * S + sg.start;                // (B, nh, S)
    const float* xg = a.xdt + rowbase * hd;
    const float* yg = a.dy + rowbase * hd;
    const float* dh = a.DH + (bh * a.nseg + k) * hdn;
    float* egk = a.eg + (bh * a.nseg + k) * a.npairs * (TR * TR);
    const int npair = sg.tiles - r;
    // the pair tiles (i, r), i = r + q: dy_i through the ring, C B^T (i, r)
    // into pm (single: it is issued once the previous pair is done with pm)
    auto issue_dy = [&](int q) {
      const int i = r + q;
      stage(rg + (q & 1) * ST, PY, yg + (size_t)i * TR * hd, hd, TR, hdp,
            min(TR, sg.len - i * TR), hd, vec);
    };
    auto issue_cb = [&](int q) {
      stage(pm, P8, cbk + (size_t)(r + q) * TR * pitch + r * TR, pitch, TR, TR, TR, TR, true);
    };

    __syncthreads();                    // the previous head is done with every buffer
    // xdt rows of tile r, dy_r and C B^T (r, r), in flight while cum is formed
    stage(xs, PX, xg + (size_t)r * TR * hd, hd, TR, hdp, rr, hd, vec);
    issue_dy(0);
    issue_cb(0);
    cp_async_commit();
    block_cumsum(a.g + rowbase, cum, sg.len, wtot);
    const double cl = cum[sg.len - 1];
    if (threadIdx.x < TR) {
      const int s = threadIdx.x;
      wend[s] = s < rr ? __expf((float)(cl - cum[r * TR + s])) : 0.f;
      colsum[s] = 0.0;
    }
    // the diagonal tile's key factors at each warp row block's first row
    {
      const int q = threadIdx.x >> 6, s = threadIdx.x & 63;
      if (s < 16 * q && r * TR + 16 * q < sg.len)
        cfw[q * TR + s] = __expf((float)(cum[r * TR + 16 * q] - cum[r * TR + s]));
    }

    float dx[DTW][4];
    zero(dx);
    for (int q = 0; q < npair; ++q) {
      const int i = r + q, ri = min(TR, sg.len - i * TR);
      if (q + 1 < npair) issue_dy(q + 1);
      cp_async_commit();
      cp_async_wait<1>();               // dy_i and C B^T (i, r) have landed
      __syncthreads();
      const float* ys = rg + (q & 1) * ST;
      // G = dy_i xdt_r^T, the warp's 16 x 32 piece
      float gacc[4][4];
      zero(gacc);
      for (int k0 = 0; k0 < hdp; k0 += KC)
        mma_chunk(gacc, [&](int rw, int kk) { return ys[(16 * L.rb + rw) * PY + k0 + kk]; },
                  [&](int kk, int c) { return xs[(32 * L.ch + c) * PX + k0 + kk]; });
      // E: left of the diagonal exp(cum_t - cum_a) cf_s, a = 64 i (cf holds
      // exp(cum_a - cum_s)); on it at the warp's first row aw (cfw), its own
      // 16 keys exp(cum_t - cum_s) itself
      const int a0 = i * TR, aw = a0 + 16 * L.rb;
      float rf[2], rfw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * L.rb + L.gid + 8 * h;
        const bool ok = t < ri;
        const double ct = ok ? cum[a0 + t] : 0.0;
        rf[h] = ok ? __expf((float)(ct - cum[a0])) : 0.f;
        rfw[h] = ok && aw < sg.len ? __expf((float)(ct - cum[aw])) : 0.f;
      }
      // E o G to the workspace, P over C B^T in pm (each thread its own
      // entries), M to mt
      float* egt = egk + (size_t)pair_index(i, r) * (TR * TR);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = 16 * L.rb + L.gid + 8 * h, s0 = 32 * L.ch + 8 * nt + 2 * L.tig;
          float2* cp = reinterpret_cast<float2*>(pm + t * P8 + s0);
          const float2 cbv = *cp;
          float egv[2], pv[2], mv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int s = s0 + c;
            float e = 0.f;
            if (t < ri && s < rr) {
              if (i > r) {
                e = rf[h] * cf[s];
              } else if (s < 16 * L.rb) {
                e = rfw[h] * cfw[L.rb * TR + s];
              } else if (s <= t) {
                e = __expf((float)(cum[a0 + t] - cum[a0 + s]));
              }
            }
            const float cbe = c == 0 ? cbv.x : cbv.y;
            egv[c] = e * gacc[nt][2 * h + c];
            mv[c] = cbe * e;
            pv[c] = cbe * egv[c];
          }
          *reinterpret_cast<float2*>(egt + t * TR + s0) = make_float2(egv[0], egv[1]);
          *cp = make_float2(pv[0], pv[1]);
          *reinterpret_cast<float2*>(mt + t * P8 + s0) = make_float2(mv[0], mv[1]);
        }
      __syncthreads();
      // P's row sums (this key tile's share, to the workspace) and column
      // sums, both from the one tile, in double: two threads a row (warps
      // 0-3) or a column (warps 4-7), 32 entries each in a fixed rotated
      // order (free of bank conflicts), then the two halves
      {
        const int x = threadIdx.x & 127, line = x >> 1, half = x & 1;
        const bool col = threadIdx.x >= 128;
        const int rot = line + (col ? 2 : 16) * half;
        double v = 0.0;
        for (int j = 0; j < 32; ++j) {
          const int m = 32 * half + ((j + rot) & 31);
          v += (double)(col ? pm[m * P8 + line] : pm[line * P8 + m]);
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (half == 0) {
          if (col)
            colsum[line] += v;
          else
            a.rowp[((bh * a.nseg + k) * T * T + i * T + r) * TR + line] = v;
        }
      }
      // the next tile's key factors exp(cum_a - cum_s), a its first row
      if (q + 1 < npair && threadIdx.x < TR) {
        const int s = threadIdx.x;
        cf[s] = s < rr ? __expf((float)(cum[(i + 1) * TR] - cum[r * TR + s])) : 0.f;
      }
      // dxdt_r += M^T dy_i (K = the 64 rows of tile i)
      for (int k0 = 0; k0 < TR; k0 += KC)
        mma_chunk(dx, [&](int rw, int kk) { return mt[(k0 + kk) * P8 + 16 * L.rb + rw]; },
                  [&](int kk, int c) { return ys[(k0 + kk) * PY + dcol(c)]; });
      __syncthreads();                  // pm, mt and the ring slot are free
      if (q + 1 < npair) issue_cb(q + 1);
      cp_async_commit();
    }

    // dxdt's state term: diag(wend) B_r dh_end^T, K = N in slices of 32
    const float* Br = a.Bm + (brow + r * TR) * N;
    ring(
        (N + KC - 1) / KC,
        [&](int q, int slot) {
          float* st = rg + slot * ST;
          stage(st, SP, Br + q * KC, N, TR, KC, rr, N - q * KC, vec);
          stage(st + TR * SP, SP, dh + q * KC, N, hdp, KC, hd, N - q * KC, vec);
        },
        [&](int, int slot) {
          const float* bs = rg + slot * ST;
          const float* ds = bs + TR * SP;
          mma_chunk(dx,
                    [&](int rw, int kk) {
                      return bs[(16 * L.rb + rw) * SP + kk] * wend[16 * L.rb + rw];
                    },
                    [&](int kk, int c) { return ds[dcol(c) * SP + kk]; });
        });
#pragma unroll
    for (int nt = 0; nt < DTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * L.rb + L.gid + 8 * (e >> 1), d = dcol(8 * nt + 2 * L.tig + (e & 1));
        if (s < rr && d < hd) a.dx[(rowbase + r * TR + s) * hd + d] = dx[nt][e];
      }
    if ((int)threadIdx.x < rr) a.cs[rowbase + r * TR + threadIdx.x] = colsum[threadIdx.x];
  }
}

// 3. one block per (batch, segment, head group, tile r): for 64 columns of
// N at a time, dB_r = sum_{i >= r} (E o G)(i, r)^T C_i + st (st = diag(wend)
// xdt_r dh_end, whose products with B_r are R), then dC_r = sum_{j <= r} (E
// o G)(r, j) B_j + it (it = diag(win) dy_r h0, whose products with C_r are
// I; none in the first segment); then dg's row terms
__global__ void __launch_bounds__(BT, 2) bwd_rows(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double cum[SEG];
  __shared__ double wtot[NW];
  __shared__ double rowpw[2 * TR], rsum[TR], isum[TR], red[BT];
  __shared__ float wend[TR], win[TR];
  const Lane L;
  const int N = a.N, hd = a.hd, S = a.S, T = a.T, hdp = a.hdp;
  const bool vec = a.vec != 0;
  int u = blockIdx.x;
  const int r = u % T;
  u /= T;
  const int grp = u % a.groups;
  u /= a.groups;
  const int k = u % a.nseg, b = u / a.nseg;
  const Seg sg = segment(k, a.Q, a.spc);
  if (r >= sg.tiles) return;
  float* rg = reinterpret_cast<float*>(smem);
  const int ST = ROWS_STAGE;
  const int rr = min(TR, sg.len - r * TR);
  const size_t brow = (size_t)b * S + sg.start;
  const size_t hdn = (size_t)hd * N;
  const bool inter = k > 0;             // h0 is exactly zero in the first segment
  const int ncol = sg.tiles - r, nrow = r + 1, nk = hdp / KC;
  // a 64-column chunk's items: part 0 (dB) its state slices, then its
  // pairs; part 1 (dC) its inter-chunk slices, then its pairs.  The slices
  // come first, so that the state term is complete (for R or I) before the
  // pairs are added to it in the same accumulator
  const int n0s = nk, n1s = inter ? nk : 0;
  const int last0 = n0s + ncol, per = last0 + n1s + nrow;
  const int nch = (N + TR - 1) / TR;
  const size_t gbase = ((size_t)b * a.groups + grp) * S + sg.start + r * TR;

  for (int hh = 0; hh < a.heads; ++hh) {
    const int head = grp * a.heads + hh;
    if (head >= a.nh) break;
    const size_t bh = (size_t)b * a.nh + head;
    const size_t rowbase = bh * S + sg.start;
    const float* xr = a.xdt + (rowbase + r * TR) * hd;
    const float* yr = a.dy + (rowbase + r * TR) * hd;
    const float* h0 = a.H + (bh * a.nseg + k) * hdn;
    const float* dh = a.DH + (bh * a.nseg + k) * hdn;
    const float* egk = a.eg + (bh * a.nseg + k) * a.npairs * (TR * TR);

    __syncthreads();
    block_cumsum(a.g + rowbase, cum, sg.len, wtot);
    if (threadIdx.x < TR) {
      const int t = threadIdx.x;
      const double cr = t < rr ? cum[r * TR + t] : 0.0;
      wend[t] = t < rr ? __expf((float)(cum[sg.len - 1] - cr)) : 0.f;
      win[t] = t < rr ? __expf((float)cr) : 0.f;
    }

    double rp[2] = {0.0, 0.0}, ip[2] = {0.0, 0.0};
    float acc[4][4];
    ring(
        nch * per,
        [&](int q, int slot) {
          const int n0 = (q / per) * TR, x = q % per;
          const bool p1 = x >= last0;
          const int y = p1 ? x - last0 : x, ns = p1 ? n1s : n0s;
          float* sb = rg + slot * ST;
          if (y < ns) {                   // 32 columns of xdt_r (dy_r), 32 rows of dh_end (h0)
            stage(sb, SP, (p1 ? yr : xr) + y * KC, hd, TR, KC, rr, hd - y * KC, vec);
            stage(sb + TR * SP, P8, (p1 ? h0 : dh) + (size_t)y * KC * N + n0, N, KC, TR,
                  hd - y * KC, N - n0, vec);
            return;
          }
          // (E o G)(i, r) and C_i for dB, (E o G)(r, j) and B_j for dC
          const int j = y - ns, i = p1 ? r : r + j, jj = p1 ? j : r, m = p1 ? j : i;
          stage(sb, P8, egk + (size_t)pair_index(i, jj) * (TR * TR), TR, TR, TR, TR, TR, true);
          stage(sb + TR * P8, P8, (p1 ? a.Bm : a.Cm) + (brow + m * TR) * N + n0, N, TR, TR,
                min(TR, sg.len - m * TR), N - n0, vec);
        },
        [&](int q, int slot) {
          const int n0 = (q / per) * TR, x = q % per;
          const bool p1 = x >= last0;
          const int y = p1 ? x - last0 : x, ns = p1 ? n1s : n0s;
          const int last = p1 ? per - last0 : last0;
          const float* sb = rg + slot * ST;
          if (y == 0) zero(acc);
          if (y < ns) {
            const float* ws = sb + TR * SP;
            const float* w = p1 ? win : wend;
            mma_chunk(acc,
                      [&](int rw, int kk) { return sb[(16 * L.rb + rw) * SP + kk] * w[16 * L.rb + rw]; },
                      [&](int kk, int c) { return ws[kk * P8 + 32 * L.ch + c]; });
            if (y + 1 == ns) {
              // the state term's products with B_r (R) or C_r (I)
              const float* prj = p1 ? a.Cm : a.Bm;
              double part[2] = {0.0, 0.0};
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int t = 16 * L.rb + L.gid + 8 * (e >> 1);
                  const int n = n0 + 32 * L.ch + 8 * nt + 2 * L.tig + (e & 1);
                  if (t < rr && n < N)
                    part[e >> 1] += (double)(acc[nt][e] * prj[(brow + r * TR + t) * N + n]);
                }
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (p1)
                  ip[h] += part[h];
                else
                  rp[h] += part[h];
              }
            }
          } else {
            // one path for every pair item, E o G read transposed for dB
            const float* os = sb + TR * P8;
            const int sr = p1 ? P8 : 1, sk = p1 ? 1 : P8;
            for (int k0 = 0; k0 < TR; k0 += KC)
              mma_chunk(acc,
                        [&](int rw, int kk) { return sb[(16 * L.rb + rw) * sr + (k0 + kk) * sk]; },
                        [&](int kk, int c) { return os[(k0 + kk) * P8 + 32 * L.ch + c]; });
          }
          if (y + 1 < last) return;
          float* dst = p1 ? a.pc : a.pb;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = 16 * L.rb + L.gid + 8 * (e >> 1);
              const int n = n0 + 32 * L.ch + 8 * nt + 2 * L.tig + (e & 1);
              if (t < rr && n < N) accumulate(dst + (gbase + t) * N + n, acc[nt][e], hh == 0);
            }
        });
    quad_sum(rp);
    half_sum(rp, rowpw, rsum, rr);
    quad_sum(ip);
    half_sum(ip, rowpw, isum, rr);
    // R_s, and d1_t = (row sums of P, the key tiles' shares in order) -
    // (column sums) + I_t
    if ((int)threadIdx.x < rr) {
      const int t = threadIdx.x;
      const double* rpw = a.rowp + (bh * a.nseg + k) * T * T * TR + (size_t)r * T * TR;
      double rs = 0.0;
      for (int j = 0; j <= r; ++j) rs += rpw[j * TR + t];
      a.d1[rowbase + r * TR + t] = rs - a.cs[rowbase + r * TR + t] + isum[t];
      a.rs[rowbase + r * TR + t] = rsum[t];
    }
    // the carried state's exp(cum_L) <dh_end, h0>, by tile 0's block
    if (r == 0 && inter) {
      double s = 0.0;
      for (size_t e = threadIdx.x; e < hdn; e += BT) s += (double)dh[e] * (double)h0[e];
      red[threadIdx.x] = s;
      __syncthreads();
      for (int w = BT / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
      }
      if (threadIdx.x == 0)
        a.kc[bh * a.nseg + k] = red[0] * (double)__expf((float)cum[sg.len - 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. finish
// ---------------------------------------------------------------------------

struct FinishArgs {
  const float *pb, *pc;
  const double *d1, *rs, *kc;
  float *dB, *dC, *dg;
  int B, nh, S, N, Q, spc, nseg, groups, sum_blocks;
};

__global__ void __launch_bounds__(BT) bwd_finish(FinishArgs a) {
  __shared__ double wtot[NW], suf[SEG], pre[SEG];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < a.sum_blocks) {
    // dB, dC = the groups' partials in order, one thread an entry of (B, S, N)
    const long long SN = (long long)a.S * a.N;
    const long long e = (long long)blockIdx.x * BT + tid;
    if (e >= a.B * SN) return;
    const long long b = e / SN, q = e % SN;
    float sb = 0.f, sc = 0.f;
    for (int gi = 0; gi < a.groups; ++gi) {
      const size_t o = (size_t)(b * a.groups + gi) * SN + q;
      sb += a.pb[o];
      sc += a.pc[o];
    }
    a.dB[e] = sb;
    a.dC[e] = sc;
    return;
  }
  // dg of one (batch, head, segment): dg_u = sum_{t >= u} d1_t + sum_{s < u}
  // R_s + the carried state's term (none in the first segment), in double
  const long long u = blockIdx.x - a.sum_blocks;
  const int k = (int)(u % a.nseg);
  const long long bh = u / a.nseg;
  const Seg sg = segment(k, a.Q, a.spc);
  const int L = sg.len;
  const size_t base = (size_t)bh * a.S + sg.start;
  const double sv = block_scan(tid < L ? a.d1[base + L - 1 - tid] : 0.0, wtot);
  const double pv = block_scan(tid < L ? a.rs[base + tid] : 0.0, wtot);
  if (tid < L) {
    suf[L - 1 - tid] = sv;
    pre[tid] = pv;
  }
  __syncthreads();
  const double kc = k > 0 ? a.kc[bh * a.nseg + k] : 0.0;
  if (tid < L) a.dg[base + tid] = (float)(suf[tid] + (tid > 0 ? pre[tid - 1] : 0.0) + kc);
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

struct Workspace {
  size_t cb, H, DH, eg, rowp, cs, rs, d1, kc, pb, pc, bytes;
};

Workspace workspace(int B, int nh, int S, int hd, int N, int Q, int heads) {
  const int spc = (Q + SEG - 1) / SEG, nseg = S / Q * spc;
  const int T = (min(Q, SEG) + TR - 1) / TR, npairs = T * (T + 1) / 2;
  const int groups = (nh + heads - 1) / heads;
  const size_t rows = (size_t)B * nh * S, hdn = (size_t)hd * N;
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t& at, size_t bytes) {
    at = off;
    off = align256(off + bytes);
  };
  take(w.cb, (size_t)B * nseg * (TR * T) * (TR * T) * sizeof(float));
  take(w.H, (size_t)B * nh * nseg * hdn * sizeof(float));
  take(w.DH, (size_t)B * nh * nseg * hdn * sizeof(float));
  take(w.eg, (size_t)B * nh * nseg * npairs * TR * TR * sizeof(float));
  take(w.rowp, (size_t)B * nh * nseg * T * T * TR * sizeof(double));
  take(w.cs, rows * sizeof(double));
  take(w.rs, rows * sizeof(double));
  take(w.d1, rows * sizeof(double));
  take(w.kc, (size_t)B * nh * nseg * sizeof(double));
  take(w.pb, (size_t)B * groups * S * N * sizeof(float));
  take(w.pc, (size_t)B * groups * S * N * sizeof(float));
  w.bytes = off;
  return w;
}

bool shape_ok(int B, int nh, int S, int hd, int N, int Q) {
  return B >= 1 && nh >= 1 && S >= 1 && hd >= 1 && hd <= HDMAX && N >= 1 && N <= NMAX &&
         Q >= 1 && S % Q == 0;
}

cudaError_t opt_in(const void* fn, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) opted = bytes;
  return e;
}

template <int DTW>
cudaError_t launch_pairs(unsigned grid, size_t bytes, cudaStream_t st, const ChunkArgs& ca) {
  static size_t opted = 0;
  const cudaError_t e = opt_in((const void*)bwd_pairs<DTW>, bytes, opted);
  if (e != cudaSuccess) return e;
  bwd_pairs<DTW><<<grid, BT, bytes, st>>>(ca);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer ssd_scan_bwd_launch needs at `heads` heads a
// block (0 for a shape it refuses).
long long ssd_scan_bwd_workspace(int B, int nh, int S, int hd, int N, int Q, int heads) {
  if (!shape_ok(B, nh, S, hd, N, Q) || heads < 1) return 0;
  return (long long)workspace(B, nh, S, hd, N, Q, heads).bytes;
}

// All pointers f32 on the device but `ws` (ssd_scan_bwd_workspace bytes,
// 256-byte aligned); dh may be null (a zero cotangent of the final state);
// g <= 0 (the anchored mask's precondition, as the forward's).  The plan of
// kernels/ssd_scan/plan.py::ssd_bwd_plan: `heads` heads a pairs or rows
// block (1..8), `dtiles` the pairs kernel's instantiation (2, 4 or 8, hd <=
// 16 dtiles), `vec` 16-byte copies (N and hd multiples of 4, every operand
// 16-byte aligned).  Launches the four passes on `stream`; returns
// cudaErrorInvalidValue for anything else, else the first launch error (0
// = launched).
int ssd_scan_bwd_launch(const void* xdt, const void* g, const void* Bm, const void* Cm,
                        const void* dy, const void* dh, void* dxdt, void* dg, void* dBm,
                        void* dCm, void* ws, int B, int nh, int S, int hd, int N, int Q,
                        int heads, int dtiles, int vec, void* stream) {
  if (!shape_ok(B, nh, S, hd, N, Q) || heads < 1 || heads > 8) return (int)cudaErrorInvalidValue;
  if ((dtiles != 2 && dtiles != 4 && dtiles != 8) || hd > 16 * dtiles)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (N % 4 || hd % 4 || !aligned(xdt) || !aligned(Bm) || !aligned(Cm) ||
              !aligned(dy) || (dh != nullptr && !aligned(dh))))
    return (int)cudaErrorInvalidValue;
  const int spc = (Q + SEG - 1) / SEG, nseg = S / Q * spc;
  const int T = (min(Q, SEG) + TR - 1) / TR, npairs = T * (T + 1) / 2;
  const int groups = (nh + heads - 1) / heads, hdp = 16 * dtiles;
  const int dtl = (hd + TR - 1) / TR, ntl = (N + TR - 1) / TR;
  const long long cb_blocks = (long long)B * nseg * npairs;
  const long long prep = cb_blocks + (long long)B * nh * 2 * dtl * ntl;
  const long long chunk = (long long)B * nseg * groups * T;
  const long long sum_blocks = ((long long)B * S * N + BT - 1) / BT;
  const long long finish = sum_blocks + (long long)B * nh * nseg;
  if (prep > 0x7fffffffLL || chunk > 0x7fffffffLL || finish > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const PairsSmem pm = pairs_smem(hdp);
  const size_t rows_bytes = (size_t)2 * ROWS_STAGE * sizeof(float);
  const size_t prep_bytes = (size_t)2 * 2 * TR * SP * sizeof(float);   // either role's ring
  if (pm.bytes + 8 * 1024 > SMEM_MAX) return (int)cudaErrorInvalidValue;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = workspace(B, nh, S, hd, N, Q, heads);
  char* base = static_cast<char*>(ws);
  float* cb = reinterpret_cast<float*>(base + w.cb);
  float* H = reinterpret_cast<float*>(base + w.H);
  float* DH = reinterpret_cast<float*>(base + w.DH);
  const int v = vec ? 1 : 0;
  cudaError_t e;

  static size_t prep_opted = 0, rows_opted = 0;
  if ((e = opt_in((const void*)bwd_prep, prep_bytes, prep_opted)) != cudaSuccess) return (int)e;
  PrepArgs pa{static_cast<const float*>(xdt), static_cast<const float*>(g),
              static_cast<const float*>(Bm),  static_cast<const float*>(Cm),
              static_cast<const float*>(dy),  static_cast<const float*>(dh),
              cb, H, DH, nh, S, hd, N, Q, spc, nseg, T, npairs, (int)cb_blocks, dtl, ntl, v};
  bwd_prep<<<(unsigned)prep, BT, prep_bytes, st>>>(pa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  ChunkArgs ca{static_cast<const float*>(xdt), static_cast<const float*>(g),
               static_cast<const float*>(Bm),  static_cast<const float*>(Cm),
               static_cast<const float*>(dy),  cb, H, DH,
               reinterpret_cast<float*>(base + w.eg), static_cast<float*>(dxdt),
               reinterpret_cast<float*>(base + w.pb), reinterpret_cast<float*>(base + w.pc),
               reinterpret_cast<double*>(base + w.rowp), reinterpret_cast<double*>(base + w.cs),
               reinterpret_cast<double*>(base + w.rs), reinterpret_cast<double*>(base + w.d1),
               reinterpret_cast<double*>(base + w.kc),
               nh, S, hd, N, Q, spc, nseg, T, npairs, heads, groups, hdp, v};
  e = dtiles == 2   ? launch_pairs<2>((unsigned)chunk, pm.bytes, st, ca)
      : dtiles == 4 ? launch_pairs<4>((unsigned)chunk, pm.bytes, st, ca)
                    : launch_pairs<8>((unsigned)chunk, pm.bytes, st, ca);
  if (e != cudaSuccess) return (int)e;
  if ((e = opt_in((const void*)bwd_rows, rows_bytes, rows_opted)) != cudaSuccess) return (int)e;
  bwd_rows<<<(unsigned)chunk, BT, rows_bytes, st>>>(ca);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  FinishArgs fa{ca.pb, ca.pc, ca.d1, ca.rs, ca.kc, static_cast<float*>(dBm),
                static_cast<float*>(dCm), static_cast<float*>(dg), B, nh, S, N, Q, spc, nseg,
                groups, (int)sum_blocks};
  bwd_finish<<<(unsigned)finish, BT, 0, st>>>(fa);
  return (int)cudaGetLastError();
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
