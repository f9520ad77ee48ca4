// Chunked SSD (Mamba2 state-space duality) forward for Hopper (sm_90a).
//   xdt (B, nh, S, hd)  x * dt, pre-scaled by the wrapper
//   g   (B, nh, S)      A * dt, the per-token log decay: <= 0 (A < 0, dt >
//                       0), a precondition of the anchored mask below
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
// (N, hd) state in VMEM scratch, and each step held one whole chunk and
// formed its (Q, Q) C B^T block for every head.
//
// What bounds it on the H100: per (batch, chunk) the causal half of C B^T,
// 2 (Q (Q + 1) / 2) N flops, shared by every head; per (batch, head,
// chunk) the causal half of the masked product, 2 (Q (Q + 1) / 2) hd, the
// state update 2 Q N hd, and C h 2 Q N hd where the incoming state is not
// zero (not the first chunk); against (B nh S (2 hd + 1) + 2 B S N + B nh
// hd N) * 4 bytes.  At the full-width prefill (B 1, nh = 80, hd = 64, N =
// 128) S = 200 is ~0.47 GFLOP and 11.1 MB, S = 512 ~1.7 GFLOP and 24.3 MB:
// 7.1 and 25.3 us in f32 FFMA (67 TFLOP/s); on the tensor cores in 3xTF32
// (three TF32 products per f32 product at 495 TFLOP/s) 2.9 and 10.3 us,
// so S = 200 is bound by its bytes (3.3 us) and S = 512 by operations.
//
// Design (the plan, kernels/ssd_scan/plan.py::ssd_plan, comes in as ints):
//  * one block of 4 warps per unit: a head of a batch row and a tile of
//    DC = 32 head dims (y[:, d] and h[:, d] depend on column d of xdt
//    alone, so the column split is exact; a ragged last tile is masked).
//    That gives 160 blocks at the serving shape, where 80 heads of 64 would
//    leave 52 of 132 SMs idle; a block's ~104 KB of shared memory and 255
//    registers let two share an SM.  (DC 64 measured slower there, with 80
//    blocks of 4 warps, and so did DC 16 with 320.)  A warp owns 16 rows of
//    each 64-row query tile;
//  * C B^T once per (batch, chunk) and cluster: CL <= 8 blocks of one
//    batch row form a thread-block cluster.  The chunk's causal 64 x 64
//    tiles (i, j), j <= i (10 at Q = 256) are split over the cluster (tile
//    k to rank k % CL), each formed into its owner's shared memory; after
//    the cluster barrier every block walks the tiles in causal order,
//    copying each from its owner's shared memory (distributed shared
//    memory, 16-byte loads held in registers, the next tile's in flight
//    while the current one is multiplied).  At 160 units and CL 8 a
//    chunk's C B^T is formed 20 times instead of 160;
//  * the cluster barrier is split: a block arrives once its tiles are
//    formed, then runs the state update (which needs no C B^T) and only
//    then waits for its peers, so the ranks that form two tiles are
//    waited for behind other work;
//  * the mask stays a difference of prefix sums: cum is the block's prefix
//    sum of the chunk's g in double (warp shuffles), every difference is
//    taken in double and rounded once to f32 before the exponential.  The
//    model's decays put cum in the thousands inside a chunk, where an f32
//    ulp is ~5e-4, and exp(cum_t) exp(-cum_s) overflows.  For a key s
//    before an anchor row a <= t the mask is exp(cum_t - cum_a) exp(cum_a -
//    cum_s): with g <= 0 both differences are <= 0, so neither factor
//    exceeds 1 (the precondition on g of the C entry).  The anchor is the
//    query tile's first row for the tiles left of the diagonal, the warp's
//    first row on the diagonal: a row takes one exponential per tile, a key
//    one per tile (kept in shared memory), and only a warp's own 16 keys
//    take exp(cum_t - cum_s) itself, where t >= s and exactly 0 above the
//    diagonal.  The exponentials are __expf;
//  * all four products on mma.sync.m16n8k8 TF32 in 3xTF32 (an f32 operand
//    v is split into big = rna(v) and small = rna(v - big), and the
//    product takes small*big + big*small + big*big, as the LoRA tile of
//    csrc/lora_mma.cuh): C B^T (K = N), M xdt (K = the key rows), C h_prev
//    (K = N) and B^T (xdt o exp(cum_Q - cum)) (K = the chunk's rows).
//    Each K-chunk's three passes go into a zeroed fragment that is then
//    added to the accumulator: the tensor core truncates what it adds;
//  * C h_prev is skipped while the state is exactly zero, the first chunk
//    of every call (exp(cum_t) <= 1 times 0 is 0);
//  * the state h^T (DC x N) lives in registers (warp w owns N / 4 of its
//    columns), scaled by exp(cum_Q) and updated in 16-row slices of B; C h
//    reads the previous state from shared memory, written after C B^T is
//    formed;
//  * xdt's rows of the chunk are staged once per block and chunk (cp.async,
//    in flight while the prefix sum runs and C B^T is formed); B and C
//    stream through cp.async rings, the next slice requested before the
//    current one is multiplied: 32-column slices of 64 rows for C B^T
//    (two stages over the state's buffer, free at that point) and C h,
//    16-row slices of all N columns of B for the state update.  16-byte
//    copies where N and hd are multiples of 4 and every base pointer is
//    16-byte aligned, element copies otherwise, zero-filled past the
//    chunk, N and the column tile;
//  * the mma loops have no branches inside: tiles past the chunk or above
//    the diagonal are multiplied as zeros (masked), so the loads, the
//    exponentials and the products of a K-chunk overlap (a warp-uniform
//    branch per n tile serialised them);
//  * shared tiles are laid out so that every fragment read is free of
//    bank conflicts: xdt XOR-swizzles its 8-column groups by row, as does
//    the state; C B^T tiles swizzle
//    4-column groups; ring rows are padded;
//  * chunks longer than 256 rows are walked as sub-chunks of at most 256
//    (the result does not depend on the chunk length, only its rounding
//    does): a sub-chunk has at most 4 x 4 row tiles, whose 10 causal C B^T
//    tiles, xdt rows and prefix sums fit a block;
//  * Q is a runtime value; ragged row tiles, N from 1 to 256 and any hd are
//    masked; one launch, no workspace;
//  * no atomics, and every sum runs in a fixed order: two runs give equal
//    bits.
// Not yet: wgmma / TMA; the B operand (xdt, the state) is split again by
// each warp that reads it.

#include "lora_mma.cuh"

namespace {

constexpr int SSD_NT = 128;             // threads: 4 warps
constexpr int SSD_NW = SSD_NT / 32;
constexpr int SSD_DC = 32;              // head dims of a block (its column tile)
constexpr int SSD_TR = 64;              // rows of a row tile; side of a C B^T tile
constexpr int SSD_QMAX = 256;           // rows of the longest sub-chunk
constexpr int SSD_NMAX = 256;           // largest state size taken
constexpr int SSD_KS = 32;              // columns of a C / B slice (C B^T, C h)
constexpr int SSD_KSP = SSD_KS + 4;     // its padded row
constexpr int SSD_RS = 16;              // rows of a B slice (state update)
constexpr int SSD_NS = 2;               // stages of every cp.async ring
constexpr int SSD_MAX_CLUSTER = 8;
constexpr size_t SSD_SMEM_MAX = 232448;

// (rows, SSD_DC) f32 operands in shared memory (xdt rows, the state): each
// 8-column group XOR-swizzled by row, so B fragments (row k + tig, column
// n + gid) hit 32 banks
__device__ __forceinline__ int xs_at(int r, int d) { return r * SSD_DC + (d ^ ((r & 3) << 3)); }

// a 64 x 64 C B^T tile, 4-column groups swizzled by row: A fragments (row
// gid, column k + tig) hit 32 banks, and a C fragment's column pair stays
// together
__device__ __forceinline__ int cb_at(int t, int s) { return t * SSD_TR + (s ^ ((t & 7) << 2)); }

__device__ __forceinline__ int tile_index(int i, int j) { return i * (i + 1) / 2 + j; }

struct SsdSmem {
  int nr, bp;                           // state rows (N to 32); B slice pitch
  size_t cum, wdec, cfac, xs, own, hs, ring, bytes;
};

// byte offsets of the block's shared memory: cum (doubles), the decay to
// the chunk's end, the mask's key factors (the tile's, then each warp's),
// xdt rows, the C B^T tiles it owns, the state (C h's operand) and the
// ring (state-update and C h slices, or the tile being read).  Forming
// C B^T, whose slices hold both C and B, runs its ring over the state's
// buffer and the ring together: the state is then in registers.
__host__ __device__ inline SsdSmem ssd_smem(int N, int cap) {
  SsdSmem L;
  L.nr = (N + SSD_KS - 1) / SSD_KS * SSD_KS;
  L.bp = (N + 31) / 32 * 32 + 8;
  size_t off = 0;
  L.cum = off;
  off += SSD_QMAX * sizeof(double);
  L.wdec = off;
  off += SSD_QMAX * sizeof(float);
  L.cfac = off;
  off += (SSD_NW + 1) * SSD_TR * sizeof(float);
  L.xs = off;
  off += (size_t)SSD_QMAX * SSD_DC * sizeof(float);
  L.own = off;
  off += (size_t)cap * SSD_TR * SSD_TR * sizeof(float);
  L.hs = off;
  const long long hsf = (long long)L.nr * SSD_DC;
  off += hsf * sizeof(float);
  L.ring = off;
  long long ring = (long long)SSD_NS * SSD_TR * SSD_KSP;
  ring = ring > SSD_NS * 2 * SSD_TR * SSD_KSP - hsf ? ring
                                                     : SSD_NS * 2 * SSD_TR * SSD_KSP - hsf;
  ring = ring > (long long)SSD_NS * SSD_RS * L.bp ? ring : (long long)SSD_NS * SSD_RS * L.bp;
  ring = ring > SSD_TR * SSD_TR ? ring : SSD_TR * SSD_TR;
  L.bytes = off + ring * sizeof(float);
  return L;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// cum[0..Q) = inclusive prefix sum of g[0..Q) in double, SSD_NT at a time
__device__ void chunk_cumsum(const float* __restrict__ g, double* cum, int Q,
                             double* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < Q; base += SSD_NT) {
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
    for (int k = 0; k < SSD_NW; ++k) {
      if (k < w) off += warp_tot[k];
      seg += warp_tot[k];
    }
    if (i < Q) cum[i] = v + off;
    carry += seg;
    __syncthreads();                    // warp_tot is rewritten next round
  }
}

// rows [r0, r0 + 64) and columns [k0, k0 + KS) of a (rows, N) matrix into
// a 64 x (KS + 4) slice, zero past `rows` and N
template <bool VEC, int KS>
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ src, int r0,
                                            int rows, int k0, int N) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < SSD_TR * (KS / 4); e += SSD_NT) {
      const int r = e / (KS / 4), c = (e % (KS / 4)) * 4;
      const bool ok = r0 + r < rows && k0 + c < N;
      cp_async16(dst + r * (KS + 4) + c, src + (ok ? (size_t)(r0 + r) * N + k0 + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < SSD_TR * KS; e += SSD_NT) {
      const int r = e / KS, c = e % KS;
      const bool ok = r0 + r < rows && k0 + c < N;
      cp_async4(dst + r * (KS + 4) + c, src + (ok ? (size_t)(r0 + r) * N + k0 + c : 0), ok);
    }
  }
}

// rows [s0, s0 + SSD_RS) of a (rows, N) matrix, columns [0, nr), into
// SSD_RS rows of pitch bp, zero past `rows` and N
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int s0,
                                           int rows, int N, int nr, int bp) {
  if constexpr (VEC) {
    const int per = nr / 4;
    for (int e = threadIdx.x; e < SSD_RS * per; e += SSD_NT) {
      const int r = e / per, c = (e % per) * 4;
      const bool ok = s0 + r < rows && c < N;
      cp_async16(dst + r * bp + c, src + (ok ? (size_t)(s0 + r) * N + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < SSD_RS * nr; e += SSD_NT) {
      const int r = e / nr, c = e % nr;
      const bool ok = s0 + r < rows && c < N;
      cp_async4(dst + r * bp + c, src + (ok ? (size_t)(s0 + r) * N + c : 0), ok);
    }
  }
}

// One block per (unit, batch row), CL blocks of a batch row per cluster;
// units_pad = units rounded up to CL, cap = C B^T tiles a block may own.
template <int NB, bool VEC>
__global__ void __launch_bounds__(SSD_NT) ssd_scan_fwd(
    const float* __restrict__ xdt, const float* __restrict__ g,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ h_last, int nh, int S, int hd, int N, int Q, int units,
    int units_pad, int cap) {
  constexpr int NTN = SSD_DC / 8;       // n tiles of a 16-row x SSD_DC product
  constexpr int MT = SSD_DC / 16;       // m tiles of the state h^T (SSD_DC x N)
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_tot[SSD_NW];
  const SsdSmem L = ssd_smem(N, cap);
  double* cum = reinterpret_cast<double*>(smem + L.cum);
  float* wdec = reinterpret_cast<float*>(smem + L.wdec);
  float* cfac = reinterpret_cast<float*>(smem + L.cfac);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* own = reinterpret_cast<float*>(smem + L.own);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* deep = hs;                     // C B^T's ring: hs and ring together
  const int nr = L.nr, bp = L.bp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int w16 = warp * 16;            // the warp's first row of a row tile
  const int b = blockIdx.x / units_pad, u = blockIdx.x % units_pad;
  const bool live = u < units;          // a padding unit only forms C B^T tiles
  const int ct = (hd + SSD_DC - 1) / SSD_DC;
  const int head = live ? u / ct : 0;
  const int d0 = live ? (u % ct) * SSD_DC : 0;
  const int dc = min(SSD_DC, hd - d0);
  const size_t bh = (size_t)b * nh + head;
  const float* xb = xdt + bh * S * hd + d0;
  const float* gb = g + bh * S;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  float* yb = y + bh * S * hd + d0;

  float hacc[MT][NB][4];                // the state h^T: rows d, columns n
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[m][nt][e] = 0.f;

  bool first = true;                    // the state is exactly zero
  for (int c0 = 0; c0 < S; c0 += Q) {
    for (int q0 = c0; q0 < c0 + Q; q0 += SSD_QMAX) {
      const int Qc = min(SSD_QMAX, c0 + Q - q0);    // rows of this sub-chunk
      const int T = (Qc + SSD_TR - 1) / SSD_TR;
      const int ntiles = T * (T + 1) / 2;
      const float* Bq = Bb + (size_t)q0 * N;
      const float* Cq = Cb + (size_t)q0 * N;

      // the cluster has read the previous sub-chunk's C B^T tiles
      if (!first) cluster_wait();

      // ---- xdt rows, in flight while cum and C B^T are formed ------------
      if (live) {
        const float* xq = xb + (size_t)q0 * hd;
        if constexpr (VEC) {
          for (int e = tid; e < T * SSD_TR * (SSD_DC / 4); e += SSD_NT) {
            const int r = e / (SSD_DC / 4), c = (e % (SSD_DC / 4)) * 4;
            const bool ok = r < Qc && c < dc;
            cp_async16(xs + xs_at(r, c), xq + (ok ? (size_t)r * hd + c : 0), ok);
          }
        } else {
          for (int e = tid; e < T * SSD_TR * SSD_DC; e += SSD_NT) {
            const int r = e / SSD_DC, c = e % SSD_DC;
            const bool ok = r < Qc && c < dc;
            cp_async4(xs + xs_at(r, c), xq + (ok ? (size_t)r * hd + c : 0), ok);
          }
        }
      }
      cp_async_commit();
      if (live) chunk_cumsum(gb + q0, cum, Qc, warp_tot);

      // ---- this block's share of C B^T: tiles rank, rank + CL, ... --------
      const int nsl = (N + SSD_KS - 1) / SSD_KS;      // C (and B) slices
      for (int k = rank, slot = 0; k < ntiles; k += CL, ++slot) {
        int i = 0;
        while (tile_index(i + 1, 0) <= k) ++i;
        const int j = k - tile_index(i, 0);
        const bool wlive = i * SSD_TR + w16 < Qc;
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        auto issue = [&](int sl) {     // one group per slice, empty past N
          if (sl < nsl) {
            float* st = deep + (sl % SSD_NS) * 2 * SSD_TR * SSD_KSP;
            stage_slice<VEC, SSD_KS>(st, Cq, i * SSD_TR, Qc, sl * SSD_KS, N);
            stage_slice<VEC, SSD_KS>(st + SSD_TR * SSD_KSP, Bq, j * SSD_TR, Qc, sl * SSD_KS, N);
          }
          cp_async_commit();
        };
#pragma unroll
        for (int sl = 0; sl < SSD_NS - 1; ++sl) issue(sl);
        for (int sl = 0; sl < nsl; ++sl) {
          issue(sl + SSD_NS - 1);
          cp_async_wait<SSD_NS - 1>();
          __syncthreads();
          if (wlive) {
            const float* cs = deep + (sl % SSD_NS) * 2 * SSD_TR * SSD_KSP;
            const float* bs = cs + SSD_TR * SSD_KSP;
            float tmp[8][4];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < SSD_KS / 8; ++kk) {
              const float* ar = cs + (w16 + gid) * SSD_KSP + kk * 8 + tig;
              const float av[4] = {ar[0], ar[8 * SSD_KSP], ar[4], ar[8 * SSD_KSP + 4]};
              uint32_t ab[4], as[4];
              split4(av, ab, as);
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const float* br = bs + (nt * 8 + gid) * SSD_KSP + kk * 8 + tig;
                mma3(tmp[nt], ab, as, br[0], br[4]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
          }
          __syncthreads();              // the stage is refilled NSF - 1 slices on
        }
        if (wlive) {
          float* dst = own + (size_t)slot * SSD_TR * SSD_TR;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int t = w16 + gid + 8 * h2;
              *reinterpret_cast<float2*>(dst + cb_at(t, nt * 8 + 2 * tig)) =
                  make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
            }
          }
        }
      }
      // C h's operand: the state, from registers into the buffer the
      // deeper rings have just left
      if (live && !first) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int nt = 0; nt < NB; ++nt) {
            const int n0 = (warp * NB + nt) * 8;
            if (n0 >= nr) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hs[xs_at(n0 + 2 * tig + (e & 1), m * 16 + gid + 8 * (e >> 1))] =
                  hacc[m][nt][e];
          }
      }
      if (live)
        for (int s = tid; s < T * SSD_TR; s += SSD_NT)
          wdec[s] = s < Qc ? __expf((float)(cum[Qc - 1] - cum[s])) : 0.f;
      cp_async_wait<0>();               // xdt rows landed, even with no tile owned
      __syncthreads();
      cluster_arrive();                 // this block's tiles are in place

      // ---- state: h <- h exp(cum_Q) + B^T (xdt * exp(cum_Q - cum)) ---------
      // while the peers finish their C B^T tiles: it needs none.  h^T (SSD_DC
      // x N) in registers: A = (xdt * decay)^T from xs (rows d), B = the rows
      // of Bm streamed through the ring; warp w owns the n tiles w * NB ...
      // w * NB + NB - 1
      if (live) {
        const float decay = __expf((float)cum[Qc - 1]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int nt = 0; nt < NB; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[m][nt][e] *= decay;
        const int nsl3 = (Qc + SSD_RS - 1) / SSD_RS;
        auto issue3 = [&](int sl) {    // one group per slice, empty past the chunk
          if (sl < nsl3)
            stage_rows<VEC>(ring + (sl % SSD_NS) * SSD_RS * bp, Bq, sl * SSD_RS, Qc, N, nr, bp);
          cp_async_commit();
        };
        issue3(0);
        for (int sl = 0; sl < nsl3; ++sl) {
          issue3(sl + 1);
          cp_async_wait<1>();
          __syncthreads();
          const float* bs = ring + (sl % SSD_NS) * SSD_RS * bp;
          float tmp[MT][NB][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nt = 0; nt < NB; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) tmp[m][nt][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < SSD_RS / 8; ++kk) {
            const int s = sl * SSD_RS + kk * 8 + tig;               // chunk row
            uint32_t ab[MT][4], as[MT][4];
#pragma unroll
            const float w0 = wdec[s], w1 = wdec[s + 4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const int d = m * 16 + gid;
              const float av[4] = {xs[xs_at(s, d)] * w0, xs[xs_at(s, d + 8)] * w0,
                                   xs[xs_at(s + 4, d)] * w1, xs[xs_at(s + 4, d + 8)] * w1};
              split4(av, ab[m], as[m]);
            }
#pragma unroll
            for (int nt = 0; nt < NB; ++nt) {
              const int n0 = (warp * NB + nt) * 8;
              const float* br = bs + (kk * 8 + tig) * bp + n0 + gid;
              uint32_t bb[2], bsm[2];
              split(br[0], bb[0], bsm[0]);
              split(br[4 * bp], bb[1], bsm[1]);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                mma_tf32(tmp[m][nt], as[m], bb);
                mma_tf32(tmp[m][nt], ab[m], bsm);
                mma_tf32(tmp[m][nt], ab[m], bb);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nt = 0; nt < NB; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) hacc[m][nt][e] += tmp[m][nt][e];
          __syncthreads();
        }
      }
      cluster_wait();                   // every peer's tiles are in place

      // ---- outputs: the causal tiles (i, j) in order, query tile by tile ----
      if (live) {
        // tile k of C B^T from its owner, 16 bytes a load, into registers;
        // put() stores it in the ring as the working tile.  Tile k + 1 is
        // in flight while tile k is multiplied (and across query tiles)
        float4 pre[SSD_TR * SSD_TR / 4 / SSD_NT];
        auto fetch = [&](int k) {
          int ti = 0;
          while (tile_index(ti + 1, 0) <= k) ++ti;
          const int rows = min(SSD_TR, Qc - ti * SSD_TR);
          const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(
              own + (size_t)(k / CL) * SSD_TR * SSD_TR, k % CL));
#pragma unroll
          for (int v = 0; v < SSD_TR * SSD_TR / 4 / SSD_NT; ++v) {
            const int e = tid + v * SSD_NT;
            if (e < rows * (SSD_TR / 4)) pre[v] = src[e];
          }
        };
        auto put = [&](int rows) {
          float4* dst = reinterpret_cast<float4*>(ring);
#pragma unroll
          for (int v = 0; v < SSD_TR * SSD_TR / 4 / SSD_NT; ++v) {
            const int e = tid + v * SSD_NT;
            if (e < rows * (SSD_TR / 4)) dst[e] = pre[v];
          }
        };
        fetch(0);
        float acc[NTN][4];
        for (int k = 0, i = 0, j = 0; k < ntiles; ++k) {
          const int rows = min(SSD_TR, Qc - i * SSD_TR);
          const int t0 = i * SSD_TR + w16 + gid, t1 = t0 + 8;       // chunk rows
          const bool wlive = i * SSD_TR + w16 < Qc;
          const double ct0 = t0 < Qc ? cum[t0] : 0.0, ct1 = t1 < Qc ? cum[t1] : 0.0;
          // below the diagonal the mask factors at a = i * 64, the query
          // tile's first row: exp(cum_t - cum_a) exp(cum_a - cum_s) for s <
          // a <= t, both differences <= 0 (no factor overflows), each taken
          // in double and rounded once
          const double ca = cum[i * SSD_TR];
          const float r0 = t0 < Qc ? __expf((float)(ct0 - ca)) : 0.f;
          const float r1 = t1 < Qc ? __expf((float)(ct1 - ca)) : 0.f;
          if (j < i && tid < SSD_TR) cfac[tid] = __expf((float)(ca - cum[j * SSD_TR + tid]));
          // on the diagonal, keys before the warp's first row aw factor at aw
          const int aw = i * SSD_TR + w16;
          const double cw = aw < Qc ? cum[aw] : 0.0;
          const float rw0 = t0 < Qc ? __expf((float)(ct0 - cw)) : 0.f;
          const float rw1 = t1 < Qc ? __expf((float)(ct1 - cw)) : 0.f;
          float* cfw = cfac + (1 + warp) * SSD_TR;
          if (j == i && aw < Qc) {
            for (int v = lane; v < w16; v += 32)
              cfw[v] = __expf((float)(cw - cum[i * SSD_TR + v]));
          }
          if (j == 0) {
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          }

          // inter-chunk: exp(cum_t) C_t . h_prev, skipped while h is zero
          if (j == 0 && !first) {
            float inter[NTN][4];
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) inter[nt][e] = 0.f;
            auto issue_c = [&](int sl) {   // one group per slice, empty past N
              if (sl < nsl)
                stage_slice<VEC, SSD_KS>(ring + (sl % SSD_NS) * SSD_TR * SSD_KSP, Cq,
                                         i * SSD_TR, Qc, sl * SSD_KS, N);
              cp_async_commit();
            };
#pragma unroll
            for (int sl = 0; sl < SSD_NS - 1; ++sl) issue_c(sl);
            for (int sl = 0; sl < nsl; ++sl) {
              issue_c(sl + SSD_NS - 1);
              cp_async_wait<SSD_NS - 1>();
              __syncthreads();
              if (wlive) {
                const float* cs = ring + (sl % SSD_NS) * SSD_TR * SSD_KSP;
                float tmp[NTN][4];
#pragma unroll
                for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
                  for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < SSD_KS / 8; ++kk) {
                  const float* ar = cs + (w16 + gid) * SSD_KSP + kk * 8 + tig;
                  const float av[4] = {ar[0], ar[8 * SSD_KSP], ar[4], ar[8 * SSD_KSP + 4]};
                  uint32_t ab[4], as[4];
                  split4(av, ab, as);
                  const int n = sl * SSD_KS + kk * 8 + tig;
#pragma unroll
                  for (int nt = 0; nt < NTN; ++nt) {
                    mma3(tmp[nt], ab, as, hs[xs_at(n, nt * 8 + gid)],
                         hs[xs_at(n + 4, nt * 8 + gid)]);
                  }
                }
#pragma unroll
                for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
                  for (int e = 0; e < 4; ++e) inter[nt][e] += tmp[nt][e];
              }
              __syncthreads();
            }
            const float e0 = t0 < Qc ? __expf((float)ct0) : 0.f;
            const float e1 = t1 < Qc ? __expf((float)ct1) : 0.f;
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
              acc[nt][0] = inter[nt][0] * e0;
              acc[nt][1] = inter[nt][1] * e0;
              acc[nt][2] = inter[nt][2] * e1;
              acc[nt][3] = inter[nt][3] * e1;
            }
          }

          // intra-chunk: the masked tile (i, j)
          put(rows);
          __syncthreads();
          if (k + 1 < ntiles) fetch(k + 1);
          if (wlive) {
            float tmp[NTN][4];
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
            const int tl0 = w16 + gid, tl1 = tl0 + 8;               // rows in the tile
            if (j < i) {
#pragma unroll
              for (int kk = 0; kk < SSD_TR / 8; ++kk) {
                const int sl0 = kk * 8 + tig, sl1 = sl0 + 4;        // keys in the tile
                const int s0 = j * SSD_TR + sl0, s1 = s0 + 4;       // chunk rows
                const float c0 = cfac[sl0], c1 = cfac[sl1];
                const float mv[4] = {ring[cb_at(tl0, sl0)] * r0 * c0,
                                     ring[cb_at(tl1, sl0)] * r1 * c0,
                                     ring[cb_at(tl0, sl1)] * r0 * c1,
                                     ring[cb_at(tl1, sl1)] * r1 * c1};
                uint32_t ab[4], as[4];
                split4(mv, ab, as);
#pragma unroll
                for (int nt = 0; nt < NTN; ++nt)
                  mma3(tmp[nt], ab, as, xs[xs_at(s0, nt * 8 + gid)],
                       xs[xs_at(s1, nt * 8 + gid)]);
              }
            } else {
#pragma unroll
              for (int kk = 0; kk < SSD_TR / 8; ++kk) {
                const int sl0 = kk * 8 + tig, sl1 = sl0 + 4;        // keys in the tile
                const int s0 = j * SSD_TR + sl0, s1 = s0 + 4;       // chunk rows
                float mv[4];
                if (kk * 8 < w16) {
                  // keys before the warp's rows: exp(cum_t - cum_aw) exp(cum_aw - cum_s)
                  const float c0 = cfw[sl0], c1 = cfw[sl1];
                  mv[0] = ring[cb_at(tl0, sl0)] * rw0 * c0;
                  mv[1] = ring[cb_at(tl1, sl0)] * rw1 * c0;
                  mv[2] = ring[cb_at(tl0, sl1)] * rw0 * c1;
                  mv[3] = ring[cb_at(tl1, sl1)] * rw1 * c1;
                } else {
                  // the warp's own keys: exp(cum_t - cum_s) itself, taken only
                  // where t >= s (cum_t - cum_s > 0 for t < s)
                  const double cs0 = s0 < Qc ? cum[s0] : 0.0, cs1 = s1 < Qc ? cum[s1] : 0.0;
                  mv[0] = (s0 <= t0 && t0 < Qc)
                              ? ring[cb_at(tl0, sl0)] * __expf((float)(ct0 - cs0)) : 0.f;
                  mv[1] = (s0 <= t1 && t1 < Qc)
                              ? ring[cb_at(tl1, sl0)] * __expf((float)(ct1 - cs0)) : 0.f;
                  mv[2] = (s1 <= t0 && t0 < Qc)
                              ? ring[cb_at(tl0, sl1)] * __expf((float)(ct0 - cs1)) : 0.f;
                  mv[3] = (s1 <= t1 && t1 < Qc)
                              ? ring[cb_at(tl1, sl1)] * __expf((float)(ct1 - cs1)) : 0.f;
                }
                uint32_t ab[4], as[4];
                split4(mv, ab, as);
#pragma unroll
                for (int nt = 0; nt < NTN; ++nt)
                  mma3(tmp[nt], ab, as, xs[xs_at(s0, nt * 8 + gid)],
                       xs[xs_at(s1, nt * 8 + gid)]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
          }
          __syncthreads();              // the working tile is replaced next
          if (j < i) {
            ++j;
            continue;
          }
          if (wlive) {
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int t = e < 2 ? t0 : t1, d = nt * 8 + 2 * tig + (e & 1);
                if (t < Qc && d < dc) yb[(size_t)(q0 + t) * hd + d] = acc[nt][e];
              }
            }
          }
          ++i;
          j = 0;
        }
      }
      cluster_arrive();                 // done reading the peers' tiles

      first = false;
    }
  }
  cluster_wait();                       // no block leaves while a peer reads it

  // the state in the model layout (hd, N): rows d, N contiguous
  if (live) {
    float* hb = h_last + (bh * hd + d0) * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = (warp * NB + nt) * 8 + 2 * tig + (e & 1);
          const int d = m * 16 + gid + 8 * (e >> 1);
          if (n < N && d < dc) hb[(size_t)d * N + n] = hacc[m][nt][e];
        }
  }
}

template <int NB>
cudaError_t ssd_run(bool vec, dim3 grid, int CL, size_t bytes, cudaStream_t st,
                    const float* xdt, const float* g, const float* Bm, const float* Cm,
                    float* y, float* h, int nh, int S, int hd, int N, int Q, int units,
                    int units_pad, int cap) {
  return vec ? cluster_launch<ssd_scan_fwd<NB, true>, SSD_NT>(
                   grid, CL, bytes, st, xdt, g, Bm, Cm, y, h, nh, S, hd, N, Q, units,
                   units_pad, cap)
             : cluster_launch<ssd_scan_fwd<NB, false>, SSD_NT>(
                   grid, CL, bytes, st, xdt, g, Bm, Cm, y, h, nh, S, hd, N, Q, units,
                   units_pad, cap);
}

}  // namespace

extern "C" {

// All pointers f32 on the device; S % Q == 0; g = A dt <= 0 everywhere (a
// non-increasing prefix sum: the mask's factors exp(cum_t - cum_a) and
// exp(cum_a - cum_s) then never exceed 1; a g that rises and falls inside a
// chunk can make one overflow to inf against a zero, a NaN).  The plan of
// kernels/ssd_scan/plan.py: `cluster` blocks per cluster (1..8), each
// serving one head and SSD_DC = 32 head dims; `vec` 16-byte copies (N and
// hd multiples of 4, xdt, Bm and Cm 16-byte aligned).  Returns
// cudaErrorInvalidValue for anything else, else cudaGetLastError() after
// the launch (0 = launched).
int ssd_scan_launch(const void* xdt, const void* g, const void* Bm, const void* Cm,
                    void* y, void* h_last, int B, int nh, int S, int hd, int N, int Q,
                    int cluster, int vec, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || hd < 1 || N < 1 || N > SSD_NMAX || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > SSD_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (N % 4 || hd % 4 || !aligned(xdt) || !aligned(Bm) || !aligned(Cm)))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)nh * ((hd + SSD_DC - 1) / SSD_DC);
  const long long units_pad = (units + cluster - 1) / cluster * cluster;
  if (units_pad * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int T = (Q < SSD_QMAX ? Q + SSD_TR - 1 : SSD_QMAX) / SSD_TR;
  const int cap = (T * (T + 1) / 2 + cluster - 1) / cluster;
  const size_t bytes = ssd_smem(N, cap).bytes;
  if (bytes > SSD_SMEM_MAX - SSD_NW * sizeof(double)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(units_pad * B));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(h_last);
  const int u = (int)units, up = (int)units_pad;
  // NB: n tiles of the state a warp owns, 4 x NB x 8 >= N
  if (N <= 128)
    return (int)ssd_run<4>(vec, grid, cluster, bytes, st, x, gp, bp, cp, yp, hp, nh, S, hd, N,
                           Q, u, up, cap);
  return (int)ssd_run<8>(vec, grid, cluster, bytes, st, x, gp, bp, cp, yp, hp, nh, S, hd, N, Q,
                         u, up, cap);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
