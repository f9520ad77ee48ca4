// The partial softmax of one-token decode attention over one piece of a KV
// cache cut by its length, for Hopper (sm_90a).  For slot b, KV head h and
// the G query heads g of h (GQA), over the live positions j < min(length_b,
// L) of the piece:
//   q       (B, KH, G, D)     f32 or bf16
//   k/v     (B, L, KH, D)     q's dtype, the model cache layout read in place
//   lengths (B,)   int32      live entries per slot at [0, length); a length
//                             past L reads all L entries
//   m (B, KH, G)      f32     max_j s_j, s_j = q . K_j * D^-0.5
//   l (B, KH, G)      f32     sum_j exp(s_j - m)
//   o (B, KH, G, D)   f32     sum_j exp(s_j - m) V_j, unnormalised
// and a slot with no live key gives m = -1e30, l = 0, o = 0 exactly.
// sharding/tp.py::lse_combine joins the pieces over the "model" axis with
// one all-reduce max and one sum.
//
// Replaces: what GSPMD makes of src/repro/kernels/flash_attention/
// decode.py::flash_decode_kernel (Pallas, TPU) over a cache sharded by
// length: each device runs the kernel on its piece and the partitioner
// joins the pieces' softmax statistics.
//
// What bounds it on the H100: the piece's live K and V are read once, 2 *
// KH * live * D * bytes a slot, and 2 + D floats are written a query head:
// ~4 G flops a K/V entry, so bytes bound (0.36 us at yi-9b's piece at tp
// 8: 4 slots x 4 KV heads of 8 query heads x 128, 65 positions, f32).  At
// that size the call is latency bound: a launch (~5.3 us under
// chip_smoke.py's timer), the length and q read (~2 us), a tile's DRAM
// round trip and its products in one warp's dependent chains (~3-5 us)
// and the two merges and the writes (~2-3 us), in series, cut short
// variants of this kernel measured on an H100.  The split-K decode body
// of csrc/decode_split.cuh, which this entry ran before it had a body of
// its own, left ~100 SMs idle and reduced each row's 8 dot products one
// head after another with xor-shuffles (38 us there).
//
// Design:
//  * the G query heads of a KV head go on the tensor cores with the
//    operands swapped: S^T = K q^T on mma.sync.m16n8k8 TF32 with 16
//    positions as M, the block's 8 query heads as N and D as the
//    reduction, so one fragment holds a 16-position tile's scores of all 8
//    heads and a head's tile max is 3 xor-shuffles (for all heads at once);
//    the output is O^T = V^T P^T with D as M, the heads as N and the
//    positions as the reduction.  P goes from the C layout (position rows)
//    to the B layout (position k) through 512 bytes of shared memory a
//    warp.  G heads go in groups of 8 a block; a G that 8 does not divide
//    leaves the last group's extra heads at q = 0, computed and not written;
//  * f32 accuracy: an f32 operand x is split into big = rna(x) and small =
//    rna(x - big) and a product takes small*big + big*small + big*big
//    (3xTF32, csrc/mma_ptx.cuh); bf16 q, K and V are exact in TF32 and go
//    whole, but P stays f32, so P V takes two passes there.  q is read
//    (every load issued before the length's is waited on), split once a
//    block and kept in shared memory in B-fragment order (one 16-byte read
//    a lane a k step); the scale D^-0.5 goes on each score, after the
//    product, as the plain version applies it.  Each k step's products go
//    into a zeroed fragment, added in f32 in k order, and each 8 positions
//    of a tile's P V into a zeroed fragment, the tile joining the running
//    output in one f32 step, acc = acc * alpha + tile: the tensor core
//    truncates what it adds;
//  * K/V staged by cp.async: each warp walks its own tiles of 16 positions
//    through a ring of `stages` stages of its own (K then V, zero-filled
//    past the live positions and past D), issuing the copies of its first
//    `stages` tiles before it computes anything, so a short piece (a tile
//    a warp) costs one DRAM round trip, and a long one keeps stages - 1
//    tiles in flight behind the one in use.  16-byte copies where D *
//    bytes and both bases allow, element copies otherwise.  Row pitches
//    (f32 K DP + 4 words, V DP + 8; bf16 both DP + 8 halves) make every
//    fragment read conflict-free;
//  * the card filled: kernels/flash_attention/plan.py::partial_plan takes
//    S blocks of a thread-block cluster a (slot, KV head, head group) and 4
//    warps a block, from what the host knows (capacity, B, KH, G, D,
//    dtype): a tile runs faster on a block of its own than beside others,
//    so S grows to the capacity's tiles where the grid stays within the SM
//    count, and the stages, then the warps, stop where two blocks would no
//    longer fit an SM (clusters of 8 blocks one an SM found 15 of their 16
//    places at once: flash_decode_partial_clusters below).
//    Each block reads the slot's length itself: rank r takes an equal
//    contiguous share of the live tiles, its warp w the share's tiles w,
//    w + warps, ...; the host syncs nothing;
//  * merges without atomics: a warp's (m, l, acc) in registers (l a lane's
//    part, summed over the fragment's rows at the end); the block's max of
//    each head, each warp's acc scaled by exp(m_w - M) in registers and
//    the warps added in warp order through shared memory; the cluster's
//    blocks weighted and added in rank order through distributed shared
//    memory after cluster.sync(), the epilogue spread over the ranks.  Two
//    runs are bit-equal; a warp or block with no live tile joins with m =
//    -1e30, l = 0, acc = 0, so an empty piece gives (-1e30, 0, 0) exactly
//    (exp(0) * 0 = 0).
// Not yet: wgmma / TMA, and a tile's D cut over several warps to shorten
// the one warp's chains that bound a long piece.

#include <cooperative_groups.h>

#include "mma_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PT = 16;          // positions of a tile: M of S^T = K q^T
constexpr int PH = 8;           // query heads of a block: N of both products
constexpr int MAX_SPLITS = 8;   // blocks of one cluster (the portable limit)
constexpr int MAX_WARPS = 4;   // warps of a block
constexpr int MAX_STAGES = 3;  // ring stages a warp
constexpr int MAX_D = 256;
constexpr size_t SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// row pitches, in T, of a stage's K and V tiles for DP padded head dims
template <typename T>
__host__ __device__ constexpr int k_pitch(int dp) { return sizeof(T) == 4 ? dp + 4 : dp + 8; }
__host__ __device__ constexpr int v_pitch(int dp) { return dp + 8; }

template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int dp) {
  return sizeof(T) * (size_t)PT * (k_pitch<T>(dp) + v_pitch(dp));
}

// the rings, q's fragments, the warps' P tiles, the block's record (m, l
// and acc[D] of each head), the warps' max and sum and the ranks' weights of
// each head
template <typename T>
size_t partial_smem(int dp, int warps, int stages, int D) {
  return (size_t)warps * stages * stage_bytes<T>(dp) + (size_t)dp / 8 * 32 * 16 +
         (size_t)warps * PT * PH * 4 + (size_t)PH * (2 + D) * 4 +
         (size_t)PH * (2 * MAX_WARPS + MAX_SPLITS) * 4;
}

// q (B, KH, G, D); k/v (B, L, KH, D); lengths (B,) int32; m, l (B, KH, G)
// and o (B, KH, G, D) f32.  Block x of the grid is rank x % S of unit x / S,
// unit = (b * KH + h) * groups + group; D <= DP = 16 * DT.
template <typename T, int DT>
__global__ void __launch_bounds__(32 * MAX_WARPS) decode_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int L, int KH, int G, int D, int stages, float scale,
    int vec) {
  constexpr int DP = 16 * DT;
  constexpr int NKS = DP / 8;           // k steps of the scores
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int EPV = 16 / sizeof(T);   // entries of a 16-byte copy
  constexpr int PK = k_pitch<T>(DP), PV = v_pitch(DP);
  constexpr int STAGE = PT * (PK + PV); // in T
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int NW = (int)blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int groups = (G + PH - 1) / PH;
  const int unit = blockIdx.x / S;
  const int bh = unit / groups, g0 = (unit % groups) * PH;
  const int b = bh / KH, h = bh % KH;

  const size_t ring_bytes = (size_t)stages * STAGE * sizeof(T);
  T* ring = reinterpret_cast<T*>(smem + warp * ring_bytes);      // this warp's
  uint4* qf = reinterpret_cast<uint4*>(smem + NW * ring_bytes);  // NKS x 32
  float* pbuf = reinterpret_cast<float*>(qf + NKS * 32) + warp * PT * PH;
  float* bpart = reinterpret_cast<float*>(qf + NKS * 32) + NW * PT * PH;
  float* wts = bpart + PH * (2 + D);            // the merges' maxima, sums and weights

  // q's B fragments, every load issued first (none waits for the length):
  // entry x = 32 kk + ln holds head g0 + ln / 4 at dims 8 kk + ln % 4 and + 4
  const T* qb = q + (size_t)bh * G * D;
  float qe[NKS][2];
#pragma unroll
  for (int it = 0; it < NKS; ++it) {
    const int x = tid + it * (int)blockDim.x;
    const int g = g0 + (x & 31) / 4, d0 = (x / 32) * 8 + (x & 3);
    const bool ok = x < NKS * 32 && g < G;
    qe[it][0] = ok && d0 < D ? to_f(qb[(size_t)g * D + d0]) : 0.f;
    qe[it][1] = ok && d0 + 4 < D ? to_f(qb[(size_t)g * D + d0 + 4]) : 0.f;
  }

  // the piece's live positions [0, hi), this rank's tiles, this warp's n
  const int hi = max(0, min(lengths[b], L));
  const int tiles = (hi + PT - 1) / PT;
  const int per = (tiles + S - 1) / S;
  const int t_first = rank * per + warp;
  const int t_end = min(tiles, (rank + 1) * per);
  const int n = t_first < t_end ? (t_end - t_first + NW - 1) / NW : 0;

  const size_t row = (size_t)KH * D;            // elements from one position to the next
  const T* kb = k + ((size_t)b * L * KH + h) * D;
  const T* vb = v + ((size_t)b * L * KH + h) * D;

  // the warp's i-th tile into stage i % stages: one commit group
  auto issue = [&](int i) {
    const int p0 = (t_first + i * NW) * PT;
    T* ks = ring + (i % stages) * STAGE;
    T* vs = ks + PT * PK;
    if (vec) {
      constexpr int RC = DP / EPV;              // 16-byte pieces of a padded row
      for (int x = lane; x < PT * RC; x += 32) {
        const int r = x / RC, c = (x % RC) * EPV;
        const bool ok = p0 + r < hi && c < D;
        const size_t off = ok ? (size_t)(p0 + r) * row + c : 0;
        cp_async16(ks + r * PK + c, kb + off, ok);
        cp_async16(vs + r * PV + c, vb + off, ok);
      }
    } else {
      for (int x = lane; x < PT * DP; x += 32) {
        const int r = x / DP, c = x % DP;
        const bool ok = p0 + r < hi && c < D;
        const size_t off = ok ? (size_t)(p0 + r) * row + c : 0;
        copy_elem(ks + r * PK + c, kb + off, ok);
        copy_elem(vs + r * PV + c, vb + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < min(n, stages); ++i) issue(i);

  // ... then split (f32) or whole, stored while the copies are in flight
#pragma unroll
  for (int it = 0; it < NKS; ++it) {
    const int x = tid + it * (int)blockDim.x;
    if (x >= NKS * 32) break;
    uint4 f = make_uint4(__float_as_uint(qe[it][0]), __float_as_uint(qe[it][1]), 0u, 0u);
    if constexpr (SPLIT) {
      split(qe[it][0], f.x, f.z);
      split(qe[it][1], f.y, f.w);
    }
    qf[x] = f;
  }
  __syncthreads();

  // this lane's heads 2 tig and 2 tig + 1: running max and its part of the
  // sum; acc[mf] the C fragment of dims 16 mf + gid (+ 8) of both heads
  float mr[2] = {NEG_INF, NEG_INF}, lr[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int mf = 0; mf < DT; ++mf)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mf][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    switch (min(n, i + stages) - i - 1) {       // the tiles issued after this one
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      default: cp_async_wait<2>(); break;
    }
    __syncwarp();
    const T* ks = ring + (i % stages) * STAGE;
    const T* vs = ks + PT * PK;
    const int p0 = (t_first + i * NW) * PT;

    // S^T = K q^T: rows gid, gid + 8 of the tile, heads 2 tig, 2 tig + 1;
    // each k step into a zeroed fragment, added in f32 in k order
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const T* kr = ks + gid * PK + kk * 8 + tig;
      const float a[4] = {to_f(kr[0]), to_f(kr[8 * PK]), to_f(kr[4]), to_f(kr[8 * PK + 4])};
      const uint4 f = qf[kk * 32 + lane];
      const uint32_t bb[2] = {f.x, f.y};
      if constexpr (SPLIT) {
        uint32_t ab[4], as[4];
        split4(a, ab, as);
        const uint32_t bs[2] = {f.z, f.w};
        mma_tf32(c, as, bb);
        mma_tf32(c, ab, bs);
        mma_tf32(c, ab, bb);
      } else {
        const uint32_t ab[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]),
                                __float_as_uint(a[2]), __float_as_uint(a[3])};
        mma_tf32(c, ab, bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += c[e];
    }

    // online softmax: each head's tile max over the 8 row groups, then p
    const bool live[2] = {p0 + gid < hi, p0 + gid + 8 < hi};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = live[e >> 1] ? s[e] * scale : NEG_INF;
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mt = fmaxf(s[j], s[j + 2]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float mn = fmaxf(mr[j], mt);
      alpha[j] = expf(mr[j] - mn);
      mr[j] = mn;
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = live[e >> 1] ? expf(s[e] - mr[e & 1]) : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) lr[j] = lr[j] * alpha[j] + (p[j] + p[j + 2]);

    // P from the C layout (position rows) to the B layout (position k)
    reinterpret_cast<float2*>(pbuf)[gid * (PH / 2) + tig] = make_float2(p[0], p[1]);
    reinterpret_cast<float2*>(pbuf)[(gid + 8) * (PH / 2) + tig] = make_float2(p[2], p[3]);
    __syncwarp();
    uint32_t pb[2][2], ps[2][2];                // [k step][b0, b1]: big, small
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      split(pbuf[(kq * 8 + tig) * PH + gid], pb[kq][0], ps[kq][0]);
      split(pbuf[(kq * 8 + tig + 4) * PH + gid], pb[kq][1], ps[kq][1]);
    }

    // O^T += V^T P^T: dims as rows, heads as columns, the tile's 16
    // positions the reduction, each 8 of them into a zeroed fragment
#pragma unroll
    for (int mf = 0; mf < DT; ++mf) {
      float t[2][4] = {};
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const T* vr = vs + (kq * 8 + tig) * PV + mf * 16 + gid;
        const float a[4] = {to_f(vr[0]), to_f(vr[8]), to_f(vr[4 * PV]), to_f(vr[4 * PV + 8])};
        if constexpr (SPLIT) {
          uint32_t ab[4], as[4];
          split4(a, ab, as);
          mma_tf32(t[kq], as, pb[kq]);
          mma_tf32(t[kq], ab, ps[kq]);
          mma_tf32(t[kq], ab, pb[kq]);
        } else {
          const uint32_t ab[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]),
                                  __float_as_uint(a[2]), __float_as_uint(a[3])};
          mma_tf32(t[kq], ab, ps[kq]);
          mma_tf32(t[kq], ab, pb[kq]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mf][e] = acc[mf][e] * alpha[e & 1] + (t[0][e] + t[1][e]);
    }
    __syncwarp();                               // the stage and P read by every lane
    if (i + stages < n) issue(i + stages);
  }

  // the block's (m, l, acc): each warp's max and sum a head published,
  // then every warp scales its acc by exp(m_w - M) in registers and writes
  // it to its own ring, and the block's record adds them in warp order
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) lr[j] += __shfl_xor_sync(FULL, lr[j], o);
  float* wm = wts;                              // [warp][head]: the warps' max
  float* wl = wts + MAX_WARPS * PH;             // ... and sum
  if (gid == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm[warp * PH + 2 * tig + j] = mr[j];
      wl[warp * PH + 2 * tig + j] = lr[j];
    }
  }
  __syncthreads();
  float* wrec = reinterpret_cast<float*>(ring);   // acc[head][D], scaled
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = 2 * tig + j;
    float mm = NEG_INF;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w * PH + g]);
    const float wt = expf(mr[j] - mm);
    if (warp == 0 && gid == 0) {                // the block's m and l of head g
      float den = 0.f;
      for (int w = 0; w < NW; ++w) den += expf(wm[w * PH + g] - mm) * wl[w * PH + g];
      bpart[g] = mm;
      bpart[PH + g] = den;
    }
#pragma unroll
    for (int mf = 0; mf < DT; ++mf) {
      const int d = mf * 16 + gid;
      if (d < D) wrec[g * D + d] = wt * acc[mf][j];
      if (d + 8 < D) wrec[g * D + d + 8] = wt * acc[mf][j + 2];
    }
  }
  __syncthreads();
  for (int x = tid; x < PH * D; x += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += reinterpret_cast<const float*>(smem + w * ring_bytes)[x];
    bpart[2 * PH + x] = t;
  }
  cluster.sync();               // every block's record is in place

  // the cluster's: each rank's weight exp(m_r - M) a head once (rank 0
  // writes m and l), then the epilogue spread over the ranks, the blocks
  // added in rank order
  float* rw = wts + 2 * MAX_WARPS * PH;         // [head][rank]
  if (tid < PH) {
    float rm[MAX_SPLITS];
    float mm = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < S) {
        rm[r] = cluster.map_shared_rank(bpart, r)[tid];
        mm = fmaxf(mm, rm[r]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < S) {
        const float w = expf(rm[r] - mm);
        rw[tid * MAX_SPLITS + r] = w;
        den += w * cluster.map_shared_rank(bpart, r)[PH + tid];
      }
    }
    if (rank == 0 && g0 + tid < G) {
      m_out[(size_t)bh * G + g0 + tid] = mm;
      l_out[(size_t)bh * G + g0 + tid] = den;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int x = rank * blockDim.x + tid; x < PH * D; x += S * blockDim.x) {
    const int g = x / D;
    if (g0 + g >= G) continue;
    float num = 0.f;
    for (int r = 0; r < S; ++r)
      num += rw[g * MAX_SPLITS + r] * cluster.map_shared_rank(bpart, r)[2 * PH + x];
    o_out[((size_t)bh * G + g0) * D + x] = num;
  }
  cluster.sync();               // keep this block's record until all have read
}

// the kernel's dynamic shared memory, opted into once per instantiation and
// size
template <typename T, int DT>
cudaError_t opt_in(size_t bytes) {
  static size_t opted = 0;
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_partial<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) opted = bytes;
  return e;
}

// a launch of `blocks` blocks of `warps` warps in clusters of `splits`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int splits, int warps, size_t bytes, cudaStream_t st) {
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)(32 * warps));
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

template <typename T, int DT>
cudaError_t run_partial(const void* q, const void* k, const void* v, const void* lengths,
                        void* m, void* l, void* o, int units, int L, int KH, int G, int D,
                        int splits, int warps, int stages, int vec, float scale,
                        cudaStream_t st) {
  const size_t bytes = partial_smem<T>(16 * DT, warps, stages, D);
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = opt_in<T, DT>(bytes);
  if (e != cudaSuccess) return e;
  const ClusterLaunch go(units * splits, splits, warps, bytes, st);
  const cudaError_t e2 = cudaLaunchKernelEx(
      &go.cfg, decode_partial<T, DT>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(o), L, KH, G, D, stages, scale, vec);
  return e2 != cudaSuccess ? e2 : cudaGetLastError();
}

// the clusters of a plan resident on the card at once
template <typename T, int DT>
int resident_clusters(int D, int splits, int warps, int stages) {
  const size_t bytes = partial_smem<T>(16 * DT, warps, stages, D);
  if (bytes > SMEM_MAX || opt_in<T, DT>(bytes) != cudaSuccess) return -1;
  const ClusterLaunch go(splits, splits, warps, bytes, nullptr);
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, decode_partial<T, DT>, &go.cfg) == cudaSuccess
             ? n : -1;
}

template <typename T>
cudaError_t launch_partial(const void* q, const void* k, const void* v, const void* lengths,
                           void* m, void* l, void* o, int B, int KH, int G, int D, int L,
                           int splits, int warps, int stages, int vec, float scale,
                           cudaStream_t st) {
  constexpr int EPV = 16 / sizeof(T);
  if (B < 1 || KH < 1 || G < 1 || D < 1 || D > MAX_D || L < 1 || splits < 1 ||
      splits > MAX_SPLITS || warps < 1 || warps > MAX_WARPS || stages < 1 ||
      stages > MAX_STAGES)
    return cudaErrorInvalidValue;
  if (vec && (D % EPV || reinterpret_cast<uintptr_t>(k) % 16 ||
              reinterpret_cast<uintptr_t>(v) % 16))
    return cudaErrorInvalidValue;
  const long long units = (long long)B * KH * ((G + PH - 1) / PH);
  if (units * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n = (int)units;
#define PARTIAL_RUN(dt)                                                                    \
  return run_partial<T, dt>(q, k, v, lengths, m, l, o, n, L, KH, G, D, splits, warps,       \
                            stages, vec, scale, st)
  if (D <= 32) PARTIAL_RUN(2);
  if (D <= 64) PARTIAL_RUN(4);
  if (D <= 128) PARTIAL_RUN(8);
  PARTIAL_RUN(16);
#undef PARTIAL_RUN
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); the plan (splits,
// warps, stages, vec) is partial_plan's.  Returns cudaErrorInvalidValue for
// a plan or shape the kernel does not take, else cudaGetLastError() after
// the launch (0 = launched).
int flash_decode_partial_launch(const void* q, const void* k, const void* v,
                                const void* lengths, void* m, void* l, void* o, int B,
                                int KH, int G, int D, int L, int splits, int warps,
                                int stages, int vec, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_partial<float>(q, k, v, lengths, m, l, o, B, KH, G, D, L, splits,
                                      warps, stages, vec, scale, s);
  if (dtype == 1)
    return (int)launch_partial<__nv_bfloat16>(q, k, v, lengths, m, l, o, B, KH, G, D, L,
                                              splits, warps, stages, vec, scale, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the plan (splits, warps, stages) the card holds at
// once for a head dim of D (-1 if the query fails): the grid's clusters
// past that run in a second wave.
int flash_decode_partial_clusters(int D, int splits, int warps, int stages, int dtype) {
  if (D < 1 || D > MAX_D || dtype < 0 || dtype > 1) return -1;
  const int dt = D <= 32 ? 2 : D <= 64 ? 4 : D <= 128 ? 8 : 16;
  if (dtype == 0)
    return dt == 2 ? resident_clusters<float, 2>(D, splits, warps, stages)
         : dt == 4 ? resident_clusters<float, 4>(D, splits, warps, stages)
         : dt == 8 ? resident_clusters<float, 8>(D, splits, warps, stages)
                   : resident_clusters<float, 16>(D, splits, warps, stages);
  return dt == 2 ? resident_clusters<__nv_bfloat16, 2>(D, splits, warps, stages)
       : dt == 4 ? resident_clusters<__nv_bfloat16, 4>(D, splits, warps, stages)
       : dt == 8 ? resident_clusters<__nv_bfloat16, 8>(D, splits, warps, stages)
                 : resident_clusters<__nv_bfloat16, 16>(D, splits, warps, stages);
}

const char* decode_partial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
