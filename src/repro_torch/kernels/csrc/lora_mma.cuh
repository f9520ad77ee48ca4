// The TF32 tensor-core tile shared by the LoRA GEMMs at prefill and
// training M, for Hopper (sm_90a): the tile regime of lora_matmul and of
// its gather (csrc/lora_matmul.cu), lora_matmul_dx
// (csrc/lora_matmul_bwd.cu), and the int8-base pair lora_matmul_q8 and
// lora_matmul_q8_dx (csrc/lora_matmul_q8.cu).  Each is
//
//   out[m][p] = finish(sum_q L[m][q] c[q] R[q][p], p) + scale * sum_j Z[m][j] V[j][p],
//   Z[m][j]   = sum_q L[m][q] U[q][j]
//
// with L (M, Q) row-major (x for the forward, dY for dX), c = 1 but for
// the q8 dX, finish the identity but for the q8 forward, and an operand
// policy `Op` that says where R, U and V live:
//
//   product     Q  P  R[q][p]       stored              U[q][j]  V[j][p]  c[q]  finish
//   forward     K  N  W[q][p]       (K, N): p-major     A[j][q]  B[p][j]  1     v
//   dX          N  K  W[p][q]       (K, N): q-major     B[q][j]  A[j][p]  1     v
//   q8 forward  K  N  W_q[q][p]     int8 (K, N): p-major A[j][q] B[p][j]  1     s[p] v
//   q8 dX       N  K  W_q[p][q]     int8 (K, N): q-major B[q][j] A[j][p]  s[q]  v
//
// (the forward's U and V are the row's adapter's under the gather's Pool).
//
// Replaces, with csrc/lora_matmul.cu's decode regime and
// csrc/lora_matmul_bwd.cu: src/repro/kernels/lora_matmul/kernel.py::
// lora_matmul_kernel, ::lora_matmul_gather_kernel and
// ::lora_matmul_dx_kernel at M above the decode regime's threshold, and
// (csrc/lora_matmul_q8.cu) ::lora_matmul_q8_kernel and
// ::lora_matmul_q8_dx_kernel.  There the grid's innermost reduction axis
// ran in order and VMEM scratch carried the (bm, bn) and (bm, r)
// accumulators; here a K loop inside the block does.
//
// What bounds it on the H100: at M = 256-768, K = N = 768 (SFL) and at
// Mamba2's prefill (M up to 300, K 2560-5120) it is a real GEMM, ~2 M K N
// flops on ~(M K + K N + M N) * 4 bytes, above the f32 ridge.  Plain f32
// FFMA is capped at 67 TFLOP/s; the tensor cores run TF32 at 495.  TF32
// keeps 10 mantissa bits (~3 decimal digits), which misses the 1e-4 the
// f32 path is held to at K = 768, so each f32 operand v is split into
// big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big) and the tile
// accumulates small*big + big*small + big*big in f32 (3xTF32): three
// mma per product, a bound of 3 * 2 M K N / 495 TFLOP/s.  An operand
// that is exact in TF32 is never split: bf16 (8 significant bits) and
// int8 (-128..127, at most 8) are taken whole, so bf16 x bf16 takes one
// pass and f32 x int8 two, small*R + big*R (a bound of 2 * 2 M K N / 495).
//
// Design:
//  * 128 threads (2 x 2 warps) per (BM x BN) output tile, BM = BN = 64 or
//    32 (plan.py picks the larger where the grid still has a block per
//    SM); each warp holds (BM/2 x BN/2) f32 accumulators in m16n8k8
//    fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32;
//    the blocks that share a column tile of R are launched together;
//  * L and R tiles, 32 deep along q, stream through a ring of NS = 3
//    stages of padded shared memory with cp.async (16-byte copies, or
//    element copies where a row pitch is not a multiple of 16 bytes),
//    zero-filled past the M, Q and P edges; R keeps its own element type
//    there (an int8 W moves a quarter of an f32 W's bytes) and becomes
//    f32 at the fragment read, (float)q for int8, exact; the ring is over
//    48 KB at 64 x 64 in f32 and is opted into with cudaFuncSetAttribute;
//  * the row padding makes every fragment read conflict-free: L and a
//    q-major R at a pitch of 32 elements + 16 bytes (36 floats: 4 mod 32
//    banks; 48 int8 bytes: the 8 rows a read takes land on words 0, 12,
//    24, 4, 16, 28, 8, 20), a p-major R at BN + 8 elements (f32, bf16)
//    or BN + 16 bytes (int8: the 4 rows at BN 64 on words {0,1}, {20,21},
//    {8,9}, {28,29}), every row on a 16-byte boundary;
//  * the q8 dX's per-q scale c = s rides the ring beside L and R (32
//    floats a stage); L's fragment value is multiplied by it, rounded
//    once in f32, before the big/small split;
//  * the rank tile Z (BM x r) stays f32 FFMA on the raw L and rides the
//    same loop: two threads per row of the staged L chunk, each half of
//    it, with the U chunk staged beside L and R when one adapter serves
//    every row (read from global memory per row under the gather's Pool);
//    the epilogue adds scale * Z V and writes once;
//  * each 32-deep chunk's products go to a zeroed fragment and then into
//    the f32 accumulator with one rounded add: the tensor core truncates
//    what it adds, so three passes a step straight onto a growing
//    accumulator drift with its magnitude and miss f32's accuracy once K
//    runs into the thousands;
//  * the reduction is split over S = 1-8 blocks of a thread-block cluster
//    (S from K and N alone, plan.py), so that the grid fills the card at
//    training and prefill M; the splits' partial tiles are added through
//    distributed shared memory in rank order and the epilogue is spread
//    over the cluster's blocks;
//  * each element's terms are added in one order: within a split q in
//    32-deep chunks in sequence, in each 8-deep step small*big, big*small,
//    big*big (the passes that exist), then the splits in rank order, then
//    finish, whatever BM and BN are, and no atomics: a row's result
//    depends only on K, N and its own inputs, and two runs give equal
//    bits;
//  * any rank 1 <= r <= RMAX = 64.
// Why mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
// shared memory, and the forward's W is (K, N), N-major; mma.sync takes
// either layout from registers.  wgmma with TMA (and a transposed copy of
// W for the forward) is the next step.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "mma_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RMAX = 64;        // largest adapter rank taken

// ---------------------------------------------------------------------------
// the tile
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;     // 2 x 2 warps
constexpr int MMA_BK = 32;      // q depth of one ring stage
constexpr int MMA_NS = 3;       // ring stages
constexpr int RJ = 4;           // ranks of the rank tile summed per pass

// The defaults of an operand policy (see mma_tile): R of L's type, no
// scale on L, nothing applied after the reduction.  R's element type
// alone decides whether it is split (f32 only).
template <typename T>
struct MmaDefaults {
  using TR = T;
  static constexpr bool L_SCALE = false;
  __device__ __forceinline__ float finish(float v, int) const { return v; }
};

// One ring stage, in elements of L's type T: L, R (R_ELEMS T's worth of
// its own type), (L_SCALE) the 32 floats of c, then (when the adapter is
// shared by the tile's rows) the U chunk, stored rank-major (r x MMA_BK);
// every part starts on a 16-byte boundary.
template <typename T, typename TR, int BM, int BN, bool RQ, bool LS>
struct MmaLayout {
  static constexpr int E = 16 / sizeof(T);                    // L elements per 16 bytes
  static constexpr int RE = 16 / sizeof(TR);                  // R elements per 16 bytes
  static constexpr int LP = MMA_BK + E;                       // L pitch
  static constexpr int RP = RQ ? MMA_BK + RE : BN + (RE > 8 ? RE : 8);   // R pitch
  static constexpr int L_ELEMS = BM * LP;
  static constexpr int R_ELEMS = (RQ ? BN : MMA_BK) * RP * sizeof(TR) / sizeof(T);
  static constexpr int S_ELEMS = LS ? MMA_BK * sizeof(float) / sizeof(T) : 0;
  static constexpr int U_OFF = L_ELEMS + R_ELEMS + S_ELEMS;
};

template <typename T, typename TR, int BM, int BN, bool RQ, bool US, bool LS>
__host__ __device__ constexpr int mma_stage_elems(int r) {
  using Ly = MmaLayout<T, TR, BM, BN, RQ, LS>;
  return Ly::U_OFF + (US ? (MMA_BK * r + Ly::E - 1) / Ly::E * Ly::E : 0);
}

// Dynamic shared memory of the tile for rank r: the ring (the partial
// tile reuses it after the loop), then the split's rank tile and the sum.
template <typename T, int BM, int BN, bool RQ, bool US, typename TR = T, bool LS = false>
constexpr size_t mma_smem_bytes(int r) {
  return size_t(MMA_NS) * mma_stage_elems<T, TR, BM, BN, RQ, US, LS>(r) * sizeof(T) +
         2 * size_t(BM) * r * sizeof(float);
}

// Copy `n` items (16-byte chunks or elements) of one tile, MMA_NT threads
// taking items tid, tid + MMA_NT, ...: a loop of a fixed trip count.
template <int N, typename F>
__device__ __forceinline__ void for_items(int tid, F&& f) {
#pragma unroll
  for (int it = 0; it < (N + MMA_NT - 1) / MMA_NT; ++it) {
    const int i = tid + it * MMA_NT;
    if (N % MMA_NT == 0 || i < N) f(i);
  }
}

// Stage q-chunk q0 of L (rows m0..) and R (columns p0..) into ring slot `st`.
template <typename T, typename TR, int BM, int BN, bool VEC, bool RQ>
__device__ __forceinline__ void mma_stage(T* st, const T* __restrict__ lhs,
                                          const TR* __restrict__ w, int m0, int p0, int q0,
                                          int M, int Q, int P, int tid) {
  using Ly = MmaLayout<T, TR, BM, BN, RQ, false>;
  T* ls = st;
  TR* rs = reinterpret_cast<TR*>(st + Ly::L_ELEMS);
  constexpr int E = VEC ? Ly::E : 1, RE = VEC ? Ly::RE : 1;
  constexpr int QC = MMA_BK / E;          // L copies along q per row
  // 16 bytes or one element, zero-filled when !ok (lhs is then named and
  // not read)
  auto copy = [&](auto* dst, const auto* src, bool ok) {
    using E_ = typename std::remove_pointer<decltype(dst)>::type;
    const E_* from = ok ? src : reinterpret_cast<const E_*>(lhs);
    if constexpr (VEC) cp_async16(dst, from, ok);
    else copy_elem(dst, from, ok);
  };
  // L: BM rows of MMA_BK along q
  for_items<BM * QC>(tid, [&](int i) {
    const int m = i / QC, q = (i % QC) * E;
    const int gm = m0 + m, gq = q0 + q;
    copy(ls + m * Ly::LP + q, lhs + (size_t)gm * Q + gq, gm < M && gq < Q);
  });
  if constexpr (RQ) {
    // R[q][p] = w[p * Q + q]: BN rows (p) of MMA_BK along q
    constexpr int RC = MMA_BK / RE;
    for_items<BN * RC>(tid, [&](int i) {
      const int p = i / RC, q = (i % RC) * RE;
      const int gp = p0 + p, gq = q0 + q;
      copy(rs + p * Ly::RP + q, w + (size_t)gp * Q + gq, gp < P && gq < Q);
    });
  } else {
    // R[q][p] = w[q * P + p]: MMA_BK rows (q) of BN along p
    constexpr int PC = BN / RE;
    for_items<MMA_BK * PC>(tid, [&](int i) {
      const int q = i / PC, p = (i % PC) * RE;
      const int gp = p0 + p, gq = q0 + q;
      copy(rs + q * Ly::RP + p, w + (size_t)gq * P + gp, gp < P && gq < Q);
    });
  }
}

// The U chunk of a shared adapter into us[j][q] (rank-major, r x MMA_BK),
// zero past Q: from a rank-major U, us[j][q] = u[j * pitch + q0 + q] (the
// forward's A, (r, K)) ...
template <typename T>
__device__ __forceinline__ void stage_u_rank_major(T* us, const T* u, int pitch, int q0,
                                                   int Q, int r, int tid) {
  for (int i = tid; i < MMA_BK * r; i += MMA_NT) {
    const int j = i / MMA_BK, q = i % MMA_BK;
    const bool ok = q0 + q < Q;
    copy_elem(us + i, ok ? u + (size_t)j * pitch + q0 + q : u, ok);
  }
}

// ... or from rows of r, us[j][q] = u[(q0 + q) * r + j] (the dX's B, (N, r)).
template <typename T>
__device__ __forceinline__ void stage_u_rows(T* us, const T* u, int q0, int Q, int r,
                                             int tid) {
  for (int i = tid; i < MMA_BK * r; i += MMA_NT) {
    const int j = i / MMA_BK, q = i % MMA_BK;
    const bool ok = q0 + q < Q;
    copy_elem(us + i, ok ? u + (size_t)(q0 + q) * r + j : u, ok);
  }
}

// Stage c[q0 .. q0 + MMA_BK) (f32, zero past Q) into `dst`.
template <bool VEC>
__device__ __forceinline__ void stage_scale(float* dst, const float* __restrict__ c, int q0,
                                            int Q, int tid) {
  constexpr int E = VEC ? 4 : 1;
  for_items<MMA_BK / E>(tid, [&](int i) {
    const int q = q0 + i * E;
    const bool ok = q < Q;
    if constexpr (VEC) cp_async16(dst + i * E, ok ? c + q : c, ok);
    else cp_async4(dst + i, ok ? c + q : c, ok);
  });
}

// The body: one (BM x BN) tile of out, its q range split over the S
// blocks of a thread-block cluster; block (split, row tile, column tile) =
// blockIdx (x, y, z): the blocks that share a column tile of R run
// together, so R (a weight too large for L2 at Mamba2's widths) is read
// from device memory about once.  Op provides:
//   static constexpr bool RQ;              R stored q-major (dX) or p-major
//   static constexpr bool US;              U is shared by all rows: staged
//   using TR;                              R's element type (T, or int8_t)
//   static constexpr bool L_SCALE;         L enters as L[m][q] * c[q]
//   const TR* w;                           R's storage
//   const float* ls;                       L_SCALE: c, (Q,) f32
//   float finish(float v, int p);          the split-summed product of column p
//                                          (MmaDefaults<T>: T, false, v)
//   bool live(int m);                      block row m has an adapter to read
//   void stage_u(T* us, int q0, int Q, int r, int tid);   US: U chunk -> us[j][q]
//   float u(int m, int j, int q);          !US: U[q][j] of block row m
//   float v(int m, int j, int p);          V[j][p] of block row m
template <typename T, int BM, int BN, bool VEC, typename Op>
__device__ __forceinline__ void mma_tile(const T* __restrict__ lhs, const Op& op,
                                         T* __restrict__ out, int M, int Q, int P, int r,
                                         float scale, unsigned char* smem) {
  using TR = typename Op::TR;
  using Ly = MmaLayout<T, TR, BM, BN, Op::RQ, Op::L_SCALE>;
  static_assert(2 * BM <= MMA_NT, "the rank tile takes two threads per row");
  static_assert(MMA_NS * (Ly::L_ELEMS + Ly::R_ELEMS) * sizeof(T) >= BM * BN * sizeof(float),
                "the ring holds the partial tile after the loop");
  constexpr int MI = BM / 32, NI = BN / 16;      // m16 and n8 fragments per warp
  // an f32 operand is split into big + small; bf16 and int8 are exact in
  // TF32 and taken whole; L * c is f32 whatever L's type
  constexpr bool L_SPLIT = sizeof(T) == 4 || Op::L_SCALE;
  constexpr bool R_SPLIT = sizeof(TR) == 4;
  const int stage = mma_stage_elems<T, TR, BM, BN, Op::RQ, Op::US, Op::L_SCALE>(r);
  T* ring = reinterpret_cast<T*>(smem);
  float* zs = reinterpret_cast<float*>(smem + size_t(MMA_NS) * stage * sizeof(T));
  float* zf = zs + BM * r;                       // [BM][r] each, f32

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * (BM / 2), wn = (warp % 2) * (BN / 2);
  const int m0 = blockIdx.y * BM, p0 = blockIdx.z * BN;
  // this split's chunks of MMA_BK along q
  const int KT = (Q + MMA_BK - 1) / MMA_BK;
  const int per = (KT + S - 1) / S;
  const int kt0 = min(KT, split * per), kt1 = min(KT, kt0 + per);

  for (int i = tid; i < BM * r; i += MMA_NT) zs[i] = 0.f;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto issue = [&](int kt) {     // stage chunk kt into its ring slot
    T* st = ring + ((kt - kt0) % MMA_NS) * stage;
    mma_stage<T, TR, BM, BN, VEC, Op::RQ>(st, lhs, op.w, m0, p0, kt * MMA_BK, M, Q, P, tid);
    if constexpr (Op::L_SCALE)
      stage_scale<VEC>(reinterpret_cast<float*>(st + Ly::L_ELEMS + Ly::R_ELEMS), op.ls,
                       kt * MMA_BK, Q, tid);
    if constexpr (Op::US) op.stage_u(st + Ly::U_OFF, kt * MMA_BK, Q, r, tid);
  };
#pragma unroll
  for (int s = 0; s < MMA_NS - 1; ++s) {
    if (kt0 + s < kt1) issue(kt0 + s);
    cp_async_commit();
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<MMA_NS - 2>();
    __syncthreads();            // chunk kt landed; the slot of kt - 1 is free again
    if (kt + MMA_NS - 1 < kt1) issue(kt + MMA_NS - 1);
    cp_async_commit();
    const T* ls = ring + ((kt - kt0) % MMA_NS) * stage;
    const TR* rs = reinterpret_cast<const TR*>(ls + Ly::L_ELEMS);

    // the chunk's products go to a zeroed fragment first, then into acc
    // with one rounded add: the tensor core truncates what it adds
    float t[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 8) {
      uint32_t ab[MI][4], as[MI][4], bb[NI][2], bs[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const T* l0 = ls + (wm + i * 16 + gid) * Ly::LP + kk + tig;
        float v[4] = {to_f(l0[0]), to_f(l0[8 * Ly::LP]), to_f(l0[4]),
                      to_f(l0[8 * Ly::LP + 4])};
        if constexpr (Op::L_SCALE) {   // L[m][q] c[q], rounded once in f32
          const float* cs = reinterpret_cast<const float*>(ls + Ly::L_ELEMS + Ly::R_ELEMS);
          const float c0 = cs[kk + tig], c1 = cs[kk + tig + 4];
          v[0] *= c0, v[1] *= c0, v[2] *= c1, v[3] *= c1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (L_SPLIT) {
            ab[i][e] = tf32_rna(v[e]);
            as[i][e] = tf32_rna(v[e] - __uint_as_float(ab[i][e]));
          } else {
            ab[i][e] = __float_as_uint(v[e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + j * 8 + gid;
        float v[2];
        if constexpr (Op::RQ) {
          v[0] = to_f(rs[c * Ly::RP + kk + tig]);
          v[1] = to_f(rs[c * Ly::RP + kk + tig + 4]);
        } else {
          v[0] = to_f(rs[(kk + tig) * Ly::RP + c]);
          v[1] = to_f(rs[(kk + tig + 4) * Ly::RP + c]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (R_SPLIT) {
            bb[j][e] = tf32_rna(v[e]);
            bs[j][e] = tf32_rna(v[e] - __uint_as_float(bb[j][e]));
          } else {
            bb[j][e] = __float_as_uint(v[e]);
          }
        }
      }
      if constexpr (L_SPLIT) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_tf32(t[i][j], as[i], bb[j]);
      }
      if constexpr (R_SPLIT) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_tf32(t[i][j], ab[i], bs[j]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_tf32(t[i][j], ab[i], bb[j]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];

    // rank tile: thread pair (2m, 2m + 1) takes row m, each its half of the
    // chunk in order; the halves are added (first + second) and the
    // chunk's sum joins Z.  The staged U is read as a broadcast.
    {
      const int m = tid / 2, h = tid % 2;
      const bool on = m < BM && op.live(m);
      const int q0 = kt * MMA_BK;
      const int qa = h * (MMA_BK / 2);
      const int qb = min(qa + MMA_BK / 2, Q - q0);
      const T* lrow = ls + m * Ly::LP;     // the raw L: Z has no c in it
      const T* us = ls + Ly::U_OFF;
      for (int j0 = 0; j0 < r; j0 += RJ) {
        float sj[RJ];
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) sj[jj] = 0.f;
        if (on) {
          int q = qa;
          if constexpr (Op::US && sizeof(T) == 4) {     // the same order, float4 reads
            if (qb - qa == MMA_BK / 2) {
#pragma unroll
              for (int c = 0; c < MMA_BK / 2; c += 4) {
                const float4 l = *reinterpret_cast<const float4*>(lrow + qa + c);
#pragma unroll
                for (int jj = 0; jj < RJ; ++jj) {
                  if (j0 + jj < r) {
                    const float4 u = *reinterpret_cast<const float4*>(
                        us + (j0 + jj) * MMA_BK + qa + c);
                    sj[jj] += l.x * u.x;
                    sj[jj] += l.y * u.y;
                    sj[jj] += l.z * u.z;
                    sj[jj] += l.w * u.w;
                  }
                }
              }
              q = qb;
            }
          }
          for (; q < qb; ++q) {
            const float l = to_f(lrow[q]);
#pragma unroll
            for (int jj = 0; jj < RJ; ++jj) {
              if (j0 + jj < r) {
                float u;
                if constexpr (Op::US) u = to_f(us[(j0 + jj) * MMA_BK + q]);
                else u = op.u(m, j0 + jj, q0 + q);
                sj[jj] += l * u;
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          const float other = __shfl_xor_sync(0xffffffffu, sj[jj], 1);
          if (on && h == 0 && j0 + jj < r) zs[m * r + j0 + jj] += sj[jj] + other;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the ring is free: it holds the partial tile now

  float* part = reinterpret_cast<float*>(smem);  // [BM][BN]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(wm + i * 16 + gid + (e >= 2 ? 8 : 0)) * BN + wn + j * 8 + 2 * tig + (e & 1)] =
            acc[i][j][e];
  cluster.sync();               // every split's partials are in place

  // the rank tile, summed over the splits in rank order
  for (int i = tid; i < BM * r; i += MMA_NT) {
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(zs, q)[i];
    zf[i] = v;
  }
  __syncthreads();

  // epilogue: this block's share of the tile, splits added in rank order
  for (int i = split * MMA_NT + tid; i < BM * BN; i += S * MMA_NT) {
    const int m = i / BN, p = i % BN;
    const int gm = m0 + m, gp = p0 + p;
    if (gm >= M || gp >= P) continue;
    T* dst = out + (size_t)gm * P + gp;
    if (!op.live(m)) {          // an index outside the pool
      store(dst, nan_f());
      continue;
    }
    float v = cluster.map_shared_rank(part, 0)[i];
    for (int q = 1; q < S; ++q) v += cluster.map_shared_rank(part, q)[i];
    float d = 0.f;
    for (int q = 0; q < r; ++q) d += zf[m * r + q] * op.v(m, q, gp);
    store(dst, op.finish(v, gp) + scale * d);
  }
  cluster.sync();               // keep this block's partials until all have read
}

// Launch `Kern` on `grid` (splits, then two tile axes) of NT threads
// in clusters of S blocks along x, with `bytes` of dynamic shared memory
// (opted into once per kernel and size).
template <auto Kern, int NT, typename... Args>
cudaError_t cluster_launch(dim3 grid, int S, size_t bytes, cudaStream_t st, Args... args) {
  static size_t opted = 0;
  if (bytes > opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    opted = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
