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
// before the window); a warp also skips a tile none of its rows can see.
//
// What bounds it on the H100: 4 * B * H * Sq * Sk_visible * D flops on
// (B * (Sq * H + 2 * Sk * KH) * D) elements read once.  At the GPT-2-S
// shapes (D = 64, S = 64 to 1024) that is 16 to 256 flops per byte in
// f32: operation bound once S passes ~128.  f32 FFMA is capped at 67
// TFLOP/s; the tensor cores run TF32 at 495, and 3xTF32 (below) keeps
// f32's accuracy at three TF32 products per f32 product: a bound of
// 3 * 4 * B * H * visible * D / 495 TFLOP/s (9.8 us at B 1, S 1024).
//
// Design:
//  * one block per (64-row query tile, head h, batch b) of one or two
//    groups of 4 warps; in a group each warp owns 16 query rows (the FA2
//    layout), so the online softmax's row max and row sum live in
//    registers: a thread holds rows gid and gid + 8 of its warp, the max is
//    reduced across the 4 threads of a fragment quad once per KV tile, the
//    sum only at the end (each thread keeps its part, rescaled by the same
//    alpha); no shared slab of scores, no block barrier between the two
//    products.  One warp per SM sub-partition runs a tile's ~2500
//    instructions in ~5 us on an H100 (D 64), bound by the latency of its
//    dependent chains,
//    so where a query tile walks 4 or more KV tiles and the grid has fewer
//    blocks than two per SM, a second group takes the odd tiles (8 warps,
//    one block per SM) and its (m, l, O) joins the first group's through
//    shared memory at the end (m the larger, both rescaled to it); shorter
//    walks and fuller grids keep one group (4 warps, two blocks per SM),
//    which runs them faster;
//  * both products on mma.sync.m16n8k8 TF32 (csrc/mma_ptx.cuh).  An f32
//    operand v is split into big = rna(v) and small = rna(v - big) and the
//    product takes small*big + big*small + big*big (3xTF32, as the LoRA
//    tile of csrc/lora_mma.cuh); bf16 Q, K and V are exact in TF32 and are
//    taken whole, so bf16 scores take one pass and P (f32) times V two;
//  * Q is read once per block, scaled by D^-0.5 * log2(e) (the softmax then
//    runs in base 2 with exp2f, no per-score scaling), split, and kept in
//    shared memory as TF32 bit patterns (big and small), read as A
//    fragments per KV tile: in registers the split Q alone would take
//    D registers a thread, 128 at D = 128.  A bf16 Q is kept whole and the
//    scale goes on each score instead: folded in, it would no longer be
//    exact in TF32 and would cost a second pass;
//  * P reaches the P V product without shuffles or shared memory: the
//    k index of the m16n8k8 A fragment is mapped to keys so that k = tig
//    is key 2 tig and k = tig + 4 is key 2 tig + 1 of the 8-key group,
//    which is exactly the score C fragment a thread already holds; V's
//    B fragment reads rows 2 tig and 2 tig + 1 in the same order;
//  * each KV tile's P V goes into a zeroed fragment and joins the running
//    output in one f32 step, acc = acc * alpha + tile: the tensor core
//    truncates what it adds, and TF32 passes summed straight onto a
//    growing accumulator drift once the reduction runs long;
//  * K and V tiles of 64 keys stream through a cp.async ring of 2 G stages
//    (the G tiles in use and the next G; G stages where 2 G do not fit:
//    f32 with two groups above D 80), 16-byte copies where D * sizeof(T)
//    and the base pointers allow, element copies otherwise, zero-filled
//    past Sk; Q's loads are all issued before any is used; D is padded to
//    DK = 16 * ceil(D / 16) with zeros.  Row pitches of DK plus 16 bytes
//    make every fragment read conflict-free (f32: DK + 4 words; bf16:
//    DK + 8 halves, two lanes on one word);
//  * grid (H * B, query tiles), the query tile index reversed: for every
//    head the heaviest causal tiles are scheduled first;
//  * no atomics, and a row's arithmetic depends only on its own inputs
//    and the tile walk: two runs give equal bits.
// Not yet: wgmma / TMA.

#include "mma_ptx.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per ring stage
constexpr int GW = 4;           // warps per group: 4 x 16 query rows
constexpr int DMAX = 128;       // largest head dim taken
constexpr int LONG_WALK = 4;    // KV tiles from which two warp groups share a walk
constexpr size_t SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// G warp groups of 4 warps: group g takes KV tiles g, g + G, ...
template <typename T, int DK, int G>
struct AttnLayout {
  static constexpr int NT = 32 * GW * G;            // threads per block
  static constexpr int E = 16 / sizeof(T);          // elements per 16 bytes
  static constexpr int KP = DK + E;                 // K and V row pitch
  static constexpr int QP = DK + 4;                 // Q row pitch (32-bit words)
  static constexpr bool SPLIT = sizeof(T) == 4;     // f32: 3xTF32; bf16 whole
  static constexpr int STAGE = 2 * BK * KP;         // K then V, in T
  static constexpr size_t STAGE_BYTES = size_t(STAGE) * sizeof(T);
  static constexpr size_t Q_BYTES = size_t(SPLIT ? 2 : 1) * BQ * QP * sizeof(uint32_t);
  // the G tiles in use and the next G in flight, or (where 2 G stages do
  // not fit) only the G in use
  static constexpr int NS = 2 * G * STAGE_BYTES + Q_BYTES <= SMEM_MAX ? 2 * G : G;
  static constexpr size_t BYTES = NS * STAGE_BYTES + Q_BYTES;
  static_assert(BYTES <= SMEM_MAX, "the ring and Q fit a block");
};

// n elements of T from global memory as f32: one 16-byte load
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
  static_assert(N == 4, "4 floats a load");
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[N]) {
  static_assert(N == 8, "8 bf16 a load");
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  bf16x2_to_f(t.x, o[0], o[1]);
  bf16x2_to_f(t.y, o[2], o[3]);
  bf16x2_to_f(t.z, o[4], o[5]);
  bf16x2_to_f(t.w, o[6], o[7]);
}

template <typename T, int DK, int G>
__global__ void __launch_bounds__(AttnLayout<T, DK, G>::NT) flash_attention_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KH, int D, int q_offset,
    int window, float qscale, bool vec) {
  using Ly = AttnLayout<T, DK, G>;
  constexpr int NT = Ly::NT, NS = Ly::NS, E = Ly::E, KP = Ly::KP, QP = Ly::QP;
  constexpr int NKS = DK / 8;           // k steps of Q K^T, n tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint32_t* qbig = reinterpret_cast<uint32_t*>(smem + NS * Ly::STAGE_BYTES);
  uint32_t* qsml = qbig + BQ * QP;      // f32 only

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int group = warp / GW, gw = warp % GW;  // the warp's group, its 16 rows
  const int gid = lane / 4, tig = lane % 4;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // heaviest tiles first
  const int kh = h / (H / KH);

  const size_t q_row = (size_t)H * D;           // stride between positions
  const size_t kv_row = (size_t)KH * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * D;

  // tiles this query tile can reach: keys up to its last row's position,
  // and (windowed) from its first row's window start
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = min(Sk, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // the padding columns [D, DK) of the ring stages are never copied to:
  // zero them once
  if (D < DK) {
    for (int i = tid; i < NS * 2 * BK * DK; i += NT) {
      const int row = i / DK, c = i % DK;
      if (c >= D) ring[row * KP + c] = T(0.f);
    }
  }

  auto issue = [&](int t) {     // stage KV tile t into its ring slot
    if (t >= n_tiles) return;
    const int k0 = k_begin + t * BK;
    T* ks = ring + (t % NS) * Ly::STAGE;
    T* vs = ks + BK * KP;
    if (vec) {
      constexpr int RC = DK / E;                // 16-byte copies per padded row
      for (int i = tid; i < BK * RC; i += NT) {
        const int r = i / RC, c = (i % RC) * E;
        if (c >= D) continue;
        const bool ok = k0 + r < Sk;
        const size_t off = ok ? (size_t)(k0 + r) * kv_row + c : 0;
        cp_async16(ks + r * KP + c, kb + off, ok);
        cp_async16(vs + r * KP + c, vb + off, ok);
      }
    } else {
      for (int i = tid; i < BK * DK; i += NT) {
        const int r = i / DK, c = i % DK;
        if (c >= D) continue;
        const bool ok = k0 + r < Sk;
        const size_t off = ok ? (size_t)(k0 + r) * kv_row + c : 0;
        copy_elem(ks + r * KP + c, kb + off, ok);
        copy_elem(vs + r * KP + c, vb + off, ok);
      }
    }
  };

#pragma unroll
  for (int g = 0; g < G; ++g) issue(g);
  cp_async_commit();

  // Q, once per block, while the first tiles are in flight: every load
  // first, then scaled (f32), split and stored as TF32 bit patterns, zero
  // past Sq and past D
  {
    constexpr int QC = E, QR = DK / QC, QN = BQ * QR, QI = (QN + NT - 1) / NT;
    float x[QI][QC];
#pragma unroll
    for (int it = 0; it < QI; ++it) {
      const int i = tid + it * NT;
      if (QN % NT != 0 && i >= QN) continue;
      const int r = i / QR, c = (i % QR) * QC;
      const bool row_ok = q0 + r < Sq;
      const T* src = qb + (size_t)(row_ok ? q0 + r : 0) * q_row + c;
      if (vec && row_ok && c < D) {
        load_vec(src, x[it]);
      } else {
#pragma unroll
        for (int e = 0; e < QC; ++e) x[it][e] = row_ok && c + e < D ? to_f(src[e]) : 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < QI; ++it) {
      const int i = tid + it * NT;
      if (QN % NT != 0 && i >= QN) continue;
      const int r = i / QR, c = (i % QR) * QC;
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        if constexpr (Ly::SPLIT) {
          const float sv = x[it][e] * qscale;
          const uint32_t big = tf32_rna(sv);
          qbig[r * QP + c + e] = big;
          qsml[r * QP + c + e] = tf32_rna(sv - __uint_as_float(big));
        } else {
          qbig[r * QP + c + e] = __float_as_uint(x[it][e]);
        }
      }
    }
  }

  // this thread's rows: gid and gid + 8 of the warp's 16
  const int wrow = gw * 16;
  const int w_first = q_offset + q0 + wrow;     // positions of the warp's rows
  const int w_last = w_first + 15;
  const int pos[2] = {w_first + gid, w_first + gid + 8};
  float o[NKS][4];
#pragma unroll
  for (int i = 0; i < NKS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  // one KV tile of this warp's group
  auto tile = [&](int t) {
    const int k0 = k_begin + t * BK;
    // a tile none of the warp's rows can see changes nothing: skip it
    if (k0 > w_last || (window > 0 && k0 + BK - 1 <= w_first - window)) return;
    const T* ks = ring + (t % NS) * Ly::STAGE;
    const T* vs = ks + BK * KP;

    // scores S = Q' K^T (base-2 logits), 16 rows x 64 keys: s[j] is the
    // C fragment of keys 8 j .. 8 j + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < NKS; ++kk) {
      const int qa = (wrow + gid) * QP + kk * 8 + tig;
      const uint32_t ab[4] = {qbig[qa], qbig[qa + 8 * QP], qbig[qa + 4], qbig[qa + 8 * QP + 4]};
      uint32_t as[4];
      if constexpr (Ly::SPLIT) {
        as[0] = qsml[qa], as[1] = qsml[qa + 8 * QP], as[2] = qsml[qa + 4];
        as[3] = qsml[qa + 8 * QP + 4];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* kr = ks + (j * 8 + gid) * KP + kk * 8 + tig;
        const float kv[2] = {to_f(kr[0]), to_f(kr[4])};
        if constexpr (Ly::SPLIT) {
          uint32_t bb[2], bs[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bb[e] = tf32_rna(kv[e]);
            bs[e] = tf32_rna(kv[e] - __uint_as_float(bb[e]));
          }
          mma_tf32(s[j], as, bb);
          mma_tf32(s[j], ab, bs);
          mma_tf32(s[j], ab, bb);
        } else {
          const uint32_t bb[2] = {__float_as_uint(kv[0]), __float_as_uint(kv[1])};
          mma_tf32(s[j], ab, bb);
        }
      }
    }
    if constexpr (!Ly::SPLIT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= qscale;
    }

    // mask where the tile crosses the diagonal, Sk or a window edge
    if (k0 + BK - 1 > w_first || k0 + BK > Sk || (window > 0 && k0 <= w_last - window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tig + (e & 1);
          const int p = pos[e >> 1];
          bool ok = key <= p && key < Sk;
          if (window > 0) ok = ok && p - key < window;
          if (!ok) s[j][e] = NEG_INF;
        }
    }

    // online softmax: the tile's row max over the quad, then p = 2^(s - m)
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[rr], mt);
      // a row that has seen no key yet keeps p = 0 (2^(-1e30 - 0))
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      alpha[rr] = exp2f(m_run[rr] - m_use);
      m_run[rr] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * rr] = exp2f(s[j][2 * rr] - m_use);
        s[j][2 * rr + 1] = exp2f(s[j][2 * rr + 1] - m_use);
        ls += s[j][2 * rr] + s[j][2 * rr + 1];
      }
      l_run[rr] = l_run[rr] * alpha[rr] + ls;
    }

    // O = O * alpha + P V.  Per 8-key group j (the k step), P's A
    // fragment: k = tig is key 2 tig, k = tig + 4 key 2 tig + 1, i.e.
    // a = {c0, c2, c1, c3} of s[j], split; its products go to the tile's
    // zeroed fragments tf[i], one per n tile of 8 output columns, so the
    // NKS accumulation chains run side by side
    float tf[NKS][4];
#pragma unroll
    for (int i = 0; i < NKS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pv[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t pb[4], ps[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pb[e] = tf32_rna(pv[e]);
        ps[e] = tf32_rna(pv[e] - __uint_as_float(pb[e]));
      }
      const T* vr = vs + (j * 8 + 2 * tig) * KP + gid;
#pragma unroll
      for (int i = 0; i < NKS; ++i) {
        const float vv[2] = {to_f(vr[i * 8]), to_f(vr[KP + i * 8])};
        uint32_t bb[2];
        if constexpr (Ly::SPLIT) {
          uint32_t bs[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bb[e] = tf32_rna(vv[e]);
            bs[e] = tf32_rna(vv[e] - __uint_as_float(bb[e]));
          }
          mma_tf32(tf[i], ps, bb);
          mma_tf32(tf[i], pb, bs);
          mma_tf32(tf[i], pb, bb);
        } else {
          bb[0] = __float_as_uint(vv[0]), bb[1] = __float_as_uint(vv[1]);
          mma_tf32(tf[i], ps, bb);
          mma_tf32(tf[i], pb, bb);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NKS; ++i) {
      o[i][0] = o[i][0] * alpha[0] + tf[i][0];
      o[i][1] = o[i][1] * alpha[0] + tf[i][1];
      o[i][2] = o[i][2] * alpha[1] + tf[i][2];
      o[i][3] = o[i][3] * alpha[1] + tf[i][3];
    }
  };

  for (int t0 = 0; t0 < n_tiles; t0 += G) {
    cp_async_wait<0>();
    __syncthreads();            // tiles t0 .. t0 + G - 1 landed (and Q); the
                                // slots of the G tiles before them are free
    if constexpr (NS == 2 * G) {
#pragma unroll
      for (int g = 0; g < G; ++g) issue(t0 + G + g);
    }
    cp_async_commit();
    if (t0 + group < n_tiles) tile(t0 + group);
    if constexpr (NS == G) {    // no room ahead: the next tiles wait for these
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) issue(t0 + G + g);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  if constexpr (G == 2) {
    // group 1's state joins group 0's: m = max, both rescaled to it
    constexpr int XW = 4 + 4 * NKS;             // floats a thread hands over
    static_assert(XW * 32 * GW * sizeof(float) <= NS * Ly::STAGE_BYTES,
                  "the exchange fits the ring");
    __syncthreads();            // every tile consumed: the ring is free
    float* xch = reinterpret_cast<float*>(smem);
    const int slot = gw * 32 + lane;
    if (group == 1) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        xch[rr * 128 + slot] = m_run[rr];
        xch[(2 + rr) * 128 + slot] = l_run[rr];
      }
#pragma unroll
      for (int i = 0; i < NKS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 + 4 * i + e) * 128 + slot] = o[i][e];
    }
    __syncthreads();
    if (group == 1) return;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m1 = xch[rr * 128 + slot];
      const float m_new = fmaxf(m_run[rr], m1);
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      const float a0 = exp2f(m_run[rr] - m_use), a1 = exp2f(m1 - m_use);
      l_run[rr] = l_run[rr] * a0 + xch[(2 + rr) * 128 + slot] * a1;
#pragma unroll
      for (int i = 0; i < NKS; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          o[i][2 * rr + c] = o[i][2 * rr + c] * a0 + xch[(4 + 4 * i + 2 * rr + c) * 128 + slot] * a1;
    }
  }

  // the row sums over the quad, then out = O / l
  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + wrow + gid + 8 * rr;
    if (row >= Sq) continue;
#pragma unroll
    for (int i = 0; i < NKS; ++i) {
      const int d = i * 8 + 2 * tig;
      if (d < D) store(ob + (size_t)row * q_row + d, o[i][2 * rr] * inv);
      if (d + 1 < D) store(ob + (size_t)row * q_row + d + 1, o[i][2 * rr + 1] * inv);
    }
  }
}

template <typename T, int DK, int G>
cudaError_t run(const T* q, const T* k, const T* v, T* out, int B, int Sq, int Sk, int H,
                int KH, int D, int q_offset, int window, float qscale, bool vec,
                cudaStream_t s) {
  using Ly = AttnLayout<T, DK, G>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_fwd<T, DK, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Ly::BYTES);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const dim3 grid(H * B, (Sq + BQ - 1) / BQ);
  flash_attention_fwd<T, DK, G><<<grid, Ly::NT, Ly::BYTES, s>>>(
      q, k, v, out, Sq, Sk, H, KH, D, q_offset, window, qscale, vec);
  return cudaGetLastError();
}

// The most KV tiles one query tile walks (the kernel's tile range).
int longest_walk(int Sq, int Sk, int q_offset, int window) {
  int most = 0;
  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    const int k_end = min(Sk, q_offset + min(q0 + BQ, Sq));
    const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) / BK * BK : 0;
    if (k_end > k_begin) most = max(most, (k_end - k_begin + BK - 1) / BK);
  }
  return most;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KH, int D, int q_offset, int window, float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  // 16-byte copies: every row starts on a 16-byte boundary
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const float qscale = scale * LOG2E;            // base-2 logits
  // a long walk is shared by two warp groups (8 warps, one block per SM)
  // while the grid leaves SMs without a second block of 4 warps; short
  // walks and full grids keep 4 warps, two blocks per SM
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long blocks = (long)H * B * ((Sq + BQ - 1) / BQ);
  const bool two = blocks < 2L * sms && longest_walk(Sq, Sk, q_offset, window) >= LONG_WALK;
  switch ((D + 15) / 16) {
#define FA_CASE(n)                                                                   \
  case n:                                                                            \
    return (int)(two ? run<T, 16 * n, 2>(qp, kp, vp, op, B, Sq, Sk, H, KH, D,        \
                                         q_offset, window, qscale, vec, s)           \
                     : run<T, 16 * n, 1>(qp, kp, vp, op, B, Sq, Sk, H, KH, D,        \
                                         q_offset, window, qscale, vec, s));
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); scale is
// the softmax scale (D^-0.5).  Returns the launch's cudaError_t (0 =
// launched).
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
