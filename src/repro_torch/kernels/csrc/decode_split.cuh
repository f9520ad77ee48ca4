// The one-token decode body for Hopper (sm_90a) of flash_decode and
// flash_decode_q8 (csrc/flash_decode.cu) and of paged_decode and
// paged_decode_q8 (csrc/paged_decode.cu).  Each computes, for slot b and KV
// head h,
//
//   out[b, h, g, :] = softmax_j(q[b, h, g, :] . K_j * D^-0.5) V_j
//
// over the slot's live positions j in [lo, hi), f32 inside, where
//   hi = min(length_b, capacity)   (a finished slab slot decodes on with
//                                   length L + 1: never read past the cache)
//   lo = max(length_b - window, 0) with a window, else 0.
// The kernel is written once; two policies say where the rows lie and
// what they hold:
//
//   Addr   SlabAddr    cache (B, L, KH, D), the model's layout read in
//                      place: row of position j is KH * D elements after
//                      row j - 1
//          PagedAddr   pool (KH, NP, PS, D) through the slot's block-table
//                      row: position j lives in page row[j / PS], offset
//                      j % PS
//   KV     FloatKV<T>  f32 or bf16 entries in q's dtype: 4 or 8 a 16-byte
//                      piece
//          Int8KV      int8 entries with f32 (KH,) per-KV-head scales, q
//                      f32 or bf16: 16 a piece, each unpacked as int8 ->
//                      f32 * scale (the plain version's dequantization,
//                      without the quarter-rate I2F) before its dot; the
//                      head's two scales are loaded with the slot's length
//
// What bounds it on the H100: each slot's live K and V are read once,
// 2 * KH * (hi - lo) * D * bytes per slot, for ~4 * G * D flops per entry
// per KV head: memory bound (2 us at the serving shape, 8 slots x 12 KV
// heads of 64 x lengths 8-255, f32; 0.5 us in int8), and at serving batch
// sizes latency bound: the whole call is a few DRAM round trips and one
// launch.
//
// Design:
//  * split-K over a thread-block cluster: one cluster of S blocks (S in
//    {1, 2, 4, 8}, from kernels/flash_attention/plan.py: the capacity, the
//    number of (slot, KV head, head group) units and the SM count) per
//    unit; the grid is S * units blocks along x, cluster dims (S, 1, 1).
//    Each block reads the slot's length itself and takes an equal
//    contiguous share of the live 32-position tiles, so the work balances
//    within a slot whatever the lengths are and the host syncs nothing;
//  * rows read 16 bytes a lane: a K or V row is read by `lanes` lanes (the
//    row's 16-byte pieces rounded up to a power of two, at most 32; f32
//    rows of more than 512 bytes take two pieces a lane), so a warp reads
//    32 / lanes rows per instruction; each lane issues the loads of U rows
//    of K and of V (U = 8, 4 or 2 by its register budget, at most the
//    policy's MAX_ROWS) before it uses the first.  Int8 rows take 4 lanes
//    at D 64, so a block has 32 streams of rows; at U 2 a batch is 64 rows,
//    as the f32 pair's is, and a short slot does not unpack and multiply
//    the dead rows of a 256-row batch.  Where D * bytes is not a multiple
//    of 16 or a base is not 16-byte aligned (plan.vec false) a piece is
//    read entry by entry, zero past D.  Paged rows resolve their page through the slot's table
//    row, and the next batch's table entries are requested before this
//    batch is used; entries past the live prefix (page 0) are never read;
//  * warp-level online softmax, no block barrier in the position loop: q
//    is pre-scaled by D^-0.5 and kept in registers for the block's GT
//    query heads, so each row read serves all GT dots; a dot reduces with
//    xor-shuffles across the row's lanes (every lane gets the same sum);
//    each group of `lanes` lanes is a stream of rows with its own (m, l,
//    acc) in registers.  At the end the streams of a warp merge by
//    xor-shuffles, the warps in shared memory in warp order;
//  * the S blocks' (m, l, acc) meet through distributed shared memory after
//    cluster.sync(), in rank order, and the epilogue is spread over the
//    ranks:  out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30).
//    No atomics and no workspace: two runs are bit-equal.  A slot with no
//    live entry gives exact zeros (acc 0, l 0), the dead-slot contract of
//    the Pallas kernels; a block with no live tile joins the barrier with
//    m = -1e30, l = 0, acc = 0;
//  * G query heads go in groups of GT (a power of two, at most the
//    policy's MAX_GT); a G that GT does not divide leaves the last group's
//    extra heads at q = 0, computed and not written.  q and acc take
//    2 * GT * NC * EPV registers a lane: FloatKV allows GT 8 (at most 64
//    floats each), Int8KV GT 1 (16 each), since its 16-entry pieces also
//    unpack to 16 floats of K and of V (at GT 2 ptxas spilled).  D up to
//    256 (DECODE_MAX_HEAD_DIM in
//    kernels/flash_attention/plan.py).

#pragma once

#include "lora_mma.cuh"         // cluster_launch; mma_ptx.cuh's to_f, store, bf16x2_to_f

namespace {

constexpr int TK = 32;          // positions per tile (the unit a block's share is cut in)
constexpr int SPLIT_NT = 128;   // threads per block
constexpr int SPLIT_NW = SPLIT_NT / 32;
constexpr int MAX_SPLITS = 8;   // blocks of one cluster (the portable limit)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// addressing: element offset of the first entry of position j's D-row.  The
// body asks for a row's key first (its page: one load for a paged slot,
// nothing for a slab) and its offset from the key after, so that the keys
// of the next rows are in flight while these rows are used.
// ---------------------------------------------------------------------------

struct SlabRows {
  size_t base, stride;
  __device__ __forceinline__ int key(int j) const { return j; }
  __device__ __forceinline__ size_t at(int, int j) const {
    return base + (size_t)j * stride;
  }
};

struct SlabAddr {               // cache (B, L, KH, D)
  int L, KH, D;
  __device__ __forceinline__ int capacity() const { return L; }
  __device__ __forceinline__ SlabRows rows(int b, int h) const {
    return {((size_t)b * L * KH + h) * D, (size_t)KH * D};
  }
};

struct PagedRows {
  const int* row;
  size_t head;
  int PS, D;
  __device__ __forceinline__ int key(int j) const { return row[j / PS]; }
  __device__ __forceinline__ size_t at(int page, int j) const {
    return head + ((size_t)page * PS + j % PS) * D;
  }
};

struct PagedAddr {              // pool (KH, NP, PS, D), tables (B, MP)
  const int* block_tables;
  int NP, PS, MP, D;
  __device__ __forceinline__ int capacity() const { return MP * PS; }
  __device__ __forceinline__ PagedRows rows(int b, int h) const {
    return {block_tables + (size_t)b * MP, (size_t)h * NP * PS * D, PS, D};
  }
};

// ---------------------------------------------------------------------------
// elements: a 16-byte piece of a K and a V row, kept raw in registers from
// its load to its use, then EPV f32 entries.  A policy's head(h) is what
// the body reads KV head h through (load, k_f, v_f); MAX_GT bounds the
// query heads a block serves (the register rule above), MAX_ROWS the rows
// a lane has in flight, and MIN_BLOCKS is the kernel's launch-bound hint
// of blocks an SM (0: none).
// ---------------------------------------------------------------------------

template <typename T>
struct FloatKV {                // f32 or bf16 entries
  static constexpr int EPV = 16 / sizeof(T);
  static constexpr int MAX_GT = 8;
  static constexpr int MAX_ROWS = 8;
  static constexpr int MIN_BLOCKS = 0;
  const T* k;
  const T* v;
  __device__ __forceinline__ FloatKV head(int) const { return *this; }

  // n >= 1 entries from p, entry by entry, zero past n
  static __device__ __forceinline__ uint4 elems(const T* p, int n) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = i < n ? __float_as_uint(p[i]) : 0u;
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = 2 * i < n ? e[2 * i] : 0u;
        const uint32_t hi = 2 * i + 1 < n ? e[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // the piece of entries [d0, d0 + EPV) of the rows at element offset off
  // (d0 < D): one 16-byte load each where VEC, else entry by entry
  template <bool VEC>
  __device__ __forceinline__ void load(uint4& kr, uint4& vr, size_t off, int d0,
                                       int D) const {
    if constexpr (VEC) {
      kr = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr = __ldg(reinterpret_cast<const uint4*>(v + off));
    } else {
      kr = elems(k + off, D - d0);
      vr = elems(v + off, D - d0);
    }
  }

  static __device__ __forceinline__ void unpack(const uint4& r, float (&x)[EPV]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) x[i] = __uint_as_float(w[i]);
      else bf16x2_to_f(w[i], x[2 * i], x[2 * i + 1]);
    }
  }
  __device__ __forceinline__ void k_f(const uint4& r, float (&x)[EPV]) const { unpack(r, x); }
  __device__ __forceinline__ void v_f(const uint4& r, float (&x)[EPV]) const { unpack(r, x); }
};

struct Int8KVHead {             // KV head h of Int8KV, with its two scales
  static constexpr int EPV = 16;
  const int8_t* k;
  const int8_t* v;
  float ks, vs;

  // n >= 1 entries from p, byte by byte, zero past n
  static __device__ __forceinline__ uint4 elems(const int8_t* p, int n) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * i + e < n) x |= (uint32_t)(uint8_t)p[4 * i + e] << (8 * e);
      w[i] = x;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // the piece of entries [d0, d0 + 16) of the rows at element offset off
  // (d0 < D): one 16-byte load each where VEC, else byte by byte
  template <bool VEC>
  __device__ __forceinline__ void load(uint4& kr, uint4& vr, size_t off, int d0,
                                       int D) const {
    if constexpr (VEC) {
      kr = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr = __ldg(reinterpret_cast<const uint4*>(v + off));
    } else {
      kr = elems(k + off, D - d0);
      vr = elems(v + off, D - d0);
    }
  }

  // 16 int8 entries (byte e of word i is entry 4 i + e) to f32, times sc.
  // No I2F (a quarter-rate conversion): the byte plus 128 goes into the low
  // mantissa bits of 2^23 (one PRMT), and 2^23 + 128 comes off exactly, so
  // the one rounding is the multiply's, as in the plain version.
  static __device__ __forceinline__ void unpack(const uint4& r, float sc,
                                                float (&x)[EPV]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[4 * i + e] =
            (__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + e)) - 8388736.f) * sc;
    }
  }
  __device__ __forceinline__ void k_f(const uint4& r, float (&x)[EPV]) const { unpack(r, ks, x); }
  __device__ __forceinline__ void v_f(const uint4& r, float (&x)[EPV]) const { unpack(r, vs, x); }
};

struct Int8KV {                 // int8 entries, f32 (KH,) scales on the device
  static constexpr int EPV = Int8KVHead::EPV;
  static constexpr int MAX_GT = 1;
  static constexpr int MAX_ROWS = 2;
  // without the hint ptxas squeezes the paged element-load kernel's
  // registers until it spills
  static constexpr int MIN_BLOCKS = 2;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ Int8KVHead head(int h) const {
    return {k, v, __ldg(k_scale + h), __ldg(v_scale + h)};
  }
};

// Every row starts on a 16-byte boundary iff D * bytes is a multiple of 16
// and both bases are (row offsets are multiples of D in either layout).
inline bool vec16_rows(const void* k, const void* v, int D, int bytes) {
  return (D * bytes) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// rows of K and V each lane has in flight: fewer where q and acc take more
// registers (GT heads x NC pieces x EPV entries each), and at most the
// policy's MAX_ROWS
__host__ __device__ constexpr int rows_in_flight(int GT, int NC, int EPV, int max_rows) {
  const int u = GT * NC * EPV <= 16 ? 8 : GT * NC * EPV <= 32 ? 4 : 2;
  return u < max_rows ? u : max_rows;
}

// ---------------------------------------------------------------------------
// the kernel: q and out (B, KH, G, D) in T; lengths (B,) int32.  Block x of
// the grid is rank x % S of unit x / S, unit = (b * KH + h) * groups + grp.
// ---------------------------------------------------------------------------

template <typename T, typename KV, typename Addr, int GT, int NC, bool VEC>
__global__ void __launch_bounds__(SPLIT_NT, KV::MIN_BLOCKS) decode_split(
    const T* __restrict__ q, const KV kv, const Addr addr,
    const int* __restrict__ lengths, T* __restrict__ out, int KH, int G, int D,
    int window, float scale, int lanes) {
  constexpr int EPV = KV::EPV;
  constexpr int U = rows_in_flight(GT, NC, EPV, KV::MAX_ROWS);
  constexpr int PW = 2;         // m, l ahead of acc in a partial's record
  extern __shared__ __align__(16) float spl[];
  const int rec = PW + D;                        // one head's record: m, l, acc[D]
  float* wpart = spl;                            // SPLIT_NW x GT records
  float* bpart = spl + SPLIT_NW * GT * rec;      // GT records: the block's

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int groups = (G + GT - 1) / GT;
  const int unit = blockIdx.x / S;
  const int bh = unit / groups;
  const int g0 = (unit % groups) * GT;
  const int b = bh / KH, h = bh % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / lanes, sl = lane % lanes;
  const int streams = SPLIT_NW * (32 / lanes);   // row streams of the block
  const int stream = warp * (32 / lanes) + sub;

  const int len = lengths[b];
  const auto kvh = kv.head(h);  // int8: the head's scales, loaded beside the length
  float qr[GT][NC][EPV];
  const T* qb = q + (size_t)bh * G * D;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const int d = (c * lanes + sl) * EPV + e;
        qr[g][c][e] = g0 + g < G && d < D ? to_f(qb[(size_t)(g0 + g) * D + d]) * scale : 0.f;
      }

  // this block's share of the live tiles, clipped to [lo, hi)
  const int hi = max(0, min(len, addr.capacity()));
  const int lo = window > 0 ? min(max(0, len - window), hi) : 0;
  const int t_lo = lo / TK;
  const int per = ((hi + TK - 1) / TK - t_lo + S - 1) / S;
  const int p0 = max(lo, (t_lo + rank * per) * TK);
  const int p1 = min(hi, (t_lo + (rank + 1) * per) * TK);

  const auto rows = addr.rows(b, h);
  float m[GT], l[GT], acc[GT][NC][EPV];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[g][c][e] = 0.f;
  }

  // row u of a batch at base: position base + u * streams + stream
  const int step = U * streams;
  int key[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = p0 + u * streams + stream;
    key[u] = j < p1 ? rows.key(j) : 0;
  }
  for (int base = p0; base < p1; base += step) {      // trip count uniform in the block
    uint4 kr[U][NC], vr[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * streams + stream;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d0 = (c * lanes + sl) * EPV;
        if (j < p1 && d0 < D) {
          kvh.template load<VEC>(kr[u][c], vr[u][c], rows.at(key[u], j) + d0, d0, D);
        } else {
          kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    // the next batch's keys (paged: its table entries) go out now
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + step + u * streams + stream;
      key[u] = j < p1 ? rows.key(j) : 0;
    }

    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[NC][EPV];
#pragma unroll
      for (int c = 0; c < NC; ++c) kvh.k_f(kr[u][c], kx[c]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < EPV; ++e) t = fmaf(qr[g][c][e], kx[c][e], t);
        for (int o = lanes >> 1; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
        s[u][g] = t;
      }
    }

    // online softmax of this stream over the batch's live rows
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * streams + stream < p1) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      float ls = l[g] * alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = base + u * streams + stream < p1 ? expf(s[u][g] - mx) : 0.f;
        s[u][g] = p;
        ls += p;
      }
      l[g] = ls;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[g][c][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[NC][EPV];
#pragma unroll
      for (int c = 0; c < NC; ++c) kvh.v_f(vr[u][c], vx[c]);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < EPV; ++e) acc[g][c][e] = fmaf(s[u][g], vx[c][e], acc[g][c][e]);
    }
  }

  // the warp's streams merge by xor-shuffles (both partners get the same bits)
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo_ = __shfl_xor_sync(FULL, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float a = expf(m[g] - mm), bo = expf(mo - mm);
      l[g] = l[g] * a + lo_ * bo;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const float ao = __shfl_xor_sync(FULL, acc[g][c][e], o);
          acc[g][c][e] = acc[g][c][e] * a + ao * bo;
        }
      m[g] = mm;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float* r = wpart + (warp * GT + g) * rec;
      if (sl == 0) {
        r[0] = m[g];
        r[1] = l[g];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const int d = (c * lanes + sl) * EPV + e;
          if (d < D) r[PW + d] = acc[g][c][e];
        }
    }
  }
  __syncthreads();

  // the block's (m, l, acc): the warps in warp order
  for (int i = tid; i < GT * rec; i += SPLIT_NT) {
    const int g = i / rec, x = i % rec;
    float mm = NEG_INF;
    for (int w = 0; w < SPLIT_NW; ++w) mm = fmaxf(mm, wpart[(w * GT + g) * rec]);
    float t = 0.f;
    if (x == 0) {
      t = mm;
    } else {
      for (int w = 0; w < SPLIT_NW; ++w) {
        const float* r = wpart + (w * GT + g) * rec;
        t += expf(r[0] - mm) * r[x];
      }
    }
    bpart[i] = t;
  }
  cluster.sync();               // every block's record is in place

  // epilogue spread over the cluster: every rank's (m, l, acc[d]) requested
  // at once, then the blocks added in rank order
  for (int i = rank * SPLIT_NT + tid; i < GT * D; i += S * SPLIT_NT) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) continue;
    float rm[MAX_SPLITS], rl[MAX_SPLITS], ra[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < S) {
        const float* p = cluster.map_shared_rank(bpart, r) + g * rec;
        rm[r] = p[0];
        rl[r] = p[1];
        ra[r] = p[PW + d];
      }
    }
    float mm = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < S) mm = fmaxf(mm, rm[r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < S) {
        const float w = expf(rm[r] - mm);
        den += w * rl[r];
        num += w * ra[r];
      }
    }
    store(out + ((size_t)bh * G + g0 + g) * D + d, num / fmaxf(den, 1e-30f));
  }
  cluster.sync();               // keep this block's record until all have read
}

// The launch plan of kernels/flash_attention/plan.py::decode_plan.
struct SplitPlan {
  int splits;                   // S: blocks of one cluster along the cache
  int heads;                    // GT: query heads a block serves
  int lanes;                    // lanes that read one row
  int vectors;                  // NC: 16-byte pieces of a row a lane holds
  int vec;                      // 16-byte loads (else entry by entry)
};

template <typename T, typename KV, typename Addr, int GT, int NC>
cudaError_t run_split(const void* q, const KV& kv, const Addr& addr, const void* lengths,
                      void* out, int units, int KH, int G, int D, int window, float scale,
                      const SplitPlan& p, cudaStream_t st) {
  const int S = p.splits;
  const size_t bytes = sizeof(float) * (size_t)(SPLIT_NW + 1) * GT * (2 + D);
  const dim3 grid((unsigned)(S * units));
  const T* qp = static_cast<const T*>(q);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  return p.vec ? cluster_launch<decode_split<T, KV, Addr, GT, NC, true>, SPLIT_NT>(
                     grid, S, bytes, st, qp, kv, addr, lp, op, KH, G, D, window, scale,
                     p.lanes)
               : cluster_launch<decode_split<T, KV, Addr, GT, NC, false>, SPLIT_NT>(
                     grid, S, bytes, st, qp, kv, addr, lp, op, KH, G, D, window, scale,
                     p.lanes);
}

// Launch the instantiated kernel the plan names on stream st; `aligned` says
// every K and V row starts on a 16-byte boundary (vec16_rows).  The checks
// follow the KV policy's entries (EPV, MAX_GT), not q's dtype T.  Returns
// cudaErrorInvalidValue for a plan that names none, else the launch's error
// (0 = launched).
template <typename T, typename KV, typename Addr>
cudaError_t launch_decode_split(const void* q, const KV& kv, const Addr& addr,
                                const void* lengths, void* out, int B, int KH, int G,
                                int D, int window, float scale, const SplitPlan& p,
                                bool aligned, cudaStream_t st) {
  constexpr int EPV = KV::EPV;
  const int S = p.splits, GT = p.heads, lanes = p.lanes, NC = p.vectors;
  if (B < 1 || KH < 1 || G < 1 || D < 1 || window < 0) return cudaErrorInvalidValue;
  if (S < 1 || S > MAX_SPLITS || (S & (S - 1)) || GT < 1 || GT > KV::MAX_GT ||
      (GT & (GT - 1)) || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (NC != 1 && NC != 2) || (NC == 2 && (lanes != 32 || EPV != 4)) || lanes * NC * EPV < D ||
      (p.vec && (!aligned || D % EPV)))
    return cudaErrorInvalidValue;
  const long long units = (long long)B * KH * ((G + GT - 1) / GT);
  if (units * S > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n = (int)units;
#define DECODE_SPLIT_RUN(gt, nc)                                                      \
  return run_split<T, KV, Addr, gt, nc>(q, kv, addr, lengths, out, n, KH, G, D, window, \
                                        scale, p, st)
  if (NC == 2) {
    if constexpr (EPV == 4) {
      switch (GT) {
        case 1: DECODE_SPLIT_RUN(1, 2);
        case 2: DECODE_SPLIT_RUN(2, 2);
        case 4: DECODE_SPLIT_RUN(4, 2);
        default: DECODE_SPLIT_RUN(8, 2);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (GT == 1) DECODE_SPLIT_RUN(1, 1);
  if constexpr (KV::MAX_GT == 8) {
    if (GT == 2) DECODE_SPLIT_RUN(2, 1);
    if (GT == 4) DECODE_SPLIT_RUN(4, 1);
    DECODE_SPLIT_RUN(8, 1);
  }
  return cudaErrorInvalidValue;
#undef DECODE_SPLIT_RUN
}

}  // namespace
