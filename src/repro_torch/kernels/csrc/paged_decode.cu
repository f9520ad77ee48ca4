// Paged decode attention for Hopper (sm_90a): one query token per slot,
// GQA, over a block-table page pool, with float or int8 entries.
//   q            (B, KH, G, D)     the G query heads of each KV head
//   k/v pools    (KH, NP, PS, D)   page 0 is the null page, never read
//   lengths      (B,)   int32      live entries per slot, [0, length)
//   block tables (B, MP) int32     entry j names the page of positions
//                                  [j*PS, (j+1)*PS)
//   out          (B, KH, G, D)     softmax(q k^T * D^-0.5) v, f32 inside
//
// 1. paged_decode:    pools in q's dtype (f32 or bf16).
//    Replaces: src/repro/kernels/flash_attention/paged_decode.py::
//    paged_decode_kernel (Pallas, TPU).
// 2. paged_decode_q8: int8 pools with f32 (KH,) per-KV-head scales
//    (precision.quantize_kv_int8, head_axis=0), dequantized as each
//    16-entry piece is unpacked; q f32 or bf16.
//    Replaces: src/repro/kernels/flash_attention/paged_decode.py::
//    paged_decode_q8_kernel (Pallas, TPU), which took the two scales as
//    scalar-prefetch operands beside the lengths and tables and
//    dequantized its tile in VMEM.
//
// There the lengths and block tables were scalar-prefetched so the
// BlockSpec index map could name each KV tile's page, and the logical-
// length grid axis ran in order with m/l/acc in VMEM scratch.  Here a block
// reads its own length, table row (and, for int8, head scale); table
// entries past the live prefix, page 0, are never read.
//
// What bounds it: the live K and V are read once, 2 * KH * length * D *
// bytes per slot (1 byte per entry for int8), plus the live table entries:
// memory bound (2.0 us at 8 slots x 12 KV heads of 64, lengths 8-255,
// pages of 16, f32), and at serving batch sizes latency bound, by the
// launch and the DRAM round trips in series (length, table entry, row).
//
// Both run the split-K body of csrc/decode_split.cuh with its PagedAddr
// addressing, 1 through the FloatKV<T> element policy and 2 through
// Int8KV: a cluster of S blocks per (slot, KV head, head group), each
// taking an equal share of the slot's live 32-position tiles (S from
// kernels/flash_attention/plan.py::decode_plan over the pool's entries),
// rows read 16 bytes a lane with several rows in flight and the next rows'
// table entries requested before these rows are used, online softmax per
// group of lanes in registers, and the blocks' (m, l, acc) merged in rank
// order through distributed shared memory: one launch, no workspace.

#include "decode_split.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it); the plan
// (splits, heads, lanes, vectors, vec) is decode_plan's.  Returns
// cudaErrorInvalidValue for a plan that names no instantiated kernel, else
// cudaGetLastError() after the launch (0 = launched).
int paged_decode_launch(const void* q, const void* kp, const void* vp,
                        const void* lengths, const void* block_tables, void* out,
                        int B, int KH, int G, int D, int NP, int PS, int MP,
                        int splits, int heads, int lanes, int vectors, int vec,
                        float scale, int dtype, void* stream) {
  if (NP < 1 || PS < 1 || MP < 1) return (int)cudaErrorInvalidValue;
  const PagedAddr addr{static_cast<const int*>(block_tables), NP, PS, MP, D};
  const SplitPlan plan{splits, heads, lanes, vectors, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const FloatKV<float> kv{static_cast<const float*>(kp), static_cast<const float*>(vp)};
    return (int)launch_decode_split<float>(q, kv, addr, lengths, out, B, KH, G, D, 0, scale,
                                           plan, vec16_rows(kp, vp, D, 4), s);
  }
  if (dtype == 1) {
    const FloatKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(kp),
                                    static_cast<const __nv_bfloat16*>(vp)};
    return (int)launch_decode_split<__nv_bfloat16>(q, kv, addr, lengths, out, B, KH, G, D, 0,
                                                   scale, plan, vec16_rows(kp, vp, D, 2), s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 pools, f32 (KH,) scales on the device; dtype is q's and out's; the
// plan is decode_plan's over int8 entries.
int paged_decode_q8_launch(const void* q, const void* kp, const void* vp,
                           const void* lengths, const void* block_tables,
                           const void* k_scale, const void* v_scale, void* out,
                           int B, int KH, int G, int D, int NP, int PS, int MP,
                           int splits, int heads, int lanes, int vectors, int vec,
                           float scale, int dtype, void* stream) {
  if (NP < 1 || PS < 1 || MP < 1) return (int)cudaErrorInvalidValue;
  const PagedAddr addr{static_cast<const int*>(block_tables), NP, PS, MP, D};
  const SplitPlan plan{splits, heads, lanes, vectors, vec};
  const Int8KV kv{static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  const bool aligned = vec16_rows(kp, vp, D, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_decode_split<float>(q, kv, addr, lengths, out, B, KH, G, D, 0, scale,
                                           plan, aligned, s);
  if (dtype == 1)
    return (int)launch_decode_split<__nv_bfloat16>(q, kv, addr, lengths, out, B, KH, G, D, 0,
                                                   scale, plan, aligned, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
