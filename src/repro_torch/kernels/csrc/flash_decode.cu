// Flash decode for Hopper (sm_90a): one query token per slot, GQA, over
// per-slot slab KV caches read in the model's layout, with float or int8
// entries.
//   q       (B, KH, G, D)     the G query heads of each KV head
//   k/v     (B, L, KH, D)     the model cache layout, read in place
//   lengths (B,)   int32      live entries per slot at [0, length); a
//                             length past L reads all L entries
//   window  0, or drop entries j <= length - 1 - window
//   out     (B, KH, G, D)     softmax(q k^T * D^-0.5) v, f32 inside
//
// 1. flash_decode:    k/v in q's dtype (f32 or bf16).
//    Replaces: src/repro/kernels/flash_attention/decode.py::
//    flash_decode_kernel (Pallas, TPU).
// 2. flash_decode_q8: int8 k/v with f32 (KH,) per-KV-head scales
//    (precision.quantize_kv_int8 with head_axis=2), dequantized as each
//    16-entry piece is unpacked; q f32 or bf16.
//    Replaces: src/repro/kernels/flash_attention/decode.py::
//    flash_decode_q8_kernel (Pallas, TPU).
//
// There the grid (B, KH, L/bk) ran the cache-length axis in order with
// m/l/acc in VMEM scratch, the lengths rode in as a scalar-prefetch
// operand so dead tiles skipped their matmuls, and the JAX wrapper
// transposed k/v to (B, KH, L, D) for the BlockSpecs.  Here the rows are
// read where the model wrote them: each D-row is contiguous, KH * D
// elements from the next position's, so the per-layer, per-step transpose
// of the whole cache (25.2 MB at 8 slots x 512 positions x 768 wide, f32)
// is never made.
//
// What bounds it: the live K and V are read once, 2 * KH * length * D *
// bytes per slot (1 byte per entry for int8): memory bound (2.0 us at 8
// slots x 12 KV heads of 64, lengths 8-255, f32), and at serving batch
// sizes latency bound, by the launch and the DRAM round trips in series.
//
// Both run the split-K body of csrc/decode_split.cuh with its SlabAddr
// addressing, 1 through the FloatKV<T> element policy and 2 through
// Int8KV: a cluster of S blocks per (slot, KV head, head group), each
// taking an equal share of the slot's live 32-position tiles (S from
// kernels/flash_attention/plan.py::decode_plan over the K/V entries), rows
// read 16 bytes a lane with several rows in flight, online softmax per
// group of lanes in registers, and the blocks' (m, l, acc) merged in rank
// order through distributed shared memory: one launch, no workspace.
//
// Trap: a finished slab slot keeps decoding at position L, writing at
// L % L = 0 and passing length L + 1; the Pallas grid covered L/bk tiles
// and clamped by construction.  Here a block reads min(length, L)
// entries; the window's lower bound still uses the length as given.

#include "decode_split.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); the plan
// (splits, heads, lanes, vectors, vec) is decode_plan's.  Returns
// cudaErrorInvalidValue for a plan that names no instantiated kernel, else
// cudaGetLastError() after the launch (0 = launched).
int flash_decode_launch(const void* q, const void* k, const void* v, const void* lengths,
                        void* out, int B, int KH, int G, int D, int L, int window,
                        int splits, int heads, int lanes, int vectors, int vec,
                        float scale, int dtype, void* stream) {
  if (L < 1 || window < 0) return (int)cudaErrorInvalidValue;
  const SlabAddr addr{L, KH, D};
  const SplitPlan plan{splits, heads, lanes, vectors, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const FloatKV<float> kv{static_cast<const float*>(k), static_cast<const float*>(v)};
    return (int)launch_decode_split<float>(q, kv, addr, lengths, out, B, KH, G, D, window,
                                           scale, plan, vec16_rows(k, v, D, 4), s);
  }
  if (dtype == 1) {
    const FloatKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                    static_cast<const __nv_bfloat16*>(v)};
    return (int)launch_decode_split<__nv_bfloat16>(q, kv, addr, lengths, out, B, KH, G, D,
                                                   window, scale, plan,
                                                   vec16_rows(k, v, D, 2), s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 k/v, f32 (KH,) scales on the device; dtype is q's and out's; the
// plan is decode_plan's over int8 entries.
int flash_decode_q8_launch(const void* q, const void* k, const void* v,
                           const void* lengths, const void* k_scale, const void* v_scale,
                           void* out, int B, int KH, int G, int D, int L, int window,
                           int splits, int heads, int lanes, int vectors, int vec,
                           float scale, int dtype, void* stream) {
  if (L < 1 || window < 0) return (int)cudaErrorInvalidValue;
  const SlabAddr addr{L, KH, D};
  const SplitPlan plan{splits, heads, lanes, vectors, vec};
  const Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  const bool aligned = vec16_rows(k, v, D, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_decode_split<float>(q, kv, addr, lengths, out, B, KH, G, D, window,
                                           scale, plan, aligned, s);
  if (dtype == 1)
    return (int)launch_decode_split<__nv_bfloat16>(q, kv, addr, lengths, out, B, KH, G, D,
                                                   window, scale, plan, aligned, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
