// Device primitives shared by the hand-written tensor-core kernels for
// Hopper (sm_90a): element conversions, cp.async (global -> shared, with
// zero fill), the TF32 rounding of the 3xTF32 split and the
// mma.sync.m16n8k8 TF32 product.  Included by csrc/lora_mma.cuh (the LoRA
// GEMM tile, and through it csrc/ssd_scan.cu), csrc/flash_attention.cu and
// csrc/ssd_scan_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
// the two bf16 of a 32-bit word (the lower one first) as f32, exactly
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 explicit
// mantissa bits): adding half of the 13 dropped bits' range to the
// sign-magnitude bit pattern and clearing them rounds the magnitude the
// same way, infinities and NaNs included.  ptxas expands the cvt into a
// compare-and-select sequence; this is two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 3xTF32 split of v: big = rna(v), small = rna(v - big)
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
}

// c += a b in 3xTF32, a split already, b = (b0, b1) split here: the small
// terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const float b0, const float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// One element of T, global -> shared: 4-byte cp.async for f32, a plain
// load and store for bf16 and int8 (cp.async copies 4 bytes at least).
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? *src : T(0.f);
  }
}

}  // namespace
