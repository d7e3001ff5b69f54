// Helpers shared by the kernels that run fp32-accurate products on Hopper's
// tensor cores (attention.cu, ssd_scan.cu): fp32/bf16 conversions, 16-byte
// cp.async staging, and 3xTF32 products on mma.sync.m16n8k8.
//
// 3xTF32: TF32 keeps 10 mantissa bits, so each fp32 operand x is split
// hi = rna(x), lo = rna(x - hi), and a product is formed as a_lo b_hi +
// a_hi b_lo + a_hi b_hi (the a_lo b_lo term is below fp32 rounding): about
// fp32's accuracy at three products.  An operand exact in TF32 (a bf16
// value) needs no lo part, and its products drop the terms it would feed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive elements (shared or global memory, aligned to their
// size) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// round to TF32, nearest with ties away from zero, as cvt.rna.tf32.f32
// does (the low 13 bits are 0): half of the dropped bits' unit added to the
// magnitude, then the bits cleared.  Two integer operations: the flash
// kernel measured faster on the H100 with these than with cvt, which
// issues at a lower rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}
// the same, recomputed where it stands: Q's split is redone per tile
// rather than hoisted out of the tile loop into D more registers (hoisted,
// the D = 128 instances spill)
__device__ __forceinline__ void split_tf32_here(float x, uint32_t& hi,
                                                uint32_t& lo) {
  asm volatile(
      "{\n .reg .b32 t;\n .reg .f32 fh, fd;\n"
      " add.u32 t, %2, 4096;\n and.b32 %0, t, 0xffffe000;\n"
      " mov.b32 fh, %0;\n sub.rn.f32 fd, %3, fh;\n mov.b32 t, fd;\n"
      " add.u32 t, t, 4096;\n and.b32 %1, t, 0xffffe000;\n}\n"
      : "=r"(hi), "=r"(lo)
      : "r"(__float_as_uint(x)), "f"(x));
}

// c += a b for a 16x8 (row) A, an 8x8 (col) B, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[off + j] += a b[j] for N tiles of one A fragment, to fp32 accuracy:
// a_lo b_hi, then a_hi b_lo, then a_hi b_hi (small terms first), each pass
// over all N accumulators, so that a product never waits on the one before
// it.  b holds the N fragments' (b0, b1) as fp32; kSplitA: A is fp32 (ah,
// al); kSplitB: B is fp32 and is split here (bf16 is exact in TF32).
template <int N, bool kSplitA, bool kSplitB, int NC>
__device__ __forceinline__ void mma_rows(float (&c)[NC][4], int off,
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float (&b)[N][2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (kSplitB)
        split_tf32(b[j][i], bh[j][i], bl[j][i]);
      else
        bh[j][i] = __float_as_uint(b[j][i]);
    }
  if constexpr (kSplitA) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      mma_tf32(c[off + j], al, bh[j][0], bh[j][1]);
  }
  if constexpr (kSplitB) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      mma_tf32(c[off + j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[off + j], ah, bh[j][0], bh[j][1]);
}

}  // namespace
