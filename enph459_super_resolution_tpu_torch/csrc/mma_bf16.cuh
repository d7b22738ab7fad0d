// Device helpers shared by the hand-written Hopper kernels (sm_90a) that run
// bfloat16 products on the tensor cores (trunk.cu, banded_rows.cu,
// fused_ibp.cu):
// asynchronous global -> shared copies (cp.async), ldmatrix fragment loads
// and the warp-wide mma.sync m16n8k16 product, bf16 x bf16 summed in f32.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"), for lane l, g = l / 4 and
// t = l % 4:
//   A (16 x 16, row-major)  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                           a2 = A[g][2t+8..+9]    a3 = A[g+8][2t+8..+9]
//   B (16 x 8, k-major)     b0 = B[2t..2t+1][g]    b1 = B[2t+8..+9][g]
//   C (16 x 8, f32)         c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// Each register holds two bf16 values, the lower index in the low half.
// ldmatrix.x4 loads four 8 x 8 b16 matrices whose eight 16-byte rows are
// addressed by lanes 8q..8q+7 for matrix q; with .trans each lane receives
// the transposed elements, which turns a k-major store of A or B into its
// fragment.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared, in flight until cp_async_wait.  Only
// `src_bytes` (0 or 16) are read; the rest of the 16 bytes is zero-filled,
// so 0 writes zeros and reads nothing.  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4-byte copy global -> shared; `src_bytes` 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A * B for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace mma_bf16
