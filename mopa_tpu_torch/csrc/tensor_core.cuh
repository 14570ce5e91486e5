// Building blocks of the port's tensor-core kernels (sm_90a): asynchronous
// 16-byte global -> shared copies (cp.async, zero-filled when the source is
// absent), ldmatrix fragment loads and the bf16 mma.sync m16n8k16 with
// float32 accumulation. Included by submanifold_conv.cu,
// submanifold_conv_dw.cu and gather_micro.cu.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 * g + q.
//   A (16 x 16, row-major): a0 = A[g][2q..2q+1], a1 = A[g+8][2q..],
//                           a2 = A[g][2q+8..],  a3 = A[g+8][2q+8..]
//   B (16 x 8, k-major):    b0 = B[2q..2q+1][g], b1 = B[2q+8..2q+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2q..2q+1], c2, c3 = C[g+8][2q..]
// ldmatrix .x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane receives element (lane / 4, 2 (lane % 4))
// of each (with .trans: of its transpose).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mopa_tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes when !present (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool present) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(present ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 16) @ B (16 x 8), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mopa_tc
