// Building blocks of the port's tensor-core kernels (sm_90a): asynchronous
// 16-byte global -> shared copies (cp.async, zero-filled when the source is
// absent), ldmatrix fragment loads, the bf16 mma.sync m16n8k16 with
// float32 accumulation, and the TF32 m16n8k8 with the hi/lo split of the
// float32 route's 3xTF32 products. Included by submanifold_conv.cu,
// submanifold_conv_dw.cu and gather_micro.cu.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 * g + q.
//   A (16 x 16, row-major): a0 = A[g][2q..2q+1], a1 = A[g+8][2q..],
//                           a2 = A[g][2q+8..],  a3 = A[g+8][2q+8..]
//   B (16 x 8, k-major):    b0 = B[2q..2q+1][g], b1 = B[2q+8..2q+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2q..2q+1], c2, c3 = C[g+8][2q..]
// ldmatrix .x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane receives element (lane / 4, 2 (lane % 4))
// of each (with .trans: of its transpose); .x2 loads two, from the
// addresses of lanes 0..15.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), one 32-bit element each:
//   A (16 x 8, row-major):  a0 = A[g][q], a1 = A[g+8][q], a2 = A[g][q+4],
//                           a3 = A[g+8][q+4]
//   B (8 x 8, k-major):     b0 = B[q][g], b1 = B[q+4][g]
//   C as for m16n8k16.
// An 8 x 8 b16 matrix is 8 rows of 4 floats, so a non-transposing ldmatrix
// of row-major float32 rows gives lane the float (lane / 4, lane % 4): the
// A fragment from an (M, K) tile and the B fragment from an (N, K) tile.
// ldmatrix cannot transpose 32-bit elements.
//
// 3xTF32: x = hi + lo + r with hi = rna_tf32(x), lo = rna_tf32(x - hi)
// (x - hi is exact), |r| <= 2^-22 |x|; a*b ~ a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, each product exact in the MMA, about 21 bits of a float32's
// 24 (TF32 alone keeps 11).

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

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// c += A (16 x 8) @ B (8 x 8), tf32 in (32-bit registers whose low 13
// mantissa bits the MMA ignores), float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna), in a
// 32-bit register.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split of x: hi = rna_tf32(x), lo = rna_tf32(x - hi).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += A @ B over 3xTF32 operands, the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

}  // namespace mopa_tc
