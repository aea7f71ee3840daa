// 3xTF32 products on the tensor cores (mma.sync m16n8k8), close to fp32:
// a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulation. One TF32
// product alone loses about 2^-11 of each term. Shared by the chunked WKV
// scan (wkv6_chunk.cu) and the fp32 body of the flash backward
// (flash_bwd.cu).
//
// Fragments (lane = 4 g + t): A (16 x 8, row) a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8, col) b0 = B[t][g],
// b1 = B[t+4][g]; C (16 x 8) c0, c1 = C[g][2t..2t+1], c2, c3 =
// C[g+8][2t..2t+1]. With row strides LDA = 4 (mod 32) for A read as [m][k]
// and LDB = 8 (mod 32) for B read as [k][n], the 32 lanes hit 32 banks.
#pragma once

#include <stdint.h>

namespace tf32x3 {

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer operations, where
// the cvt compiles to a longer sequence of compares and selects on sm_90a
// (K1b in fp32 at qwen3-4b's training shape on an H100: 35 -> 24 ms).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

}  // namespace tf32x3
