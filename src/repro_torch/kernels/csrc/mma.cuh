// Tensor-core fragments of mma.sync, shared by segment_matmul.cu and
// fused_transform_reduce.cu: bf16 as m16n8k16 with fp32 accumulators, fp32
// as m16n8k8 TF32 with the 3xTF32 split (x = x_hi + x_lo: x_hi keeps the top
// 10 mantissa bits, x_lo = x - x_hi, of which the tensor core reads the top
// 10, as it truncates an operand to TF32; x_lo*w_hi + x_hi*w_lo + x_hi*w_hi
// has an error of the order of a plain fp32 product's).
//
// Fragment coordinates of a lane: gq = lane / 4, tq = lane % 4. A (16 x k):
// a0 = (gq, tq), a1 = (gq + 8, tq), a2 = (gq, tq + 4), a3 = (gq + 8, tq + 4),
// in 32-bit words of a row (bf16: a word is the pair of k = 2w, 2w + 1).
// B (k x 8): b0 = (tq, gq), b1 = (tq + 4, gq), in words along k of column
// gq. C (16 x 8): c0, c1 = (gq, 2tq), (gq, 2tq + 1); c2, c3 = the same of
// row gq + 8.
#pragma once

#include <stdint.h>

// the 3xTF32 split of one fp32 value
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = bits & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(bits) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
