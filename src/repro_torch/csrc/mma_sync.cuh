// mma.sync helpers shared by the integer GEMMs' decode path (igemm.cuh)
// and the split paged decode (paged_decode.cuh): the int8 m16n8k32 product
// and the 4 x 4 byte transpose that turns row-major int8 tiles into
// fragments whose k runs down the rows.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fq {

// 4 x 4 byte transpose: a[i] holds row i's bytes for columns 0..3; b[c]
// holds column c's bytes for rows 0..3 (row i in byte i).
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t (&b)[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t2 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  b[0] = __byte_perm(t0, t1, 0x5410);
  b[1] = __byte_perm(t0, t1, 0x7632);
  b[2] = __byte_perm(t2, t3, 0x5410);
  b[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void mma_16832(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

}  // namespace fq
