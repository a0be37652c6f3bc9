// PTX helpers shared by the integer GEMMs (igemm.cuh), the split paged and
// stripe decode (paged_decode.cuh, stripe_decode.cuh), the paged prefill
// (paged_prefill.cuh) and the flash prefill (flash_qattention.cu): the
// int8 mma.sync products (m16n8k32, m16n8k16), ldmatrix, cp.async, and the
// 4 x 4 byte transpose that turns row-major int8 tiles into fragments whose
// k runs down the rows.
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

// d += a (16 x 16, row-major) . b (16 x 8, k-major), int8 in, int32 sums:
// a0 holds row g, k 4t..4t+3; a1 row g + 8; b0 k 4t..4t+3 of column g
// (lane = 4 g + t); d as in mma_16832.
__device__ __forceinline__ void mma_16816(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: copies nothing and writes zeros when !valid
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 16-byte tiles from shared memory: lanes 8 i .. 8 i + 7 give the
// row addresses of tile i; r[i] gets bytes 4 t .. 4 t + 3 of its row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

}  // namespace fq
