// The shared core of the port's two integer GEMMs (int4_matmul.cu,
// int8_bitsplit_matmul.cu): a block owns a BM x 64 output tile, each K step
// stages a BM x 64 tile of x and a 64 x 64 tile of w (transposed, so both are
// K-contiguous) as int8 codes in shared memory, 256 threads accumulate with
// __dp4a on CUDA cores, and the epilogue adds the int32 bias and applies the
// reference's Q15 requantize (core/fixedpoint.py::requantize) to int8.  Each
// kernel writes only its own staging of the tiles: that is where the weight
// formats differ.
#pragma once

#include "common.cuh"

namespace fq {

constexpr int kBN = 64;           // output columns per block
constexpr int kBK = 64;           // k values per K step
constexpr int kLds = kBK + 4;     // padded shared row: 17 words, conflict-free
constexpr int kGemmThreads = 256; // 16 x 16 threads

template <int BM>
struct GemmTiles {
  __align__(16) int8_t xs[BM][kLds];
  __align__(16) int8_t ws[kBN][kLds];
};

// acc[i][j] += sum_k xs[ty + 16 i][k] * ws[tx + 16 j][k] over one staged K step.
template <int BM>
__device__ __forceinline__ void gemm_step(const GemmTiles<BM>& t, int (&acc)[BM / 16][4],
                                          int tx, int ty) {
#pragma unroll 4
  for (int kk = 0; kk < kBK; kk += 4) {
    int a[BM / 16];
    int b[4];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) a[i] = *reinterpret_cast<const int*>(&t.xs[ty + 16 * i][kk]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const int*>(&t.ws[tx + 16 * j][kk]);
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// out[m0 + ty + 16 i][n0 + tx + 16 j] = requantize8(acc + bias).
template <int BM>
__device__ __forceinline__ void gemm_epilogue(const int (&acc)[BM / 16][4],
                                              const int* __restrict__ bias,
                                              const int* __restrict__ Mq,
                                              const int* __restrict__ shq,
                                              int8_t* __restrict__ out, int M, int N,
                                              int m0, int n0, int tx, int ty) {
  const int Mv = *Mq;
  const int shv = *shq;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] = requantize8(wrap_add(acc[i][j], bias[gn]), Mv, shv);
    }
  }
}

// Launch geometry shared by both GEMMs: 16-row tiles when M <= 16 (decode),
// 64-row tiles otherwise.
inline dim3 gemm_grid(int M, int N, int bm) {
  return dim3((N + kBN - 1) / kBN, (M + bm - 1) / bm);
}

}  // namespace fq
