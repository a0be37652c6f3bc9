// W4A8 integer GEMM for Hopper: y = requantize(x @ unpack(W4) + bias).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::int4_matmul
// (Pallas, MXU int8 dots over VMEM tiles).  Same arithmetic: x int8 (M, K),
// w uint8 (K/2, N) K-planar nibble-packed (packed row r holds k = r in the
// low nibble and k = r + K/2 in the high nibble), both planes sign-extended
// with (x ^ 8) - 8, int32 accumulation, + int32 bias, Q15 fixed-point
// requantize to int8 (core/fixedpoint.py::requantize, csrc/common.cuh).
//
// What bounds it on the H100: at decode (M <= 8) the packed weights are the
// only large operand, so the bound is bytes (K*N/2 per call over 3.35 TB/s);
// at prefill (M in the hundreds) it is int8 operations.  This first version
// is the simple, exact one (dp4a_gemm.cuh): each block owns a BM x 64 output
// tile, stages the x tile and the unpacked nibble planes of the w tile in
// shared memory (each packed byte is read from device memory once per block
// column), and accumulates with __dp4a on CUDA cores.  It does not use the
// tensor cores (wgmma) or TMA; BM = 16 for decode keeps the wasted rows of a
// small M low.
#include "dp4a_gemm.cuh"

namespace {

using fq::kBK;
using fq::kBN;
using fq::kGemmThreads;
constexpr int kBK2 = kBK / 2;     // packed rows per K step

template <int BM>
__global__ void __launch_bounds__(kGemmThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const int* __restrict__ bias, const int* __restrict__ Mq,
                   const int* __restrict__ shq, int8_t* __restrict__ out,
                   int M, int K, int N) {
  __shared__ fq::GemmTiles<BM> t;
  const int K2 = K / 2;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  int acc[BM / 16][4];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K2; k0 += kBK2) {
    // x tile: row r, bytes [0, 32) = columns k0.. of the low plane's k range,
    // bytes [32, 64) = columns K/2 + k0.. (the high plane's k range)
    for (int i = tid; i < BM * (kBK / 4); i += kGemmThreads) {
      const int r = i / (kBK / 4);
      const int c = (i % (kBK / 4)) * 4;
      const int gm = m0 + r;
      const int gk = c < kBK2 ? k0 + c : K2 + k0 + (c - kBK2);
      int v = 0;
      if (gm < M) v = *reinterpret_cast<const int*>(x + static_cast<size_t>(gm) * K + gk);
      *reinterpret_cast<int*>(&t.xs[r][c]) = v;
    }
    // w tile: 32 packed rows x 64 columns, unpacked and transposed so that
    // ws[n][kk] holds the code of k = kk (low plane) / kk - 32 + K/2 (high)
    for (int i = tid; i < kBK2 * (kBN / 4); i += kGemmThreads) {
      const int r = i / (kBN / 4);
      const int n = (i % (kBN / 4)) * 4;
      unsigned v = 0;
      if (n0 + n < N)
        v = *reinterpret_cast<const unsigned*>(w + static_cast<size_t>(k0 + r) * N + n0 + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = static_cast<int>((v >> (8 * j)) & 0xffu);
        t.ws[n + j][r] = static_cast<int8_t>(((byte & 15) ^ 8) - 8);
        t.ws[n + j][kBK2 + r] = static_cast<int8_t>((((byte >> 4) & 15) ^ 8) - 8);
      }
    }
    __syncthreads();
    fq::gemm_step<BM>(t, acc, tx, ty);
    __syncthreads();
  }
  fq::gemm_epilogue<BM>(acc, bias, Mq, shq, out, M, N, m0, n0, tx, ty);
}

}  // namespace

// x int8 (M, K) row-major, w uint8 (K/2, N), bias int32 (N,), Mq/shq int32
// scalars in device memory, out int8 (M, N).  Needs K/2 % 32 == 0,
// N % 4 == 0 and 4-byte aligned x/w (the wrapper checks).
extern "C" int int4_matmul(const void* x, const void* w, const void* bias,
                           const void* Mq, const void* shq, void* out,
                           int M, int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* mp = static_cast<const int*>(Mq);
  const auto* sp = static_cast<const int*>(shq);
  auto* op = static_cast<int8_t*>(out);
  if (M <= 16)
    int4_matmul_kernel<16><<<fq::gemm_grid(M, N, 16), kGemmThreads, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N);
  else
    int4_matmul_kernel<64><<<fq::gemm_grid(M, N, 64), kGemmThreads, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
