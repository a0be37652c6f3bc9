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
// is the simple, exact one: each block owns a BM x 64 output tile, stages the
// x tile and the unpacked nibble planes of the w tile in shared memory (each
// packed byte is read from device memory once per block column), and
// accumulates with __dp4a on CUDA cores.  It does not use the tensor cores
// (wgmma) or TMA; BM = 16 for decode keeps the wasted rows of a small M low.
#include "common.cuh"

namespace {

constexpr int kBN = 64;           // output columns per block
constexpr int kBK2 = 32;          // packed rows per K step
constexpr int kBK = 2 * kBK2;     // k values per K step (both nibble planes)
constexpr int kLds = kBK + 4;     // padded shared row: 17 words, conflict-free
constexpr int kThreads = 256;     // 16 x 16 threads

template <int BM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const int* __restrict__ bias, const int* __restrict__ Mq,
                   const int* __restrict__ shq, int8_t* __restrict__ out,
                   int M, int K, int N) {
  constexpr int RM = BM / 16;     // output rows per thread
  __shared__ __align__(16) int8_t xs[BM][kLds];
  __shared__ __align__(16) int8_t ws[kBN][kLds];
  const int K2 = K / 2;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  int acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K2; k0 += kBK2) {
    // x tile: row r, bytes [0, 32) = columns k0.. of the low plane's k range,
    // bytes [32, 64) = columns K/2 + k0.. (the high plane's k range)
    for (int i = tid; i < BM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4);
      const int c = (i % (kBK / 4)) * 4;
      const int gm = m0 + r;
      const int gk = c < kBK2 ? k0 + c : K2 + k0 + (c - kBK2);
      int v = 0;
      if (gm < M) v = *reinterpret_cast<const int*>(x + static_cast<size_t>(gm) * K + gk);
      *reinterpret_cast<int*>(&xs[r][c]) = v;
    }
    // w tile: 32 packed rows x 64 columns, unpacked and transposed so that
    // ws[n][kk] holds the code of k = kk (low plane) / kk - 32 + K/2 (high)
    for (int i = tid; i < kBK2 * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4);
      const int n = (i % (kBN / 4)) * 4;
      unsigned v = 0;
      if (n0 + n < N)
        v = *reinterpret_cast<const unsigned*>(w + static_cast<size_t>(k0 + r) * N + n0 + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = static_cast<int>((v >> (8 * j)) & 0xffu);
        ws[n + j][r] = static_cast<int8_t>(((byte & 15) ^ 8) - 8);
        ws[n + j][kBK2 + r] = static_cast<int8_t>((((byte >> 4) & 15) ^ 8) - 8);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      int a[RM];
      int b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const int*>(&xs[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int Mv = *Mq;
  const int shv = *shq;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] =
            fq::requantize8(fq::wrap_add(acc[i][j], bias[gn]), Mv, shv);
    }
  }
}

}  // namespace

// x int8 (M, K) row-major, w uint8 (K/2, N), bias int32 (N,), Mq/shq int32
// scalars in device memory, out int8 (M, N).  Needs K/2 % 32 == 0,
// N % 4 == 0 and 4-byte aligned x/w (the wrapper checks).
extern "C" int int4_matmul(const void* x, const void* w, const void* bias,
                           const void* Mq, const void* shq, void* out,
                           int M, int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kBN - 1) / kBN, 1);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* mp = static_cast<const int*>(Mq);
  const auto* sp = static_cast<const int*>(shq);
  auto* op = static_cast<int8_t*>(out);
  if (M <= 16) {
    grid.y = (M + 15) / 16;
    int4_matmul_kernel<16><<<grid, kThreads, 0, s>>>(xp, wp, bp, mp, sp, op, M, K, N);
  } else {
    grid.y = (M + 63) / 64;
    int4_matmul_kernel<64><<<grid, kThreads, 0, s>>>(xp, wp, bp, mp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
