// W8A8 integer GEMM for Hopper: y = requantize(x @ w + bias), int8 w.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::
// int8_bitsplit_matmul (Pallas), which feeds the MXU two nibble planes of
// the 8-bit weights, hi = w >> 4 (signed) and lo = w & 15, and adds
// (x@hi << 4) + x@lo: the paper's BIM Type-A bit split.  That identity is
// exact in integers, w = 16 hi + lo, and in int32 neither side wraps while
// every partial sum stays below K * 128 * 128 < 2^31, i.e. for K <= 131071
// (the wrapper refuses larger K).  So this kernel computes the one int8
// product x@w that the two nibble passes add up to; the CPU and card tests
// hold it bit for bit against the bit-split plain version
// (kernels/ref.py::int8_bitsplit_matmul_ref).
//
// What bounds it on the H100: at BERT's shapes (M = B*S rows of K, N in
// {768, 3072}) int8 operations, 2*M*K*N over 1,979 TOP/s; at a small M the
// K*N weight bytes.  The first version is the simple, exact one of
// dp4a_gemm.cuh shared with int4_matmul.cu: BM x 64 output tiles, x and the
// transposed w tile staged K-contiguous in shared memory, __dp4a on CUDA
// cores, the Q15 requantize epilogue.  No tensor cores (wgmma) or TMA yet.
#include "dp4a_gemm.cuh"

namespace {

using fq::kBK;
using fq::kBN;
using fq::kGemmThreads;

template <int BM>
__global__ void __launch_bounds__(kGemmThreads)
int8_bitsplit_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                            const int* __restrict__ bias, const int* __restrict__ Mq,
                            const int* __restrict__ shq, int8_t* __restrict__ out,
                            int M, int K, int N) {
  __shared__ fq::GemmTiles<BM> t;
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

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: BM rows x 64 k values, one 4-byte word per thread and pass
    for (int i = tid; i < BM * (kBK / 4); i += kGemmThreads) {
      const int r = i / (kBK / 4);
      const int c = (i % (kBK / 4)) * 4;
      const int gm = m0 + r;
      int v = 0;
      if (gm < M) v = *reinterpret_cast<const int*>(x + static_cast<size_t>(gm) * K + k0 + c);
      *reinterpret_cast<int*>(&t.xs[r][c]) = v;
    }
    // w tile: 64 k rows x 64 columns, transposed so that ws[n][kk] = w[k0+kk][n0+n]
    for (int i = tid; i < kBK * (kBN / 4); i += kGemmThreads) {
      const int r = i / (kBN / 4);
      const int n = (i % (kBN / 4)) * 4;
      unsigned v = 0;
      if (n0 + n < N)
        v = *reinterpret_cast<const unsigned*>(w + static_cast<size_t>(k0 + r) * N + n0 + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) t.ws[n + j][r] = static_cast<int8_t>((v >> (8 * j)) & 0xffu);
    }
    __syncthreads();
    fq::gemm_step<BM>(t, acc, tx, ty);
    __syncthreads();
  }
  fq::gemm_epilogue<BM>(acc, bias, Mq, shq, out, M, N, m0, n0, tx, ty);
}

}  // namespace

// x int8 (M, K) row-major, w int8 (K, N) row-major, bias int32 (N,), Mq/shq
// int32 scalars in device memory, out int8 (M, N).  Needs K % 64 == 0,
// K <= 131071, N % 4 == 0 and 4-byte aligned x/w (the wrapper checks).
extern "C" int int8_bitsplit_matmul(const void* x, const void* w, const void* bias,
                                    const void* Mq, const void* shq, void* out,
                                    int M, int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* mp = static_cast<const int*>(Mq);
  const auto* sp = static_cast<const int*>(shq);
  auto* op = static_cast<int8_t*>(out);
  if (M <= 16)
    int8_bitsplit_matmul_kernel<16><<<fq::gemm_grid(M, N, 16), kGemmThreads, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N);
  else
    int8_bitsplit_matmul_kernel<64><<<fq::gemm_grid(M, N, 64), kGemmThreads, 0, s>>>(
        xp, wp, bp, mp, sp, op, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
