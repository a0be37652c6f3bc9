// Integer LayerNorm / RMSNorm for Hopper: one block per row.
//
// Replaces the TPU kernel src/repro/kernels/quant_layernorm.py::
// quant_layernorm (Pallas, _ln_kernel on the VPU).  Same arithmetic, all
// int32: rounded mean (LN only; half away from zero, integer division only
// on non-negative operands), centred sum of squares, var = max(rounded
// mean of squares, eps), Newton rsqrt as mantissa/exponent
// (fixedpoint.rsqrt_mantexp), gamma multiply, aligned beta add, Q15
// rescale, clip to +-127.  The exponent of rsqrt_mantexp is 31 - clz(var)
// instead of floor(log2(float(var))); the two agree on the whole LN
// variance range [1, 2^16), which the CPU tests check for every value.
//
// What bounds it on the H100: bytes (one int8 row in, one out, gamma and
// beta read once per row); the two block reductions are the only serial
// part.  256 threads per row, warp-shuffle reductions, no shared row copy
// (the second and third passes re-read the row from L1/L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < kThreads / 32; ++i) t += red[i];
    red[kThreads / 32] = t;
  }
  __syncthreads();
  const int total = red[kThreads / 32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
quant_layernorm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ gamma,
                       const int* __restrict__ beta, const int* __restrict__ Mq,
                       const int* __restrict__ shq, int8_t* __restrict__ out,
                       int N, int sub_mean, int eps) {
  __shared__ int red[kThreads / 32 + 1];
  const int8_t* xr = x + static_cast<size_t>(blockIdx.x) * N;
  int8_t* yr = out + static_cast<size_t>(blockIdx.x) * N;
  const int half = N / 2;
  int mean = 0;
  if (sub_mean) {
    int s = 0;
    for (int i = threadIdx.x; i < N; i += kThreads) s += xr[i];
    s = block_sum(s, red);
    mean = s >= 0 ? (s + half) / N : -((-s + half) / N);
  }
  int ss = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int c = xr[i] - mean;
    ss += c * c;
  }
  ss = block_sum(ss, red);
  const int var = max((ss + half) / N, eps);
  // rsqrt_mantexp(var): y Q15 mantissa, se exponent
  const int xv = max(var, 1);
  const int e = 31 - __clz(xv);
  const int se = e >> 1;
  const int sh = 14 - 2 * se;
  const int m14 = sh >= 0 ? fq::shl(xv, sh) : fq::sra(xv, -sh);
  int y = m14 < (1 << 15) ? 27853 : 19661;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int y2 = fq::sra(fq::wrap_mul(y, y), 15);
    const int t = fq::sra(fq::wrap_mul(m14, y2), 15);
    y = fq::sra(fq::wrap_mul(y, (3 << 14) - t), 15);
  }
  const int Mv = *Mq;
  const int shv = *shq;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int c = xr[i] - mean;
    const int nq = fq::rshift_round(fq::wrap_mul(c, y), se + 1);
    const int acc = fq::wrap_add(fq::wrap_mul(nq, static_cast<int>(gamma[i])), beta[i]);
    const int v = fq::rescale(acc, Mv, shv, 8);
    yr[i] = static_cast<int8_t>(min(max(v, -127), 127));
  }
}

}  // namespace

// x int8 (R, N), gamma int8 (N,), beta int32 (N,), Mq/shq int32 scalars in
// device memory, out int8 (R, N).
extern "C" int quant_layernorm(const void* x, const void* gamma, const void* beta,
                               const void* Mq, const void* shq, void* out,
                               int R, int N, int sub_mean, int eps, void* stream) {
  if (R > 0)
    quant_layernorm_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(gamma),
        static_cast<const int*>(beta), static_cast<const int*>(Mq),
        static_cast<const int*>(shq), static_cast<int8_t*>(out), N, sub_mean, eps);
  return static_cast<int>(cudaGetLastError());
}
