// Integer LUT row softmax for Hopper: int32 logit codes (R, S) -> int8 Q0.7.
//
// Replaces the TPU kernel src/repro/kernels/quant_softmax.py::quant_softmax
// (Pallas, _softmax_kernel on the VPU, the 256-entry table as a one-hot
// select against an iota).  Same arithmetic, all int32 (core/qsoftmax.py::
// quant_softmax): m = row max; d = m - x (two's-complement wrap, as torch;
// masked codes sit 2^30 below the max); idx = clamp(rescale(d, M, sh, 9),
// 0, 255) (csrc/common.cuh); num = LUT[idx] from the q8 table; den =
// max(sum num, 1); p = clamp((num * 128 + den / 2) / den, 0, 127) with
// every operand non-negative, so C's truncating division is jnp's floor.
// The sums are integers, so their order does not matter: any reduction is
// exact.
//
// What bounds it on the H100: bytes (4 per input code read, 1 per output
// code written; R = B*12*S rows of S <= 512 for BERT).  One warp per row and
// eight rows per block: a row's three passes (max, den, output) re-read it
// from L1, lanes read neighbouring codes, the table is a shared-memory
// gather in place of the TPU's one-hot select, and warp shuffles do the two
// reductions.  Any S works; no vector loads or register-held rows yet.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
static_assert(kThreads == fq::kLutSize, "one table entry per thread");

__global__ void __launch_bounds__(kThreads)
quant_softmax_kernel(const int* __restrict__ x, const int* __restrict__ lut,
                     const int* __restrict__ Mq, const int* __restrict__ shq,
                     int8_t* __restrict__ out, int R, int S) {
  __shared__ int tab[fq::kLutSize];
  tab[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= R) return;
  const int* xr = x + static_cast<size_t>(row) * S;
  int8_t* yr = out + static_cast<size_t>(row) * S;
  const int Mv = *Mq;
  const int shv = *shq;

  int m = INT_MIN;
  for (int i = lane; i < S; i += 32) m = max(m, xr[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));

  int den = 0;
  for (int i = lane; i < S; i += 32) {
    const int idx = min(max(fq::rescale(fq::wrap_sub(m, xr[i]), Mv, shv, 9), 0), fq::kLutSize - 1);
    den += tab[idx];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  den = max(den, 1);

  for (int i = lane; i < S; i += 32) {
    const int idx = min(max(fq::rescale(fq::wrap_sub(m, xr[i]), Mv, shv, 9), 0), fq::kLutSize - 1);
    const int p = (tab[idx] * 128 + den / 2) / den;
    yr[i] = static_cast<int8_t>(min(max(p, 0), 127));
  }
}

}  // namespace

// x int32 (R, S) row-major, lut int32 (256,), Mq/shq int32 scalars in device
// memory, out int8 (R, S).
extern "C" int quant_softmax(const void* x, const void* lut, const void* Mq,
                             const void* shq, void* out, int R, int S, void* stream) {
  if (R > 0 && S > 0)
    quant_softmax_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<const int*>(lut),
        static_cast<const int*>(Mq), static_cast<const int*>(shq),
        static_cast<int8_t*>(out), R, S);
  return static_cast<int>(cudaGetLastError());
}
