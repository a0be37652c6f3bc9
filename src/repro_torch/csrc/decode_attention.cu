// Continuous-batching decode attention over the contiguous KV stripe, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_qattention (Pallas grid (slot, kv head, KV block of bkv keys) over
// the cache-native (B, Smax, Hkv, D) stripe, per-slot lengths in scalar
// prefetch, dead blocks clamped onto the last live one and skipped).
//
// The result depends on bkv: the fp32 carry (running max m, denominator,
// accumulator) updates once per block of bkv keys, with the max taken over
// the whole block (kernels/ref.py::decode_qattention_ref):
//
//   s    = int8 q . int8 k over the block's bkv keys   (int32, __dp4a)
//   s    = kpos < len ? s : s - 2^30
//   m'   = max(m, max_block s);  f = exp((m - m') * inv)  (0 while m unset)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num;  acc = acc * f + num . int8 v   (per block)
//
// The serving path's bkv is 512 (divisor_tile(512, Smax)), and a 512-row
// K or V block does not fit beside the rest in shared memory, so a block
// runs in two passes over 64-row sub-tiles: pass 1 streams K and writes all
// G x bkv scores into shared memory (32 KB at G = 16, bkv = 512); then the
// block max, the rescale factor and the numerators in place; pass 2
// streams V and sums num . v in int32 registers over the whole block (exact:
// at most 512 * 127 * 127 < 2^31), so f multiplies the carry once per
// block as in the reference.  Blocks at or past the slot's length do no
// work and read nothing; inside the last live block every key is read, as
// the reference computes the masked ones too.
//
// What bounds it on the H100: bytes — the K and V rows below each slot's
// length (a masked key's numerator is 0, so the function needs no others;
// this kernel also reads the masked tail of the last live block).  Like the
// paged kernel, it runs B * Hkv blocks (32 at yi-6b with 8 slots), each
// walking its stripe serially.
#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr int kTile = 64;          // K/V rows staged at a time
constexpr int kMaxBkv = 512;
constexpr int kAcc = kMaxG * fq::kMaxD / kThreads;

struct StripeSmem {
  alignas(16) int8_t q[kMaxG * fq::kMaxD];
  alignas(16) int8_t kv[kTile * fq::kMaxD];
  int s[kMaxG * kMaxBkv];          // scores, then LUT numerators
  int m[kMaxG];
  int m_new[kMaxG];
  float f[kMaxG];
  float den[kMaxG];
  int lut[fq::kLutSize];
};

// Rows [t0, t0 + rows) of the stripe of slot b, kv head h, into sm.kv.
__device__ __forceinline__ void load_rows(StripeSmem& sm, const int8_t* cache, int b, int h,
                                          int t0, int rows, int Smax, int Hkv, int D) {
  const int vecs = D / 16;
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = (e % vecs) * 16;
    const size_t g = ((static_cast<size_t>(b) * Smax + t0 + r) * Hkv + h) * D + c;
    *reinterpret_cast<int4*>(&sm.kv[r * D + c]) = *reinterpret_cast<const int4*>(cache + g);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kc,
              const int8_t* __restrict__ vc, const int* __restrict__ lengths,
              const int* __restrict__ lut, const int* __restrict__ Mi_p,
              const int* __restrict__ shi_p, const float* __restrict__ inv_p,
              const float* __restrict__ osc_p, int8_t* __restrict__ out, int Hkv, int G,
              int D, int Smax, int bkv) {
  __shared__ StripeSmem sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int len = lengths[b];
  const size_t qoff = (static_cast<size_t>(b) * Hkv + h) * G * D;
  for (int i = tid; i < fq::kLutSize; i += kThreads) sm.lut[i] = lut[i];
  for (int r = tid; r < G; r += kThreads) {
    sm.m[r] = fq::kNegInit;
    sm.den[r] = 0.0f;
  }
  for (int e = tid; e < G * D; e += kThreads) sm.q[e] = q[qoff + e];
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int nblk = len > 0 ? min((len + bkv - 1) / bkv, Smax / bkv) : 0;
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const int base = blk * bkv;
    // pass 1: every score of the block
    for (int t0 = 0; t0 < bkv; t0 += kTile) {
      const int rows = min(kTile, bkv - t0);
      load_rows(sm, kc, b, h, base + t0, rows, Smax, Hkv, D);
      __syncthreads();
      for (int e = tid; e < G * rows; e += kThreads) {
        const int r = e / rows;
        const int c = e % rows;
        const int* qw = reinterpret_cast<const int*>(&sm.q[r * D]);
        const int* kw = reinterpret_cast<const int*>(&sm.kv[c * D]);
        int s = 0;
        for (int w = 0; w < D / 4; ++w) s = __dp4a(qw[w], kw[w], s);
        if (base + t0 + c >= len) s = fq::wrap_sub(s, fq::kMaskOffset);
        sm.s[r * bkv + t0 + c] = s;
      }
      __syncthreads();
    }
    // the block's max, the carry's rescale factor, numerators and den
    fq::carry_update<kThreads>(sm.s, G, bkv, sm.m, sm.m_new, sm.f, sm.den, sm.lut, Mi, shi,
                               inv);
    // pass 2: num . v over the whole block in int32
    int pv[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) pv[j] = 0;
    for (int t0 = 0; t0 < bkv; t0 += kTile) {
      const int rows = min(kTile, bkv - t0);
      load_rows(sm, vc, b, h, base + t0, rows, Smax, Hkv, D);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int e = tid + kThreads * j;
        if (e < G * D) {
          const int r = e / D;
          const int d = e % D;
          const int* num = &sm.s[r * bkv + t0];
          int sum = 0;
          for (int c = 0; c < rows; ++c) sum += num[c] * static_cast<int>(sm.kv[c * D + d]);
          pv[j] += sum;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int e = tid + kThreads * j;
      if (e < G * D) acc[j] = __fadd_rn(__fmul_rn(acc[j], sm.f[e / D]), static_cast<float>(pv[j]));
    }
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = tid + kThreads * j;
    if (e < G * D) out[qoff + e] = fq::attn_out(acc[j], sm.den[e / D], osc);
  }
}

}  // namespace

// q int8 (B, Hkv, G, D), k/v caches int8 (B, Smax, Hkv, D), lengths int32
// (B,), lut int32 (256,), M_idx/sh_idx int32 and inv_s_logit/out_scale fp32
// scalars in device memory, out int8 like q.  Needs G <= 16, D <= 128 with
// D % 16 == 0, bkv <= 512 dividing Smax (the wrapper checks).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, const void* lut, const void* Mi,
                                const void* shi, const void* inv, const void* osc, void* out,
                                int B, int Hkv, int G, int D, int Smax, int bkv,
                                void* stream) {
  if (B > 0 && Hkv > 0)
    decode_kernel<<<dim3(Hkv, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(kc),
        static_cast<const int8_t*>(vc), static_cast<const int*>(lengths),
        static_cast<const int*>(lut), static_cast<const int*>(Mi),
        static_cast<const int*>(shi), static_cast<const float*>(inv),
        static_cast<const float*>(osc), static_cast<int8_t*>(out), Hkv, G, D, Smax, bkv);
  return static_cast<int>(cudaGetLastError());
}
