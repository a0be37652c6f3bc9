// The single-query decode over a contiguous KV stripe, a template on the
// stripe's layout (where row t of slot b, kv head h starts):
//
//   CacheNative  (B, Smax, Hkv, D): the engine's contiguous stripe
//                (decode_attention.cu, row 6);
//   HeadMajor    (B, Smax, D) per kv head, i.e. (B, Hkv, Smax, D): the
//                reference's single-sequence cache (Hkv, Smax, D) at B = 1
//                (flash_qdecode.cu, row 10).
//
// Everything after the row load is the same datapath.  The result depends
// on bkv: the fp32 carry (running max m, denominator, accumulator) updates
// once per block of bkv keys, with the max taken over the whole block
// (kernels/ref.py::decode_qattention_ref):
//
//   s    = int8 q . int8 k over the block's bkv keys   (int32, __dp4a)
//   s    = kpos < len ? s : s - 2^30
//   m'   = max(m, max_block s);  f = exp((m - m') * inv)  (0 while m unset)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num;  acc = acc * f + num . int8 v   (per block)
//
// A 512-row K or V block does not fit beside the rest in shared memory, so
// a block runs in two passes over 64-row sub-tiles: pass 1 streams K and
// writes all G x bkv scores into shared memory (32 KB at G = 16, bkv =
// 512); then the block max, the rescale factor and the numerators in place
// (paged_attention.cuh::carry_update); pass 2 streams V and sums num . v in
// int32 registers over the whole block (exact: at most 512 * 127 * 127 <
// 2^31), so f multiplies the carry once per block as in the reference.
// Blocks at or past the slot's length do no work and read nothing (they
// leave the carry untouched); inside the last live block every key is
// read, as the reference computes the masked ones too.
#pragma once

#include "paged_attention.cuh"

namespace fq {

constexpr int kStripeThreads = 128;
constexpr int kStripeMaxG = 16;
constexpr int kStripeTile = 64;    // K/V rows staged at a time
constexpr int kStripeMaxBkv = 512;
constexpr int kStripeAcc = kStripeMaxG * kMaxD / kStripeThreads;

struct StripeSmem {
  alignas(16) int8_t q[kStripeMaxG * kMaxD];
  alignas(16) int8_t kv[kStripeTile * kMaxD];
  int s[kStripeMaxG * kStripeMaxBkv];   // scores, then LUT numerators
  int m[kStripeMaxG];
  int m_new[kStripeMaxG];
  float f[kStripeMaxG];
  float den[kStripeMaxG];
  int lut[kLutSize];
};

struct CacheNative {
  __device__ __forceinline__ static size_t row(int b, int t, int h, int Smax, int Hkv, int D) {
    return ((static_cast<size_t>(b) * Smax + t) * Hkv + h) * D;
  }
};

struct HeadMajor {
  __device__ __forceinline__ static size_t row(int b, int t, int h, int Smax, int Hkv, int D) {
    return ((static_cast<size_t>(b) * Hkv + h) * Smax + t) * D;
  }
};

// Rows [t0, t0 + rows) of slot b, kv head h, into sm.kv (16 bytes a load).
template <class Layout>
__device__ __forceinline__ void load_stripe_rows(StripeSmem& sm, const int8_t* cache, int b,
                                                 int h, int t0, int rows, int Smax, int Hkv,
                                                 int D) {
  const int vecs = D / 16;
  for (int e = threadIdx.x; e < rows * vecs; e += kStripeThreads) {
    const int r = e / vecs;
    const int c = (e % vecs) * 16;
    const size_t g = Layout::row(b, t0 + r, h, Smax, Hkv, D) + c;
    *reinterpret_cast<int4*>(&sm.kv[r * D + c]) = *reinterpret_cast<const int4*>(cache + g);
  }
}

// One block per (kv head, slot): q (B, Hkv, G, D) and out alike.
template <class Layout>
__global__ void __launch_bounds__(kStripeThreads)
stripe_decode_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kc,
                     const int8_t* __restrict__ vc, const int* __restrict__ lengths,
                     const int* __restrict__ lut, const int* __restrict__ Mi_p,
                     const int* __restrict__ shi_p, const float* __restrict__ inv_p,
                     const float* __restrict__ osc_p, int8_t* __restrict__ out, int Hkv, int G,
                     int D, int Smax, int bkv) {
  __shared__ StripeSmem sm;
  constexpr int NT = kStripeThreads;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int len = lengths[b];
  const size_t qoff = (static_cast<size_t>(b) * Hkv + h) * G * D;
  for (int i = tid; i < kLutSize; i += NT) sm.lut[i] = lut[i];
  for (int r = tid; r < G; r += NT) {
    sm.m[r] = kNegInit;
    sm.den[r] = 0.0f;
  }
  for (int e = tid; e < G * D; e += NT) sm.q[e] = q[qoff + e];
  float acc[kStripeAcc];
#pragma unroll
  for (int j = 0; j < kStripeAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int nblk = len > 0 ? min((len + bkv - 1) / bkv, Smax / bkv) : 0;
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const int base = blk * bkv;
    // pass 1: every score of the block
    for (int t0 = 0; t0 < bkv; t0 += kStripeTile) {
      const int rows = min(kStripeTile, bkv - t0);
      load_stripe_rows<Layout>(sm, kc, b, h, base + t0, rows, Smax, Hkv, D);
      __syncthreads();
      for (int e = tid; e < G * rows; e += NT) {
        const int r = e / rows;
        const int c = e % rows;
        const int* qw = reinterpret_cast<const int*>(&sm.q[r * D]);
        const int* kw = reinterpret_cast<const int*>(&sm.kv[c * D]);
        int s = 0;
        for (int w = 0; w < D / 4; ++w) s = __dp4a(qw[w], kw[w], s);
        if (base + t0 + c >= len) s = wrap_sub(s, kMaskOffset);
        sm.s[r * bkv + t0 + c] = s;
      }
      __syncthreads();
    }
    // the block's max, the carry's rescale factor, numerators and den
    carry_update<NT>(sm.s, G, bkv, bkv, sm.m, sm.m_new, sm.f, sm.den, sm.lut, Mi, shi, inv);
    // pass 2: num . v over the whole block in int32
    int pv[kStripeAcc];
#pragma unroll
    for (int j = 0; j < kStripeAcc; ++j) pv[j] = 0;
    for (int t0 = 0; t0 < bkv; t0 += kStripeTile) {
      const int rows = min(kStripeTile, bkv - t0);
      load_stripe_rows<Layout>(sm, vc, b, h, base + t0, rows, Smax, Hkv, D);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kStripeAcc; ++j) {
        const int e = tid + NT * j;
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
    for (int j = 0; j < kStripeAcc; ++j) {
      const int e = tid + NT * j;
      if (e < G * D) acc[j] = __fadd_rn(__fmul_rn(acc[j], sm.f[e / D]), static_cast<float>(pv[j]));
    }
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kStripeAcc; ++j) {
    const int e = tid + NT * j;
    if (e < G * D) out[qoff + e] = attn_out(acc[j], sm.den[e / D], osc);
  }
}

template <class Layout>
int launch_stripe_decode(const void* q, const void* kc, const void* vc, const void* lengths,
                         const void* lut, const void* Mi, const void* shi, const void* inv,
                         const void* osc, void* out, int B, int Hkv, int G, int D, int Smax,
                         int bkv, void* stream) {
  if (B > 0 && Hkv > 0)
    stripe_decode_kernel<Layout><<<dim3(Hkv, B), kStripeThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(kc),
        static_cast<const int8_t*>(vc), static_cast<const int*>(lengths),
        static_cast<const int*>(lut), static_cast<const int*>(Mi),
        static_cast<const int*>(shi), static_cast<const float*>(inv),
        static_cast<const float*>(osc), static_cast<int8_t*>(out), Hkv, G, D, Smax, bkv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fq
