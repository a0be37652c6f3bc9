// The paged chunked-prefill kernel, a template on the page loader
// (Int8Pages or Int4Pages; paged_attention.cuh).
//
// One block owns one (slot, q head, q block of up to 64 rows) and walks the
// slot's block-table row itself, page by page, up to the q block's causal
// frontier (pos0 + last row) / P.  Pages wholly past the frontier are
// skipped: for every row of the block they are fully masked, and the
// reference oracle's docstring (kernels/ref.py::paged_prefill_qattention_ref)
// proves such a page is an exact identity of the online update, so the
// result equals the oracle's for any q-block size and any (also unaligned)
// pos0.
#pragma once

#include "paged_attention.cuh"

namespace fq {

constexpr int kPrefillThreads = 256;
constexpr int kPrefillAcc = kMaxRows * kMaxD / kPrefillThreads;

template <class Pages>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const int8_t* __restrict__ q, Pages pages, const int* __restrict__ btab,
                     const int* __restrict__ pos0_p, const int* __restrict__ lut,
                     const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                     const float* __restrict__ inv_p, const float* __restrict__ osc_p,
                     int8_t* __restrict__ out, int H, int S, int Hkv, int D, int P,
                     int nb, int bq) {
  __shared__ PageSmem sm;
  const int qi = blockIdx.x;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int h = hh / (H / Hkv);
  const int pos0 = pos0_p[b];
  const int row0 = qi * bq;
  const int rows = min(bq, S - row0);       // real rows of this q block
  const size_t qoff = ((static_cast<size_t>(b) * H + hh) * S + row0) * D;
  init_rows<kPrefillThreads>(sm, lut, bq);
  for (int e = threadIdx.x; e < bq * D; e += kPrefillThreads)
    sm.q[e] = e < rows * D ? q[qoff + e] : static_cast<int8_t>(0);
  for (int r = threadIdx.x; r < bq; r += kPrefillThreads) sm.qpos[r] = pos0 + row0 + r;
  float acc[kPrefillAcc];
#pragma unroll
  for (int j = 0; j < kPrefillAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int frontier = min((pos0 + row0 + rows - 1) / P, nb - 1);
  __syncthreads();
  for (int p = 0; p <= frontier; ++p) {
    pages.template load<kPrefillThreads>(sm, btab[b * nb + p], P, Hkv, h, D);
    __syncthreads();
    page_step<kPrefillThreads, kPrefillAcc>(sm, bq, P, D, p * P, Mi, shi, inv, acc);
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kPrefillAcc; ++j) {
    const int e = threadIdx.x + kPrefillThreads * j;
    if (e < rows * D) out[qoff + e] = attn_out(acc[j], sm.den[e / D], osc);
  }
}

template <class Pages>
int launch_paged_prefill(const void* q, Pages pages, const void* btab, const void* pos0,
                         const void* lut, const void* Mi, const void* shi, const void* inv,
                         const void* osc, void* out, int B, int H, int S, int Hkv, int D,
                         int P, int nb, int bq, void* stream) {
  if (B > 0 && H > 0 && S > 0)
    paged_prefill_kernel<Pages><<<dim3((S + bq - 1) / bq, H, B), kPrefillThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), pages, static_cast<const int*>(btab),
        static_cast<const int*>(pos0), static_cast<const int*>(lut),
        static_cast<const int*>(Mi), static_cast<const int*>(shi),
        static_cast<const float*>(inv), static_cast<const float*>(osc),
        static_cast<int8_t*>(out), H, S, Hkv, D, P, nb, bq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fq
