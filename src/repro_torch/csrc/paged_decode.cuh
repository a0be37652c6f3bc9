// The paged decode kernel, a template on the page loader (Int8Pages for the
// int8 pool, Int4Pages for the int4-packed one; paged_attention.cuh).
//
// One block owns one (slot, kv head) and all G query rows of its GQA group,
// loads its own block-table entries and loops over pages 0 .. ceil(len/P)-1
// only: pages at or past the slot's length leave the reference's carry
// untouched (kernels/ref.py::paged_decode_qattention_ref), so skipping them
// is exact.  Each page's K and V rows are read from device memory once and
// shared by the whole group.
#pragma once

#include "paged_attention.cuh"

namespace fq {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxG = 16;
constexpr int kDecodeAcc = kDecodeMaxG * kMaxD / kDecodeThreads;

template <class Pages>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const int8_t* __restrict__ q, Pages pages, const int* __restrict__ btab,
                    const int* __restrict__ lengths, const int* __restrict__ lut,
                    const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                    const float* __restrict__ inv_p, const float* __restrict__ osc_p,
                    int8_t* __restrict__ out, int Hkv, int G, int D, int P, int nb) {
  __shared__ PageSmem sm;
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int len = lengths[b];
  const size_t qoff = (static_cast<size_t>(b) * Hkv + h) * G * D;
  init_rows<kDecodeThreads>(sm, lut, G);
  for (int e = threadIdx.x; e < G * D; e += kDecodeThreads) sm.q[e] = q[qoff + e];
  for (int r = threadIdx.x; r < G; r += kDecodeThreads) sm.qpos[r] = len - 1;
  float acc[kDecodeAcc];
#pragma unroll
  for (int j = 0; j < kDecodeAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int npages = len > 0 ? min((len + P - 1) / P, nb) : 0;
  __syncthreads();
  for (int p = 0; p < npages; ++p) {
    pages.template load<kDecodeThreads>(sm, btab[b * nb + p], P, Hkv, h, D);
    __syncthreads();
    page_step<kDecodeThreads, kDecodeAcc>(sm, G, P, D, p * P, Mi, shi, inv, acc);
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kDecodeAcc; ++j) {
    const int e = threadIdx.x + kDecodeThreads * j;
    if (e < G * D) out[qoff + e] = attn_out(acc[j], sm.den[e / D], osc);
  }
}

template <class Pages>
int launch_paged_decode(const void* q, Pages pages, const void* btab, const void* lengths,
                        const void* lut, const void* Mi, const void* shi, const void* inv,
                        const void* osc, void* out, int B, int Hkv, int G, int D, int P,
                        int nb, void* stream) {
  if (B > 0 && Hkv > 0)
    paged_decode_kernel<Pages><<<dim3(Hkv, B), kDecodeThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), pages, static_cast<const int*>(btab),
        static_cast<const int*>(lengths), static_cast<const int*>(lut),
        static_cast<const int*>(Mi), static_cast<const int*>(shi),
        static_cast<const float*>(inv), static_cast<const float*>(osc),
        static_cast<int8_t*>(out), Hkv, G, D, P, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fq
