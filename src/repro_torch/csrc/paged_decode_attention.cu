// Paged continuous-batching decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_qattention (Pallas grid (slot, kv head, logical block) with
// the block table scalar-prefetched into the KV index map).  Here one block
// owns one (slot, kv head) and all G query rows of its GQA group, loads its
// own block-table entries and loops over pages 0 .. ceil(len/P) - 1 only:
// pages at or past the slot's length leave the reference's carry untouched
// (kernels/ref.py::paged_decode_qattention_ref), so skipping them is exact.
// Each page's K and V rows are read from device memory once and shared by
// the whole group.  The per-page datapath is paged_attention.cuh.
//
// What bounds it on the H100: bytes — the live K/V pages of every slot
// (2 * len * D bytes per kv head) against a few int8 operations per byte.
// This version runs B * Hkv blocks (32 at yi-6b with 8 slots), each walking
// its chain serially, so at small batch it fills a fraction of the 132 SMs;
// splitting the chain across blocks (flash-decoding) is later work.
#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr int kAcc = kMaxG * fq::kMaxD / kThreads;

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kpool,
                    const int8_t* __restrict__ vpool, const int* __restrict__ btab,
                    const int* __restrict__ lengths, const int* __restrict__ lut,
                    const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                    const float* __restrict__ inv_p, const float* __restrict__ osc_p,
                    int8_t* __restrict__ out, int Hkv, int G, int D, int P, int nb) {
  __shared__ fq::PageSmem sm;
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int len = lengths[b];
  const size_t qoff = (static_cast<size_t>(b) * Hkv + h) * G * D;
  fq::init_rows<kThreads>(sm, lut, G);
  for (int e = threadIdx.x; e < G * D; e += kThreads) sm.q[e] = q[qoff + e];
  for (int r = threadIdx.x; r < G; r += kThreads) sm.qpos[r] = len - 1;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int npages = len > 0 ? min((len + P - 1) / P, nb) : 0;
  __syncthreads();
  for (int p = 0; p < npages; ++p) {
    fq::load_page<kThreads>(sm, kpool, vpool, btab[b * nb + p], P, Hkv, h, D);
    __syncthreads();
    fq::page_step<kThreads, kAcc>(sm, G, P, D, p * P, Mi, shi, inv, acc);
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = threadIdx.x + kThreads * j;
    if (e < G * D) out[qoff + e] = fq::attn_out(acc[j], sm.den[e / D], osc);
  }
}

}  // namespace

// q int8 (B, Hkv, G, D), pools int8 (n_pages, P, Hkv, D), btab int32
// (B, nb), lengths int32 (B,), lut int32 (256,), M_idx/sh_idx int32 and
// inv_s_logit/out_scale fp32 scalars in device memory, out int8 like q.
// Needs G <= 16, D <= 128 with D % 16 == 0, P <= 64 (the wrapper checks).
extern "C" int paged_decode_attention(const void* q, const void* kpool, const void* vpool,
                                      const void* btab, const void* lengths, const void* lut,
                                      const void* Mi, const void* shi, const void* inv,
                                      const void* osc, void* out, int B, int Hkv, int G,
                                      int D, int P, int nb, void* stream) {
  if (B > 0 && Hkv > 0)
    paged_decode_kernel<<<dim3(Hkv, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(kpool),
        static_cast<const int8_t*>(vpool), static_cast<const int*>(btab),
        static_cast<const int*>(lengths), static_cast<const int*>(lut),
        static_cast<const int*>(Mi), static_cast<const int*>(shi),
        static_cast<const float*>(inv), static_cast<const float*>(osc),
        static_cast<int8_t*>(out), Hkv, G, D, P, nb);
  return static_cast<int>(cudaGetLastError());
}
