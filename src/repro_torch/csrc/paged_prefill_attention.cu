// Paged chunked-prefill attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::
// paged_prefill_qattention (Pallas grid (slot, q head, q block, logical
// block) with pos0 and the block table scalar-prefetched).  Here one block
// owns one (slot, q head, q block of up to 64 rows) and walks the slot's
// block-table row itself, page by page, up to the q block's causal frontier
// (pos0 + last row) / P.  Pages wholly past the frontier are skipped: for
// every row of the block they are fully masked, and the reference oracle's
// docstring (kernels/ref.py::paged_prefill_qattention_ref) proves such a
// page is an exact identity of the online update, so the result equals the
// oracle's for any q-block size and any (also unaligned) pos0.  The q7 LUT
// sits in shared memory; the per-page datapath is paged_attention.cuh.
//
// What bounds it on the H100: at chunk sizes of a few hundred rows, int8
// operations (two S x L x D products per head) over the bytes of the chain;
// this version runs them on CUDA cores with __dp4a and re-reads each KV
// page once per (q head, q block), not once per kv head — grouping the
// query heads of a kv head into one block and using the tensor cores are
// later work.
#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = fq::kMaxRows * fq::kMaxD / kThreads;

__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kpool,
                     const int8_t* __restrict__ vpool, const int* __restrict__ btab,
                     const int* __restrict__ pos0_p, const int* __restrict__ lut,
                     const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                     const float* __restrict__ inv_p, const float* __restrict__ osc_p,
                     int8_t* __restrict__ out, int H, int S, int Hkv, int D, int P,
                     int nb, int bq) {
  __shared__ fq::PageSmem sm;
  const int qi = blockIdx.x;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int h = hh / (H / Hkv);
  const int pos0 = pos0_p[b];
  const int row0 = qi * bq;
  const int rows = min(bq, S - row0);       // real rows of this q block
  const size_t qoff = ((static_cast<size_t>(b) * H + hh) * S + row0) * D;
  fq::init_rows<kThreads>(sm, lut, bq);
  for (int e = threadIdx.x; e < bq * D; e += kThreads)
    sm.q[e] = e < rows * D ? q[qoff + e] : static_cast<int8_t>(0);
  for (int r = threadIdx.x; r < bq; r += kThreads) sm.qpos[r] = pos0 + row0 + r;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int frontier = min((pos0 + row0 + rows - 1) / P, nb - 1);
  __syncthreads();
  for (int p = 0; p <= frontier; ++p) {
    fq::load_page<kThreads>(sm, kpool, vpool, btab[b * nb + p], P, Hkv, h, D);
    __syncthreads();
    fq::page_step<kThreads, kAcc>(sm, bq, P, D, p * P, Mi, shi, inv, acc);
  }
  const float osc = *osc_p;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = threadIdx.x + kThreads * j;
    if (e < rows * D) out[qoff + e] = fq::attn_out(acc[j], sm.den[e / D], osc);
  }
}

}  // namespace

// q int8 (B, H, S, D), pools int8 (n_pages, P, Hkv, D), btab int32 (B, nb),
// pos0 int32 (B,), lut int32 (256,), M_idx/sh_idx int32 and inv_s_logit/
// out_scale fp32 scalars in device memory, out int8 like q.  Needs
// bq * D <= 64 * 128, bq <= 64, D % 16 == 0, P <= 64 and H % Hkv == 0
// (the wrapper checks).  The page walk stops at the table's last entry.
extern "C" int paged_prefill_attention(const void* q, const void* kpool, const void* vpool,
                                       const void* btab, const void* pos0, const void* lut,
                                       const void* Mi, const void* shi, const void* inv,
                                       const void* osc, void* out, int B, int H, int S,
                                       int Hkv, int D, int P, int nb, int bq, void* stream) {
  if (B > 0 && H > 0 && S > 0)
    paged_prefill_kernel<<<dim3((S + bq - 1) / bq, H, B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(kpool),
        static_cast<const int8_t*>(vpool), static_cast<const int*>(btab),
        static_cast<const int*>(pos0), static_cast<const int*>(lut),
        static_cast<const int*>(Mi), static_cast<const int*>(shi),
        static_cast<const float*>(inv), static_cast<const float*>(osc),
        static_cast<int8_t*>(out), H, S, Hkv, D, P, nb, bq);
  return static_cast<int>(cudaGetLastError());
}
