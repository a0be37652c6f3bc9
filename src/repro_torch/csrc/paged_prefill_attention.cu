// Paged chunked-prefill attention for Hopper, int8 pool.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::
// paged_prefill_qattention (Pallas grid (slot, q head, q block, logical
// block) with pos0 and the block table scalar-prefetched).  The kernel is
// paged_prefill.cuh's paged_prefill_kernel on the Int8Pages loader: one
// block per 16 query rows of the q heads of one kv head, each page staged
// once by cp.async for all of them, QK^T and P.V on the int8 tensor cores
// (mma.sync), the fp32 carry per page in registers.
//
// What bounds it on the H100: the bound per call is the bytes of q, the
// output and the chain's pages (a microsecond at a 512-row chunk); the
// int8 operations, two S x L x D products per head, are a few microseconds
// at the tensor-core rate.  What the kernel cannot go below is the serial
// walk of the longest rows: one dependent carry step per page (32 pages at
// S = 512, 16-row pages).
#include "paged_prefill.cuh"

// q int8 (B, H, S, D) and out int8 (B, H, S, D) through their element
// strides (batch, head, row; D contiguous, every stride and base a
// multiple of 16 bytes), pools int8 (n_pages, P, Hkv, D), btab int32 (B,
// nb), pos0 int32 (B,), lut int32 (256,) of codes in [0, 127], M_idx/sh_idx
// int32 and inv_s_logit/out_scale fp32 scalars in device memory; gh q
// heads per block.  Needs D <= 128, D % 16 == 0, P <= 64, H % Hkv == 0, gh
// dividing H / Hkv and at most 4 (the wrapper checks).  The page walk stops
// at the table's last entry.
extern "C" int paged_prefill_attention(const void* q, const void* kpool, const void* vpool,
                                       const void* btab, const void* pos0, const void* lut,
                                       const void* Mi, const void* shi, const void* inv,
                                       const void* osc, void* out, int B, int H, int S,
                                       int Hkv, int D, int P, int nb, int gh, int qsb, int qsh,
                                       int qss, int osb, int osh, int oss, void* stream) {
  const fq::Int8Pages pages{static_cast<const int8_t*>(kpool),
                            static_cast<const int8_t*>(vpool)};
  return fq::launch_paged_prefill(q, pages, btab, pos0, lut, Mi, shi, inv, osc, out, B, H,
                                  S, Hkv, D, P, nb, gh, qsb, qsh, qss, osb, osh, oss, stream);
}

// Dynamic shared memory of one launch over P-row pages of head dim D.
extern "C" int paged_prefill_attention_smem(int P, int D) {
  return fq::paged_prefill_smem<fq::Int8Pages>(P, D);
}
