// Paged chunked-prefill attention for Hopper, int8 pool.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::
// paged_prefill_qattention (Pallas grid (slot, q head, q block, logical
// block) with pos0 and the block table scalar-prefetched).  The kernel is
// paged_prefill.cuh's paged_prefill_kernel on the Int8Pages loader; the q7
// LUT sits in shared memory; the per-page datapath is paged_attention.cuh.
//
// What bounds it on the H100: at chunk sizes of a few hundred rows, int8
// operations (two S x L x D products per head) over the bytes of the chain;
// this version runs them on CUDA cores with __dp4a and re-reads each KV
// page once per (q head, q block), not once per kv head — grouping the
// query heads of a kv head into one block and using the tensor cores are
// later work.
#include "paged_prefill.cuh"

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
  const fq::Int8Pages pages{static_cast<const int8_t*>(kpool),
                            static_cast<const int8_t*>(vpool)};
  return fq::launch_paged_prefill(q, pages, btab, pos0, lut, Mi, shi, inv, osc, out, B, H,
                                  S, Hkv, D, P, nb, bq, stream);
}
