// Paged continuous-batching decode attention for Hopper, int8 pool.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_qattention (Pallas grid (slot, kv head, logical block) with
// the block table scalar-prefetched into the KV index map).  The kernel is
// paged_decode.cuh's paged_decode_kernel on the Int8Pages loader; the
// per-page datapath is paged_attention.cuh.
//
// What bounds it on the H100: bytes — the live K/V pages of every slot
// (2 * len * D bytes per kv head) against a few int8 operations per byte.
// This version runs B * Hkv blocks (32 at yi-6b with 8 slots), each walking
// its chain serially, so at small batch it fills a fraction of the 132 SMs;
// splitting the chain across blocks (flash-decoding) is later work.
#include "paged_decode.cuh"

// q int8 (B, Hkv, G, D), pools int8 (n_pages, P, Hkv, D), btab int32
// (B, nb), lengths int32 (B,), lut int32 (256,), M_idx/sh_idx int32 and
// inv_s_logit/out_scale fp32 scalars in device memory, out int8 like q.
// Needs G <= 16, D <= 128 with D % 16 == 0, P <= 64 (the wrapper checks).
extern "C" int paged_decode_attention(const void* q, const void* kpool, const void* vpool,
                                      const void* btab, const void* lengths, const void* lut,
                                      const void* Mi, const void* shi, const void* inv,
                                      const void* osc, void* out, int B, int Hkv, int G,
                                      int D, int P, int nb, void* stream) {
  const fq::Int8Pages pages{static_cast<const int8_t*>(kpool),
                            static_cast<const int8_t*>(vpool)};
  return fq::launch_paged_decode(q, pages, btab, lengths, lut, Mi, shi, inv, osc, out, B,
                                 Hkv, G, D, P, nb, stream);
}
