// Paged continuous-batching decode attention for Hopper, int8 pool.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_qattention (Pallas grid (slot, kv head, logical block) with
// the block table scalar-prefetched into the KV index map).  The kernels
// are paged_decode.cuh's passes on the Int8Pages loader.
//
// What bounds it on the H100: bytes — the live K/V pages of every slot
// (2 * len * D bytes per kv head) against a few int8 operations per byte —
// and, at a decode tick's few hundred KB, latency.  So each slot's chain is
// split over the SMs: paged_decode.cuh's passes A and B run one warp per
// live page (B * Hkv * ceil(nb / 8) blocks of 256 threads, 32 * 8 at yi-6b
// with 8 slots of 1,024 rows), both products on the int8 tensor cores
// (mma.sync); only the fp32 carry stays serial, along each of the 1,024
// accumulators of a (slot, kv head), 8 blocks of 32 threads streaming the
// pages' int32 partials from the workspace.
#include "paged_decode.cuh"

// q int8 (B, Hkv, G, D), pools int8 (n_pages, P, Hkv, D), btab int32
// (B, nb), lengths int32 (B,), lut int32 (256,), M_idx/sh_idx int32 and
// inv_s_logit/out_scale fp32 scalars in device memory, out int8 like q, ws
// int32 of paged_decode_ws(...) elements (paged_decode.cuh).  Needs G <= 16,
// D <= 128 with D % 16 == 0, P <= 64, 16-byte aligned q and pools (the
// wrapper checks).
extern "C" int paged_decode_attention(const void* q, const void* kpool, const void* vpool,
                                      const void* btab, const void* lengths, const void* lut,
                                      const void* Mi, const void* shi, const void* inv,
                                      const void* osc, void* out, void* ws, int B, int Hkv,
                                      int G, int D, int P, int nb, void* stream) {
  const fq::Int8Pages pages{static_cast<const int8_t*>(kpool),
                            static_cast<const int8_t*>(vpool)};
  return fq::launch_paged_decode(q, pages, btab, lengths, lut, Mi, shi, inv, osc, out, ws, B,
                                 Hkv, G, D, P, nb, stream);
}
