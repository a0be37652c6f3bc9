// Paged continuous-batching decode attention for Hopper over the
// int4-packed KV pool (kv_bits=4).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_qattention_q4, which is the int8 paged decode kernel with
// only its KV tile load swapped for a fused nibble dequant
// (dequant_kv_tile).  The same holds here: paged_decode.cuh's passes on
// the Int4Pages loader, whose k16 / v16 read 16 packed bytes of one row of
// kv head h, sign-extend one nibble plane, multiply each code by the page's
// fp32 scale (one rounding), round half to even, clip to +-127 and hand
// int8 codes to the mma fragments in registers; the rest is the int8
// kernel's own.  No dequantized view of the pool is ever written.
//
// What bounds it on the H100: bytes, as for the int8 kernel, but each live
// page costs half the bytes (D/2 per row and kv head, plus 8 bytes of
// scales); the dequant adds a few CUDA-core operations per code.  Split
// across the SMs as the int8 kernel is (paged_decode_attention.cu).
#include "paged_decode.cuh"

// q int8 (B, Hkv, G, D), pools uint8 (n_pages, P, Hkv, D/2), ks/vs fp32
// (n_pages,), btab int32 (B, nb), lengths int32 (B,), lut int32 (256,),
// M_idx/sh_idx int32 and inv_s_logit/out_scale fp32 scalars in device
// memory, out int8 like q, ws int32 of paged_decode_ws(...) elements
// (paged_decode.cuh).  Needs G <= 16, D <= 128 with D % 32 == 0, P <= 64,
// 16-byte aligned q and pools (the wrapper checks).
extern "C" int paged_decode_attention_q4(const void* q, const void* kpool, const void* vpool,
                                         const void* ks, const void* vs, const void* btab,
                                         const void* lengths, const void* lut, const void* Mi,
                                         const void* shi, const void* inv, const void* osc,
                                         void* out, void* ws, int B, int Hkv, int G, int D,
                                         int P, int nb, void* stream) {
  const fq::Int4Pages pages{static_cast<const uint8_t*>(kpool),
                            static_cast<const uint8_t*>(vpool),
                            static_cast<const float*>(ks), static_cast<const float*>(vs)};
  return fq::launch_paged_decode(q, pages, btab, lengths, lut, Mi, shi, inv, osc, out, ws, B,
                                 Hkv, G, D, P, nb, stream);
}
