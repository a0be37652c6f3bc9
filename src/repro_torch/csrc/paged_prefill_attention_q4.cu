// Paged chunked-prefill attention for Hopper over the int4-packed KV pool
// (kv_bits=4).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::
// paged_prefill_qattention_q4, the int8 paged prefill kernel with its KV
// tile load swapped for a fused nibble dequant.  Here: paged_prefill.cuh's
// kernel on the Int4Pages loader, which stages each page's (P, D/2) packed
// bytes of kv head h by cp.async and turns them into int8 codes in shared
// memory one page ahead of their use — sign-extended nibble planes times
// the page's fp32 scale, one rounding, half to even, clipped to +-127 —
// then the int8 kernel's tensor-core datapath and epilogue.
//
// What bounds it on the H100: as the int8 prefill kernel (the serial page
// walk of the longest rows), with half the bytes per page.
#include "paged_prefill.cuh"

// q int8 (B, H, S, D) and out int8 like q through their element strides,
// pools uint8 (n_pages, P, Hkv, D/2), ks/vs fp32 (n_pages,), btab int32 (B,
// nb), pos0 int32 (B,), lut int32 (256,) of codes in [0, 127], M_idx/sh_idx
// int32 and inv_s_logit/out_scale fp32 scalars in device memory; gh q heads
// per block.  Needs D <= 128, D % 32 == 0, P <= 64, H % Hkv == 0, gh
// dividing H / Hkv and at most 4 (the wrapper checks).
extern "C" int paged_prefill_attention_q4(const void* q, const void* kpool,
                                          const void* vpool, const void* ks, const void* vs,
                                          const void* btab, const void* pos0, const void* lut,
                                          const void* Mi, const void* shi, const void* inv,
                                          const void* osc, void* out, int B, int H, int S,
                                          int Hkv, int D, int P, int nb, int gh, int qsb,
                                          int qsh, int qss, int osb, int osh, int oss,
                                          void* stream) {
  const fq::Int4Pages pages{static_cast<const uint8_t*>(kpool),
                            static_cast<const uint8_t*>(vpool),
                            static_cast<const float*>(ks), static_cast<const float*>(vs)};
  return fq::launch_paged_prefill(q, pages, btab, pos0, lut, Mi, shi, inv, osc, out, B, H,
                                  S, Hkv, D, P, nb, gh, qsb, qsh, qss, osb, osh, oss, stream);
}

// Dynamic shared memory of one launch over P-row pages of head dim D.
extern "C" int paged_prefill_attention_q4_smem(int P, int D) {
  return fq::paged_prefill_smem<fq::Int4Pages>(P, D);
}
