// Single-sequence GQA decode attention over an (Hkv, Smax, D) cache, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_qattention.py::
// flash_qdecode (Pallas grid (kv head, KV block of bkv keys), the whole
// query group of a kv head per program, a scalar cache_len masking keys at
// or past it).  It is decode_attention.cu's stripe kernel at B = 1 with a
// one-element length: stripe_decode.cuh's stripe_decode_kernel on the
// HeadMajor layout (row stride D, head stride Smax * D).  The reference
// updates the carry on every block; a block at or past cache_len adds
// num = 0 (a masked key's index clips to 255, whose table entry is 0) with
// f = exp(0) = 1, so skipping it, as this kernel does, is exact.
//
// What bounds it on the H100: bytes — the K and V rows below cache_len
// (2 * cache_len * D per kv head) against 4 * G * D int8 operations per
// row.  It runs Hkv blocks (4 at yi-6b), each walking its rows serially:
// a fraction of the 132 SMs; splitting the rows across blocks
// (flash-decoding) is later work.
#include "stripe_decode.cuh"

// q int8 (Hkv, G, D), k/v caches int8 (Hkv, Smax, D), cache_len int32 (1,),
// lut int32 (256,), M_idx/sh_idx int32 and inv_s_logit/out_scale fp32
// scalars in device memory, out int8 like q.  Needs G <= 16, D <= 128 with
// D % 16 == 0, bkv <= 512 dividing Smax (the wrapper checks).
extern "C" int flash_qdecode(const void* q, const void* kc, const void* vc,
                             const void* cache_len, const void* lut, const void* Mi,
                             const void* shi, const void* inv, const void* osc, void* out,
                             int Hkv, int G, int D, int Smax, int bkv, void* stream) {
  return fq::launch_stripe_decode<fq::HeadMajor>(q, kc, vc, cache_len, lut, Mi, shi, inv, osc,
                                                 out, 1, Hkv, G, D, Smax, bkv, stream);
}
