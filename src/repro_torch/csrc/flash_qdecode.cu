// Single-sequence GQA decode attention over an (Hkv, Smax, D) cache, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_qattention.py::
// flash_qdecode (Pallas grid (kv head, KV block of bkv keys), the whole
// query group of a kv head per program, a scalar cache_len masking keys at
// or past it).  It is decode_attention.cu's split at B = 1 with a
// one-element length: stripe_decode.cuh's three passes on the cache's
// (head, row) strides.  The reference updates the carry on every block; a
// block at or past cache_len adds num = 0 (a masked key's index clips to
// 255, whose table entry is 0) with f = exp(0) = 1, so skipping it, as
// these kernels do, is exact.
//
// What bounds it on the H100: bytes — the K and V rows below cache_len
// (2 * cache_len * D per kv head) against 4 * G * D int8 operations per
// row — and latency.  It runs Hkv * spans CTAs of 8 sub-tiles (32 with
// rows to run at yi-6b's 4 kv heads and 1,000 rows: narrower spans fill
// more SMs but lengthen the carry pass more, stripe_decode.cuh), both
// products on the int8 tensor cores (mma.sync).
#include "stripe_decode.cuh"

// q int8 (Hkv, G, D), k/v caches int8 with row t of kv head h at h * sh +
// t * sr (sh = Smax D, sr = D for a contiguous (Hkv, Smax, D) cache),
// cache_len int32 (1,), lut int32 (256,), M_idx/sh_idx int32 and
// inv_s_logit/out_scale fp32 scalars in device memory, out int8 like q, ws
// int32 of stripe_decode_ws(1, Hkv, G, Smax, bkv) elements.  Needs
// G <= 16, D <= 128 with D % 16 == 0, bkv <= 512 dividing Smax, 16-byte
// aligned q, caches and strides (the wrapper checks).
extern "C" int flash_qdecode(const void* q, const void* kc, const void* vc,
                             const void* cache_len, const void* lut, const void* Mi,
                             const void* shi, const void* inv, const void* osc, void* out,
                             void* ws, int Hkv, int G, int D, int Smax, int bkv, int sh,
                             int sr, void* stream) {
  return fq::launch_stripe_decode(q, kc, vc, cache_len, lut, Mi, shi, inv, osc, out, ws, 1,
                                  Hkv, G, D, Smax, bkv, 0, sh, sr, stream);
}
