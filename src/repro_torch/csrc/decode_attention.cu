// Continuous-batching decode attention over the contiguous KV stripe, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_qattention (Pallas grid (slot, kv head, KV block of bkv keys) over
// the cache-native (B, Smax, Hkv, D) stripe, per-slot lengths in scalar
// prefetch, dead blocks clamped onto the last live one and skipped).  The
// kernel is stripe_decode.cuh's stripe_decode_kernel on the CacheNative
// layout; its datapath and two-pass block design are described there.  The
// serving path's bkv is 512 (divisor_tile(512, Smax)).
//
// What bounds it on the H100: bytes — the K and V rows below each slot's
// length (a masked key's numerator is 0, so the function needs no others;
// this kernel also reads the masked tail of the last live block).  Like the
// paged kernel, it runs B * Hkv blocks (32 at yi-6b with 8 slots), each
// walking its stripe serially.
#include "stripe_decode.cuh"

// q int8 (B, Hkv, G, D), k/v caches int8 (B, Smax, Hkv, D), lengths int32
// (B,), lut int32 (256,), M_idx/sh_idx int32 and inv_s_logit/out_scale fp32
// scalars in device memory, out int8 like q.  Needs G <= 16, D <= 128 with
// D % 16 == 0, bkv <= 512 dividing Smax (the wrapper checks).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, const void* lut, const void* Mi,
                                const void* shi, const void* inv, const void* osc, void* out,
                                int B, int Hkv, int G, int D, int Smax, int bkv,
                                void* stream) {
  return fq::launch_stripe_decode<fq::CacheNative>(q, kc, vc, lengths, lut, Mi, shi, inv, osc,
                                                   out, B, Hkv, G, D, Smax, bkv, stream);
}
