// Continuous-batching decode attention over the contiguous KV stripe, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_qattention (Pallas grid (slot, kv head, KV block of bkv keys) over
// the cache-native (B, Smax, Hkv, D) stripe, per-slot lengths in scalar
// prefetch, dead blocks clamped onto the last live one and skipped).  The
// kernels are stripe_decode.cuh's three passes on the stripe's strides; the
// serving path's bkv is 512 (divisor_tile(512, Smax)).
//
// What bounds it on the H100: bytes — the K and V rows below each slot's
// length (2 * len * D per kv head; a masked key's numerator is 0, so the
// function needs no others) against a few int8 operations per byte — and,
// at a decode tick's few hundred KB, latency.  So each slot's rows are
// split over the SMs: passes A and B run one warp per live 16-row sub-tile
// (B * Hkv * spans CTAs of 8 sub-tiles; 32 * 8 at yi-6b with 8 slots of
// 1,024 rows, 128 of them with rows to run), both products on the int8 tensor cores
// (mma.sync); only the fp32 carry stays serial, once per bkv block along
// each of the G * D accumulators of a (slot, kv head).
#include "stripe_decode.cuh"

// q int8 (B, Hkv, G, D), k/v caches int8 with row t of slot b, kv head h at
// b * sb + h * sh + t * sr (the (B, Smax, Hkv, D) stripe: sb = Smax Hkv D,
// sh = D, sr = Hkv D), lengths int32 (B,), lut int32 (256,), M_idx/sh_idx
// int32 and inv_s_logit/out_scale fp32 scalars in device memory, out int8
// like q, ws int32 of stripe_decode_ws(B, Hkv, G, Smax, bkv) elements.
// Needs G <= 16, D <= 128 with D % 16 == 0, bkv <= 512 dividing Smax,
// 16-byte aligned q, caches and strides (the wrapper checks).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, const void* lut, const void* Mi,
                                const void* shi, const void* inv, const void* osc, void* out,
                                void* ws, int B, int Hkv, int G, int D, int Smax, int bkv,
                                int sb, int sh, int sr, void* stream) {
  return fq::launch_stripe_decode(q, kc, vc, lengths, lut, Mi, shi, inv, osc, out, ws, B, Hkv,
                                  G, D, Smax, bkv, sb, sh, sr, stream);
}
