// The paged attention kernels' shared datapath (kernels/ref.py::
// paged_*_qattention_ref), per page of P keys and query row:
//
//   s    = int8 q . int8 k                  (int32)
//   s    = kpos <= qpos ? s : s - 2^30      (causal / length mask)
//   m'   = max(m, rowmax s)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num                (fp32, f = exp((m - m') * inv),
//   acc  = acc * f + num . int8 v            f = 0 while m is the initial
//   m    = m'                                value)
//
// Products and sums of the fp32 carry are rounded one operation at a time
// (__fmul_rn / __fadd_rn: no FMA contraction), exp is the accurate expf
// (no fast math), int -> float conversions round to nearest, as in PyTorch
// eager and XLA.  The epilogue is round(acc / max(den, 1) * out_scale)
// clipped to +-127 with rintf (half to even, as torch.round / jnp.round).
//
// Here: the page loaders of the paged kernels (paged_decode.cuh,
// paged_prefill.cuh), the LUT index and row max of the tensor-core
// attention kernels (paged_prefill.cuh, flash_qattention.cu) and the
// epilogue (attn_out).
#pragma once

#include <climits>

#include "common.cuh"

namespace fq {

constexpr int kMaxP = 64;     // page size
constexpr int kMaxD = 128;    // head dim

// Page loaders: the paged kernels are templates on them.  k16 / v16 return
// the 16 int8 codes of columns [col, col + 16) of one row of a page
// straight into registers (the split decode kernels, paged_decode.cuh);
// paged_prefill.cuh stages whole pages through shared memory (its
// stage_page / unpack_page overloads).

// The int8 pool (n_pages, P, Hkv, D).
struct Int8Pages {
  static constexpr bool kPacked = false;
  const int8_t* k;
  const int8_t* v;

  __device__ __forceinline__ uint4 k16(int page, int row, int h, int Hkv, int D, int P,
                                       int col) const {
    return codes16(k, page, row, h, Hkv, D, P, col);
  }
  __device__ __forceinline__ uint4 v16(int page, int row, int h, int Hkv, int D, int P,
                                       int col) const {
    return codes16(v, page, row, h, Hkv, D, P, col);
  }
  static __device__ __forceinline__ uint4 codes16(const int8_t* pool, int page, int row, int h,
                                                  int Hkv, int D, int P, int col) {
    return __ldg(reinterpret_cast<const uint4*>(
        pool + ((static_cast<size_t>(page) * P + row) * Hkv + h) * D + col));
  }
};

// One int4 code under the page's fp32 scale: clip(round(c4 * scale), +-127),
// the single-rounding product and half-to-even round of core/packing.py::
// dequant_int4_codes.
__device__ __forceinline__ unsigned dequant_code(int c4, float scale) {
  const float y = fminf(fmaxf(rintf(__fmul_rn(static_cast<float>(c4), scale)), -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(y)) & 0xffu;
}

// One nibble plane of 16 packed bytes -> 16 codes: the low nibbles (hi
// false) or the high ones, each sign-extended as ((x & 15) ^ 8) - 8 and
// dequantized.
__device__ __forceinline__ uint4 dequant_plane16(uint4 w, bool hi, float scale) {
  const unsigned in[4] = {w.x, w.y, w.z, w.w};
  unsigned o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = static_cast<int>((in[i] >> (8 * j + (hi ? 4 : 0))) & 15u);
      o[i] |= dequant_code((x ^ 8) - 8, scale) << (8 * j);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The int4-packed pool (n_pages, P, Hkv, D/2) uint8, nibble-planar along the
// head dim (the low nibbles hold columns [0, D/2), the high ones [D/2, D)),
// with one fp32 scale per page for K (ks) and one for V (vs): the page is
// read at half the bytes and dequantized on the card.  Needs D % 32 == 0.
struct Int4Pages {
  static constexpr bool kPacked = true;
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;

  // columns [col, col + 16) sit in the low plane of packed bytes [col, +16)
  // when col < D/2, else in the high plane of bytes [col - D/2, +16)
  __device__ __forceinline__ uint4 k16(int page, int row, int h, int Hkv, int D, int P,
                                       int col) const {
    return codes16(k, ks[page], page, row, h, Hkv, D, P, col);
  }
  __device__ __forceinline__ uint4 v16(int page, int row, int h, int Hkv, int D, int P,
                                       int col) const {
    return codes16(v, vs[page], page, row, h, Hkv, D, P, col);
  }
  static __device__ __forceinline__ uint4 codes16(const uint8_t* pool, float scale, int page,
                                                  int row, int h, int Hkv, int D, int P,
                                                  int col) {
    const int half = D / 2;
    const bool hi = col >= half;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
        pool + ((static_cast<size_t>(page) * P + row) * Hkv + h) * half + (hi ? col - half : col)));
    return dequant_plane16(w, hi, scale);
  }
};

// The LUT index of a numerator, clip(rescale(x, M_idx, sh_idx, 9), 0, 255)
// (common.cuh), for x = m' - s >= 0: a valid key's score never exceeds the
// running max and |s| < 2^31 - 2^30, so only the first rounding shift's
// non-negative branch is taken.  The shifts and biases are computed once:
// sra(v, n) for n >= 0 is v >> min(n, 31), and sh_idx >= 0 keeps both
// shifts non-negative.
struct LutIndex {
  int M, n1, b1, n2, b2;
  __device__ __forceinline__ LutIndex(int M_idx, int shift) : M(M_idx) {
    const int pre = max(shift - 21, 0), post = shift - pre;
    n1 = min(pre, 31);
    b1 = pre > 0 ? shl(1, pre - 1) : 0;
    n2 = min(post, 31);
    b2 = post > 0 ? shl(1, post - 1) : 0;
  }
  __device__ __forceinline__ int operator()(int x) const {
    int v = wrap_add(x, b1) >> n1;
    v = min(max(v, -32768), 32767);
    const int y = wrap_mul(v, M);
    const int z =
        y >= 0 ? wrap_add(y, b2) >> n2 : wrap_sub(0, wrap_add(wrap_sub(0, y), b2) >> n2);
    return min(max(z, 0), kLutSize - 1);
  }
};

// The max over the four lanes (t) that hold one row of an mma C fragment.
__device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ int8_t attn_out(float acc, float den, float out_scale) {
  const float o = __fmul_rn(__fdiv_rn(acc, fmaxf(den, 1.0f)), out_scale);
  return static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.0f), 127.0f));
}

}  // namespace fq
