// The per-page step of the paged prefill kernels, int8 and int4-packed
// pools alike (only the page loader differs, below), and the page loaders
// the paged decode kernels share (paged_decode.cuh splits the same datapath
// into passes): one block holds R query rows of one (slot, kv head) and
// walks the slot's block-table chain page by page with the reference's
// exact datapath (kernels/ref.py::paged_*_qattention_ref):
//
//   s    = int8 q . int8 k                  (int32, __dp4a)
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
#pragma once

#include "common.cuh"

namespace fq {

constexpr int kMaxP = 64;     // page size
constexpr int kMaxD = 128;    // head dim
constexpr int kMaxRows = 64;  // query rows per block

struct PageSmem {
  alignas(16) int8_t q[kMaxRows * kMaxD];
  alignas(16) int8_t k[kMaxP * kMaxD];
  alignas(16) int8_t v[kMaxP * kMaxD];
  int s[kMaxRows * kMaxP];    // scores, then LUT numerators
  int qpos[kMaxRows];
  int m[kMaxRows];
  int m_new[kMaxRows];
  float f[kMaxRows];
  float den[kMaxRows];
  int lut[kLutSize];
};

// Page loaders: each copies one pool page's K and V rows of kv head h into
// sm.k / sm.v as int8 codes, (P, D) row-major.  The kernels are templates
// on the loader; everything after the load is the same datapath.  k16 / v16
// return the 16 int8 codes of columns [col, col + 16) of one row of a page
// straight into registers (the split decode kernels, paged_decode.cuh).

// The int8 pool (n_pages, P, Hkv, D): 16 bytes per thread-load.
struct Int8Pages {
  const int8_t* k;
  const int8_t* v;

  template <int NT>
  __device__ __forceinline__ void load(PageSmem& sm, int page, int P, int Hkv, int h,
                                       int D) const {
    const int vecs = D / 16;
    for (int e = threadIdx.x; e < P * vecs; e += NT) {
      const int r = e / vecs;
      const int c = (e % vecs) * 16;
      const size_t g = (static_cast<size_t>(page) * P + r) * Hkv * D +
                       static_cast<size_t>(h) * D + c;
      *reinterpret_cast<int4*>(&sm.k[r * D + c]) = *reinterpret_cast<const int4*>(k + g);
      *reinterpret_cast<int4*>(&sm.v[r * D + c]) = *reinterpret_cast<const int4*>(v + g);
    }
  }

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

// 16 packed bytes -> 16 low-plane codes at lo[0..16) and 16 high-plane codes
// at hi[0..16): each nibble sign-extended as ((x & 15) ^ 8) - 8, dequantized.
__device__ __forceinline__ void dequant16(int8_t* lo, int8_t* hi, int4 w, float scale) {
  const unsigned in[4] = {static_cast<unsigned>(w.x), static_cast<unsigned>(w.y),
                          static_cast<unsigned>(w.z), static_cast<unsigned>(w.w)};
  unsigned lo_w[4], hi_w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo_w[i] = 0;
    hi_w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = static_cast<int>((in[i] >> (8 * j)) & 0xffu);
      lo_w[i] |= dequant_code(((x & 15) ^ 8) - 8, scale) << (8 * j);
      hi_w[i] |= dequant_code((((x >> 4) & 15) ^ 8) - 8, scale) << (8 * j);
    }
  }
  *reinterpret_cast<int4*>(lo) = make_int4(static_cast<int>(lo_w[0]), static_cast<int>(lo_w[1]),
                                           static_cast<int>(lo_w[2]), static_cast<int>(lo_w[3]));
  *reinterpret_cast<int4*>(hi) = make_int4(static_cast<int>(hi_w[0]), static_cast<int>(hi_w[1]),
                                           static_cast<int>(hi_w[2]), static_cast<int>(hi_w[3]));
}

// One nibble plane of 16 packed bytes -> 16 codes: the low nibbles (hi
// false) or the high ones, sign-extended and dequantized per code exactly as
// dequant16 does.
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
// read at half the bytes and dequantized on its way into shared memory.
// 16 packed bytes (32 codes) per thread-load; needs D % 32 == 0.
struct Int4Pages {
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;

  template <int NT>
  __device__ __forceinline__ void load(PageSmem& sm, int page, int P, int Hkv, int h,
                                       int D) const {
    const int half = D / 2;
    const int vecs = half / 16;
    const float sk = ks[page];
    const float sv = vs[page];
    for (int e = threadIdx.x; e < P * vecs; e += NT) {
      const int r = e / vecs;
      const int c = (e % vecs) * 16;
      const size_t g = (static_cast<size_t>(page) * P + r) * Hkv * half +
                       static_cast<size_t>(h) * half + c;
      dequant16(&sm.k[r * D + c], &sm.k[r * D + half + c],
                *reinterpret_cast<const int4*>(k + g), sk);
      dequant16(&sm.v[r * D + c], &sm.v[r * D + half + c],
                *reinterpret_cast<const int4*>(v + g), sv);
    }
  }

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

template <int NT>
__device__ __forceinline__ void init_rows(PageSmem& sm, const int* lut, int R) {
  for (int i = threadIdx.x; i < kLutSize; i += NT) sm.lut[i] = lut[i];
  for (int r = threadIdx.x; r < R; r += NT) {
    sm.m[r] = kNegInit;
    sm.den[r] = 0.0f;
  }
}

// The carry update of one tile of L keys for R rows, with the scores s
// (R x L, row r at s + r * ld) already written and a barrier passed: the
// tile's row max m', the rescale factor f, the LUT numerators in place of
// the scores, then den = den * f + sum num and m = m'.  The order of the
// operations is the exactness contract with kernels/ref.py; the caller then
// folds f and the numerators into its accumulator (f and the numerators
// are final when this returns, without a further barrier).  A row stride
// ld that is odd modulo 32 keeps the per-row loops free of bank conflicts.
template <int NT>
__device__ __forceinline__ void carry_update(int* s, int R, int L, int ld, int* m, int* m_new,
                                             float* f, float* den, const int* lut, int Mi,
                                             int shi, float inv) {
  const int tid = threadIdx.x;
  for (int r = tid; r < R; r += NT) {
    int lm = s[r * ld];
    for (int c = 1; c < L; ++c) lm = max(lm, s[r * ld + c]);
    const int m_old = m[r];
    const int mn = max(m_old, lm);
    float fr = expf(__fmul_rn(static_cast<float>(wrap_sub(m_old, mn)), inv));
    if (m_old == kNegInit) fr = 0.0f;
    m_new[r] = mn;
    f[r] = fr;
  }
  __syncthreads();
  for (int e = tid; e < R * L; e += NT) {
    const int r = e / L;
    const int c = e % L;
    int idx = rescale(wrap_sub(m_new[r], s[r * ld + c]), Mi, shi, 9);
    idx = min(max(idx, 0), kLutSize - 1);
    s[r * ld + c] = lut[idx];
  }
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    int den_b = 0;
    for (int c = 0; c < L; ++c) den_b += s[r * ld + c];
    den[r] = __fadd_rn(__fmul_rn(den[r], f[r]), static_cast<float>(den_b));
    m[r] = m_new[r];
  }
}

// One page of the online update for R rows; kbase = first key position of
// the page.  Ends with a barrier, so the caller may overwrite sm.k/sm.v.
template <int NT, int ACC>
__device__ __forceinline__ void page_step(PageSmem& sm, int R, int P, int D, int kbase,
                                          int Mi, int shi, float inv, float (&acc)[ACC]) {
  const int tid = threadIdx.x;
  for (int e = tid; e < R * P; e += NT) {
    const int r = e / P;
    const int c = e % P;
    const int* qw = reinterpret_cast<const int*>(&sm.q[r * D]);
    const int* kw = reinterpret_cast<const int*>(&sm.k[c * D]);
    int s = 0;
    for (int w = 0; w < D / 4; ++w) s = __dp4a(qw[w], kw[w], s);
    if (kbase + c > sm.qpos[r]) s = wrap_sub(s, kMaskOffset);
    sm.s[e] = s;
  }
  __syncthreads();
  carry_update<NT>(sm.s, R, P, P, sm.m, sm.m_new, sm.f, sm.den, sm.lut, Mi, shi, inv);
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int e = tid + NT * j;
    if (e < R * D) {
      const int r = e / D;
      const int d = e % D;
      int pv = 0;
      for (int c = 0; c < P; ++c) pv += sm.s[r * P + c] * static_cast<int>(sm.v[c * D + d]);
      acc[j] = __fadd_rn(__fmul_rn(acc[j], sm.f[r]), static_cast<float>(pv));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int8_t attn_out(float acc, float den, float out_scale) {
  const float o = __fmul_rn(__fdiv_rn(acc, fmaxf(den, 1.0f)), out_scale);
  return static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.0f), 127.0f));
}

}  // namespace fq
