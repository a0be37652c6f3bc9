// The per-page step shared by the paged prefill and paged decode kernels:
// one block holds R query rows of one (slot, kv head) and walks the slot's
// block-table chain page by page with the reference's exact datapath
// (kernels/ref.py::paged_*_qattention_ref):
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

// Copies one page's K and V rows of kv head h (pool layout
// (n_pages, P, Hkv, D)) into shared memory, 16 bytes per thread-load.
template <int NT>
__device__ __forceinline__ void load_page(PageSmem& sm, const int8_t* kpool,
                                          const int8_t* vpool, int page, int P,
                                          int Hkv, int h, int D) {
  const int vecs = D / 16;
  for (int e = threadIdx.x; e < P * vecs; e += NT) {
    const int r = e / vecs;
    const int c = (e % vecs) * 16;
    const size_t g = (static_cast<size_t>(page) * P + r) * Hkv * D + static_cast<size_t>(h) * D + c;
    *reinterpret_cast<int4*>(&sm.k[r * D + c]) = *reinterpret_cast<const int4*>(kpool + g);
    *reinterpret_cast<int4*>(&sm.v[r * D + c]) = *reinterpret_cast<const int4*>(vpool + g);
  }
}

template <int NT>
__device__ __forceinline__ void init_rows(PageSmem& sm, const int* lut, int R) {
  for (int i = threadIdx.x; i < kLutSize; i += NT) sm.lut[i] = lut[i];
  for (int r = threadIdx.x; r < R; r += NT) {
    sm.m[r] = kNegInit;
    sm.den[r] = 0.0f;
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
  for (int r = tid; r < R; r += NT) {
    int lm = sm.s[r * P];
    for (int c = 1; c < P; ++c) lm = max(lm, sm.s[r * P + c]);
    const int m_old = sm.m[r];
    const int m_new = max(m_old, lm);
    float f = expf(__fmul_rn(static_cast<float>(wrap_sub(m_old, m_new)), inv));
    if (m_old == kNegInit) f = 0.0f;
    sm.m_new[r] = m_new;
    sm.f[r] = f;
  }
  __syncthreads();
  for (int e = tid; e < R * P; e += NT) {
    int idx = rescale(wrap_sub(sm.m_new[e / P], sm.s[e]), Mi, shi, 9);
    idx = min(max(idx, 0), kLutSize - 1);
    sm.s[e] = sm.lut[idx];
  }
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    int den_b = 0;
    for (int c = 0; c < P; ++c) den_b += sm.s[r * P + c];
    sm.den[r] = __fadd_rn(__fmul_rn(sm.den[r], sm.f[r]), static_cast<float>(den_b));
    sm.m[r] = sm.m_new[r];
  }
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
