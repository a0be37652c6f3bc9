// Integer LUT row softmax for Hopper: int32 logit codes (R, S) -> int8 Q0.7,
// each row read once into registers.
//
// Replaces the TPU kernel src/repro/kernels/quant_softmax.py::quant_softmax
// (Pallas, _softmax_kernel on the VPU, the 256-entry table as a one-hot
// select against an iota).  Same arithmetic, all int32 (core/qsoftmax.py::
// quant_softmax): m = row max; d = m - x (two's-complement wrap, as torch;
// masked codes sit 2^30 below the max); idx = clamp(rescale(d, M, sh, 9),
// 0, 255) (csrc/common.cuh); num = LUT[idx] from the q8 table; den =
// max(sum num, 1); p = clamp(floor((num * 128 + den / 2) / den), 0, 127).
// The sums are integers, so their order does not matter: any reduction is
// exact.
//
// What bounds it on the H100: bytes (4 per input code read, 1 per output
// code written; R = B*12*S rows of S <= 512 for BERT).  The design:
// - one warp per row, a grid of at most kCtasPerSm blocks of 8 warps an SM
//   walking the rows, the table copied into shared memory once per block;
// - S % 4 == 0 and S <= 512 (every BERT row): the row is read once into
//   registers, kJ 16-byte loads a lane (4 codes each), and max, index,
//   numerator and den come from registers in one pass; the numerators stay
//   there for the output, four codes packed into each 32-bit store;
// - the index is computed once per code, as min(min((m + b - x) >> pre,
//   2^15 - 1) * M + b' >> n, 255) where no rounding add can wrap (M and sh
//   checked once per block, the row's range once per row), else with the
//   reference's wrapping helpers; the division by den goes through a
//   reciprocal taken once per row (one correction step, exact below 2^32)
//   when the table lies in [0, 2^15) and S <= 2^16 (no sum can wrap), else
//   a floor division of the wrapped int32 operands;
// - any other row (a ragged S, an unaligned base, S > 512) takes kJ = 0:
//   three passes over the row (max, den, output) with scalar loads.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 4;    // blocks an SM at most; each copies the table once
static_assert(kThreads == fq::kLutSize, "one table entry per thread");

struct Params {     // the same in every block
  int M, sh;        // the index rescale's multiplier and shift
  int pre, n2, b1, b2;
  bool fast_idx;    // no rounding add of the index rescale can wrap (d >= 0)
  bool fast_out;    // table in [0, 2^15) and S <= 2^16: no sum can wrap
};

struct RowConsts {
  int m;            // the row max
  int mb;           // m + b1 (fast rows)
  bool fast;        // fast_idx and m - min + b1 <= INT_MAX
};

__device__ __forceinline__ RowConsts row_consts(int m, int mn, const Params& p) {
  m = __reduce_max_sync(0xffffffffu, m);
  mn = __reduce_min_sync(0xffffffffu, mn);
  const bool fast = p.fast_idx && static_cast<long long>(m) - mn + p.b1 <= INT_MAX;
  return RowConsts{m, static_cast<int>(static_cast<unsigned>(m) + p.b1), fast};
}

// The table entry of code x in a row with constants r; kFast: r.fast.
template <bool kFast>
__device__ __forceinline__ int numerator(int x, const RowConsts& r, const Params& p,
                                         const int* tab) {
  int idx;
  if constexpr (kFast) {
    // d + b1 = m + b1 - x lies in [b1, INT_MAX]: the reference's positive
    // branch, then v * M + b2 in [0, INT_MAX]
    const int v = min(static_cast<int>(static_cast<unsigned>(r.mb) - static_cast<unsigned>(x))
                          >> p.pre, 32767);
    idx = min((v * p.M + p.b2) >> p.n2, fq::kLutSize - 1);
  } else {
    idx = min(max(fq::rescale(fq::wrap_sub(r.m, x), p.M, p.sh, 9), 0), fq::kLutSize - 1);
  }
  return tab[idx];
}

struct Div {        // division by one row's den
  int den, half;
  unsigned inv;     // floor((2^32 - 1) / den), fast_out only
};

__device__ __forceinline__ Div make_div(int den_sum, const Params& p) {
  const int den = max(__reduce_add_sync(0xffffffffu, den_sum), 1);
  return Div{den, den >> 1, p.fast_out ? 0xffffffffu / static_cast<unsigned>(den) : 0u};
}

// The probability of numerator num; kFast: p.fast_out.
template <bool kFast>
__device__ __forceinline__ int prob(int num, const Div& d) {
  if constexpr (kFast) {   // a = num * 128 + den / 2 < 2^31: floor(a / den) from inv
    const unsigned a = static_cast<unsigned>(num) * 128u + static_cast<unsigned>(d.half);
    unsigned q = __umulhi(a, d.inv);
    q += a - q * static_cast<unsigned>(d.den) >= static_cast<unsigned>(d.den) ? 1u : 0u;
    return min(static_cast<int>(q), 127);
  } else {
    const int a = fq::wrap_add(fq::wrap_mul(num, 128), d.half);
    int q = a / d.den;                                // den >= 1
    if (a % d.den != 0 && a < 0) --q;                 // floor, as torch
    return min(max(q, 0), 127);
  }
}

// four probabilities (each in [0, 127]) packed little-endian
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>(__byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                                      0x5410u));
}

template <bool kFast, int kJ>
__device__ __forceinline__ int numerators(const int4 (&v)[kJ], int (&num)[kJ][4], int S,
                                          int lane, const RowConsts& r, const Params& p,
                                          const int* tab) {
  int den = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const bool live = (j * 32 + lane) * 4 < S;
    num[j][0] = live ? numerator<kFast>(v[j].x, r, p, tab) : 0;
    num[j][1] = live ? numerator<kFast>(v[j].y, r, p, tab) : 0;
    num[j][2] = live ? numerator<kFast>(v[j].z, r, p, tab) : 0;
    num[j][3] = live ? numerator<kFast>(v[j].w, r, p, tab) : 0;
    den = fq::wrap_add(den, fq::wrap_add(fq::wrap_add(num[j][0], num[j][1]),
                                         fq::wrap_add(num[j][2], num[j][3])));
  }
  return den;
}

template <bool kFast, int kJ>
__device__ __forceinline__ void store_probs(const int (&num)[kJ][4], int8_t* __restrict__ yr,
                                            int S, int lane, const Div& d) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c0 = (j * 32 + lane) * 4;
    if (c0 < S)
      __stcs(reinterpret_cast<int*>(yr + c0),
             pack4(prob<kFast>(num[j][0], d), prob<kFast>(num[j][1], d),
                   prob<kFast>(num[j][2], d), prob<kFast>(num[j][3], d)));
  }
}

// kJ > 0: a row of S <= 128 * kJ codes, S % 4 == 0, in registers.
template <int kJ>
__device__ __forceinline__ void row_in_registers(const int* __restrict__ xr,
                                                 int8_t* __restrict__ yr, int S, int lane,
                                                 const Params& p, const int* tab) {
  int4 v[kJ];
  int m = INT_MIN, mn = INT_MAX;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c0 = (j * 32 + lane) * 4;
    if (c0 < S) {
      v[j] = __ldcs(reinterpret_cast<const int4*>(xr + c0));
      m = max(m, max(max(v[j].x, v[j].y), max(v[j].z, v[j].w)));
      mn = min(mn, min(min(v[j].x, v[j].y), min(v[j].z, v[j].w)));
    } else {
      v[j] = make_int4(0, 0, 0, 0);
    }
  }
  const RowConsts r = row_consts(m, mn, p);
  int num[kJ][4];
  const int den = r.fast ? numerators<true, kJ>(v, num, S, lane, r, p, tab)
                         : numerators<false, kJ>(v, num, S, lane, r, p, tab);
  const Div d = make_div(den, p);
  if (p.fast_out)
    store_probs<true, kJ>(num, yr, S, lane, d);
  else
    store_probs<false, kJ>(num, yr, S, lane, d);
}

template <bool kFast>
__device__ __forceinline__ int den_in_passes(const int* __restrict__ xr, int S, int lane,
                                             const RowConsts& r, const Params& p,
                                             const int* tab) {
  int den = 0;
  for (int i = lane; i < S; i += 32)
    den = fq::wrap_add(den, numerator<kFast>(xr[i], r, p, tab));
  return den;
}

template <bool kFast, bool kFastOut>
__device__ __forceinline__ void probs_in_passes(const int* __restrict__ xr,
                                                int8_t* __restrict__ yr, int S, int lane,
                                                const RowConsts& r, const Params& p,
                                                const int* tab, const Div& d) {
  for (int i = lane; i < S; i += 32)
    yr[i] = static_cast<int8_t>(prob<kFastOut>(numerator<kFast>(xr[i], r, p, tab), d));
}

// kJ == 0: any S and alignment, three passes with scalar loads.
__device__ __forceinline__ void row_in_passes(const int* __restrict__ xr,
                                              int8_t* __restrict__ yr, int S, int lane,
                                              const Params& p, const int* tab) {
  int m = INT_MIN, mn = INT_MAX;
  for (int i = lane; i < S; i += 32) {
    const int x = xr[i];
    m = max(m, x);
    mn = min(mn, x);
  }
  const RowConsts r = row_consts(m, mn, p);
  const Div d = make_div(r.fast ? den_in_passes<true>(xr, S, lane, r, p, tab)
                                : den_in_passes<false>(xr, S, lane, r, p, tab), p);
  if (r.fast && p.fast_out) probs_in_passes<true, true>(xr, yr, S, lane, r, p, tab, d);
  else if (r.fast) probs_in_passes<true, false>(xr, yr, S, lane, r, p, tab, d);
  else if (p.fast_out) probs_in_passes<false, true>(xr, yr, S, lane, r, p, tab, d);
  else probs_in_passes<false, false>(xr, yr, S, lane, r, p, tab, d);
}

template <int kJ>
__global__ void __launch_bounds__(kThreads)
quant_softmax_kernel(const int* __restrict__ x, const int* __restrict__ lut,
                     const int* __restrict__ Mq, const int* __restrict__ shq,
                     int8_t* __restrict__ out, int R, int S) {
  __shared__ int tab[fq::kLutSize];
  const int e = lut[threadIdx.x];
  tab[threadIdx.x] = e;
  Params p;
  p.M = *Mq;
  p.sh = *shq;
  p.pre = max(p.sh + (9 - 30), 0);
  p.n2 = p.sh - p.pre;
  p.b1 = p.pre > 0 ? fq::shl(1, p.pre - 1) : 0;
  p.b2 = p.n2 > 0 ? fq::shl(1, p.n2 - 1) : 0;
  p.fast_idx = p.sh >= 0 && p.pre <= 30 && p.n2 <= 30 && p.M >= 0 &&
               32767LL * p.M + p.b2 <= INT_MAX;
  p.fast_out = __syncthreads_and(e >= 0 && e < 32768) && S <= 65536;
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < R; row += gridDim.x * kWarps) {
    const int* xr = x + static_cast<size_t>(row) * S;
    int8_t* yr = out + static_cast<size_t>(row) * S;
    if constexpr (kJ > 0)
      row_in_registers<kJ>(xr, yr, S, lane, p, tab);
    else
      row_in_passes(xr, yr, S, lane, p, tab);
  }
}

template <int kJ>
void launch(const void* x, const void* lut, const void* Mq, const void* shq, void* out, int R,
            int S, int grid, cudaStream_t stream) {
  quant_softmax_kernel<kJ><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(lut), static_cast<const int*>(Mq),
      static_cast<const int*>(shq), static_cast<int8_t*>(out), R, S);
}

}  // namespace

// x int32 (R, S) row-major, lut int32 (256,), Mq/shq int32 scalars in device
// memory, out int8 (R, S); sms: the card's SMs.
extern "C" int quant_softmax(const void* x, const void* lut, const void* Mq,
                             const void* shq, void* out, int R, int S, int sms,
                             void* stream) {
  if (R <= 0 || S <= 0) return 0;
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + kWarps - 1) / kWarps;
  const int grid = blocks < kCtasPerSm * sms ? blocks : kCtasPerSm * sms;
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec && S <= 128) launch<1>(x, lut, Mq, shq, out, R, S, grid, s);
  else if (vec && S <= 256) launch<2>(x, lut, Mq, shq, out, R, S, grid, s);
  else if (vec && S <= 512) launch<4>(x, lut, Mq, shq, out, R, S, grid, s);
  else launch<0>(x, lut, Mq, shq, out, R, S, grid, s);
  return static_cast<int>(cudaGetLastError());
}
