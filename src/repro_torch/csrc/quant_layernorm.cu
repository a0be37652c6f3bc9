// Integer LayerNorm / RMSNorm for Hopper: each row read once into registers,
// one block reduction per row.
//
// Replaces the TPU kernel src/repro/kernels/quant_layernorm.py::
// quant_layernorm (Pallas, _ln_kernel on the VPU).  Same arithmetic, all
// int32 (core/qlayernorm.py): rounded mean (LN only; half away from zero,
// integer division only on non-negative operands), centred sum of squares,
// var = max(rounded mean of squares, eps), Newton rsqrt as mantissa/exponent
// (fixedpoint.rsqrt_mantexp), gamma multiply, aligned beta add, Q15
// rescale, clip to +-127.  The exponent of rsqrt_mantexp is 31 - clz(var)
// instead of floor(log2(float(var))); the two agree on the whole LN
// variance range [1, 2^16), which the CPU tests check for every value.
//
// What bounds it on the H100: bytes (one int8 row in, one out; 1.3 us at
// R=512 N=4096), then its integer work, which does not overlap the loads
// at a few rows a block: ~15 operations per code on the merged path (a
// PRMT and an IMAD for (x - m) * y, three for n_q's rounding shift, an
// IMAD for gamma and beta, two for the clamp, six for the output's two
// rounding shifts, and a share of the pack and of the moments' __dp4a),
// most at half the float rate.  The design:
// - a thread holds 16 codes of the row in each of its kC chunks (one
//   16-byte load each, two chunks up to N = 8192, four up to 16384) from
//   the load to the store; the next row is loaded before the current one is
//   reduced, and the scalars and the first row before gamma and beta;
// - one block reduction of (sum x, sum x^2) per row (__dp4a,
//   __reduce_add_sync, the warps' partials in shared memory, one barrier);
//   the centred sum of squares is sum x^2 - 2 m sum x + N m^2 with the
//   rounded mean m, exact in int32 for N <= 16384 (every term and the true
//   value lie below 2^31);
// - the grid holds at most kWarpsPerSm warps an SM; each block walks its
//   rows with its columns' gamma and beta in registers, loaded once;
// - divisions by N go through a reciprocal taken once per block (one
//   correction step, exact for every numerator below 2^32); the rounding
//   shifts are (v + b - [v < 0]) >> n and the int16 clamp and the +-127
//   clip merge into one clamp of the accumulator where nothing wraps: a
//   warp takes that path when the output scale's shift is 23..52 (scales
//   from 2^-38 to 2^-8) and its columns' |beta| keeps every accumulator
//   below 2^31 (|n_q * gamma| < 2^30 since rsqrt's mantissa is at most
//   2^15), and the reference's wrapping helpers (common.cuh) otherwise;
// - N % 16 != 0 or an unaligned base (an offset row slice) loads and stores
//   the same chunks byte by byte (kVec = false).
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kChunk = 16;                   // codes per 16-byte chunk
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWarpsPerSm = 8;               // the grid's warps an SM at most

// 16 codes from c0 (zeros past N); kStream: read once (x), else kept in
// the caches (gamma, which every block reads)
template <bool kVec, bool kStream>
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ row, int c0, int N) {
  if constexpr (kVec) {
    if (c0 >= N) return make_int4(0, 0, 0, 0);
    const int4* p = reinterpret_cast<const int4*>(row + c0);
    return kStream ? __ldcs(p) : __ldg(p);
  } else {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (c0 + j < N)
        w[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(row[c0 + j])) << (8 * (j % 4));
    return make_int4(w[0], w[1], w[2], w[3]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(int8_t* __restrict__ row, int c0, int N, int4 v) {
  if constexpr (kVec) {
    if (c0 < N) __stcs(reinterpret_cast<int4*>(row + c0), v);
  } else {
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (c0 + j < N) row[c0 + j] = static_cast<int8_t>(w[j / 4] >> (8 * (j % 4)));
  }
}

__device__ __forceinline__ int word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte j of a 16-byte chunk, sign-extended: one PRMT whose selector
// nibbles with bit 3 set replicate the byte's sign
__device__ __forceinline__ int code(const int4& v, int j) {
  const unsigned s = j % 4;
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r) : "r"(word(v, j / 4)), "r"(0), "r"((s | 8u) * 0x1110u + s));
  return r;
}

// four codes (each in [-128, 127]) packed little-endian
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>(__byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                                      0x5410u));
}

// floor(a / N) for any a < 2^32, from inv = floor((2^32 - 1) / N): the
// product's high word is floor(a / N) or one less.
__device__ __forceinline__ unsigned div_n(unsigned a, unsigned n, unsigned inv) {
  const unsigned q = __umulhi(a, inv);
  return q + (a - q * n >= n ? 1u : 0u);
}

// The rescale of the output (fixedpoint.rescale(acc, M, sh, 8), then the
// clip to +-127), as each warp evaluates it.
enum Mode {
  kExact,    // the reference's wrapping helpers (common.cuh)
  kMerged,   // shifts (v + b - [v < 0]) >> n and one clamp of acc (below)
};

struct Out {     // the same in every block
  int M, sh;     // Q15 multiplier and shift
  int pre, b1, n2, b2;
  int ahi;       // kMerged: clamp acc to [-ahi, ahi] and clip nothing else
  bool merge;    // kMerged may be taken (M and sh; beta is checked per warp)
};

__device__ Out out_consts(int M, int sh) {
  Out o;
  o.M = M;
  o.sh = sh;
  o.pre = max(o.sh + (8 - 30), 0);
  o.n2 = o.sh - o.pre;
  o.b1 = o.pre > 0 ? fq::shl(1, o.pre - 1) : 0;
  o.b2 = o.n2 > 0 ? fq::shl(1, o.n2 - 1) : 0;
  // With vhi the largest v <= 2^15 - 1 whose rescale (v * M + b2) >> n2 is
  // at most 127, clip127(rescale(clamp16(v))) = rescale(clamp(v, -vhi,
  // vhi)) when that rescale is exactly 127 (M > 0 makes it monotone and
  // odd), and clamp(round1(acc), -vhi, vhi) = round1(clamp(acc, -ahi,
  // ahi)); with pre, n2 >= 1 both rounding shifts take acc's sign, and
  // |v| <= 2^15 keeps v * M + b2 from wrapping.  Every Q15 multiplier at
  // shift 23..52 qualifies (tests/test_torch_kernels.py checks them all).
  o.merge = false;
  o.ahi = 0;
  if (o.M > 0 && o.pre >= 1 && o.n2 >= 1 && o.pre <= 30 && o.n2 <= 30 &&
      32768LL * o.M + o.b2 <= INT_MAX) {
    // vhi = floor(lim / M), the largest v with v * M <= lim
    const long long v = min(((128LL << o.n2) - o.b2 - 1) / o.M, 32767LL);
    o.merge = ((v * o.M + o.b2) >> o.n2) == 127;
    o.ahi = static_cast<int>(min((v + 1) * (1LL << o.pre) - o.b1 - 1,
                                 static_cast<long long>(INT_MAX)));
  }
  return o;
}

struct Row {     // one row's constants, the same in every thread
  int y, my;     // rsqrt's Q15 mantissa and mean * y
  int b, n;      // n_q = (prod + b + [prod < 0]) >> n, prod = x * y - my
};

// One row's constants from its chunks: one block reduction of (sum x,
// sum x^2), the rounded mean, the variance, rsqrt_mantexp.
template <int kC>
__device__ __forceinline__ Row row_consts(const int4 (&xv)[kC], int2* red, int N,
                                          unsigned inv_n, int sub_mean, int eps) {
  int sx = 0, sq = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sx = __dp4a(word(xv[c], i), 0x01010101, sx);
      sq = __dp4a(word(xv[c], i), word(xv[c], i), sq);
    }
  sx = __reduce_add_sync(0xffffffffu, sx);
  sq = __reduce_add_sync(0xffffffffu, sq);
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[threadIdx.x / 32] = make_int2(sx, sq);
  __syncthreads();
  const int2 part = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : make_int2(0, 0);
  sx = __reduce_add_sync(0xffffffffu, part.x);
  sq = __reduce_add_sync(0xffffffffu, part.y);
  const unsigned half = static_cast<unsigned>(N) / 2;
  int mean = 0;
  unsigned ss = static_cast<unsigned>(sq);
  if (sub_mean) {
    const int q = static_cast<int>(div_n(static_cast<unsigned>(abs(sx)) + half, N, inv_n));
    mean = sx >= 0 ? q : -q;
    // sum (x - m)^2 = sum x^2 - 2 m sum x + N m^2, exact modulo 2^32 and so
    // exactly, as the true value lies in [0, 2^31)
    ss = ss - 2u * static_cast<unsigned>(mean) * static_cast<unsigned>(sx)
         + static_cast<unsigned>(N) * static_cast<unsigned>(mean * mean);
  }
  const int var = max(static_cast<int>(div_n(ss + half, N, inv_n)), eps);
  // rsqrt_mantexp(var): y Q15 mantissa, se exponent
  const int xv1 = max(var, 1);
  const int e = 31 - __clz(xv1);
  const int se = e >> 1;
  const int sh = 14 - 2 * se;
  const int m14 = sh >= 0 ? fq::shl(xv1, sh) : fq::sra(xv1, -sh);
  int y = m14 < (1 << 15) ? 27853 : 19661;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int y2 = fq::sra(fq::wrap_mul(y, y), 15);
    const int t = fq::sra(fq::wrap_mul(m14, y2), 15);
    y = fq::sra(fq::wrap_mul(y, (3 << 14) - t), 15);
  }
  return Row{y, mean * y, 1 << se, se + 1};
}

template <int kC>
struct Cols {    // this thread's gamma and beta, loaded once per block
  static constexpr bool kUnpacked = kC == 2;
  int4 gp[kC];                                   // gamma, packed
  int g[kUnpacked ? kC * kChunk : 1];            // gamma, a code a register
  int bt[kC][kChunk];
  __device__ __forceinline__ int gamma(int c, int j) const {
    if constexpr (kUnpacked) return g[c * kChunk + j];
    else return code(gp[c], j);
  }
};

// One row's chunks -> int8 codes.
template <Mode kMode, int kC>
__device__ __forceinline__ void normalize(const int4 (&xv)[kC], int4 (&ov)[kC],
                                          const Cols<kC>& cols, const Row& r, const Out& o) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    int res[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      // n_q = rshift_round((x - m) * y, se + 1), Q14 of (x - m) / sigma:
      // |(x - m) * y| < 2^23, so the rounding add cannot wrap
      const int prod = code(xv[c], j) * r.y - r.my;
      const int nq = (prod + r.b + (prod >> 31)) >> r.n;
      int v;
      if constexpr (kMode == kMerged) {
        const int acc = min(max(nq * cols.gamma(c, j) + cols.bt[c][j], -o.ahi), o.ahi);
        const int s = static_cast<int>(static_cast<unsigned>(acc) >> 31);
        v = (((acc + o.b1 - s) >> o.pre) * o.M + o.b2 - s) >> o.n2;
      } else {
        v = fq::rescale(fq::wrap_add(fq::wrap_mul(nq, cols.gamma(c, j)), cols.bt[c][j]),
                        o.M, o.sh, 8);
        v = min(max(v, -127), 127);
      }
      res[j] = v;
    }
    ov[c] = make_int4(pack4(res[0], res[1], res[2], res[3]),
                      pack4(res[4], res[5], res[6], res[7]),
                      pack4(res[8], res[9], res[10], res[11]),
                      pack4(res[12], res[13], res[14], res[15]));
  }
}

// kC chunks of 16 codes per thread (2 up to N = 8192, 4 up to 16384);
// kVec: N % 16 == 0 and every base 16-byte aligned.  The block's threads
// cover one row.
// The launch bounds leave registers for kWarpsPerSm warps an SM (at least
// one block of kMaxThreads), which the grid places there.
static_assert(kWarpsPerSm <= kMaxWarps, "the launch bounds assume kWarpsPerSm <= kMaxWarps");
template <int kC, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kC == 2 ? 2 : 1)
quant_layernorm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ gamma,
                       const int* __restrict__ beta, const int* __restrict__ Mq,
                       const int* __restrict__ shq, int8_t* __restrict__ out,
                       int R, int N, int sub_mean, int eps) {
  __shared__ int2 red[2][kMaxWarps];     // the warps' partial sums, by row parity
  const int Mv = *Mq, shv = *shq;        // the scalars, then the first row, then the rest
  int4 cur[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c)
    cur[c] = load_chunk<kVec, true>(x + static_cast<size_t>(blockIdx.x) * N,
                                    (c * blockDim.x + threadIdx.x) * kChunk, N);
  Cols<kC> cols;                         // this thread's columns, once per block
  int beta_max = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int c0 = (c * blockDim.x + threadIdx.x) * kChunk;
    cols.gp[c] = load_chunk<kVec, false>(gamma, c0, N);
    if constexpr (Cols<kC>::kUnpacked) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) cols.g[c * kChunk + j] = code(cols.gp[c], j);
    }
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      int4 b4 = make_int4(0, 0, 0, 0);
      if (kVec && c0 < N) {
        b4 = __ldg(reinterpret_cast<const int4*>(beta + c0) + q);
      } else if (!kVec) {
        const int i = c0 + 4 * q;
        b4 = make_int4(i < N ? beta[i] : 0, i + 1 < N ? beta[i + 1] : 0,
                       i + 2 < N ? beta[i + 2] : 0, i + 3 < N ? beta[i + 3] : 0);
      }
      cols.bt[c][4 * q] = b4.x;
      cols.bt[c][4 * q + 1] = b4.y;
      cols.bt[c][4 * q + 2] = b4.z;
      cols.bt[c][4 * q + 3] = b4.w;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      beta_max = max(beta_max, cols.bt[c][j] == INT_MIN ? INT_MAX : abs(cols.bt[c][j]));
  }
  const Out o = out_consts(Mv, shv);
  const unsigned inv_n = 0xffffffffu / static_cast<unsigned>(N);
  int mode = -1;                         // this warp's path, known from the first row on
  for (int row = blockIdx.x, buf = 0; row < R; row += gridDim.x, buf ^= 1) {
    const int nxt = row + gridDim.x;
    int4 next[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      next[c] = nxt < R ? load_chunk<kVec, true>(x + static_cast<size_t>(nxt) * N,
                                                 (c * blockDim.x + threadIdx.x) * kChunk, N)
                        : make_int4(0, 0, 0, 0);
    const Row r = row_consts<kC>(cur, red[buf], N, inv_n, sub_mean, eps);
    if (mode < 0) {
      // a warp touches its own columns only: none of their accumulators can
      // wrap when |beta| + 2^30 + b1 fits (|n_q * gamma| < 2^30: rsqrt's
      // mantissa is at most 2^15 and |x - m| <= 255)
      mode = o.merge && __all_sync(0xffffffffu, static_cast<long long>(beta_max) +
                                                    (1LL << 30) + o.b1 <= INT_MAX)
                 ? kMerged : kExact;
    }
    int4 ov[kC];
    if (mode == kMerged) normalize<kMerged, kC>(cur, ov, cols, r, o);
    else normalize<kExact, kC>(cur, ov, cols, r, o);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store_chunk<kVec>(out + static_cast<size_t>(row) * N,
                        (c * blockDim.x + threadIdx.x) * kChunk, N, ov[c]);
      cur[c] = next[c];
    }
  }
}

template <int kC, bool kVec>
void launch(const void* x, const void* gamma, const void* beta, const void* Mq,
            const void* shq, void* out, int R, int N, int sub_mean, int eps, int grid,
            int threads, cudaStream_t stream) {
  quant_layernorm_kernel<kC, kVec><<<grid, threads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(gamma),
      static_cast<const int*>(beta), static_cast<const int*>(Mq),
      static_cast<const int*>(shq), static_cast<int8_t*>(out), R, N, sub_mean, eps);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x int8 (R, N), gamma int8 (N,), beta int32 (N,), Mq/shq int32 scalars in
// device memory, out int8 (R, N); 1 <= N <= 16384.  sms: the card's SMs.
extern "C" int quant_layernorm(const void* x, const void* gamma, const void* beta,
                               const void* Mq, const void* shq, void* out,
                               int R, int N, int sub_mean, int eps, int sms, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  if (N > kMaxThreads * 4 * kChunk || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % kChunk == 0 && aligned16(x) && aligned16(out) && aligned16(gamma) &&
                   aligned16(beta);
  const int chunks = (N + kChunk - 1) / kChunk;
  const bool wide = chunks > 2 * kMaxThreads;
  const int kc = wide ? 4 : 2;
  const int threads = ((chunks + kc - 1) / kc + 31) / 32 * 32;
  const int grid = std::min(R, sms * std::max(1, kWarpsPerSm * 32 / threads));
  const auto s = static_cast<cudaStream_t>(stream);
#define LN_LAUNCH(KC, VEC) \
  launch<KC, VEC>(x, gamma, beta, Mq, shq, out, R, N, sub_mean, eps, grid, threads, s)
  if (vec && !wide) LN_LAUNCH(2, true);
  else if (vec) LN_LAUNCH(4, true);
  else if (!wide) LN_LAUNCH(2, false);
  else LN_LAUNCH(4, false);
#undef LN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
