// The single-query decode over a contiguous KV stripe, split across the SMs.
// The stripe is read through its (slot, head, row) strides, D contiguous, so
// one template serves both layouts:
//
//   (B, Smax, Hkv, D)  the engine's contiguous stripe (decode_attention.cu,
//                      row 6);
//   (Hkv, Smax, D)     the reference's single-sequence cache at B = 1
//                      (flash_qdecode.cu, row 10).
//
// The result depends on bkv: the reference (kernels/ref.py::
// decode_qattention_ref) carries m, den and acc once per block of bkv keys,
// with the max over the whole block:
//
//   s    = int8 q . int8 k;  s = kpos < len ? s : s - 2^30      (int32)
//   m'   = max(m, max_block s);  f = exp((m - m') * inv)  (0 while m unset)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num;  acc = acc * f + num . int8 v   (per block)
//
// Only the fp32 carry depends on order.  Block j's numerators need m'_j =
// max(NEG_INIT, every score of blocks 0..j), and its den_b and P.V are
// int32 sums, exact in any grouping (at most 512 * 127 * 127 < 2^31).  So
// the work splits into three passes, PR 16's split of the paged decode
// (paged_decode.cuh) with the bkv block as the carry's unit: a block's rows
// are cut into sub-tiles of 16 (one warp each; the last may be shorter when
// 16 does not divide bkv), and up to 8 sub-tiles of one block make a span,
// one CTA; a span never crosses a block end.
//
//   A  stripe_scores_kernel, grid (spans, Hkv, B): per live sub-tile the
//      masked int32 scores of the G query rows (mma.sync m16n8k32,
//      paged_decode.cuh::page_scores), kept in the workspace; per span each
//      row's maximum.
//   B  stripe_pv_kernel, the same grid: m'_j from the span maxima of
//      blocks 0..j (one warp per row), the LUT numerators (int8), den_b and
//      P.V as V^T . num^T on mma.sync (the paged pass B's datapath, here as
//      the device functions page_numerators and pv_step), summed over the
//      span's sub-tiles in shared memory, to the workspace per span.
//   C  stripe_carry_kernel, one thread per 4 accumulators of a (slot, kv
//      head), 32 a CTA: per live block in order, the span sums of den_b and
//      P.V, the block max from the span maxima, f = exp((m - m') * inv)
//      (0 while m is NEG_INIT), den = den * f + den_b and acc = acc * f + pv,
//      each product and sum rounded on its own (__fmul_rn / __fadd_rn, no
//      fast math), then attn_out.
//
// Dead rows.  A sub-tile at or past the slot's length reads nothing, a span
// whose first row is at or past it exits, and blocks past it leave the
// carry untouched.  This is exact: a masked key's score s - 2^30 is below
// every live score (|s| < 2^21 at D <= 128), so it never raises a live
// block's max, and its index clips to 255, whose table entry is 0.  Masked
// rows inside a live sub-tile are computed as the reference computes them.
//
// Three launches per call, B and C as programmatic dependent launches; the
// wrapper takes the workspace (stripe_decode_ws ints) from PyTorch's caching
// allocator.  Spans of 8 sub-tiles, 128 rows, leave SMs idle at B = 1 (32
// CTAs a pass over 1,000 rows at Hkv = 4), but narrower ones lengthen pass
// C's sum over the spans of a block more than the wider grid saves: on the
// H100 8 sub-tiles a span were the fastest at every served shape, B = 1
// included.
#pragma once

#include "paged_decode.cuh"

namespace fq {

constexpr int kStripeRows = 16;      // rows per sub-tile, one warp each
constexpr int kStripeWarps = 8;      // sub-tiles per span
constexpr int kSpanRows = kStripeWarps * kStripeRows;
constexpr int kStripeThreads = kStripeWarps * 32;
constexpr int kStripeCarrySpans = 8; // spans in flight in pass C

// Where the spans of one (slot, kv head) lie: span s covers sub-tiles
// s % spb * 8 .. + 7 of block s / spb; sub-tile i of block j covers rows
// [j bkv + 16 i, j bkv + min(16 (i + 1), bkv)).
struct StripeGeom {
  int bkv, nst, spb, nspan;
  __host__ __device__ StripeGeom(int Smax, int bkv_)
      : bkv(bkv_), nst((bkv_ + kStripeRows - 1) / kStripeRows),
        spb((nst + kStripeWarps - 1) / kStripeWarps), nspan(Smax / bkv_ * spb) {}
  __device__ __forceinline__ int first_row(int s) const {
    return s / spb * bkv + s % spb * kSpanRows;
  }
  // spans of block j whose first row lies below len (j bkv < len)
  __device__ __forceinline__ int live_spans(int j, int len) const {
    return min(spb, (len - j * bkv + kSpanRows - 1) / kSpanRows);
  }
};

// Per span of every (slot, kv head): the G row maxima, the G den_b sums,
// P.V as NT * 256 int4 (int4 (nt * 8 + T) * 32 + lane: element e is column
// 16 g + 2 T + (e >> 1), row 8 nt + 2 t + (e & 1), lane = 4 g + t), and the
// scores of its 8 sub-tiles, (8, G, 16).
struct StripeWs {
  int* smax;
  int* den;
  int4* pv;
  int* scores;
};

__host__ __device__ __forceinline__ long long stripe_decode_ws_ints(int B, int Hkv, int G,
                                                                    int Smax, int bkv) {
  const long long spans = static_cast<long long>(B) * Hkv * StripeGeom(Smax, bkv).nspan;
  const long long nt = (G + 7) / 8;
  return 2 * align4(spans * G) + spans * nt * 1024 + spans * kSpanRows * G;
}

inline StripeWs stripe_ws(int* base, long long spans, int G) {
  const long long nt = (G + 7) / 8;
  StripeWs w;
  w.smax = base;
  w.den = w.smax + align4(spans * G);
  w.pv = reinterpret_cast<int4*>(w.den + align4(spans * G));
  w.scores = reinterpret_cast<int*>(w.pv + spans * nt * 256);
  return w;
}

// The K or V rows of one slot: row t of kv head h at base + h sh + t sr.
struct StripeRows {
  const int8_t* base;
  long long sh, sr;
  __device__ __forceinline__ uint4 row16(int t, int h, int col) const {
    return __ldg(reinterpret_cast<const uint4*>(base + h * sh + t * sr + col));
  }
  // paged_decode.cuh's loader interface (page_scores), the sub-tile's first
  // row in place of the page
  __device__ __forceinline__ uint4 k16(int t0, int r, int h, int, int, int, int col) const {
    return row16(t0 + r, h, col);
  }
};

// One warp: the G x P scores page_scores left in sw to dst (row stride
// ld) and each row's maximum to maxima[r] (as paged_decode.cuh's pass A).
__device__ __forceinline__ void keep_scores(const int* sw, int* dst, int ld, int P, int G,
                                            int* maxima) {
  const int lane = threadIdx.x & 31;
  const int seg = P <= 16 ? 16 : 32, c0 = lane % seg;
  for (int r0 = 0; r0 < G; r0 += 32 / seg) {
    const int r = r0 + lane / seg;
    int m = INT_MIN;
    if (r < G) {
      for (int c = c0; c < P; c += seg) {
        const int v = sw[r * kScoreLd + c];
        m = max(m, v);
        dst[r * ld + c] = v;
      }
    }
    m = seg_max(m, seg);
    if (r < G && c0 == 0) maxima[r] = m;
  }
}

// One warp: the int8 LUT numerators of the G x P scores sc (row stride ld)
// against each row's running max (lane r holds row r's, m_new) into nm (row
// stride kNumLd); returns den_b, the sum of row r's numerators, in lane r
// (as paged_decode.cuh's pass B).
__device__ __forceinline__ int page_numerators(int8_t* nm, const int* sc, int ld, int P, int G,
                                               int m_new, const int* s_lut, int Mi, int shi) {
  const int lane = threadIdx.x & 31;
  const int seg = P <= 16 ? 16 : 32, rpi = 32 / seg, c0 = lane % seg;
  int den_b = 0;
  for (int r0 = 0; r0 < G; r0 += rpi) {
    const int r = r0 + lane / seg;
    const int mr = __shfl_sync(0xffffffffu, m_new, r & 31);
    int sum = 0;
    if (r < G) {
      for (int c = c0; c < P; c += seg) {
        int idx = rescale(wrap_sub(mr, sc[r * ld + c]), Mi, shi, 9);
        idx = min(max(idx, 0), kLutSize - 1);
        const int n = s_lut[idx];
        nm[r * kNumLd + c] = static_cast<int8_t>(n);
        sum = wrap_add(sum, n);
      }
    }
    sum = seg_sum(sum, seg);
    const int got = __shfl_sync(0xffffffffu, sum, ((lane - r0) & (rpi - 1)) * seg);
    if (lane >= r0 && lane < r0 + rpi) den_b = got;
  }
  return den_b;
}

// This lane's V rows t0 + 4 t + i (i < 4), columns 16 g .. + 15, of a
// sub-tile of P rows; zeros past P or D.
__device__ __forceinline__ void load_v_rows(uint4 (&va)[4], const StripeRows& rows, int t0,
                                            int h, int D, int P) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * t + i;
    va[i] = r < P && 16 * g < D ? rows.row16(t0 + r, h, 16 * g) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// P.V of a sub-tile's 16 keys as V^T . num^T (mma.sync m16n8k16, 16 of the
// D columns on m16, the query rows on n8; V's rows transposed by
// __byte_perm): tile T of n-tile nt holds column 16 g + 2 T (+ 1 on rows
// g + 8), rows 8 nt + 2 t (+ 1).
template <int NT>
__device__ __forceinline__ void pv_step(int (&acc)[NT][8][4], const int8_t* nm,
                                        const uint4 (&va)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t bf[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    bf[nt] = *reinterpret_cast<const uint32_t*>(nm + (8 * nt + g) * kNumLd + 4 * t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t rw[4], cw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rw[i] = word_of(va[i], j);
    transpose4(rw, cw);     // keys 4 t .. 4 t + 3 of columns 16 g + 4 j + c
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_16816(acc[nt][2 * j + hh], cw[2 * hh], cw[2 * hh + 1], bf[nt]);
  }
}

// Pass A.  CTA (s, h, b): span s of slot b, kv head h; warp w takes
// sub-tile s % spb * 8 + w of block s / spb.
__global__ void __launch_bounds__(kStripeThreads)
stripe_scores_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int* __restrict__ lengths, StripeWs ws, StripeGeom geo, int Hkv,
                     int G, int D, int sb, int sh, int sr) {
  __shared__ int s_sc[kStripeWarps][kSplitMaxG * kScoreLd];
  __shared__ int s_max[kStripeWarps][kSplitMaxG];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = lengths[b];
  const int row0 = geo.first_row(s);
  if (row0 >= len) return;   // a dead span reads nothing
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = s % geo.spb * kStripeWarps + warp;
  const int t0 = row0 + kStripeRows * warp, nv = min(kStripeRows, geo.bkv - kStripeRows * i);
  const size_t span = static_cast<size_t>(bh) * geo.nspan + s;
  if (i < geo.nst && t0 < len) {
    int* sw = s_sc[warp];
    page_scores(q + static_cast<size_t>(bh) * G * D,
                StripeRows{k + static_cast<long long>(b) * sb, sh, sr}, t0, h, Hkv, G, D, nv,
                t0, len, sw);
    __syncwarp();
    keep_scores(sw, ws.scores + (span * kStripeWarps + warp) * G * kStripeRows, kStripeRows,
                nv, G, s_max[warp]);
  } else if (lane < G) {
    s_max[warp][lane] = INT_MIN;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < G) {
    int m = INT_MIN;
    for (int w = 0; w < kStripeWarps; ++w) m = max(m, s_max[w][threadIdx.x]);
    ws.smax[span * G + threadIdx.x] = m;
  }
}

// Pass B.
template <int NT>
__global__ void __launch_bounds__(kStripeThreads)
stripe_pv_kernel(const int8_t* __restrict__ v, const int* __restrict__ lengths,
                 const int* __restrict__ lut, const int* __restrict__ Mi_p,
                 const int* __restrict__ shi_p, StripeWs ws, StripeGeom geo, int Hkv, int G,
                 int D, int sb, int sh, int sr) {
  __shared__ int s_lut[kLutSize];
  __shared__ int s_m[kSplitMaxG];
  __shared__ int s_den[kSplitMaxG];
  __shared__ int s_pv[4][NT * 256];   // element e of int4 x at s_pv[e][x]
  __shared__ __align__(16) int8_t s_num[kStripeWarps][kSplitMaxG * kNumLd];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = lengths[b];
  const int row0 = geo.first_row(s);
  if (row0 >= len) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = s / geo.spb, i = s % geo.spb * kStripeWarps + warp;
  const int t0 = row0 + kStripeRows * warp, nv = min(kStripeRows, geo.bkv - kStripeRows * i);
  const bool live = i < geo.nst && t0 < len;
  // this lane's V rows, read before pass A has finished
  uint4 va[4];
  if (live) load_v_rows(va, StripeRows{v + static_cast<long long>(b) * sb, sh, sr}, t0, h, D, nv);
  for (int x = tid; x < kLutSize; x += kStripeThreads) s_lut[x] = lut[x];
  for (int x = tid; x < kStripeWarps * kSplitMaxG * kNumLd / 4; x += kStripeThreads)
    reinterpret_cast<int*>(s_num)[x] = 0;
  for (int x = tid; x < 4 * NT * 256; x += kStripeThreads) (&s_pv[0][0])[x] = 0;
  if (tid < kSplitMaxG) s_den[tid] = 0;
  // pass A's results from here on (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the running max after block j, one warp per row: every span of blocks
  // 0..j below the slot's length
  const int* smax_bh = ws.smax + static_cast<size_t>(bh) * geo.nspan * G;
  const int nspans = j * geo.spb + geo.live_spans(j, len);
  for (int r = warp; r < G; r += kStripeWarps) {
    int m = kNegInit;
    for (int x = lane; x < nspans; x += 32) m = max(m, smax_bh[x * G + r]);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) s_m[r] = m;
  }
  __syncthreads();

  const size_t span = static_cast<size_t>(bh) * geo.nspan + s;
  if (live) {
    int8_t* nm = s_num[warp];
    const int den_b =
        page_numerators(nm, ws.scores + (span * kStripeWarps + warp) * G * kStripeRows,
                        kStripeRows, nv, G, lane < G ? s_m[lane] : kNegInit, s_lut, *Mi_p,
                        *shi_p);
    if (lane < G) atomicAdd(&s_den[lane], den_b);
    __syncwarp();
    int acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int T = 0; T < 8; ++T)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][T][e] = 0;
    pv_step<NT>(acc, nm, va);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int T = 0; T < 8; ++T)
#pragma unroll
        for (int e = 0; e < 4; ++e) atomicAdd(&s_pv[e][(nt * 8 + T) * 32 + lane], acc[nt][T][e]);
  }
  __syncthreads();
  int4* pvw = ws.pv + span * NT * 256;
  for (int x = tid; x < NT * 256; x += kStripeThreads)
    pvw[x] = make_int4(s_pv[0][x], s_pv[1][x], s_pv[2][x], s_pv[3][x]);
  if (tid < G) ws.den[span * G + tid] = s_den[tid];
}

// Pass C.  Thread c of the grid owns int4 q4 = c % (NT * 256) of every span
// of (slot, kv head) c / (NT * 256): n-tile nt = q4 / 256, tile T = q4 / 32
// % 8, lane L = q4 % 32 (g, t), columns 16 g + 2 T (+ 1), rows 8 nt + 2 t
// (+ 1); it carries m and den for those two rows itself.
__global__ void __launch_bounds__(kCarryThreads)
stripe_carry_kernel(const int* __restrict__ lengths, const float* __restrict__ inv_p,
                    const float* __restrict__ osc_p, int8_t* __restrict__ out, StripeWs ws,
                    StripeGeom geo, int Hkv, int G, int D, int nblk, int NT) {
  constexpr int K = kStripeCarrySpans;
  const int chains = NT * 256;
  const int c = blockIdx.x * kCarryThreads + threadIdx.x;
  const int bh = c / chains, q4 = c % chains;
  const int len = lengths[bh / Hkv];
  const int nt = q4 >> 8, T = (q4 >> 5) & 7, L = q4 & 31, g = L >> 2, t = L & 3;
  const int ra = 8 * nt + 2 * t;
  const int live_blk = len > 0 ? min((len + geo.bkv - 1) / geo.bkv, nblk) : 0;
  const float inv = *inv_p;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, den[2] = {0.0f, 0.0f};
  int m[2] = {kNegInit, kNegInit};
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int j = 0; j < live_blk; ++j) {
    const int n = geo.live_spans(j, len);
    const size_t sp0 = static_cast<size_t>(bh) * geo.nspan + static_cast<size_t>(j) * geo.spb;
    int mb[2] = {INT_MIN, INT_MIN}, db[2] = {0, 0}, pv[4] = {0, 0, 0, 0};
    for (int x0 = 0; x0 < n; x0 += K) {
      int4 p[K];
      int mx[K][2], dd[K][2];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (x0 + u < n) {
          const size_t sp = sp0 + x0 + u;
          p[u] = __ldcg(ws.pv + sp * chains + q4);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool row = ra + r < G;
            mx[u][r] = row ? __ldcg(ws.smax + sp * G + ra + r) : INT_MIN;
            dd[u][r] = row ? __ldcg(ws.den + sp * G + ra + r) : 0;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (x0 + u < n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mb[r] = max(mb[r], mx[u][r]);
            db[r] = wrap_add(db[r], dd[u][r]);
          }
          pv[0] = wrap_add(pv[0], p[u].x);
          pv[1] = wrap_add(pv[1], p[u].y);
          pv[2] = wrap_add(pv[2], p[u].z);
          pv[3] = wrap_add(pv[3], p[u].w);
        }
      }
    }
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mn = max(m[r], mb[r]);
      f[r] = m[r] == kNegInit
                 ? 0.0f
                 : expf(__fmul_rn(static_cast<float>(wrap_sub(m[r], mn)), inv));
      m[r] = mn;
      den[r] = __fadd_rn(__fmul_rn(den[r], f[r]), static_cast<float>(db[r]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] = __fadd_rn(__fmul_rn(acc[e], f[e & 1]), static_cast<float>(pv[e]));
  }
  const float osc = *osc_p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 16 * g + 2 * T + (e >> 1), r = ra + (e & 1);
    if (r < G && d < D)
      out[(static_cast<size_t>(bh) * G + r) * D + d] = attn_out(acc[e], den[e & 1], osc);
  }
}

// q int8 (B, Hkv, G, D) -> out int8 (B, Hkv, G, D); K/V row t of slot b,
// kv head h at b sb + h sh + t sr; ws holds stripe_decode_ws_ints(B, Hkv,
// G, Smax, bkv) int32 (16-byte aligned).
inline int launch_stripe_decode(const void* q, const void* k, const void* v,
                                const void* lengths, const void* lut, const void* Mi,
                                const void* shi, const void* inv, const void* osc, void* out,
                                void* ws_base, int B, int Hkv, int G, int D, int Smax, int bkv,
                                int sb, int sh, int sr, void* stream) {
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  const StripeGeom geo(Smax, bkv);
  const StripeWs ws =
      stripe_ws(static_cast<int*>(ws_base), static_cast<long long>(B) * Hkv * geo.nspan, G);
  const dim3 grid(geo.nspan, Hkv, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ln = static_cast<const int*>(lengths);
  stripe_scores_kernel<<<grid, kStripeThreads, 0, st>>>(static_cast<const int8_t*>(q),
                                                static_cast<const int8_t*>(k), ln, ws, geo, Hkv,
                                                G, D, sb, sh, sr);
  const int NT = G > 8 ? 2 : 1;
  cudaError_t rc = launch_dependent(
      grid, kStripeThreads, st, NT == 2 ? stripe_pv_kernel<2> : stripe_pv_kernel<1>,
      static_cast<const int8_t*>(v), ln, static_cast<const int*>(lut),
      static_cast<const int*>(Mi), static_cast<const int*>(shi), ws, geo, Hkv, G, D, sb, sh,
      sr);
  if (rc == cudaSuccess)
    rc = launch_dependent(dim3(B * Hkv * NT * 256 / kCarryThreads), kCarryThreads, st,
                          stripe_carry_kernel, ln, static_cast<const float*>(inv),
                          static_cast<const float*>(osc), static_cast<int8_t*>(out), ws, geo,
                          Hkv, G, D, Smax / bkv, NT);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace fq

// The workspace of one call, in int32; each stripe library
// (decode_attention.cu, flash_qdecode.cu) exports it.
extern "C" long long stripe_decode_ws(int B, int Hkv, int G, int Smax, int bkv) {
  return fq::stripe_decode_ws_ints(B, Hkv, G, Smax, bkv);
}
