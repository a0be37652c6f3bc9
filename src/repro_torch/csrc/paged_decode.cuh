// The paged decode kernels, templates on the page loader (Int8Pages for the
// int8 pool, Int4Pages for the int4-packed one; paged_attention.cuh).
//
// The reference walks a slot's chain one page at a time with an fp32 carry
// (kernels/ref.py::paged_decode_qattention_ref).  Only that carry depends
// on the order of the pages: page p's numerators depend on the running
// integer max after p, m_new_p = max(NEG_INIT, page maxima 0..p), and its
// den_b and P.V are int32.  So the work splits into three passes that give
// the page-serial values bit for bit, and the first two spread each slot's
// pages over the SMs:
//
//   A  split_scores_kernel, grid (spans of 8 pages, Hkv, B), one page per
//      warp: the masked int32 scores of the G query rows (mma.sync
//      m16n8k32, the page's keys on m16, the rows on n8) and each row's
//      page max, to an int32 workspace, and the scores themselves.
//   B  split_pv_kernel, the same grid: m_old_p / m_new_p from the page
//      maxima, f_p = exp((m_old - m_new) * inv) (0 while m_old is
//      NEG_INIT), the LUT numerators from the scores pass A left, den_b_p,
//      and P.V as V^T . num^T (mma.sync m16n8k32, 16 of
//      the D columns on m16, the rows on n8; numerators <= 127 enter as
//      int8, as in the TPU kernel), all to the workspace.
//   C  split_carry_kernel, one thread per 4 accumulators of a (slot, kv
//      head), 32 a block: den = den * f + den_b and acc = acc * f + pv over
//      the pages in order, each product and sum rounded on its own
//      (__fmul_rn / __fadd_rn), then attn_out.  The carry is serial only
//      along a chain; its 1,024 (G = 8) chains per (slot, kv head) spread
//      over 8 blocks.
//
// Three launches per call, B and C programmatic dependent launches (their
// blocks start during the previous pass's tail; B reads its V rows before
// it waits); no host synchronisation; the wrapper takes the workspace from
// PyTorch's caching allocator (paged_decode_ws ints).  stripe_decode.cuh
// splits the contiguous stripe the same way and reuses page_scores.
#pragma once

#include <climits>

#include "mma_sync.cuh"
#include "paged_attention.cuh"

namespace fq {

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSpan = kSplitWarps;     // pages per block, one per warp
constexpr int kSplitMaxG = 16;
constexpr int kScoreLd = kMaxP + 4;    // the C fragments' stores hit 32 banks
constexpr int kNumLd = 80;             // int8 numerators: B-fragment loads hit 32 banks

// Per page of every (slot, kv head): the G page maxima, NT*4 int4 of
// {f(r), f(r+1) as bits, den_b(r), den_b(r+1)} for rows r = 8 nt + 2 t, and
// P.V as NT*256 int4 in mma fragment order (int4 (nt*32 + lane)*8 + tile:
// column 16 g + 2 tile + (e >> 1), row 8 nt + 2 t + (e & 1) for element e).
struct SplitWs {
  int* pmax;      // (B * Hkv * nb, G)
  int4* fd;       // (B * Hkv * nb, NT * 4)
  int4* pv;       // (B * Hkv * nb, NT * 256)
  int* scores;    // (B * Hkv * nb, G, P)
};

__host__ __device__ __forceinline__ long long align4(long long n) { return (n + 3) & ~3LL; }

__host__ __device__ __forceinline__ long long paged_decode_ws_ints(int B, int Hkv, int G, int P,
                                                                   int nb) {
  const long long pages = static_cast<long long>(B) * Hkv * nb;
  const long long nt = (G + 7) / 8;
  return align4(pages * G) + pages * nt * 16 + pages * nt * 1024 + pages * G * P;
}

inline SplitWs split_ws(int* base, int B, int Hkv, int G, int nb) {
  const long long pages = static_cast<long long>(B) * Hkv * nb;
  const long long nt = (G + 7) / 8;
  SplitWs w;
  w.pmax = base;
  w.fd = reinterpret_cast<int4*>(w.pmax + align4(pages * G));
  w.pv = w.fd + pages * nt * 4;
  w.scores = reinterpret_cast<int*>(w.pv + pages * nt * 256);
  return w;
}

__device__ __forceinline__ int live_pages(int len, int P, int nb) {
  return len > 0 ? min((len + P - 1) / P, nb) : 0;
}

// A sum or max over the `seg` lanes (16 or 32) that share a row.
__device__ __forceinline__ int seg_max(int v, int seg) {
  for (int o = seg >> 1; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int seg_sum(int v, int seg) {
  for (int o = seg >> 1; o > 0; o >>= 1) v = wrap_add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp: the masked int32 scores of page `page` (logical keys kbase ..)
// for the G rows of qbh (G, D) into sw[r * kScoreLd + key].  Lane (g, t)
// holds bytes 32 t .. 32 t + 31 of query row 8 nt + g and of key rows
// 16 mt + g and + 8; k-step ks takes words 2 ks and 2 ks + 1 of both, the
// same permutation of the head dim on both sides of the product.
template <class Pages>
__device__ __forceinline__ void page_scores(const int8_t* __restrict__ qbh, const Pages& pages,
                                            int page, int h, int Hkv, int G, int D, int P,
                                            int kbase, int len, int* sw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint32_t qf[2][8];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 8 * nt + g, col = 32 * t + 16 * hh;
      const int8_t* src = qbh + static_cast<size_t>(r) * D + col;
      const uint4 v = r < G && col < D ? __ldg(reinterpret_cast<const uint4*>(src)) : zero;
      qf[nt][4 * hh] = v.x;
      qf[nt][4 * hh + 1] = v.y;
      qf[nt][4 * hh + 2] = v.z;
      qf[nt][4 * hh + 3] = v.w;
    }
  }
  const int nts = G > 8 ? 2 : 1;
  for (int mt = 0; 16 * mt < P; ++mt) {
    uint32_t ka[8], kb[8];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ra = 16 * mt + g, rb = ra + 8, col = 32 * t + 16 * hh;
      const uint4 a = ra < P && col < D ? pages.k16(page, ra, h, Hkv, D, P, col) : zero;
      const uint4 b = rb < P && col < D ? pages.k16(page, rb, h, Hkv, D, P, col) : zero;
      ka[4 * hh] = a.x, ka[4 * hh + 1] = a.y, ka[4 * hh + 2] = a.z, ka[4 * hh + 3] = a.w;
      kb[4 * hh] = b.x, kb[4 * hh + 1] = b.y, kb[4 * hh + 2] = b.z, kb[4 * hh + 3] = b.w;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= nts) break;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_16832(acc, ka[2 * ks], kb[2 * ks], ka[2 * ks + 1], kb[2 * ks + 1],
                         qf[nt][2 * ks], qf[nt][2 * ks + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * mt + g + 8 * (e >> 1), r = 8 * nt + 2 * t + (e & 1);
        if (key < P && r < G)
          sw[r * kScoreLd + key] = kbase + key < len ? acc[e] : wrap_sub(acc[e], kMaskOffset);
      }
    }
  }
}

// Pass A.  Block (s, h, b): pages 8 s .. 8 s + 7 of slot b, kv head h.
template <class Pages>
__global__ void __launch_bounds__(kSplitThreads)
split_scores_kernel(const int8_t* __restrict__ q, Pages pages, const int* __restrict__ btab,
                    const int* __restrict__ lengths, SplitWs ws, int Hkv, int G, int D, int P,
                    int nb) {
  __shared__ int s_sc[kSplitWarps][kSplitMaxG * kScoreLd];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = lengths[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = s * kSpan + warp;
  if (p >= live_pages(len, P, nb)) return;
  int* sw = s_sc[warp];
  page_scores(q + static_cast<size_t>(bh) * G * D, pages, btab[b * nb + p], h, Hkv, G, D, P,
              p * P, len, sw);
  __syncwarp();
  const size_t pg = static_cast<size_t>(bh) * nb + p;
  const int seg = P <= 16 ? 16 : 32, c0 = lane % seg;
  for (int r0 = 0; r0 < G; r0 += 32 / seg) {
    const int r = r0 + lane / seg;
    int m = INT_MIN;
    if (r < G) {
      for (int c = c0; c < P; c += seg) {
        const int v = sw[r * kScoreLd + c];
        m = max(m, v);
        ws.scores[(pg * G + r) * P + c] = v;
      }
    }
    m = seg_max(m, seg);
    if (r < G && c0 == 0) ws.pmax[pg * G + r] = m;
  }
}

// Pass B.
template <class Pages, int NT>
__global__ void __launch_bounds__(kSplitThreads)
split_pv_kernel(Pages pages, const int* __restrict__ btab, const int* __restrict__ lengths,
                const int* __restrict__ lut,
                const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                const float* __restrict__ inv_p, SplitWs ws, int Hkv, int G, int D, int P,
                int nb) {
  __shared__ int s_lut[kLutSize];
  __shared__ int s_pre[kSplitMaxG];
  __shared__ __align__(16) int8_t s_num[kSplitWarps][kSplitMaxG * kNumLd];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = lengths[b];
  const int npages = live_pages(len, P, nb);
  if (s * kSpan >= npages) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = s * kSpan, p = p0 + warp;
  const bool live = p < npages;
  const int page = live ? btab[b * nb + p] : 0;
  // this lane's V rows k0 + 4 t + i and + 16, columns 16 g .. + 15: the
  // first 32 rows are read before pass A has finished
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int colv = 16 * g;
  uint4 va[4], vb[4];
  auto load_v = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ra = k0 + 4 * t + i, rb = ra + 16;
      va[i] = ra < P && colv < D ? pages.v16(page, ra, h, Hkv, D, P, colv) : zero;
      vb[i] = rb < P && colv < D ? pages.v16(page, rb, h, Hkv, D, P, colv) : zero;
    }
  };
  if (live) load_v(0);
  for (int i = tid; i < kLutSize; i += kSplitThreads) s_lut[i] = lut[i];
  for (int i = tid; i < kSplitWarps * kSplitMaxG * kNumLd / 4; i += kSplitThreads)
    reinterpret_cast<int*>(s_num)[i] = 0;
  // pass A's results from here on: the launch may overlap pass A's tail
  // (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // running max before this span, one warp per row
  const int* pmax_bh = ws.pmax + static_cast<size_t>(bh) * nb * G;
  for (int r = warp; r < G; r += kSplitWarps) {
    int m = kNegInit;
    for (int j = lane; j < p0; j += 32) m = max(m, pmax_bh[j * G + r]);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) s_pre[r] = m;
  }
  __syncthreads();

  if (live) {
    const size_t pg = static_cast<size_t>(bh) * nb + p;
    const int Mi = *Mi_p, shi = *shi_p;
    // lane r < G: row r's running max before and after this page, and f
    int m_new = kNegInit, den_b = 0;
    float f = 0.0f;
    if (lane < G) {
      int m_old = s_pre[lane];
      for (int j = p0; j < p; ++j) m_old = max(m_old, pmax_bh[j * G + lane]);
      m_new = max(m_old, pmax_bh[p * G + lane]);
      if (m_old != kNegInit)
        f = expf(__fmul_rn(static_cast<float>(wrap_sub(m_old, m_new)), *inv_p));
    }
    const int* sc = ws.scores + pg * G * P;
    // numerators (int8 into s_num, rows 16 apart) and den_b (lane r)
    int8_t* nm = s_num[warp];
    const int seg = P <= 16 ? 16 : 32, rpi = 32 / seg, c0 = lane % seg;
    for (int r0 = 0; r0 < G; r0 += rpi) {
      const int r = r0 + lane / seg;
      const int mr = __shfl_sync(0xffffffffu, m_new, r & 31);
      int sum = 0;
      if (r < G) {
        for (int c = c0; c < P; c += seg) {
          int idx = rescale(wrap_sub(mr, sc[r * P + c]), Mi, shi, 9);
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
    {
      const int ra = 8 * (lane >> 2) + 2 * (lane & 3);
      const float fa = __shfl_sync(0xffffffffu, f, ra & 31);
      const float fb = __shfl_sync(0xffffffffu, f, (ra + 1) & 31);
      const int da = __shfl_sync(0xffffffffu, den_b, ra & 31);
      const int db = __shfl_sync(0xffffffffu, den_b, (ra + 1) & 31);
      if (lane < 4 * NT)
        ws.fd[pg * NT * 4 + lane] = make_int4(__float_as_int(fa), __float_as_int(fb), da, db);
    }
    __syncwarp();

    // P.V: tile T of n-tile nt holds column 16 g + 2 T (+ 1 on rows g + 8)
    int acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int T = 0; T < 8; ++T)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][T][e] = 0;
    for (int k0 = 0; k0 < P; k0 += 32) {
      if (k0 > 0) load_v(k0);
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* nr = nm + (8 * nt + g) * kNumLd + k0 + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(nr);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(nr + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t r0w[4], r1w[4], c0w[4], c1w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r0w[i] = word_of(va[i], j);
          r1w[i] = word_of(vb[i], j);
        }
        transpose4(r0w, c0w);     // keys k0 + 4 t .. of columns 16 g + 4 j + c
        transpose4(r1w, c1w);     // keys k0 + 16 + 4 t ..
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_16832(acc[nt][2 * j + hh], c0w[2 * hh], c0w[2 * hh + 1], c1w[2 * hh],
                             c1w[2 * hh + 1], bf[nt][0], bf[nt][1]);
      }
    }
    int4* pvw = ws.pv + pg * NT * 256;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int T = 0; T < 8; ++T)
        pvw[(nt * 32 + lane) * 8 + T] =
            make_int4(acc[nt][T][0], acc[nt][T][1], acc[nt][T][2], acc[nt][T][3]);
  }
}

// Pass C.  Thread c of the grid owns int4 q4 = c % (NT * 256) of every page
// of (slot, kv head) c / (NT * 256): n-tile nt = q4 / 256, lane L = q4 / 8
// % 32 (g, t), tile T = q4 % 8, columns 16 g + 2 T (+ 1), rows 8 nt + 2 t
// (+ 1); it carries den for those two rows itself.
constexpr int kCarryThreads = 32;
constexpr int kCarryPages = 16;   // pages in flight

__global__ void __launch_bounds__(kCarryThreads)
split_carry_kernel(const int* __restrict__ lengths, const float* __restrict__ osc_p,
                   int8_t* __restrict__ out, SplitWs ws, int Hkv, int G, int D, int P, int nb,
                   int NT) {
  const int chains = NT * 256;
  const int c = blockIdx.x * kCarryThreads + threadIdx.x;
  const int bh = c / chains, q4 = c % chains;
  const int npages = live_pages(lengths[bh / Hkv], P, nb);
  const int nt = q4 >> 8, L = (q4 >> 3) & 31, T = q4 & 7, g = L >> 2, t = L & 3;
  const int4* pvb = ws.pv + static_cast<size_t>(bh) * nb * chains + q4;
  const int4* fdb = ws.fd + static_cast<size_t>(bh) * nb * NT * 4 + nt * 4 + t;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, den[2] = {0.0f, 0.0f};
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int pb = 0; pb < npages; pb += kCarryPages) {
    int4 pv[kCarryPages], fd[kCarryPages];
#pragma unroll
    for (int u = 0; u < kCarryPages; ++u)
      if (pb + u < npages) {
        pv[u] = __ldcg(pvb + static_cast<size_t>(pb + u) * chains);
        fd[u] = __ldcg(fdb + static_cast<size_t>(pb + u) * NT * 4);
      }
#pragma unroll
    for (int u = 0; u < kCarryPages; ++u)
      if (pb + u < npages) {
        const float fa = __int_as_float(fd[u].x), fb = __int_as_float(fd[u].y);
        den[0] = __fadd_rn(__fmul_rn(den[0], fa), static_cast<float>(fd[u].z));
        den[1] = __fadd_rn(__fmul_rn(den[1], fb), static_cast<float>(fd[u].w));
        acc[0] = __fadd_rn(__fmul_rn(acc[0], fa), static_cast<float>(pv[u].x));
        acc[1] = __fadd_rn(__fmul_rn(acc[1], fb), static_cast<float>(pv[u].y));
        acc[2] = __fadd_rn(__fmul_rn(acc[2], fa), static_cast<float>(pv[u].z));
        acc[3] = __fadd_rn(__fmul_rn(acc[3], fb), static_cast<float>(pv[u].w));
      }
  }
  const float osc = *osc_p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 16 * g + 2 * T + (e >> 1), r = 8 * nt + 2 * t + (e & 1);
    if (r < G && d < D)
      out[(static_cast<size_t>(bh) * G + r) * D + d] = attn_out(acc[e], den[e & 1], osc);
  }
}

// a programmatic dependent launch of kernel on grid x block
template <class... Params, class... Args>
cudaError_t launch_dependent(dim3 grid, int block, cudaStream_t st, void (*kernel)(Params...),
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// q int8 (B, Hkv, G, D) -> out int8 (B, Hkv, G, D); ws holds
// paged_decode_ws_ints(B, Hkv, G, P, nb) int32 (16-byte aligned).
template <class Pages>
int launch_paged_decode(const void* q, Pages pages, const void* btab, const void* lengths,
                        const void* lut, const void* Mi, const void* shi, const void* inv,
                        const void* osc, void* out, void* ws_base, int B, int Hkv, int G, int D,
                        int P, int nb, void* stream) {
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  const SplitWs ws = split_ws(static_cast<int*>(ws_base), B, Hkv, G, nb);
  const dim3 grid(max(1, (nb + kSpan - 1) / kSpan), Hkv, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* bt = static_cast<const int*>(btab);
  const auto* ln = static_cast<const int*>(lengths);
  const auto* osc_f = static_cast<const float*>(osc);
  auto* o8 = static_cast<int8_t*>(out);
  split_scores_kernel<Pages><<<grid, kSplitThreads, 0, st>>>(q8, pages, bt, ln, ws, Hkv, G, D,
                                                             P, nb);
  const int NT = G > 8 ? 2 : 1;
  cudaError_t rc = launch_dependent(
      grid, kSplitThreads, st,
      NT == 2 ? split_pv_kernel<Pages, 2> : split_pv_kernel<Pages, 1>, pages, bt, ln, static_cast<const int*>(lut), static_cast<const int*>(Mi),
      static_cast<const int*>(shi), static_cast<const float*>(inv), ws, Hkv, G, D, P, nb);
  if (rc == cudaSuccess)
    rc = launch_dependent(dim3(B * Hkv * NT * 256 / kCarryThreads), kCarryThreads, st,
                          split_carry_kernel, ln, osc_f, o8, ws, Hkv, G, D, P, nb, NT);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace fq

// The workspace of one call, in int32: the same for both pools; each
// kernel library (paged_decode_attention.cu, _q4.cu) exports it.
extern "C" long long paged_decode_ws(int B, int Hkv, int G, int P, int nb) {
  return fq::paged_decode_ws_ints(B, Hkv, G, P, nb);
}
