// The paged chunked-prefill kernel for Hopper, a template on the page
// loader (Int8Pages for the int8 pool, Int4Pages for the int4-packed one;
// paged_attention.cuh) and on the 16-key tiles per page (KT).
//
// Exactness.  The reference carries m, den and acc once per page of P keys
// (kernels/ref.py::paged_prefill_qattention_ref).  Everything inside a page
// is an integer (the scores, their max, the LUT numerators, den_b and P.V),
// exact in any order and grouping; only the fp32 carry depends on order,
// and it is applied here once per page, in page order, with the same
// __fmul_rn / __fadd_rn / expf / rintf as paged_attention.cuh.  Pages wholly
// past a row tile's causal frontier are skipped: for every row of the tile
// they are fully masked, an exact identity of the update (the oracle's
// docstring), so the result equals the oracle's bit for bit.
//
// Design.  A block serves `gh` q heads of one kv head (one warp each, gh
// dividing G, at most 4) on a tile of 16 query rows of one slot, so every
// warp of the block has the same causal frontier and the block walks one
// page chain; the wrapper picks gh so that the grid fills the SMs.  The
// longest rows get the lowest block index.  One more warp, the stager,
// copies each K/V page once for the block's q heads by 16-byte cp.async
// into a ring of three steps (two in flight), reading the block-table
// entries a step ahead, at a row stride that is an odd multiple of 16 bytes,
// so both fragment loads below are free of bank conflicts.  kv4 stages the
// packed bytes and a 16-entry code table per page (dequant_code of each
// nibble), and every thread turns a share of the next step's bytes into
// codes by table lookups (__byte_perm) while the warps work on this one.
// A step is U pages (32 keys) behind one barrier, so their integer work
// interleaves.  Per page, each warp:
//
//   QK^T  mma.sync m16n8k32: its 16 rows (q fragments held in registers for
//         the whole walk) x 16 keys per tile (two n8 tiles, K by ldmatrix),
//         D on k; the row max over the C fragments and two shuffles across
//         the four lanes that share a row; f from the running max;
//   num   the LUT numerators (<= 127, so int8) in the registers that held
//         their scores: every index, then every load;
//   P.V   mma.sync m16n8k16 with the numerators as A: lane (g, t) holds keys
//         2t, 2t+1, 8+2t, 9+2t of a tile as k = 4t..4t+3, so V's rows go
//         into the B fragments in that order (16-byte loads of those four
//         rows, transposed by __byte_perm); n-tile j column g is V's column
//         16 g + j, so lane (g, t) ends up with the 32 output bytes
//         [32 t, 32 t + 32) of its two rows; den_b is the numerators times
//         a column of ones, one more mma;
//   carry acc = acc * f + pv, den = den * f + den_b in registers, P.V
//         turned into a float exactly by a bias (pv_float).
//
// q is read and the output written through their (batch, head, row)
// strides, D contiguous (the serving forward's (B, S, H, D) projections in
// place).
#pragma once

#include <climits>

#include "mma_sync.cuh"
#include "paged_attention.cuh"

namespace fq {

constexpr int kPfSteps = 3;      // steps in the cp.async ring (two in flight)
constexpr int kPfMaxWarps = 4;   // q heads per block, one warp each
constexpr int kPfRows = 16;      // query rows per block (the mma's m16)
constexpr int kPfLutBytes = kLutSize * 4;
constexpr int kPfHead = kPfLutBytes + 512;   // the LUT, then kv4's dequant tables
constexpr int kPfStepKeys = 32;  // keys per step (U pages of 16 KT)

// Pages per step: a step's pages share one barrier, and their integer work
// (scores, maxima, numerators) interleaves; the carry stays per page.
__host__ __device__ constexpr int pf_pages_per_step(int KT) {
  return kPfStepKeys / (16 * KT) > 1 ? kPfStepKeys / (16 * KT) : 1;
}

// Row stride of a staged K or V tile: D rounded up to the QK^T k-step,
// plus 16 bytes (an odd multiple of 16 bytes in all).
__host__ __device__ constexpr int pf_stride(int D) { return (D + 31) / 32 * 32 + 16; }

// Bytes of one staged K (or V) tile of codes: 16 KT rows.
__host__ __device__ constexpr int pf_tile_bytes(int KT, int D) { return 16 * KT * pf_stride(D); }

// Dynamic shared memory of one block: the LUT and kv4's tables, the code
// buffers (the ring itself for int8, two steps for kv4) and kv4's packed
// ring.
__host__ __device__ constexpr int pf_smem_bytes(bool packed, int KT, int P, int D) {
  return kPfHead + (packed ? 2 : kPfSteps) * pf_pages_per_step(KT) * 2 * pf_tile_bytes(KT, D) +
         (packed ? kPfSteps * pf_pages_per_step(KT) * 2 * P * (D / 2) : 0);
}

// KT: the 16-row tiles one staged page spans (P up to 16, 32 or 64 rows).
__host__ __device__ constexpr int pf_kt(int P) { return P <= 16 ? 1 : P <= 32 ? 2 : 4; }

// Dynamic shared memory of one launch over P-row pages of head dim D.
template <class Pages>
int paged_prefill_smem(int P, int D) {
  return pf_smem_bytes(Pages::kPacked, pf_kt(P), P, D);
}

// Staging of one pool page (K and V rows of kv head h) by threads tid of
// nt, 16 bytes a copy: int8 codes straight to their tile at row stride ld
// ...
__device__ __forceinline__ void stage_page(const Int8Pages& pg, int8_t* kdst, int8_t* vdst,
                                           uint8_t*, int page, int P, int Hkv, int h, int D,
                                           int ld, int tid, int nt) {
  const size_t base = (static_cast<size_t>(page) * P * Hkv + h) * D;
  for (int e = tid; e < P * 8; e += nt) {
    const int r = e >> 3, c = (e & 7) << 4;
    if (c < D) {
      const size_t g = base + static_cast<size_t>(r) * Hkv * D + c;
      cp_async16(smem_u32(kdst + r * ld + c), pg.k + g, true);
      cp_async16(smem_u32(vdst + r * ld + c), pg.v + g, true);
    }
  }
}

// ... or the packed bytes, (P, D/2) row-major, and the page's two dequant
// tables: tab[x] (K) and tab[16 + x] (V) are the codes of raw nibble x,
// clip(round(((x ^ 8) - 8) * scale)) (dequant_code).
__device__ __forceinline__ void stage_page(const Int4Pages& pg, int8_t* kdst, int8_t* vdst,
                                           uint8_t* tab, int page, int P, int Hkv, int h, int D,
                                           int, int tid, int nt) {
  const int half = D / 2;
  const size_t base = (static_cast<size_t>(page) * P * Hkv + h) * half;
  for (int e = tid; e < P * 4; e += nt) {
    const int r = e >> 2, c = (e & 3) << 4;
    if (c < half) {
      const size_t g = base + static_cast<size_t>(r) * Hkv * half + c;
      cp_async16(smem_u32(kdst + r * half + c), pg.k + g, true);
      cp_async16(smem_u32(vdst + r * half + c), pg.v + g, true);
    }
  }
  if (tid < 32) {
    const int x = tid & 15;
    const float scale = tid < 16 ? pg.ks[page] : pg.vs[page];
    tab[tid] = static_cast<uint8_t>(dequant_code((x ^ 8) - 8, scale));
  }
}

// Four raw nibbles, one in the low half of each byte of nib, to their codes
// through a 16-byte table t: __byte_perm picks entries 0-7 and 8-15, bit 3
// of each nibble chooses between them.
__device__ __forceinline__ uint32_t nibble_codes(uint32_t nib, const uint4& t) {
  const uint32_t sel = __byte_perm(nib | (nib >> 4), 0u, 0x0020) & 0x7777u;
  const uint32_t lo = __byte_perm(t.x, t.y, sel), hi = __byte_perm(t.z, t.w, sel);
  const uint32_t m = ((nib >> 3) & 0x01010101u) * 0xffu;
  return (lo & ~m) | (hi & m);
}

// 16 packed bytes -> their 16 low-plane and 16 high-plane codes.
__device__ __forceinline__ void unpack16(int8_t* lo, int8_t* hi, uint4 w, const uint4& t) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t l[4], h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = nibble_codes(in[i] & 0x0f0f0f0fu, t);
    h[i] = nibble_codes((in[i] >> 4) & 0x0f0f0f0fu, t);
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
}

// kv4: one staged packed page -> its int8 codes at row stride ld.
__device__ __forceinline__ void unpack_page(const int8_t* kraw, const int8_t* vraw,
                                            const uint8_t* tab, int8_t* kc, int8_t* vc, int P,
                                            int D, int ld, int tid, int nt) {
  const int half = D / 2;
  const uint4 tk = *reinterpret_cast<const uint4*>(tab);
  const uint4 tv = *reinterpret_cast<const uint4*>(tab + 16);
  for (int e = tid; e < P * 4; e += nt) {
    const int r = e >> 2, c = (e & 3) << 4;
    if (c < half) {
      unpack16(kc + r * ld + c, kc + r * ld + half + c,
               *reinterpret_cast<const uint4*>(kraw + r * half + c), tk);
      unpack16(vc + r * ld + c, vc + r * ld + half + c,
               *reinterpret_cast<const uint4*>(vraw + r * half + c), tv);
    }
  }
}

// P.V leaves the mma biased by kPvBias, the bits of 1.5 * 2^23: for |pv| <
// 2^22 (at most 64 keys x 127 x 127 here) the biased int32 read as a float
// is 1.5 * 2^23 + pv exactly, and one exact subtraction gives float(pv).
constexpr int kPvBias = 0x4B400000;

__device__ __forceinline__ float pv_float(int biased) {
  return __fsub_rn(__int_as_float(biased), 12582912.0f);
}

// Block i of the 1-D grid: row tile ntiles - 1 - i / units (the longest
// rows first), then (slot, kv head, head group) from i % units.  Pages go
// U = pf_pages_per_step(KT) to a step.  Two blocks fit an SM (168
// registers; a few spill at KT = 1).
template <class Pages, int KT>
__global__ void __launch_bounds__((kPfMaxWarps + 1) * 32, 2)
paged_prefill_kernel(const int8_t* __restrict__ q, Pages pages, const int* __restrict__ btab,
                     const int* __restrict__ pos0_p, const int* __restrict__ lut,
                     const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
                     const float* __restrict__ inv_p, const float* __restrict__ osc_p,
                     int8_t* __restrict__ out, int H, int S, int Hkv, int D, int P, int nb,
                     int gh, int qsb, int qsh, int qss, int osb, int osh, int oss) {
  constexpr bool kPacked = Pages::kPacked;
  constexpr int U = pf_pages_per_step(KT);
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  uint8_t* s_tab = smem + kPfLutBytes;   // kv4: 32 bytes of dequant tables per packed slot
  int8_t* codes = reinterpret_cast<int8_t*>(smem + kPfHead);
  const int ld = pf_stride(D);
  const int tile = pf_tile_bytes(KT, D);
  int8_t* raw = codes + (kPacked ? 2 : kPfSteps) * U * 2 * tile;   // kv4's packed ring
  const int raw_half = P * (D / 2);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int G = H / Hkv, groups = G / gh;
  const int ntiles = (S + kPfRows - 1) / kPfRows;
  const int units = gridDim.x / ntiles;
  const int qt = ntiles - 1 - static_cast<int>(blockIdx.x) / units;
  const int u0 = static_cast<int>(blockIdx.x) % units;
  const int b = u0 / (Hkv * groups);
  const int h = u0 % (Hkv * groups) / groups;
  const bool stager = warp == gh;   // the last warp stages the pages
  const int hq = h * G + u0 % groups * gh + warp;
  const int row0 = qt * kPfRows;
  const int pos0 = pos0_p[b];
  const int last = pos0 + min(row0 + kPfRows, S) - 1;   // the tile's causal frontier
  const int np = min(last / P, nb - 1) + 1;
  const int nsteps = (np + U - 1) / U;
  const int* bt = btab + static_cast<size_t>(b) * nb;

  // the ring: step s's pages in slots (s % kPfSteps) U + u; kv4 unpacks
  // step s into code buffer s & 1 one step ahead of its use
  constexpr int kLead = kPfSteps - 1 + (kPacked ? 1 : 0);
  int ahead[U];   // the block-table entries of the next step to issue
  auto fetch = [&](int s) {
#pragma unroll
    for (int u = 0; u < U; ++u) ahead[u] = s * U + u < np ? bt[s * U + u] : 0;
  };
  auto issue = [&](int s) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s * U + u < np) {
        const int slot = s % kPfSteps * U + u;
        int8_t* dst = kPacked ? raw + slot * 2 * raw_half : codes + slot * 2 * tile;
        stage_page(pages, dst, dst + (kPacked ? raw_half : tile), s_tab + 32 * slot, ahead[u],
                   P, Hkv, h, D, ld, lane, 32);
      }
    }
    cp_async_commit();
    fetch(s + 1);
  };
  auto unpack = [&](int s) {
    if constexpr (kPacked) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s * U + u < np) {
          const int slot = s % kPfSteps * U + u;
          const int8_t* src = raw + slot * 2 * raw_half;
          int8_t* dst = codes + ((s & 1) * U + u) * 2 * tile;
          unpack_page(src, src + raw_half, s_tab + 32 * slot, dst, dst + tile, P, D, ld, tid, nt);
        }
      }
    }
  };
  if (stager) {
    for (int i = lane; i < kLutSize / 4; i += 32)
      cp_async16(smem_u32(s_lut + 4 * i), lut + 4 * i, true);
    fetch(0);
    for (int s = 0; s < kLead; ++s) issue(s);
  }

  // this lane's q fragments: rows row0 + g (+ 8), bytes 32 ks + 4 t (+ 16)
  uint32_t qf[4][4];
  const int8_t* qb = q + static_cast<long long>(b) * qsb + static_cast<long long>(hq) * qsh;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1), c = 32 * ks + 16 * (i >> 1) + 4 * t;
      qf[ks][i] = !stager && r < S && c < D
                      ? *reinterpret_cast<const uint32_t*>(qb + static_cast<long long>(r) * qss + c)
                      : 0u;
    }
  const LutIndex li(*Mi_p, *shi_p);
  const float inv = *inv_p;
  const int qpos[2] = {pos0 + row0 + g, pos0 + row0 + g + 8};
  int m[2] = {kNegInit, kNegInit};
  float den[2] = {0.0f, 0.0f};
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const bool v_live = 16 * g < D;   // this lane's V columns 16 g .. 16 g + 15
  const int krow = ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 16;

  if constexpr (kPacked) {
    if (stager) cp_async_wait<kLead - 1>();
    __syncthreads();
    if (nsteps > 0) unpack(0);
  }
  for (int s = 0; s < nsteps; ++s) {
    if (stager) cp_async_wait<kPfSteps - 2>();
    __syncthreads();
    if (stager) issue(s + kLead);
    if (s + 1 < nsteps) unpack(s + 1);
    if (stager) continue;
    const int8_t* step = codes + (kPacked ? (s & 1) : s % kPfSteps) * U * 2 * tile;

    // scores of the step's pages: page u, tile kt, n-tile n, element e ->
    // row g + 8 (e >> 1), key 16 kt + 8 n + 2 t + (e & 1), masked
    // (even and odd k steps into separate sums, two shorter mma chains)
    int sc[U][KT][2][4];
    int mx[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int8_t* kt_s = step + u * 2 * tile + krow;
      mx[u][0] = mx[u][1] = INT_MIN;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        int odd[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][kt][n][e] = odd[n][e] = 0;
        if (kt > 0 && 16 * kt >= P) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks > 0 && 32 * ks >= D) break;
          uint32_t kb[4];
          ldmatrix_x4(kb, kt_s + 16 * kt * ld + 32 * ks);
          int (&d0)[4] = ks & 1 ? odd[0] : sc[u][kt][0];
          int (&d1)[4] = ks & 1 ? odd[1] : sc[u][kt][1];
          mma_16832(d0, qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], kb[0], kb[1]);
          mma_16832(d1, qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], kb[2], kb[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][kt][n][e] = wrap_add(sc[u][kt][n][e], odd[n][e]);
      }
      const int kbase = (s * U + u) * P;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * kt + 8 * n + 2 * t + (e & 1);
            int v = sc[u][kt][n][e];
            v = kbase + key > qpos[e >> 1] ? wrap_sub(v, kMaskOffset) : v;
            sc[u][kt][n][e] = v;
            mx[u][e >> 1] = max(mx[u][e >> 1], key < P ? v : INT_MIN);
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) mx[u][i] = quad_max(mx[u][i]);
    }
    // the running max before (mo) and after (mn) each of the step's pages;
    // a page past the walk (p >= np) leaves the carry as it is (f = 1, no
    // numerators)
    int mo[U][2], mn[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = s * U + u < np;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mo[u][i] = m[i];
        mn[u][i] = live ? max(m[i], mx[u][i]) : m[i];
        m[i] = mn[u][i];
      }
    }
    // numerators, in place of the scores: every LUT index, then every
    // load, then the A fragments na[u][kt][row half], byte 2 n + (e & 1)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[u][kt][n][e] = li(wrap_sub(mn[u][e >> 1], sc[u][kt][n][e]));
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][kt][n][e] = s_lut[sc[u][kt][n][e]];
    uint32_t na[U][KT][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = s * U + u < np;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        na[u][kt][0] = na[u][kt][1] = 0u;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * kt + 8 * n + 2 * t + (e & 1);
            const uint32_t num = live && key < P ? sc[u][kt][n][e] & 0xff : 0u;
            na[u][kt][e >> 1] |= num << (8 * (2 * n + (e & 1)));
          }
      }
    }

    float f[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = s * U + u < np;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        f[u][i] = !live ? 1.0f
                  : mo[u][i] == kNegInit
                      ? 0.0f
                      : expf(__fmul_rn(static_cast<float>(wrap_sub(mo[u][i], mn[u][i])), inv));
    }

    // per page: P.V into int32 and the carry, four n-tiles (one word of
    // each V row) at a time
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u > 0 && s * U + u >= np) break;
      const int8_t* vt_s = step + u * 2 * tile + tile + 16 * g;
      uint4 vr[KT][4];
      int db[4] = {0, 0, 0, 0};   // den_b of rows g, g + 8: the numerators . ones
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt > 0 && 16 * kt >= P) continue;
        mma_16816(db, na[u][kt][0], na[u][kt][1], 0x01010101u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 16 * kt + 8 * (i >> 1) + 2 * t + (i & 1);
          vr[kt][i] = v_live ? *reinterpret_cast<const uint4*>(vt_s + key * ld)
                             : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        int pv[4][4];   // kPvBias + P.V of n-tiles 4 w + c
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[c][e] = kPvBias;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          if (kt > 0 && 16 * kt >= P) continue;
          const uint32_t rows[4] = {word_of(vr[kt][0], w), word_of(vr[kt][1], w),
                                    word_of(vr[kt][2], w), word_of(vr[kt][3], w)};
          uint32_t cols[4];
          transpose4(rows, cols);    // columns 16 g + 4 w + c, keys in na's byte order
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_16816(pv[c], na[u][kt][0], na[u][kt][1], cols[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * w + c][e] =
                __fadd_rn(__fmul_rn(acc[4 * w + c][e], f[u][e >> 1]), pv_float(pv[c][e]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        den[i] = __fadd_rn(__fmul_rn(den[i], f[u][i]), static_cast<float>(db[2 * i]));
    }
  }
  cp_async_wait<0>();
  if (stager) return;

  // acc[j][2 i + hh]: row g + 8 i, column 32 t + 16 hh + j
  const float osc = *osc_p;
  int8_t* ob = out + static_cast<long long>(b) * osb + static_cast<long long>(hq) * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = 32 * t + 16 * hh;
      if (c0 >= D) continue;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         attn_out(acc[j][2 * i + hh], den[i], osc)))
                     << (8 * (j & 3));
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * oss + c0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// q int8 (B, H, S, D) and out int8 like it through their (batch, head,
// row) element strides; gh q heads per block (dividing G = H / Hkv, at most
// kPfMaxWarps).
template <class Pages>
int launch_paged_prefill(const void* q, Pages pages, const void* btab, const void* pos0,
                         const void* lut, const void* Mi, const void* shi, const void* inv,
                         const void* osc, void* out, int B, int H, int S, int Hkv, int D,
                         int P, int nb, int gh, int qsb, int qsh, int qss, int osb, int osh,
                         int oss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int KT = pf_kt(P);
  auto kernel = KT == 1 ? paged_prefill_kernel<Pages, 1>
                : KT == 2 ? paged_prefill_kernel<Pages, 2> : paged_prefill_kernel<Pages, 4>;
  const int bytes = pf_smem_bytes(Pages::kPacked, KT, P, D);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (S + kPfRows - 1) / kPfRows * B * Hkv * (H / Hkv / gh);
  kernel<<<blocks, 32 * (gh + 1), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), pages, static_cast<const int*>(btab),
      static_cast<const int*>(pos0), static_cast<const int*>(lut), static_cast<const int*>(Mi),
      static_cast<const int*>(shi), static_cast<const float*>(inv),
      static_cast<const float*>(osc), static_cast<int8_t*>(out), H, S, Hkv, D, P, nb, gh, qsb,
      qsh, qss, osb, osh, oss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fq
