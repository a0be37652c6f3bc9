// Causal integer flash attention (the cache-less prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_qattention.py::
// flash_qattention (Pallas grid (q head, q block of bq rows, KV block of
// bkv keys), GQA through the K/V index map, KV blocks wholly past a q
// block's causal frontier skipped).  Per KV block of bkv keys the datapath
// is the reference's (flash_qattention_jax, kernels/flash_qattention.py::
// flash_qattention_torch):
//
//   s    = int8 q . int8 k                       (int32)
//   s    = live ? s : s - 2^30                   (qpos = q_offset + row;
//          live: kpos <= qpos, and kpos > qpos - window with a window)
//   m'   = max(m, max_block s);  f = exp((m - m') * inv)  (0 while m unset)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num;  acc = acc * f + num . int8 v   (per block)
//
// and the epilogue round(acc / max(den, 1) * out_scale) clipped to +-127
// (paged_attention.cuh's attn_out: no fast math, no FMA contraction, so the
// result equals the plain version's bit for bit).
//
// Layout: q and out (B, H, Sq, D), k and v (B, Hkv, Skv, D), each read
// through its own (batch, head, row) strides with D contiguous — so the
// serving forward's (B, S, H, D) projections are read in place, and the
// output is written in the layout of q.  Kv head = h / G.
//
// Design: PR 17's paged prefill (paged_prefill.cuh) on a contiguous K/V,
// with the bkv block as the carry's unit.  A CTA serves 16 query rows x gh
// q heads of one kv head (one warp each, gh dividing G, at most 4; the
// wrapper picks gh so that the grid covers the SMs), the longest rows
// first, so the G q heads of a kv head share one staging of K and V.  One
// more warp, the stager, copies 32-key steps of K (and V) by 16-byte
// cp.async into a ring of three steps (two in flight), at a row stride that
// is an odd multiple of 16 bytes.  A row's numerators need the whole
// block's max first, so every block is walked twice, step by step:
//
//   sweep 1  QK^T on mma.sync m16n8k32 (K by ldmatrix), masked, each row's
//            max over the block's keys;
//   sweep 2  QK^T again (exact: integers), the LUT numerators against the
//            block's running max, den_b (an mma against ones) and P.V on
//            mma.sync m16n8k16, both summed in int32 registers across the
//            block (at most 512 * 127 * 127 < 2^31, exact);
//
// then once per block the fp32 carry, den in registers and acc in shared
// memory (64 floats a lane, each lane its own, so no barrier), with the
// reference's roundings.  Keys of a step past the block's end count for
// neither the max nor the sums; blocks wholly past the tile's causal
// frontier are skipped, as in Pallas, and so are the steps of the last
// block past it: for every row of the tile those keys are masked, below any
// live score, and their index clips to 255, whose table entry is 0 (they
// would add num = 0 with f = 1).  bkv is the caller's: any divisor of Skv
// up to 512, odd ones included (37 for a 37-token prefill).
//
// A sliding window (window > 0) masks per element in both sweeps.  The
// reference computes the blocks below a row's window too: their masked
// scores set m to a masked max and fill den and acc with nonzero
// numerators, which the row's first live block scales by f = exp((m_old -
// m_new) * inv), m_old - m_new <= -(2^30 - 2 D 127^2).  Where that product
// is below -skip_exp_arg, f is exactly 0.0f for every row, so a tile may
// start at the first block live for its first row (the others' windows
// start later); the kernel decides it per CTA from the inv it reads, with
// the threshold the wrapper passes (kernels/ref.py::SKIP_EXP_ARG, which
// window_skip_margin and the plain tiled mirror use too), and otherwise
// walks from block 0, bit for bit the reference's carry.
//
// What bounds it on the H100: int8 operations for long sequences — the
// live causal pairs times 4 * D (QK and PV) at the 1,979 TOP/s int8 tensor
// rate — against the bytes of Q, K, V and the output.  The second sweep
// adds half the products again; what the CTA cannot go below is the serial
// walk of its longest rows, two steps per 32 keys.
#include "mma_sync.cuh"
#include "paged_attention.cuh"

namespace {

using namespace fq;

constexpr int kSteps = 3;        // steps in the cp.async ring (two in flight)
constexpr int kMaxWarps = 4;     // q heads per CTA, one warp each
constexpr int kRows = 16;        // query rows per CTA (the mma's m16)
constexpr int kStepKeys = 32;    // keys per step: two 16-key tiles
constexpr int kLutBytes = kLutSize * 4;
constexpr int kAccFloats = 64 * 32;   // a warp's fp32 accumulators

// Row stride of a staged K or V step: D rounded up to the QK^T k-step,
// plus 16 bytes (an odd multiple of 16 bytes in all).
__host__ __device__ constexpr int row_stride(int D) { return (D + 31) / 32 * 32 + 16; }

__host__ __device__ constexpr int smem_bytes(int D, int gh) {
  return kLutBytes + kSteps * 2 * kStepKeys * row_stride(D) + gh * kAccFloats * 4;
}

// Block j's keys run [j bkv, j bkv + bkv); its steps start at j bkv + 32 u.
// The tile walks nblk blocks from block j0; every block but the last walks
// spb = ceil(bkv / 32) steps a sweep, the last nlast (its keys up to the
// causal frontier).  Step s of the walk:
struct Walk {
  int bkv, spb, j0, nblk, nlast;
  __device__ __forceinline__ int len(int j) const { return j == j0 + nblk - 1 ? nlast : spb; }
  __device__ __forceinline__ bool at(int s, int& j, int& u) const {
    const int jj = s / (2 * spb);
    j = j0 + jj;
    const int n = len(j);
    const int r = s - jj * 2 * spb;
    u = r < n ? r : r - n;
    return r >= n;   // the second sweep
  }
  __device__ __forceinline__ int steps() const { return 2 * ((nblk - 1) * spb + nlast); }
};

__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 2)
flash_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
             const int8_t* __restrict__ v, const int* __restrict__ lut,
             const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
             const float* __restrict__ inv_p, const float* __restrict__ osc_p,
             int8_t* __restrict__ out, int H, int Hkv, int D, int Sq, int Skv, int bkv,
             int q_offset, int window, int skip_exp_arg, int gh, int qsb, int qsh, int qss,
             int ksb, int ksh, int kss, int osb, int osh, int oss) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lut = reinterpret_cast<int*>(smem);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + kLutBytes);
  const int ld = row_stride(D);
  const int tile = kStepKeys * ld;   // one staged K or V step
  float* s_acc = reinterpret_cast<float*>(ring + kSteps * 2 * tile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int G = H / Hkv, groups = G / gh;
  const int ntiles = (Sq + kRows - 1) / kRows;
  const int units = gridDim.x / ntiles;
  const int qt = ntiles - 1 - static_cast<int>(blockIdx.x) / units;
  const int u0 = static_cast<int>(blockIdx.x) % units;
  const int b = u0 / (Hkv * groups);
  const int h = u0 % (Hkv * groups) / groups;
  const bool stager = warp == gh;   // the last warp stages K and V
  const int hq = h * G + u0 % groups * gh + warp;
  const int row0 = qt * kRows;
  const int last = q_offset + min(row0 + kRows, Sq) - 1;   // the tile's causal frontier
  const float inv = *inv_p;
  const int jend = min(Skv / bkv, last / bkv + 1);           // blocks up to the frontier
  // the first block live for the tile's first row, where skipping the
  // blocks below it leaves the reference's result (see the header)
  const bool skip = window > 0 && static_cast<double>((1 << 30) - 2 * D * 127 * 127) *
                                          static_cast<double>(inv) > skip_exp_arg;
  Walk walk;
  walk.bkv = bkv;
  walk.spb = (bkv + kStepKeys - 1) / kStepKeys;
  walk.j0 = skip ? min(max(0, q_offset + row0 - window + 1) / bkv, jend - 1) : 0;
  walk.nblk = jend - walk.j0;
  walk.nlast = (min(bkv, last + 1 - (jend - 1) * bkv) + kStepKeys - 1) / kStepKeys;
  const int nsteps = walk.steps();
  const int8_t* kb = k + static_cast<long long>(b) * ksb + static_cast<long long>(h) * ksh;
  const int8_t* vb = v + static_cast<long long>(b) * ksb + static_cast<long long>(h) * ksh;

  // the stager: step s's K rows (and V rows in the second sweep) into ring
  // slot s % kSteps; rows past the block's end are zero-filled
  auto issue = [&](int s) {
    if (s < nsteps) {
      int j, u;
      const bool second = walk.at(s, j, u);
      const int key0 = j * bkv + u * kStepKeys, end = j * bkv + bkv;
      int8_t* kd = ring + s % kSteps * 2 * tile;
      for (int e = lane; e < kStepKeys * 8; e += 32) {
        const int r = e >> 3, c = (e & 7) << 4;
        if (c < D) {
          const bool ok = key0 + r < end;
          const long long off = static_cast<long long>(ok ? key0 + r : 0) * kss + c;
          cp_async16(smem_u32(kd + r * ld + c), kb + off, ok);
          if (second) cp_async16(smem_u32(kd + tile + r * ld + c), vb + off, ok);
        }
      }
    }
    cp_async_commit();
  };
  if (stager) {
    for (int i = lane; i < kLutSize / 4; i += 32)
      cp_async16(smem_u32(s_lut + 4 * i), lut + 4 * i, true);
    for (int s = 0; s < kSteps - 1; ++s) issue(s);
  }

  // this lane's q fragments: rows row0 + g (+ 8), bytes 32 ks + 4 t (+ 16)
  uint32_t qf[4][4];
  const int8_t* qb = q + static_cast<long long>(b) * qsb + static_cast<long long>(hq) * qsh;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1), c = 32 * ks + 16 * (i >> 1) + 4 * t;
      qf[ks][i] = !stager && r < Sq && c < D
                      ? *reinterpret_cast<const uint32_t*>(qb + static_cast<long long>(r) * qss + c)
                      : 0u;
    }
  const LutIndex li(*Mi_p, *shi_p);
  const int qpos[2] = {q_offset + row0 + g, q_offset + row0 + g + 8};
  // a key at or below lo is outside the row's window
  const int lo[2] = {window > 0 ? qpos[0] - window : INT_MIN,
                     window > 0 ? qpos[1] - window : INT_MIN};
  // acc (j, e) of this lane at acc_l[(4 j + e) * 32]: row g + 8 (e >> 1),
  // column 32 t + 16 (e & 1) + j
  float* acc_l = s_acc + warp * kAccFloats + lane;
  if (!stager)
    for (int x = 0; x < 64; ++x) acc_l[x * 32] = 0.0f;
  int m[2] = {kNegInit, kNegInit};   // the running max of rows g, g + 8
  int mn[2] = {kNegInit, kNegInit};  // ... after the block being walked
  int mx[2] = {INT_MIN, INT_MIN};    // the block's max so far (sweep 1)
  float den[2] = {0.0f, 0.0f};
  int db[4] = {0, 0, 0, 0};          // den_b of rows g (db[0]), g + 8 (db[2])
  int pv[16][4];                     // P.V of n-tile j, as acc
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[j][e] = 0;
  const bool v_live = 16 * g < D;   // this lane's V columns 16 g .. 16 g + 15
  const int krow = ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 16;

  for (int s = 0; s < nsteps; ++s) {
    if (stager) cp_async_wait<kSteps - 2>();
    __syncthreads();
    if (stager) {
      issue(s + kSteps - 1);
      continue;
    }
    int j, u;
    const bool second = walk.at(s, j, u);
    const int n = walk.len(j);
    const int key0 = j * bkv + u * kStepKeys, end = j * bkv + bkv;
    const int8_t* kt_s = ring + s % kSteps * 2 * tile;

    // scores of the step's two tiles: tile kt, n-tile nn, element e -> row
    // g + 8 (e >> 1), key key0 + 16 kt + 8 nn + 2 t + (e & 1), masked (even
    // and odd k steps into separate sums, two shorter mma chains); a tile
    // past the block's end or the frontier is not computed
    int sc[2][2][4];
    bool tl[2];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      tl[kt] = key0 + 16 * kt < end && key0 + 16 * kt <= last;
      int odd[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[kt][nn][e] = odd[nn][e] = 0;
      if (tl[kt]) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks > 0 && 32 * ks >= D) break;
          uint32_t kf[4];
          ldmatrix_x4(kf, kt_s + krow + 16 * kt * ld + 32 * ks);
          int (&d0)[4] = ks & 1 ? odd[0] : sc[kt][0];
          int (&d1)[4] = ks & 1 ? odd[1] : sc[kt][1];
          mma_16832(d0, qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], kf[0], kf[1]);
          mma_16832(d1, qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 16 * kt + 8 * nn + 2 * t + (e & 1);
          const int x = wrap_add(sc[kt][nn][e], odd[nn][e]);
          sc[kt][nn][e] = key > qpos[e >> 1] || key <= lo[e >> 1] ? wrap_sub(x, kMaskOffset) : x;
        }
    }

    if (!second) {
      // sweep 1: the block's row max
      if (u == 0) mx[0] = mx[1] = INT_MIN;
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 16 * kt + 8 * nn + 2 * t + (e & 1);
            if (tl[kt] && key < end) mx[e >> 1] = max(mx[e >> 1], sc[kt][nn][e]);
          }
      if (u == n - 1)
#pragma unroll
        for (int i = 0; i < 2; ++i) mn[i] = max(m[i], quad_max(mx[i]));
      continue;
    }

    // sweep 2: numerators against mn in place of the scores (every LUT
    // index, then every load), then the A fragments na[kt][row half],
    // byte 2 nn + (e & 1)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[kt][nn][e] = li(wrap_sub(mn[e >> 1], sc[kt][nn][e]));
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[kt][nn][e] = s_lut[sc[kt][nn][e]];
    uint32_t na[2][2];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      na[kt][0] = na[kt][1] = 0u;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 16 * kt + 8 * nn + 2 * t + (e & 1);
          const uint32_t num = key < end ? sc[kt][nn][e] & 0xff : 0u;
          na[kt][e >> 1] |= num << (8 * (2 * nn + (e & 1)));
        }
    }
    // den_b and P.V in int32 across the block, tile by tile, four n-tiles
    // (one word of each V row) at a time
    const int8_t* vt_s = kt_s + tile + 16 * g;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (!tl[kt]) continue;
      mma_16816(db, na[kt][0], na[kt][1], 0x01010101u);
      uint4 vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 16 * kt + 8 * (i >> 1) + 2 * t + (i & 1);
        vr[i] = v_live ? *reinterpret_cast<const uint4*>(vt_s + key * ld)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t rows[4] = {word_of(vr[0], w), word_of(vr[1], w), word_of(vr[2], w),
                                  word_of(vr[3], w)};
        uint32_t cols[4];
        transpose4(rows, cols);    // columns 16 g + 4 w + c, keys in na's byte order
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_16816(pv[4 * w + c], na[kt][0], na[kt][1], cols[c]);
      }
    }
    if (u < n - 1) continue;

    // the block's end: the fp32 carry, then a fresh block
    float f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[i] = m[i] == kNegInit
                 ? 0.0f
                 : expf(__fmul_rn(static_cast<float>(wrap_sub(m[i], mn[i])), inv));
      den[i] = __fadd_rn(__fmul_rn(den[i], f[i]), static_cast<float>(db[2 * i]));
      m[i] = mn[i];
    }
#pragma unroll
    for (int x = 0; x < 16; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = acc_l[(4 * x + e) * 32];
        a = __fadd_rn(__fmul_rn(a, f[e >> 1]), static_cast<float>(pv[x][e]));
        pv[x][e] = 0;
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) db[e] = 0;
  }
  cp_async_wait<0>();
  if (stager) return;

  const float osc = *osc_p;
  int8_t* ob = out + static_cast<long long>(b) * osb + static_cast<long long>(hq) * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = 32 * t + 16 * hh;
      if (c0 >= D) continue;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int x = 0; x < 16; ++x)
        w[x >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         attn_out(acc_l[(4 * x + 2 * i + hh) * 32], den[i], osc)))
                     << (8 * (x & 3));
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * oss + c0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace

// q int8 (B, H, Sq, D) and k/v int8 (B, Hkv, Skv, D) through their element
// strides (batch, head, row; D contiguous, every stride and base a multiple
// of 16 bytes), lut int32 (256,) of codes in [0, 127], M_idx/sh_idx int32
// and inv_s_logit/out_scale fp32 scalars in device memory, out int8
// (B, H, Sq, D) through its strides; gh q heads per CTA; window 0 for
// none; skip_exp_arg the exp argument below which the carry factor over
// skipped masked blocks is 0.0f.  Needs H % Hkv == 0, gh dividing H / Hkv and at most 4, D <= 128
// with D % 16 == 0, bkv <= 512 dividing Skv, q_offset >= 0, window >= 0
// (the wrapper checks).
extern "C" int flash_qattention(const void* q, const void* k, const void* v, const void* lut,
                                const void* Mi, const void* shi, const void* inv,
                                const void* osc, void* out, int B, int H, int Hkv, int D,
                                int Sq, int Skv, int bkv, int q_offset, int window,
                                int skip_exp_arg, int gh, int qsb, int qsh, int qss, int ksb,
                                int ksh, int kss, int osb, int osh, int oss, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  const int bytes = smem_bytes(D, gh);
  const cudaError_t e =
      cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (Sq + kRows - 1) / kRows * B * Hkv * (H / Hkv / gh);
  flash_kernel<<<blocks, 32 * (gh + 1), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(lut), static_cast<const int*>(Mi),
      static_cast<const int*>(shi), static_cast<const float*>(inv),
      static_cast<const float*>(osc), static_cast<int8_t*>(out), H, Hkv, D, Sq, Skv, bkv,
      q_offset, window, skip_exp_arg, gh, qsb, qsh, qss, ksb, ksh, kss, osb, osh, oss);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one launch at head dim D, gh q heads a block.
extern "C" int flash_qattention_smem(int D, int gh) { return smem_bytes(D, gh); }
