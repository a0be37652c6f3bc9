// Causal integer flash attention (the cache-less prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_qattention.py::
// flash_qattention (Pallas grid (q head, q block of bq rows, KV block of
// bkv keys), GQA through the K/V index map, KV blocks wholly past a q
// block's causal frontier skipped).  Per KV block of bkv keys the datapath
// is the reference's (flash_qattention_jax, kernels/flash_qattention.py::
// flash_qattention_torch):
//
//   s    = int8 q . int8 k                       (int32, __dp4a)
//   s    = kpos <= qpos ? s : s - 2^30           (qpos = q_offset + row)
//   m'   = max(m, max_block s);  f = exp((m - m') * inv)  (0 while m unset)
//   num  = LUT_q7[clip(rescale(m' - s, M_idx, sh_idx, 9), 0, 255)]
//   den  = den * f + sum num;  acc = acc * f + num . int8 v   (per block)
//
// and the epilogue round(acc / max(den, 1) * out_scale) clipped to +-127
// (paged_attention.cuh's carry_update and attn_out: no fast math, no FMA
// contraction, so the result equals the plain version's bit for bit).
//
// Layout: q and out (B, H, Sq, D), k and v (B, Hkv, Skv, D), each read
// through its own (batch, head, row) strides with D contiguous — so the
// serving forward's (B, S, H, D) projections are read in place, and the
// output is written in the layout of q.  Kv head = h / G.
//
// Design: one block of 128 threads holds kRows = 32 query rows of one
// (batch, head) and walks the KV blocks up to its causal frontier; blocks
// wholly past it are skipped, as in Pallas (a skipped block would add
// num = 0 with f = 1: the masked keys' index clips to 255, whose table entry
// is 0).  A KV block runs in two passes over 64-row tiles: pass 1 streams K
// and writes the 32 x bkv int32 scores into shared memory (rows padded to a
// stride odd modulo 32, 64 KB at bkv = 512); then the block's max, the
// carry's rescale factor and the numerators in place; pass 2 streams V and
// sums num . v in int32 registers over the whole block (exact: at most
// 512 * 127 * 128 < 2^31), so f multiplies the carry once per block as in
// the reference.  Each thread holds a 4-row x 4-key tile of scores in pass
// 1 and a 4-row x 8-column tile of the output in pass 2; the q and K/V
// tiles sit in shared memory at a padded row stride of 33 words, so
// neither pass has bank conflicts.  bkv is the caller's: any divisor of
// Skv up to 512, odd ones included (37 for a 37-token prefill).
//
// What bounds it on the H100: int8 operations for long sequences — the
// live causal pairs times 4 * D (QK and PV) at the 1,979 TOP/s int8 tensor
// rate — against the bytes of Q, K, V and the output.  This version
// multiplies on the CUDA cores (__dp4a and int32 multiply-adds), far from
// that rate; tensor-core MMA (int8 mma / wgmma) is later work.
#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;                  // query rows per block
constexpr int kTile = 64;                  // K/V rows staged at a time
constexpr int kMaxBkv = 512;
constexpr int kW = fq::kMaxD / 4 + 1;      // shared row stride in 32-bit words
constexpr int kRowGroups = 8;              // threads: 8 row groups x 16 column groups
constexpr int kColGroups = kThreads / kRowGroups;
constexpr int kRi = kRows / kRowGroups;    // rows per thread
constexpr int kKj = kTile / kColGroups;    // keys per thread (pass 1)
constexpr int kCj = fq::kMaxD / 4 / kColGroups;   // 4-column groups per thread (pass 2)

__host__ __device__ constexpr int score_ld(int bkv) { return (bkv + 31) / 32 * 32 + 1; }

__host__ __device__ constexpr int smem_bytes(int bkv) {
  return 4 * (fq::kLutSize + 4 * kRows + kRows * kW + kTile * kW + kRows * score_ld(bkv));
}

// Rows [0, rows) of a (row stride, D) int8 matrix into shared memory at a
// row stride of kW words; rows at or past `valid` are zero.
__device__ __forceinline__ void load_rows(int* dst, const int8_t* src, long long stride,
                                          int rows, int valid, int D) {
  const int vecs = D / 16;
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = e % vecs;
    const int4 w = r < valid ? *reinterpret_cast<const int4*>(src + r * stride + c * 16)
                             : make_int4(0, 0, 0, 0);
    int* d = dst + r * kW + c * 4;
    d[0] = w.x;
    d[1] = w.y;
    d[2] = w.z;
    d[3] = w.w;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
             const int8_t* __restrict__ v, const int* __restrict__ lut,
             const int* __restrict__ Mi_p, const int* __restrict__ shi_p,
             const float* __restrict__ inv_p, const float* __restrict__ osc_p,
             int8_t* __restrict__ out, int G, int D, int Sq, int Skv, int bkv, int q_offset,
             int qsb, int qsh, int qss, int ksb, int ksh, int kss, int osb, int osh,
             int oss) {
  extern __shared__ int smem[];
  const int ld = score_ld(bkv);
  int* s_lut = smem;
  int* s_m = s_lut + fq::kLutSize;
  int* s_mnew = s_m + kRows;
  float* s_f = reinterpret_cast<float*>(s_mnew + kRows);
  float* s_den = s_f + kRows;
  int* s_q = reinterpret_cast<int*>(s_den + kRows);
  int* s_kv = s_q + kRows * kW;
  int* s_s = s_kv + kTile * kW;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kRows;
  const int nrows = min(kRows, Sq - q0);
  const int8_t* kb = k + b * static_cast<long long>(ksb) + (h / G) * static_cast<long long>(ksh);
  const int8_t* vb = v + b * static_cast<long long>(ksb) + (h / G) * static_cast<long long>(ksh);
  for (int i = tid; i < fq::kLutSize; i += kThreads) s_lut[i] = lut[i];
  for (int r = tid; r < kRows; r += kThreads) {
    s_m[r] = fq::kNegInit;
    s_den[r] = 0.0f;
  }
  load_rows(s_q, q + b * static_cast<long long>(qsb) + h * static_cast<long long>(qsh) +
                     q0 * static_cast<long long>(qss), qss, kRows, nrows, D);
  const int tr = tid / kColGroups;
  const int tc = tid % kColGroups;
  const int ncg = D / 4;
  float acc[kRi][kCj][4];
#pragma unroll
  for (int i = 0; i < kRi; ++i)
#pragma unroll
    for (int j = 0; j < kCj; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.0f;
  const int Mi = *Mi_p;
  const int shi = *shi_p;
  const float inv = *inv_p;
  const int last = q_offset + q0 + nrows - 1;    // the block's causal frontier
  const int nblk = min(Skv / bkv, last / bkv + 1);
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const int base = blk * bkv;
    // pass 1: the 32 x bkv scores of the block, masked
    for (int t0 = 0; t0 < bkv; t0 += kTile) {
      const int rows = min(kTile, bkv - t0);
      load_rows(s_kv, kb + (base + t0) * static_cast<long long>(kss), kss, rows, rows, D);
      __syncthreads();
      int sc[kRi][kKj];
#pragma unroll
      for (int i = 0; i < kRi; ++i)
#pragma unroll
        for (int j = 0; j < kKj; ++j) sc[i][j] = 0;
      for (int w = 0; w < ncg; ++w) {
        int qw[kRi], kw[kKj];
#pragma unroll
        for (int i = 0; i < kRi; ++i) qw[i] = s_q[(tr + kRowGroups * i) * kW + w];
#pragma unroll
        for (int j = 0; j < kKj; ++j) kw[j] = s_kv[(tc + kColGroups * j) * kW + w];
#pragma unroll
        for (int i = 0; i < kRi; ++i)
#pragma unroll
          for (int j = 0; j < kKj; ++j) sc[i][j] = __dp4a(qw[i], kw[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRi; ++i) {
        const int r = tr + kRowGroups * i;
        const int qpos = q_offset + q0 + r;
#pragma unroll
        for (int j = 0; j < kKj; ++j) {
          const int c = tc + kColGroups * j;
          if (c < rows) {
            int s = sc[i][j];
            if (base + t0 + c > qpos) s = fq::wrap_sub(s, fq::kMaskOffset);
            s_s[r * ld + t0 + c] = s;
          }
        }
      }
      __syncthreads();
    }
    // the block's max, the carry's rescale factor, numerators and den
    fq::carry_update<kThreads>(s_s, kRows, bkv, ld, s_m, s_mnew, s_f, s_den, s_lut, Mi, shi,
                               inv);
    // pass 2: num . v over the whole block in int32
    int pv[kRi][kCj][4];
#pragma unroll
    for (int i = 0; i < kRi; ++i)
#pragma unroll
      for (int j = 0; j < kCj; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[i][j][x] = 0;
    for (int t0 = 0; t0 < bkv; t0 += kTile) {
      const int rows = min(kTile, bkv - t0);
      load_rows(s_kv, vb + (base + t0) * static_cast<long long>(kss), kss, rows, rows, D);
      __syncthreads();
      for (int c = 0; c < rows; ++c) {
        int n[kRi];
#pragma unroll
        for (int i = 0; i < kRi; ++i) n[i] = s_s[(tr + kRowGroups * i) * ld + t0 + c];
#pragma unroll
        for (int j = 0; j < kCj; ++j) {
          const int cg = tc + kColGroups * j;
          if (cg < ncg) {
            const int w = s_kv[c * kW + cg];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int vx = static_cast<int>(static_cast<int8_t>(w >> (8 * x)));
#pragma unroll
              for (int i = 0; i < kRi; ++i) pv[i][j][x] += n[i] * vx;
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRi; ++i) {
      const float f = s_f[tr + kRowGroups * i];
#pragma unroll
      for (int j = 0; j < kCj; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc[i][j][x] = __fadd_rn(__fmul_rn(acc[i][j][x], f), static_cast<float>(pv[i][j][x]));
    }
  }
  const float osc = *osc_p;
  int8_t* ob = out + b * static_cast<long long>(osb) + h * static_cast<long long>(osh) +
               q0 * static_cast<long long>(oss);
#pragma unroll
  for (int i = 0; i < kRi; ++i) {
    const int r = tr + kRowGroups * i;
    if (r >= nrows) continue;
    const float den = s_den[r];
#pragma unroll
    for (int j = 0; j < kCj; ++j) {
      const int cg = tc + kColGroups * j;
      if (cg >= ncg) continue;
      unsigned word = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        word |= static_cast<unsigned>(static_cast<uint8_t>(fq::attn_out(acc[i][j][x], den, osc)))
                << (8 * x);
      *reinterpret_cast<unsigned*>(ob + r * static_cast<long long>(oss) + cg * 4) = word;
    }
  }
}

}  // namespace

// q int8 (B, H, Sq, D) and k/v int8 (B, Hkv, Skv, D) through their element
// strides (batch, head, row; D contiguous, every stride and base a multiple
// of 16 bytes), lut int32 (256,), M_idx/sh_idx int32 and inv_s_logit/
// out_scale fp32 scalars in device memory, out int8 (B, H, Sq, D) through
// its strides.  Needs G = H / Hkv, D <= 128 with D % 16 == 0, bkv <= 512
// dividing Skv, q_offset >= 0 (the wrapper checks).
extern "C" int flash_qattention(const void* q, const void* k, const void* v, const void* lut,
                                const void* Mi, const void* shi, const void* inv,
                                const void* osc, void* out, int B, int H, int G, int D, int Sq,
                                int Skv, int bkv, int q_offset, int qsb, int qsh, int qss,
                                int ksb, int ksh, int kss, int osb, int osh, int oss,
                                void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxBkv));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B > 0 && H > 0 && Sq > 0)
    flash_kernel<<<dim3((Sq + kRows - 1) / kRows, H, B), kThreads, smem_bytes(bkv),
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const int*>(lut),
        static_cast<const int*>(Mi), static_cast<const int*>(shi),
        static_cast<const float*>(inv), static_cast<const float*>(osc),
        static_cast<int8_t*>(out), G, D, Sq, Skv, bkv, q_offset, qsb, qsh, qss, ksb, ksh, kss,
        osb, osh, oss);
  return static_cast<int>(cudaGetLastError());
}
