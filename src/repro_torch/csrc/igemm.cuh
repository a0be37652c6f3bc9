// The shared core of the port's two integer GEMMs (int4_matmul.cu,
// int8_bitsplit_matmul.cu): y = requantize8(x @ W + bias), int8 x (M, K),
// W either K-planar nibble-packed uint8 (K/2, N) (kW4) or int8 (K, N), int32
// accumulation, the Q15 requantize of common.cuh.  Integer sums are exact in
// any order, so every path, tile and K split gives the same array.
//
// Two paths, chosen by the wrapper (kernels/int4_matmul.py::plan):
//
// * tc_kernel, M > 8: Hopper's int8 tensor cores through wgmma
//   (m64nBNk32 .s32.s8.s8, both operands K-major in 128-byte-swizzled shared
//   memory), one or two consumer warpgroups on a BM x BN output tile.  A
//   4-stage ring in dynamic shared memory is filled by 16-byte cp.async
//   (4-byte where N % 16 != 0) three stages ahead: x rows go straight into
//   the swizzled A layout; the weights, whose reference layout is N-major,
//   land raw and every thread transposes one stage (and unpacks the nibbles
//   with 32-bit mask-and-multiply and __byte_perm) into the K-major B buffer
//   while the tensor cores run the previous stage's wgmmas.  A stage is 128
//   k values: for W4, 64 packed rows, whose low nibbles pair with x[:,
//   k0:k0+64] and high nibbles with x[:, K/2+k0 : K/2+k0+64], so x needs no
//   reordering.  Where the tiles fill less than a wave of SMs the wrapper
//   splits K (blockIdx.z); the int32 partials go to a workspace and
//   reduce_kernel adds them in a fixed order with the bias and requantize.
//
// * decode_kernel, M <= 8: the packed weights are the only large operand,
//   so the bound is bytes.  Operands are swapped: 16 weight columns fill the
//   M side of mma.sync m16n8k32, the (up to 8) tokens its n8 side.  x's K
//   slice is staged once per block; each warp streams 32 weight rows x 128
//   columns per step with 16-byte loads straight into registers (the next
//   step's loads in flight while this step's MMAs run), transposes them
//   with __byte_perm into A fragments, and the block's 8 warps sum in shared
//   memory.  A block owns 128 columns and a K slice; K is split so that the
//   blocks cover the SMs.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma_sync.cuh"

namespace fq {
namespace igemm {

constexpr int kStages = 4;         // tc ring depth
constexpr int kStageK = 128;       // k values per tc stage (one swizzled 128-byte row)
constexpr int kDecodeWarps = 8;
constexpr int kDecodeCols = 128;   // weight columns per decode block
constexpr int kDecodeRows = 32;    // weight rows per decode warp step

// ---- PTX helpers ----------------------------------------------------------

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
// that ends its wgmmas (only there: an instruction that defines an
// accumulator while wgmmas are in flight makes ptxas serialize them)
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), atoms 1024-aligned.
// Adding 2 advances the start by 32 bytes, one k32 step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// byte offset of (row, byte k) in a 128-byte-row tile under the 128-byte
// swizzle: 16-byte chunk k/16 of row r sits at chunk (k/16) ^ (r % 8)
__device__ __forceinline__ int sw128(int row, int k) {
  return row * 128 + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// Sign-extends the four nibbles held in the low half of each byte
// (0..15 -> -8..7, the reference's (v ^ 8) - 8): 0x08 * 0x1e = 0xf0 stays
// inside its byte, so one multiply sets the high nibble of every negative
// code.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1eu);
}

// ---- wgmma m64nNk32 .s32.s8.s8, every accumulator register spelled out ---

// d = A (64 x 32, K-major, swizzled) . B (32 x 64, K-major, swizzled) (+ d if
// accumulate), int8 -> int32.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A (64 x 32, K-major, swizzled) . B (32 x 128, K-major, swizzled) (+ d if
// accumulate), int8 -> int32.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- tensor-core path (M > 8) --------------------------------------------

template <bool kW4, int BM, int BN>
struct TcShape {
  static constexpr int kThreads = BM * 2;              // BM / 64 warpgroups
  static constexpr int kRawRows = kW4 ? 64 : 128;      // weight rows per stage
  static constexpr int kChunks = BN / 16;              // 16-byte chunks per raw row
  static constexpr int kABytes = BM * 128;
  static constexpr int kRawBytes = kRawRows * BN;
  static constexpr int kBBytes = BN * 128;
  static constexpr int kOutStride = BN + 16;           // epilogue staging row
  static constexpr int kSmem = kStages * (kABytes + kRawBytes) + 2 * kBBytes + 1024;
  static_assert(BM * kOutStride <= kStages * kABytes, "epilogue tile must fit the A ring");
};

// Stage s of the block's K range: x's BM x 128 slice into the swizzled A
// slot, the weights' raw rows into the raw slot.  The raw rows keep the
// N-major layout, their 16-byte chunks XOR-swizzled by (row / 4) so the
// transpose reads conflict less.  Rows past M, k past K and columns past N
// are zero-filled, so they add nothing.
template <bool kW4, int BM, int BN, bool kVec16>
__device__ __forceinline__ void tc_load_stage(uint8_t* a_slot, uint8_t* raw_slot,
                                              const int8_t* __restrict__ x,
                                              const uint8_t* __restrict__ w, int s, int m0,
                                              int n0, int M, int K, int N) {
  using S = TcShape<kW4, BM, BN>;
  const int tid = threadIdx.x;
  const int rows = kW4 ? K / 2 : K;
  const int r0 = s * S::kRawRows;
#pragma unroll
  for (int i = tid; i < BM * 8; i += S::kThreads) {
    const int r = i >> 3, c = i & 7;
    int kk;
    bool ok;
    if (kW4) {   // chunks 0-3: the low plane's k, 4-7: the high plane's (k + K/2)
      const int kp = r0 + 16 * (c & 3);
      kk = (c < 4 ? 0 : K / 2) + kp;
      ok = kp < K / 2;
    } else {
      kk = r0 + 16 * c;
      ok = kk < K;
    }
    ok = ok && m0 + r < M;
    const int8_t* src = ok ? x + static_cast<size_t>(m0 + r) * K + kk : x;
    cp_async16(smem_u32(a_slot + sw128(r, 16 * c)), src, ok);
  }
#pragma unroll
  for (int i = tid; i < S::kRawRows * S::kChunks; i += S::kThreads) {
    const int r = i / S::kChunks, c = i % S::kChunks;
    const int gr = r0 + r, gn = n0 + 16 * c;
    uint8_t* dst = raw_slot + r * BN + ((c ^ ((r >> 2) & (S::kChunks - 1))) << 4);
    const uint8_t* src = w + static_cast<size_t>(gr) * N + gn;
    if (kVec16) {
      const bool ok = gr < rows && gn < N;
      cp_async16(smem_u32(dst), ok ? src : w, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < rows && gn + 4 * j < N;
        cp_async4(smem_u32(dst + 4 * j), ok ? src + 4 * j : w, ok);
      }
    }
  }
}

// The raw slot's weights, transposed (and for W4 unpacked) into the K-major
// swizzled B buffer: B row n, byte k = W[k][n] (W4: k < 64 the low nibble of
// packed row k, k >= 64 the high nibble of packed row k - 64).  A work unit
// is a 4-row x 4-column block; a warp takes 16 row quads x 2 column words,
// so its 32 lanes' B stores hit 32 distinct banks.
template <bool kW4, int BM, int BN>
__device__ __forceinline__ void tc_transpose(const uint8_t* raw_slot, uint8_t* b) {
  using S = TcShape<kW4, BM, BN>;
  constexpr int kQHalves = kW4 ? 1 : 2;   // 16 or 32 row quads
  constexpr int kUnits = kQHalves * (BN / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = warp; u < kUnits; u += S::kThreads / 32) {
    const int q = (u % kQHalves) * 16 + (lane & 15);
    const int wd = (u / kQHalves) * 2 + (lane >> 4);   // columns 4 wd .. 4 wd + 3
    const int off = ((((wd >> 2) ^ q) & (S::kChunks - 1)) << 4) + ((wd & 3) << 2);
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const uint32_t*>(raw_slot + (4 * q + i) * BN + off);
    if (kW4) {
      uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = sext_nibbles(a[i] & 0x0f0f0f0fu);
        hi[i] = sext_nibbles((a[i] >> 4) & 0x0f0f0f0fu);
      }
      transpose4(lo, tl);
      transpose4(hi, th);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * wd + c;
        *reinterpret_cast<uint32_t*>(b + sw128(n, 4 * q)) = tl[c];
        *reinterpret_cast<uint32_t*>(b + sw128(n, 64 + 4 * q)) = th[c];
      }
    } else {
      uint32_t t[4];
      transpose4(a, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(b + sw128(4 * wd + c, 4 * q)) = t[c];
    }
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_step(int (&d)[BN / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_step<64>(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_n64(d, da, db, acc);
}

template <>
__device__ __forceinline__ void wgmma_step<128>(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_n128(d, da, db, acc);
}

// grid (ceil(N / BN), ceil(M / BM), split); split > 1 writes int32 partials
// ws[z][m][n] for reduce_kernel, split == 1 the requantized int8 output.
template <bool kW4, int BM, int BN, bool kVec16>
__global__ void __launch_bounds__(BM * 2, 1)
tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
          const int* __restrict__ bias, const int* __restrict__ Mq, const int* __restrict__ shq,
          int8_t* __restrict__ out, int* __restrict__ ws, int M, int K, int N, int split) {
  using S = TcShape<kW4, BM, BN>;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* smem = smem_tc + ((1024 - (smem_u32(smem_tc) & 1023)) & 1023);
  uint8_t* As = smem;                                  // kStages x kABytes
  uint8_t* Rs = As + kStages * S::kABytes;             // kStages x kRawBytes
  uint8_t* Bs = Rs + kStages * S::kRawBytes;           // 2 x kBBytes

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int rows = kW4 ? K / 2 : K;
  const int nst = (rows + S::kRawRows - 1) / S::kRawRows;
  const int s_begin = static_cast<int>(static_cast<long long>(nst) * z / split);
  const int n = static_cast<int>(static_cast<long long>(nst) * (z + 1) / split) - s_begin;

  // no zero fill: the first wgmma overwrites (an instruction that defines
  // an accumulator register inside the wgmma pipeline serializes it)
  int acc[BN / 2];

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n)
      tc_load_stage<kW4, BM, BN, kVec16>(As + i * S::kABytes, Rs + i * S::kRawBytes, x, w,
                                         s_begin + i, m0, n0, M, K, N);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  tc_transpose<kW4, BM, BN>(Rs, Bs);
  fence_proxy_async();
  __syncthreads();

  const uint32_t a_base = smem_u32(As) + wg * 64 * 128;
  const uint32_t b_base = smem_u32(Bs);
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    const uint64_t da = sw128_desc(a_base + (it % kStages) * S::kABytes);
    const uint64_t db = sw128_desc(b_base + (it & 1) * S::kBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk)
      wgmma_step<BN>(acc, da + 2 * kk, db + 2 * kk, it > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                    // this warpgroup's wgmmas of stage it - 1 are done
    if (it + 1 < n) {
      cp_async_wait<kStages - 3>();     // stage it + 1 has landed (this thread's copies)
      __syncthreads();                  // ... everyone's; stage it - 1's slots are free
      const int nx = it + kStages - 1;
      if (nx < n)
        tc_load_stage<kW4, BM, BN, kVec16>(As + (nx % kStages) * S::kABytes,
                                           Rs + (nx % kStages) * S::kRawBytes, x, w,
                                           s_begin + nx, m0, n0, M, K, N);
      cp_async_commit();
      tc_transpose<kW4, BM, BN>(Rs + ((it + 1) % kStages) * S::kRawBytes,
                                Bs + ((it + 1) & 1) * S::kBBytes);
      fence_proxy_async();
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  // accumulator layout of m64nBN: acc[4 j + e] is row 16 warp + lane / 4
  // (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + (e & 1) of the warpgroup's
  // 64 x BN tile
  const int lane = tid & 31;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  if (split > 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + row0 + 8 * h, gn = n0 + 8 * j + col0;
        if (gm < M && gn < N)
          *reinterpret_cast<int2*>(ws + (static_cast<size_t>(z) * M + gm) * N + gn) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    return;
  }
  // requantize into a shared tile (the A ring is free), then one 4-byte
  // store per thread and pass, a warp writing whole 128-byte row segments
  __syncthreads();
  const int Mv = *Mq, shv = *shq;
  uint8_t* tile = As;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + col0;
    const int b0 = n0 + c < N ? bias[n0 + c] : 0;
    const int b1 = n0 + c < N ? bias[n0 + c + 1] : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lo = static_cast<uint8_t>(requantize8(wrap_add(acc[4 * j + 2 * h], b0), Mv, shv));
      const uint32_t hi = static_cast<uint8_t>(requantize8(wrap_add(acc[4 * j + 2 * h + 1], b1), Mv, shv));
      *reinterpret_cast<uint16_t*>(tile + (row0 + 8 * h) * S::kOutStride + c) =
          static_cast<uint16_t>(lo | (hi << 8));
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * (BN / 4); i += S::kThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(gm) * N + gn) =
          *reinterpret_cast<const uint32_t*>(tile + r * S::kOutStride + c);
  }
}

// ---- decode path (M <= 8) -------------------------------------------------

// Row stride of the staged x slice: planes * len + 16 bytes, an odd
// multiple of 16, so the 8 tokens x 4 k-quads of a B-fragment load hit 32
// distinct banks.
__host__ __device__ __forceinline__ int decode_x_stride(bool w4, int len) {
  return (w4 ? 2 : 1) * len + 16;
}

__host__ __device__ __forceinline__ int decode_smem(bool w4, int max_len) {
  return (8 * decode_x_stride(w4, max_len) + 15) / 16 * 16 + kDecodeWarps * 8 * kDecodeCols * 4;
}

// grid (ceil(N / 128), split), 256 threads, M <= 8.  Block (cg, z) owns
// columns 128 cg .. and the z-th slice of the weight rows.
template <bool kW4, bool kVec16>
__global__ void __launch_bounds__(kDecodeWarps * 32, 1)
decode_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
              const int* __restrict__ bias, const int* __restrict__ Mq,
              const int* __restrict__ shq, int8_t* __restrict__ out, int* __restrict__ ws,
              int M, int K, int N, int split) {
  constexpr int kPlanes = kW4 ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem_dec[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = kW4 ? K / 2 : K;
  const int nsteps = rows / kDecodeRows;
  const int z = blockIdx.y, n0 = blockIdx.x * kDecodeCols;
  const int s0 = static_cast<int>(static_cast<long long>(nsteps) * z / split);
  const int s1 = static_cast<int>(static_cast<long long>(nsteps) * (z + 1) / split);
  const int len = (s1 - s0) * kDecodeRows;
  const int xstride = decode_x_stride(kW4, len);
  uint8_t* xs = smem_dec;
  int* red = reinterpret_cast<int*>(smem_dec + (8 * xstride + 15) / 16 * 16);

  // x[:, slice] (both planes for W4) once per block; rows past M are zeros
  const int cpp = len / 16;   // 16-byte chunks per plane
  for (int i = tid; i < 8 * kPlanes * cpp; i += kDecodeWarps * 32) {
    const int r = i / (kPlanes * cpp), rem = i % (kPlanes * cpp);
    const int p = rem / cpp, c = rem % cpp;
    const bool ok = r < M;
    const int8_t* src = x + static_cast<size_t>(r) * K + p * (K / 2) + s0 * kDecodeRows + 16 * c;
    cp_async16(smem_u32(xs + r * xstride + p * len + 16 * c), ok ? src : x, ok);
  }
  cp_async_commit();

  // this lane's weights of a step: rows 16 h + 4 t + i (v[4 h + i]),
  // columns n0 + 16 g .. + 15
  const int ncol = n0 + 16 * g;
  auto load = [&](uint4 (&v)[8], int s) {
#pragma unroll
    for (int hi = 0; hi < 8; ++hi) {
      const int r = s * kDecodeRows + 16 * (hi >> 2) + 4 * t + (hi & 3);
      const uint8_t* p = w + static_cast<size_t>(r) * N + ncol;
      if (kVec16) {
        v[hi] = ncol < N ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
      } else {
        const unsigned* q = reinterpret_cast<const unsigned*>(p);
        v[hi].x = ncol < N ? __ldg(q) : 0u;
        v[hi].y = ncol + 4 < N ? __ldg(q + 1) : 0u;
        v[hi].z = ncol + 8 < N ? __ldg(q + 2) : 0u;
        v[hi].w = ncol + 12 < N ? __ldg(q + 3) : 0u;
      }
    }
  };

  int acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0;

  uint4 cur[8];
  int s = s0 + warp;
  if (s < s1) load(cur, s);
  cp_async_wait<0>();
  __syncthreads();
  for (; s < s1; s += kDecodeWarps) {
    uint4 nxt[8] = {};
    if (s + kDecodeWarps < s1) load(nxt, s + kDecodeWarps);
    const int kb = (s - s0) * kDecodeRows;
    // B fragments: token g, k = kb + 4 t (+ 16)
    uint32_t bf[kPlanes][2];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const uint8_t* xr = xs + g * xstride + p * len + kb + 4 * t;
      bf[p][0] = *reinterpret_cast<const uint32_t*>(xr);
      bf[p][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {        // columns 16 g + 4 j .. + 3
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        uint32_t r0[4], r1[4], c0[4], c1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t u0 = word_of(cur[i], j), u1 = word_of(cur[4 + i], j);
          if (kW4) {
            u0 = sext_nibbles((p == 0 ? u0 : u0 >> 4) & 0x0f0f0f0fu);
            u1 = sext_nibbles((p == 0 ? u1 : u1 >> 4) & 0x0f0f0f0fu);
          }
          r0[i] = u0;
          r1[i] = u1;
        }
        transpose4(r0, c0);              // k = 4 t .. + 3 of columns 4 j + c
        transpose4(r1, c1);              // k = 16 + 4 t ..
        // MMA 2 j + h: row g <-> column 16 g + 4 j + 2 h, row g + 8 <-> + 1
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_16832(acc[2 * j + h], c0[2 * h], c0[2 * h + 1], c1[2 * h], c1[2 * h + 1],
                    bf[p][0], bf[p][1]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 8; ++hi) cur[hi] = nxt[hi];
  }

  // acc[P][e]: column 16 g + 2 P + (e >> 1), token 2 t + (e & 1); the 8
  // warps' sums meet in red[warp][token][column]
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 8 + 2 * t + (e & 1)) * kDecodeCols + 16 * g + 2 * p + (e >> 1)] = acc[p][e];
  __syncthreads();
  const int Mv = *Mq, shv = *shq;
  for (int i = tid; i < 8 * kDecodeCols; i += kDecodeWarps * 32) {
    const int tok = i / kDecodeCols, col = i % kDecodeCols, gn = n0 + col;
    if (tok >= M || gn >= N) continue;
    int v = 0;
#pragma unroll
    for (int wi = 0; wi < kDecodeWarps; ++wi) v = wrap_add(v, red[wi * 8 * kDecodeCols + i]);
    if (split > 1)
      ws[(static_cast<size_t>(z) * M + tok) * N + gn] = v;
    else
      out[static_cast<size_t>(tok) * N + gn] = requantize8(wrap_add(v, bias[gn]), Mv, shv);
  }
}

// ---- split-K reduction -----------------------------------------------------

// out[m][n] = requantize8(sum_z ws[z][m][n] + bias[n]), four columns a thread.
__global__ void reduce_kernel(const int* __restrict__ ws, const int* __restrict__ bias,
                              const int* __restrict__ Mq, const int* __restrict__ shq,
                              int8_t* __restrict__ out, int M, int N, int split) {
  const int n4 = N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(M) * n4) return;
  const int c = static_cast<int>(i % n4) * 4;
  const int4* p = reinterpret_cast<const int4*>(ws) + i;
  int4 s = make_int4(0, 0, 0, 0);
  for (int zz = 0; zz < split; ++zz) {
    const int4 v = p[static_cast<size_t>(zz) * M * n4];
    s = make_int4(wrap_add(s.x, v.x), wrap_add(s.y, v.y), wrap_add(s.z, v.z), wrap_add(s.w, v.w));
  }
  const int Mv = *Mq, shv = *shq;
  char4 o;
  o.x = requantize8(wrap_add(s.x, bias[c]), Mv, shv);
  o.y = requantize8(wrap_add(s.y, bias[c + 1]), Mv, shv);
  o.z = requantize8(wrap_add(s.z, bias[c + 2]), Mv, shv);
  o.w = requantize8(wrap_add(s.w, bias[c + 3]), Mv, shv);
  reinterpret_cast<char4*>(out)[i] = o;
}

// ---- host side ---------------------------------------------------------------

enum Path { kTensorCore = 0, kDecode = 1 };

// Raises the dynamic shared-memory limit of one kernel instance once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int& done) {
  if (bytes <= done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = bytes;
  return e;
}

template <bool kW4, int BM, int BN, bool kVec16>
inline cudaError_t launch_tc(const int8_t* x, const uint8_t* w, const int* bias, const int* Mq,
                             const int* shq, int8_t* out, int* ws, int M, int K, int N,
                             int split, cudaStream_t s) {
  static int done = 0;
  constexpr int kSmem = TcShape<kW4, BM, BN>::kSmem;
  auto kernel = tc_kernel<kW4, BM, BN, kVec16>;
  const cudaError_t e = allow_smem(kernel, kSmem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  kernel<<<grid, BM * 2, kSmem, s>>>(x, w, bias, Mq, shq, out, ws, M, K, N, split);
  return cudaSuccess;
}

// Dynamic shared memory of a decode-path launch over K split ``split`` ways.
inline int decode_launch_smem(bool w4, int K, int split) {
  const int nsteps = (w4 ? K / 2 : K) / kDecodeRows;
  return decode_smem(w4, (nsteps + split - 1) / split * kDecodeRows);
}

// Dynamic shared memory the launch of plan (path, bm, bn, split) at K asks
// for, or -1 for a plan this file has no instance for (the C entries'
// ``*_smem`` query, read by the kernel lint).
template <bool kW4>
inline int dyn_smem(int path, int bm, int bn, int K, int split) {
  if (path == kDecode) return decode_launch_smem(kW4, K, split);
  if (path != kTensorCore) return -1;
  if (bm == 128 && bn == 128) return TcShape<kW4, 128, 128>::kSmem;
  if (bm == 64 && bn == 128) return TcShape<kW4, 64, 128>::kSmem;
  if (bm == 64 && bn == 64) return TcShape<kW4, 64, 64>::kSmem;
  return -1;
}

template <bool kW4, bool kVec16>
inline cudaError_t launch_decode(const int8_t* x, const uint8_t* w, const int* bias,
                                 const int* Mq, const int* shq, int8_t* out, int* ws, int M,
                                 int K, int N, int split, cudaStream_t s) {
  static int done = 0;
  const int smem = decode_launch_smem(kW4, K, split);
  auto kernel = decode_kernel<kW4, kVec16>;
  const cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kDecodeCols - 1) / kDecodeCols, split);
  kernel<<<grid, kDecodeWarps * 32, smem, s>>>(x, w, bias, Mq, shq, out, ws, M, K, N, split);
  return cudaSuccess;
}

// The C entries' body: (path, bm, bn, split, vec) is the wrapper's plan;
// a plan this file has no instance for returns cudaErrorInvalidValue.
template <bool kW4>
inline int launch(const void* x, const void* w, const void* bias, const void* Mq,
                  const void* shq, void* out, void* ws, int M, int K, int N, int path, int bm,
                  int bn, int split, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* mp = static_cast<const int*>(Mq);
  const auto* sp = static_cast<const int*>(shq);
  auto* op = static_cast<int8_t*>(out);
  auto* wsp = static_cast<int*>(ws);
  const bool v16 = vec == 16;
  cudaError_t e = cudaErrorInvalidValue;
#define FQ_TC(BM_, BN_)                                                                        \
  if (bm == BM_ && bn == BN_)                                                                  \
    e = v16 ? launch_tc<kW4, BM_, BN_, true>(xp, wp, bp, mp, sp, op, wsp, M, K, N, split, s)   \
            : launch_tc<kW4, BM_, BN_, false>(xp, wp, bp, mp, sp, op, wsp, M, K, N, split, s);
  if (path == kTensorCore) {
    FQ_TC(128, 128)
    FQ_TC(64, 128)
    FQ_TC(64, 64)
  } else if (path == kDecode && bm == 8 && bn == kDecodeCols && M <= 8) {
    e = v16 ? launch_decode<kW4, true>(xp, wp, bp, mp, sp, op, wsp, M, K, N, split, s)
            : launch_decode<kW4, false>(xp, wp, bp, mp, sp, op, wsp, M, K, N, split, s);
  }
#undef FQ_TC
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess || split <= 1) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(M) * (N / 4);
  reduce_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, s>>>(wsp, bp, mp, sp, op, M,
                                                                       N, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace igemm
}  // namespace fq
