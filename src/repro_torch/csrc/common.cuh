// Shared device arithmetic of the port's kernels: the reference's int32
// fixed-point helpers (core/fixedpoint.py) with two's-complement wrap made
// explicit (signed overflow is undefined in C++, so sums and products that
// may wrap go through unsigned), and shifts of 32 or more bits defined the
// way XLA and torch define them (sign fill for >>, zero for <<).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fq {

constexpr int kNegInit = -(1 << 30);
constexpr int kMaskOffset = 1 << 30;
constexpr int kLutSize = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int sra(int x, int n) {
  return n >= 32 ? (x < 0 ? -1 : 0) : (x >> n);
}

__device__ __forceinline__ int shl(int x, int n) {
  return n >= 32 ? 0 : static_cast<int>(static_cast<unsigned>(x) << n);
}

// Rounding arithmetic right shift, half away from zero (n >= 0):
// x >= 0 ? (x + b) >> n : -((-x + b) >> n),  b = n > 0 ? 1 << (n-1) : 0.
__device__ __forceinline__ int rshift_round(int x, int n) {
  const int bias = n > 0 ? shl(1, n - 1) : 0;
  const int pos = sra(wrap_add(x, bias), n);
  const int neg = wrap_sub(0, sra(wrap_add(wrap_sub(0, x), bias), n));
  return x >= 0 ? pos : neg;
}

// round(acc * M * 2^-shift) in int32 (fixedpoint.rescale).
__device__ __forceinline__ int rescale(int acc, int M, int shift, int out_bits) {
  const int pre = max(shift + (out_bits - 30), 0);
  int v = rshift_round(acc, pre);
  v = min(max(v, -32768), 32767);
  return rshift_round(wrap_mul(v, M), shift - pre);
}

// fixedpoint.requantize: int32 accumulator -> int8 code clamped to +-127.
__device__ __forceinline__ int8_t requantize8(int acc, int M, int shift) {
  const int y = rescale(acc, M, shift, 8);
  return static_cast<int8_t>(min(max(y, -127), 127));
}

}  // namespace fq
