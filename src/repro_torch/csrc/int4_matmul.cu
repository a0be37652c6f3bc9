// W4A8 integer GEMM for Hopper: y = requantize(x @ unpack(W4) + bias).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::int4_matmul
// (Pallas, MXU int8 dots over VMEM tiles).  Same arithmetic: x int8 (M, K),
// w uint8 (K/2, N) K-planar nibble-packed (packed row r holds k = r in the
// low nibble and k = r + K/2 in the high nibble), both planes sign-extended
// with (x ^ 8) - 8, int32 accumulation, + int32 bias, Q15 fixed-point
// requantize to int8 (core/fixedpoint.py::requantize, csrc/common.cuh).
//
// What bounds it on the H100, and what the design (igemm.cuh) does:
// * Prefill and evaluation (M from 9 to thousands; yi-6b's projections,
//   BERT's linears): int8 operations, 2 M K N over 1,979 TOP/s.  The
//   tensor-core path runs wgmma m64nNk32 on 128 x 128 tiles (64 x 128 or
//   64 x 64 where those leave SMs idle, K split across blocks where even
//   they do), fed by a 4-stage cp.async ring; each stage's 64 packed rows
//   are unpacked and transposed into the K-major B layout in shared memory
//   while the previous stage's wgmmas run, and pair with two contiguous
//   64-byte slabs of each x row (k0.. and K/2 + k0..).
// * Decode (M <= 8, the batch of a decode tick): the K N / 2 packed bytes
//   over 3.35 TB/s.  The decode path streams them once, 16 bytes a load
//   with the next step's loads in flight, unpacks them in registers into
//   mma.sync m16n8k32 fragments with the tokens on the n8 side, and splits
//   K across blocks so that every SM streams.
#include "igemm.cuh"

// x int8 (M, K) row-major, w uint8 (K/2, N), bias int32 (N,), Mq/shq int32
// scalars in device memory, out int8 (M, N), ws int32 (split, M, N) when
// split > 1.  (path, bm, bn, split, vec) is kernels/int4_matmul.py::plan's
// choice.  Needs K/2 % 32 == 0, N % 4 == 0, 16-byte aligned x and w (the
// wrapper checks).
extern "C" int int4_matmul(const void* x, const void* w, const void* bias, const void* Mq,
                           const void* shq, void* out, void* ws, int M, int K, int N, int path,
                           int bm, int bn, int split, int vec, void* stream) {
  return fq::igemm::launch<true>(x, w, bias, Mq, shq, out, ws, M, K, N, path, bm, bn, split,
                                 vec, stream);
}

// Dynamic shared memory of one launch of plan (path, bm, bn, split) at K.
extern "C" int int4_matmul_smem(int path, int bm, int bn, int K, int split) {
  return fq::igemm::dyn_smem<true>(path, bm, bn, K, split);
}
