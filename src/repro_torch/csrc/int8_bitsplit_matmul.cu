// W8A8 integer GEMM for Hopper: y = requantize(x @ w + bias), int8 w.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::
// int8_bitsplit_matmul (Pallas), which feeds the MXU two nibble planes of
// the 8-bit weights, hi = w >> 4 (signed) and lo = w & 15, and adds
// (x@hi << 4) + x@lo: the paper's BIM Type-A bit split.  That identity is
// exact in integers, w = 16 hi + lo, and in int32 neither side wraps while
// every partial sum stays below K * 128 * 128 < 2^31, i.e. for K <= 131071
// (the wrapper refuses larger K).  So this kernel computes the one int8
// product x@w that the two nibble passes add up to; the CPU and card tests
// hold it bit for bit against the bit-split plain version
// (kernels/ref.py::int8_bitsplit_matmul_ref).
//
// What bounds it on the H100: at BERT's shapes (M = B*S rows of K, N in
// {768, 3072}) int8 operations, 2 M K N over 1,979 TOP/s; at M <= 8 the
// K N weight bytes.  It runs the two paths of igemm.cuh that int4_matmul.cu
// runs, with no unpack: the wgmma tensor-core path (4-stage cp.async ring,
// the weights transposed into the K-major B layout in shared memory while
// the previous stage's wgmmas run; 64 x 64 tiles and split K at BERT's
// (1, 128), where 128 x 128 tiles would leave most SMs idle), and the
// mma.sync decode path for M <= 8.
#include "igemm.cuh"

// x int8 (M, K) row-major, w int8 (K, N) row-major, bias int32 (N,), Mq/shq
// int32 scalars in device memory, out int8 (M, N), ws int32 (split, M, N)
// when split > 1.  (path, bm, bn, split, vec) is kernels/int4_matmul.py::
// plan's choice.  Needs K % 64 == 0, K <= 131071, N % 4 == 0, 16-byte
// aligned x and w (the wrapper checks).
extern "C" int int8_bitsplit_matmul(const void* x, const void* w, const void* bias,
                                    const void* Mq, const void* shq, void* out, void* ws,
                                    int M, int K, int N, int path, int bm, int bn, int split,
                                    int vec, void* stream) {
  return fq::igemm::launch<false>(x, w, bias, Mq, shq, out, ws, M, K, N, path, bm, bn, split,
                                  vec, stream);
}

// Dynamic shared memory of one launch of plan (path, bm, bn, split) at K.
extern "C" int int8_bitsplit_matmul_smem(int path, int bm, int bn, int K, int split) {
  return fq::igemm::dyn_smem<false>(path, bm, bn, K, split);
}
