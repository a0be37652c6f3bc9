"""The integer GEMMs: W4A8 (``csrc/int4_matmul.cu``) and W8A8
(``csrc/int8_bitsplit_matmul.cu``), both on the core of ``csrc/igemm.cuh``,
and their wrappers.

Replace the TPU kernels ``repro/kernels/int4_matmul.py::int4_matmul`` and
``::int8_bitsplit_matmul``.  On a CUDA tensor a wrapper launches its kernel
(or raises); on a CPU tensor it computes the plain version
(``ref.int4_matmul_ref``, ``ref.int8_bitsplit_matmul_ref``).  ``launches``
counts kernel launches only, ``path_launches`` the same launches by the
path the plan took.  The plan (path, tile, K split) comes from
``autotune.gemm_plan``; ``plan`` is its ``off`` rule.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.boundary import kernel_launch
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.hw_constants import SMS
from repro_torch.kernels.ref import int4_matmul_ref, int8_bitsplit_matmul_ref

SOURCE = "src/repro_torch/csrc/int4_matmul.cu"
REPLACES = "src/repro/kernels/int4_matmul.py:71"
BITSPLIT_SOURCE = "src/repro_torch/csrc/int8_bitsplit_matmul.cu"
BITSPLIT_REPLACES = "src/repro/kernels/int4_matmul.py:141"
# (x@hi << 4) + x@lo and x@w are the same int32 value, with no wrap on
# either side, while K * 128 * 128 < 2^31 (every int8 code has |c| <= 128)
BITSPLIT_MAX_K = (2**31 - 1) // (128 * 128)

WAVE_SHARE = 0.9           # a grid of at least this share of the SMs fills a wave
WAVE = WAVE_SHARE * SMS    # ... of the H100 SXM's
PATHS = ("tensor_core", "decode")
DECODE_MAX_M = 8           # a decode tick's batch: the weights are the only large operand
TC_STAGE_K = 128           # k values per stage of the tensor-core ring
TC_MIN_STAGES = 4          # a K slice keeps the ring full for this many stages
TC_TILES = ((128, 128), (64, 128), (64, 64))   # (BM, BN), largest first
DECODE_COLS = 128          # weight columns per decode block
DECODE_ROWS = 32           # weight rows per decode warp step
DECODE_WARPS = 8
DECODE_MAX_X_BYTES = 96 << 10   # the staged x slice of a decode block
# integer instructions a block spends on each weight byte it stages: both
# paths unpack the weights on the CUDA cores (csrc/igemm.cuh: W4's two
# nibble planes masked, sign-extended and transposed with __byte_perm, ~96
# instructions per 16 packed bytes; W8's only transposed)
UNPACK_OPS_PER_BYTE = {4: 6, 8: 2}


class GemmPlan(NamedTuple):
    """How one GEMM launches: ``path`` ("tensor_core" or "decode"), tile
    rows ``bm`` (decode: the 8 token rows) and columns ``bn``, the number
    of K slices ``split`` (partials reduced by a second pass when > 1), and
    ``vec``, the bytes of one weight copy (16, or 4 where N % 16 != 0)."""
    path: str
    bm: int
    bn: int
    split: int
    vec: int
    blocks: int


def decode_fits(k: int, split: int, w_bits: int = 4) -> bool:
    """Whether the decode path's staged x slice (8 rows of each plane's
    longest slice, csrc/igemm.cuh decode_x_stride) fits
    ``DECODE_MAX_X_BYTES`` with K split ``split`` ways."""
    steps = (k // 2 if w_bits == 4 else k) // DECODE_ROWS
    planes = 2 if w_bits == 4 else 1
    return 8 * (planes * -(-steps // split) * DECODE_ROWS + 16) <= DECODE_MAX_X_BYTES


def plan(m: int, k: int, n: int, w_bits: int = 4, sms: int = SMS) -> GemmPlan:
    """The fixed rule for a (M, K, N) GEMM on a card of ``sms`` SMs (the
    tuner's ``off`` mode).  M <= 8: the decode path, 128 columns a block, K
    split until the blocks cover the SMs (each slice at least one 32-row
    step).  Otherwise the tensor-core path: the largest tile whose grid,
    with K split into slices of at least 4 stages, fills a wave of SMs (90 %
    of them: 128 tiles of 128 x 128 at M = 512, N = 4096 run unsplit on
    132), else the smallest tile with K split as far as it goes."""
    vec = 16 if n % 16 == 0 else 4
    rows = k // 2 if w_bits == 4 else k          # weight rows
    if m <= DECODE_MAX_M:
        cols = -(-n // DECODE_COLS)
        steps = rows // DECODE_ROWS
        split = max(1, min(-(-sms // cols), steps))
        while not decode_fits(k, split, w_bits):
            split += 1
        return GemmPlan("decode", 8, DECODE_COLS, split, vec, cols * split)
    wave = WAVE_SHARE * sms
    stages = -(-k // TC_STAGE_K)
    for bm, bn in TC_TILES:
        tiles = -(-m // bm) * -(-n // bn)
        split = max(1, min(-(-int(wave) // tiles), stages // TC_MIN_STAGES))
        if tiles * split >= wave:
            return GemmPlan("tensor_core", bm, bn, split, vec, tiles * split)
    split = max(1, min(-(-int(wave) // tiles), stages))
    return GemmPlan("tensor_core", bm, bn, split, vec, tiles * split)


def _launch(name: str, x_i8, w, bias_i32, M_q, shift_q, n: int, p: GemmPlan) -> torch.Tensor:
    """Launch the GEMM kernel ``name`` at plan ``p`` on CUDA operands whose
    types and shapes its wrapper checked -> int8 (M, N).  Counts nothing:
    the wrappers count, the tuner's races do not."""
    dev = x_i8.device
    x = x_i8.contiguous()
    w = w.contiguous()
    bias = bias_i32.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned (the kernels copy 16 "
                         "bytes at a time)")
    Mq = _build.device_scalar(M_q, torch.int32, dev)
    shq = _build.device_scalar(shift_q, torch.int32, dev)
    m, k = x.shape
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    ws = torch.empty((p.split, m, n) if p.split > 1 else (1,), dtype=torch.int32, device=dev)
    rc = _build.bind(name, name, 7, 8)(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), Mq.data_ptr(), shq.data_ptr(),
        out.data_ptr(), ws.data_ptr(), m, k, n, PATHS.index(p.path), p.bm, p.bn, p.split,
        p.vec, _build.stream_of(dev))
    _build.check_launch(rc, name)
    return out


def _counted(fn, x_i8, w, bias_i32, M_q, shift_q, n: int, w_bits: int) -> torch.Tensor:
    """The wrapper ``fn``'s launch at the tuner's plan, counted on ``fn``
    and on the plan's path."""
    m, k = x_i8.shape
    if m == 0:
        return torch.empty((0, n), dtype=torch.int8, device=x_i8.device)
    p = autotune.gemm_plan(m, k, n, w_bits, _build.sm_count(x_i8.device), device=x_i8.device)
    out = _launch(fn.__name__, x_i8, w, bias_i32, M_q, shift_q, n, p)
    fn.launches += 1
    fn.path_launches[p.path] += 1
    return out


@kernel_launch
def int4_matmul(x_i8: torch.Tensor, w_packed: torch.Tensor, bias_i32: torch.Tensor,
                M_q, shift_q) -> torch.Tensor:
    """x int8 (M, K) @ unpack(w uint8 (K/2, N)) + bias, requantized -> int8 (M, N)."""
    if x_i8.device.type == "cpu":
        return int4_matmul_ref(x_i8, w_packed, bias_i32, M_q, shift_q)
    if x_i8.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x_i8.device}")
    m, k = x_i8.shape
    k2, n = w_packed.shape
    if x_i8.dtype != torch.int8 or w_packed.dtype != torch.uint8 \
            or bias_i32.dtype != torch.int32:
        raise TypeError("int4_matmul wants int8 x, uint8 w_packed, int32 bias")
    if k != 2 * k2 or k2 % 32 or n % 4 or bias_i32.shape != (n,):
        raise ValueError(f"int4_matmul: unsupported shapes x {tuple(x_i8.shape)}, "
                         f"w {tuple(w_packed.shape)} (needs K/2 % 32 == 0, N % 4 == 0)")
    return _counted(int4_matmul, x_i8, w_packed, bias_i32, M_q, shift_q, n, 4)


int4_matmul.launches = 0
int4_matmul.path_launches = dict.fromkeys(PATHS, 0)


@kernel_launch
def int8_bitsplit_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
                         M_q, shift_q) -> torch.Tensor:
    """x int8 (M, K) @ w int8 (K, N) + bias, requantized -> int8 (M, N): the
    bit-split W8A8 product, computed by the kernel as one exact int8 GEMM."""
    if x_i8.device.type == "cpu":
        return int8_bitsplit_matmul_ref(x_i8, w_i8, bias_i32, M_q, shift_q)
    if x_i8.device.type != "cuda":
        raise ValueError(f"int8_bitsplit_matmul: unsupported device {x_i8.device}")
    m, k = x_i8.shape
    k_w, n = w_i8.shape
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8 or bias_i32.dtype != torch.int32:
        raise TypeError("int8_bitsplit_matmul wants int8 x, int8 w, int32 bias")
    if k != k_w or k % 64 or k > BITSPLIT_MAX_K or n % 4 or bias_i32.shape != (n,):
        raise ValueError(f"int8_bitsplit_matmul: unsupported shapes x {tuple(x_i8.shape)}, "
                         f"w {tuple(w_i8.shape)} (needs K % 64 == 0, K <= {BITSPLIT_MAX_K}, "
                         "N % 4 == 0)")
    return _counted(int8_bitsplit_matmul, x_i8, w_i8, bias_i32, M_q, shift_q, n, 8)


int8_bitsplit_matmul.launches = 0
int8_bitsplit_matmul.path_launches = dict.fromkeys(PATHS, 0)
