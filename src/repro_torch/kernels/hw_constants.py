"""The H100's ceilings: one source for the port.

``kernels/autotune.py`` (the launch tuner's cost model),
``kernels/int4_matmul.py`` (``plan``'s wave of SMs),
``analysis/kernel_lint.py`` (the shared-memory budget) and ``chip_smoke.py``
(each kernel's bound) reason about the same card; each imports these
objects and keeps no copy (``tests/test_torch_autotune.py`` pins every
consumer to them).  The values are the H100 SXM's at its full 700 W power
limit: NVIDIA's data sheet (dense rates, no sparsity) and the CUDA
programming guide's table for compute capability 9.0, except the launch
floor, which was measured.  No TPU constant carries over.
"""
from __future__ import annotations

SMS = 132                   # streaming multiprocessors (H100 SXM data sheet)
HBM_BW = 3.35e12            # bytes/s of HBM3 (data sheet)
PEAK_INT8_OPS = 1979e12     # int8 tensor-core ops/s, dense (data sheet)
PEAK_F32_OPS = 67e12        # float32 ops/s outside the tensor cores (data sheet)
# int32 instructions/s of the CUDA cores: 64 lanes an SM (Hopper white paper)
# at the 1,980 MHz boost clock
PEAK_INT32_OPS = 64 * SMS * 1.98e9
L2_BYTES = 50 << 20         # L2 cache (data sheet: 50 MB)
SMEM_PER_BLOCK = 232_448    # shared memory a block may opt into, 227 KB (CUDA guide, cc 9.0)
SMEM_PER_SM = 233_472       # shared memory of one SM, 228 KB (CUDA guide, cc 9.0)
SMEM_RESERVED = 1024        # shared memory the runtime keeps per resident block (CUDA guide)
REGISTERS_PER_SM = 65536    # 32-bit registers of one SM (CUDA guide, cc 9.0)
MAX_REGISTERS = 255         # registers a thread may hold (CUDA guide, cc 9.0)
# The least device time of a launch: a one-element torch.neg timed back to
# back by chip_smoke.py's launch_floor_ms, 0.0019 ms on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (PERF.md section 6, row 2).
LAUNCH_FLOOR_S = 1.9e-6
