"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each kernel source is compiled by its own ``nvcc`` process — all of them
started together — into a shared library with a plain C interface, which
the wrappers load with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries land in ``<checkout>/build/repro_torch/<hash>/``,
keyed by a hash of every source and header and of the flags, so an edit
rebuilds and an unchanged checkout reuses the build.  A missing ``nvcc``
or a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("int4_matmul", "quant_layernorm", "paged_prefill_attention",
           "paged_decode_attention", "quant_softmax", "int8_bitsplit_matmul",
           "paged_decode_attention_q4", "paged_prefill_attention_q4", "decode_attention",
           "flash_qattention", "flash_qdecode")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, dict] = {}   # name -> {"seconds", "ptxas", "path"}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA kernels of "
                       "repro_torch are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel not yet built for the current sources, in
    parallel; returns name -> library path."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {k: out_dir / f"lib{k}.so" for k in KERNELS}
    todo = [k for k in KERNELS if not paths[k].exists()]
    if todo:
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for k in todo:
            tmp = out_dir / f"lib{k}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{k}.cu")]
            procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp, cmd)
        failed = []
        for k, (proc, tmp, cmd) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            (out_dir / f"lib{k}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, paths[k])
            build_info[k] = {"seconds": secs, "ptxas": log, "path": str(paths[k])}
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for k in KERNELS:
        if k not in build_info:
            log = out_dir / f"lib{k}.log"
            build_info[k] = {"seconds": 0.0, "path": str(paths[k]),
                             "ptxas": log.read_text() if log.exists() else ""}
    return paths


def load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all()[name]))
    return _libs[name]


def bind(name: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry ``symbol`` of kernel ``name``: ``n_ptr`` pointers, then
    ``n_int`` ints, then the stream — pointers and the stream as c_void_p
    (a plain int would be cut to 32 bits)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_query(name: str, *ints) -> int:
    """The dynamic shared memory a launch of kernel ``name`` asks for, as
    its library's ``<name>_smem(...)`` answers for the launch parameters
    ``ints`` (-1 where the library has no instance of them)."""
    fn = getattr(load(name), f"{name}_smem")
    fn.argtypes = [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_int
    return int(fn(*ints))


def device_scalar(v, dtype, device):
    """A scalar argument as a one-element tensor in device memory (a
    kernel reads it there, so a scalar that already lives on the card
    costs no host synchronisation)."""
    import torch

    return torch.as_tensor(v, dtype=dtype).to(device).reshape(1).contiguous()


def attn_scalars(device, M_idx, shift_idx, inv_s_logit, out_scale):
    """The attention kernels' four scalars (the LUT index multiplier and
    shift, the logit scale, the output scale) in device memory."""
    import torch

    return [device_scalar(M_idx, torch.int32, device),
            device_scalar(shift_idx, torch.int32, device),
            device_scalar(inv_s_logit, torch.float32, device),
            device_scalar(out_scale, torch.float32, device)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of ``device``'s card (the wrappers size
    their grids to cover them)."""
    import torch

    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
