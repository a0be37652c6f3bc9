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
           "paged_decode_attention")
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


def device_scalar(v, dtype, device):
    """A scalar argument as a one-element tensor in device memory (a
    kernel reads it there, so a scalar that already lives on the card
    costs no host synchronisation)."""
    import torch

    return torch.as_tensor(v, dtype=dtype).to(device).reshape(1).contiguous()


def check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
