"""Checks over the port's CUDA kernels (``csrc/``), the counterpart of the
reference's ``analysis/pallas_lint.py``.

``IDXMAP-RANGE`` / ``IDXMAP-CLAMP``
    A Pallas index map is a function the reference evaluates; a CUDA
    kernel's index arithmetic lives in device code, so this check RUNS the
    kernels that walk a block table or a length (rows 3, 4, 7, 8: the paged
    family; 6: ``decode_qattention``; 10: ``flash_qdecode``) over the
    reference's battery of edge-case lengths, chunk origins and block
    tables, and holds each output against the plain version's.  Every dead
    table column points at a valid page filled with a sentinel (every dead
    row of a stripe holds one): a different output means a dead page was
    read (``IDXMAP-CLAMP``).  The pool sits between two pools' worth of
    guard pages of poison (a stripe between as many guard slots): a
    different output means a read past the pool (``IDXMAP-RANGE``), and so
    does any byte of an input's buffer, guards included, that a call
    changes (a write that left ``out``).  A read further out than the
    guards is seen only by compute-sanitizer's memcheck, which runs the
    battery again in a subprocess on the card wherever the tool runs; its
    every reported access is an ``IDXMAP-RANGE``.  On the CPU the wrappers
    run the plain versions, which the battery holds to the same contract.

``SMEM-BUDGET`` (counterpart of ``VMEM-BUDGET``)
    From the ``ptxas -v`` log ``_build.build_all`` keeps, each kernel's
    static shared memory plus the dynamic bytes its launches ask for (the
    libraries' ``*_smem`` queries, at the shapes the served archs give and
    every launch plan the tuner can pick there) must fit the H100's 227 KB
    a block.  Registers and spills are reported, not gated.

``ARG-ORDER`` (counterpart of ``SCALAR-PREFETCH``)
    Each ``_build.bind(name, symbol, n_ptr, n_int)(...)`` call must pass as
    many pointers and ints as the ``extern "C"`` entry of
    ``csrc/<name>.cu`` declares, and its pointer arguments in the entry's
    order: a swapped (lengths, block_tables) pair type-checks and runs,
    reading garbage.  Text only, so it runs on the CPU.

``SHARED-BODY``
    The int8 and int4 members of each kernel pair claim one datapath: each
    ``.cu`` must include the shared header and call its launcher, with no
    ``__global__`` body of its own.  Text only.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.graph_audit import Violation
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_qattention as FA
from repro_torch.kernels import int4_matmul as MM
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels import ref
from repro_torch.kernels.hw_constants import SMEM_PER_BLOCK
KERNEL_MODULES = ("decode_attention", "flash_qattention", "int4_matmul", "prefill_attention",
                  "quant_layernorm", "quant_softmax")
SRC = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Check:
    check: str
    kernel: str
    ok: bool
    detail: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _violation(rule: str, kernel: str, detail: str) -> Violation:
    return Violation(rule=rule, graph=f"kernel:{kernel}", scope="", detail=detail)


# --- index bounds: the battery ----------------------------------------------------

POISON_I8, POISON_U8 = 127, 0x77        # every code (nibble) at its largest
POISON_SCALE = 64.0                     # a page scale that saturates every dequantized code


def _scalars(d: int, dev):
    """The attention scalars of a logit scale that spreads random codes'
    logits over about +-2 (as chip_smoke.py's kernel phases use)."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qsoftmax import LUT_DELTA

    s_logit = float(np.sqrt(d)) * 73.0 * 73.0 / 2.0
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32, device=dev),
            torch.tensor(sh, dtype=torch.int32, device=dev),
            torch.as_tensor(ref.make_exp_lut_q7(), device=dev),
            torch.tensor(np.float32(1.0 / s_logit), device=dev),
            torch.tensor(np.float32(1.1), device=dev))


def _guarded(t: torch.Tensor, fill) -> torch.Tensor:
    """``t`` copied into a buffer with as many guard entries along axis 0
    before and after as ``t`` has (a whole pool of guard pages each side),
    filled with ``fill``; returns the view of ``t``'s place."""
    n = t.shape[0]
    buf = torch.full((3 * n, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    buf[n:2 * n] = t
    return buf[n:2 * n]


def _btab(b: int, nb: int, live: List[int], n_pages: int, dead: int) -> torch.Tensor:
    """Each slot's ``live[b]`` distinct pages, interleaved across slots and
    never page 0 (the trash page) or ``n_pages - 1`` (the sentinel page);
    ``dead`` in every column past them."""
    btab = np.full((b, nb), dead, np.int32)
    nxt = 0
    for bb in range(b):
        for k in range(live[bb]):
            btab[bb, k] = 1 + nxt % (n_pages - 2)
            nxt += 5
    return torch.as_tensor(btab)


@dataclasses.dataclass
class Case:
    """One battery point.  ``args[v]`` are the wrapper's arguments under
    variant ``v``: ``"want"`` (the engine's state: dead table columns on
    the zero trash page, zero guards), ``"clamp"`` (dead columns on a
    sentinel page), ``"guard"`` (poisoned guards) and, for the paged
    family, ``"trash"`` (the trash page poisoned, as inactive slots leave
    it).  ``kwargs`` go to ``fn`` and ``plain`` alike."""
    label: str
    fn: Callable
    plain: Callable
    args: Dict[str, tuple]
    kwargs: Dict = dataclasses.field(default_factory=dict)


def _paged_pools(gen, n_pages, psize, hkv, d, packed, dev) -> Dict[str, List[torch.Tensor]]:
    """The pool arguments (int8 K and V, or packed K, V and their page
    scales) of each variant, each between guard pages.  Page 0 is the trash
    page, page n_pages - 1 the sentinel page."""
    if packed:
        k, v = (torch.randint(0, 256, (n_pages, psize, hkv, d // 2), generator=gen,
                              dtype=torch.uint8) for _ in range(2))
        ks, vs = (torch.randint(1, 128, (n_pages,), generator=gen).to(torch.float32)
                  * float(np.float32(1 / 7)) for _ in range(2))
        pools, poison, scales = [k, v, ks, vs], POISON_U8, (2, 3)
    else:
        pools = [torch.randint(-127, 128, (n_pages, psize, hkv, d), generator=gen,
                               dtype=torch.int8) for _ in range(2)]
        poison, scales = POISON_I8, ()

    def bad(i):
        return POISON_SCALE if i in scales else poison

    for i, t in enumerate(pools):
        t[0] = 1.0 / 7 if i in scales else 0
    out = {}
    for variant, page in (("want", None), ("clamp", -1), ("guard", None), ("trash", 0)):
        ts = [t.clone() for t in pools]
        if page is not None:
            for i, t in enumerate(ts):
                t[page] = bad(i)
        out[variant] = [_guarded(t.to(dev), bad(i) if variant == "guard" else 0)
                        for i, t in enumerate(ts)]
    return out


def paged_decode_cases(dev, packed: bool, fn: Optional[Callable] = None) -> Iterator[Case]:
    """Rows 4 and 7 over the reference's decode lengths (3 slots, 2 kv heads
    of 2 q heads, 16-row pages, 4 table columns).  A decode step attends its
    own row, so lengths start at 1."""
    b, hkv, g, d, psize, nb = 3, 2, 2, 32, 16, 4
    n_pages = b * nb + 2
    gen = torch.Generator().manual_seed(0)
    pools = _paged_pools(gen, n_pages, psize, hkv, d, packed, dev)
    fn = fn or (DA.paged_decode_qattention_q4 if packed else DA.paged_decode_qattention)
    plain = ref.paged_decode_qattention_q4_ref if packed else ref.paged_decode_qattention_ref
    smax = nb * psize
    for ln in (1, psize - 1, psize, psize + 1, smax - 1, smax):
        live = [-(-ln // psize)] * b
        q = torch.randint(-127, 128, (b, hkv, g, d), generator=gen, dtype=torch.int8).to(dev)
        lens = torch.full((b,), ln, dtype=torch.int32, device=dev)
        yield Case(f"len={ln}", fn, plain, {
            v: (q, *pools[v], _btab(b, nb, live, n_pages, n_pages - 1 if v == "clamp" else 0)
                .to(dev), lens, *_scalars(d, dev)) for v in pools})


def paged_prefill_cases(dev, packed: bool) -> Iterator[Case]:
    """Rows 3 and 8 over the reference's chunk origins under the kernel
    contract ``pos0 + S <= nb * P`` (2 slots, 4 q heads over 2 kv heads, a
    16-row chunk of 16-row pages, 4 table columns)."""
    b, h, hkv, d, psize, nb, sq = 2, 4, 2, 32, 16, 4, 16
    n_pages = b * nb + 2
    gen = torch.Generator().manual_seed(1)
    pools = _paged_pools(gen, n_pages, psize, hkv, d, packed, dev)
    fn = PA.paged_prefill_qattention_q4 if packed else PA.paged_prefill_qattention
    plain = ref.paged_prefill_qattention_q4_ref if packed else ref.paged_prefill_qattention_ref
    for pos0 in (0, psize, nb * psize - sq):
        live = [-(-(pos0 + sq) // psize)] * b
        q = torch.randint(-127, 128, (b, h, sq, d), generator=gen, dtype=torch.int8).to(dev)
        p0 = torch.full((b,), pos0, dtype=torch.int32, device=dev)
        yield Case(f"pos0={pos0}", fn, plain, {
            v: (q, *pools[v], _btab(b, nb, live, n_pages, n_pages - 1 if v == "clamp" else 0)
                .to(dev), p0, *_scalars(d, dev)) for v in pools})


def _stripe(gen, b, smax, hkv, d, lengths, dev) -> Dict[str, List[torch.Tensor]]:
    """K and V stripes (B, Smax, Hkv, D) of each variant between guard
    slots: rows past each slot's length zero, or the sentinel (clamp)."""
    kv = [torch.randint(-127, 128, (b, smax, hkv, d), generator=gen, dtype=torch.int8)
          for _ in range(2)]
    dead = torch.arange(smax)[None, :] >= torch.as_tensor(lengths)[:, None]     # (B, Smax)
    out = {}
    for variant in ("want", "clamp", "guard"):
        ts = []
        for t in kv:
            t = t.clone()
            t[dead] = POISON_I8 if variant == "clamp" else 0
            ts.append(_guarded(t.to(dev), POISON_I8 if variant == "guard" else 0))
        out[variant] = ts
    return out


def stripe_decode_cases(dev) -> Iterator[Case]:
    """Row 6 over the reference's lengths (3 slots, 64-row stripes, bkv 16)."""
    b, smax, hkv, g, d, bkv = 3, 64, 2, 2, 32, 16
    gen = torch.Generator().manual_seed(2)
    for ln in (1, bkv - 1, bkv, bkv + 1, smax - 1, smax):
        kv = _stripe(gen, b, smax, hkv, d, [ln] * b, dev)
        q = torch.randint(-127, 128, (b, hkv, g, d), generator=gen, dtype=torch.int8).to(dev)
        tail = (torch.full((b,), ln, dtype=torch.int32, device=dev), *_scalars(d, dev))
        yield Case(f"len={ln}", DA.decode_qattention, ref.decode_qattention_ref,
                   {v: (q, *ts, *tail) for v, ts in kv.items()}, kwargs={"bkv": bkv})


def flash_qdecode_cases(dev) -> Iterator[Case]:
    """Row 10 over the reference's cache lengths: one sequence's (Hkv, Smax,
    D) cache seen through a (Smax, Hkv, D) stripe, bkv 16."""
    smax, hkv, g, d, bkv = 64, 2, 2, 32, 16
    gen = torch.Generator().manual_seed(3)
    for ln in (1, bkv - 1, bkv, bkv + 1, smax - 1, smax):
        kv = _stripe(gen, 1, smax, hkv, d, [ln], dev)
        q = torch.randint(-127, 128, (hkv, g, d), generator=gen, dtype=torch.int8).to(dev)
        tail = (ln, *_scalars(d, dev))
        yield Case(f"cache_len={ln}", FA.flash_qdecode, ref.flash_qdecode_ref,
                   {v: (q, *(t[0].transpose(0, 1) for t in ts), *tail) for v, ts in kv.items()},
                   kwargs={"bkv": bkv})


BATTERY = {
    "paged_prefill_qattention": lambda dev: paged_prefill_cases(dev, False),
    "paged_decode_qattention": lambda dev: paged_decode_cases(dev, False),
    "decode_qattention": stripe_decode_cases,
    "paged_decode_qattention_q4": lambda dev: paged_decode_cases(dev, True),
    "paged_prefill_qattention_q4": lambda dev: paged_prefill_cases(dev, True),
    "flash_qdecode": flash_qdecode_cases,
}


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.cpu() != b.cpu()).sum())


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"kernel_lint on {device!r} needs a CUDA card (pass device='cpu' "
                           "to lint the plain versions)")
    return dev


def _buffers(args: tuple) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(the whole buffer under each tensor argument, a copy of it)."""
    out = []
    for t in args:
        if isinstance(t, torch.Tensor) and t.numel():
            buf = torch.empty(0, dtype=torch.uint8, device=t.device).set_(t.untyped_storage())
            out.append((buf, buf.clone()))
    return out


def check_index_bounds(device: str = "cuda",
                       battery: Optional[Dict[str, Callable]] = None) -> List[Violation]:
    """Run every battery case through its wrapper (the CUDA kernel on
    ``cuda``, the plain version on ``cpu``).  ``IDXMAP-CLAMP``: the output
    with dead columns on the sentinel page differs from the plain
    version's.  ``IDXMAP-RANGE``: the output moves when only the guards, or
    only the trash page, change (a read outside the pool or of a page that
    is not the slot's own), or a call changes any byte of an input's
    buffer, its guards included (a write outside the output)."""
    out: List[Violation] = []
    for kernel, cases in (battery or BATTERY).items():
        for c in cases(_device(device)):
            want = c.plain(*c.args["want"], **c.kwargs)
            got = {}
            for v, a in c.args.items():
                bufs = _buffers(a)
                got[v] = c.fn(*a, **c.kwargs)
                moved = sum(_differ(buf, was) for buf, was in bufs)
                if moved:
                    out.append(_violation("IDXMAP-RANGE", kernel,
                                          f"{c.label} ({v}): the call wrote {moved} byte(s) "
                                          "of its inputs' buffers or their guards: a write "
                                          "left the output"))
            n = _differ(got["clamp"], want)
            if n:
                out.append(_violation("IDXMAP-CLAMP", kernel,
                                      f"{c.label}: {n} of {want.numel()} outputs differ from "
                                      "the plain version's with dead columns on a sentinel "
                                      "page: a dead page was read"))
            for v, what in (("guard", "a poisoned guard page: a read left the pool"),
                            ("trash", "a poisoned trash page: a page not the slot's own "
                                      "was read")):
                n = _differ(got[v], got["want"]) if v in got else 0
                if n:
                    out.append(_violation("IDXMAP-RANGE", kernel,
                                          f"{c.label}: {n} of {want.numel()} outputs move "
                                          f"under {what}"))
    return out


def _sanitizer() -> Optional[str]:
    try:
        cand = pathlib.Path(_build.nvcc_path()).parent / "compute-sanitizer"
    except RuntimeError:
        cand = None
    if cand is not None and cand.is_file():
        return str(cand)
    return shutil.which("compute-sanitizer")


UNAVAILABLE = "unavailable: "


def _sanitizer_errors(text: str) -> str:
    """The tool's own ``Error:`` and ``Program hit`` lines, joined."""
    hits = [ln.strip("= ").strip() for ln in text.splitlines()
            if re.search(r"=+ (Error:|Program hit)", ln)]
    return " | ".join(hits[:3]) or " | ".join(text.strip().splitlines()[-3:])


def check_memcheck(timeout: float = 300.0) -> Tuple[Check, List[Violation]]:
    """The battery on the card under ``compute-sanitizer --tool memcheck``,
    in a subprocess, with the CUDA caching allocator off so that every
    tensor is its own allocation and a write past ``out`` is an access the
    tool sees.  API errors are not reported (only accesses are the rule's).
    A clean control program runs first: where the tool fails even that
    (it refuses the device), the check is ``ok=False`` with a detail that
    starts with ``UNAVAILABLE`` and the tool's own error lines, and finds
    nothing."""
    tool = _sanitizer()
    if tool is None:
        return Check("memcheck", "*", False, UNAVAILABLE + "no compute-sanitizer"), []
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1", PYTHONPATH=os.pathsep.join(
        [str(SRC.parent)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    base = [tool, "--tool", "memcheck", "--report-api-errors", "no", "--error-exitcode", "1",
            sys.executable]
    ctl = subprocess.run(base + ["-c", "import torch; print(torch.ones(4, device='cuda').sum()"
                                       ".item())"],
                         capture_output=True, text=True, env=env, timeout=timeout)
    if ctl.returncode != 0:
        return Check("memcheck", "*", False,
                     f"{UNAVAILABLE}a clean control program fails under compute-sanitizer "
                     f"(exit {ctl.returncode}: {_sanitizer_errors(ctl.stdout + ctl.stderr)})"), []
    run = subprocess.run(base + ["-m", "repro_torch.analysis.kernel_lint", "--battery"],
                         capture_output=True, text=True, env=env, timeout=timeout)
    errors = [ln for ln in (run.stdout + run.stderr).splitlines()
              if re.search(r"Invalid (__global__|__shared__|__local__)? ?(read|write)|"
                           r"out of bounds|Address .* is out of bounds", ln)]
    viols = [_violation("IDXMAP-RANGE", "*", f"memcheck: {ln.strip()}") for ln in errors[:20]]
    if run.returncode != 0 and not viols:
        tail = " | ".join((run.stdout + run.stderr).strip().splitlines()[-3:])
        viols.append(_violation("IDXMAP-RANGE", "*", f"memcheck exit {run.returncode}: {tail}"))
    return Check("memcheck", "*", not viols, f"{len(viols)} violation(s)"), viols


# --- shared memory -----------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> List[Dict]:
    """Per entry function of a ``ptxas -v`` log: registers, static shared
    memory and spill bytes."""
    out: List[Dict] = []
    cur: Optional[Dict] = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"entry": m.group(1), "registers": 0, "smem": 0, "spill_stores": 0,
                   "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


# (K, N) of the served archs' linears: yi-6b's, qwen3-4b's, mixtral's widest,
# jamba's; BERT-base's for the W8A8 bit-split GEMM
GEMM_KN = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (2560, 9728),
           (6144, 16384), (16384, 6144), (8192, 24576), (24576, 8192))
BITSPLIT_KN = ((768, 768), (768, 3072), (3072, 768))
GEMM_M = (1, 8, 32, 128, 512, 2048, 4096)


def dynamic_smem() -> Dict[str, int]:
    """Kernel library -> the most dynamic shared memory its launches ask
    for at the served shapes, over every plan and heads per block the
    launch tuner can pick there (``autotune.gemm_candidates``; the flash
    prefill at every heads per block up to the most; the paged prefill's
    request does not depend on it), -1 where a plan has no instance in the
    library (card only: the libraries answer)."""
    out = {lib: 0 for lib in _build.KERNELS}
    sms = _build.sm_count(torch.device("cuda"))
    for lib, kn, w_bits in (("int4_matmul", GEMM_KN, 4), ("int8_bitsplit_matmul", BITSPLIT_KN, 8)):
        for m in GEMM_M:
            for k, n in kn:
                for p in autotune.gemm_candidates(m, k, n, w_bits, sms):
                    got = _build.smem_query(lib, MM.PATHS.index(p.path), p.bm, p.bn, k, p.split)
                    out[lib] = -1 if min(got, out[lib]) < 0 else max(out[lib], got)
    for lib in ("paged_prefill_attention", "paged_prefill_attention_q4"):
        out[lib] = max(_build.smem_query(lib, psize, d) for psize in (8, 16, 32, 64)
                       for d in (64, 128))
    out["flash_qattention"] = max(_build.smem_query("flash_qattention", d, gh)
                                  for d in (64, 128)
                                  for gh in range(1, FA.MAX_HEADS_PER_BLOCK + 1))
    return out


def check_smem(logs: Dict[str, str], dynamic: Optional[Dict[str, int]] = None,
               ) -> Tuple[List[Check], List[Violation]]:
    """Each library's largest static shared memory (its ptxas log) plus its
    largest dynamic request against ``SMEM_PER_BLOCK``; one check a
    library, with its registers and spills in the detail."""
    checks, viols = [], []
    for lib, log in logs.items():
        entries = parse_ptxas(log)
        static = max((e["smem"] for e in entries), default=0)
        dyn = (dynamic or {}).get(lib, 0)
        if dyn < 0:
            viols.append(_violation("SMEM-BUDGET", lib, "a served shape's launch plan has no "
                                                        "instance in the library"))
        elif static + dyn > SMEM_PER_BLOCK:
            viols.append(_violation("SMEM-BUDGET", lib,
                                    f"static {static} B + dynamic {dyn} B of shared memory "
                                    f"exceed the {SMEM_PER_BLOCK} B a block may hold"))
        regs = max((e["registers"] for e in entries), default=0)
        spills = sum(e["spill_stores"] + e["spill_loads"] for e in entries)
        checks.append(Check("smem_budget", lib, not any(v.graph == f"kernel:{lib}" for v in viols),
                            f"{len(entries)} entries, registers <= {regs}, static smem <= "
                            f"{static} B, dynamic <= {dyn} B, spill bytes {spills}"))
    return checks, viols


# --- argument order ---------------------------------------------------------------

_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
# C entry parameter -> the names a wrapper may pass for it, where they differ
ARG_ALIASES = {"kpool": ("kp", "k"), "vpool": ("vp", "v"), "kc": ("k",), "vc": ("v",),
               "lengths": ("lens", "lengths"), "cache_len": ("lengths",), "pos0": ("p0",),
               "lut": ("lut", "table")}
# the attention scalars a wrapper passes as *(t.data_ptr() for t in scal)
SCALARS = ("Mi", "shi", "inv", "osc")
# a bind whose symbol is a variable: the function -> the entries it launches
VARIABLE_BINDS = {"_stripe_call": ("decode_attention", "flash_qdecode"),
                  "_launch": ("int4_matmul", "int8_bitsplit_matmul")}


def c_entries(sources: Dict[str, str]) -> Dict[str, Tuple[List[str], List[str]]]:
    """C entry name -> (pointer parameter names, int parameter names), the
    trailing stream left out."""
    out = {}
    for text in sources.values():
        for name, params in _EXTERN.findall(text):
            ptrs, ints = [], []
            for p in (p.strip() for p in params.split(",") if p.strip()):
                pname = re.split(r"[\s*]+", p)[-1]
                (ptrs if "*" in p else ints).append(pname)
            if ptrs and ptrs[-1] == "stream":
                ptrs.pop()
            out[name] = (ptrs, ints)
    return out


def _py_pointer_names(call: ast.Call) -> List[str]:
    """The pointer arguments of a bound entry's call, in order, as base
    names (``x.data_ptr()`` -> ``x``; the attention scalars' starred
    expansion -> ``SCALARS``); stops at the first int argument."""
    names: List[str] = []
    for a in call.args:
        if isinstance(a, ast.Starred):
            inner = a.value
            if isinstance(inner, ast.GeneratorExp) and "data_ptr" in ast.dump(inner.elt):
                names.extend(SCALARS)
                continue
            break
        if isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute) \
                and a.func.attr == "data_ptr":
            v = a.func.value
            names.append(v.id if isinstance(v, ast.Name) else ast.unparse(v))
            continue
        break
    return names


def _matches(c_name: str, py_name: str) -> bool:
    if c_name in SCALARS:
        return py_name == c_name
    return py_name == c_name or py_name in ARG_ALIASES.get(c_name, ())


def check_arg_order(py_sources: Optional[Dict[str, str]] = None,
                    c_sources: Optional[Dict[str, str]] = None) -> List[Violation]:
    """Every ``_build.bind(...)(...)`` call in the kernel modules against
    the C entry it binds: pointer and int counts, and the pointers' order.
    Over the tree's own sources every kernel's entry must be bound."""
    whole_tree = py_sources is None
    if py_sources is None:
        py_sources = {m: (SRC / "kernels" / f"{m}.py").read_text() for m in KERNEL_MODULES}
    if c_sources is None:
        c_sources = {p.name: p.read_text() for p in sorted((SRC / "csrc").glob("*.cu"))}
    entries = c_entries(c_sources)
    out: List[Violation] = []
    bound = set()
    for mod, text in py_sources.items():
        tree = ast.parse(text)
        for fd in (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)):
            for call in (n for n in ast.walk(fd) if isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Call)
                         and isinstance(n.func.func, ast.Attribute)
                         and n.func.func.attr == "bind"):
                bargs = call.func.args
                sym = bargs[1].value if isinstance(bargs[1], ast.Constant) else None
                targets = (sym,) if sym else VARIABLE_BINDS.get(fd.name, ())
                if not targets:
                    out.append(_violation("ARG-ORDER", f"{mod}.{fd.name}",
                                          "binds a symbol this lint cannot name"))
                n_ptr = bargs[2].value if isinstance(bargs[2], ast.Constant) else None
                n_int = bargs[3].value if isinstance(bargs[3], ast.Constant) else None
                names = _py_pointer_names(call)
                for entry in targets:
                    bound.add(entry)
                    if entry not in entries:
                        out.append(_violation("ARG-ORDER", entry, f"{mod}.{fd.name} binds "
                                                                  "an entry no csrc/*.cu "
                                                                  "declares"))
                        continue
                    ptrs, ints = entries[entry]
                    if n_ptr is not None and n_ptr != len(ptrs):
                        out.append(_violation("ARG-ORDER", entry,
                                              f"{mod}.{fd.name} binds {n_ptr} pointers, the "
                                              f"entry declares {len(ptrs)}"))
                    if n_int is not None and n_int != len(ints):
                        out.append(_violation("ARG-ORDER", entry,
                                              f"{mod}.{fd.name} binds {n_int} ints, the "
                                              f"entry declares {len(ints)}"))
                    if len(names) != len(ptrs):
                        out.append(_violation("ARG-ORDER", entry,
                                              f"{mod}.{fd.name} passes {len(names)} pointers "
                                              f"{names}, the entry takes {ptrs}"))
                        continue
                    for i, (c, p) in enumerate(zip(ptrs, names)):
                        if not _matches(c, p):
                            out.append(_violation(
                                "ARG-ORDER", entry,
                                f"{mod}.{fd.name}: pointer {i} is `{p}`, the entry's "
                                f"parameter there is `{c}` (order: {', '.join(ptrs)})"))
    if whole_tree:
        for entry in sorted(set(_build.KERNELS) - bound):
            out.append(_violation("ARG-ORDER", entry, "no wrapper binds this entry"))
    return out


# --- shared bodies ----------------------------------------------------------------

# each member of a pair -> (the shared header, the launcher it must call)
SHARED_BODY = {
    "paged_decode_attention.cu": ("paged_decode.cuh", "launch_paged_decode"),
    "paged_decode_attention_q4.cu": ("paged_decode.cuh", "launch_paged_decode"),
    "paged_prefill_attention.cu": ("paged_prefill.cuh", "launch_paged_prefill"),
    "paged_prefill_attention_q4.cu": ("paged_prefill.cuh", "launch_paged_prefill"),
    "decode_attention.cu": ("stripe_decode.cuh", "launch_stripe_decode"),
    "flash_qdecode.cu": ("stripe_decode.cuh", "launch_stripe_decode"),
}


def check_shared_body(c_sources: Optional[Dict[str, str]] = None) -> List[Violation]:
    """Each member of a pair includes its shared header, calls its launcher
    and defines no kernel body of its own."""
    if c_sources is None:
        c_sources = {f: (SRC / "csrc" / f).read_text() for f in SHARED_BODY}
    out: List[Violation] = []
    for f, text in c_sources.items():
        header, launcher = SHARED_BODY[f]
        code = re.sub(r"//[^\n]*", "", text)
        if f'#include "{header}"' not in code:
            out.append(_violation("SHARED-BODY", f, f"does not include the shared {header}"))
        if not re.search(rf"\bfq::{launcher}\s*\(", code):
            out.append(_violation("SHARED-BODY", f, f"does not launch through the shared "
                                                    f"fq::{launcher}"))
        if "__global__" in code:
            out.append(_violation("SHARED-BODY", f, "defines a kernel body of its own: the "
                                                    "pair's one-datapath claim no longer "
                                                    "holds"))
    return out


def run_all(device: str = "cuda") -> Dict:
    """Every kernel lint; returns {"checks": [...], "violations": [...]}.
    On ``cuda`` (the default; it raises without a card) the battery runs
    the kernels, and again under compute-sanitizer's memcheck, and the
    shared-memory budget reads the build's ptxas logs; on ``cpu`` the
    battery runs the plain versions and the budget is left to the card."""
    device = _device(device).type
    groups = {
        "idxmap_battery": check_index_bounds(device),
        "arg_order": check_arg_order(),
        "shared_body": check_shared_body(),
    }
    checks = [Check(name, "*", not viols, f"{len(viols)} violation(s)")
              for name, viols in groups.items()]
    if device == "cuda":
        _build.build_all()
        smem_checks, groups["smem_budget"] = check_smem(
            {k: v["ptxas"] for k, v in _build.build_info.items()}, dynamic_smem())
        checks += smem_checks
        mc, groups["memcheck"] = check_memcheck()
        checks.append(mc)
    else:
        checks.append(Check("smem_budget", "*", True, "not run: the ptxas logs come from the "
                                                      "card's build"))
    return {"checks": [c.to_dict() for c in checks],
            "violations": [v.to_dict() for vs in groups.values() for v in vs]}


def failed_checks(lint: Dict) -> List[Dict]:
    """The checks of a ``run_all`` payload that fail: every one not ok,
    but a memcheck whose tool cannot run on the machine (printed, since it
    found nothing either way)."""
    return [c for c in lint["checks"]
            if not c["ok"] and not c["detail"].startswith(UNAVAILABLE)]


if __name__ == "__main__" and sys.argv[1:] == ["--battery"]:
    # the memcheck subprocess: the battery on the card, nothing else
    viols = check_index_bounds("cuda")
    torch.cuda.synchronize()
    print(f"battery: {len(viols)} violation(s)")
    raise SystemExit(1 if viols else 0)
