"""kernels/autotune.py and kernels/hw_constants.py of the port, on the CPU.

The reference's ``tests/test_autotune.py`` case for case on the port's
knobs (the GEMMs' plan, the attention's heads per block, the contiguous
decode's bkv): picks are legal and cached, a poisoned cache wins, pins
win, the off switch gives back the fixed rules, and measured mode falls
back to the model without a card.  Then ``_fit`` and ``measure_best``
against the reference's own, the single source of the card's ceilings,
and the finding that bkv moves codes.  The GEMM model asks the kernel
library for each plan's shared memory; here a stand-in answers
(``_library``).  The kernels themselves, the library's answers and the
measured mode's races are held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``[autotune]``).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.analysis import kernel_lint
from repro_torch.core import fixedpoint as fxp
from repro_torch.core.qsoftmax import LUT_DELTA
from repro_torch.kernels import _build, autotune, ref
from repro_torch.kernels import hw_constants as HW
from repro_torch.kernels import int4_matmul as MM
from repro_torch.kernels import prefill_attention as PA

ENV = ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_GEMM_PLAN", "REPRO_TORCH_HEADS_PER_BLOCK",
       "REPRO_TORCH_DECODE_BKV")
# (group, units, sms): yi-6b's (8), qwen3-4b's (4), mixtral's and qwen2-vl's
# (6), G = 1 and 16; prefill chunks of 1-176 row tiles x slots x kv heads;
# the H100 and two smaller cards
ATTN_BATTERY = [(g, u, s) for g in (1, 4, 6, 8, 16) for u in (1, 4, 16, 32, 64, 128, 176, 512)
                for s in (132, 114, 78)]
GEMM_BATTERY = ([(m, k, n, 4) for m in kernel_lint.GEMM_M for k, n in kernel_lint.GEMM_KN]
                + [(m, k, n, 8) for m in kernel_lint.GEMM_M for k, n in kernel_lint.BITSPLIT_KN])


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _library(monkeypatch, smem=40_000):
    """A stand-in for the kernel libraries' ``*_smem`` queries, which the
    GEMM model asks for each plan (the card answers for real): ``smem``
    bytes for every plan; the queries it was asked, in a list."""
    asked = []

    def query(name, *ints):
        asked.append((name,) + ints)
        return smem

    monkeypatch.setattr(_build, "smem_query", query)
    return asked


def _legal(p, m, k, n, w_bits):
    """A plan the libraries have an instance of, on the path M implies
    (the shared memory of every candidate is the kernel lint's, on the
    card)."""
    assert p in autotune.gemm_candidates(m, k, n, w_bits)
    assert p.path == ("decode" if m <= MM.DECODE_MAX_M else "tensor_core")
    assert (p.bm, p.bn) in (MM.TC_TILES if p.path == "tensor_core" else [(8, MM.DECODE_COLS)])
    if p.path == "decode":
        assert MM.decode_fits(k, p.split, w_bits)


def test_decode_bkv_legal_divisor():
    for smax in (64, 512, 2048, 96):
        got = autotune.decode_bkv(smax, batch_slots=8, hkv=8, hd=128)
        assert smax % got == 0 and got >= 1
        assert got <= autotune.DEFAULT_DECODE_BKV


def test_heads_per_block_legal_divisor():
    for group, units, sms in ATTN_BATTERY:
        got = autotune.attn_heads_per_block(group, units, sms)
        assert group % got == 0 and 1 <= got <= PA.MAX_HEADS_PER_BLOCK


def test_gemm_plan_legal_with_an_instance(monkeypatch):
    """The model's picks (at two shared-memory answers), and without a card
    the off rule's, are legal; the model asks the library of the GEMM at
    hand for every candidate's launch parameters."""
    for smem in (40_000, 120_000):
        asked = _library(monkeypatch, smem)
        autotune.clear_cache()
        for m, k, n, w_bits in GEMM_BATTERY:
            _legal(autotune.gemm_plan(m, k, n, w_bits, device="cuda"), m, k, n, w_bits)
            _legal(autotune.gemm_plan(m, k, n, w_bits, device="cpu"), m, k, n, w_bits)
        m, k, n = GEMM_BATTERY[-1][:3]
        assert asked[-len(autotune.gemm_candidates(m, k, n, 8)):] == [
            ("int8_bitsplit_matmul", MM.PATHS.index(p.path), p.bm, p.bn, k, p.split)
            for p in autotune.gemm_candidates(m, k, n, 8)]


def test_fewest_page_streams_once_the_blocks_fill_the_card():
    """The counterpart of the reference's long-chain bq test: each block
    streams its K/V chain once, so where even the largest heads per block
    gives a full wave the model must not split the heads (it would stream
    every page more often)."""
    assert autotune.attn_heads_per_block(8, 512, 132) == 4
    assert autotune.attn_heads_per_block(16, 176, 132) == 4


def test_selection_cached_per_shape(monkeypatch):
    asked = _library(monkeypatch)
    g = ("gemm_plan", 512, 4096, 4096, 4, HW.SMS)
    autotune.gemm_plan(512, 4096, 4096, device="cuda")
    assert g in autotune._cache
    n_asked = len(asked)
    autotune.gemm_plan(512, 4096, 4096, device="cuda")
    assert len(asked) == n_asked       # a cache hit asks the library nothing
    poison = MM.GemmPlan("tensor_core", 64, 64, 3, 16, 8 * 64 * 3)
    autotune._cache[g] = poison        # poison: cache hit must win, with or without a card
    assert autotune.gemm_plan(512, 4096, 4096, device="cuda") == poison
    assert autotune.gemm_plan(512, 4096, 4096) == poison
    autotune.clear_cache()
    assert autotune.gemm_plan(512, 4096, 4096, device="cuda") != poison
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "measure")
    shape = ("paged_prefill_qattention", 1, 32, 128, 128, 4, 16, 9)
    h = ("measure", "attn_heads_per_block", 8, 64, HW.SMS, shape)
    autotune._cache[h] = 1
    assert autotune.attn_heads_per_block(8, 64, shape=shape) == 1
    assert autotune.attn_heads_per_block(8, 64, shape=shape[:-1] + (10,)) != 1
    autotune.decode_bkv(1024, batch_slots=4, hkv=8, hd=128)
    assert all(key[0] != "decode_bkv" for key in autotune._cache)


def test_env_override_pins_value(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DECODE_BKV", "256")
    assert autotune.decode_bkv(1024, batch_slots=4, hkv=8, hd=128) == 256
    # a pin is still divisor-fitted to the actual length
    assert autotune.decode_bkv(96, batch_slots=4, hkv=8, hd=128) == 96
    monkeypatch.setenv("REPRO_TORCH_DECODE_BKV", "1024")      # the kernel takes <= 512
    assert autotune.decode_bkv(2048, batch_slots=4, hkv=8, hd=128) == 512
    monkeypatch.setenv("REPRO_TORCH_HEADS_PER_BLOCK", "2")
    assert autotune.attn_heads_per_block(8, 512) == 2
    monkeypatch.setenv("REPRO_TORCH_HEADS_PER_BLOCK", "4")
    assert autotune.attn_heads_per_block(6, 512) == 3           # fitted to the group
    monkeypatch.setenv("REPRO_TORCH_GEMM_PLAN", "64x128/3")
    p = autotune.gemm_plan(512, 4096, 4096)
    assert (p.path, p.bm, p.bn, p.split, p.blocks) == ("tensor_core", 64, 128, 3, 8 * 32 * 3)
    p = autotune.gemm_plan(8, 4096, 4096)                       # the decode path: the split
    assert (p.path, p.bm, p.bn, p.split, p.blocks) == ("decode", 8, 128, 3, 32 * 3)
    monkeypatch.setenv("REPRO_TORCH_GEMM_PLAN", "64x128/1")     # raised until x fits
    p = autotune.gemm_plan(8, 24576, 8192)
    assert p.split == 3 and MM.decode_fits(24576, 3) and not MM.decode_fits(24576, 2)
    for m, k, n, w_bits in GEMM_BATTERY[::7]:
        _legal(autotune.gemm_plan(m, k, n, w_bits), m, k, n, w_bits)
    monkeypatch.setenv("REPRO_TORCH_GEMM_PLAN", "32x32/2")
    with pytest.raises(ValueError, match="BMxBN/SPLIT"):
        autotune.gemm_plan(512, 4096, 4096)


def test_off_mode_restores_the_fixed_rules(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "off")
    for m, k, n, w_bits in GEMM_BATTERY:
        for sms in (132, 114):
            assert autotune.gemm_plan(m, k, n, w_bits, sms) == MM.plan(m, k, n, w_bits, sms)
    for group, units, sms in ATTN_BATTERY:
        assert autotune.attn_heads_per_block(group, units, sms) == \
            PA.heads_per_block(group, units, sms)
    for smax in (64, 96, 256, 1024, 4096):
        assert autotune.decode_bkv(smax, batch_slots=4, hkv=8, hd=128) == \
            autotune._fit(autotune.DEFAULT_DECODE_BKV, smax)
    assert not autotune._cache
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "fast")
    with pytest.raises(ValueError, match="REPRO_TORCH_AUTOTUNE"):
        autotune.gemm_plan(512, 4096, 4096)


def test_plan_takes_the_device_sm_count():
    """``plan``'s wave follows the SMs it is given (the wrappers pass the
    card's); 132, the H100 SXM's, only where no card is at hand."""
    assert MM.plan(8, 4096, 4096).split == -(-HW.SMS // 32)
    assert MM.plan(8, 4096, 4096, sms=64).split == 2
    assert MM.plan(512, 4096, 4096, sms=78).split == 1      # 128 tiles fill 78 SMs


@pytest.mark.parametrize("mode", autotune.MODES)
def test_bkv_is_the_pin_or_512_in_every_mode(monkeypatch, mode):
    """bkv moves codes, so no mode picks it: an int8 or a 4-bit stripe gets
    the pin or 512, fitted to Smax, and nothing is cached or raced."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", mode)
    for kv_bits in (8, 4):
        for smax in (96, 384, 2048):
            assert autotune.decode_bkv(smax, batch_slots=8, hkv=8, hd=128,
                                       kv_bits=kv_bits) == autotune._fit(512, smax)
    monkeypatch.setenv("REPRO_TORCH_DECODE_BKV", "128")
    assert autotune.decode_bkv(2048, batch_slots=8, hkv=8, hd=128, kv_bits=4) == 128
    assert not autotune._cache


def test_measure_mode_falls_back_on_the_cpu(monkeypatch):
    """Without a card measured mode races nothing: each knob gives the
    model's pick (the off rule, with no library to ask) and caches no
    measured key; pins still win."""
    model = (autotune.gemm_plan(8, 4096, 11008), autotune.attn_heads_per_block(8, 32))
    assert model == (MM.plan(8, 4096, 11008), PA.heads_per_block(8, 32, HW.SMS))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "measure")
    shape = ("paged_prefill_qattention", 1, 32, 128, 128, 4, 16, 9)
    got = (autotune.gemm_plan(8, 4096, 11008, device="cpu"),
           autotune.attn_heads_per_block(8, 32, shape=shape, device="cpu"))
    assert got == model
    assert not any(k[0] == "measure" for k in autotune._cache)
    monkeypatch.setenv("REPRO_TORCH_HEADS_PER_BLOCK", "2")
    assert autotune.attn_heads_per_block(8, 32, shape=shape, device="cpu") == 2


def test_measure_mode_falls_back_without_kernel(monkeypatch):
    """Heads per block asked with no kernel geometry to race take the off
    rule, on any device; a GEMM over the cap takes the model's pick."""
    asked = _library(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "measure")
    for group, units, sms in ATTN_BATTERY[::5]:
        assert autotune.attn_heads_per_block(group, units, sms, device="cuda") == \
            PA.heads_per_block(group, units, sms)
    monkeypatch.setattr(autotune, "MEASURE_BYTES_CAP", 1 << 20)
    got = autotune.gemm_plan(512, 4096, 4096, device="cuda")
    assert asked and got == autotune._cache[("gemm_plan", 512, 4096, 4096, 4, HW.SMS)]
    assert not any(k[0] == "measure" for k in autotune._cache)


@pytest.mark.parametrize("smem", [0, 100_000])
def test_decode_grids_stay_in_their_wave(monkeypatch, smem):
    """The counterpart of the reference's small-bq test: the decode path's
    256-thread blocks hold an SM each (by the register file, whatever
    shared memory they ask), so a split whose grid spills a few blocks past
    a wave pays a second wave, and a split where the unsplit blocks already
    fit one wave pays the reduce pass; the model must price both out (the
    off rule takes split 5, 160 blocks, at N = 4096 and split 2 at N =
    8960)."""
    _library(monkeypatch, smem)
    assert autotune.gemm_plan(8, 4096, 4096, device="cuda").split == 4
    assert autotune.gemm_plan(8, 1536, 8960, device="cuda").split == 1
    assert autotune.gemm_plan(4, 6144, 16384, device="cuda").split == 1


def test_measure_best_caches_argmin():
    times = {32: 3.0, 64: 1.0, 128: 2.0}
    calls = []

    def timer(c):
        calls.append(c)
        return times[c]

    got = autotune.measure_best((32, 64, 128), timer, key=("m", 1))
    assert got == 64
    assert autotune.measure_best((32, 64, 128), timer, key=("m", 1)) == 64
    assert len(calls) == 3            # second call served from cache


@pytest.mark.parametrize("times", [{1: 2.0, 2: 2.0, 3: 1.0}, {1: 1.0, 2: 1.0, 3: 1.0},
                                   {1: 0.5, 2: 3.0, 3: 0.25}, {1: 9.0, 2: 8.0, 3: 8.0}])
def test_fit_and_measure_best_match_the_reference(times):
    for c in (1, 7, 64, 128, 500, 512, 1024):
        for n in (1, 96, 100, 128, 1000, 1024, 4000, 4096):
            assert autotune._fit(c, n) == ref_autotune._fit(c, n)
    cands = tuple(times)
    assert autotune.measure_best(cands, times.get) == ref_autotune.measure_best(cands, times.get)


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hw_constants_single_source_no_drift():
    """The card's ceilings live once, in kernels/hw_constants.py: the tuner,
    the GEMMs' plan, the kernel lint and chip_smoke.py's bounds resolve to
    the very same objects (a re-declared copy in any is the drift this
    pins)."""
    assert autotune.HBM_BW is HW.HBM_BW
    assert autotune.PEAK_INT8_OPS is HW.PEAK_INT8_OPS
    assert autotune.LAUNCH_FLOOR_S is HW.LAUNCH_FLOOR_S
    assert autotune.SMEM_PER_SM is HW.SMEM_PER_SM
    assert autotune.SMEM_RESERVED is HW.SMEM_RESERVED
    assert autotune.SMS is HW.SMS
    assert autotune.L2_BYTES is HW.L2_BYTES
    assert autotune.PEAK_INT32_OPS is HW.PEAK_INT32_OPS
    assert autotune.REGISTERS_PER_SM is HW.REGISTERS_PER_SM
    assert autotune.MAX_REGISTERS is HW.MAX_REGISTERS
    assert MM.SMS is HW.SMS
    assert kernel_lint.SMEM_PER_BLOCK is HW.SMEM_PER_BLOCK
    smoke = _load_chip_smoke()
    assert smoke.HBM_BYTES_PER_S is HW.HBM_BW
    assert smoke.INT8_OPS_PER_S is HW.PEAK_INT8_OPS
    assert smoke.F32_OPS_PER_S is HW.PEAK_F32_OPS
    assert smoke.L2_BYTES is HW.L2_BYTES


def test_bkv_moves_codes():
    """The stripe decode's q7 carry takes each block's max, and its LUT
    numerators follow it: the plain version at bkv 128 and 512 differs in
    codes (seed 0, B 4, Hkv 2, G 4, D 64, Smax 1,024, lengths 33 / 300 / 700
    / 1,000, a logit scale of 1e-4).  The reference's docstring calls the
    tile neutral; the port's served decode keeps bkv 512 for it."""
    rng = np.random.default_rng(0)
    b, hkv, g, d, smax = 4, 2, 4, 64, 1024

    def codes(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    q, k, v = codes(b, hkv, g, d), codes(b, smax, hkv, d), codes(b, smax, hkv, d)
    lengths = torch.tensor([33, 300, 700, 1000], dtype=torch.int32)
    scale = 1e-4
    M, sh = fxp.quantize_multiplier(scale / LUT_DELTA)
    scal = (torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
            torch.as_tensor(ref.make_exp_lut_q7()), torch.tensor(np.float32(scale)),
            torch.tensor(np.float32(1.0)))
    a = ref.decode_qattention_ref(q, k, v, lengths, *scal, 128)
    c = ref.decode_qattention_ref(q, k, v, lengths, *scal, 512)
    assert int((a != c).sum()) > 0
