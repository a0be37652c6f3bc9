"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same device and inputs: equal arrays.  Imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test that needs the card takes the ``cuda`` fixture, which skips when
no card is present; the tests without it check what runs anywhere: the
wrappers' CPU side (plain version, no launch counted), the backend choice
and the refusals (other devices, no ``nvcc``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import qlayernorm as qln
from repro_torch.core import qsoftmax as qs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import (
    decode_qattention,
    paged_decode_qattention,
    paged_decode_qattention_q4,
)
from repro_torch.kernels.flash_qattention import flash_qattention, flash_qdecode
from repro_torch.kernels.int4_matmul import (
    BITSPLIT_MAX_K,
    WAVE,
    int4_matmul,
    int8_bitsplit_matmul,
    plan,
)
from repro_torch.kernels.prefill_attention import (
    paged_prefill_qattention,
    paged_prefill_qattention_q4,
)
from repro_torch.kernels.quant_layernorm import quant_layernorm
from repro_torch.kernels.quant_softmax import quant_softmax
from repro_torch.launch.mesh import TPMesh
from repro_torch.launch.serve import calibrated_folded
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.serve.engine import Engine, EngineConfig, LockstepEngine, Request

ENGINE_KERNELS = (int4_matmul, quant_layernorm, paged_prefill_qattention,
                  paged_decode_qattention)
KERNELS = ENGINE_KERNELS + (quant_softmax, int8_bitsplit_matmul)
LAYOUT_KERNELS = (paged_decode_qattention_q4, paged_prefill_qattention_q4, decode_qattention)
FLASH_KERNELS = (flash_qattention, flash_qdecode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")


def _mm(m, k, n, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    codes = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
    bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(np.int32))
    M, sh = fxp.quantize_multiplier(0.00071 * 128 / np.sqrt(k))
    return (x.to(device), packing.pack_int4_planar(codes, axis=0).to(device),
            bias.to(device), M, sh)


def _mm8(m, k, n, seed, device, lo=-128):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(lo, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(lo, 128, (k, n)).astype(np.int8))
    bias = torch.from_numpy(rng.integers(-50_000, 50_000, (n,)).astype(np.int32))
    M, sh = fxp.quantize_multiplier(0.0071 / np.sqrt(k))
    return x.to(device), w.to(device), bias.to(device), M, sh


def _softmax(r, s, seed, device):
    """int32 logit codes with masked tails (2^30 below) on every third row
    and row 0 wholly masked, the q8 table and its index multiplier."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-400_000, 400_000, (r, s)).astype(np.int32)
    x[::3, (2 * s) // 3:] -= qs.MASK_OFFSET
    x[0] -= qs.MASK_OFFSET
    M, sh = fxp.quantize_multiplier(1.0 / (rng.uniform(20, 60) * qs.LUT_DELTA))
    lut = torch.as_tensor(qs.make_exp_lut(), dtype=torch.int32)
    return torch.from_numpy(x).to(device), M, sh, lut.to(device)


def _ln(r, n, seed, subtract_mean, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (r, n)).astype(np.int8)
    x[0] = 5                                  # zero-variance row (eps)
    x[1, ::2], x[1, 1::2] = 127, -127         # largest variance
    gamma = rng.integers(-127, 128, n).astype(np.int8)
    beta = (rng.integers(-(2**20), 2**20, n) if subtract_mean else np.zeros(n)).astype(np.int32)
    M, sh = fxp.quantize_multiplier(0.0021)
    p = qln.QLNParams(torch.from_numpy(gamma).to(device), torch.from_numpy(beta).to(device),
                      torch.tensor(M, dtype=torch.int32, device=device),
                      torch.tensor(sh, dtype=torch.int32, device=device), subtract_mean)
    return torch.from_numpy(x).to(device), p


def _attn_common(rng, n_pages, psize, hkv, d, device):
    kp = rng.integers(-127, 128, (n_pages, psize, hkv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (n_pages, psize, hkv, d)).astype(np.int8)
    s_logit = 1.0 / (rng.uniform(0.02, 0.08) * np.sqrt(d))
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * qs.LUT_DELTA))
    lut = torch.from_numpy(ref.make_exp_lut_q7()).to(device)
    scal = (torch.tensor(M, dtype=torch.int32, device=device),
            torch.tensor(sh, dtype=torch.int32, device=device), lut,
            torch.tensor(np.float32(1.0 / s_logit), device=device),
            torch.tensor(np.float32(rng.uniform(0.5, 2.0)), device=device))
    return torch.from_numpy(kp).to(device), torch.from_numpy(vp).to(device), scal


def _btab(rng, rows, nb, n_pages, psize):
    """Per-slot chains of distinct pages; entries past a chain stay 0 (trash)."""
    perm = iter(rng.permutation(np.arange(1, n_pages)))
    btab = np.zeros((len(rows), nb), np.int32)
    for b, ln in enumerate(rows):
        for i in range(-(-int(ln) // psize)):
            btab[b, i] = next(perm)
    return btab


def _decode(g, d, psize, lengths, device, hkv=4, seed=2):
    rng = np.random.default_rng(seed)
    nb = -(-max(lengths) // psize) + 1
    n_pages = len(lengths) * nb + 1
    kp, vp, scal = _attn_common(rng, n_pages, psize, hkv, d, device)
    q = torch.from_numpy(rng.integers(-127, 128, (len(lengths), hkv, g, d)).astype(np.int8))
    btab = torch.from_numpy(_btab(rng, lengths, nb, n_pages, psize))
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (q.to(device), kp, vp, btab.to(device), lens.to(device), *scal)


def _prefill(h, hkv, d, psize, sq, pos0, device, seed=4):
    rng = np.random.default_rng(seed)
    nb = -(-(max(pos0) + sq) // psize) + 1
    n_pages = len(pos0) * nb + 1
    kp, vp, scal = _attn_common(rng, n_pages, psize, hkv, d, device)
    q = torch.from_numpy(rng.integers(-127, 128, (len(pos0), h, sq, d)).astype(np.int8))
    btab = torch.from_numpy(_btab(rng, [p + sq for p in pos0], nb, n_pages, psize))
    p0 = torch.tensor(pos0, dtype=torch.int32)
    return (q.to(device), kp, vp, btab.to(device), p0.to(device), *scal)


def _pack(rng, pool, scale_max=127 / 7, fill=None):
    """A packed pool like ``pool`` (n_pages, P, Hkv, D) int8 -> uint8
    (n_pages, P, Hkv, D/2) of random bytes (every nibble code), or all
    ``fill`` bytes, and fp32 page scales; page 0, the trash page, keeps the
    all-zero page's scale 1/7."""
    n_pages, psize, hkv, d = pool.shape
    shape = (n_pages, psize, hkv, d // 2)
    packed = np.full(shape, fill, np.uint8) if fill is not None else \
        rng.integers(0, 256, shape).astype(np.uint8)
    scales = rng.uniform(1 / 7, scale_max, n_pages).astype(np.float32)
    scales[0] = np.float32(1) / np.float32(7)
    return torch.from_numpy(packed).to(pool.device), torch.from_numpy(scales).to(pool.device)


def _decode_q4(g, d, psize, lengths, device, hkv=4, seed=2, fill=None):
    q, kp, vp, btab, lens, *scal = _decode(g, d, psize, lengths, device, hkv, seed)
    rng = np.random.default_rng(seed + 1)
    (kq, ks), (vq, vs) = _pack(rng, kp, fill=fill), _pack(rng, vp, fill=fill)
    return (q, kq, vq, ks, vs, btab, lens, *scal)


def _prefill_q4(h, hkv, d, psize, sq, pos0, device, seed=4, fill=None):
    q, kp, vp, btab, p0, *scal = _prefill(h, hkv, d, psize, sq, pos0, device, seed)
    rng = np.random.default_rng(seed + 1)
    (kq, ks), (vq, vs) = _pack(rng, kp, fill=fill), _pack(rng, vp, fill=fill)
    return (q, kq, vq, ks, vs, btab, p0, *scal)


def _stripe(g, d, smax, lengths, device, hkv=4, seed=6):
    rng = np.random.default_rng(seed)
    kp, vp, scal = _attn_common(rng, len(lengths), smax, hkv, d, device)  # (B, Smax, Hkv, D)
    q = torch.from_numpy(rng.integers(-127, 128, (len(lengths), hkv, g, d)).astype(np.int8))
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (q.to(device), kp, vp, lens.to(device), *scal)


def _flash(b, h, hkv, sq, skv, d, device, seed=8, strided=False):
    """q (B, H, Sq, D), k/v (B, Hkv, Skv, D) int8 and the scalars; with
    ``strided`` the three are (B, S, H, D) tensors seen transposed, as the
    serving forward hands them over."""
    rng = np.random.default_rng(seed)
    _, _, scal = _attn_common(rng, 1, 1, 1, d, device)
    shapes = [(b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)]
    ts = []
    for shp in shapes:
        a = rng.integers(-127, 128, shp).astype(np.int8)
        t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)) if strided else a)
        t = t.to(device)
        ts.append(t.transpose(1, 2) if strided else t)
    return (*ts, *scal)


def _qdecode(g, d, smax, cache_len, device, hkv=4, seed=10):
    rng = np.random.default_rng(seed)
    _, _, scal = _attn_common(rng, 1, 1, 1, d, device)
    q, k, v = (torch.from_numpy(rng.integers(-127, 128, shp).astype(np.int8)).to(device)
               for shp in ((hkv, g, d), (hkv, smax, d), (hkv, smax, d)))
    return (q, k, v, cache_len, *scal)


def _launched_once(fn, *args, **kw):
    n0 = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    return out


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = [k.launches for k in KERNELS]
    args = _mm(5, 128, 96, 1, "cpu")
    assert torch.equal(int4_matmul(*args), ref.int4_matmul_ref(*args))
    x, p = _ln(4, 256, 1, False, "cpu")
    assert torch.equal(quant_layernorm(x, p), ref.quant_layernorm_ref(x, p))
    args = _decode(4, 32, 8, [3, 20], "cpu", hkv=2)
    assert torch.equal(paged_decode_qattention(*args), ref.paged_decode_qattention_ref(*args))
    args = _prefill(4, 2, 32, 8, 16, [0, 5], "cpu")
    assert torch.equal(paged_prefill_qattention(*args), ref.paged_prefill_qattention_ref(*args))
    args = _softmax(5, 77, 1, "cpu")
    assert torch.equal(quant_softmax(*args), ref.quant_softmax_ref(*args))
    args = _mm8(5, 128, 96, 1, "cpu")
    assert torch.equal(int8_bitsplit_matmul(*args), ref.int8_bitsplit_matmul_ref(*args))
    assert [k.launches for k in KERNELS] == before


def test_cpu_tensors_take_the_plain_version_for_the_layout_kernels():
    before = [k.launches for k in LAYOUT_KERNELS]
    args = _decode_q4(4, 32, 8, [3, 20], "cpu", hkv=2)
    assert torch.equal(paged_decode_qattention_q4(*args),
                       ref.paged_decode_qattention_q4_ref(*args))
    args = _prefill_q4(4, 2, 32, 8, 16, [0, 5], "cpu")
    assert torch.equal(paged_prefill_qattention_q4(*args),
                       ref.paged_prefill_qattention_q4_ref(*args))
    args = _stripe(4, 32, 48, [3, 48], "cpu", hkv=2)
    assert torch.equal(decode_qattention(*args, bkv=16), ref.decode_qattention_ref(*args, 16))
    assert [k.launches for k in LAYOUT_KERNELS] == before


@pytest.mark.parametrize("group,units,sms,want", [
    (8, 32, 132, 1),      # a 128-row chunk of yi-6b (8 row tiles x 4 kv heads)
    (8, 128, 132, 4),     # a 512-row chunk
    (8, 176, 132, 4),     # a 704-row chunk
    (16, 40, 132, 4),     # G = 16: at most 4 heads a block
    (6, 10, 132, 3),      # odd divisors stop the halving
    (1, 4, 132, 1),
])
def test_heads_per_block_fills_the_sms(group, units, sms, want):
    from repro_torch.kernels.prefill_attention import heads_per_block

    gh = heads_per_block(group, units, sms)
    assert gh == want and group % gh == 0 and gh <= 4


def test_cpu_tensors_take_the_plain_version_for_the_flash_kernels():
    from repro_torch.kernels.flash_qattention import flash_qattention_torch

    before = [k.launches for k in FLASH_KERNELS]
    args = _flash(2, 4, 2, 24, 40, 32, "cpu", strided=True)
    assert torch.equal(flash_qattention(*args, q_offset=16, bkv=20),
                       flash_qattention_torch(*args, q_offset=16, bkv=20))
    args = _qdecode(4, 32, 48, 30, "cpu", hkv=2)
    assert torch.equal(flash_qdecode(*args, bkv=16), ref.flash_qdecode_ref(*args, bkv=16))
    assert [k.launches for k in FLASH_KERNELS] == before


def test_backend_follows_the_device_unless_overridden(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    assert (ops.backend(device="cuda"), ops.backend(device="cpu")) == ("gpu", "ref")
    assert ops.backend("ref", device="cuda") == "ref"
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert ops.backend(device="cpu") == "gpu"


def test_missing_nvcc_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_wrappers_refuse_other_devices():
    x, w, b, M, sh = _mm(4, 64, 8, 1, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int4_matmul(x, w, b, M, sh)
    with pytest.raises(ValueError, match="unsupported device"):
        quant_layernorm(*_ln(2, 64, 1, False, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        quant_softmax(*_softmax(2, 8, 1, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        int8_bitsplit_matmul(*_mm8(4, 64, 8, 1, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        decode_qattention(*_stripe(4, 32, 16, [3], "meta", hkv=1), bkv=16)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_qattention(*_flash(1, 2, 1, 8, 8, 32, "meta"), bkv=8)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_qdecode(*_qdecode(4, 32, 16, 3, "meta", hkv=1), bkv=16)


# (K, N) of the served linears: yi-6b's wq/wo, wk/wv, wg/wu, wd and
# BERT-base's attention projections, w1, w2
YI6B_GEMMS = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096)]
BERT_GEMMS = [(768, 768), (768, 3072), (3072, 768)]
# M on the served paths: a decode tick (8), prefill chunks and the
# cache-less forward (32-704 one-shot, up to 256 chunked, 512 and 2048),
# BERT at (1, 128) and (8, 512)
SERVED_GEMMS = ([(m, k, n) for m in (8, 32, 128, 256, 512, 704, 2048) for k, n in YI6B_GEMMS]
                + [(m, k, n) for m in (128, 4096) for k, n in BERT_GEMMS])
# ragged M on both sides of the decode/tensor-core boundary, N not a
# multiple of 16 (4-byte weight copies), K that ends in half a stage
RAGGED_GEMMS = [(1, 128, 12), (5, 256, 100), (9, 4096, 4096), (16, 4096, 4096),
                (17, 256, 100), (37, 4160, 12), (130, 4096, 100)]


def _launched_once_on(fn, path, *args):
    """One launch, counted on the path ``plan`` chose."""
    n0 = fn.path_launches[path]
    out = _launched_once(fn, *args)
    assert fn.path_launches[path] == n0 + 1
    return out


@pytest.mark.parametrize("m,k,n", SERVED_GEMMS)
@pytest.mark.parametrize("w_bits", [4, 8])
def test_plan_takes_the_tensor_cores_or_the_decode_path_and_fills_a_wave(w_bits, m, k, n):
    """Every served GEMM shape: the decode path at M <= 8, the tensor-core
    path above, 16-byte weight copies, K split into no more slices than it
    has stages (steps), and a grid of at least 90 % of the 132 SMs."""
    p = plan(m, k, n, w_bits)
    assert p.path == ("decode" if m <= 8 else "tensor_core")
    assert p.vec == 16
    rows = k // 2 if w_bits == 4 else k
    if p.path == "decode":
        assert (p.bm, p.bn) == (8, 128) and 1 <= p.split <= rows // 32
        assert p.blocks == -(-n // 128) * p.split
    else:
        assert (p.bm, p.bn) in [(128, 128), (64, 128), (64, 64)]
        assert 1 <= p.split <= -(-k // 128)
        assert p.blocks == -(-m // p.bm) * -(-n // p.bn) * p.split
    assert p.blocks >= WAVE


def test_plan_copies_four_bytes_where_n_is_ragged():
    assert [plan(m, k, n).vec for m, k, n in RAGGED_GEMMS] == [4, 4, 16, 16, 4, 4, 4]
    assert [plan(m, k, n).path for m, k, n in RAGGED_GEMMS] == \
        ["decode"] * 2 + ["tensor_core"] * 5


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 512), (8, 11008, 4096), (37, 256, 96),
                                   (130, 4096, 11008)] + RAGGED_GEMMS
                         + [(m, k, n) for m in (8, 128, 512) for k, n in YI6B_GEMMS + BERT_GEMMS
                            if (m, k, n) not in [(8, 4096, 512), (8, 11008, 4096)]])
def test_int4_matmul_kernel_equals_plain(cuda, m, k, n):
    args = _mm(m, k, n, 3, cuda)
    assert torch.equal(_launched_once_on(int4_matmul, plan(m, k, n).path, *args),
                       ref.int4_matmul_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 17])
def test_int4_matmul_holds_its_extreme_codes(cuda, m):
    """x = -128 against w = -8 at K = 2^20: every partial sum grows to
    2^30 on the decode path (M = 8) and the tensor-core path (M = 17) alike
    and the requantize saturates; equal to the plain version."""
    k, n = 1 << 20, 8
    x = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
    w = torch.full((k // 2, n), 0x88, dtype=torch.uint8, device=cuda)   # both nibbles -8
    b = torch.zeros(n, dtype=torch.int32, device=cuda)
    args = (x, w, b, 16384, 30)
    out = _launched_once_on(int4_matmul, plan(m, k, n).path, *args)
    assert torch.equal(out, ref.int4_matmul_ref(*args))
    assert bool((out == 127).all())


@pytest.mark.cuda
def test_int4_matmul_rejects_unsupported_shapes(cuda):
    x, w, b, M, sh = _mm(4, 96, 64, 1, cuda)        # K/2 = 48 is no multiple of 32
    with pytest.raises(ValueError):
        int4_matmul(x, w, b, M, sh)


@pytest.mark.cuda
@pytest.mark.parametrize("subtract_mean", [True, False])
@pytest.mark.parametrize("r,n", [(33, 4096), (8, 128), (5, 100), (9, 1000), (3, 16384),
                                 (1, 4096), (4096, 768), (704, 4096), (2, 1)])
def test_quant_layernorm_kernel_equals_plain(cuda, subtract_mean, r, n):
    """yi-6b's and BERT's rows, N not a multiple of 16 (byte-wise chunks),
    the widest row (four chunks a thread), one row (the largest variance),
    one code."""
    x, p = _ln(max(r, 2), n, 5, subtract_mean, cuda)
    x = x[1:] if r == 1 else x
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


def _offset_rows(x, offset):
    """x's values in a contiguous tensor whose base lies ``offset`` elements
    into a larger buffer (an unaligned base, as an offset row slice has)."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("subtract_mean", [True, False])
@pytest.mark.parametrize("n,offset", [(100, 0), (4096, 3), (768, 8)])
def test_quant_layernorm_kernel_reads_an_unaligned_base(cuda, subtract_mean, n, offset):
    """An offset row slice (x[1:] of 100-code rows) and buffers offset by a
    few bytes take the byte-wise chunks of the same kernel."""
    x, p = _ln(9, n, 6, subtract_mean, cuda)
    x = x[1:] if offset == 0 else _offset_rows(x, offset)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("subtract_mean", [True, False])
@pytest.mark.parametrize("params", ["served", "wide_beta", "small_shift"])
def test_quant_layernorm_kernel_holds_extreme_rows(cuda, subtract_mean, params):
    """Rows of all -128, all 127 and one constant (zero variance) beside
    seeded ones; ``wide_beta``: beta at the int32 extremes and a large M,
    ``small_shift``: an output shift of 19, both outside the merged clamp,
    where the warps take the reference's wrapping rescale."""
    x, p = _ln(16, 4096, 7, subtract_mean, cuda)
    x[2], x[3], x[4] = -128, 127, -7
    if params == "wide_beta":
        rng = np.random.default_rng(8)
        beta = torch.from_numpy(rng.integers(-2**31, 2**31, 4096).astype(np.int32))
        p = qln.QLNParams(p.gamma_i, beta.to(cuda), torch.tensor(30000, dtype=torch.int32,
                          device=cuda), torch.tensor(24, dtype=torch.int32, device=cuda),
                          subtract_mean)
    elif params == "small_shift":
        M, sh = fxp.quantize_multiplier(0.05)
        p = qln.QLNParams(p.gamma_i, p.beta_aligned, torch.tensor(M, dtype=torch.int32,
                          device=cuda), torch.tensor(sh, dtype=torch.int32, device=cuda),
                          subtract_mean)
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,psize,lengths", [(8, 128, 16, [1, 100, 730, 0]),
                                               (4, 32, 8, [5, 17, 40])])
def test_paged_decode_kernel_equals_plain(cuda, g, d, psize, lengths):
    args = _decode(g, d, psize, lengths, cuda)
    assert torch.equal(_launched_once(paged_decode_qattention, *args),
                       ref.paged_decode_qattention_ref(*args))


# the paged chunked prefill (csrc/paged_prefill.cuh): (h, hkv, d, psize, sq, pos0)
PREFILL_CASES = [
    (32, 4, 128, 16, 128, [0, 256]),
    (8, 2, 32, 8, 77, [3, 0]),
    (32, 4, 128, 16, 704, [0]),          # yi-6b's longest one-shot prompt
    (32, 4, 128, 16, 16, [1008]),        # the last chunk on a 1,024-row chain
    (32, 4, 128, 16, 128, [256]),        # a 128-row chunk
    (32, 4, 128, 16, 64, [37, 0]),       # two slots, one unaligned
    (4, 4, 64, 16, 50, [10]),            # G = 1
    (32, 2, 128, 16, 100, [30]),         # G = 16
    (8, 2, 32, 16, 40, [5]),             # D = 32
    (8, 2, 64, 16, 40, [5]),             # D = 64
    (8, 2, 48, 16, 33, [7]),             # D = 48, a half-empty k step
    (8, 2, 128, 8, 70, [9]),             # P = 8
    (8, 2, 128, 64, 70, [100]),          # P = 64
    (8, 2, 64, 32, 45, [20, 3]),         # P = 32
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,psize,sq,pos0", PREFILL_CASES)
def test_paged_prefill_kernel_equals_plain(cuda, h, hkv, d, psize, sq, pos0):
    args = _prefill(h, hkv, d, psize, sq, pos0, cuda)
    assert torch.equal(_launched_once(paged_prefill_qattention, *args),
                       ref.paged_prefill_qattention_ref(*args))


def _real_scalars(d, device):
    """chip_smoke's attention scalars: random codes give logits of about
    +-2, so numerators spread over the LUT and f over (0, 1)."""
    s_logit = np.sqrt(d) * 73.0 * 73.0 / 2.0
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * qs.LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32, device=device),
            torch.tensor(sh, dtype=torch.int32, device=device),
            torch.from_numpy(ref.make_exp_lut_q7()).to(device),
            torch.tensor(np.float32(1.0 / s_logit), device=device),
            torch.tensor(np.float32(1.1), device=device))


def _prefill_rising(kind, device, quiet=20):
    """A 128-row chunk at pos0 = 256 on yi-6b's heads whose keys are small
    on the first ``quiet`` pages of the chain and full width after: each
    row's running max rises at page ``quiet``, inside the chunk's own pages
    (16-23), with f strictly between 0 and 1."""
    h, hkv, d, psize, sq, pos0 = 32, 4, 128, 16, 128, [256]
    if kind == "int8":
        q, kp, vp, btab, p0, *_ = _prefill(h, hkv, d, psize, sq, pos0, device)
        early = btab[0, :quiet].long()
        kp = kp.clone()
        kp[early] = torch.div(kp[early], 6, rounding_mode="trunc")
        return (q, kp, vp, btab, p0, *_real_scalars(d, device))
    q, kq, vq, ks, vs, btab, p0, *_ = _prefill_q4(h, hkv, d, psize, sq, pos0, device)
    early = btab[0, :quiet].long()
    ks = ks.clone()
    ks[early] = float(np.float32(2 / 7))
    ks[btab[0, quiet:].long()] = float(np.float32(127 / 7))
    return (q, kq, vq, ks, vs, btab, p0, *_real_scalars(d, device))


def _prefill_pair(kind):
    return (paged_prefill_qattention, ref.paged_prefill_qattention_ref) if kind == "int8" \
        else (paged_prefill_qattention_q4, ref.paged_prefill_qattention_q4_ref)


def _prefill_args(kind, case, device):
    h, hkv, d, psize, sq, pos0 = case
    return _prefill(h, hkv, d, psize, sq, pos0, device) if kind == "int8" else \
        _prefill_q4(h, hkv, d, psize, sq, pos0, device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_holds_a_max_that_rises_mid_chunk(cuda, kind):
    fn, plain = _prefill_pair(kind)
    args = _prefill_rising(kind, cuda)
    want = plain(*args)
    assert torch.equal(_launched_once(fn, *args), want)
    assert int((want != 0).sum()) > want.numel() // 2     # not a one-hot softmax


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_back_to_back_calls_leave_no_state(cuda, kind):
    """A 704-row prompt, a 16-row G = 16 chunk with 64-row pages, then the
    prompt again, launched back to back: each equals its plain version."""
    fn, plain = _prefill_pair(kind)
    long_args = _prefill_args(kind, (32, 4, 128, 16, 704, [0]), cuda)
    short_args = _prefill_args(kind, (32, 2, 64, 64, 16, [200]), cuda)
    outs = [fn(*a) for a in (long_args, short_args, long_args)]
    torch.cuda.synchronize()
    for out, a in zip(outs, (long_args, short_args, long_args)):
        assert torch.equal(out, plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_any_heads_per_block_gives_the_same_codes(cuda, kind, monkeypatch):
    from repro_torch.kernels import prefill_attention as pa

    fn, plain = _prefill_pair(kind)
    args = _prefill_args(kind, (32, 4, 128, 16, 80, [37]), cuda)
    want = plain(*args)
    for gh in (1, 2, 4):
        monkeypatch.setattr(pa, "heads_per_block", lambda *_, gh=gh: gh)
        assert torch.equal(fn(*args), want), gh
    for gh in (3, 8):
        monkeypatch.setattr(pa, "heads_per_block", lambda *_, gh=gh: gh)
        with pytest.raises(ValueError, match="heads_per_block"):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_reads_q_in_place_and_writes_its_layout(cuda, kind):
    """q as the serving forward hands it over, (B, S, H, D) seen as (B, H,
    S, D): the output takes that layout, so turning it back is a view."""
    fn, plain = _prefill_pair(kind)
    q, *rest = _prefill_args(kind, (32, 4, 128, 16, 96, [16, 48]), cuda)
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    out = _launched_once(fn, qv, *rest)
    assert out.stride() == qv.stride() and out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, plain(q, *rest))


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(1536, 128), (3000, 512), (77 * 12, 77), (9, 1), (3, 1500),
                                 (6144, 512), (40, 256), (33, 4), (17, 516)])
def test_quant_softmax_kernel_equals_plain(cuda, r, s):
    """BERT's (B*12*S, S) rows (at (8, 512) cut to 6,144 rows), a ragged S,
    one key, rows longer than the registers hold; every third row masked
    after 2/3 of its keys, row 0 wholly masked too (its tail 2^31 below its
    head, so it wraps and takes the reference's helpers)."""
    args = _softmax(r, s, r + s, cuda)
    assert torch.equal(_launched_once(quant_softmax, *args), ref.quant_softmax_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,offset", [(100, 77, 0), (64, 128, 1), (64, 512, 2)])
def test_quant_softmax_kernel_reads_an_unaligned_base(cuda, r, s, offset):
    """An offset row slice (x[1:] of 77-key rows) and buffers offset by one
    or two codes take the scalar passes of the same kernel."""
    x, M, sh, lut = _softmax(r + 1, s, 11, cuda)
    x = x[1:] if offset == 0 else _offset_rows(x[1:], offset)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = _launched_once(quant_softmax, x, M, sh, lut)
    assert torch.equal(out, ref.quant_softmax_ref(x, M, sh, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 77])
def test_quant_softmax_kernel_holds_wrapping_rows_and_tables(cuda, s):
    """Rows spanning the whole int32 range (m - x wraps), a negative M, and
    a table with negative and large entries (the sums wrap, the division
    floors): every check of the one-pass path fails over to the
    reference's arithmetic."""
    x, M, sh, lut = _softmax(64, s, 12, cuda)
    x[::2, 0] = 2**31 - 1
    x[::2, -1] = -(2**31)
    assert torch.equal(_launched_once(quant_softmax, x, M, sh, lut),
                       ref.quant_softmax_ref(x, M, sh, lut))
    assert torch.equal(_launched_once(quant_softmax, x, -M, sh, lut),
                       ref.quant_softmax_ref(x, -M, sh, lut))
    wild = torch.from_numpy(np.random.default_rng(13).integers(-2**20, 2**28, 256)
                            .astype(np.int32)).to(cuda)
    assert torch.equal(_launched_once(quant_softmax, x, M, sh, wild),
                       ref.quant_softmax_ref(x, M, sh, wild))


@pytest.mark.cuda
def test_quant_softmax_kernel_clamps_an_empty_denominator(cuda):
    """A table that is 0 past a few entries and at index 0 zeroes some
    rows' sums: den clamps to 1 and those probabilities are 0."""
    x, M, sh, lut = _softmax(64, 40, 3, cuda)
    lut = lut.clone()
    lut[0] = 0
    lut[4:] = 0
    out = _launched_once(quant_softmax, x, M, sh, lut)
    assert torch.equal(out, ref.quant_softmax_ref(x, M, sh, lut))
    assert int((out == 0).all(dim=1).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(128, 768, 768), (128, 768, 3072), (128, 3072, 768),
                                   (4096, 768, 3072), (5, 64, 12), (37, 3072, 100)]
                         + RAGGED_GEMMS
                         + [(m, k, n) for m in (8, 512) for k, n in BERT_GEMMS + YI6B_GEMMS]
                         + [(128, k, n) for k, n in YI6B_GEMMS])
def test_int8_bitsplit_matmul_kernel_equals_plain(cuda, m, k, n):
    args = _mm8(m, k, n, 7, cuda)
    assert torch.equal(_launched_once_on(int8_bitsplit_matmul, plan(m, k, n, 8).path, *args),
                       ref.int8_bitsplit_matmul_ref(*args))


@pytest.mark.cuda
def test_int8_bitsplit_matmul_holds_its_k_bound(cuda):
    """At the largest K the kernel takes, all codes -128: every partial sum
    reaches K * 128 * 128 < 2^31 on both sides, and they agree; one K step
    more is refused."""
    k = BITSPLIT_MAX_K // 64 * 64
    x = torch.full((4, k), -128, dtype=torch.int8, device=cuda)
    w = torch.full((k, 8), -128, dtype=torch.int8, device=cuda)
    b = torch.zeros(8, dtype=torch.int32, device=cuda)
    args = (x, w, b, 16384, 30)
    assert torch.equal(_launched_once_on(int8_bitsplit_matmul, plan(4, k, 8, 8).path, *args),
                       ref.int8_bitsplit_matmul_ref(*args))
    with pytest.raises(ValueError, match="K"):
        int8_bitsplit_matmul(torch.zeros((4, k + 64), dtype=torch.int8, device=cuda),
                             torch.zeros((k + 64, 8), dtype=torch.int8, device=cuda), b, 1, 0)


@pytest.mark.cuda
def test_engine_on_card_chunked_equals_oneshot(cuda):
    """The smoke yi-6b through the engine on the card (the gpu backend):
    chunked and one-shot prefill give the same greedy tokens, a shared
    prefix is reused, and every kernel launched."""
    cfg = smoke_config("yi-6b")
    folded = tree_map(lambda t: t.to(cuda), calibrated_folded(cfg, 0, device="cpu"))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 12)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 17)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]) for n in (3, 11)]

    def run(**kw):
        eng = Engine(cfg, folded, EngineConfig(batch_slots=3, max_len=64, page_size=4, **kw))
        reqs = [Request(prompt=p.astype(np.int32), max_new_tokens=6) for p in prompts]
        eng.generate(reqs)
        return [r.out.tolist() for r in reqs], eng.counters

    for k in ENGINE_KERNELS:
        k.launches = 0
    one, c1 = run()
    assert all(k.launches > 0 for k in ENGINE_KERNELS), [k.launches for k in ENGINE_KERNELS]
    chunked, c2 = run(max_prefill_chunk=8, max_batched_tokens=16)
    assert one == chunked
    assert c1["prefix_hits"] >= 1 and c2["chunked_prefills"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["POLICY_FQ", "POLICY_W8A8"])
def test_small_bert_on_card_equals_cpu(cuda, pol):
    """The smoke bert-base under both policies: the cache-less integer
    forward on the card (quant_softmax, the GEMM of the policy, the LN)
    equals the same forward on the CPU, logit for logit."""
    import dataclasses

    from repro_torch.core import policy
    from repro_torch.models import serve_int as S

    cfg = dataclasses.replace(smoke_config("bert-base"), quant=getattr(policy, pol))
    folded = calibrated_folded(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 77)))
    want, _ = S.serve_forward(cfg, folded, toks)
    gemm = int8_bitsplit_matmul if cfg.quant.w_bits == 8 else int4_matmul
    for k in (quant_softmax, gemm, quant_layernorm):
        k.launches = 0
    got, _ = S.serve_forward(cfg, tree_map(lambda t: t.to(cuda), folded), toks.to(cuda))
    assert (quant_softmax.launches, gemm.launches, quant_layernorm.launches) == (2, 12, 5)
    assert torch.equal(got.cpu(), want)


YI_LENGTHS = [33, 100, 250, 400, 520, 640, 700, 1000]     # chip_smoke's decode batch


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,psize,lengths,fill", [
    (8, 128, 16, YI_LENGTHS, None),              # yi-6b, max_len 1024
    (8, 128, 16, [1, 16, 17, 0], None),          # 1 row, on and past a page end, inactive
    (4, 32, 8, [5, 17, 40], 0x88),               # every code -8 (clips at the top scales)
    (4, 64, 64, [64, 3, 1], 0x77),               # every code 7, one 64-row page
])
def test_paged_decode_q4_kernel_equals_plain(cuda, g, d, psize, lengths, fill):
    args = _decode_q4(g, d, psize, lengths, cuda, fill=fill)
    assert torch.equal(_launched_once(paged_decode_qattention_q4, *args),
                       ref.paged_decode_qattention_q4_ref(*args))


# the split paged decode (csrc/paged_decode.cuh): spans of 8 pages, one
# block each; (g, d, psize, lengths, hkv)
SPLIT_CASES = {
    "one_4096_chain": (8, 128, 16, [4096], 4),                  # yi-6b's full context
    "span_edges": (8, 128, 16, [128, 129, 127, 256, 257, 384, 16, 0], 4),
    "g16_d128_p64": (16, 128, 64, [512, 513, 3, 1024], 2),
    "mqa_p32": (1, 64, 32, [31, 32, 33, 600], 2),
}


def _split_args(kind, case, device):
    g, d, psize, lengths, hkv = SPLIT_CASES[case]
    if kind == "int8":
        return _decode(g, d, psize, lengths, device, hkv, seed=len(lengths))
    return _decode_q4(g, d, psize, lengths, device, hkv, seed=len(lengths))


def _split_pair(kind):
    return (paged_decode_qattention, ref.paged_decode_qattention_ref) if kind == "int8" else \
        (paged_decode_qattention_q4, ref.paged_decode_qattention_q4_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_split_paged_decode_equals_plain(cuda, kind, case):
    fn, plain = _split_pair(kind)
    args = _split_args(kind, case, cuda)
    assert torch.equal(_launched_once(fn, *args), plain(*args))


@pytest.mark.cuda
def test_split_paged_decode_int8_takes_d48_and_odd_groups(cuda):
    args = _decode(3, 48, 8, [7, 8, 9, 130], cuda, hkv=2, seed=9)
    assert torch.equal(_launched_once(paged_decode_qattention, *args),
                       ref.paged_decode_qattention_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_split_paged_decode_back_to_back_calls_leave_no_state(cuda, kind):
    """The workspace is per call: a long batch, a short one of
    another size, then the long one again, each equal to its plain version."""
    fn, plain = _split_pair(kind)
    long_args = _split_args(kind, "span_edges", cuda)
    short_args = _split_args(kind, "mqa_p32", cuda)
    outs = [fn(*a) for a in (long_args, short_args, long_args)]
    torch.cuda.synchronize()
    for out, a in zip(outs, (long_args, short_args, long_args)):
        assert torch.equal(out, plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,psize,sq,pos0,fill", [
    (32, 4, 128, 16, 512, [0], None),            # yi-6b one-shot prefill
    (32, 4, 128, 16, 128, [256], None),          # yi-6b chunk
    (8, 2, 32, 8, 77, [3, 0], 0x87),             # unaligned pos0, codes 7 (lo) and -8 (hi)
    (4, 1, 64, 64, 40, [64, 0], None),           # 64-row pages
    (32, 4, 128, 16, 704, [0], None),            # the longest one-shot prompt
    (32, 4, 128, 16, 16, [1008], None),          # the last chunk on a 1,024-row chain
    (32, 4, 128, 16, 64, [37, 0], None),         # two slots, one unaligned
    (4, 4, 64, 16, 50, [10], None),              # G = 1
    (32, 2, 128, 16, 100, [30], None),           # G = 16
    (8, 2, 32, 16, 40, [5], 0x78),               # D = 32, codes -8 (lo) and 7 (hi)
    (8, 2, 64, 16, 40, [5], None),               # D = 64
    (8, 2, 128, 8, 70, [9], None),               # P = 8
    (8, 2, 128, 64, 70, [100], None),            # P = 64
])
def test_paged_prefill_q4_kernel_equals_plain(cuda, h, hkv, d, psize, sq, pos0, fill):
    args = _prefill_q4(h, hkv, d, psize, sq, pos0, cuda, fill=fill)
    assert torch.equal(_launched_once(paged_prefill_qattention_q4, *args),
                       ref.paged_prefill_qattention_q4_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,smax,bkv,lengths", [
    (8, 128, 1024, 512, YI_LENGTHS),             # yi-6b, max_len 1024
    (8, 128, 1024, 512, [1, 512, 513, 1024]),    # 1 row, on and past a block end, full
    (4, 32, 64, 64, [1, 64, 0, 30]),             # the smoke model's stripe, inactive slot
    (16, 64, 96, 48, [47, 48, 49, 96]),          # G 16, a block of 48 (no multiple of 64)
])
def test_contiguous_decode_kernel_equals_plain(cuda, g, d, smax, bkv, lengths):
    args = _stripe(g, d, smax, lengths, cuda)
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=bkv),
                       ref.decode_qattention_ref(*args, bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,smax,bkv,lengths", [
    (8, 128, 4096, 512, [4096]),                 # B = 1 over yi-6b's full context
    (8, 128, 4096, 512, [3000]),
    (16, 128, 592, 296, [295, 296, 297, 592]),   # G 16, D 128, blocks of 296 (18.5 tiles)
    (4, 64, 111, 37, [0, 1, 37, 38, 111]),       # blocks of 37: a 5-row sub-tile each
    (1, 48, 1024, 512, [1000, 17]),              # MQA, D 48, 1,000 rows in 512-row blocks
])
def test_split_contiguous_decode_equals_plain(cuda, g, d, smax, bkv, lengths):
    """The split over sub-tiles of 16 rows: one slot's whole stripe, sub-tiles
    straddling a block end (bkv 296 and 37), lengths 0, 1, on and past a
    block end and full."""
    args = _stripe(g, d, smax, lengths, cuda, seed=len(lengths) + g)
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=bkv),
                       ref.decode_qattention_ref(*args, bkv))


def _rise_per_block(k, q0, lengths, bkv, row_axis):
    """K with the last live row of every live block of slot b set to
    sign(q0[b]) * c, c growing from block to block: each row's running max
    rises in the last sub-tile (key tile) of every block.  ``k`` is indexed
    [b, row] (row_axis 1) or [b, :, row] (row_axis 2)."""
    k = k.clone()
    for b, ln in enumerate(lengths):
        nblk = -(-ln // bkv)
        for j in range(nblk):
            row = min(ln, (j + 1) * bkv) - 1
            top = torch.where(q0[b] >= 0, 1, -1) * (40 + 87 * (j + 1) // nblk)
            if row_axis == 1:
                k[b, row] = top.to(torch.int8)
            else:
                k[b, :, row] = top.to(torch.int8)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,smax,bkv,lengths", [
    (8, 128, 1024, 512, YI_LENGTHS),
    (16, 128, 592, 296, [296, 297, 592, 100]),
    (4, 64, 111, 37, [37, 74, 111, 50]),
])
def test_split_contiguous_decode_holds_a_max_that_rises_in_each_blocks_last_tile(
        cuda, g, d, smax, bkv, lengths):
    q, kc, vc, lens, *_ = _stripe(g, d, smax, lengths, cuda, seed=7)
    kc = _rise_per_block(kc, q[:, :, 0], lengths, bkv, row_axis=1)
    args = (q, kc, vc, lens, *_real_scalars(d, cuda))
    want = ref.decode_qattention_ref(*args, bkv)
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=bkv), want)
    assert int((want != 0).sum()) > want.numel() // 2     # not a one-hot softmax


@pytest.mark.cuda
def test_split_contiguous_decode_back_to_back_calls_leave_no_state(cuda):
    """The workspace is per call: yi-6b's batch, one 4,080-row slot at G 16
    and blocks of 48, then the batch again, each equal to its plain version."""
    long_args = _stripe(8, 128, 1024, YI_LENGTHS, cuda)
    short_args = _stripe(16, 64, 4080, [4000], cuda, hkv=1)
    calls = ((long_args, 512), (short_args, 48), (long_args, 512))
    outs = [decode_qattention(*a, bkv=bkv) for a, bkv in calls]
    torch.cuda.synchronize()
    for out, (a, bkv) in zip(outs, calls):
        assert torch.equal(out, ref.decode_qattention_ref(*a, bkv))


@pytest.mark.cuda
def test_split_contiguous_decode_reads_the_stripe_in_place(cuda):
    """The engine's (Smax, Hkv, D) stripe of one slot seen as (Hkv, Smax, D)
    goes to flash_qdecode through its strides, with decode_qattention's
    codes."""
    q, kc, vc, lens, *scal = _stripe(8, 128, 1024, [700], cuda)
    got = _launched_once(flash_qdecode, q[0], kc[0].transpose(0, 1), vc[0].transpose(0, 1),
                         700, *scal, bkv=512)
    assert torch.equal(got, decode_qattention(q, kc, vc, lens, *scal, bkv=512)[0])


@pytest.mark.cuda
def test_layout_kernels_refuse_unsupported_shapes(cuda):
    args = _stripe(4, 32, 96, [5], cuda, hkv=1)
    with pytest.raises(ValueError, match="bkv"):
        decode_qattention(*args, bkv=40)                  # does not divide Smax
    q, kq, vq, ks, vs, *rest = _decode_q4(4, 32, 8, [5], cuda, hkv=1)
    with pytest.raises(ValueError, match="scale"):
        paged_decode_qattention_q4(q, kq, vq, ks[:-1], vs, *rest)


@pytest.mark.cuda
def test_kv4_and_contiguous_engines_on_card_equal_cpu(cuda, monkeypatch):
    """The smoke yi-6b through the kv4 engine (one-shot and chunked), the
    contiguous engine and the lockstep engine on the card equals the same
    engines on the CPU under REPRO_TORCH_KERNELS=gpu (the plain versions),
    and the card launched the three layout kernels."""
    cfg = smoke_config("yi-6b")
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to(cuda), folded_cpu)}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 17, 12)]

    def serve(dev, **kw):
        eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64, page_size=4,
                                                    **kw))
        return [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]

    def lockstep(dev):
        from repro_torch.serve.engine import LockstepEngine
        eng = LockstepEngine(cfg, folded[dev], EngineConfig(batch_slots=4, max_len=64))
        return [r.out.tolist() for r in eng.generate(
            [Request(prompt=p[:8], max_new_tokens=6) for p in prompts])]

    runs = [lambda d: serve(d, kv_bits=4),
            lambda d: serve(d, kv_bits=4, max_prefill_chunk=8, max_batched_tokens=16),
            lambda d: serve(d, cache_layout="contiguous"), lockstep]
    for k in LAYOUT_KERNELS + (flash_qattention,):
        k.launches = 0
    on_card = [run("cuda") for run in runs]
    assert all(k.launches > 0 for k in LAYOUT_KERNELS), [k.launches for k in LAYOUT_KERNELS]
    assert flash_qattention.launches > 0        # the stripe's one-shot prefills
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert on_card == [run("cpu") for run in runs]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,bkv,q_offset,strided", [
    (1, 32, 4, 512, 512, 128, 512, 0, True),     # yi-6b, the (1, 512) prefill, in place
    (2, 16, 2, 704, 704, 128, 352, 0, True),     # G 8, the 700-token prompt's bucket
    (1, 4, 4, 592, 592, 64, 296, 0, False),      # G 1, bkv 296
    (3, 8, 2, 37, 37, 64, 37, 0, True),          # G 4, an odd block, B 3
    (2, 8, 1, 128, 1024, 128, 128, 896, False),  # G 8, q_offset with Sq < Skv
    (2, 4, 1, 100, 160, 64, 16, 60, False),      # G 4, bkv 16, ragged q tile
    (1, 4, 1, 1024, 1024, 128, 128, 0, False),   # attention_q's default block
])
def test_flash_qattention_kernel_equals_plain(cuda, b, h, hkv, sq, skv, d, bkv, q_offset,
                                              strided):
    from repro_torch.kernels.flash_qattention import flash_qattention_torch

    args = _flash(b, h, hkv, sq, skv, d, cuda, strided=strided)
    got = _launched_once(flash_qattention, *args, q_offset=q_offset, bkv=bkv)
    assert got.stride() == args[0].stride()          # the output takes q's layout
    assert torch.equal(got, flash_qattention_torch(*args, q_offset=q_offset, bkv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,smax,bkv,cache_len", [
    (8, 128, 1024, 512, 1000),       # chip_smoke.py's shapes
    (8, 128, 4096, 512, 3000),
    (8, 128, 1024, 512, 1),          # one key
    (4, 64, 96, 48, 49),             # a block of 48, one row past its end
])
def test_flash_qdecode_kernel_equals_plain(cuda, g, d, smax, bkv, cache_len):
    args = _qdecode(g, d, smax, cache_len, cuda)
    assert torch.equal(_launched_once(flash_qdecode, *args, bkv=bkv),
                       ref.flash_qdecode_ref(*args, bkv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,smax,bkv,cache_len", [
    (8, 128, 4096, 512, 3000),
    (16, 128, 592, 296, 297),        # G 16, one row past a 296-row block
    (4, 64, 111, 37, 111),           # blocks of 37, full
])
def test_flash_qdecode_holds_a_max_that_rises_in_each_blocks_last_tile(cuda, g, d, smax, bkv,
                                                                       cache_len):
    q, k, v, n, *_ = _qdecode(g, d, smax, cache_len, cuda)
    k = _rise_per_block(k.transpose(0, 1)[None], q[None, :, 0], [cache_len], bkv,
                        row_axis=1)[0].transpose(0, 1).contiguous()
    args = (q, k, v, n, *_real_scalars(d, cuda))
    want = ref.flash_qdecode_ref(*args, bkv=bkv)
    assert torch.equal(_launched_once(flash_qdecode, *args, bkv=bkv), want)
    assert int((want != 0).sum()) > want.numel() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,bkv,q_offset", [
    (1, 32, 4, 512, 512, 128, 128, 0),           # yi-6b heads, four 128-key blocks
    (2, 16, 1, 592, 592, 128, 296, 0),           # G 16, blocks of 296
    (1, 8, 2, 111, 111, 64, 37, 0),              # blocks of 37, a ragged q tile
    (1, 8, 2, 100, 1024, 128, 512, 924),         # q_offset, Sq = 100 < Skv
])
def test_flash_qattention_holds_a_max_that_rises_in_each_blocks_last_tile(
        cuda, b, h, hkv, sq, skv, d, bkv, q_offset):
    from repro_torch.kernels.flash_qattention import flash_qattention_torch

    q, k, v, *_ = _flash(b, h, hkv, sq, skv, d, cuda)
    k = _rise_per_block(k, q[:, ::h // hkv, 0], [skv] * b, bkv, row_axis=2)
    args = (q, k, v, *_real_scalars(d, cuda))
    want = flash_qattention_torch(*args, q_offset=q_offset, bkv=bkv)
    assert torch.equal(_launched_once(flash_qattention, *args, q_offset=q_offset, bkv=bkv),
                       want)
    assert int((want != 0).sum()) > want.numel() // 2


@pytest.mark.cuda
def test_flash_qattention_back_to_back_calls_leave_no_state(cuda):
    from repro_torch.kernels.flash_qattention import flash_qattention_torch

    calls = [(_flash(1, 32, 4, 704, 704, 128, cuda, strided=True), 352, 0),
             (_flash(3, 8, 2, 37, 37, 64, cuda), 37, 0),
             (_flash(2, 8, 1, 128, 1024, 128, cuda), 128, 896)]
    calls.append(calls[0])
    outs = [flash_qattention(*a, q_offset=o, bkv=bkv) for a, bkv, o in calls]
    torch.cuda.synchronize()
    for out, (a, bkv, o) in zip(outs, calls):
        assert torch.equal(out, flash_qattention_torch(*a, q_offset=o, bkv=bkv))


@pytest.mark.cuda
def test_flash_qattention_any_heads_per_block_gives_the_same_codes(cuda, monkeypatch):
    from repro_torch.kernels import flash_qattention as fa

    args = _flash(1, 32, 4, 80, 80, 128, cuda, strided=True)
    want = fa.flash_qattention_torch(*args, q_offset=0, bkv=40)
    for gh in (1, 2, 4):
        monkeypatch.setattr(fa, "heads_per_block", lambda *_, gh=gh: gh)
        assert torch.equal(fa.flash_qattention(*args, q_offset=0, bkv=40), want), gh
    for gh in (3, 8):
        monkeypatch.setattr(fa, "heads_per_block", lambda *_, gh=gh: gh)
        with pytest.raises(ValueError, match="heads_per_block"):
            fa.flash_qattention(*args, q_offset=0, bkv=40)


def _sass_functions(name):
    """A built kernel library's SASS, function by function (``cuobjdump``
    beside ``nvcc``)."""
    import os
    import re
    import subprocess

    path = _build.build_all()[name]
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    return dict(chunk.split("\n", 1) for chunk in re.split(r"\n\s*Function : ", sass)[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("name,products", [
    ("decode_attention", ("stripe_scores_kernel", "stripe_pv_kernel")),
    ("flash_qdecode", ("stripe_scores_kernel", "stripe_pv_kernel")),
    ("flash_qattention", ("flash_kernel",)),
])
def test_stripe_and_flash_products_run_on_the_tensor_cores(cuda, name, products):
    """QK^T and P.V of the stripe decode and the flash prefill are IMMA
    (mma.sync) in every kernel that computes them; no IDP (__dp4a) and no
    serial stripe kernel is left."""
    import re

    funcs = _sass_functions(name)
    assert not any("stripe_decode_kernel" in f for f in funcs)
    assert not any(re.search(r"\bIDP\b", body) for body in funcs.values())
    for kernel in products:
        bodies = [body for f, body in funcs.items() if kernel in f]
        assert bodies and all(re.search(r"\bIMMA\b", body) for body in bodies), kernel


@pytest.mark.cuda
def test_flash_kernels_refuse_unsupported_shapes(cuda):
    args = _flash(1, 4, 2, 32, 96, 64, cuda)
    with pytest.raises(ValueError, match="bkv"):
        flash_qattention(*args, bkv=40)                  # does not divide Skv
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_qattention(*_flash(1, 3, 2, 32, 32, 64, cuda), bkv=32)
    with pytest.raises(ValueError, match="D % 16"):
        flash_qattention(*_flash(1, 2, 1, 8, 8, 40, cuda), bkv=8)
    with pytest.raises(ValueError, match="q_offset"):
        flash_qattention(*args, q_offset=-1, bkv=32)
    with pytest.raises(ValueError, match="G <= 16"):
        flash_qdecode(*_qdecode(32, 64, 64, 5, cuda, hkv=1), bkv=64)
    with pytest.raises(ValueError, match="bkv"):
        flash_qdecode(*_qdecode(4, 64, 96, 5, cuda, hkv=1), bkv=64)


@pytest.mark.cuda
def test_cacheless_prefill_on_card_equals_cpu(cuda, monkeypatch):
    """The smoke yi-6b's cache-less causal prefill at (2, 37) and (1, 80)
    through flash_qattention on the card (2 launches per forward, one per
    layer, and no plain flash on a CUDA tensor) equals the CPU's plain
    versions logit for logit."""
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.models import serve_int as S

    cfg = smoke_config("yi-6b")
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = tree_map(lambda t: t.to(cuda), folded_cpu)
    plain = fa.flash_qattention_torch
    on_card = []

    def guard(q, *a, **kw):
        on_card.append(q.is_cuda)
        return plain(q, *a, **kw)

    monkeypatch.setattr(fa, "flash_qattention_torch", guard)
    monkeypatch.setattr(ops, "flash_qattention_torch", guard)
    rng = np.random.default_rng(3)
    for shape in ((2, 37), (1, 80)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
        n0 = flash_qattention.launches
        got, _ = S.serve_forward(cfg, folded, toks.to(cuda))
        torch.cuda.synchronize()
        assert flash_qattention.launches - n0 == cfg.n_layers
        monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
        want, _ = S.serve_forward(cfg, folded_cpu, toks)
        monkeypatch.delenv("REPRO_TORCH_KERNELS")
        assert torch.equal(got.cpu(), want)
    assert on_card.count(True) == 0 and on_card.count(False) >= 2


# --- the speculative verify forward ------------------------------------------------

VERIFY_CASES = [
    (32, 4, 128, 16, 4, [33, 100, 250, 400, 520, 640, 700, 1000]),   # yi-6b, spec_k = 3
    (32, 4, 128, 16, 9, [7, 1014]),                                  # spec_k = 8, a chain's end
    (8, 2, 32, 4, 4, [5, 33, 0, 18]),                                # the smoke model's pages
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,psize,sq,pos0", VERIFY_CASES)
def test_paged_prefill_at_the_verify_shape_equals_plain_and_decode(cuda, h, hkv, d, psize, sq,
                                                                   pos0):
    """Row 3 at S = spec_k + 1 rows and a ragged, unaligned per-slot pos0:
    equal to its plain version, and row i equal to the paged decode kernel
    (row 4) at length pos0 + i + 1 (the identity speculative decoding on
    the card leans on)."""
    q, kp, vp, btab, p0, *scal = _prefill(h, hkv, d, psize, sq, pos0, cuda)
    out = _launched_once(paged_prefill_qattention, q, kp, vp, btab, p0, *scal)
    assert torch.equal(out, ref.paged_prefill_qattention_ref(q, kp, vp, btab, p0, *scal))
    b = len(pos0)
    for i in range(sq):
        qd = q[:, :, i].reshape(b, hkv, h // hkv, d)
        dec = paged_decode_qattention(qd, kp, vp, btab, p0 + i + 1, *scal)
        assert torch.equal(dec.reshape(b, h, d), out[:, :, i]), i


def _smoke_folded(device):
    cfg = smoke_config("yi-6b")
    return cfg, tree_map(lambda t: t.to(device), calibrated_folded(cfg, 0, device="cpu"))


@pytest.mark.cuda
def test_verify_forward_on_card_equals_cpu(cuda, monkeypatch):
    """The smoke yi-6b's verify forward (two slots at cursors 21 and 14, 4
    and 2 real rows, after a prefill of their prompts) on the card equals
    the gpu backend's control flow on the CPU, logit for logit on the real
    rows, and updates the pool the same way."""
    from repro_torch.models import serve_int as S

    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    rng = np.random.default_rng(6)
    cfg = smoke_config("yi-6b")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32))
    btab = torch.tensor([[3, 5, 1, 8, 0, 0, 0, 0], [2, 7, 4, 6, 0, 0, 0, 0]], dtype=torch.int32)
    out = []
    for dev in ("cpu", cuda):
        _, folded = _smoke_folded(dev)
        cache = S.init_paged_cache(cfg, 9, 8, device=dev)
        S.serve_forward(cfg, folded, prompt.to(dev), cache=cache, pos_offset=0,
                        block_tables=btab.to(dev))
        logits, cache = S.serve_forward(
            cfg, folded, toks.to(dev), cache=cache, mode="verify", block_tables=btab.to(dev),
            pos_offset=torch.tensor([21, 14], dtype=torch.int32, device=dev),
            verify_rows=torch.tensor([4, 2], dtype=torch.int32, device=dev))
        out.append((torch.cat([logits[0, :4], logits[1, :2]]).cpu(),
                    [c[leaf][:, 1:].cpu() for c in cache.values() for leaf in ("k", "v")]))
    (cpu_logits, cpu_pool), (card_logits, card_pool) = out
    assert torch.equal(cpu_logits, card_logits)
    assert all(torch.equal(a, b) for a, b in zip(cpu_pool, card_pool))


@pytest.mark.cuda
def test_engine_on_card_spec_equals_plain(cuda):
    """The smoke yi-6b through the engine on the card with spec_k = 3:
    prompt lookup and the oracle give the plain-decode tokens, the oracle
    rejects nothing with fewer decode forwards, and each verify forward
    launches the paged prefill kernel once per layer."""
    from repro_torch.serve.draft import SequenceDraft

    cfg, folded = _smoke_folded(cuda)
    rng = np.random.default_rng(1)
    pats = [rng.integers(0, cfg.vocab_size, 3) for _ in range(4)]
    prompts = [np.tile(p, n)[:m].astype(np.int32) for p, n, m in zip(pats, (3, 5, 2, 7),
                                                                       (9, 14, 5, 20))]

    def run(**kw):
        eng = Engine(cfg, folded, EngineConfig(batch_slots=3, max_len=64, page_size=4, **kw))
        reqs = [Request(prompt=p, max_new_tokens=9) for p in prompts]
        n0 = paged_prefill_qattention.launches
        eng.generate(reqs)
        return [r.out.tolist() for r in reqs], eng.counters, paged_prefill_qattention.launches - n0

    plain, c0, _ = run()
    seqs = [list(p) + o for p, o in zip(prompts, plain)]
    for draft in ("prompt_lookup", SequenceDraft(seqs)):
        toks, c, launches = run(spec_k=3, draft=draft)
        assert toks == plain
        assert c["drafted"] == c["accepted"] + c["rejected"]
        assert launches % cfg.n_layers == 0 and launches > cfg.n_layers * c["prefill_chunks"]
    assert c["rejected"] == 0 and c["decode_steps"] < c0["decode_steps"]


# --- the archs of port slice 11: qwen3-4b (qk-norm), qwen2-moe-a2.7b (MoE),
# stablelm-1.6b (MHA at head_dim 64) ---------------------------------------

# (K, N) of qwen3-4b's linears (wq, wk/wv, wg/wu, wo, wd) and of qwen2-moe's
# experts (wg/wu, wd), at the M the served paths give them: a decode tick
# (8), the experts' capacity at a tick or a short chunk (4), at 96 rows (8)
# and at a 512-row chunk (43)
QWEN3_GEMMS = [(2560, 4096), (2560, 1024), (2560, 9728), (4096, 2560), (9728, 2560)]
EXPERT_GEMMS = [(2048, 1408), (1408, 2048)]


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 512) for k, n in QWEN3_GEMMS]
                         + [(m, k, n) for m in (4, 8, 43) for k, n in EXPERT_GEMMS])
def test_plan_fills_a_wave_at_the_qwen_shapes(m, k, n):
    p = plan(m, k, n)
    assert p.path == ("decode" if m <= 8 else "tensor_core")
    assert p.vec == 16 and p.blocks >= WAVE


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 512) for k, n in QWEN3_GEMMS]
                         + [(m, k, n) for m in (4, 8, 43) for k, n in EXPERT_GEMMS])
def test_int4_matmul_kernel_equals_plain_at_the_qwen_shapes(cuda, m, k, n):
    args = _mm(m, k, n, m + n, cuda)
    assert torch.equal(_launched_once_on(int4_matmul, plan(m, k, n).path, *args),
                       ref.int4_matmul_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(8, 2560), (512, 2560), (8, 2048), (512, 2048)])
@pytest.mark.parametrize("subtract_mean", [True, False])
def test_quant_layernorm_kernel_equals_plain_at_the_new_widths(cuda, subtract_mean, r, n):
    x, p = _ln(r, n, r + n, subtract_mean, cuda)
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


# G = 1: qwen2-moe (16 heads of 128) and stablelm (32 heads of 64)
G1_HEADS = [(16, 128), (32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,d", G1_HEADS)
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_decode_kernels_equal_plain_at_g1(cuda, kind, hkv, d):
    fn, plain = _split_pair(kind)
    maker = _decode if kind == "int8" else _decode_q4
    args = maker(1, d, 16, YI_LENGTHS, cuda, hkv=hkv, seed=hkv + d)
    assert torch.equal(_launched_once(fn, *args), plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,d", G1_HEADS)
@pytest.mark.parametrize("sq,pos0", [(512, [0]), (128, [256]), (4, [33, 100, 700, 1000])])
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_kernels_equal_plain_at_g1(cuda, kind, hkv, d, sq, pos0):
    fn, plain = _prefill_pair(kind)
    args = _prefill_args(kind, (hkv, hkv, d, 16, sq, pos0), cuda)
    assert torch.equal(_launched_once(fn, *args), plain(*args))


@pytest.mark.cuda
def test_lm_head_is_exact_when_the_caller_turns_tf32_on(cuda):
    """``torch.set_float32_matmul_precision("high")`` lets cuBLAS round a
    float32 product's inputs to TF32; the serving forward's lm_head (and
    the MoE router) turn it off for their own product: the logits equal
    those at "highest", and the caller's setting is in force afterwards."""
    from repro_torch.models import serve_int as S

    cfg = smoke_config("qwen2-moe-a2.7b")
    folded = S.prepare_folded(cfg, tree_map(lambda t: t.to(cuda),
                                            calibrated_folded(cfg, 0, device="cpu")))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32)).to(cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want, _ = S.serve_forward(cfg, folded, toks)
        torch.set_float32_matmul_precision("high")
        got, _ = S.serve_forward(cfg, folded, toks)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-4b", "stablelm-1.6b"])
def test_small_arch_engine_on_card_gives_the_cpu_tokens(cuda, arch, monkeypatch):
    """The smoke arch through the engine on the card (the kernels) and on
    the CPU under REPRO_TORCH_KERNELS=gpu (their plain versions), one-shot
    and chunked: equal greedy tokens.  The float islands (the router's and
    the RoPE island's exp, rsqrt and sums) may move a code between the two
    devices; the tokens must not move.  One-shot equals chunked for the
    dense archs only: a MoE forward's capacity couples its rows, so where
    the router drops a choice the chunking moves tokens, as in the
    reference."""
    cfg = smoke_config(arch)
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to(cuda), folded_cpu)}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 17, 12)]

    def serve(dev, **kw):
        eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64, page_size=4,
                                                    **kw))
        return [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=8) for p in prompts])]

    runs = [lambda d: serve(d), lambda d: serve(d, max_prefill_chunk=8, max_batched_tokens=16)]
    for k in ENGINE_KERNELS:
        k.launches = 0
    on_card = [run("cuda") for run in runs]
    assert all(k.launches > 0 for k in ENGINE_KERNELS), [k.launches for k in ENGINE_KERNELS]
    if not cfg.n_experts:
        assert on_card[0] == on_card[1]
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert on_card == [run("cpu") for run in runs]


# --- the sliding window (mixtral-8x22b) -----------------------------------------

def _window_scalars(d, device, branch):
    """``_real_scalars``, or for ``branch="from_block_0"`` a logit scale 600
    times larger: a masked key still clips to the table's zero entry, but
    ``window_skip_margin`` falls below 1, so a windowed tile walks from
    block 0."""
    M, sh, lut, inv, osc = _real_scalars(d, device)
    if branch == "skip":
        return M, sh, lut, inv, osc
    s_logit = np.sqrt(d) * 73.0 * 73.0 / 2.0 * 600.0
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * qs.LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32, device=device),
            torch.tensor(sh, dtype=torch.int32, device=device), lut,
            torch.tensor(np.float32(1.0 / s_logit), device=device), osc)


# (B, H, Hkv, Sq, Skv, D, bkv, q_offset, window)
WINDOW_CASES = {
    "mixtral_s8192": (1, 48, 8, 8192, 8192, 128, 512, 0, 4096),
    "mixtral_q_offset": (1, 48, 8, 128, 8192, 128, 512, 8064, 4096),
    "mixtral_bkv504": (1, 48, 8, 8064, 8064, 128, 504, 0, 4096),
    "mixtral_window_never_bites": (1, 48, 8, 4032, 4032, 128, 504, 0, 4096),
    "g6_small_window": (2, 12, 2, 100, 100, 64, 25, 0, 20),
    "g6_bkv_odd_q_offset": (1, 12, 2, 37, 111, 128, 37, 74, 50),
    "g2_window_1": (1, 4, 2, 48, 48, 32, 16, 0, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["skip", "from_block_0"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windowed_flash_qattention_kernel_equals_plain(cuda, case, branch):
    """Row 9 with a sliding window against its plain version (which walks
    every row from block 0): mixtral's heads (G 6, three q heads a CTA) at
    the served shapes, a 16-row tile whose rows' windows start in different
    blocks, bkv not dividing the window, q_offset > 0, window 1; in the
    branch that starts each tile at its first live block and in the one that
    may not."""
    from repro_torch.kernels.flash_qattention import flash_qattention_torch

    b, h, hkv, sq, skv, d, bkv, q_offset, window = WINDOW_CASES[case]
    q, k, v, *_ = _flash(b, h, hkv, sq, skv, d, cuda, seed=sq + skv, strided=True)
    scal = _window_scalars(d, cuda, branch)
    assert (ref.window_skip_margin(float(scal[3]), d) > 1) == (branch == "skip")
    args = (q, k, v, *scal)
    got = _launched_once(flash_qattention, *args, q_offset=q_offset, bkv=bkv, window=window)
    want = flash_qattention_torch(*args, q_offset=q_offset, bkv=bkv, window=window)
    assert torch.equal(got, want)
    if branch == "skip":            # logits of a few units: outputs spread over the codes
        assert int((want != 0).sum()) > want.numel() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("smax,bkv,lengths", [
    (4096, 512, [33, 600, 1024, 2047, 2048, 3000, 4095, 4096]),   # mixtral's ring, B 8
    (16, 16, [16, 3, 16, 9]),                                     # the small mixtral's
])
def test_contiguous_decode_kernel_equals_plain_at_g6_over_a_full_ring(cuda, smax, bkv,
                                                                       lengths):
    """Row 6 at mixtral's group (Hkv 8, G 6, D 128) over rings whose rows
    hold positions out of order once they wrap: lengths min(pos + 1, Smax),
    full rings among them."""
    args = _stripe(6, 128, smax, lengths, cuda, hkv=8, seed=smax)
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=bkv),
                       ref.decode_qattention_ref(*args, bkv))


@pytest.mark.cuda
def test_small_mixtral_on_card_gives_the_cpu_tokens(cuda, monkeypatch):
    """The small mixtral (window 16) on ``cache_layout="auto"``, which
    resolves to the 16-row ring: prompts of 9 and 12 tokens prefill
    one-shot, of 30 and 20 through the batch-1 decode loop, and every
    request decodes past the window; then the ``LockstepEngine``.  The card
    (the kernels) and the CPU under REPRO_TORCH_KERNELS=gpu (their plain
    versions) give equal greedy tokens."""
    cfg = smoke_config("mixtral-8x22b")
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to(cuda), folded_cpu)}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 12, 20)]

    def continuous(dev):
        eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64))
        out = [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=12) for p in prompts])]
        assert eng.layout == "contiguous" and eng.counters["loop_prefill_steps"] == 50
        return out

    def lockstep(dev):
        return [r.out.tolist() for r in LockstepEngine(
            cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64)).generate(
            [Request(prompt=p, max_new_tokens=10) for p in prompts[:3]])]

    for k in LAYOUT_KERNELS + FLASH_KERNELS:
        k.launches = 0
    on_card = [continuous("cuda"), lockstep("cuda")]
    assert decode_qattention.launches > 0 and flash_qattention.launches > 0
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert on_card == [continuous("cpu"), lockstep("cpu")]


# --- the recurrent archs (xlstm-1.3b, jamba-1.5-large) ----------------------------

RECURRENT = ["xlstm-1.3b", "jamba-1.5-large-398b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_small_recurrent_arch_on_card_gives_the_cpu_tokens(cuda, arch, monkeypatch):
    """The small xlstm (sLSTM + mLSTM) or jamba (Mamba, attention, 4
    experts) on ``cache_layout="auto"`` (the contiguous layout, every prompt
    through the batch-1 decode loop), then the ``LockstepEngine``: the card
    (the kernels; the float cores on cuBLAS) and the CPU under
    REPRO_TORCH_KERNELS=gpu (the kernels' plain versions) give equal greedy
    tokens."""
    cfg = smoke_config(arch)
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to(cuda), folded_cpu)}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 17, 12)]

    def continuous(dev):
        eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64))
        out = [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=8) for p in prompts])]
        c = eng.counters
        assert eng.layout == "contiguous" and c["loop_prefill_steps"] == 68
        assert c["oneshot_prefills"] == 0
        return out

    def lockstep(dev):
        return [r.out.tolist() for r in LockstepEngine(
            cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64)).generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts[:3]])]

    kernels = (quant_layernorm, int4_matmul, decode_qattention, flash_qattention)
    for k in kernels + ENGINE_KERNELS:
        k.launches = 0
    on_card = [continuous("cuda"), lockstep("cuda")]
    assert quant_layernorm.launches > 0
    attn = arch.startswith("jamba")
    assert (int4_matmul.launches > 0) == attn and (decode_qattention.launches > 0) == attn
    assert paged_decode_qattention.launches == paged_prefill_qattention.launches == 0
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert on_card == [continuous("cpu"), lockstep("cpu")]


@pytest.mark.cuda
def test_lin_wonly_is_exact_when_the_caller_turns_tf32_on(cuda):
    """The recurrent slots' float products (``_lin_wonly`` and the rest of
    the island) run with TF32 off whatever the caller set: a weight-only
    linear and the small xlstm's logits equal those at "highest", and the
    caller's setting is in force afterwards."""
    from repro_torch.models import serve_int as S

    cfg = smoke_config("xlstm-1.3b")
    folded = S.prepare_folded(cfg, tree_map(lambda t: t.to(cuda),
                                            calibrated_folded(cfg, 0, device="cpu")))
    lin = folded["layers"][0]["slot1"]["mx"]["wq"]
    x = torch.randn((3, 37, cfg.d_model), generator=torch.Generator().manual_seed(4)).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32)).to(cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = S._lin_wonly(x, lin), S.serve_forward(cfg, folded, toks)[0]
        torch.set_float32_matmul_precision("high")
        got = S._lin_wonly(x, lin), S.serve_forward(cfg, folded, toks)[0]
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[17, 40, 80, 128, 150, 200, 230, 256], [200]])
def test_contiguous_decode_kernel_equals_plain_at_jamba_g8(cuda, lengths):
    """Row 6 at jamba's group (Hkv 8, G 8, D 128) over 256-row stripes (the
    served max_len, bkv 256): a tick of 8 slots and a loop step of one."""
    args = _stripe(8, 128, 256, lengths, cuda, hkv=8, seed=len(lengths))
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=256),
                       ref.decode_qattention_ref(*args, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [512, 200])
def test_flash_qattention_kernel_equals_plain_at_jamba_heads(cuda, s):
    """Row 9 at jamba's heads (H 64, Hkv 8, D 128): the (1, 512) cache-less
    forward at its serving block, and a 200-token one."""
    from repro_torch.kernels.flash_qattention import divisor_tile, flash_qattention_torch

    args = _flash(1, 64, 8, s, s, 128, cuda, strided=True)
    bkv = divisor_tile(512, s)
    assert torch.equal(_launched_once(flash_qattention, *args, bkv=bkv),
                       flash_qattention_torch(*args, bkv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_step_writes_the_recurrent_state_in_place_through_a_slot_view(cuda, arch):
    """Decode steps through a view of one slot of a 3-slot cache (as the
    engine's decode-loop prefill hands it over) write the recurrent state
    in place: the viewed slot ends equal to a batch-1 cache run alone, the
    other slots stay zero."""
    from repro_torch.models import serve_int as S

    cfg = smoke_config(arch)
    folded = S.prepare_folded(cfg, tree_map(lambda t: t.to(cuda),
                                            calibrated_folded(cfg, 0, device="cpu")))
    cache = S.init_cache(cfg, 3, 32, device=cuda)
    view = {n: {leaf: t[:, 1:2] for leaf, t in c.items()} for n, c in cache.items()}
    alone = S.init_cache(cfg, 1, 32, device=cuda)
    toks = torch.tensor([[5], [77], [300], [9]], dtype=torch.int32, device=cuda)
    for t in range(4):
        for c in (view, alone):
            S.serve_forward(cfg, folded, toks[t:t + 1], cache=c, pos_offset=t, mode="decode")
    for n, c in cache.items():
        for leaf, t in c.items():
            assert torch.equal(t[:, 1:2], alone[n][leaf]), (n, leaf)
            assert not t[:, 0].any() and not t[:, 2].any(), (n, leaf)
    assert all(bool(cache[n][leaf].any()) for n, c in cache.items() for leaf in c
               if leaf not in ("k", "v"))


# --- the frontend archs (qwen2-vl-2b, musicgen-medium) ----------------------------

# (K, N) of qwen2-vl-2b's linears (wq and wo, wk/wv, w_gate/w_up, w_down) and
# musicgen-medium's (the attention's four, w1, w2), at a lockstep step (M 8)
# and a 512-row prefill
FRONTEND_GEMMS = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (1536, 6144),
                  (6144, 1536)]


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 512) for k, n in FRONTEND_GEMMS])
def test_plan_fills_a_wave_at_the_frontend_shapes(m, k, n):
    """The decode path at M 8, the tensor cores at 512, 16-byte copies; the
    blocks fill a wave unless K is already split into single 32-row steps
    (wk/wv's N 256 at M 8: 2 column blocks x 24 steps)."""
    p = plan(m, k, n)
    assert p.path == ("decode" if m <= 8 else "tensor_core") and p.vec == 16
    assert p.blocks >= WAVE or (p.path == "decode" and p.split == k // 64)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 512) for k, n in FRONTEND_GEMMS])
def test_int4_matmul_kernel_equals_plain_at_the_frontend_shapes(cuda, m, k, n):
    args = _mm(m, k, n, m + n + k, cuda)
    assert torch.equal(_launched_once_on(int4_matmul, plan(m, k, n).path, *args),
                       ref.int4_matmul_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 512])
@pytest.mark.parametrize("subtract_mean", [True, False])
def test_quant_layernorm_kernel_equals_plain_at_n1536(cuda, subtract_mean, r):
    """qwen2-vl's RMSNorm and musicgen's LN at d 1,536."""
    x, p = _ln(r, 1536, r + 1536, subtract_mean, cuda)
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


# (Hkv, G, D): qwen2-vl's GQA and musicgen's MHA at head_dim 64
FRONTEND_HEADS = [(2, 6, 128), (24, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[33, 100, 250, 400, 520, 640, 700, 1024], [545]])
@pytest.mark.parametrize("hkv,g,d", FRONTEND_HEADS)
def test_contiguous_decode_kernel_equals_plain_at_the_frontend_heads(cuda, hkv, g, d,
                                                                     lengths):
    """Row 6 over 1,024-row stripes at bkv 512: a lockstep step of 8 slots
    and one slot of the vision stub's 512-row prefill plus its decode."""
    args = _stripe(g, d, 1024, lengths, cuda, hkv=hkv, seed=hkv + len(lengths))
    assert torch.equal(_launched_once(decode_qattention, *args, bkv=512),
                       ref.decode_qattention_ref(*args, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 512])
@pytest.mark.parametrize("hkv,g,d", FRONTEND_HEADS)
def test_flash_qattention_kernel_equals_plain_at_the_frontend_heads(cuda, hkv, g, d, s):
    """Row 9 at qwen2-vl's heads (H 12, Hkv 2, D 128) and musicgen's (H =
    Hkv = 24, D 64), B 2, the serving block of S 64 and 512."""
    from repro_torch.kernels.flash_qattention import divisor_tile, flash_qattention_torch

    args = _flash(2, hkv * g, hkv, s, s, d, cuda, seed=s + d, strided=True)
    bkv = divisor_tile(512, s)
    assert torch.equal(_launched_once(flash_qattention, *args, bkv=bkv),
                       flash_qattention_torch(*args, bkv=bkv))


def _frontend_tokens(cfg, folded, dev):
    """A small frontend arch on ``dev``: the cache-less forward, then the
    one-shot stripe prefill and 6 greedy decode steps (qwen2-vl: 16 image
    rows of codes and a 4 x 4 ``pos3`` grid before 8 text tokens, the
    LockstepEngine's greedy tokens too; musicgen: (2, 4, 12) codes, each
    head's argmax the next frame).  Returns (greedy tokens, logits)."""
    from repro_torch.models import serve_int as S

    rng = np.random.default_rng(5)
    audio = cfg.frontend == "audio_codebooks"
    kw = {}
    if audio:
        prompt = rng.integers(0, cfg.vocab_size, (2, cfg.n_codebooks, 12))
    else:
        prompt = rng.integers(0, cfg.vocab_size, (2, 8))
        g = np.arange(16)
        pos3 = np.concatenate([np.stack([0 * g, g // 4, g % 4], -1),
                               np.repeat(4 + np.arange(8)[:, None], 3, -1)])
        kw = dict(extra_embeds_i8=torch.from_numpy(
            rng.integers(-60, 61, (2, 16, cfg.d_model)).astype(np.int8)).to(dev),
            pos3=torch.from_numpy(np.broadcast_to(pos3, (2, 24, 3)).astype(np.int32)).to(dev))
    prompt = torch.from_numpy(prompt.astype(np.int32)).to(dev)
    logits = [S.serve_forward(cfg, folded, prompt, **kw)[0]]
    cache = S.init_cache(cfg, 2, 48, device=dev)
    lg, cache = S.serve_forward(cfg, folded, prompt, cache=cache, **kw)
    logits.append(lg)
    toks, rows = [], lg.shape[-2]
    for step in range(6):
        toks.append(lg[..., -1, :].argmax(-1).to(torch.int32)[..., None])
        lg, cache = S.serve_forward(cfg, folded, toks[-1], cache=cache,
                                    pos_offset=rows + step, mode="decode")
        logits.append(lg)
    out = [t.cpu().tolist() for t in toks]
    if not audio:
        out.append([r.out.tolist() for r in LockstepEngine(
            cfg, folded, EngineConfig(batch_slots=2, max_len=48)).generate(
            [Request(prompt=p, max_new_tokens=6) for p in (np.arange(3, 12), np.arange(40, 45))])])
    return out, [t.cpu() for t in logits]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_small_frontend_arch_on_card_gives_the_cpu_tokens(cuda, arch, monkeypatch):
    """The small qwen2-vl (the published section proportions at head_dim
    32, (4, 6, 6)) or musicgen on the card (the kernels) and on the CPU
    under REPRO_TORCH_KERNELS=gpu (their plain versions), from the same
    folded weights: the cache-less forward, the one-shot stripe prefill and
    its decode steps give equal greedy tokens, and so does qwen2-vl's
    LockstepEngine; the flash and the stripe decode ran on the card."""
    cfg = smoke_config(arch, **({} if arch.startswith("musicgen") else
                                dict(mrope_sections=(4, 6, 6))))
    folded_cpu = calibrated_folded(cfg, 0, device="cpu")
    folded = tree_map(lambda t: t.to(cuda), folded_cpu)
    for k in (decode_qattention, flash_qattention):
        k.launches = 0
    got, got_logits = _frontend_tokens(cfg, folded, cuda)
    assert decode_qattention.launches > 0 and flash_qattention.launches > 0
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    want, want_logits = _frontend_tokens(cfg, folded_cpu, "cpu")
    assert got == want
    assert all(torch.isfinite(g).all() and g.shape == w.shape
               for g, w in zip(got_logits, want_logits))


# --- training: the QAT step on the card ----------------------------------------

def _train_state_to(state, device):
    from repro_torch.train import steps as St

    return St.TrainState(tree_map(lambda t: t.to(device), state.params),
                         tree_map(lambda t: t.to(device), state.opt),
                         tree_map(lambda t: t.to(device), state.amax), state.step.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_train_fake_quant_gradient_on_card_equals_cpu(cuda, bits):
    """``ste_round`` and ``fake_quant`` give the same values and gradients
    on the card as on the CPU, elements on the clip's bounds (half the
    gradient) included."""
    from repro_torch.core import quant as q

    rng = np.random.default_rng(bits)
    x = rng.normal(0, 1, (257, 129)).astype(np.float32)
    x[0, :5] = [-2.0, -1.0, 0.3, 1.0, 2.0]
    x = np.clip(x, -2.0, 2.0)                       # many elements on the bounds
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = q.fake_quant(xt, torch.tensor(2.0, device=dev), bits)
        (y * torch.from_numpy(w).to(dev)).sum().backward()
        r = torch.from_numpy(x * 3.7).to(dev).requires_grad_(True)
        z = q.ste_round(r)
        z.sum().backward()
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu(), z.detach().cpu(), r.grad.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)], strict=True):
        assert torch.equal(a, b)
    assert out["cpu"][1][0, 0] == 0.5 * w[0, 0] and out["cpu"][1][0, 4] == 0.5 * w[0, 4]


def _card_step_matches_cpu(cuda, cfg, s, grad_norm_rtol=1e-3, rel=5e-2):
    """One train step of ``cfg`` on the card against the same step on the
    CPU: the loss at rtol 1e-3, the grad norm at ``grad_norm_rtol``, the
    gradients (the first moments, (1 - b1) clip g) within ``rel`` of their
    norm, every new param within 2 x lr, the new amax at rtol ``rel``; every
    difference printed, with the gradient elements beyond 1e-5 of their
    leaf's largest and the amax entries that moved (the code flips'
    trace)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as St

    opt = AdamWConfig(lr=1e-3)
    state = St.init_train_state(cfg, torch.Generator().manual_seed(0), opt)
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg.vocab_size, s, 2).batch_at(0).items()}
    step = St.make_train_step(cfg, opt)
    want, wm = step(state, batch)
    got, gm = step(_train_state_to(state, cuda), {k: v.to(cuda) for k, v in batch.items()})
    pairs = {name: list(zip(tree_leaves(getattr(want, name) if name != "m" else want.opt["m"]),
                            tree_leaves(getattr(got, name) if name != "m" else got.opt["m"]),
                            strict=True)) for name in ("params", "m", "amax")}
    grad_rel = (sum(float(((b.cpu() - a) ** 2).sum()) for a, b in pairs["m"])
                / sum(float((a ** 2).sum()) for a, _ in pairs["m"])) ** 0.5
    beyond = sum(int(((b.cpu() - a).abs() > 1e-5 * a.abs().max()).sum()) for a, b in pairs["m"])
    param_max = max(float((a - b.cpu()).abs().max()) for a, b in pairs["params"])
    amax_rel = max(float(((b.cpu() - a).abs() / a.abs().clamp(min=1e-30)).max())
                   for a, b in pairs["amax"])
    moved = sum(int((b.cpu() != a).sum()) for a, b in pairs["amax"])
    for k in ("loss", "grad_norm"):
        print(f"  {cfg.name} {k}: CPU {float(wm[k])!r}, card {float(gm[k])!r}")
    print(f"  {cfg.name} gradients: difference norm {grad_rel:.3g} of the norm, {beyond} "
          f"elements beyond 1e-5 of their leaf's max; new params: max |diff| "
          f"{param_max / opt.lr:.3g} x lr; new amax: {moved} entries moved, worst relative "
          f"difference {amax_rel:.3g}")
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                               rtol=grad_norm_rtol)
    assert grad_rel <= rel
    assert param_max <= 2 * opt.lr + 1e-6
    assert amax_rel <= rel
    assert int(got.step) == 1


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One smoke yi-6b train step on the card against the same step on the
    CPU (TF32 off, as PyTorch's default).  A float product summed in
    another order flips activation codes (the first run on the H100 moved
    the grad norm by 1.6e-4 of itself), so the step is held as the CPU
    tests hold an arch across such an island (``_card_step_matches_cpu``)."""
    _card_step_matches_cpu(cuda, smoke_config("yi-6b"), 32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_recurrent_train_step_on_card_matches_cpu(cuda, arch):
    """One smoke train step of a recurrent arch on the card against the
    CPU (``_card_step_matches_cpu``): xlstm's sLSTM loop and mLSTM, jamba's
    Mamba scan and its MoE at S = 160 (two scan chunks).  The loss at rtol
    1e-3, as yi-6b's; yi-6b's other bounds failed on the first H100 run
    (xlstm: grad norm 2.5e-3 apart, 25 amax entries moved; jamba: the
    gradients' difference 5.65e-2 of their norm, amax 5.5e-2 apart, its
    router rerouting), since the card's exp, tanh, sigmoid and float
    products flip codes that the exponential gates and the router amplify:
    the grad norm is held at rtol 5e-3, the gradients and amax at 1e-1."""
    _card_step_matches_cpu(cuda, smoke_config(arch), 160, grad_norm_rtol=5e-3, rel=1e-1)


@pytest.mark.cuda
def test_train_bf16_checkpoint_roundtrip_on_card(cuda, tmp_path):
    """A bf16 TrainState on the card (float32 moments) after a step at S =
    1,024 (rows chunked and each layer recomputed in the backward): saved
    and restored, every leaf equal bit for bit, on the card, in its dtype."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import steps as St

    cfg = dataclasses.replace(smoke_config("yi-6b"), param_dtype="bfloat16", remat=True)
    opt = AdamWConfig(lr=1e-3)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = St.init_train_state(cfg, gen, opt)
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in SyntheticLM(cfg.vocab_size, 1024, 2).batch_at(0).items()}
    state, m = St.make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert state.params["embed"]["tokens"].dtype == torch.bfloat16
    assert state.opt["m"]["embed"]["tokens"].dtype == torch.float32
    ck.save(tmp_path, 1, state, meta={"data_step": 1})
    back, meta = ck.restore(tmp_path, 1, state)
    assert meta == {"data_step": 1}
    for (path, a), (_, b) in zip(ck._paths(state), ck._paths(back), strict=True):
        assert a.dtype == b.dtype and b.device.type == "cuda" and torch.equal(a, b), path


# --- tensor parallelism: the paged pool split over four ranks ------------------

# yi-6b at tp = 4: each rank holds Hkv = 1 KV head with its G = 8 q heads
TP4_LENGTHS = [33, 100, 250, 400, 520, 640, 700, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_decode_at_the_tp4_rank_shape_equals_plain(cuda, kind):
    fn, plain = _split_pair(kind)
    make = _decode if kind == "int8" else _decode_q4
    args = make(8, 128, 16, TP4_LENGTHS, cuda, hkv=1)
    assert torch.equal(_launched_once(fn, *args), plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,pos0", [(512, [0]), (128, [256]), (16, [1008]),
                                     (4, TP4_LENGTHS)])          # the verify forward's rows
@pytest.mark.parametrize("kind", ["int8", "q4"])
def test_paged_prefill_at_the_tp4_rank_shape_equals_plain(cuda, kind, sq, pos0):
    fn, plain, make = (
        (paged_prefill_qattention, ref.paged_prefill_qattention_ref, _prefill) if kind == "int8"
        else (paged_prefill_qattention_q4, ref.paged_prefill_qattention_q4_ref, _prefill_q4))
    args = make(8, 1, 128, 16, sq, pos0, cuda)
    assert torch.equal(_launched_once(fn, *args), plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"kv_bits": 4}, {"spec_k": 3}], ids=["int8", "kv4", "spec"])
def test_tp4_engine_on_card_equals_tp1(cuda, kw):
    """A small yi-6b with yi-6b's grouping (32 q heads, 4 KV heads) through
    the engine on the card, unsharded and over four ranks on the one card
    (Hkv = 1, G = 8 a rank): equal tokens and counters, and each attention
    kernel of the path launched four times as often."""
    cfg = smoke_config("yi-6b", n_heads=32, n_kv_heads=4)
    folded = tree_map(lambda t: t.to(cuda), calibrated_folded(cfg, 0, device="cpu"))
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, 3), 12)[:n].astype(np.int32)
               for n in (9, 30, 17, 12)]
    attn = [paged_prefill_qattention_q4, paged_decode_qattention_q4] if kw.get("kv_bits") \
        else [paged_prefill_qattention, paged_decode_qattention]

    def run(mesh):
        for k in attn:
            k.launches = 0
        eng = Engine(cfg, folded, EngineConfig(batch_slots=3, max_len=64, page_size=4,
                                               mesh=mesh, **kw))
        out = [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]
        torch.cuda.synchronize()
        return out, dict(eng.counters), [k.launches for k in attn]

    one, c1, n1 = run(None)
    four, c4, n4 = run(TPMesh((torch.device("cuda", 0),) * 4))
    assert four == one and c4 == c1
    assert all(n > 0 for n in n1) and n4 == [4 * n for n in n1]
    if kw.get("spec_k"):
        assert c4["drafted"] > 0
