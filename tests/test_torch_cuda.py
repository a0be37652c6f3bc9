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
from repro_torch.kernels.decode_attention import paged_decode_qattention
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.prefill_attention import paged_prefill_qattention
from repro_torch.kernels.quant_layernorm import quant_layernorm
from repro_torch.launch.serve import calibrated_folded
from repro_torch.models.transformer import tree_map
from repro_torch.serve.engine import Engine, EngineConfig, Request

KERNELS = (int4_matmul, quant_layernorm, paged_prefill_qattention, paged_decode_qattention)


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


def _launched_once(fn, *args):
    n0 = fn.launches
    out = fn(*args)
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
    assert [k.launches for k in KERNELS] == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 512), (8, 11008, 4096), (37, 256, 96),
                                   (130, 4096, 11008)])
def test_int4_matmul_kernel_equals_plain(cuda, m, k, n):
    args = _mm(m, k, n, 3, cuda)
    assert torch.equal(_launched_once(int4_matmul, *args), ref.int4_matmul_ref(*args))


@pytest.mark.cuda
def test_int4_matmul_rejects_unsupported_shapes(cuda):
    x, w, b, M, sh = _mm(4, 96, 64, 1, cuda)        # K/2 = 48 is no multiple of 32
    with pytest.raises(ValueError):
        int4_matmul(x, w, b, M, sh)


@pytest.mark.cuda
@pytest.mark.parametrize("subtract_mean", [True, False])
@pytest.mark.parametrize("r,n", [(33, 4096), (8, 128)])
def test_quant_layernorm_kernel_equals_plain(cuda, subtract_mean, r, n):
    x, p = _ln(r, n, 5, subtract_mean, cuda)
    assert torch.equal(_launched_once(quant_layernorm, x, p), ref.quant_layernorm_ref(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,psize,lengths", [(8, 128, 16, [1, 100, 730, 0]),
                                               (4, 32, 8, [5, 17, 40])])
def test_paged_decode_kernel_equals_plain(cuda, g, d, psize, lengths):
    args = _decode(g, d, psize, lengths, cuda)
    assert torch.equal(_launched_once(paged_decode_qattention, *args),
                       ref.paged_decode_qattention_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,psize,sq,pos0", [(32, 4, 128, 16, 128, [0, 256]),
                                                   (8, 2, 32, 8, 77, [3, 0])])
def test_paged_prefill_kernel_equals_plain(cuda, h, hkv, d, psize, sq, pos0):
    args = _prefill(h, hkv, d, psize, sq, pos0, cuda)
    assert torch.equal(_launched_once(paged_prefill_qattention, *args),
                       ref.paged_prefill_qattention_ref(*args))


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

    for k in KERNELS:
        k.launches = 0
    one, c1 = run()
    assert all(k.launches > 0 for k in KERNELS), [k.launches for k in KERNELS]
    chunked, c2 = run(max_prefill_chunk=8, max_batched_tokens=16)
    assert one == chunked
    assert c1["prefix_hits"] >= 1 and c2["chunked_prefills"] >= 1
