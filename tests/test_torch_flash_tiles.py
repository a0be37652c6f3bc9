"""The causal flash prefill as the CUDA kernel tiles it
(``ref.flash_qattention_tiled_ref``: 16 query rows a tile; per bkv block a
sweep over 32-key steps for the block's row max, a second sweep recomputing
the scores for the int32 numerators, den_b and P.V, then the carry once per
block) against the block-serial plain version ``flash_qattention_torch``,
with ``torch.equal`` on the CPU.

The cases: a max that rises in the last key tile of every block, equal
maxima, blocks of 48, 37 and 296 keys (no multiple of the step), 512-key
blocks over 1,024 keys, G = 16 with D = 128, ``q_offset`` with Sq < Skv and a
ragged q tile (Sq = 100); steps of 16, 32 (the kernel's) and 64 keys.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.qsoftmax import LUT_DELTA
from repro_torch.kernels import ref
from repro_torch.kernels.flash_qattention import flash_qattention_torch

# (b, h, hkv, sq, skv, d, bkv, q_offset, rig): rig "rise" puts a growing
# maximum on the last key of every block, "equal" repeats the first 16 keys
# down the whole sequence
CASES = {
    "rise_in_last_tile": (1, 4, 2, 96, 96, 32, 48, 0, "rise"),
    "equal_maxima": (1, 4, 2, 64, 64, 32, 32, 0, "equal"),
    "bkv48": (2, 4, 1, 144, 144, 32, 48, 0, None),
    "bkv37": (1, 4, 2, 111, 111, 32, 37, 0, None),
    "bkv296": (1, 2, 1, 592, 592, 32, 296, 0, None),
    "bkv512_1024_keys": (1, 2, 1, 1024, 1024, 32, 512, 0, None),
    "g16_d128": (1, 16, 1, 40, 40, 128, 40, 0, None),
    "q_offset": (2, 4, 1, 48, 160, 32, 32, 112, None),
    "ragged_q_tile": (1, 4, 1, 100, 160, 32, 16, 60, None),
}
KEYS = [16, 32, 64]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalars(d):
    """Logits of a few units for random codes (|q|, |k| ~ 73)."""
    s_logit = 73.0 * 73.0 * np.sqrt(d) / 1.5
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
            torch.from_numpy(ref.make_exp_lut_q7()), torch.tensor(np.float32(1.0 / s_logit)),
            torch.tensor(np.float32(1.3)))


def _case(name):
    b, h, hkv, sq, skv, d, bkv, q_offset, rig = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.integers(-127, 128, (b, h, sq, d)).astype(np.int8)
    k = rng.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
    if rig == "equal":
        k = np.tile(k[:, :, :16], (1, 1, skv // 16 + 1, 1))[:, :, :skv]
    if rig == "rise":
        nblk = skv // bkv
        for j in range(nblk):
            top = 40 + 87 * (j + 1) // nblk
            k[:, :, (j + 1) * bkv - 1] = np.where(q[:, ::h // hkv, 0] >= 0, top, -top)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), *_scalars(d))
    return args, dict(q_offset=q_offset, bkv=bkv)


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_flash_equals_block_serial(name, keys):
    args, kw = _case(name)
    want = flash_qattention_torch(*args, **kw)
    assert torch.equal(ref.flash_qattention_tiled_ref(*args, keys=keys, **kw), want)


def test_flash_rigged_cases_do_what_they_say():
    """The rise case's row maxima grow block by block; the equal case's
    16-key tiles repeat."""
    (q, k, *_), kw = _case("rise_in_last_tile")
    s = torch.einsum("d,td->t", q[0, 0, -1].float(), k[0, 0].float())
    bkv = kw["bkv"]
    block_max = s.reshape(-1, bkv).amax(dim=1)
    assert bool((block_max[1:] > block_max[:-1]).all())
    (q, k, *_), _ = _case("equal_maxima")
    assert torch.equal(k[:, :, :16], k[:, :, 48:64])
