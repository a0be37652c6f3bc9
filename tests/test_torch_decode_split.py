"""The paged decode as the CUDA kernels split it (``ref.paged_decode_split_ref``:
page maxima in parallel, then numerators, den and P.V per page, then the fp32
carry in page order) against the page-serial plain versions, int8 and
int4-packed pools, with ``torch.equal`` on the CPU.

The cases stress what the split must keep exact: the running max rising on
a slot's last page, equal maxima on every page (f = 1 after the first), the
masked tail of a partial page, lengths 0, 1 and whole pages, every span
boundary (spans of 1, 2, 3 and 8 pages, lengths on and across them), and
the kernels' shape limits G = 16, D = 128, P = 64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core.qsoftmax import LUT_DELTA
from repro_torch.kernels import ref

# (hkv, g, d, psize, lengths, rig): rig "rise" puts each slot's largest
# score on its last live page, "equal" backs every page of a chain with the
# same pool page
CASES = {
    "rise_on_last_page": (2, 4, 32, 8, [40, 17, 9], "rise"),
    "equal_maxima": (2, 4, 32, 8, [64, 24, 1], "equal"),
    "masked_tail": (1, 8, 32, 16, [13, 30, 47, 5], None),
    "len_0_1_whole_pages": (2, 2, 32, 8, [0, 1, 16, 64], None),
    "span_boundaries": (1, 4, 32, 4, [4, 8, 9, 12, 13, 24, 25, 31, 32, 33], None),
    "g16": (1, 16, 32, 8, [23, 64, 50], None),
    "d128": (2, 8, 128, 16, [33, 100, 64], None),
    "p64": (1, 4, 64, 64, [64, 65, 200, 1], None),
}
SPANS = [1, 2, 3, 8]


def _scalars(d):
    """Logits of a few units for random codes (|q|, |k| ~ 73), so that many
    keys of a row carry weight and every page's numerators matter."""
    s_logit = 73.0 * 73.0 * np.sqrt(d) / 1.5
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
            torch.from_numpy(ref.make_exp_lut_q7()), torch.tensor(np.float32(1.0 / s_logit)),
            torch.tensor(np.float32(1.3)))


def _case(name, packed):
    hkv, g, d, psize, lengths, rig = CASES[name]
    b = len(lengths)
    nb = -(-max(lengths) // psize) + 1
    n_pages = b * nb + 1
    rng = np.random.default_rng(sum(map(ord, name)))
    q = torch.from_numpy(rng.integers(-127, 128, (b, hkv, g, d)).astype(np.int8))
    lo, hi = (-8, 8) if packed else (-127, 128)
    k = rng.integers(lo, hi, (n_pages, psize, hkv, d)).astype(np.int8)
    v = rng.integers(lo, hi, (n_pages, psize, hkv, d)).astype(np.int8)
    scale = rng.uniform(1 / 7, 127 / 7, (2, n_pages)).astype(np.float32)
    btab = np.zeros((b, nb), np.int32)
    perm = iter(rng.permutation(np.arange(1, n_pages)))
    for bb, ln in enumerate(lengths):
        npg = -(-ln // psize)
        if rig == "equal" and npg:
            btab[bb, :npg] = next(perm)
            continue
        for i in range(npg):
            btab[bb, i] = next(perm)
        if rig == "rise" and npg:
            last, key = btab[bb, npg - 1], (ln - 1) % psize
            top = 7 if packed else 127
            k[last, key] = np.where(q[bb, :, 0].numpy() >= 0, top, -top).astype(np.int8)
            scale[0, last] = 127 / 7
    lens = torch.tensor(lengths, dtype=torch.int32)
    if packed:
        pool = (packing.pack_int4_planar(torch.from_numpy(k), axis=-1),
                packing.pack_int4_planar(torch.from_numpy(v), axis=-1),
                torch.from_numpy(scale[0]), torch.from_numpy(scale[1]))
    else:
        pool = (torch.from_numpy(k), torch.from_numpy(v))
    return (q, *pool, torch.from_numpy(btab), lens, *_scalars(d))


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_equals_page_serial_int8(name, span):
    args = _case(name, packed=False)
    want = ref.paged_decode_qattention_ref(*args)
    assert torch.equal(ref.paged_decode_split_ref(*args, span=span), want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_equals_page_serial_q4(name, span):
    args = _case(name, packed=True)
    want = ref.paged_decode_qattention_q4_ref(*args)
    assert torch.equal(ref.paged_decode_split_q4_ref(*args, span=span), want)


def test_rigged_cases_do_what_they_say():
    """The rise case's row maxima peak on the last live page; the equal
    case's pages all share one maximum; the zero-length slot's output is 0."""
    q, kp, vp, btab, lens, *_ = _case("rise_on_last_page", packed=False)
    for bb, ln in enumerate(lens.tolist()):
        npg = -(-ln // kp.shape[1])
        s = torch.einsum("hgd,pkhd->phgk", q[bb].float(),
                         kp[btab[bb, :npg].long()].float())           # (page, hkv, g, key)
        assert int(s.amax(dim=(1, 2, 3)).argmax()) == npg - 1
    q, kp, vp, btab, lens, *rest = _case("len_0_1_whole_pages", packed=False)
    out = ref.paged_decode_split_ref(q, kp, vp, btab, lens, *rest)
    assert int(out[0].abs().sum()) == 0
    q, kp, vp, btab, lens, *_ = _case("equal_maxima", packed=False)
    assert len(set(btab[0, :8].tolist())) == 1
