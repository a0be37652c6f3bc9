"""The decode kernels' splits against their serial plain versions, with
``torch.equal`` on the CPU.

The paged decode (``ref.paged_decode_split_ref``: page maxima in parallel,
then numerators, den and P.V per page, then the fp32 carry in page order),
int8 and int4-packed pools.  The cases stress what the split must keep
exact: the running max rising on a slot's last page, equal maxima on every
page (f = 1 after the first), the masked tail of a partial page, lengths 0,
1 and whole pages, every span boundary (spans of 1, 2, 3 and 8 pages,
lengths on and across them), and the kernels' shape limits G = 16, D = 128,
P = 64.

The contiguous stripe decode (``ref.stripe_decode_split_ref``: 16-row
sub-tiles, spans of 1, 2 or 8 of them inside one bkv block, the block's
running max from the span maxima, int32 partials per span, the carry per
block) against ``decode_qattention_ref`` and ``flash_qdecode_ref``: a max
that rises in the last sub-tile of every block, equal maxima, lengths 0, 1,
on and past a block end and full, blocks of 48, 37 and 296 rows (no
multiple of the sub-tile), 512-row blocks over 1,000 rows, G = 16 with
D = 128.
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


# (hkv, g, d, smax, bkv, lengths, rig): rig "rise" puts a growing maximum on
# the last live row of every live block, "equal" repeats the first 16 rows
# of K down the whole stripe (every sub-tile has the same maxima)
STRIPE_CASES = {
    "rise_in_last_subtile": (2, 4, 32, 96, 48, [48, 96, 40, 17], "rise"),
    "equal_maxima": (2, 4, 32, 96, 48, [96, 50, 1], "equal"),
    "len_0_1_block_edges": (1, 8, 32, 128, 32, [0, 1, 32, 33, 64, 128], None),
    "bkv48": (2, 4, 32, 144, 48, [47, 48, 49, 144], None),
    "bkv37": (1, 4, 32, 111, 37, [36, 37, 38, 74, 111], None),
    "bkv296": (1, 4, 32, 592, 296, [295, 296, 297, 592], None),
    "bkv512_1000_rows": (1, 8, 32, 1024, 512, [1000], None),
    "g16_d128": (2, 16, 128, 128, 64, [100, 64, 1], None),
}
WARPS = [1, 2, 8]


def _stripe_case(name):
    hkv, g, d, smax, bkv, lengths, rig = STRIPE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b = len(lengths)
    q = rng.integers(-127, 128, (b, hkv, g, d)).astype(np.int8)
    k = rng.integers(-127, 128, (b, smax, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, smax, hkv, d)).astype(np.int8)
    if rig == "equal":
        k = np.tile(k[:, :16], (1, smax // 16 + 1, 1, 1))[:, :smax]
    if rig == "rise":
        for bb, ln in enumerate(lengths):
            nblk = -(-ln // bkv)
            for j in range(nblk):
                top = 40 + 87 * (j + 1) // nblk
                k[bb, min(ln, (j + 1) * bkv) - 1] = np.where(q[bb, :, 0] >= 0, top, -top)
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(lengths, dtype=torch.int32), *_scalars(d)), bkv


@pytest.mark.parametrize("warps", WARPS)
@pytest.mark.parametrize("name", sorted(STRIPE_CASES))
def test_stripe_split_equals_block_serial(name, warps):
    args, bkv = _stripe_case(name)
    want = ref.decode_qattention_ref(*args, bkv)
    assert torch.equal(ref.stripe_decode_split_ref(*args, bkv, warps=warps), want)


@pytest.mark.parametrize("name", ["rise_in_last_subtile", "bkv37", "bkv296",
                                  "bkv512_1000_rows", "g16_d128"])
def test_stripe_split_equals_flash_qdecode_ref(name):
    """One slot of each case as the single-sequence decode sees it: the
    (Hkv, Smax, D) cache and a scalar cache_len."""
    (q, k, v, lens, *scal), bkv = _stripe_case(name)
    b = int(lens.argmax())
    want = ref.flash_qdecode_ref(q[b], k[b].transpose(0, 1), v[b].transpose(0, 1),
                                 int(lens[b]), *scal, bkv=bkv)
    got = ref.stripe_decode_split_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], lens[b:b + 1],
                                      *scal, bkv, warps=2)[0]
    assert torch.equal(got, want)


def test_stripe_rigged_cases_do_what_they_say():
    """The rise case's row maxima peak on the last live row of the last live
    block; the equal case's sub-tiles share their maxima."""
    (q, k, v, lens, *_), bkv = _stripe_case("rise_in_last_subtile")
    for bb, ln in enumerate(lens.tolist()):
        s = torch.einsum("hd,thd->th", q[bb, :, 0].float(), k[bb, :ln].float())
        assert int(s.amax(dim=1).argmax()) == ln - 1
    (q, k, *_), _ = _stripe_case("equal_maxima")
    assert torch.equal(k[:, :16], k[:, 48:64])
