"""The port's plain pair-class versions (``repro_torch.kernels.ref``: the
bitset pair op and count, the array x bitset probe, the array pair masks
and count) against the JAX package's jnp oracles and its Pallas kernels
run in interpret mode, on the same seeded numpy inputs.

Inputs: mixed op ids per row, including the ids outside 0-3 that every
version reads as andnot; all-zero and all-ones words; cards 0, 1 and
4,096; identical arrays, disjoint value ranges, a 50% overlap and the
values 0 and 65535.  Off-contract inputs (probe values outside [0, 65535],
cards outside [0, 4096]) are held against a numpy model of the port's own
plain version only.  Tolerance 0: words, masks and counts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import array_ops as jarray
from repro.kernels import pair_ops as jpair
from repro.kernels import ref as jref
from repro_torch.kernels import array_ops as tarray
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pair_ops as tpair
from repro_torch.kernels import ref as tref

WORDS = tref.WORDS
CAP = tref.ARRAY_CAP


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.astype(np.int32))


def _np(t):
    return t.numpy()


def _u32(t):
    return t.numpy().view(np.uint32)


def _words(rng, m):
    w = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    if m > 2:
        w[1] = 0
        w[2] = 0xFFFFFFFF
    return w


# ---------------------------------------------------------------------------
# bitset x bitset (rows 9 and 10)
# ---------------------------------------------------------------------------

OPIDS = [np.array([0, 1, 2, 3, -1, 7, 2, 0], np.int32),
         np.array([3, 3, 3], np.int32), np.array([1], np.int32)]


@pytest.mark.parametrize("opids", OPIDS, ids=["mixed", "andnot", "or"])
def test_bitset_pair_op_matches_jax(opids):
    rng = np.random.default_rng(len(opids))
    m = opids.size
    a, b = _words(rng, m), _words(rng, m)[::-1].copy()
    jw, jc = jref.bitset_pair_op(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(opids))
    tw, tc = tref.bitset_pair_op(_t(a), _t(b), _t(opids))
    assert np.array_equal(_u32(tw), np.asarray(jw))
    assert np.array_equal(_np(tc), np.asarray(jc))
    assert np.array_equal(_np(tref.bitset_pair_card(_t(a), _t(b),
                                                    _t(opids))),
                          np.asarray(jc))
    pw, pc = jpair.bitset_pair_op(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(opids), interpret=True)
    assert np.array_equal(_u32(tw), np.asarray(pw))
    assert np.array_equal(_np(tc), np.asarray(pc))
    pc2 = jpair.bitset_pair_card(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(opids), interpret=True)
    assert np.array_equal(_np(tc), np.asarray(pc2))


def test_bitset_pair_op_reads_other_ids_as_andnot():
    rng = np.random.default_rng(9)
    a, b = _words(rng, 4), _words(rng, 4)
    ids = np.array([3, -1, 7, -2**31], np.int32)
    tw, tc = tref.bitset_pair_op(_t(a), _t(b), _t(ids))
    want = a & ~b
    assert np.array_equal(_u32(tw), want)
    assert np.array_equal(_np(tc), np.bitwise_count(want).sum(axis=1))


# ---------------------------------------------------------------------------
# array x bitset (row 11)
# ---------------------------------------------------------------------------

def _sorted_rows(rng, cards, lo=0, hi=1 << 16):
    vals = np.zeros((len(cards), CAP), np.int32)
    for r, c in enumerate(cards):
        vals[r, :c] = np.sort(rng.choice(np.arange(lo, hi), c,
                                         replace=False))
    return vals


def test_array_bitset_probe_matches_jax():
    rng = np.random.default_rng(11)
    cards = np.array([0, 1, 4096, 300, 2, 4096], np.int32)
    vals = _sorted_rows(rng, cards)
    vals[4, :2] = [0, 65535]                        # the extreme values
    vals[5] = np.arange(CAP) * 16                   # spans every word
    vals[3, 300:] = rng.integers(0, 1 << 16, CAP - 300)   # junk past card
    words = _words(rng, 6)
    words[5] = 0xFFFFFFFF
    jm, jc = jref.array_bitset_probe(jnp.asarray(vals), jnp.asarray(cards),
                                     jnp.asarray(words))
    tm, tc = tref.array_bitset_probe(_t(vals), _t(cards), _t(words))
    assert np.array_equal(_np(tm), np.asarray(jm))
    assert np.array_equal(_np(tc), np.asarray(jc))
    pm, pc = jpair.array_bitset_probe(jnp.asarray(vals),
                                      jnp.asarray(cards),
                                      jnp.asarray(words), interpret=True)
    assert np.array_equal(_np(tm), np.asarray(pm))
    assert np.array_equal(_np(tc), np.asarray(pc))
    assert _np(tc)[5] == 4096 and _np(tc)[0] == 0


def test_array_bitset_probe_off_contract_clips():
    """Values outside [0, 65535] take the clipped word and bit ``v & 31``,
    and cards outside [0, 4096] act clamped: the behaviour the CUDA kernel
    must also have, so it never reads outside the row."""
    rng = np.random.default_rng(12)
    vals = rng.integers(-2**31, 2**31, (3, CAP), dtype=np.int64).astype(
        np.int32)
    vals[0, :4] = [-1, 65536, 2**31 - 1, -2**31]
    cards = np.array([5000, -3, 77], np.int32)
    words = _words(rng, 3)
    tm, tc = tref.array_bitset_probe(_t(vals), _t(cards), _t(words))
    widx = np.clip(vals >> 5, 0, WORDS - 1)
    bit = (np.take_along_axis(words, widx, axis=1)
           >> (vals & 31).astype(np.uint32)) & 1
    valid = np.arange(CAP)[None, :] < np.clip(cards, 0, CAP)[:, None]
    want = np.where(valid, bit, 0).astype(np.int32)
    assert np.array_equal(_np(tm), want)
    assert np.array_equal(_np(tc), want.sum(axis=1))


# ---------------------------------------------------------------------------
# array x array (rows 13 and 14)
# ---------------------------------------------------------------------------

def _array_pairs(seed):
    """Rows: cards (0, 5), (1, 1) equal, (4096, 1), identical arrays of
    3,000, disjoint value ranges, a 50% overlap, full x full, and the
    extreme values 0 and 65535 on both sides."""
    rng = np.random.default_rng(seed)
    ac = np.array([0, 1, 4096, 3000, 900, 1000, 4096, 2], np.int32)
    bc = np.array([5, 1, 1, 3000, 800, 1000, 4096, 3], np.int32)
    a = _sorted_rows(rng, ac)
    b = _sorted_rows(rng, bc)
    a[1, 0] = b[1, 0] = 42
    b[2, 0] = a[2, 17]
    b[3] = a[3]                                       # identical
    a[4, :900] = _sorted_rows(rng, [900], 0, 30000)[0, :900]
    b[4, :800] = _sorted_rows(rng, [800], 30000, 65536)[0, :800]
    common = np.sort(rng.choice(65536, 1500, replace=False))
    a[5, :1000] = np.sort(common[:1000])              # 50% overlap
    b[5, :1000] = np.sort(common[500:])
    a[7, :2] = [0, 65535]
    b[7, :3] = [0, 7, 65535]
    a[0, :] = rng.integers(0, 1 << 16, CAP)           # junk past card 0
    return a, ac, b, bc


def test_array_pair_masks_match_jax():
    a, ac, b, bc = _array_pairs(13)
    args = [jnp.asarray(x) for x in (a, ac, b, bc)]
    jma, jmb, jc = jref.array_pair_masks(*args)
    tma, tmb, tc = tref.array_pair_masks(*[_t(x) for x in (a, ac, b, bc)])
    assert np.array_equal(_np(tma), np.asarray(jma))
    assert np.array_equal(_np(tmb), np.asarray(jmb))
    assert np.array_equal(_np(tc), np.asarray(jc))
    pma, pmb, pc = jarray.array_pair_masks(*args, interpret=True)
    assert np.array_equal(_np(tma), np.asarray(pma))
    assert np.array_equal(_np(tmb), np.asarray(pmb))
    assert np.array_equal(_np(tc), np.asarray(pc))
    assert list(_np(tc)[[1, 3, 4, 5, 7]]) == [1, 3000, 0, 500, 2]


def test_array_intersect_count_matches_jax():
    a, ac, b, bc = _array_pairs(14)
    args = [jnp.asarray(x) for x in (a, ac, b, bc)]
    tc = tref.array_intersect_count(*[_t(x) for x in (a, ac, b, bc)])
    assert np.array_equal(_np(tc), np.asarray(
        jref.array_intersect_count(*args)))
    assert np.array_equal(_np(tc), np.asarray(
        jarray.array_intersect_card(*args, interpret=True)))


def test_array_pair_off_contract_cards_act_clamped():
    a, ac, b, bc = _array_pairs(15)
    big = tref.array_pair_masks(_t(a), _t(np.where(ac == 4096, 9999, ac)),
                                _t(b), _t(np.where(bc == 5, -4, bc)))
    want = tref.array_pair_masks(_t(a), _t(ac), _t(b),
                                 _t(np.where(bc == 5, 0, bc)))
    for g, w in zip(big, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the wrappers and the backend switch on CPU tensors
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu():
    a, ac, b, bc = _array_pairs(16)
    rng = np.random.default_rng(16)
    w = _words(rng, 8)
    ids = np.arange(8, dtype=np.int32) - 2
    tpair.reset_launches()
    tarray.reset_launches()
    got = [tpair.bitset_pair_op(_t(w), _t(w[::-1]), _t(ids)),
           tpair.bitset_pair_card(_t(w), _t(w[::-1]), _t(ids)),
           tpair.array_bitset_probe(_t(a), _t(ac), _t(w)),
           tarray.array_pair_masks(_t(a), _t(ac), _t(b), _t(bc)),
           tarray.array_intersect_card(_t(a), _t(ac), _t(b), _t(bc))]
    want = [tref.bitset_pair_op(_t(w), _t(w[::-1]), _t(ids)),
            tref.bitset_pair_card(_t(w), _t(w[::-1]), _t(ids)),
            tref.array_bitset_probe(_t(a), _t(ac), _t(w)),
            tref.array_pair_masks(_t(a), _t(ac), _t(b), _t(bc)),
            tref.array_intersect_count(_t(a), _t(ac), _t(b), _t(bc))]
    for g, v in zip(got, want):
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        v if isinstance(v, tuple) else (v,)):
            assert torch.equal(x, y)
    assert tpair.launches == 0 and tarray.launches == 0


@pytest.mark.parametrize("backend", [None, "ref"])
def test_ops_switch_on_cpu(backend):
    a, ac, b, bc = _array_pairs(17)
    rng = np.random.default_rng(17)
    w = _words(rng, 8)
    ids = [0, 1, 2, 3, 7, -1, 0, 1]                   # a plain list
    tw, tc = tops.bitset_pair_op(_t(w), _t(w[::-1]), ids, backend=backend)
    want = tref.bitset_pair_op(_t(w), _t(w[::-1]),
                               torch.tensor(ids, dtype=torch.int32))
    assert torch.equal(tw, want[0]) and torch.equal(tc, want[1])
    assert torch.equal(tops.bitset_pair_card(_t(w), _t(w[::-1]), ids,
                                             backend=backend), want[1])
    pm, pc = tops.array_bitset_probe(_t(a), _t(ac), _t(w), backend=backend)
    assert torch.equal(pc, tref.array_bitset_probe(_t(a), _t(ac),
                                                   _t(w))[1])
    ma, mb, c = tops.array_pair_masks(_t(a), _t(ac), _t(b), _t(bc),
                                      backend=backend)
    assert torch.equal(tops.array_intersect_card(
        _t(a), _t(ac), _t(b), _t(bc), backend=backend), c)


def test_forced_cuda_backend_raises_on_cpu_tensors():
    z = torch.zeros((2, WORDS), dtype=torch.int32)
    v = torch.zeros((2, CAP), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: tops.bitset_pair_op(z, z, c, backend="cuda"),
                 lambda: tops.bitset_pair_card(z, z, c, backend="cuda"),
                 lambda: tops.array_bitset_probe(v, c, z, backend="cuda"),
                 lambda: tops.array_pair_masks(v, c, v, c, backend="cuda"),
                 lambda: tops.array_intersect_card(v, c, v, c,
                                                   backend="cuda")):
        with pytest.raises(ValueError, match="cuda"):
            call()


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a GPU raises in the
    launch path instead of being computed by the plain version."""
    meta = dict(dtype=torch.int32, device="meta")
    z = torch.zeros((2, WORDS), **meta)
    v = torch.zeros((2, CAP), **meta)
    c = torch.zeros(2, **meta)
    for call in (lambda: tpair.bitset_pair_op(z, z, c),
                 lambda: tpair.bitset_pair_card(z, z, c),
                 lambda: tpair.array_bitset_probe(v, c, z),
                 lambda: tarray.array_pair_masks(v, c, v, c),
                 lambda: tarray.array_intersect_card(v, c, v, c)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_plain_versions_take_zero_rows():
    z = torch.zeros((0, WORDS), dtype=torch.int32)
    v = torch.zeros((0, CAP), dtype=torch.int32)
    c = torch.zeros(0, dtype=torch.int32)
    assert tref.bitset_pair_op(z, z, c)[0].shape == (0, WORDS)
    assert tref.array_bitset_probe(v, c, z)[0].shape == (0, CAP)
    assert tref.array_pair_masks(v, c, v, c)[1].shape == (0, CAP)
    assert tref.array_intersect_count(v, c, v, c).shape == (0,)
