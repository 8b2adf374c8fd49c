"""The port's sorted-array intersection and difference
(``repro_torch.kernels.array_ops.array_intersect`` / ``array_difference``,
``ops.array_intersect`` and the plain ``ref.array_intersect_mask``) against
the JAX package's Pallas kernel run in interpret mode, its jnp oracle and
numpy (``np.intersect1d`` / ``np.setdiff1d``), on the same seeded inputs.

In-contract rows (sorted distinct values in [0, 65535] below cards in [0,
4096]): card pairs (10, 4000), (3000, 3000), (4096, 1), (0, 5) and (5, 0),
and a 4-row batch.  The mask's values are compared, not its dtype: the
JAX ``ref`` gives bool, Pallas and the port int32.  Off-contract inputs are
held against the side ROADMAP Queue 3 names for each: a value of 65537
against ``ref`` (a slot at or above a card never matches), a card outside
[0, 4096] against numpy on the clamped prefix (the difference's count is
the sum of its keep mask), M = 0 against ``ref``.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import array_ops as jarray
from repro.kernels import ref as jref
from repro_torch.kernels import array_ops as tarray
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CAP = tref.ARRAY_CAP


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _rows(pairs, seed):
    """(a, ac, b, bc): per (card_a, card_b) one row of sorted distinct
    values; about half of the smaller side's values also lie in the other
    side, and the slots past each card hold junk."""
    rng = np.random.default_rng(seed)
    m = len(pairs)
    a = rng.integers(0, 1 << 16, (m, CAP)).astype(np.int32)
    b = rng.integers(0, 1 << 16, (m, CAP)).astype(np.int32)
    for r, (ca, cb) in enumerate(pairs):
        x = np.sort(rng.choice(1 << 16, ca, replace=False))
        pool = np.setdiff1d(np.arange(1 << 16), x)
        shared = rng.choice(x, min(ca, cb) // 2, replace=False) if ca else []
        y = np.union1d(shared, rng.choice(pool, cb - len(shared),
                                          replace=False))
        a[r, :ca], b[r, :cb] = x, y
    ac = np.array([p[0] for p in pairs], np.int32)
    bc = np.array([p[1] for p in pairs], np.int32)
    return a, ac, b, bc


def _numpy(a, ac, b, bc):
    """Mask, count, keep and difference count from np.intersect1d /
    np.setdiff1d on each row's valid prefix (cards clamped)."""
    m = a.shape[0]
    mask = np.zeros((m, CAP), np.int32)
    keep = np.zeros((m, CAP), np.int32)
    count = np.zeros(m, np.int32)
    diff = np.zeros(m, np.int32)
    for r in range(m):
        na, nb = np.clip([ac[r], bc[r]], 0, CAP)
        x, y = a[r, :na], b[r, :nb]
        inter = np.intersect1d(x, y)
        mask[r, :na] = np.isin(x, inter)
        keep[r, :na] = np.isin(x, np.setdiff1d(x, y))
        count[r], diff[r] = inter.size, np.setdiff1d(x, y).size
    return mask, count, keep, diff


CASES = {"10x4000": [(10, 4000)], "3000x3000": [(3000, 3000)],
         "4096x1": [(4096, 1)], "0x5": [(0, 5)], "5x0": [(5, 0)],
         "batch4": [(64, 70), (1, 1), (4096, 4096), (900, 30)]}


@pytest.mark.parametrize("case", list(CASES))
def test_array_intersect_matches_jax_and_numpy(case):
    a, ac, b, bc = _rows(CASES[case], len(case))
    if case == "4096x1":
        b[0, 0] = a[0, 1234]                       # the one value is in A
    if case == "batch4":
        b[1, 0] = a[1, 0]                          # (1, 1) equal
    mask, count, keep, diff = _numpy(a, ac, b, bc)
    tm, tc = tarray.array_intersect(_t(a), _t(ac), _t(b), _t(bc))
    assert tm.dtype == torch.int32 and tc.dtype == torch.int32
    assert np.array_equal(tm.numpy(), mask)
    assert np.array_equal(tc.numpy(), count)
    args = [jnp.asarray(x) for x in (a, ac, b, bc)]
    jm, jc = jref.array_intersect_mask(*args)
    assert np.array_equal(tm.numpy(), np.asarray(jm))      # bool vs 0/1
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    pm, pc = jarray.array_intersect(*args, interpret=True)
    assert np.array_equal(tm.numpy(), np.asarray(pm))
    assert np.array_equal(tc.numpy(), np.asarray(pc))
    tk, td = tarray.array_difference(_t(a), _t(ac), _t(b), _t(bc))
    assert np.array_equal(tk.numpy(), keep)
    assert np.array_equal(td.numpy(), diff)
    pk, pd = jarray.array_difference(*args, interpret=True)
    assert np.array_equal(tk.numpy(), np.asarray(pk))
    assert np.array_equal(td.numpy(), np.asarray(pd))
    if case == "4096x1":
        assert list(tc.numpy()) == [1] and list(td.numpy()) == [4095]
    if case in ("0x5", "5x0"):
        assert list(tc.numpy()) == [0] and not tm.numpy().any()


def test_padding_value_never_matches_as_in_the_jax_ref():
    """A = [5, 7, 65537] and B = [5, 9] (B's slots past its card hold
    65537, the Pallas sentinel): only 5 matches, as in
    ``ref.array_intersect_mask``; the Pallas kernel also matches 65537."""
    a = np.zeros((1, CAP), np.int32)
    b = np.full((1, CAP), 65537, np.int32)
    a[0, :3] = [5, 7, 65537]
    b[0, :2] = [5, 9]
    ac, bc = np.array([3], np.int32), np.array([2], np.int32)
    jm, jc = jref.array_intersect_mask(*[jnp.asarray(x)
                                         for x in (a, ac, b, bc)])
    for backend in (None, "ref"):
        tm, tc = tops.array_intersect(_t(a), _t(ac), _t(b), _t(bc),
                                      backend=backend)
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        assert list(tm.numpy()[0, :4]) == [1, 0, 0, 0]
        assert list(tc.numpy()) == list(np.asarray(jc)) == [1]
    keep, diff = tarray.array_difference(_t(a), _t(ac), _t(b), _t(bc))
    assert list(keep.numpy()[0, :4]) == [0, 1, 1, 0]
    assert list(diff.numpy()) == [2]


def test_cards_outside_the_range_act_clamped():
    """A card below 0 or above 4,096 acts clamped: the mask and keep are 0
    at and above the clamped card, and the difference's count is the sum
    of keep, clamp(a_card) - |A ∩ B| (the JAX function returns a_card -
    |A ∩ B|, which is -1 for a_card = -1)."""
    a, ac, b, bc = _rows([(4096, 300), (50, 4096), (20, 30), (4096, 4096)],
                         5)
    ac_off = np.array([5000, -1, 20, 4096], np.int32)
    bc_off = np.array([300, 9999, -7, 2**31 - 1], np.int32)
    mask, count, keep, diff = _numpy(a, ac_off, b, bc_off)
    tm, tc = tarray.array_intersect(_t(a), _t(ac_off), _t(b), _t(bc_off))
    assert np.array_equal(tm.numpy(), mask)
    assert np.array_equal(tc.numpy(), count)
    tk, td = tarray.array_difference(_t(a), _t(ac_off), _t(b), _t(bc_off))
    assert np.array_equal(tk.numpy(), keep)
    assert np.array_equal(td.numpy(), diff)
    assert np.array_equal(td.numpy(), tk.numpy().sum(axis=1))
    assert td.numpy()[1] == 0 and td.numpy()[0] == 4096 - count[0]


def test_zero_rows_follow_the_jax_ref():
    z = np.zeros((0, CAP), np.int32)
    c = np.zeros(0, np.int32)
    jm, jc = jref.array_intersect_mask(*[jnp.asarray(x)
                                         for x in (z, c, z, c)])
    for backend in (None, "ref"):
        tm, tc = tops.array_intersect(_t(z), _t(c), _t(z), _t(c),
                                      backend=backend)
        assert tm.shape == tuple(jm.shape) and tc.shape == tuple(jc.shape)
    keep, diff = tarray.array_difference(_t(z), _t(c), _t(z), _t(c))
    assert keep.shape == (0, CAP) and diff.shape == (0,)


def test_plain_row_chunks_agree(monkeypatch):
    """The plain searches' row chunks: chunks of 3 rows give the masks and
    counts of one pass, for every function built on them."""
    a, ac, b, bc = _rows([(64, 70), (1, 1), (4096, 4096), (900, 30),
                          (0, 5), (3000, 3000), (10, 4000)], 9)
    args = [_t(x) for x in (a, ac, b, bc)]
    want = (tref.array_intersect_mask(*args), tref.array_pair_masks(*args),
            tref.array_intersect_count(*args))
    monkeypatch.setattr(tref, "_ARRAY_CHUNK", 3)
    got = (tref.array_intersect_mask(*args), tref.array_pair_masks(*args),
           tref.array_intersect_count(*args))
    for g, w in zip(got, want):
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(x, y)
    assert torch.equal(want[0][0], want[1][0])       # A side == mask_a
    assert torch.equal(want[0][1], want[2])


@pytest.mark.parametrize("backend", [None, "ref"])
def test_ops_switch_on_cpu(backend):
    a, ac, b, bc = _rows(CASES["batch4"], 4)
    args = [_t(x) for x in (a, ac, b, bc)]
    tarray.reset_launches()
    got = tops.array_intersect(*args, backend=backend)
    want = tref.array_intersect_mask(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tarray.launches == 0
    assert tarray.launches_by_kernel["array_intersect"] == 0


def test_forced_cuda_backend_raises_on_cpu_tensors():
    v = torch.zeros((2, CAP), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tops.array_intersect(v, c, v, c, backend="cuda")


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a GPU raises in the
    launch path instead of being computed by the plain version."""
    meta = dict(dtype=torch.int32, device="meta")
    v = torch.zeros((2, CAP), **meta)
    c = torch.zeros(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tarray.array_intersect(v, c, v, c)
    with pytest.raises(ValueError, match="CUDA"):
        tarray.array_difference(v, c, v, c)
