"""The port's plain conversion and popcount versions
(``repro_torch.kernels.ref``: ``array_to_bitset``, ``bitset_set_many``,
``bitset_to_array``, ``popcount_words``) and their entry points in
``repro_torch.kernels.ops``, against the JAX package's jnp oracles and its
Pallas kernels run in interpret mode, on the same seeded numpy inputs.

In contract (sorted distinct values in [0, 65535], cards in [0, 4096])
both JAX versions agree and the port must equal both; duplicated values
(which ADD, carrying into the next bit) also agree in both.  Off contract
the JAX versions split: for a negative value ``ref.array_to_bitset`` wraps
the word index numpy-style, while the Pallas kernel drops it.  The port
drops it, so those cases are held against Pallas only.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_convert as jconv
from repro.kernels import harley_seal as jhs
from repro.kernels import ref as jref
from repro_torch.kernels import bitset_convert as tconv
from repro_torch.kernels import harley_seal as ths
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

WORDS = tref.WORDS
CAP = tref.ARRAY_CAP


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.astype(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _arrays(rng, cards):
    """(M, CAP) int32 rows of sorted distinct values below their card,
    random values after it (which every version must ignore)."""
    vals = rng.integers(0, 1 << 16, (len(cards), CAP)).astype(np.int32)
    for r, c in enumerate(cards):
        c = min(max(int(c), 0), CAP)
        vals[r, :c] = np.sort(rng.choice(1 << 16, c, replace=False))
    return vals


def _old_words(rng, m):
    w = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    w &= rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    w[::3] = 0
    w[1::3] = 0xFFFFFFFF
    return w


IN_CONTRACT = {
    "edges": np.array([0, 1, CAP, 64, 3000, 2], np.int32),
    "sparse": np.array([64, 70, 1, 0], np.int32),
}


def _jax_both(vals, card):
    """(jnp ref words, Pallas interpret words) as numpy uint32."""
    jv, jc = jnp.asarray(vals), jnp.asarray(card)
    return (np.asarray(jref.array_to_bitset(jv, jc)),
            np.asarray(jconv.array_to_bitset(jv, jc, interpret=True)))


@pytest.mark.parametrize("case", sorted(IN_CONTRACT))
def test_array_to_bitset_matches_jax(case):
    card = IN_CONTRACT[case]
    rng = np.random.default_rng(len(card))
    vals = _arrays(rng, card)
    vals[0, :2] = [0, 65535] if card[0] >= 2 else vals[0, :2]
    want_ref, want_pallas = _jax_both(vals, card)
    got = tref.array_to_bitset(_t(vals), _t(card))
    assert np.array_equal(_u32(got), want_ref)
    assert np.array_equal(_u32(got), want_pallas)
    assert np.array_equal(_u32(tops.array_to_bitset(vals, card)), want_ref)
    assert np.array_equal(
        _u32(tops.array_to_bitset(_t(vals), _t(card), backend="ref")),
        want_ref)
    assert np.array_equal(_u32(tconv.array_to_bitset(_t(vals), _t(card))),
                          want_ref)


def test_array_to_bitset_duplicates_add():
    """A repeated value adds its bit again (8 + 8 carries into bit 4), in
    both JAX versions and the port."""
    vals = np.zeros((3, CAP), np.int32)
    vals[0, :4] = [3, 3, 5, 31]
    vals[1, :3] = [31, 31, 64]                 # 2^31 + 2^31 wraps to 0
    vals[2, :5] = [7, 7, 7, 7, 65535]
    card = np.array([4, 3, 5], np.int32)
    want_ref, want_pallas = _jax_both(vals, card)
    got = _u32(tref.array_to_bitset(_t(vals), _t(card)))
    assert np.array_equal(got, want_ref)
    assert np.array_equal(got, want_pallas)
    assert got[0, 0] == 8 + 8 + 32 + (1 << 31)
    assert got[1, 0] == 0 and got[1, 2] == 1


def test_array_to_bitset_off_contract_matches_pallas():
    """Values outside [0, 65535] drop and cards outside [0, 4096] clamp,
    as in the Pallas kernel.  (The JAX reference wraps a negative word
    index instead: at -1 it sets bit 31 of word 2047, a split in the
    reference, so these cases are held against Pallas only.)"""
    rng = np.random.default_rng(7)
    card = np.array([4, -1, 0, CAP, 5000, 9], np.int32)
    vals = _arrays(rng, card)
    vals[0, :4] = [-1, 3, 3, 70000]
    vals[3, 10:14] = [65536, -33, -2**31, 2**31 - 1]
    vals[5, :9] = [-1, 0, 31, 32, 65535, 65536, 131071, -65536, 5]
    _, want_pallas = _jax_both(vals, card)
    got = _u32(tref.array_to_bitset(_t(vals), _t(card)))
    assert np.array_equal(got, want_pallas)
    assert got[0, 0] == 16 and got[0].sum(dtype=np.uint64) == 16
    assert not got[1].any() and not got[2].any()


def test_array_to_bitset_no_rows():
    z = tref.array_to_bitset(torch.zeros((0, CAP), dtype=torch.int32),
                             torch.zeros(0, dtype=torch.int32))
    assert z.shape == (0, WORDS) and z.dtype == torch.int32
    want = np.asarray(jref.array_to_bitset(jnp.zeros((0, CAP), jnp.int32),
                                           jnp.zeros(0, jnp.int32)))
    assert want.shape == tuple(z.shape)


@pytest.mark.parametrize("case", sorted(IN_CONTRACT) + ["duplicates"])
def test_bitset_set_many_matches_jax(case):
    card = IN_CONTRACT.get(case, np.array([4, 3, 0, 6], np.int32))
    rng = np.random.default_rng(len(case))
    vals = _arrays(rng, card)
    if case == "duplicates":
        vals[0, :4] = [3, 3, 5, 9]
        vals[3, :6] = [64, 64, 64, 100, 100, 65535]
    old = _old_words(rng, len(card))
    jo, jv, jc = jnp.asarray(old), jnp.asarray(vals), jnp.asarray(card)
    rw, rd = jref.bitset_set_many(jo, jv, jc)
    pw, pd = jconv.bitset_set_many(jo, jv, jc, interpret=True)
    tw, td = tref.bitset_set_many(_t(old), _t(vals), _t(card))
    for w, d in ((rw, rd), (pw, pd)):
        assert np.array_equal(_u32(tw), np.asarray(w))
        assert np.array_equal(td.numpy(), np.asarray(d))
    ow, od = tops.bitset_set_many(_t(old), vals, card)
    assert torch.equal(ow, tw) and torch.equal(od, td)
    assert (td.numpy()[1::3] == 0).all()          # all-ones rows: no change


def test_bitset_set_many_off_contract_matches_pallas():
    """Dropped values add nothing and change no count, as in Pallas (the
    JAX reference's delta is 2 here, Pallas's 1)."""
    vals = np.zeros((2, CAP), np.int32)
    vals[0, :4] = [-1, 3, 3, 70000]
    vals[1, :3] = [-1, -1, 65536]
    card = np.array([4, 3], np.int32)
    old = np.zeros((2, WORDS), np.uint32)
    pw, pd = jconv.bitset_set_many(jnp.asarray(old), jnp.asarray(vals),
                                   jnp.asarray(card), interpret=True)
    tw, td = tref.bitset_set_many(_t(old), _t(vals), _t(card))
    assert np.array_equal(_u32(tw), np.asarray(pw))
    assert np.array_equal(td.numpy(), np.asarray(pd))
    assert td.tolist() == [1, 0]


def test_bitset_to_array_matches_jax():
    """Cards 0, 1, below, at and above 4,096 (a row of more bits keeps its
    4,096 smallest), bits 0 and 65535."""
    rng = np.random.default_rng(11)
    m = 7
    words = np.zeros((m, WORDS), np.uint32)
    for r, c in enumerate([0, 1, 64, 4095, CAP, 4097, 40000]):
        pos = rng.choice(1 << 16, c, replace=False)
        np.bitwise_or.at(words[r], pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))
    words[2, 0] |= 1
    words[2, WORDS - 1] |= np.uint32(1 << 31)
    jv, jc = jref.bitset_to_array(jnp.asarray(words))
    tv, tc = tref.bitset_to_array(_t(words))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    ov, oc = tops.bitset_to_array(_t(words))
    assert torch.equal(ov, tv) and torch.equal(oc, tc)
    z = tref.bitset_to_array(torch.zeros((0, WORDS), dtype=torch.int32))
    assert z[0].shape == (0, CAP) and z[1].shape == (0,)


def test_bitset_to_array_inverts_array_to_bitset():
    rng = np.random.default_rng(3)
    card = np.array([0, 1, 17, 4096, 300], np.int32)
    vals = _arrays(rng, card)
    words = tref.array_to_bitset(_t(vals), _t(card))
    got, got_card = tref.bitset_to_array(words)
    assert np.array_equal(got_card.numpy(), card)
    for r, c in enumerate(card):
        assert np.array_equal(got[r, :c].numpy(), vals[r, :c])
        assert (got[r, c:] == tref.CONTAINER_BITS).all()


def test_unpack_and_pack_bits_invert():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, (3, WORDS), dtype=np.uint32)
    bits = tref.unpack_bits(_t(words))
    assert bits.shape == (3, 1 << 16) and bits.dtype == torch.bool
    i = 2 * 32 + 7
    assert bool(bits[1, i]) == bool((words[1, 2] >> 7) & 1)
    assert np.array_equal(_u32(tref.pack_bits(bits)), words)


@pytest.mark.parametrize("m", [0, 1, 8, 13])
def test_popcount_matches_jax(m):
    rng = np.random.default_rng(m)
    words = _old_words(rng, m)
    want = np.asarray(jref.popcount_words(jnp.asarray(words)))
    got = tops.popcount(_t(words))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tops.popcount(_t(words), backend="ref"), got)
    assert torch.equal(ths.popcount(_t(words)), got)
    if m:
        pallas = np.asarray(jhs.popcount(jnp.asarray(words), interpret=True))
        assert np.array_equal(got.numpy(), pallas)


def test_cpu_calls_do_not_count_as_launches():
    tconv.reset_launches()
    ths.reset_launches()
    vals = np.zeros((2, CAP), np.int32)
    card = np.array([1, 0], np.int32)
    tops.array_to_bitset(vals, card)
    tops.bitset_set_many(torch.zeros((2, WORDS), dtype=torch.int32), vals,
                         card)
    tops.popcount(torch.zeros((2, WORDS), dtype=torch.int32))
    assert tconv.launches == 0 and ths.launches == 0
    assert set(tconv.launches_by_kernel) == {"array_to_bitset",
                                             "bitset_set_many"}


def test_cuda_backend_raises_on_cpu_tensors():
    v = torch.zeros((1, CAP), dtype=torch.int32)
    c = torch.zeros(1, dtype=torch.int32)
    w = torch.zeros((1, WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tops.array_to_bitset(v, c, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tops.bitset_set_many(w, v, c, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tops.popcount(w, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tops.popcount(w, backend="pallas")
