"""The port's numpy twins against the JAX package's: ``data/synth.py``
(the Table 3 dataset twins and the ClusterData generator: for the same
seed every array bit-equal, dtype included) and ``core/scalar.py`` (the
section 5.10 scalar ablation: every function equal to the JAX package's
on seeded inputs, and to the vectorized containers and the port's
``RoaringBitmap`` algebra on the CPU).  Integer work: exact everywhere.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import scalar as jscalar
from repro.data import synth as jsynth
from repro_torch.core import RoaringBitmap, pairwise, scalar
from repro_torch.core import containers as C
from repro_torch.data import synth

OPS = ("and", "or", "xor", "andnot")
SET_OPS = {"and": scalar.intersect, "or": scalar.union,
           "xor": scalar.symmetric_difference, "andnot": scalar.difference}
J_SET_OPS = {"and": jscalar.intersect, "or": jscalar.union,
             "xor": jscalar.symmetric_difference,
             "andnot": jscalar.difference}


def _same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ synth
def test_table3_specs_are_the_same():
    assert [dataclasses.astuple(s) for s in synth.TABLE3] == \
        [dataclasses.astuple(s) for s in jsynth.TABLE3]


@pytest.mark.parametrize("i", range(len(jsynth.TABLE3)))
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_dataset_is_bit_equal(i, seed):
    """Each Table 3 twin at 6 sets (the generator draws set by set, so the
    first sets of the full 200 are these)."""
    spec = dataclasses.replace(synth.TABLE3[i], n_sets=6)
    jspec = dataclasses.replace(jsynth.TABLE3[i], n_sets=6)
    got = synth.generate_dataset(spec, seed)
    _same_arrays(got, jsynth.generate_dataset(jspec, seed))
    for arr in got:
        assert arr.dtype == np.uint32 and arr.size >= 1
        assert (np.diff(arr.astype(np.int64)) > 0).all()
        assert int(arr[-1]) < spec.universe


def test_generate_set_is_bit_equal():
    for spec, jspec in zip(synth.TABLE3, jsynth.TABLE3):
        a = synth.generate_set(spec, np.random.default_rng(3))
        b = jsynth.generate_set(jspec, np.random.default_rng(3))
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,universe,f", [(1, 100, 0.1), (5_000, 10**6, 0.1),
                                          (200_000, 10**7, 0.3)])
@pytest.mark.parametrize("seed", [0, 11])
def test_cluster_data_is_bit_equal(n, universe, f, seed):
    a = synth.cluster_data(n, universe, seed, f)
    b = jsynth.cluster_data(n, universe, seed, f)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert int(a[-1]) < universe


def test_clusterdata_sets_are_bit_equal():
    kw = dict(n_sets=4, values_per_set=1_000_000, universe=10**8, seed=5,
              scale=0.01)
    _same_arrays(synth.clusterdata_sets(**kw), jsynth.clusterdata_sets(**kw))


# ----------------------------------------------------------------- scalar
def _words(rng, density):
    bits = rng.random(1 << 16) < density
    return np.packbits(bits, bitorder="little").view(np.uint64).copy()


def _chunk_sets(rng, n=6):
    """Sorted uint16 value arrays of several densities, empty included."""
    sizes = [0, 1, 37, 1_500, 4_096, 20_000][:n]
    return [np.sort(rng.choice(1 << 16, s, replace=False)).astype(np.uint16)
            for s in sizes]


def test_popcount64():
    rng = np.random.default_rng(1)
    words = [0, 1, (1 << 64) - 1, 1 << 63] + [
        int(w) for w in rng.integers(0, 1 << 63, 500, dtype=np.uint64)
        * np.uint64(2) + rng.integers(0, 2, 500, dtype=np.uint64)]
    for w in words:
        assert scalar.popcount64(w) == jscalar.popcount64(w) \
            == bin(w).count("1")


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
def test_bitset_popcount(density):
    w = _words(np.random.default_rng(2), density)
    assert scalar.bitset_popcount(w) == jscalar.bitset_popcount(w) \
        == C.popcount_words(w)


@pytest.mark.parametrize("op", OPS)
def test_bitset_op(op):
    rng = np.random.default_rng(3)
    a, b = _words(rng, 0.4), _words(rng, 0.2)
    words, card = scalar.bitset_op(a, b, op)
    jwords, jcard = jscalar.bitset_op(a, b, op)
    want = {"and": a & b, "or": a | b, "xor": a ^ b, "andnot": a & ~b}[op]
    assert words.dtype == np.uint64
    assert np.array_equal(words, jwords) and np.array_equal(words, want)
    assert card == jcard == C.popcount_words(want)


@pytest.mark.parametrize("op", OPS)
def test_sorted_set_ops_match_jax_and_the_bitmap_algebra(op):
    """The two-pointer merges against JAX's, numpy's set ops and the
    port's RoaringBitmap algebra (``merge_one`` on the CPU) on every pair
    of one chunk's seeded sets."""
    rng = np.random.default_rng(4)
    sets = _chunk_sets(rng)
    for a in sets:
        for b in sets:
            got = SET_OPS[op](a, b)
            assert got.dtype == np.uint16
            assert np.array_equal(got, J_SET_OPS[op](a, b))
            want = {"and": np.intersect1d, "or": np.union1d,
                    "xor": np.setxor1d, "andnot": np.setdiff1d}[op](a, b)
            assert np.array_equal(got, want)
            bm = pairwise.merge_one(RoaringBitmap.from_values(a),
                                    RoaringBitmap.from_values(b), op,
                                    device="cpu")
            assert np.array_equal(bm.to_array(), got.astype(np.uint32))


@pytest.mark.parametrize("density", [0.0, 0.0005, 0.2, 1.0])
def test_bitset_to_positions(density):
    w = _words(np.random.default_rng(5), density)
    got = scalar.bitset_to_positions(w)
    assert np.array_equal(got, jscalar.bitset_to_positions(w))
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    assert np.array_equal(got, np.nonzero(bits)[0].astype(np.uint16))


def test_bitset_set_many():
    rng = np.random.default_rng(6)
    base = _words(rng, 0.1)
    values = rng.integers(0, 1 << 16, 3_000).astype(np.uint16)
    values[:5] = values[5]                       # duplicates
    w, jw, vw = base.copy(), base.copy(), base.copy()
    delta = scalar.bitset_set_many(w, values)
    assert delta == jscalar.bitset_set_many(jw, values) \
        == C.bitset_set_many(vw, values)
    assert np.array_equal(w, jw) and np.array_equal(w, vw)
