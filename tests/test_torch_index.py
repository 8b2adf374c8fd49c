"""The port's InvertedIndex on the CPU: the boolean half of the
unknown-term / empty-input contract of ``tests/data/test_index_contract.py``,
and seeded indexes whose query results equal the JAX package's, with and
without an arena, built through ``repro_torch.convert.index_from_parts``.
"""

import numpy as np
import pytest

from repro.core import BitmapArena as JArena
from repro.data.index import InvertedIndex as JIndex
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.data.index import InvertedIndex

GHOST = "no-such-term"
CPU = "cpu"


def _docs(seed, n_docs=500, vocab=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    return [[words[j] for j in rng.choice(vocab, size=int(rng.integers(2, 8)),
                                          replace=False)]
            for _ in range(n_docs)]


@pytest.fixture(scope="module")
def index():
    return InvertedIndex(device=CPU).build(_docs(5))


UNKNOWN_CALLS = [
    ("query_and", lambda ix: ix.query_and(GHOST)),
    ("query_and_mixed", lambda ix: ix.query_and("w0", GHOST)),
    ("query_or", lambda ix: ix.query_or(GHOST, GHOST + "2")),
    ("query_xor", lambda ix: ix.query_xor(GHOST, GHOST + "2")),
    ("query_andnot_keep", lambda ix: ix.query_andnot(GHOST, "w0")),
    ("query_threshold", lambda ix: ix.query_threshold([GHOST, GHOST], 1)),
    ("query_threshold_weighted",
     lambda ix: ix.query_threshold([GHOST, GHOST], 2, weights=[2, 3])),
]
EMPTY_CALLS = [
    ("query_and", lambda ix: ix.query_and()),
    ("query_or", lambda ix: ix.query_or()),
    ("query_xor", lambda ix: ix.query_xor()),
    ("query_andnot_no_drops", lambda ix: ix.query_andnot(GHOST)),
    ("query_threshold", lambda ix: ix.query_threshold([], 1)),
]


@pytest.mark.parametrize("name,call", UNKNOWN_CALLS + EMPTY_CALLS,
                         ids=[n for n, _ in UNKNOWN_CALLS + EMPTY_CALLS])
def test_unknown_or_empty_inputs_give_empty_bitmap(index, name, call):
    out = call(index)
    assert isinstance(out, RoaringBitmap)
    assert out.cardinality == 0


def test_unknown_drops_subtract_nothing(index):
    assert index.query_andnot("w0", GHOST) == index.query_or("w0")


def test_unknown_terms_pin_no_arena_rows():
    arena = BitmapArena(device=CPU)
    ix = InvertedIndex(arena=arena).build(_docs(6))
    ix.query_or("w1", GHOST)
    assert arena.n_rows == 1 + len(ix.postings["w1"].containers)


def _twins(seed, n_docs, vocab, arena):
    """A JAX-package index and the port's twin over the same postings,
    both through ``from_postings`` (with an arena: one bulk adoption)."""
    jx = JIndex().build(_docs(seed, n_docs, vocab)).optimize()
    parts = {t: convert.bitmap_to_parts(b) for t, b in jx.postings.items()}
    jx = JIndex.from_postings(jx.postings, jx.n_docs,
                              arena=JArena() if arena else None)
    tx = convert.index_from_parts(
        parts, jx.n_docs, arena=BitmapArena(device=CPU) if arena else None,
        device=None if arena else CPU)
    return jx, tx


def _queries(rng, vocab, n=12):
    words = [f"w{i}" for i in range(vocab)]
    for _ in range(n):
        k = int(rng.integers(2, 6))
        terms = list(rng.choice(words, k, replace=False))
        yield "and", (terms,)
        yield "or", (terms,)
        yield "xor", (terms,)
        yield "andnot", (terms,)
        yield "threshold", (terms, int(rng.integers(1, k + 1)), None)
        w = [int(x) for x in rng.integers(1, 5, k)]
        yield "threshold", (terms, int(rng.integers(1, sum(w) + 1)), w)


def _run(ix, op, args):
    if op == "threshold":
        terms, t, w = args
        return ix.query_threshold(terms, t, weights=w)
    terms = args[0]
    if op == "andnot":
        return ix.query_andnot(terms[0], *terms[1:])
    return getattr(ix, f"query_{op}")(*terms)


@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("seed,n_docs,vocab", [(1, 150_000, 12),
                                               (2, 3_000, 30)])
def test_queries_match_jax(seed, n_docs, vocab, arena):
    jx, tx = _twins(seed, n_docs, vocab, arena)
    assert tx.n_docs == jx.n_docs
    assert tx.memory_bytes() == jx.memory_bytes()
    rng = np.random.default_rng(seed)
    for op, args in _queries(rng, vocab):
        want = _run(jx, op, args)
        got = _run(tx, op, args)
        assert convert.bitmap_to_parts(got)[:2] == \
            convert.bitmap_to_parts(want)[:2], (op, args)
        assert np.array_equal(got.to_array(), want.to_array()), (op, args)
    if arena:
        assert tx.arena.stats.as_dict() == jx.arena.stats.as_dict()


def test_add_document_and_requery_match_jax():
    jx, tx = _twins(3, 2_000, 10, arena=True)
    for ix in (jx, tx):
        ix.query_or("w1", "w2", "w3")
        ix.add_document(70_000, ["w1", "w9"])
    for terms in (("w1", "w2", "w3"), ("w1", "w9")):
        assert np.array_equal(tx.query_or(*terms).to_array(),
                              jx.query_or(*terms).to_array())
    assert tx.arena.stats.as_dict() == jx.arena.stats.as_dict()
    assert tx.n_docs == jx.n_docs == 70_001


def test_index_device_follows_arena():
    arena = BitmapArena(device=CPU)
    assert InvertedIndex(arena=arena).device == arena.device
    with pytest.raises(ValueError):
        InvertedIndex(arena=arena, device="meta")
