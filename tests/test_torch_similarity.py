"""The port's SimilarityEngine and InvertedIndex.similar against the JAX
package's, on the CPU, on the same seeded postings (both indexes built from
the same numpy parts through ``repro_torch.convert``).

Every route of both packages must return the same bits: the port's None
(the pruned host sweep on the CPU), "ref" (the kernel route with the plain
versions) and "host"; the JAX package's default, "ref" and "pallas" (its
Pallas kernels in interpret mode).  With and without an arena, after
``refresh`` following postings edits, ``topk_batch`` against ``topk``, tie
groups cut by k, and the edge cases: empty candidates, unknown terms, k
clamped, out-of-range members, cardinalities of 2^31.  The tolerance is 0:
indices and intersections equal, float32 scores bit-identical.
"""

import numpy as np
import pytest

from repro.core import BitmapArena as JArena
from repro.core import RoaringBitmap as JBitmap
from repro.core.pairwise import SimilarityEngine as JEngine
from repro.data.index import InvertedIndex as JIndex
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.core.containers import RunContainer
from repro_torch.core.pairwise import METRICS, SimilarityEngine
from repro_torch.data.index import InvertedIndex
from repro_torch.kernels import ops as tops

CPU = "cpu"
T_ROUTES = (None, "ref", "host")


def _values(rng, n_terms=14, universe=1 << 18):
    """Posting values per term: sizes from a few to dense (bitset chunks),
    one run-heavy term, and a duplicate pair that ties exactly."""
    out = {}
    for i in range(n_terms):
        size = int(universe * 0.4 / (i + 1) ** 1.5) + 5
        out[f"t{i}"] = np.unique(rng.integers(0, universe, size,
                                              dtype=np.uint32))
    out["runs"] = np.arange(70_000, 140_000, dtype=np.uint32)
    out["dup"] = out["t3"].copy()
    return out


def _pair(seed, arena=False, **kw):
    """A JAX-package index and the port's over the same postings."""
    vals = _values(np.random.default_rng(seed), **kw)
    jb = {t: JBitmap.from_values(v) for t, v in vals.items()}
    jb["runs"].run_optimize()
    parts = {t: convert.bitmap_to_parts(b) for t, b in jb.items()}
    n_docs = 1 + max(int(v.max()) for v in vals.values())
    jx = JIndex.from_postings(jb, n_docs, arena=JArena() if arena else None)
    tx = convert.index_from_parts(
        parts, n_docs, arena=BitmapArena(device=CPU) if arena else None,
        device=None if arena else CPU)
    return jx, tx


def _same_topk(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        assert np.array_equal(g.view(np.int32) if g.dtype == np.float32
                              else g, w.view(np.int32)
                              if w.dtype == np.float32 else w)


def _same_list(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    assert np.array_equal(np.float32([s for _, s in got]).view(np.int32),
                          np.float32([s for _, s in want]).view(np.int32))


@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_similar_matches_jax_on_every_route(metric, arena):
    jx, tx = _pair(1, arena)
    for term in ("t0", "t5", "t13", "runs", "dup", "no-such-term"):
        for k in (1, 5, 100):
            want = jx.similar(term, k, metric)
            _same_list(jx.similar(term, k, metric, backend="ref"), want)
            for route in T_ROUTES:
                _same_list(tx.similar(term, k, metric, backend=route), want)
    _same_list(tx.similar("t2", 6, metric),
               jx.similar("t2", 6, metric, backend="pallas"))


def test_score_ties_at_k_boundary():
    """Duplicate posting lists tie exactly; ties order by term insertion
    on every route of both packages."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 5000, 800, dtype=np.uint32)
    docs_of = {"q": base, "a": base[:500], "b": base[:500],
               "c": base[:500], "d": base[:500], "e": base[:100]}
    jx = JIndex.from_postings({t: JBitmap.from_values(v)
                               for t, v in docs_of.items()}, 5000)
    tx = convert.index_from_parts(
        {t: convert.bitmap_to_parts(b) for t, b in jx.postings.items()},
        5000, device=CPU)
    for k, names in ((2, ["a", "b"]), (4, ["a", "b", "c", "d"])):
        want = jx.similar("q", k)
        assert [t for t, _ in want] == names
        _same_list(jx.similar("q", k, backend="pallas"), want)
        for route in T_ROUTES:
            _same_list(tx.similar("q", k, backend=route), want)


def _engines(seed, arena=False, n=12):
    rng = np.random.default_rng(seed)
    vals = [np.unique(rng.integers(0, 1 << 18, int(rng.integers(30, 9000)),
                                   dtype=np.uint32)) for _ in range(n)]
    vals[4] = vals[7].copy()                        # an exact tie
    vals[9] = np.zeros(0, np.uint32)                # an empty candidate
    jbs = [JBitmap.from_values(v) for v in vals]
    tbs = [convert.bitmap_from_parts(*convert.bitmap_to_parts(b))
           for b in jbs]
    je = JEngine(jbs, arena=JArena() if arena else None)
    te = SimilarityEngine(tbs, arena=BitmapArena(device=CPU)
                          if arena else None, device=None if arena else CPU)
    q = rng.integers(0, 1 << 18, 4000, dtype=np.uint32)
    return je, te, jbs, tbs, JBitmap.from_values(q), \
        RoaringBitmap.from_values(q)


@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_engine_topk_matches_jax(metric, arena):
    je, te, _, _, jq, tq = _engines(3, arena)
    assert np.array_equal(te.rows, je.rows)
    for jquery, tquery in ((jq, tq), (4, 4), (9, 9), (JBitmap(),
                                                      RoaringBitmap())):
        for k in (1, 3, 11, 50):
            want = je.topk(jquery, k, metric)
            _same_topk(je.topk(jquery, k, metric, backend="ref"), want)
            for route in T_ROUTES:
                _same_topk(te.topk(tquery, k, metric, backend=route), want)


@pytest.mark.parametrize("metric", METRICS)
def test_topk_batch_equals_per_query_topk(metric):
    je, te, _, _, jq, tq = _engines(4)
    tqueries = [0, 7, 11, tq, RoaringBitmap(), 4]
    jqueries = [0, 7, 11, jq, JBitmap(), 4]
    want = [je.topk(q, 6, metric) for q in jqueries]
    for route in T_ROUTES:
        got = te.topk_batch(tqueries, 6, metric, backend=route)
        assert len(got) == len(want)
        for g, w, q in zip(got, want, tqueries):
            _same_topk(g, w)
            _same_topk(g, te.topk(q, 6, metric, backend=route))
    assert te.topk_batch([], 5, backend="ref") == []
    with pytest.raises(ValueError):
        te.topk_batch([0], 5, metric="bogus", backend="ref")
    with pytest.raises(IndexError):
        te.topk_batch([12], 5, backend="ref")


def test_engine_edge_cases():
    _, te, _, _, _, tq = _engines(5)
    idx, _, _ = te.topk(2, 100)                     # k clamps to n - 1
    assert idx.size == 11 and 2 not in idx.tolist()
    for bad in (-1, -2, 12):
        for route in T_ROUTES:
            with pytest.raises(IndexError):
                te.topk(bad, 3, backend=route)
    assert all(a.size == 0 for a in te.topk(tq, 0))
    with pytest.raises(ValueError):
        te.topk(tq, 3, metric="dice")
    one = SimilarityEngine([RoaringBitmap.from_values(np.arange(100))],
                           device=CPU)
    for route in T_ROUTES:
        assert one.topk(0, 5, backend=route)[0].size == 0
        assert one.topk_batch([0], 5, backend=route)[0][0].size == 0


@pytest.mark.parametrize("metric", METRICS)
def test_all_empty_candidates_never_reach_a_kernel(metric, monkeypatch):
    calls = []
    monkeypatch.setattr(tops, "similarity_topk",
                        lambda *a, **k: calls.append(1))
    je = JEngine([JBitmap(), JBitmap(), JBitmap()])
    te = SimilarityEngine([RoaringBitmap()] * 3, device=CPU)
    q = np.arange(10, dtype=np.uint32)
    for jquery, tquery in ((1, 1), (JBitmap.from_values(q),
                                    RoaringBitmap.from_values(q)),
                           (JBitmap(), RoaringBitmap())):
        want = je.topk(jquery, 5, metric)
        for route in T_ROUTES:
            _same_topk(te.topk(tquery, 5, metric, backend=route), want)
    assert calls == []


def test_cardinality_of_2_31_is_refused():
    full = RoaringBitmap(list(range(1 << 15)),
                         [RunContainer(np.array([[0, 65535]]))] * (1 << 15))
    assert full.cardinality == 2**31
    with pytest.raises(ValueError, match="2\\^31"):
        SimilarityEngine([full], device=CPU)
    _, te, _, _, _, _ = _engines(6)
    for route in T_ROUTES:
        with pytest.raises(ValueError, match="2\\^31"):
            te.topk(full, 3, backend=route)


def test_kernel_route_is_one_call_per_query(monkeypatch):
    """On a kernel backend a query is one ``ops.similarity_topk`` call (the
    score and the select launch); the host route makes none."""
    calls = []
    real = tops.similarity_topk

    def spy(*a, **k):
        calls.append(k["backend"])
        return real(*a, **k)

    monkeypatch.setattr(tops, "similarity_topk", spy)
    _, tx = _pair(7)
    tx.similar("t0", 5, backend="ref")
    assert calls == ["ref"]
    calls.clear()
    tx.similar("t1", 5)
    tx.similar("t1", 5, backend="host")
    assert calls == []


def test_arena_view_parity_and_refresh():
    """An arena view answers as a private slab does; after an edit,
    ``refresh`` repatches exactly the edited row and the next kernel query
    gathers again from the patched slab -- the old view, left standing,
    would answer from the old rows."""
    je, te, jbs, tbs, jq, tq = _engines(8, arena=True)
    _, cold, _, _, _, _ = _engines(8)
    for query in (3, tq):
        for route in T_ROUTES:
            _same_topk(te.topk(query, 5, backend=route),
                       cold.topk(query, 5, backend=route))
    je._device()
    old_rows = te._device()[0]
    up0 = te._arena.stats.rows_uploaded
    for bms in (jbs, tbs):
        bms[2].add(1 << 19)                        # a new chunk: one row
        bms[5].add(5)
    stale = [te.topk(tq, 12, backend="ref")]
    assert te.refresh() is True and je.refresh() is True
    assert te.refresh() is False
    fresh_rows = te._device()[0]
    je._device()
    assert fresh_rows is not old_rows
    assert te._arena.stats.rows_uploaded > up0
    assert te._arena.stats.as_dict() == je._arena.stats.as_dict()
    fresh = SimilarityEngine(tbs, device=CPU)
    for route in T_ROUTES:
        _same_topk(te.topk(tq, 12, backend=route), fresh.topk(tq, 12))
        _same_topk(te.topk(tq, 12, backend=route), je.topk(jq, 12))
    assert not all(np.array_equal(a, b) for a, b in
                   zip(stale[0], fresh.topk(tq, 12)))
    with pytest.raises(ValueError, match="arena"):
        cold.refresh()


def test_index_engine_cache_follows_mutations():
    """Without an arena every mutation path drops the cached engine and
    direct postings edits are caught by the snapshot; with one, an edit
    of existing terms refreshes the same engine in place and a new term
    builds a new one.  Answers track the JAX package's throughout."""
    jx, tx = _pair(9)
    _same_list(tx.similar("t0", 4), jx.similar("t0", 4))
    assert tx._sim is not None
    for ix in (jx, tx):
        ix.add_document(300_000, ["t0", "t4"])
    assert tx._sim is None
    _same_list(tx.similar("t0", 4), jx.similar("t0", 4))
    tx.optimize()
    assert tx._sim is None
    for ix, cls in ((jx, JBitmap), (tx, RoaringBitmap)):
        ix.postings["clone"] = cls.from_values(ix.postings["t0"].to_array())
        ix.postings["t1"].add(5_000_000)
    assert tx.similar("t0", 1)[0] == ("clone", 1.0)
    _same_list(tx.similar("t1", 5, "cosine"), jx.similar("t1", 5, "cosine"))
    tx.build([["a", "b"], ["b"]])
    assert tx._sim is None

    jx, tx = _pair(10, arena=True)
    before = tx._sim_engine()[1]
    for ix in (jx, tx):
        ix.similar("t2", 3)
        ix.add_document(9000, ["t1", "t2"])
    assert tx._sim_engine()[1] is before           # refreshed in place
    for route in T_ROUTES:                          # the same routes
        _same_list(tx.similar("t1", 5, backend=route),
                   jx.similar("t1", 5, backend="ref" if route else None))
    for ix in (jx, tx):
        ix.add_document(9001, ["brand_new"])
    assert tx._sim_engine()[1] is not before
    _same_list(tx.similar("t1", 5, backend="ref"),
               jx.similar("t1", 5, backend="ref"))
    assert tx.arena.stats.as_dict() == jx.arena.stats.as_dict()


def test_unknown_term_and_empty_index():
    _, tx = _pair(11)
    got = tx.similar("nope", 3)
    assert len(got) == 3 and all(s == 0.0 for _, s in got)
    assert all(s == 1.0 for _, s in tx.similar("nope", 3, "containment"))
    assert InvertedIndex(device=CPU).similar("x", 5) == []
    with pytest.raises(ValueError):
        tx.similar("t0", 3, metric="dice")
