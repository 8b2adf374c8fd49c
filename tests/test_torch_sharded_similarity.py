"""The port's sharded similarity top-k on the CPU, in one process:
``SimilarityEngine(mesh=)`` and ``InvertedIndex.similar(mesh=)`` over the
arena's per-shard slabs, on a ``WideMesh`` of S CPU devices, against the
JAX package's single-device engine (its own sharded tests hold its sharded
runs to the same).

The corpus is the JAX package's sharded test corpus (41 bitmaps and one
empty one, seed 0xB17).  Member, bitmap and empty queries under every
metric and k in {1, 5, n}; tie groups that straddle the shards at the k
cut; warm re-queries that upload no row; an edit and ``refresh`` that
patch one row on one shard; ``topk_batch``; the 1-shard mesh and the
missing arena.  The tolerance is 0: indices and intersections equal,
float32 scores bit-identical.
"""

import numpy as np
import pytest

from repro.core import RoaringBitmap as JBitmap
from repro.core.pairwise import SimilarityEngine as JEngine
from repro.data.index import InvertedIndex as JIndex
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.core.pairwise import METRICS, SimilarityEngine
from repro_torch.data.index import InvertedIndex
from repro_torch.dist import WideMesh

CPU = "cpu"
UNIVERSE = 300_000


def _mesh(s):
    return WideMesh([CPU] * s)


def _twin(jbm):
    return convert.bitmap_from_parts(*convert.bitmap_to_parts(jbm))


def _corpus():
    rng = np.random.default_rng(0xB17)
    jb = []
    for _ in range(41):
        n = int(rng.integers(0, 6000))
        jb.append(JBitmap.from_values(np.unique(rng.choice(
            UNIVERSE, size=n, replace=False)).astype(np.uint32)))
    jb.append(JBitmap())                          # an empty candidate
    q = np.unique(rng.choice(UNIVERSE, 4000, replace=False)).astype(
        np.uint32)
    return jb, [_twin(b) for b in jb], q


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w), (g, w)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_engine_matches_jax(s, metric):
    jb, tb, qv = _corpus()
    jeng = JEngine(jb)
    eng = SimilarityEngine(tb, arena=BitmapArena(device=CPU), mesh=_mesh(s))
    assert (eng._mesh is None) == (s == 1)
    queries = [(0, 0), (7, 7), (41, 41),
               (JBitmap.from_values(qv), RoaringBitmap.from_values(qv)),
               (JBitmap(), RoaringBitmap())]
    for jq, tq in queries:
        for k in (1, 5, len(jb)):
            want = jeng.topk(jq, k, metric)
            _same(eng.topk(tq, k, metric), want)
            _same(eng.topk(tq, k, metric, backend="ref"), want)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_tie_groups_straddle_shards(s):
    """Identical candidates at consecutive global indices (their homes
    t % S cycle through every shard), k cutting inside the group: the
    lowest global indices win, in order, as on one device."""
    jb, _, _ = _corpus()
    vals = np.unique(np.random.default_rng(5).choice(
        UNIVERSE, 500, replace=False)).astype(np.uint32)
    jties = [JBitmap.from_values(vals) for _ in range(2 * s + 1)] + jb[:9]
    eng = SimilarityEngine([_twin(b) for b in jties],
                           arena=BitmapArena(device=CPU), mesh=_mesh(s))
    jeng = JEngine(jties)
    q = RoaringBitmap.from_values(vals)
    for k in (2, s, 2 * s):
        got = eng.topk(q, k, "jaccard")
        _same(got, jeng.topk(JBitmap.from_values(vals), k, "jaccard"))
        assert got[0].tolist() == list(range(k))
        assert np.all(got[1] == got[1][0])


def test_warm_requery_uploads_nothing_and_refresh_patches_one_shard():
    jb, tb, qv = _corpus()
    arena = BitmapArena(device=CPU)
    mesh = _mesh(4)
    eng = SimilarityEngine(tb, arena=arena, mesh=mesh)
    eng.topk(3, 10)                               # builds the shard slabs
    shards = arena.shard_slabs(mesh)
    up0 = [st.rows_uploaded for st in shards.stats]
    g0 = [st.device_gathers for st in shards.stats]
    q = RoaringBitmap.from_values(qv)
    for metric in ("jaccard", "cosine"):
        eng.topk(3, 10, metric)
        eng.topk(q, 10, metric)
    assert [st.rows_uploaded for st in shards.stats] == up0
    assert all(b > a for a, b in zip(g0, (st.device_gathers
                                           for st in shards.stats)))
    assert arena.stats.rows_uploaded == 0         # the slab: never built
    tb[5].add(UNIVERSE - 1)
    jb[5].add(UNIVERSE - 1)
    assert eng.refresh()
    p0 = [st.rows_patched for st in shards.stats]
    got = eng.topk(5, 7, "jaccard")
    deltas = [st.rows_patched - p for st, p in zip(shards.stats, p0)]
    assert sum(deltas) == 1 and max(deltas) == 1
    _same(got, JEngine(jb).topk(5, 7, "jaccard"))


def test_mutation_interleave_and_batch():
    jb, tb, qv = _corpus()
    rng = np.random.default_rng(11)
    eng = SimilarityEngine(tb, arena=BitmapArena(device=CPU),
                           mesh=_mesh(3))
    for step in range(6):
        t = int(rng.integers(0, len(tb) - 1))
        v = int(rng.integers(0, 1 << 20))
        tb[t].add(v)
        jb[t].add(v)
        eng.refresh()
        q = int(rng.integers(0, len(tb)))
        k = int(rng.integers(1, 12))
        metric = METRICS[step % 3]
        _same(eng.topk(q, k, metric), JEngine(jb).topk(q, k, metric))
    batch_t = [0, 1, RoaringBitmap.from_values(qv), len(tb) - 1]
    batch_j = [0, 1, JBitmap.from_values(qv), len(jb) - 1]
    for got, want in zip(eng.topk_batch(batch_t, 6, "jaccard"),
                         JEngine(jb).topk_batch(batch_j, 6, "jaccard")):
        _same(got, want)


def _docs():
    rng = np.random.default_rng(0xB17)
    return [[f"t{j}" for j in rng.choice(50, rng.integers(2, 12))]
            for _ in range(3000)]


@pytest.mark.parametrize("s", [1, 2, 4])
def test_similar_mesh_matches_jax(s):
    docs = _docs()
    jx = JIndex().build(docs)
    ix = InvertedIndex(arena=BitmapArena(device=CPU)).build(docs)
    mesh = _mesh(s)
    for term, k, metric in (("t1", 8, "jaccard"), ("t1", 8, "cosine"),
                            ("t3", 50, "containment"), ("absent", 8,
                                                        "jaccard")):
        assert ix.similar(term, k, metric, mesh=mesh) == \
            jx.similar(term, k, metric)
    if s > 1:
        assert mesh in ix._sim_sharded            # cached per mesh
        assert ix._sim_engine(mesh)[1] is not ix._sim_engine()[1]


def test_mesh_needs_an_arena():
    with pytest.raises(ValueError, match="arena"):
        SimilarityEngine([], device=CPU, mesh=_mesh(2))
    ix = InvertedIndex(device=CPU).build([["a", "b"], ["b"]])
    with pytest.raises(ValueError, match="arena"):
        ix.similar("a", 2, mesh=_mesh(2))
    assert ix.similar("a", 2, mesh=_mesh(1)) == ix.similar("a", 2)
