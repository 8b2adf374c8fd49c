"""The port's cold start and data path against the JAX package's.

``load_index`` of an archive the JAX package wrote answers every query
class as the JAX package's ``load_index`` does, with and without an arena
(``device="cpu"``), and keeps its postings lazy until a query touches
them.  ``StreamingIndexBuilder`` writes archives byte-identical to the JAX
package's for the same appends (one segment, a multi-segment merge, no
postings at all).  ``RoaringDataPipeline`` draws the JAX package's batches
for the same seed and filters, and each package loads the other's state
dict.  An index mapped read-only from a file answers ``count_and``,
``jaccard``, the plain kernel versions' routes and a point ``add`` with
every warning an error, and the file's bytes stay as they were.
"""

import os
import warnings

import numpy as np
import pytest

from repro.core import BitmapArena as JArena
from repro.core import serde as jserde
from repro.data import index as jindex
from repro.data import pipeline as jpipe
from repro_torch.core import BitmapArena as TArena
from repro_torch.core import RoaringBitmap, aggregate, pairwise
from repro_torch.core import serde as tserde
from repro_torch.data import index as tindex
from repro_torch.data import pipeline as tpipe

N_DOCS = 1 << 19


def _postings(seed=5):
    """Term -> uint32 doc ids over 2^19 documents: dense terms (bitset
    chunks), sparse terms (arrays), run terms and one empty term."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(4):
        out[f"d{i}"] = np.flatnonzero(rng.random(N_DOCS) < 0.1 + 0.1 * i)
    for i in range(12):
        out[f"s{i}"] = np.unique(rng.integers(0, N_DOCS, 600))
    for i in range(3):
        lo = int(rng.integers(0, N_DOCS - 70000))
        out[f"r{i}"] = np.arange(lo, lo + 70000 + 1000 * i)
    out["empty"] = np.zeros(0, np.int64)
    return {k: v.astype(np.uint32) for k, v in out.items()}


def _jax_archive(path):
    from repro.core import RoaringBitmap as JRB
    named = {t: JRB.from_values(v).run_optimize()
             for t, v in _postings().items()}
    jserde.write_snapshot(path, named, meta=N_DOCS)


QUERIES = [("query_and", ("d1", "d2")), ("query_and", ("d0", "s3", "d2")),
           ("query_or", ("s1", "s2", "d0")), ("query_or", ("r0", "r1")),
           ("query_xor", ("d1", "r2", "s4")), ("query_andnot", ("d3", "s1",
                                                                 "r0")),
           ("query_or", ("nope", "s5")), ("query_and", ())]


def _answers(idx, similar=True):
    out = [getattr(idx, fn)(*terms).to_array() for fn, terms in QUERIES]
    out.append(idx.query_threshold(["d0", "d1", "s2", "r1"], 2).to_array())
    out.append(idx.query_threshold(["d0", "d3", "r0"], 3,
                                   weights=[1, 2, 2]).to_array())
    out.append([idx.count_and("d0", "d2"), idx.count_and("s1", "r0"),
                idx.jaccard("d1", "d3"), idx.jaccard("empty", "nope")])
    if similar:
        for metric in ("jaccard", "cosine", "containment"):
            out.append(idx.similar("d1", 5, metric))
            out.append(idx.similar("s7", 3, metric))
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("arena", [False, True])
def test_load_index_of_a_jax_archive_answers_as_jax(tmp_path, arena):
    path = tmp_path / "jax.snap"
    _jax_archive(path)
    jidx = jindex.load_index(path, arena=JArena() if arena else None)
    tidx = tindex.load_index(path, arena=TArena(device="cpu") if arena
                             else None, device="cpu")
    assert tidx.n_docs == jidx.n_docs == N_DOCS
    assert list(tidx.postings) == list(jidx.postings)
    _equal(_answers(tidx), _answers(jidx))
    if arena:
        up0 = tidx.arena.stats.rows_uploaded
        tidx.query_or("d0", "d1")
        assert tidx.arena.stats.rows_uploaded == up0


def test_load_index_keeps_postings_lazy(tmp_path):
    path = tmp_path / "jax.snap"
    _jax_archive(path)
    idx = tindex.load_index(path, device="cpu")
    assert isinstance(idx.postings, tserde.LazyBitmaps)
    assert set(idx.postings._pending) == set(_postings())
    idx.query_and("d0", "s1")
    assert set(idx.postings._pending) == set(_postings()) - {"d0", "s1"}
    eager = tindex.InvertedIndex.from_postings(
        {"a": RoaringBitmap.from_values([1, 2])}, 3, device="cpu")
    assert type(eager.postings) is dict
    with pytest.raises(ValueError):
        (tmp_path / "bad.snap").write_bytes(b"not an archive at all")
        tindex.load_index(tmp_path / "bad.snap", device="cpu")


def _feed(builder, postings, batches):
    """Append every term's ids in ``batches`` interleaved batches (batch
    b takes every ``batches``-th id from the b-th), so every segment holds
    part of every chunk and the merge unions them."""
    for b in range(batches):
        for t, v in postings.items():
            builder.append_postings(t, v[b::batches])
    return builder


@pytest.mark.parametrize("segment_bytes,batches", [(64 << 20, 1),
                                                   (40_000, 4),
                                                   (100_000, 7)])
def test_streaming_archives_match_jax(tmp_path, segment_bytes, batches):
    post = _postings(9)
    jb = _feed(jpipe.StreamingIndexBuilder(tmp_path / "j.snap",
                                           segment_bytes=segment_bytes),
               post, batches)
    tb = _feed(tpipe.StreamingIndexBuilder(tmp_path / "t.snap",
                                           segment_bytes=segment_bytes),
               post, batches)
    assert len(tb._segments) == len(jb._segments)
    assert (len(tb._segments) > 1) == (batches > 1)
    jidx = jb.finalize()
    tidx = tb.finalize(device="cpu")
    assert (tmp_path / "t.snap").read_bytes() == \
        (tmp_path / "j.snap").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["j.snap", "t.snap"]
    assert tidx.n_docs == jidx.n_docs
    for t, v in post.items():
        if v.size:
            assert np.array_equal(tidx.postings[t].to_array(), v)
    _equal(_answers(tidx, similar=False), _answers(jidx, similar=False))


def test_streaming_builder_with_an_arena_and_no_postings(tmp_path):
    tb = tpipe.StreamingIndexBuilder(tmp_path / "e.snap")
    jb = jpipe.StreamingIndexBuilder(tmp_path / "j.snap")
    idx = tb.finalize(arena=TArena(device="cpu"))
    jb.finalize()
    assert (tmp_path / "e.snap").read_bytes() == \
        (tmp_path / "j.snap").read_bytes()
    assert idx.n_docs == 0 and len(idx.postings) == 0
    assert idx.query_and("anything") == RoaringBitmap()
    b = tpipe.StreamingIndexBuilder(tmp_path / "w.snap", segment_bytes=4096)
    for i in range(3000):
        b.add_document(i, [f"t{i % 7}", f"t{i % 3}"])
    assert len(b._segments) > 1
    arena = TArena(device="cpu")
    idx = b.finalize(arena=arena)
    arena.sync()
    up0 = arena.stats.rows_uploaded
    want = [i for i in range(3000) if i % 7 == 2 or i % 3 == 2]
    assert idx.query_or("t2").to_array().tolist() == want
    assert arena.stats.rows_uploaded == up0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.StreamingIndexBuilder(tmp_path / "x.snap").finalize()


def _filters(pkg, n, seed=4):
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, n // 3, n)
    scores = rng.random(n)
    return {"quality": pkg.quality_filter(scores, 0.3),
            "dedup": pkg.dedup_filter(hashes)}


def test_pipeline_batches_and_state_match_jax():
    n = 1 << 17
    args = dict(n_docs=n, seq_len=32, batch_size=64, vocab=1000, seed=7)
    jp = jpipe.RoaringDataPipeline(**args, filters=_filters(jpipe, n))
    tp = tpipe.RoaringDataPipeline(**args, filters=_filters(tpipe, n),
                                   device="cpu")
    assert np.array_equal(tp.keep.to_array(), jp.keep.to_array())
    for _ in range(3):
        jb, tb = jp.next_batch(), tp.next_batch()
        assert set(tb) == set(jb)
        for k in jb:
            assert isinstance(tb[k], np.ndarray)
            assert np.array_equal(tb[k], jb[k])
    assert tp.remaining() == jp.remaining() == jp.keep.cardinality - 192
    # each package loads the other's state dict and draws the same next
    tstate, jstate = tp.state_dict(), jp.state_dict()
    assert tstate["seen"] == jstate["seen"] and tstate["step"] == 3
    jp2 = jpipe.RoaringDataPipeline(**dict(args, seed=99))
    jp2.load_state_dict(tstate)
    tp2 = tpipe.RoaringDataPipeline(**dict(args, seed=99), device="cpu")
    tp2.load_state_dict(jstate)
    want = jp.next_batch()["doc_ids"]
    assert np.array_equal(tp.next_batch()["doc_ids"], want)
    assert np.array_equal(jp2.next_batch()["doc_ids"], want)
    assert np.array_equal(tp2.next_batch()["doc_ids"], want)


def test_pipeline_epoch_has_no_repeats_and_resets():
    p = tpipe.RoaringDataPipeline(n_docs=64, seq_len=8, batch_size=8,
                                  vocab=50, seed=3, device="cpu")
    seen = []
    for _ in range(8):
        seen.extend(p.next_batch()["doc_ids"].tolist())
    assert len(seen) == len(set(seen)) == 64 and p.remaining() == 0
    again = p.next_batch()["doc_ids"]             # a new epoch starts
    assert p.remaining() == 56 and len(set(again.tolist())) == 8


def test_mapped_index_is_read_only_safe(tmp_path):
    path = tmp_path / "jax.snap"
    _jax_archive(path)
    raw = path.read_bytes()
    idx = tindex.load_index(path, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert idx.count_and("d0", "d1") == \
            jindex.load_index(path).count_and("d0", "d1")
        idx.jaccard("s1", "r0")
        d0, s1, r0 = (idx.postings[t] for t in ("d0", "s1", "r0"))
        # the routes through the plain kernel versions (tensors made from
        # container views), as on the card
        for op in ("and", "or", "xor", "andnot"):
            for x, y in ((d0, s1), (s1, r0), (d0, idx.postings["d2"]),
                         (s1, idx.postings["s2"])):
                got = pairwise.merge_one(x, y, op, backend="ref",
                                         device="cpu")
                assert got == pairwise.merge_one(x, y, op, device="cpu")
        RoaringBitmap.pairwise_card("and", [(d0, s1), (s1, r0), (d0, r0)],
                                    backend="ref", device="cpu")
        aggregate.or_many([d0, s1, r0], backend="ref", device="cpu")
        idx.similar("d0", 3, backend="ref")
        s1.add(N_DOCS - 1)
        d0.add(5)
        d0.remove(int(d0.to_array()[3]))
    assert path.read_bytes() == raw
