"""Analytics on the PyTorch/CUDA port: an inverted index over synthetic
postings lists -- the paper's home application (Druid/Lucene-style
predicate algebra).

    PYTHONPATH=src python examples/torch_analytics_index.py         # the card
    PYTHONPATH=src python examples/torch_analytics_index.py --device cpu

The same walk-through as ``examples/analytics_index.py``, through
``repro_torch``: boolean and threshold queries (one segmented-reduce
launch each on the card), count-only Jaccard, similarity top-k, the
device-resident arena, sharded similarity, the snapshot archive and its
cold start, and a Table-3 twin dataset.  ``--shards N`` puts N arena
shards on the one device; by default they span up to four cards.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.data.index import InvertedIndex, load_index
from repro_torch.data.pipeline import StreamingIndexBuilder
from repro_torch.data.synth import TABLE3, generate_dataset
from repro_torch.dist import WideMesh
from repro_torch.kernels.ops import resolve_device


def synthetic_docs(n_docs: int, n_terms: int, seed: int = 1) -> list:
    """Documents of 5-29 distinct terms ``t<i>`` drawn with Zipf(0.8)
    weights from a seeded generator (the JAX example's inputs)."""
    rng = np.random.default_rng(seed)
    zipf = (1.0 / np.arange(1, n_terms + 1)) ** 0.8
    zipf /= zipf.sum()
    return [[f"t{t}" for t in rng.choice(n_terms, size=rng.integers(5, 30),
                                         p=zipf, replace=False)]
            for _ in range(n_docs)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--terms", type=int, default=120)
    ap.add_argument("--shards", type=int, default=0,
                    help="arena shards on the one device (default: one a "
                         "card, up to four)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    n_docs = args.docs
    docs = synthetic_docs(n_docs, args.terms)
    t0 = time.perf_counter()
    idx = InvertedIndex(device=dev).build(docs).optimize()
    print(f"indexed {n_docs} docs / {len(idx.postings)} terms "
          f"in {time.perf_counter() - t0:.2f}s, "
          f"{idx.memory_bytes() / 1024:.0f} kB of postings")

    q = ("t0", "t1", "t2")
    t0 = time.perf_counter()
    hits_and = idx.query_and(*q)
    hits_or = idx.query_or(*q)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"AND({q}) = {hits_and.cardinality} docs; "
          f"OR = {hits_or.cardinality} docs  [{dt:.2f} ms]")
    jac = idx.jaccard("t0", "t1")
    print(f"jaccard(t0, t1) = {jac:.4f} (count-only, never materialized)")
    # difference chain: one fused plan, the union of the dropped postings
    # is never materialized
    excl = idx.query_andnot("t0", "t1", "t2", "t3")
    print(f"t0 AND NOT (t1 OR t2 OR t3) = {excl.cardinality} docs")
    out.update(memory=idx.memory_bytes(), hits_and=hits_and, hits_or=hits_or,
               jaccard=jac, andnot=excl)

    # T-occurrence query: documents matching at least T of K terms, one
    # segmented-reduce launch each; T is a runtime scalar
    terms = [f"t{i}" for i in range(8)]
    out["threshold"] = []
    for t_min in (2, 4, 6):
        hits = idx.query_threshold(terms, t_min)
        out["threshold"].append(hits)
        print(f">= {t_min} of {len(terms)} terms: {hits.cardinality} docs")
    t0 = time.perf_counter()
    for t_min in (2, 4, 6):
        idx.query_threshold(terms, t_min)
    _sync(dev)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"three warm threshold sweeps over K={len(terms)} terms "
          f"in {dt:.2f} ms (one kernel dispatch each)")

    # weighted variant: rare terms score higher; same counter circuit
    weights = [3 if i >= 4 else 1 for i in range(len(terms))]
    hits = idx.query_threshold(terms, 6, weights=weights)
    out["weighted"] = hits
    print(f"weighted score >= 6 over {len(terms)} terms "
          f"(rare terms x3): {hits.cardinality} docs")

    # top-k similarity: "which terms co-occur most with t0?"  The first
    # call builds the SimilarityEngine's candidate slab (every posting
    # list promoted to bitset rows, cached across queries); each query is
    # then one score and one select launch on the card
    t0 = time.perf_counter()
    top = idx.similar("t0", top_k=5)                   # builds the slab
    build_ms = (time.perf_counter() - t0) * 1e3
    out["similar"] = top
    print("top-5 jaccard neighbours of t0: "
          + ", ".join(f"{t}={s:.4f}" for t, s in top))
    t0 = time.perf_counter()
    out["cosine"] = [idx.similar(term, top_k=5, metric="cosine")
                     for term in ("t0", "t1", "t2", "t3")]
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"similar(): slab build+query {build_ms:.2f} ms, then 4 warm "
          f"cosine queries in {warm_ms:.2f} ms (cached slab, one "
          "dispatch each on kernel backends)")

    # device-resident arena: promote the postings ONCE into a warm slab,
    # then every query moves only row ids and results -- never container
    # payloads.  A postings edit repatches just the affected rows.
    warm = InvertedIndex(arena=BitmapArena(device=dev)).build(docs).optimize()
    warm.arena.adopt_many(warm.postings.values())   # promote whole index
    hits = warm.query_or(*q)                        # uploads once
    st = warm.arena.stats
    up0, staged0 = st.rows_uploaded, st.host_rows_staged
    t0 = time.perf_counter()
    for _ in range(5):
        assert warm.query_or(*q) == hits
    dt = (time.perf_counter() - t0) * 1e3
    moved = (st.rows_uploaded - up0, st.host_rows_staged - staged0)
    print(f"arena: {warm.arena.n_rows} resident rows; 5 warm OR queries "
          f"in {dt:.2f} ms, rows uploaded since warm: {moved[0]}, "
          f"staged: {moved[1]}")                   # both 0: zero-transfer
    warm.add_document(n_docs, ["t0", "t5"])       # postings edit
    warm.query_or(*q)                             # revalidates lazily
    edited = warm.query_or(*q)
    print(f"one document added: {st.rows_patched} row(s) repatched via "
          f"one scatter (vs re-uploading all {warm.arena.n_rows} rows); "
          f"OR result now {edited.cardinality} docs")
    out.update(arena_rows=warm.arena.n_rows, warm_moved=moved,
               patched=st.rows_patched, edited=edited)

    # sharded similarity: the arena round-robins its rows into per-shard
    # slabs; each shard scores its own candidates, and the k-lists merge
    # to the global top-k.  A one-shard mesh takes the single-device path.
    if args.shards:
        mesh = WideMesh([dev] * args.shards)
    elif dev.type == "cuda":
        mesh = WideMesh([torch.device("cuda", i) for i in
                         range(min(4, torch.cuda.device_count()))])
    else:
        mesh = WideMesh([dev])
    n_dev = len(mesh.devices)
    top = warm.similar("t0", top_k=5, mesh=mesh)      # builds shard slabs
    assert top == warm.similar("t0", top_k=5)         # bit-identical
    out["sharded"] = top
    if n_dev > 1:
        shards = warm.arena.shard_slabs(mesh)
        up0 = [s.rows_uploaded for s in shards.stats]
        warm.similar("t1", top_k=5, metric="cosine", mesh=mesh)  # warm
        n_rows = warm.arena.n_rows
        for s, stat in enumerate(shards.stats):
            owned = (n_rows - s + n_dev - 1) // n_dev  # rows r%S == s
            print(f"shard {s}: rows={owned} "
                  f"uploaded={stat.rows_uploaded} "
                  f"patched={stat.rows_patched} "
                  f"gathers={stat.device_gathers}")
        moved = sum(s.rows_uploaded for s in shards.stats) - sum(up0)
        print(f"sharded similar() over {n_dev} shards: warm re-query "
              f"moved {moved} container rows host->device (ids only)")
    else:
        print("sharded similar(): 1 visible device -- degraded to the "
              "single-device path (--shards 4 puts four shards on it)")

    # save / mmap / serve: stream the postings into a frozen snapshot
    # archive on disk, then cold-start a server from it.  Opening maps the
    # file read-only; posting lists materialize lazily on first touch.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analytics.snap")
        t0 = time.perf_counter()
        builder = StreamingIndexBuilder(path, segment_bytes=1 << 20)
        for doc_id, doc_terms in enumerate(docs):
            builder.add_document(doc_id, doc_terms)
        builder.finalize(device=dev)
        dt = (time.perf_counter() - t0) * 1e3
        out["archive_bytes"] = os.path.getsize(path)
        print(f"streamed {n_docs} docs into {path.split('/')[-1]} "
              f"({out['archive_bytes'] / 1024:.0f} kB) in {dt:.0f} ms")

        # serve lazily: only the 3 queried posting lists materialize
        t0 = time.perf_counter()
        served = load_index(path, device=dev)     # mmap, zero parse
        lazy_hits = served.query_or(*q)
        dt = (time.perf_counter() - t0) * 1e3
        assert lazy_hits == hits_or
        print(f"mmap open + first OR query in {dt:.2f} ms "
              f"(lazy: {len(q)} of {len(served.postings)} posting "
              "lists materialized)")

        # or serve device-warm: one batched promotion of the whole
        # snapshot into an arena slab; sync() performs the single
        # host->device transfer the promotion staged
        served_warm = load_index(path, arena=BitmapArena(device=dev))
        served_warm.arena.sync()
        st = served_warm.arena.stats
        out["cold_rows"] = st.rows_uploaded
        print(f"arena cold-start: rows_uploaded = {st.rows_uploaded} "
              "(whole snapshot, one bulk transfer)")
        up0 = st.rows_uploaded
        assert served_warm.query_or(*q) == hits_or
        print(f"first query after promotion: rows uploaded since = "
              f"{st.rows_uploaded - up0} (already device-resident)")

    # run the same predicates over a Table-3 twin dataset
    sets, universe = generate_dataset(TABLE3[0], seed=0)[:50], \
        TABLE3[0].universe
    bms = [RoaringBitmap.from_values(s).run_optimize() for s in sets]
    wide = RoaringBitmap.or_many(bms, device=dev)
    out["census"] = wide
    print(f"census twin: union of 50 postings lists -> "
          f"{wide.cardinality} ids at {wide.bits_per_value():.2f} bits/value")
    return out


if __name__ == "__main__":
    main()
