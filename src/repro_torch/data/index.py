"""A small inverted index on Roaring bitmaps -- the paper's motivating
application (section 1: "inverted indexes map query terms to document
identifiers").  The port of the JAX package's ``data/index.py``: the
boolean, count and similarity query surface, and ``load_index``, the cold
start over a snapshot archive (``core.serde``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.pairwise import METRICS, SimilarityEngine
from repro_torch.kernels.ops import resolve_device


class InvertedIndex:
    """Term -> document-id postings on Roaring bitmaps.

    Every boolean query (``query_and`` .. ``query_andnot``) plans through
    ``repro_torch.core.aggregate``: one segmented-kernel launch per query,
    whatever the number of terms.  ``count_and`` and ``jaccard`` run the
    pair count planner (``core.pairwise``): one launch per container-type
    class.  ``similar`` runs on a cached
    ``core.pairwise.SimilarityEngine``: one score and one select launch per
    query on the card.

    Unknown-term / empty-input contract: a term absent from the index
    queries as an EMPTY posting list -- never a ``KeyError`` -- and an
    empty term list yields an empty result.  So ``query_and`` /
    ``query_or`` / ``query_xor`` with no or only-unknown terms return the
    empty bitmap; ``query_andnot`` with an unknown ``keep`` is empty and
    unknown ``drops`` subtract nothing; ``query_threshold`` prunes unknown
    terms' (zero) contributions; ``similar`` scores an unknown term as an
    empty query (all scores 0) and returns a full-length, validly ordered
    list.

    ``arena``: an optional ``core.arena.BitmapArena``.  When present,
    queries adopt their term postings into it first, so container rows
    stay on the device across queries (warm re-queries move no container
    payloads), and the similarity engine is a view of the arena's slab
    that revalidates in place after postings edits (only edited rows
    repatch).  ``device``: where queries run without an arena, "cuda" by
    default (raises when no GPU is present); with an arena, its device.
    Results are bit-identical with or without an arena."""

    def __init__(self, *, arena=None, device=None):
        self.postings: dict[str, RoaringBitmap] = {}
        self.n_docs = 0
        self.arena = arena
        self.device = resolve_device(device, arena)
        # cached (snapshot, terms, SimilarityEngine); the snapshot
        # revalidates against direct postings edits -- see _sim_engine
        self._sim = None
        self._sim_sharded: dict = {}      # mesh -> the same, per mesh

    @classmethod
    def from_postings(cls, postings, n_docs: int, *, arena=None,
                      device=None) -> "InvertedIndex":
        """Wrap pre-built posting lists -- the snapshot cold-start
        constructor (``load_index`` and ``StreamingIndexBuilder.finalize``
        route through here).

        Args: ``postings`` a mapping of term -> RoaringBitmap.  A lazy
        ``serde.LazyBitmaps`` mapping (what ``read_snapshot`` returns) is
        kept AS the postings store, so entries stay unmaterialized until a
        query touches them; any other mapping is copied into a plain dict.
        ``n_docs`` the document-id space size; ``arena`` an optional
        BitmapArena -- when given, all postings are materialized and
        bulk-promoted with ``arena.adopt_frozen`` (one batched conversion,
        one transfer) so every query is warm from the start; ``device``
        as for the constructor."""
        from repro_torch.core import serde
        idx = cls(arena=arena, device=device)
        idx.postings = (postings if isinstance(postings, serde.LazyBitmaps)
                        else dict(postings))
        idx.n_docs = int(n_docs)
        if arena is not None:
            arena.adopt_frozen(idx.postings.values())
        return idx

    def add_document(self, doc_id: int, terms) -> None:
        if self.arena is None:
            self._sim = None                      # postings changed
        # with an arena, _sim_engine revalidates generations instead
        self.n_docs = max(self.n_docs, doc_id + 1)
        for t in set(terms):
            bm = self.postings.get(t)
            if bm is None:
                bm = self.postings[t] = RoaringBitmap()
            bm.add(doc_id)

    def build(self, docs: list[list[str]]) -> "InvertedIndex":
        # columnar build: term -> sorted doc ids, one from_values each
        self._sim = None
        by_term: dict[str, list[int]] = {}
        for i, terms in enumerate(docs):
            for t in set(terms):
                by_term.setdefault(t, []).append(i)
        self.n_docs = len(docs)
        for t, ids in by_term.items():
            self.postings[t] = RoaringBitmap.from_values(
                np.asarray(ids, np.uint32))
        return self

    def optimize(self):
        if self.arena is None:
            self._sim = None
        for bm in self.postings.values():
            bm.run_optimize()
        return self

    # query surface ------------------------------------------------------
    def _get(self, term: str) -> RoaringBitmap:
        """Postings for ``term``; an unknown term is an empty posting
        list (the class-level contract: no KeyError, ever)."""
        return self.postings.get(term, RoaringBitmap())

    def _adopt(self, bms: list[RoaringBitmap]) -> list[RoaringBitmap]:
        """Adopt query operands into the arena (no-op without one).
        Only non-empty bitmaps register: the fresh empties ``_get``
        returns for unknown terms are per-call temporaries that must not
        pin arena rows."""
        if self.arena is not None:
            for bm in bms:
                if bm.containers:
                    self.arena.adopt(bm)
        return bms

    def query_and(self, *terms) -> RoaringBitmap:
        """Documents matching ALL ``terms``, with cardinality-ascending
        pruning.  Unknown terms are empty postings, so the result is
        empty."""
        return RoaringBitmap.and_many(
            self._adopt([self._get(t) for t in terms]), arena=self.arena,
            device=self.device)

    def query_or(self, *terms) -> RoaringBitmap:
        return RoaringBitmap.or_many(
            self._adopt([self._get(t) for t in terms]), arena=self.arena,
            device=self.device)

    def query_xor(self, *terms) -> RoaringBitmap:
        return RoaringBitmap.xor_many(
            self._adopt([self._get(t) for t in terms]), arena=self.arena,
            device=self.device)

    def query_threshold(self, terms, t: int, weights=None) -> RoaringBitmap:
        """Documents whose matched terms reach a total score of ``t``
        (T-occurrence query, Kaser & Lemire); optional per-term integer
        ``weights``."""
        return RoaringBitmap.threshold_many(
            self._adopt([self._get(term) for term in terms]), t,
            weights=weights, arena=self.arena, device=self.device)

    def query_andnot(self, keep: str, *drops: str) -> RoaringBitmap:
        """Documents matching ``keep`` and none of ``drops`` -- a
        difference chain planned as one fused launch (the union of the
        dropped postings is never materialized)."""
        ops = self._adopt([self._get(keep)] + [self._get(d) for d in drops])
        return RoaringBitmap.andnot_many(ops[0], ops[1:], arena=self.arena,
                                         device=self.device)

    def count_and(self, a: str, b: str) -> int:
        """|postings(a) ∩ postings(b)| without materializing it (the fast
        count, paper section 5.9), on the index's device."""
        return self._get(a).and_card(self._get(b), device=self.device)

    def jaccard(self, a: str, b: str) -> float:
        """Jaccard similarity of two terms' postings, on the index's
        device (two empty postings score 1.0)."""
        return self._get(a).jaccard(self._get(b), device=self.device)

    def _sim_engine(self, mesh=None):
        """(terms, SimilarityEngine) over every posting list, cached and
        rebuilt lazily after a postings change.  Changes through the index
        drop the cache; direct edits of the public ``postings`` dict
        (replaced bitmaps, new terms, point updates) are caught by a
        snapshot of each term's name, bitmap identity, mutation counter
        (``RoaringBitmap._version``) and cardinality.

        With an arena, a stale snapshot over the same terms and bitmap
        objects refreshes the engine in place (``refresh()``: the arena
        repatches only the edited rows); a changed term set or a replaced
        bitmap builds a new engine.

        ``mesh``: an optional 1-D ``dist.WideMesh``.  With more than one
        shard the engine runs the sharded route, which needs an
        arena-backed index; engines are cached per mesh, so sharded and
        single-device engines over the same postings coexist."""
        key = None
        if mesh is not None:
            from repro_torch.dist import ctx
            m, size, _ = ctx.resolve_wide(mesh)
            if size > 1:
                if self.arena is None:
                    raise ValueError(
                        "similar(mesh=) requires an arena-backed index")
                key = m
        snap = tuple((t, id(bm), bm._version, bm.cardinality)
                     for t, bm in self.postings.items())
        ent = self._sim if key is None else self._sim_sharded.get(key)
        if ent is None or ent[0] != snap:
            terms = list(self.postings)
            if (self.arena is not None and ent is not None
                    and ent[1] == terms
                    and all(self.postings[t] is bm for t, bm in
                            zip(terms, ent[2]._bitmaps))):
                eng = ent[2]
                eng.refresh()
            else:
                eng = SimilarityEngine((self.postings[t] for t in terms),
                                       arena=self.arena, device=self.device,
                                       mesh=key)
            ent = (snap, terms, eng)
            if key is None:
                self._sim = ent
            else:
                self._sim_sharded[key] = ent
        return ent[1], ent[2]

    def similar(self, term: str, top_k: int = 10, metric: str = "jaccard",
                *, backend: str | None = None,
                mesh=None) -> list[tuple[str, float]]:
        """The ``top_k`` terms most similar to ``term``.

        Args: ``term`` the query term (an unknown term queries as an empty
        posting list); ``top_k`` results wanted (clamped to the other
        terms); ``metric`` "jaccard" (|A∩B| / |A∪B|), "cosine" (|A∩B| /
        sqrt(|A||B|)) or "containment" (|A∩B| / |A|, the query side);
        ``backend`` as for ``SimilarityEngine.topk`` -- every route gives
        the same bits; ``mesh`` a ``dist.WideMesh`` for the sharded route
        over the arena's per-shard slabs (an arena-backed index only; a
        1-shard mesh is the single-device route) -- the same bits, tie
        order included.

        Returns [(term, score)] best first; ties order by term insertion.
        On the card: one score and one select launch over the engine's
        resident rows."""
        if metric not in METRICS:
            raise ValueError(metric)
        terms, eng = self._sim_engine(mesh)
        if term in self.postings:
            query = terms.index(term)
        else:
            query = self._get(term)
        idx, score, _ = eng.topk(query, top_k, metric, backend=backend)
        return [(terms[i], float(s)) for i, s in zip(idx.tolist(),
                                                     score.tolist())]

    def memory_bytes(self) -> int:
        return sum(bm.memory_bytes() for bm in self.postings.values())


def load_index(path, *, arena=None, mmap: bool = True,
               device=None) -> InvertedIndex:
    """Map an on-disk snapshot archive straight into a queryable index.

    The cold-start path (docs/FORMAT.md section 3): the archive written
    by ``StreamingIndexBuilder.finalize`` (or ``serde.write_snapshot``,
    in either package: the bytes are the same) is mapped read-only, every
    posting list becomes numpy views over the mapped buffer (zero payload
    copies, pages fault in on first touch), and -- when ``arena`` is
    given -- the whole set is promoted to the device slab in one batched
    transfer.

    Args: ``path`` the snapshot file; ``arena`` optional BitmapArena for
    device-warm queries; ``mmap=False`` reads the file into memory
    instead (same views, private buffer); ``device`` where queries run
    without an arena, "cuda" by default (with an arena, its device).

    Returns an InvertedIndex whose ``n_docs`` is the archive's ``meta``
    field.  Raises ``ValueError`` on a corrupt archive.  Complexity:
    O(terms + containers) directory work; payload bytes are only touched
    by queries (or the arena promotion)."""
    from repro_torch.core import serde
    snap = serde.read_snapshot(path, mmap=mmap)
    return InvertedIndex.from_postings(snap.bitmaps, snap.meta, arena=arena,
                                       device=device)
