"""Training data pipeline with Roaring-indexed sample selection, and the
streaming index builder (the cold-start ingest half of the serde format).

The port of the JAX package's ``data/pipeline.py``.  The pipeline holds
  * `keep`  -- a Roaring bitmap of sample ids passing the quality filter
               (built by set algebra over per-criterion bitmaps), and
  * `seen`  -- a Roaring bitmap of consumed ids,
and draws batches from `keep \\ seen`.  Both sets checkpoint with the model
(serde.py is the wire format, byte for byte the JAX package's, so a state
dict loads in either package), so restarts never replay samples.

The set algebra runs on ``device`` ("cuda" unless the caller names
another; it raises without a GPU, as every port entry point does): the
pair planner's kernels build ``keep`` and ``keep \\ seen`` and count
``remaining``.  Batches stay numpy, as the JAX package's are.  Tokens are
synthetic (hash-derived) so the pipeline is self-contained and
deterministic given (seed, sample id).
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core import RoaringBitmap, deserialize, serde, serialize
from repro_torch.core import pairwise
from repro_torch.kernels.ops import resolve_device


class RoaringDataPipeline:
    def __init__(self, n_docs: int, seq_len: int, batch_size: int,
                 vocab: int, seed: int = 0,
                 filters: dict[str, RoaringBitmap] | None = None, *,
                 device=None):
        self.n_docs = n_docs
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.vocab = vocab
        self.seed = seed
        self.filters = filters or {}
        self.device = resolve_device(device)
        # keep = AND of all criterion bitmaps (paper: predicate intersection)
        keep = RoaringBitmap.from_range(0, n_docs)
        for bm in self.filters.values():
            keep = pairwise.merge_one(keep, bm, "and", device=self.device)
        self.keep = keep
        self.seen = RoaringBitmap()
        self.rng = np.random.default_rng(seed)
        self.step = 0

    # ------------------------------------------------------------------
    def remaining(self) -> int:
        return self.keep.andnot_card(self.seen, device=self.device)

    def _draw_ids(self) -> np.ndarray:
        avail = self.keep.andnot(self.seen, device=self.device)
        n_avail = avail.cardinality
        if n_avail < self.batch_size:           # epoch boundary: reset seen
            self.seen = RoaringBitmap()
            avail = self.keep
            n_avail = avail.cardinality
        # select by rank (Roaring select is O(containers))
        ranks = self.rng.choice(n_avail, self.batch_size, replace=False)
        ids = np.array([avail.select(int(r)) for r in sorted(ranks)],
                       np.uint32)
        for i in ids:
            self.seen.add(int(i))
        return ids

    def _tokens_for(self, doc_id: int) -> np.ndarray:
        r = np.random.default_rng((self.seed << 32) ^ doc_id)
        return r.integers(0, self.vocab, self.seq_len + 1).astype(np.int32)

    def next_batch(self) -> dict:
        ids = self._draw_ids()
        toks = np.stack([self._tokens_for(int(i)) for i in ids])
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "doc_ids": ids}

    # ------------------------------------------------------------------
    # checkpointable state (resume without replay)
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "seen": serialize(self.seen),
            "keep": serialize(self.keep),
            "rng": self.rng.bit_generator.state,
            "step": self.step,
        }

    def load_state_dict(self, state: dict):
        self.seen = deserialize(bytes(state["seen"]))
        self.keep = deserialize(bytes(state["keep"]))
        self.rng.bit_generator.state = state["rng"]
        self.step = int(state["step"])


class StreamingIndexBuilder:
    """Bounded-memory inverted-index construction: append postings in
    chunks, spill frozen segments to disk, finalize into ONE mmap-able
    snapshot archive a node can map and query in milliseconds.

    The cold-start ingest half of the serde format (docs/FORMAT.md
    sections 2-3): instead of holding every posting list in RAM until the
    end, the builder accumulates raw doc-id chunks per term and --
    whenever the pending raw bytes cross ``segment_bytes`` -- freezes
    them into a segment file in the frozen zero-copy layout.
    :meth:`finalize` merges all segments (mmap-backed views, per-term
    ``or_many`` through the wide planner on the card) into the final
    archive at ``path`` and hands back the mapped index; with a single
    segment the merge is a rename.  The archives are byte for byte the
    JAX package's for the same appends.

    Typical use::

        b = StreamingIndexBuilder("idx.snap", segment_bytes=32 << 20)
        for doc_id, terms in corpus:
            b.add_document(doc_id, terms)
        index = b.finalize(arena=arena)   # mapped + device-warm

    Peak memory is O(segment_bytes + largest term's postings), not
    O(index); every spill is sequential I/O.
    """

    def __init__(self, path, *, segment_bytes: int = 64 << 20):
        """Args: ``path`` -- destination snapshot archive (segments
        spill beside it as ``<path>.seg<N>``); ``segment_bytes`` --
        raw pending-postings threshold (4 bytes per appended doc id)
        that triggers a spill."""
        self.path = os.fspath(path)
        self.segment_bytes = int(segment_bytes)
        self.n_docs = 0
        self._pend: dict[str, list[np.ndarray]] = {}
        self._pend_ids = 0              # appended ids since last spill
        self._segments: list[str] = []

    @property
    def pending_bytes(self) -> int:
        """Raw bytes of buffered postings (4 per pending doc id)."""
        return 4 * self._pend_ids

    def append_postings(self, term: str, doc_ids) -> None:
        """Bulk-append doc ids to one term's postings (columnar path).

        Args: ``doc_ids`` -- array-like of uint32 document ids, any
        order, duplicates allowed (deduped at spill).  Spills a frozen
        segment when the pending raw bytes cross ``segment_bytes``.
        Amortized O(len(doc_ids)).
        """
        ids = np.asarray(doc_ids, np.uint32).ravel()
        if ids.size == 0:
            return
        self.n_docs = max(self.n_docs, int(ids.max()) + 1)
        self._pend.setdefault(term, []).append(ids)
        self._pend_ids += ids.size
        if self.pending_bytes >= self.segment_bytes:
            self._spill()

    def add_document(self, doc_id: int, terms) -> None:
        """Row-wise append: register ``doc_id`` under each distinct
        term.  Convenience wrapper over :meth:`append_postings`."""
        one = np.array([doc_id], np.uint32)
        for t in set(terms):
            self.append_postings(t, one)

    def _spill(self) -> None:
        """Freeze pending postings into ``<path>.seg<N>`` and drop the
        buffers.  One bitmap per pending term (``from_values`` sorts +
        dedups, ``run_optimize`` picks the compact encoding)."""
        if not self._pend:
            return
        named = {}
        for term in sorted(self._pend):
            vals = np.concatenate(self._pend[term])
            named[term] = RoaringBitmap.from_values(vals).run_optimize()
        seg = f"{self.path}.seg{len(self._segments)}"
        serde.write_snapshot(seg, named, meta=self.n_docs)
        self._segments.append(seg)
        self._pend = {}
        self._pend_ids = 0

    def finalize(self, *, arena=None, device=None):
        """Spill the tail, merge every segment into the final archive
        at ``path``, delete the segments, and return the mapped index.

        Single-segment builds skip the merge (one ``os.replace``).
        Multi-segment merges mmap each segment and union per term
        (``or_many`` on ``device``: the wide planner, whose dense
        remainder is one ``segment_reduce`` launch a term), so peak memory
        is one term's merged postings, not the index.  Returns
        ``load_index(path, arena=arena, device=device)`` -- an
        InvertedIndex over zero-copy views of the final file,
        bulk-promoted to the arena when one is given.  ``device``: "cuda"
        unless the caller names another; with an arena, its device.
        Complexity: O(total payload bytes) once.
        """
        from repro_torch.data.index import load_index
        dev = resolve_device(device, arena)
        self._spill()
        if not self._segments:
            serde.write_snapshot(self.path, {}, meta=self.n_docs)
        elif len(self._segments) == 1:
            os.replace(self._segments[0], self.path)
        else:
            snaps = [serde.read_snapshot(s) for s in self._segments]
            n_docs = max(s.meta for s in snaps)
            terms = sorted({t for s in snaps for t in s.bitmaps})
            merged = {}
            for t in terms:
                parts = [s.bitmaps[t] for s in snaps if t in s.bitmaps]
                merged[t] = (parts[0] if len(parts) == 1
                             else RoaringBitmap.or_many(parts, device=dev))
            serde.write_snapshot(self.path, merged, meta=n_docs)
            del snaps, merged
            for s in self._segments:
                os.remove(s)
        self._segments = []
        return load_index(self.path, arena=arena, device=dev)


def dedup_filter(doc_hashes: np.ndarray) -> RoaringBitmap:
    """Keep the first occurrence of each content hash: a Roaring bitmap of
    survivor ids (vectorized duplicate detection)."""
    _, first_idx = np.unique(doc_hashes, return_index=True)
    return RoaringBitmap.from_values(np.sort(first_idx).astype(np.uint32))


def quality_filter(scores: np.ndarray, threshold: float) -> RoaringBitmap:
    return RoaringBitmap.from_values(
        np.flatnonzero(scores >= threshold).astype(np.uint32))
