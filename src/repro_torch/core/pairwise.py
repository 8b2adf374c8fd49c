"""Top-k similarity against a fixed candidate set: the similarity half of
the JAX package's ``core/pairwise.py`` (its ``SimilarityEngine``).

"Compressed bitmap indexes: beyond unions and intersections" (Kaser &
Lemire) derives jaccard, cosine and containment from the AND cardinality
alone; the paper's fast-count argument (section 5.9) keeps the AND and the
popcount in registers.  Here the scores do not leave the card either: a
query is one score launch and one select launch
(``kernels/topk_ops.py``), and only k results come back.

The two-by-two merge and count planner of the JAX module
(``pairwise_card``, ``jaccard_matrix``, ``merge_one``) is not ported yet,
nor its sharded top-k (``mesh=``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import METRICS, WORDS

__all__ = ["METRICS", "SimilarityEngine"]


def _scores_host(inter, q_card, cards, metric: str) -> np.ndarray:
    """Numpy version of ``kernels.ref.similarity_scores``: float32 in the
    same operation order, so host selection gives the kernel's bits and
    its tie order."""
    interf = np.asarray(inter).astype(np.float32)
    qc = np.float32(q_card)
    oc = np.asarray(cards).astype(np.float32)
    if metric == "jaccard":
        denom = qc + oc - interf
    elif metric == "cosine":
        denom = np.sqrt(qc * oc)
    elif metric == "containment":
        denom = np.broadcast_to(qc, oc.shape)
    else:
        raise ValueError(metric)
    return np.divide(interf, denom, out=np.ones_like(interf),
                     where=denom > 0)


def _is_member(query) -> bool:
    return isinstance(query, (int, np.integer))


class SimilarityEngine:
    """Top-k similarity joins against a fixed candidate set, one score and
    one select launch per query on the card.

    Construction promotes every candidate container to a bitset row once,
    into a candidate-major slab over the global chunk-key set (the layout
    ``kernels/topk_ops.py`` consumes), with a device copy made at the first
    kernel query.  Memory: 8 KiB per candidate container, on the host and
    on the device (a query-serving cache; the stored bitmaps keep their
    compressed kinds).

    Routes (``backend`` of :meth:`topk`): on the card, and whenever a
    kernel backend is forced ("cuda", "ref"), the score and select stages
    run through ``kernels.ops.similarity_topk``; on the CPU by default,
    and always with "host", the candidate-pruning planner runs in numpy:
    every candidate's score is bounded above by the metric at ``inter =
    min(|Q|, |C|)``, the k best bounds are scored exactly to fix the
    running k-th score, and every candidate whose bound falls below it is
    skipped.  Every route evaluates the score in float32 in one operation
    order and breaks ties toward the lower candidate index, so all of them
    return the same bits.

    With an ``arena`` (``core/arena.py``) the slab is an arena view: the
    candidates are adopted into the shared arena, the engine keeps slab row
    ids, its host rows are a gather from the arena's host mirror, and its
    device rows a gather from the arena's device slab (taken at the first
    kernel query after a build).  A postings edit then costs one
    :meth:`refresh`: the arena repatches only the changed rows and the
    next query gathers again from the patched slab.
    """

    def __init__(self, bitmaps, *, arena=None, device=None):
        """``bitmaps``: the candidate set, index-aligned with results.
        ``arena``: an optional shared ``BitmapArena``; the candidates are
        adopted into it and the engine becomes a view over its slab.
        ``device``: where kernel queries run, "cuda" by default (raises
        when no GPU is present); with an arena, the arena's device."""
        self._bitmaps = list(bitmaps)
        self._arena = arena
        self.device = kops.resolve_device(device, arena)
        self._build()

    def _build(self) -> None:
        bitmaps = self._bitmaps
        arena = self._arena
        self.n = len(bitmaps)
        self.cards = np.array([bm.cardinality for bm in bitmaps], np.int64)
        if self.cards.size and int(self.cards.max()) >= 2**31:
            # the kernel route carries cardinalities as int32; refuse to
            # build rather than wrap on one route only
            raise ValueError("candidate cardinality >= 2^31 unsupported")
        if arena is not None:
            arena.adopt_many(bitmaps)
        keys = sorted({k for bm in bitmaps for k in bm.keys})
        self.key_col = {k: i for i, k in enumerate(keys)}
        self.n_keys = len(keys)
        rows, row_col = [], []
        starts = np.zeros(self.n + 1, np.int32)
        for i, bm in enumerate(bitmaps):
            for k, c in zip(bm.keys, bm.containers):
                rows.append(arena.lookup(c) if arena is not None
                            else C.container_words64(c))
                row_col.append(self.key_col[k])
            starts[i + 1] = len(rows)
        if arena is not None:
            self.row_ids = np.asarray(rows, np.int32)
            self.rows = arena.host_rows(self.row_ids) if rows else \
                np.zeros((0, 1024), np.uint64)
            self._snap = tuple((id(bm), bm._version) for bm in bitmaps)
        else:
            self.row_ids = None
            self.rows = np.stack(rows) if rows else \
                np.zeros((0, 1024), np.uint64)
            self._snap = None
        self.row_col = np.asarray(row_col, np.int32)
        self.starts = starts
        self._dev = None                         # made at the first query

    def refresh(self) -> bool:
        """Revalidate an arena-backed engine: re-adopt candidates whose
        ``_version`` moved (the arena repatches only their changed rows),
        rebuild the host index arrays, and drop the device view, so the
        next query gathers again from the patched slab on the device.
        Returns True when anything changed, False when every candidate is
        current.  The arena's patch is out of place, so a stale view would
        still answer, from the old rows: dropping it is what keeps the
        answers current."""
        if self._arena is None:
            raise ValueError("refresh() requires an arena-backed engine")
        snap = tuple((id(bm), bm._version) for bm in self._bitmaps)
        if snap == self._snap:
            return False
        self._build()
        return True

    # -- query preparation ----------------------------------------------

    def _query_words(self, query) -> np.ndarray:
        """(C, 1024) uint64 host query rows over the global keys.
        ``query`` is a candidate index (its rows come from the slab) or a
        RoaringBitmap (keys outside the candidate set are dropped: no
        candidate row can meet them)."""
        q64 = np.zeros((max(self.n_keys, 1), 1024), np.uint64)
        if _is_member(query):
            s, e = int(self.starts[query]), int(self.starts[query + 1])
            q64[self.row_col[s:e]] = self.rows[s:e]
            return q64
        cols, rows = self._bitmap_rows(query)
        if cols:
            q64[cols] = np.stack(rows)
        return q64

    def _bitmap_rows(self, query) -> tuple[list[int], list[np.ndarray]]:
        """Key columns and uint64 rows of a bitmap query's containers
        whose keys some candidate has."""
        cols, rows = [], []
        for k, cont in zip(query.keys, query.containers):
            col = self.key_col.get(k)
            if col is not None:
                cols.append(col)
                rows.append(C.container_words64(cont))
        return cols, rows

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _query_words_dev(self, query) -> torch.Tensor:
        """(C, WORDS) int32 query block on the device.  A member query
        copies its rows from the resident device rows (no container words
        cross from the host); a bitmap query ships only its occupied
        rows."""
        dev_rows, dev_col, _, _ = self._device()
        out = torch.zeros((max(self.n_keys, 1), WORDS), dtype=torch.int32,
                          device=self.device)
        if _is_member(query):
            s, e = int(self.starts[query]), int(self.starts[query + 1])
            if s < e:
                out.index_copy_(0, dev_col[s:e].long(), dev_rows[s:e])
            return out
        cols, rows = self._bitmap_rows(query)
        if cols:
            out.index_copy_(
                0, self._to_device(np.asarray(cols, np.int64)),
                self._to_device(np.stack(rows).view(np.int32)
                                .reshape(-1, WORDS)))
        return out

    def _device(self):
        """(rows, row_col, starts, cards) on the device, made once per
        build.  With an arena the rows are gathered from the arena's
        resident slab on the device (counted in ``device_gathers``)."""
        if self._dev is None:
            if self._arena is not None and self.row_ids.size:
                rows = self._arena.device_slab().index_select(
                    0, self._to_device(self.row_ids.astype(np.int64)))
                self._arena.stats.device_gathers += 1
            elif self.rows.size:
                rows = self._to_device(
                    self.rows.view(np.int32).reshape(-1, WORDS))
            else:
                rows = torch.zeros((1, WORDS), dtype=torch.int32,
                                   device=self.device)
            self._dev = (
                rows,
                self._to_device(self.row_col if self.row_col.size else
                                np.zeros(1, np.int32)),
                self._to_device(self.starts),
                self._to_device(self.cards.astype(np.int32)),
            )
        return self._dev

    # -- the query surface ----------------------------------------------

    def _check_query(self, query, k: int) -> tuple[int | None, int, int]:
        """(exclude, query cardinality, k clamped to the candidates)."""
        if _is_member(query):
            exclude = int(query)
            if not 0 <= exclude < self.n:
                raise IndexError(f"candidate index {exclude} out of "
                                 f"range [0, {self.n})")
            qc = int(self.cards[exclude])
        else:
            exclude = None
            qc = query.cardinality
        k = min(int(k), self.n - (1 if exclude is not None else 0))
        if k > 0 and qc >= 2**31:                # int32 on the kernel route
            raise ValueError("query cardinality >= 2^31 unsupported")
        return exclude, qc, k

    def _shortcut(self, exclude, qc: int, k: int, metric: str):
        """The result where no route has work to do -- nothing to return,
        or no candidate with a row -- else None."""
        if k <= 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        if self.rows.shape[0] == 0:              # all candidates empty
            score = _scores_host(np.zeros(self.n, np.int64), qc,
                                 self.cards, metric)
            if exclude is not None:
                score[exclude] = np.float32(-1.0)
            order = np.argsort(-score, kind="stable")[:k]
            return (order.astype(np.int64), score[order],
                    np.zeros(k, np.int64))
        return None

    def _use_kernel(self, backend) -> bool:
        return backend != "host" and kops.prefer_kernel(backend,
                                                        self.device)

    def _topk_kernel(self, q_words: torch.Tensor, qc: int, k: int,
                     metric: str, exclude, backend):
        dev_rows, dev_col, dev_starts, dev_cards = self._device()
        idx, score, inter = kops.similarity_topk(
            dev_rows, dev_col, dev_starts, q_words, qc, dev_cards,
            metric=metric, k=k, exclude=-1 if exclude is None else exclude,
            backend=backend)
        return (idx.cpu().numpy().astype(np.int64), score.cpu().numpy(),
                inter.cpu().numpy().astype(np.int64))

    def topk(self, query, k: int, metric: str = "jaccard", *,
             backend: str | None = None
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k most similar candidates to ``query``.

        query:   a candidate index (int; excluded from its own result) or a
                 RoaringBitmap.
        k:       results wanted; clamped to the candidate count.
        metric:  "jaccard" | "cosine" | "containment".
        backend: None (the kernels on the card, the pruned host sweep on
                 the CPU), "cuda" or "ref" (the kernel route with the CUDA
                 kernels or their plain versions), or "host" (the numpy
                 sweep, the query server's degraded route).  Every route
                 returns the same bits.

        Returns (idx (k',) int64, score (k',) float32, inter (k',) int64),
        best first; ties at equal score order by ascending index.
        """
        if metric not in METRICS:
            raise ValueError(metric)
        exclude, qc, k = self._check_query(query, k)
        done = self._shortcut(exclude, qc, k, metric)
        if done is not None:
            return done
        if self._use_kernel(backend):
            return self._topk_kernel(self._query_words_dev(query), qc, k,
                                     metric, exclude, backend)
        return self._topk_host(self._query_words(query), qc, k, metric,
                               exclude)

    def topk_batch(self, queries, k: int, metric: str = "jaccard", *,
                   backend: str | None = None) -> list:
        """``[self.topk(q, k, metric, backend=backend) for q in queries]``
        (the query server's similarity batch).  On the kernel route each
        query runs its own score and select launches, as the JAX package's
        kernel route loops per query."""
        if metric not in METRICS:
            raise ValueError(metric)
        return [self.topk(q, k, metric, backend=backend) for q in queries]

    # -- pruned host route ----------------------------------------------

    def _host_inter(self, sel: np.ndarray, q64: np.ndarray) -> np.ndarray:
        """Exact intersection cardinalities of the selected candidates:
        gather their rows, AND with the query's key columns, popcount,
        sum per candidate."""
        out = np.zeros(sel.size, np.int64)
        lens = (self.starts[sel + 1] - self.starts[sel]).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            return out
        offs = np.repeat(np.cumsum(lens) - lens, lens)
        ridx = np.arange(total) - offs + np.repeat(
            self.starts[sel].astype(np.int64), lens)
        per = np.bitwise_count(
            self.rows[ridx] & q64[self.row_col[ridx]]).sum(axis=1)
        np.add.at(out, np.repeat(np.arange(sel.size), lens),
                  per.astype(np.int64))
        return out

    def _topk_host(self, q64, qc, k, metric, exclude):
        """The pruning planner: score upper bounds from cardinalities alone
        (the metric at ``inter = min(|Q|, |C|)``, monotone in inter, so a
        true float32 bound), exact scores for the k best bounds to fix the
        running k-th score, and no work for a candidate whose bound falls
        strictly below it."""
        ub = _scores_host(np.minimum(qc, self.cards), qc, self.cards,
                          metric)
        if exclude is not None:
            ub[exclude] = np.float32(-1.0)
        order_ub = np.argsort(-ub, kind="stable")
        seeds = order_ub[:k]
        score = np.full(self.n, np.float32(-1.0), np.float32)
        inter = np.zeros(self.n, np.int64)
        inter[seeds] = self._host_inter(seeds, q64)
        score[seeds] = _scores_host(inter[seeds], qc, self.cards[seeds],
                                    metric)
        tau = score[seeds].min()                 # running k-th score
        rest = order_ub[k:]
        survivors = rest[ub[rest] >= tau]        # bound < tau: skipped
        if survivors.size:
            inter[survivors] = self._host_inter(survivors, q64)
            score[survivors] = _scores_host(
                inter[survivors], qc, self.cards[survivors], metric)
        if exclude is not None:
            score[exclude] = np.float32(-1.0)
        order = np.argsort(-score, kind="stable")[:k]
        return order.astype(np.int64), score[order], inter[order]
