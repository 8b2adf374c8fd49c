"""Paged KV-cache page allocator with a Roaring free-set, the port of the
JAX package's ``repro/serve/kv_cache.py``.

The allocator's free list over [0, n_pages) is exactly an integer set: we
keep it as a Roaring bitmap, so
  * allocation        = select(0..k) + difference,
  * free              = union,
  * fragmentation     = num_runs vs cardinality (run containers!),
  * defrag planning   = set algebra between per-sequence page sets.
The page *table* (sequence -> ordered page list) stays a plain list since
order matters; set queries (which pages live, which sequences own a page
range) go through bitmaps.  The set algebra runs on ``device`` (the card
unless the caller names another).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import RoaringBitmap, complement, pairwise
from repro_torch.kernels.ops import resolve_device


class PagedKVAllocator:
    def __init__(self, n_pages: int, page_size: int = 128, *, device=None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        self.free = RoaringBitmap.from_range(0, n_pages).run_optimize()
        self.tables: dict[int, list[int]] = {}

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return self.free.cardinality

    def fragmentation(self) -> float:
        """1 - (1 / runs-per-free-region); 0 when the free set is one run."""
        if not self.free:
            return 0.0
        runs = sum(c.num_runs() for c in self.free.containers)
        return 1.0 - 1.0 / runs

    # ------------------------------------------------------------------
    def allocate(self, seq_id: int, n_pages: int) -> list[int]:
        if n_pages > self.n_free:
            raise MemoryError(
                f"need {n_pages} pages, {self.n_free} free")
        pages = [self.free.select(i) for i in range(n_pages)]
        taken = RoaringBitmap.from_values(np.asarray(pages, np.uint32))
        self.free = pairwise.merge_one(self.free, taken, "andnot",
                                       device=self.device)
        self.tables.setdefault(seq_id, []).extend(pages)
        return pages

    def extend(self, seq_id: int, token_count: int) -> list[int]:
        """Grow a sequence to cover token_count tokens."""
        have = len(self.tables.get(seq_id, ())) * self.page_size
        need = max(0, -(-max(token_count - have, 0) // self.page_size))
        return self.allocate(seq_id, need) if need else []

    def release(self, seq_id: int) -> None:
        pages = self.tables.pop(seq_id, [])
        if pages:
            self.free = pairwise.merge_one(
                self.free, RoaringBitmap.from_values(
                    np.asarray(pages, np.uint32)), "or", device=self.device)
            self.free.run_optimize()

    # ------------------------------------------------------------------
    def pages_of(self, seq_id: int) -> list[int]:
        return list(self.tables.get(seq_id, ()))

    def used_set(self) -> RoaringBitmap:
        return complement(self.free, self.n_pages, device=self.device)

    def owner_overlap(self, a: int, b: int) -> int:
        """Shared pages between two sequences (prefix sharing telemetry)."""
        sa = RoaringBitmap.from_values(
            np.asarray(self.tables.get(a, []), np.uint32))
        sb = RoaringBitmap.from_values(
            np.asarray(self.tables.get(b, []), np.uint32))
        return sa.and_card(sb, device=self.device)
