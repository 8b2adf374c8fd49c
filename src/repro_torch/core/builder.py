"""Construction / conversion helpers around RoaringBitmap, the port of the
JAX package's ``core/builder.py``.

The set algebra runs through ``pairwise.merge_one`` on ``device`` ("cuda"
unless the caller names another, as every port entry point), so
``complement`` and ``flip_range`` also run on the CPU when asked.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import pairwise
from repro_torch.core.bitmap import RoaringBitmap


def from_indices(indices) -> RoaringBitmap:
    return RoaringBitmap.from_values(indices)


def from_dense(mask: np.ndarray) -> RoaringBitmap:
    """Boolean occupancy vector -> RoaringBitmap."""
    return RoaringBitmap.from_values(np.flatnonzero(np.asarray(mask)))


def to_dense(bm: RoaringBitmap, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=bool)
    vals = bm.to_array()
    out[vals[vals < n]] = True
    return out


def complement(bm: RoaringBitmap, n: int, *, device=None) -> RoaringBitmap:
    """Complement within the universe [0, n)."""
    return pairwise.merge_one(RoaringBitmap.from_range(0, n), bm, "andnot",
                              device=device)


def flip_range(bm: RoaringBitmap, start: int, stop: int, *,
               device=None) -> RoaringBitmap:
    """Flip all bits in [start, stop) (paper: bitset negation, sec 2.2)."""
    window = RoaringBitmap.from_range(start, stop)
    inside_flipped = pairwise.merge_one(window, bm, "andnot", device=device)
    outside = pairwise.merge_one(bm, window, "andnot", device=device)
    return pairwise.merge_one(outside, inside_flipped, "or", device=device)
