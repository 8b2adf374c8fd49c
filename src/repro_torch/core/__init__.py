"""repro_torch.core -- Roaring bitmaps on the host (numpy), the device
arena and the wide-aggregation planner."""

from repro_torch.core.arena import ArenaStats, BitmapArena
from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.containers import (
    ARRAY_MAX, BITSET_WORDS, CHUNK, MAX_RUNS,
    ArrayContainer, BitsetContainer, RunContainer,
)

__all__ = [
    "ArenaStats", "BitmapArena", "RoaringBitmap",
    "ArrayContainer", "BitsetContainer", "RunContainer",
    "ARRAY_MAX", "BITSET_WORDS", "CHUNK", "MAX_RUNS",
]
