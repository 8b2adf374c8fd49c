"""repro_torch.core -- Roaring bitmaps on the host (numpy), the device
arena, the wide-aggregation planner and the construction helpers."""

from repro_torch.core.arena import ArenaStats, BitmapArena
from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.builder import (
    complement, flip_range, from_dense, from_indices, to_dense,
)
from repro_torch.core.containers import (
    ARRAY_MAX, BITSET_WORDS, CHUNK, MAX_RUNS,
    ArrayContainer, BitsetContainer, RunContainer,
)

__all__ = [
    "ArenaStats", "BitmapArena", "RoaringBitmap",
    "ArrayContainer", "BitsetContainer", "RunContainer",
    "ARRAY_MAX", "BITSET_WORDS", "CHUNK", "MAX_RUNS",
    "complement", "flip_range", "from_dense", "from_indices", "to_dense",
]
