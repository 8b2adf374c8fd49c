"""repro_torch.core -- Roaring bitmaps on the host (numpy), the device
arena, the wide-aggregation planner, the construction helpers and the
three serialization formats (``serde``)."""

from repro_torch.core.arena import ArenaStats, BitmapArena
from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.builder import (
    complement, flip_range, from_dense, from_indices, to_dense,
)
from repro_torch.core.containers import (
    ARRAY_MAX, BITSET_WORDS, CHUNK, MAX_RUNS,
    ArrayContainer, BitsetContainer, RunContainer,
)
from repro_torch.core.serde import (
    FrozenSnapshot, LazyBitmaps, deserialize, deserialize_frozen,
    deserialize_portable, load_frozen, read_snapshot, serialize,
    serialize_frozen, serialize_portable, serialized_size_bytes,
    write_frozen, write_snapshot,
)

__all__ = [
    "ArenaStats", "BitmapArena", "RoaringBitmap",
    "ArrayContainer", "BitsetContainer", "RunContainer",
    "ARRAY_MAX", "BITSET_WORDS", "CHUNK", "MAX_RUNS",
    "complement", "flip_range", "from_dense", "from_indices", "to_dense",
    "serialize", "deserialize", "serialized_size_bytes",
    "serialize_portable", "deserialize_portable",
    "serialize_frozen", "deserialize_frozen", "write_frozen", "load_frozen",
    "FrozenSnapshot", "LazyBitmaps", "write_snapshot", "read_snapshot",
]
