"""RoaringBitmap: the paper's two-level data structure (host path).

A Roaring bitmap is a sorted list of 16-bit keys (the high half of each
present 32-bit value) paired with containers holding the low halves
(paper section 1, Fig. 1).  This is the port's copy of the JAX package's
``RoaringBitmap``: construction, membership, point updates, the two-by-two
algebra with its fast counts and similarity joins (through
``repro_torch.core.pairwise``), the wide aggregates (through
``repro_torch.core.aggregate``), run optimization, memory accounting and
rank/select and the three serialization formats (through
``repro_torch.core.serde``, byte for byte the JAX package's).

The top level is scalar python (as in CRoaring the top level is scalar C);
all heavy lifting happens inside the vectorized container layer.
"""

from __future__ import annotations

import bisect

import numpy as np

from repro_torch.core import containers as C
from repro_torch.core.containers import (
    ArrayContainer, BitsetContainer, RunContainer, Container,
    container_from_values, optimize,
)

__all__ = ["RoaringBitmap"]


class RoaringBitmap:
    """Compressed set of uint32 values."""

    __slots__ = ("keys", "containers", "_prefix", "_version")

    def __init__(self, keys: list[int] | None = None,
                 conts: list[Container] | None = None):
        self.keys: list[int] = keys if keys is not None else []
        self.containers: list[Container] = conts if conts is not None else []
        self._prefix: np.ndarray | None = None    # cumulative cards cache
        # bumped by every mutator (add/remove/run_optimize): caches over
        # live bitmaps (the arena's adopt) revalidate against it
        self._version: int = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_values(cls, values) -> "RoaringBitmap":
        """Build from any iterable / array of uint32 values (deduplicated)."""
        arr = np.asarray(values, dtype=np.uint32)
        if arr.size == 0:
            return cls()
        arr = np.unique(arr)                     # sorted + distinct
        his = (arr >> np.uint32(16)).astype(np.int64)
        los = arr.astype(np.uint16)              # low 16 bits
        keys_u, starts = np.unique(his, return_index=True)
        bounds = np.concatenate((starts, [arr.size]))
        keys, conts = [], []
        for i, k in enumerate(keys_u.tolist()):
            chunk = los[bounds[i]:bounds[i + 1]]
            keys.append(int(k))
            conts.append(container_from_values(chunk))
        return cls(keys, conts)

    @classmethod
    def from_range(cls, start: int, stop: int) -> "RoaringBitmap":
        """Dense range [start, stop) -- built directly as run containers."""
        if stop <= start:
            return cls()
        keys, conts = [], []
        k0, k1 = start >> 16, (stop - 1) >> 16
        for k in range(k0, k1 + 1):
            lo = start - (k << 16) if k == k0 else 0
            hi = (stop - 1) - (k << 16) if k == k1 else 0xFFFF
            keys.append(k)
            conts.append(RunContainer(np.array([[lo, hi - lo]],
                                               dtype=np.int32)))
        return cls(keys, conts)

    def copy(self) -> "RoaringBitmap":
        return RoaringBitmap(list(self.keys), list(self.containers))

    # ------------------------------------------------------------------
    # basic queries
    # ------------------------------------------------------------------

    def _card_prefix(self) -> np.ndarray:
        """Cached cumulative container cardinalities (paper section 6):
        rank/select navigate the top level with ONE binary search instead
        of a scalar per-container scan.  Invalidated by ``add`` /
        ``remove`` / ``run_optimize``."""
        if self._prefix is None or \
                self._prefix.size != len(self.containers):
            self._prefix = np.cumsum(
                [c.card for c in self.containers]).astype(np.int64)
        return self._prefix

    @property
    def cardinality(self) -> int:
        p = self._card_prefix()
        return int(p[-1]) if p.size else 0

    def __len__(self) -> int:
        return self.cardinality

    def __bool__(self) -> bool:
        return bool(self.containers)

    def __contains__(self, v: int) -> bool:
        """Logarithmic random access (paper section 1): binary search the key,
        then probe the container."""
        i = bisect.bisect_left(self.keys, int(v) >> 16)
        if i == len(self.keys) or self.keys[i] != int(v) >> 16:
            return False
        return self.containers[i].contains(int(v) & 0xFFFF)

    def contains_many(self, values) -> np.ndarray:
        """Vectorized membership for an array of uint32 values."""
        arr = np.asarray(values, dtype=np.uint32)
        out = np.zeros(arr.size, dtype=bool)
        if not self.keys:
            return out
        his = (arr >> np.uint32(16)).astype(np.int64)
        keys_np = np.asarray(self.keys, dtype=np.int64)
        idx = np.searchsorted(keys_np, his)
        idx_c = np.minimum(idx, keys_np.size - 1)
        hit = keys_np[idx_c] == his
        for ci in np.unique(idx_c[hit]).tolist():
            sel = hit & (idx_c == ci)
            lo = arr[sel].astype(np.uint16)
            cont = self.containers[ci]
            if isinstance(cont, BitsetContainer):
                out[sel] = C.bitset_test_many(cont.words, lo)
            elif isinstance(cont, ArrayContainer):
                pos = np.searchsorted(cont.values, lo)
                pos[pos == cont.values.size] = max(cont.values.size - 1, 0)
                out[sel] = (cont.values[pos] == lo) if cont.values.size else False
            else:
                out[sel] = np.fromiter(
                    (cont.contains(int(x)) for x in lo), bool, lo.size)
        return out

    def to_array(self) -> np.ndarray:
        """All values, sorted, as uint32 (sequential access, paper sec 5.5)."""
        parts = []
        for k, c in zip(self.keys, self.containers):
            parts.append((np.uint32(k) << np.uint32(16)) |
                         c.to_array_values().astype(np.uint32))
        if not parts:
            return np.zeros(0, dtype=np.uint32)
        return np.concatenate(parts)

    def __iter__(self):
        return iter(self.to_array().tolist())

    def __eq__(self, other) -> bool:
        if not isinstance(other, RoaringBitmap):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())

    def __hash__(self):  # content hash for caching in the data pipeline
        return hash(self.to_array().tobytes())

    # ------------------------------------------------------------------
    # point updates
    # ------------------------------------------------------------------

    def add(self, v: int) -> None:
        self._prefix = None                      # invalidate rank cache
        self._version += 1
        hi, lo = int(v) >> 16, int(v) & 0xFFFF
        i = bisect.bisect_left(self.keys, hi)
        if i < len(self.keys) and self.keys[i] == hi:
            cont = self.containers[i]
            if isinstance(cont, BitsetContainer):
                # copy-on-write: wide aggregates pass containers through
                # zero-copy, so point updates must never mutate in place
                words = cont.words.copy()
                delta = C.bitset_set_many(
                    words, np.array([lo], dtype=np.uint16))
                self.containers[i] = BitsetContainer(words,
                                                     cont.card + delta)
            else:
                vals = cont.to_array_values()
                j = int(np.searchsorted(vals, np.uint16(lo)))
                if j < vals.size and int(vals[j]) == lo:
                    return
                vals = np.insert(vals, j, np.uint16(lo))
                self.containers[i] = container_from_values(vals)
        else:
            self.keys.insert(i, hi)
            self.containers.insert(
                i, ArrayContainer(np.array([lo], dtype=np.uint16)))

    def remove(self, v: int) -> None:
        self._prefix = None                      # invalidate rank cache
        self._version += 1
        hi, lo = int(v) >> 16, int(v) & 0xFFFF
        i = bisect.bisect_left(self.keys, hi)
        if i == len(self.keys) or self.keys[i] != hi:
            return
        cont = self.containers[i]
        if isinstance(cont, BitsetContainer):
            words = cont.words.copy()              # copy-on-write, as in add
            delta = C.bitset_clear_many(
                words, np.array([lo], dtype=np.uint16))
            cont = BitsetContainer(words, cont.card - delta)
            self.containers[i] = cont
            # paper: deleting from a bitset container may force an array
            # conversion (Roaring tracks cardinality; BitMagic cannot)
            if cont.card <= C.ARRAY_MAX:
                self.containers[i] = ArrayContainer(cont.to_array_values())
        else:
            vals = cont.to_array_values()
            j = int(np.searchsorted(vals, np.uint16(lo)))
            if j >= vals.size or int(vals[j]) != lo:
                return
            vals = np.delete(vals, j)
            self.containers[i] = container_from_values(vals)
        if self.containers[i].card == 0:
            del self.keys[i]
            del self.containers[i]

    # ------------------------------------------------------------------
    # two-by-two set algebra (key-merge at the top, paper layout), through
    # the type-grouped pair planner (repro_torch.core.pairwise): matched
    # container pairs bucket by class (bitset x bitset, array x array,
    # array x bitset) and each class is ONE kernel launch; small pairs stay
    # on the scalar key-merge (paper sections 4.2-4.5).  The operators run
    # on the card ("cuda"; they raise without a GPU); the named methods
    # take ``device=``.
    # ------------------------------------------------------------------

    def _merge(self, other: "RoaringBitmap", op: str, *,
               device=None) -> "RoaringBitmap":
        from repro_torch.core import pairwise
        return pairwise.merge_one(self, other, op, device=device)

    def __and__(self, other):
        return self._merge(other, "and")

    def __or__(self, other):
        return self._merge(other, "or")

    def __xor__(self, other):
        return self._merge(other, "xor")

    def __sub__(self, other):
        return self._merge(other, "andnot")

    def andnot(self, other, *, device=None):
        return self._merge(other, "andnot", device=device)

    # ------------------------------------------------------------------
    # count-only ("fast count", paper section 5.9) and similarity
    # ------------------------------------------------------------------

    def and_card(self, other: "RoaringBitmap", *, device=None) -> int:
        """Intersection cardinality without materializing the result
        (paper section 5.9), planned as a batch of one pair: at most one
        kernel launch per container-type class (tiny pairs stay on the
        scalar host merge).  ``device``: where it runs, "cuda" by
        default."""
        from repro_torch.core import pairwise
        return int(pairwise.pairwise_card("and", [(self, other)],
                                          device=device)[0])

    def or_card(self, other, *, device=None) -> int:
        return (self.cardinality + other.cardinality
                - self.and_card(other, device=device))

    def andnot_card(self, other, *, device=None) -> int:
        return self.cardinality - self.and_card(other, device=device)

    def xor_card(self, other, *, device=None) -> int:
        return (self.cardinality + other.cardinality
                - 2 * self.and_card(other, device=device))

    def jaccard(self, other, *, device=None) -> float:
        inter = self.and_card(other, device=device)
        union = self.cardinality + other.cardinality - inter
        return inter / union if union else 1.0

    def cosine(self, other, *, device=None) -> float:
        inter = self.and_card(other, device=device)
        denom = (self.cardinality * other.cardinality) ** 0.5
        return inter / denom if denom else 1.0

    def intersects(self, other, *, device=None) -> bool:
        return self.and_card(other, device=device) > 0

    # ------------------------------------------------------------------
    # batched pairwise engine (similarity joins: "Compressed bitmap
    # indexes: beyond unions and intersections", Kaser & Lemire)
    # ------------------------------------------------------------------

    @staticmethod
    def pairwise_card(ops, pairs, *, backend=None,
                      device=None) -> np.ndarray:
        """Count-only set algebra over M bitmap pairs in O(container-type
        classes) launches (not O(pairs)).

        Args: ``ops`` is one of "and" | "or" | "xor" | "andnot" or a
        length-M sequence of per-pair op names; ``pairs`` is a sequence
        of ``(RoaringBitmap, RoaringBitmap)``; ``backend`` forces the
        kernel launches ("cuda") or their plain versions ("ref") where the
        default on the CPU takes the numpy host twins; ``device`` where it
        runs, "cuda" by default.

        Returns (M,) int64 counts, each derived from the pair's AND
        cardinality by inclusion-exclusion (paper section 5.9)."""
        from repro_torch.core import pairwise
        return pairwise.pairwise_card(ops, pairs, backend=backend,
                                      device=device)

    @staticmethod
    def jaccard_matrix(bitmaps, *, backend=None,
                       device=None) -> np.ndarray:
        """(N, N) float64 Jaccard similarity matrix: the all-pairs
        similarity join, batched class-wise over all N*(N-1)/2 pairs
        (diagonal is 1.0; empty-vs-empty scores 1.0 by convention).  For
        top-k neighbour queries use ``core.pairwise.SimilarityEngine``,
        which never materializes the full matrix."""
        from repro_torch.core import pairwise
        return pairwise.jaccard_matrix(bitmaps, backend=backend,
                                       device=device)

    # ------------------------------------------------------------------
    # wide aggregates (paper section 5.8: roaring_bitmap_or_many), routed
    # through the segmented-aggregation planner (repro_torch.core.
    # aggregate): containers sharing a chunk key become the rows of one
    # segment, and one kernel launch reduces every segment, whatever K.
    # ``arena``: an optional BitmapArena whose resident containers are read
    # from the device slab; ``device``: where the kernel runs ("cuda" by
    # default; with an arena, the arena's device); ``mesh``: an optional
    # ``dist.WideMesh`` -- with more than one shard, rows shard round-robin
    # and the partials fold across shards.  Results are bit-identical with
    # or without an arena or a mesh.
    # ------------------------------------------------------------------

    @staticmethod
    def or_many(bitmaps: list["RoaringBitmap"], *, arena=None,
                device=None, mesh=None) -> "RoaringBitmap":
        """Wide union (paper section 5.8, ``roaring_bitmap_or_many``)."""
        from repro_torch.core import aggregate
        return aggregate.or_many(bitmaps, arena=arena, device=device,
                                 mesh=mesh)

    @staticmethod
    def and_many(bitmaps: list["RoaringBitmap"], *, arena=None,
                 device=None, mesh=None) -> "RoaringBitmap":
        """Wide intersection with cardinality-ascending key pruning and
        empty-key early exit."""
        from repro_torch.core import aggregate
        return aggregate.and_many(bitmaps, arena=arena, device=device,
                                  mesh=mesh)

    @staticmethod
    def xor_many(bitmaps: list["RoaringBitmap"], *, arena=None,
                 device=None, mesh=None) -> "RoaringBitmap":
        """Wide symmetric difference: values present in an odd number of
        inputs."""
        from repro_torch.core import aggregate
        return aggregate.xor_many(bitmaps, arena=arena, device=device,
                                  mesh=mesh)

    @staticmethod
    def andnot_many(minuend: "RoaringBitmap",
                    subtrahends: list["RoaringBitmap"], *, arena=None,
                    device=None, mesh=None) -> "RoaringBitmap":
        """Difference chain ``a - (b1 | b2 | ...)`` as one fused plan: the
        subtrahend union is never materialized."""
        from repro_torch.core import aggregate
        return aggregate.andnot_many(minuend, subtrahends, arena=arena,
                                     device=device, mesh=mesh)

    @staticmethod
    def threshold_many(bitmaps: list["RoaringBitmap"], t: int, *,
                       weights=None, arena=None, device=None,
                       mesh=None) -> "RoaringBitmap":
        """T-occurrence query ("Threshold and Symmetric Functions over
        Bitmaps", Kaser & Lemire): values whose (weighted) occurrence count
        across the inputs reaches ``t``; ``weights`` are optional
        per-bitmap positive ints."""
        from repro_torch.core import aggregate
        return aggregate.threshold_many(bitmaps, t, weights=weights,
                                        arena=arena, device=device,
                                        mesh=mesh)

    # ------------------------------------------------------------------
    # serialization (paper section 5.1; docs/FORMAT.md)
    # ------------------------------------------------------------------

    def serialize(self, format: str = "rj02") -> bytes:
        """Serialize to one of the three wire formats (docs/FORMAT.md):
        ``"rj02"`` (private, CRC-checksummed), ``"portable"`` (the
        CRoaring/RoaringFormatSpec interchange layout, paper section
        5.1) or ``"frozen"`` (zero-copy mmap layout whose deserialize
        is pure views).  Returns ``bytes``, identical to the JAX
        package's; complexity O(payload bytes).  Module-level twins live
        in ``repro_torch.core.serde``."""
        from repro_torch.core import serde
        try:
            fn = {"rj02": serde.serialize,
                  "portable": serde.serialize_portable,
                  "frozen": serde.serialize_frozen}[format]
        except KeyError:
            raise ValueError(
                f"unknown serialization format {format!r}") from None
        return fn(self)

    @classmethod
    def deserialize(cls, buf, format: str = "auto") -> "RoaringBitmap":
        """Parse any of the three wire formats (docs/FORMAT.md).

        Args: ``buf`` bytes-like (or ``np.memmap`` for the frozen
        zero-copy path); ``format`` one of ``"auto"`` (sniff the
        magic/cookie), ``"rj02"``, ``"portable"``, ``"frozen"``.

        Returns a RoaringBitmap (frozen buffers yield view-backed
        containers -- zero payload copies).  Raises ``ValueError``
        with byte offset + container index on corruption."""
        from repro_torch.core import serde
        if format == "auto":
            format = serde.sniff_format(buf)
        try:
            fn = {"rj02": serde.deserialize,
                  "portable": serde.deserialize_portable,
                  "frozen": serde.deserialize_frozen}[format]
        except KeyError:
            raise ValueError(
                f"unknown serialization format {format!r}") from None
        return fn(buf)

    # ------------------------------------------------------------------
    # maintenance (paper: run_optimize / shrink_to_fit)
    # ------------------------------------------------------------------

    def run_optimize(self) -> "RoaringBitmap":
        self.containers = [optimize(c) for c in self.containers]
        self._prefix = None                      # invalidate rank cache
        self._version += 1
        return self

    def memory_bytes(self) -> int:
        """Estimated in-memory footprint (paper section 5.4 accounting):
        per-container payload + 8 bytes/container of key+type+card overhead
        + 16 bytes of top-level header."""
        payload = sum(c.memory_bytes() for c in self.containers)
        return payload + 8 * len(self.containers) + 16

    def bits_per_value(self) -> float:
        card = self.cardinality
        return 8.0 * self.memory_bytes() / card if card else float("inf")

    # ------------------------------------------------------------------
    # rank / select (advanced queries, paper section 6)
    # ------------------------------------------------------------------

    def rank(self, v: int) -> int:
        """Number of elements <= v: one binary search over the cached
        cumulative-cardinality prefix (paper section 6), then a per-kind
        in-container rank -- no per-container Python loop."""
        hi, lo = int(v) >> 16, int(v) & 0xFFFF
        if not self.keys:
            return 0
        prefix = self._card_prefix()
        i = bisect.bisect_left(self.keys, hi)
        base = int(prefix[i - 1]) if i > 0 else 0
        if i < len(self.keys) and self.keys[i] == hi:
            return base + C.container_rank(self.containers[i], lo)
        return base

    def select(self, i: int) -> int:
        """i-th smallest element (0-based): binary search the cached
        prefix for the owning container, then a per-kind in-container
        select (paper section 6)."""
        i = int(i)
        if i < 0:
            raise IndexError(i)
        prefix = self._card_prefix()
        if prefix.size == 0 or i >= int(prefix[-1]):
            raise IndexError("select out of range")
        j = int(np.searchsorted(prefix, i, side="right"))
        local = i - (int(prefix[j - 1]) if j else 0)
        return (self.keys[j] << 16) | \
            C.container_select(self.containers[j], local)

    def min(self) -> int:
        if not self.containers:
            raise ValueError("empty bitmap")
        return self.select(0)

    def max(self) -> int:
        if not self.containers:
            raise ValueError("empty bitmap")
        c = self.containers[-1]
        return (self.keys[-1] << 16) | C.container_select(c, c.card - 1)

    def __repr__(self) -> str:
        kinds = {}
        for c in self.containers:
            kinds[c.kind] = kinds.get(c.kind, 0) + 1
        return (f"RoaringBitmap(card={self.cardinality}, "
                f"containers={len(self.containers)}, kinds={kinds})")
