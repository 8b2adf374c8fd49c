"""Container-level algorithms for Roaring bitmaps (host / numpy path).

This module is the faithful reproduction of the paper's container layer:

  * array containers   -- <= 4096 sorted distinct uint16 values  (8 kB max)
  * bitset containers  -- 2^16 bits as 1024 x uint64 words (8 kB) + tracked
                          cardinality (the paper tracks cardinality per bitset
                          container; so do we)
  * run containers     -- sorted <start, length> pairs, run covers
                          [start, start + length] inclusive (paper section 1)

Vectorization: the numpy path plays the role of the paper's SIMD code (it is
what "wide registers" look like from Python).

This is a numpy-only copy of the JAX package's ``core/containers.py``: the
port keeps its own so that importing it never pulls in JAX.

Result-kind policy (paper section 1 / section 2.2): binary set operations
materialize either an array (card <= 4096) or a bitset (card > 4096); run
containers are produced only by `optimize` (the analogue of
`roaring_bitmap_run_optimize`), which picks the smallest of the three
representations subject to the paper's constraints (<= 2047 runs).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# constants (paper section 1)
# ---------------------------------------------------------------------------

CHUNK = 1 << 16          # values per chunk / container universe
ARRAY_MAX = 4096         # max cardinality of an array container
BITSET_WORDS = 1024      # 2^16 / 64 words of uint64
MAX_RUNS = 2047          # run container may hold at most this many runs
GALLOP_RATIO = 64        # size skew beyond which intersection gallops (sec 4.2)

_ONE = np.uint64(1)
_U64_63 = np.uint64(63)


# ---------------------------------------------------------------------------
# low level bitset helpers (the paper's section 3 primitives, vectorized)
# ---------------------------------------------------------------------------

def popcount_words(words: np.ndarray) -> int:
    """Population count of an array of uint64 words (section 4.1.1)."""
    return int(np.bitwise_count(words).sum())


def bitset_set_many(words: np.ndarray, values: np.ndarray) -> int:
    """Set bits at `values` (uint16 indexes); return the number of *newly*
    set bits, i.e. the cardinality change (paper section 3.2 XOR trick,
    vectorized).  Mutates `words` in place."""
    if values.size == 0:
        return 0
    idx = (values >> 4).astype(np.int64) >> 2          # values // 64
    bit = np.left_shift(_ONE, (values.astype(np.uint64) & _U64_63))
    old = words.copy()
    np.bitwise_or.at(words, idx, bit)
    # cardinality delta = popcount(old XOR new), exactly the paper's trick
    return int(np.bitwise_count(old ^ words).sum())


def bitset_clear_many(words: np.ndarray, values: np.ndarray) -> int:
    """Clear bits at `values`; return the number of bits actually cleared."""
    if values.size == 0:
        return 0
    idx = (values >> 4).astype(np.int64) >> 2
    bit = np.left_shift(_ONE, (values.astype(np.uint64) & _U64_63))
    old = words.copy()
    np.bitwise_and.at(words, idx, ~bit)
    return int(np.bitwise_count(old ^ words).sum())


def bitset_flip_many(words: np.ndarray, values: np.ndarray) -> int:
    """Flip bits at `values` (must be distinct); return cardinality delta."""
    if values.size == 0:
        return 0
    idx = (values >> 4).astype(np.int64) >> 2
    bit = np.left_shift(_ONE, (values.astype(np.uint64) & _U64_63))
    before = int(np.bitwise_count(words).sum())
    np.bitwise_xor.at(words, idx, bit)
    return int(np.bitwise_count(words).sum()) - before


def bitset_test_many(words: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized `bt`: boolean mask of which `values` are present."""
    if values.size == 0:
        return np.zeros(0, dtype=bool)
    idx = (values >> 4).astype(np.int64) >> 2
    sh = values.astype(np.uint64) & _U64_63
    return ((words[idx] >> sh) & _ONE).astype(bool)


def bitset_to_positions(words: np.ndarray) -> np.ndarray:
    """Bitset -> sorted uint16 array (paper section 3.1 blsi/tzcnt loop; the
    numpy idiom is unpackbits + flatnonzero, our TPU idiom is a prefix sum)."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def positions_to_bitset(values: np.ndarray) -> np.ndarray:
    """Sorted distinct uint16 values -> 1024 x uint64 bitset words.

    Indicator stores + packbits: a fresh bitset needs no read-modify-write
    scatter (np.bitwise_or.at) and no cardinality delta, so plain vector
    stores into a byte indicator beat bitset_set_many by a wide margin."""
    ind = np.zeros(CHUNK, dtype=np.uint8)
    ind[values] = 1
    return np.packbits(ind, bitorder="little").view(np.uint64)


def bitset_num_runs(words: np.ndarray) -> int:
    """Number of runs of consecutive 1s in the bitset (for run_optimize).

    runs = sum_w popcount(w & ~(w << 1))  with the carry of the previous
    word's msb folded in (standard CRoaring formula).
    """
    shifted = words << _ONE
    # bring in the msb of the previous word as lsb carry
    carry = np.zeros_like(words)
    carry[1:] = words[:-1] >> np.uint64(63)
    starts = words & ~(shifted | carry)
    return int(np.bitwise_count(starts).sum())


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

class ArrayContainer:
    """<= 4096 sorted distinct uint16 values."""

    __slots__ = ("values",)
    kind = "array"

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=np.uint16)

    @property
    def card(self) -> int:
        return int(self.values.size)

    def contains(self, v: int) -> bool:
        i = int(np.searchsorted(self.values, np.uint16(v)))
        return i < self.values.size and int(self.values[i]) == int(v)

    def to_array_values(self) -> np.ndarray:
        return self.values

    def to_bitset(self) -> "BitsetContainer":
        return BitsetContainer(positions_to_bitset(self.values), self.card)

    def num_runs(self) -> int:
        if self.values.size == 0:
            return 0
        v = self.values.astype(np.int32)
        return int(np.count_nonzero(np.diff(v) > 1)) + 1

    def memory_bytes(self) -> int:
        return 2 * self.card

    def __eq__(self, other) -> bool:  # pragma: no cover - debugging aid
        return isinstance(other, ArrayContainer) and np.array_equal(
            self.values, other.values)


class BitsetContainer:
    """2^16-bit bitset with tracked cardinality."""

    __slots__ = ("words", "card")
    kind = "bitset"

    def __init__(self, words: np.ndarray, card: int | None = None):
        self.words = np.asarray(words, dtype=np.uint64)
        self.card = popcount_words(self.words) if card is None else int(card)

    def contains(self, v: int) -> bool:
        return bool((int(self.words[v >> 6]) >> (v & 63)) & 1)

    def to_array_values(self) -> np.ndarray:
        return bitset_to_positions(self.words)

    def to_bitset(self) -> "BitsetContainer":
        return self

    def num_runs(self) -> int:
        return bitset_num_runs(self.words)

    def memory_bytes(self) -> int:
        return 8 * BITSET_WORDS

    def __eq__(self, other) -> bool:  # pragma: no cover
        return isinstance(other, BitsetContainer) and np.array_equal(
            self.words, other.words)


class RunContainer:
    """Sorted non-overlapping, non-adjacent runs: (n, 2) int32 of
    [start, length]; run covers [start, start + length] inclusive."""

    __slots__ = ("runs",)
    kind = "run"

    def __init__(self, runs: np.ndarray):
        self.runs = np.asarray(runs, dtype=np.int32).reshape(-1, 2)

    @property
    def card(self) -> int:
        if self.runs.size == 0:
            return 0
        return int((self.runs[:, 1] + 1).sum())

    def contains(self, v: int) -> bool:
        if self.runs.size == 0:
            return False
        i = int(np.searchsorted(self.runs[:, 0], v, side="right")) - 1
        if i < 0:
            return False
        s, l = int(self.runs[i, 0]), int(self.runs[i, 1])
        return s <= v <= s + l

    def to_array_values(self) -> np.ndarray:
        if self.runs.size == 0:
            return np.zeros(0, dtype=np.uint16)
        lens = self.runs[:, 1] + 1
        total = int(lens.sum())
        # vectorized expansion of [s, s+l] ranges
        out = np.ones(total, dtype=np.int64)
        ends = np.cumsum(lens)
        starts_idx = np.concatenate(([0], ends[:-1]))
        out[starts_idx] = self.runs[:, 0]
        out[starts_idx[1:]] -= self.runs[:-1, 0] + self.runs[:-1, 1]
        return np.cumsum(out).astype(np.uint16)

    def to_bitset(self) -> BitsetContainer:
        n = self.runs.shape[0]
        if n == 0:
            return BitsetContainer(np.zeros(BITSET_WORDS, np.uint64), 0)
        if n < 8:
            # a handful of runs: per-run word masking beats the 2^16 sweep
            return self._to_bitset_scalar()
        # vectorized: +1/-1 deltas at run bounds, occupancy = prefix sum > 0
        starts = self.runs[:, 0].astype(np.int64)
        ends = starts + self.runs[:, 1].astype(np.int64)   # inclusive
        # runs are non-overlapping and non-adjacent, so the delta indices
        # are distinct within each statement: plain fancy stores suffice
        delta = np.zeros(CHUNK + 1, dtype=np.int32)
        delta[starts] = 1
        delta[ends + 1] = -1
        occ = np.cumsum(delta[:CHUNK]) > 0
        words = np.packbits(occ, bitorder="little").view(np.uint64)
        return BitsetContainer(words, self.card)

    def _to_bitset_scalar(self) -> BitsetContainer:
        words = np.zeros(BITSET_WORDS, dtype=np.uint64)
        card = 0
        for s, l in self.runs.tolist():
            e = s + l  # inclusive
            w0, w1 = s >> 6, e >> 6
            if w0 == w1:
                mask = ((1 << (e - s + 1)) - 1) << (s & 63)
                words[w0] |= np.uint64(mask & 0xFFFFFFFFFFFFFFFF)
            else:
                words[w0] |= np.uint64(
                    (0xFFFFFFFFFFFFFFFF << (s & 63)) & 0xFFFFFFFFFFFFFFFF)
                if w1 > w0 + 1:
                    words[w0 + 1:w1] = np.uint64(0xFFFFFFFFFFFFFFFF)
                words[w1] |= np.uint64(
                    0xFFFFFFFFFFFFFFFF >> (63 - (e & 63)))
            card += l + 1
        return BitsetContainer(words, card)

    def num_runs(self) -> int:
        return int(self.runs.shape[0])

    def memory_bytes(self) -> int:
        return 4 * self.num_runs() + 2

    def __eq__(self, other) -> bool:  # pragma: no cover
        return isinstance(other, RunContainer) and np.array_equal(
            self.runs, other.runs)


Container = ArrayContainer | BitsetContainer | RunContainer


# ---------------------------------------------------------------------------
# constructors / conversions
# ---------------------------------------------------------------------------

def container_from_values(values: np.ndarray) -> Container:
    """Build the canonical array-or-bitset container from sorted distinct
    uint16 values (paper: no array container may exceed 4096 values)."""
    values = np.asarray(values, dtype=np.uint16)
    if values.size <= ARRAY_MAX:
        return ArrayContainer(values)
    return BitsetContainer(positions_to_bitset(values), int(values.size))


def runs_from_sorted_values(values: np.ndarray) -> np.ndarray:
    """(n, 2) [start, length] runs from sorted distinct values."""
    if values.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    v = values.astype(np.int32)
    breaks = np.flatnonzero(np.diff(v) > 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [v.size - 1]))
    return np.stack([v[starts], v[ends] - v[starts]], axis=1).astype(np.int32)


def optimize(c: Container) -> Container:
    """Pick the smallest representation (run_optimize + shrink_to_fit).

    Paper constraints: a run container with more than 4096 distinct values
    must have <= 2047 runs; below 4097 values the run count must be less than
    half the cardinality.  This is exactly "choose the smallest of
    {2*card, 8192, 4*runs+2} bytes" with the MAX_RUNS cap.
    """
    card = c.card
    if card == 0:
        return ArrayContainer(np.zeros(0, dtype=np.uint16))
    runs = c.num_runs()
    run_bytes = 4 * runs + 2
    array_bytes = 2 * card
    bitset_bytes = 8 * BITSET_WORDS
    best = min(run_bytes if runs <= MAX_RUNS else 1 << 30,
               array_bytes if card <= ARRAY_MAX else 1 << 30,
               bitset_bytes)
    if runs <= MAX_RUNS and best == run_bytes:
        if isinstance(c, RunContainer):
            return c
        return RunContainer(runs_from_sorted_values(c.to_array_values()))
    if card <= ARRAY_MAX and best == array_bytes:
        if isinstance(c, ArrayContainer):
            return c
        return ArrayContainer(c.to_array_values())
    return c.to_bitset()


def containers_to_word_rows(conts) -> np.ndarray:
    """Batch-convert ``conts`` to an ``(len(conts), 1024)`` uint64
    block of bitset-domain word rows -- the vectorized twin of calling
    :func:`container_words64` per container.

    The bulk cold-start path (``BitmapArena.adopt_frozen``) rides on
    this: bitset rows are gathered with one fancy-index store, and ALL
    array/run containers set their bits through one global (row, value)
    stream (runs expand with the same global cumsum trick as
    ``RunContainer.to_array_values``) and one ``np.bitwise_or.at`` into
    the output's 32-bit words.  No per-container conversion work happens
    in Python.  (The JAX package's copy sweeps a uint8 indicator matrix in
    256-row blocks, testing every value against every block: quadratic in
    the container count, over a minute for the quarter million array
    containers of a 2^24-document index.  The words are the same.)
    Complexity: O(total payload values); returns a fresh writable array
    safe to hand to a device slab.  Raises ``IndexError`` for a value
    outside [0, 65535], as the indicator would.
    """
    n = len(conts)
    out = np.zeros((n, BITSET_WORDS), np.uint64)
    bit_idx, bit_rows = [], []
    dense_idx: list[int] = []          # array/run containers, in order
    val_parts, val_owner = [], []      # point values + local dense row
    run_parts, run_owner = [], []      # (m, 2) runs + local dense row
    for i, c in enumerate(conts):
        if isinstance(c, BitsetContainer):
            bit_idx.append(i)
            bit_rows.append(c.words)
        elif isinstance(c, ArrayContainer):
            if c.values.size:
                val_parts.append(c.values)
                val_owner.append((len(dense_idx), c.values.size))
            dense_idx.append(i)
        else:
            if c.runs.size:
                run_parts.append(c.runs.astype(np.int64))
                run_owner.append((len(dense_idx), c.runs.shape[0]))
            dense_idx.append(i)
    if bit_idx:
        out[np.asarray(bit_idx)] = np.stack(bit_rows)
    if not val_parts and not run_parts:
        return out
    # one global (row, value) stream for every array value and every
    # run-expanded value
    rows_list, vals_list = [], []
    if val_parts:
        vals_list.append(np.concatenate(val_parts).astype(np.int64))
        rows_list.append(np.repeat(
            np.asarray([o for o, _ in val_owner], np.int64),
            np.asarray([s for _, s in val_owner], np.int64)))
    if run_parts:
        runs = np.concatenate(run_parts)           # (R, 2) [start, len]
        lens = runs[:, 1] + 1
        total = int(lens.sum())
        ends = np.cumsum(lens)
        starts_idx = np.concatenate(([0], ends[:-1]))
        expand = np.ones(total, dtype=np.int64)
        expand[starts_idx] = runs[:, 0]
        expand[starts_idx[1:]] -= runs[:-1, 0] + runs[:-1, 1]
        vals_list.append(np.cumsum(expand))
        owner = np.repeat(
            np.asarray([o for o, _ in run_owner], np.int64),
            np.asarray([m for _, m in run_owner], np.int64))
        rows_list.append(np.repeat(owner, lens))
    rows = np.concatenate(rows_list)
    vals = np.concatenate(vals_list)
    if vals.size and (vals.min() < 0 or vals.max() >= CHUNK):
        raise IndexError("a container value lies outside [0, 65535]")
    dense = np.asarray(dense_idx, np.int64)
    words32 = out.view(np.uint32).reshape(-1)  # bit i in word i >> 5 (LE)
    np.bitwise_or.at(words32, dense[rows] * (2 * BITSET_WORDS) + (vals >> 5),
                     np.left_shift(np.uint32(1),
                                   (vals & 31).astype(np.uint32)))
    return out


def container_words64(c: Container) -> np.ndarray:
    """Any container -> its (1024,) uint64 bitset-domain words (the
    shared promotion step of the aggregate / pairwise / top-k planners)."""
    if isinstance(c, BitsetContainer):
        return c.words
    return c.to_bitset().words


def _as_array_or_bitset(c: Container) -> Container:
    """Normalize a run container to whichever dense form is cheaper for ops."""
    if isinstance(c, RunContainer):
        return ArrayContainer(c.to_array_values()) if c.card <= ARRAY_MAX \
            else c.to_bitset()
    return c


def _result_from_bitset(words: np.ndarray, card: int | None = None) -> Container:
    card = popcount_words(words) if card is None else card
    if card > ARRAY_MAX:
        return BitsetContainer(words, card)
    return ArrayContainer(bitset_to_positions(words))


# ---------------------------------------------------------------------------
# array <-> array primitives (paper sections 4.2 - 4.5)
# ---------------------------------------------------------------------------

def array_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-array intersection.  Mirrors the paper's dual strategy: a
    merge-style intersection for similar sizes (the vectorized pcmpistrm
    algorithm's role) and a galloping / binary-search intersection when one
    input is much smaller (section 4.2, [42])."""
    if a.size == 0 or b.size == 0:
        return np.zeros(0, dtype=np.uint16)
    if a.size > b.size:
        a, b = b, a
    if b.size > GALLOP_RATIO * a.size:
        # galloping: binary-search each element of the small array
        idx = np.searchsorted(b, a)
        idx[idx == b.size] = b.size - 1
        return a[b[idx] == a]
    return np.intersect1d(a, b, assume_unique=True)


def array_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.union1d(a, b).astype(np.uint16)


def array_difference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.size == 0:
        return np.zeros(0, dtype=np.uint16)
    if b.size == 0:
        return a.copy()
    if b.size > GALLOP_RATIO * a.size:
        idx = np.searchsorted(b, a)
        idx[idx == b.size] = b.size - 1
        return a[b[idx] != a]
    return np.setdiff1d(a, b, assume_unique=True).astype(np.uint16)


def array_symmetric_difference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.setxor1d(a, b, assume_unique=True).astype(np.uint16)


# ---------------------------------------------------------------------------
# binary operations between containers
# ---------------------------------------------------------------------------

def container_and(x: Container, y: Container) -> Container:
    x, y = _as_array_or_bitset(x), _as_array_or_bitset(y)
    xa, ya = isinstance(x, ArrayContainer), isinstance(y, ArrayContainer)
    if xa and ya:
        return ArrayContainer(array_intersect(x.values, y.values))
    if xa:
        return ArrayContainer(x.values[bitset_test_many(y.words, x.values)])
    if ya:
        return ArrayContainer(y.values[bitset_test_many(x.words, y.values)])
    words = x.words & y.words
    return _result_from_bitset(words)


def container_or(x: Container, y: Container) -> Container:
    x, y = _as_array_or_bitset(x), _as_array_or_bitset(y)
    xa, ya = isinstance(x, ArrayContainer), isinstance(y, ArrayContainer)
    if xa and ya:
        # paper heuristic: guess whether the output exceeds the array limit
        if x.card + y.card > ARRAY_MAX:
            words = positions_to_bitset(x.values)
            card = popcount_words(words)
            card += bitset_set_many(words, y.values)
            return _result_from_bitset(words, card)
        return ArrayContainer(array_union(x.values, y.values))
    if xa:
        x, y = y, x  # x bitset, y array
    if isinstance(y, ArrayContainer):
        words = x.words.copy()
        card = x.card + bitset_set_many(words, y.values)
        return BitsetContainer(words, card)  # card >= x.card > 4096
    words = x.words | y.words
    return _result_from_bitset(words)


def container_xor(x: Container, y: Container) -> Container:
    x, y = _as_array_or_bitset(x), _as_array_or_bitset(y)
    xa, ya = isinstance(x, ArrayContainer), isinstance(y, ArrayContainer)
    if xa and ya:
        out = array_symmetric_difference(x.values, y.values)
        return container_from_values(out)
    if xa:
        x, y = y, x
    if isinstance(y, ArrayContainer):
        words = x.words.copy()
        card = x.card + bitset_flip_many(words, y.values)
        return _result_from_bitset(words, card)
    words = x.words ^ y.words
    return _result_from_bitset(words)


def container_andnot(x: Container, y: Container) -> Container:
    x, y = _as_array_or_bitset(x), _as_array_or_bitset(y)
    xa, ya = isinstance(x, ArrayContainer), isinstance(y, ArrayContainer)
    if xa and ya:
        return ArrayContainer(array_difference(x.values, y.values))
    if xa:
        keep = ~bitset_test_many(y.words, x.values)
        return ArrayContainer(x.values[keep])
    if ya:
        words = x.words.copy()
        card = x.card - bitset_clear_many(words, y.values)
        return _result_from_bitset(words, card)
    words = x.words & ~y.words
    return _result_from_bitset(words)


# ---------------------------------------------------------------------------
# in-container rank / select (the chunk-level half of paper section 6):
# vectorized per kind, never expanding the container to a value array.
# ---------------------------------------------------------------------------

def container_rank(c: Container, v: int) -> int:
    """Number of container values <= v (v in [0, 2^16))."""
    v = int(v)
    if isinstance(c, ArrayContainer):
        return int(np.searchsorted(c.values, np.uint16(v), side="right"))
    if isinstance(c, BitsetContainer):
        w = v >> 6
        partial = int(c.words[w]) & ((2 << (v & 63)) - 1)
        return int(np.bitwise_count(c.words[:w]).sum()) + partial.bit_count()
    if c.runs.size == 0:
        return 0
    i = int(np.searchsorted(c.runs[:, 0], v, side="right")) - 1
    if i < 0:
        return 0
    base = int((c.runs[:i, 1] + 1).sum())
    s, ln = int(c.runs[i, 0]), int(c.runs[i, 1])
    return base + min(v - s, ln) + 1


def container_select(c: Container, i: int) -> int:
    """The i-th smallest container value (0-based; requires i < card)."""
    i = int(i)
    if isinstance(c, ArrayContainer):
        return int(c.values[i])
    if isinstance(c, BitsetContainer):
        cs = np.cumsum(np.bitwise_count(c.words))
        w = int(np.searchsorted(cs, i, side="right"))
        prior = int(cs[w - 1]) if w else 0
        bits = np.flatnonzero(np.unpackbits(
            c.words[w:w + 1].view(np.uint8), bitorder="little"))
        return (w << 6) + int(bits[i - prior])
    cum = np.cumsum(c.runs[:, 1] + 1)
    r = int(np.searchsorted(cum, i, side="right"))
    prior = int(cum[r - 1]) if r else 0
    return int(c.runs[r, 0]) + (i - prior)


# ---------------------------------------------------------------------------
# count-only variants (paper section 5.9 "fast counts"):
# never materialize the result container.
# ---------------------------------------------------------------------------

def container_and_card(x: Container, y: Container) -> int:
    x, y = _as_array_or_bitset(x), _as_array_or_bitset(y)
    xa, ya = isinstance(x, ArrayContainer), isinstance(y, ArrayContainer)
    if xa and ya:
        return int(array_intersect(x.values, y.values).size)
    if xa:
        return int(np.count_nonzero(bitset_test_many(y.words, x.values)))
    if ya:
        return int(np.count_nonzero(bitset_test_many(x.words, y.values)))
    return popcount_words(x.words & y.words)


def container_or_card(x: Container, y: Container) -> int:
    return x.card + y.card - container_and_card(x, y)


def container_andnot_card(x: Container, y: Container) -> int:
    return x.card - container_and_card(x, y)


def container_xor_card(x: Container, y: Container) -> int:
    return x.card + y.card - 2 * container_and_card(x, y)


OPS = {
    "and": (container_and, container_and_card),
    "or": (container_or, container_or_card),
    "xor": (container_xor, container_xor_card),
    "andnot": (container_andnot, container_andnot_card),
}
