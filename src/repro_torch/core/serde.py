"""Serialization for RoaringBitmap: three on-disk layouts, one module.

Byte-exact specifications (plus a worked hex example and a CRoaring
compatibility table) live in ``docs/FORMAT.md``; this docstring is the
short map.  Paper section 5.1: "The CRoaring library supports a compact
and portable serialization format"; in-memory and serialized sizes are
nearly identical.

1. **RJ02** (``serialize`` / ``deserialize``) -- the private
   checksummed format: CRC-32 over the whole body, explicit kind bytes,
   strict structural validation.  Use it for checkpoints that must
   detect corruption (``data/pipeline.py`` checkpoints ride on it).
2. **Portable** (``serialize_portable`` / ``deserialize_portable``) --
   the CRoaring/RoaringFormatSpec interchange layout (cookies 12346 /
   12347): what ``roaring_bitmap_portable_serialize`` writes and every
   Roaring implementation (C, Java, Go, ...) reads.  No checksum; kind
   is inferred (run flag bitmap, else cardinality > 4096 => bitset).
3. **Frozen** (``serialize_frozen`` / ``deserialize_frozen``) -- the
   mmap-first layout: payloads grouped into per-kind zones so
   deserialization is a handful of numpy *views* over one buffer --
   zero payload bytes are read or copied (``np.shares_memory`` holds
   for every container, asserted by tests).  A node maps a snapshot
   and answers its first query in milliseconds; see
   ``BitmapArena.adopt_frozen`` for the bulk device promotion.

``write_snapshot`` / ``read_snapshot`` bundle many *named* frozen
bitmaps (an inverted index) into one mmap-able archive -- the segment
format of ``data.pipeline.StreamingIndexBuilder``.

Robustness contract: ``deserialize`` of ANY corrupted RJ02 buffer
raises ``ValueError`` -- never a crash, hang, or a silently-wrong
bitmap -- and every truncation/validation error reports the byte
offset where the parse died plus the container index when one is in
scope.  Two layers enforce it: the CRC rejects every byte flip up
front (CRC-32 catches all error bursts <= 32 bits, so every
single-byte corruption), and structural validation (sorted keys,
per-kind payload invariants, card cross-checks, no trailing bytes)
rejects buffers that were built wrong rather than damaged in flight.
The portable format has no checksum (the spec has none), so only the
structural layer stands: header/cardinality/offset corruption is
detected, but a flipped *key* byte that stays sorted is not -- see
docs/FORMAT.md section 4 for the honest table.  The frozen format
validates its directory vectorized but never touches payload zones
(that would defeat lazy mmap paging); treat it as trusted local
storage, not an interchange format.

This is a numpy-only copy of the JAX package's ``core/serde.py``: the
port keeps its own so that importing it never pulls in JAX.  Every
format's bytes are identical to the JAX package's, and each package
reads the other's.
"""

from __future__ import annotations

import struct
import zlib
from collections.abc import MutableMapping

import numpy as np

from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.containers import (
    ARRAY_MAX, ArrayContainer, BitsetContainer, RunContainer, BITSET_WORDS,
)

MAGIC = b"RJ02"

# CRoaring / RoaringFormatSpec constants (docs/FORMAT.md section 3)
SERIAL_COOKIE = 12347                  # with run containers (uint16)
SERIAL_COOKIE_NO_RUNCONTAINER = 12346  # without run containers (uint32)
NO_OFFSET_THRESHOLD = 4                # run format omits offsets below this

MAGIC_FROZEN = b"RJFZ0001"
MAGIC_SNAPSHOT = b"RJSN0001"

_MAX_CONTAINERS = 1 << 16              # keys are uint16, so n can't exceed


# ---------------------------------------------------------------------------
# RJ02: the private checksummed format
# ---------------------------------------------------------------------------

def serialize(bm: RoaringBitmap) -> bytes:
    """Serialize ``bm`` to the private checksummed RJ02 wire format.

    Args: ``bm`` any RoaringBitmap (container kinds are preserved
    exactly, including bitsets below the 4096 threshold).

    Returns ``bytes``: magic + CRC-32 + directory + payloads
    (docs/FORMAT.md section 2 has the byte-exact layout).  Complexity:
    O(total payload bytes); one pass, no per-value work.
    """
    n = len(bm.keys)
    parts = [struct.pack("<I", n)]
    parts.append(np.asarray(bm.keys, dtype=np.uint16).tobytes())
    kinds, cards = [], []
    for c in bm.containers:
        kinds.append({"array": 1, "bitset": 2, "run": 3}[c.kind])
        cards.append(c.card - 1)
    parts.append(np.asarray(kinds, dtype=np.uint8).tobytes())
    parts.append(np.asarray(cards, dtype=np.uint16).tobytes())
    for c in bm.containers:
        if isinstance(c, ArrayContainer):
            parts.append(c.values.tobytes())
        elif isinstance(c, BitsetContainer):
            parts.append(c.words.tobytes())
        else:
            runs = c.runs.astype(np.uint16)
            parts.append(struct.pack("<H", runs.shape[0]))
            parts.append(runs.tobytes())
    body = b"".join(parts)
    return MAGIC + struct.pack("<I", zlib.crc32(body)) + body


def _need(buf: bytes, off: int, nbytes: int, what: str) -> None:
    """Bounds check with an actionable message: truncated/corrupt
    payloads must fail with ValueError (never a bare struct/buffer
    error) that names *what* was being parsed and the exact byte
    offset where the parse died."""
    if off + nbytes > len(buf):
        raise ValueError(
            f"truncated roaring payload: need {nbytes} byte(s) for {what} "
            f"at byte offset {off}, but only {len(buf) - off} remain")


def deserialize(buf: bytes) -> RoaringBitmap:
    """Parse an RJ02 payload produced by :func:`serialize`.

    Args: ``buf`` bytes-like.  Returns a new RoaringBitmap (container
    kinds exactly as serialized).

    Raises ``ValueError`` on ANY corruption -- CRC first (catches every
    single-byte flip), then structural validation; every message
    carries the byte offset where the parse died and the container
    index when one is in scope.  Complexity: O(total payload bytes)
    including the CRC pass.  See docs/FORMAT.md section 2.
    """
    buf = bytes(buf)
    _need(buf, 0, 12, "header")
    if buf[:4] != MAGIC:
        raise ValueError(
            "bad magic; not an RJ02 roaring payload (at byte offset 0)")
    (crc,) = struct.unpack_from("<I", buf, 4)
    if zlib.crc32(buf[8:]) != crc:
        raise ValueError(
            "checksum mismatch; corrupt roaring payload "
            "(crc field at byte offset 4)")
    (n,) = struct.unpack_from("<I", buf, 8)
    if n > _MAX_CONTAINERS:
        raise ValueError(
            f"container count {n} exceeds the 65536 maximum "
            "(count field at byte offset 8)")
    off = 12
    _need(buf, off, 5 * n, f"directory of {n} container(s)")
    keys = np.frombuffer(buf, dtype=np.uint16, count=n, offset=off)
    off += 2 * n
    kinds = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off)
    off += n
    cards = np.frombuffer(buf, dtype=np.uint16, count=n, offset=off)
    off += 2 * n
    if n > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError(
            "container keys not strictly increasing "
            "(key directory at byte offset 12)")
    out_keys, out_conts = [], []
    for i in range(n):
        card = int(cards[i]) + 1
        kind = int(kinds[i])
        po = off                      # payload start, for error messages
        if kind == 1:
            _need(buf, off, 2 * card, f"array container {i} ({card} values)")
            vals = np.frombuffer(buf, dtype=np.uint16, count=card, offset=off)
            off += 2 * card
            if card > 1 and not (vals[1:] > vals[:-1]).all():
                raise ValueError(
                    f"array container {i}: values not strictly increasing "
                    f"(payload at byte offset {po})")
            out_conts.append(ArrayContainer(vals.copy()))
        elif kind == 2:
            _need(buf, off, 8 * BITSET_WORDS, f"bitset container {i}")
            words = np.frombuffer(buf, dtype=np.uint64,
                                  count=BITSET_WORDS, offset=off)
            off += 8 * BITSET_WORDS
            pop = int(np.bitwise_count(words).sum())
            if pop != card:
                raise ValueError(
                    f"bitset container {i}: stored cardinality {card} "
                    f"!= popcount {pop} (payload at byte offset {po})")
            out_conts.append(BitsetContainer(words.copy(), card))
        elif kind == 3:
            _need(buf, off, 2, f"run count of container {i}")
            (nr,) = struct.unpack_from("<H", buf, off)
            off += 2
            _need(buf, off, 4 * nr, f"run container {i} ({nr} runs)")
            runs = np.frombuffer(buf, dtype=np.uint16, count=2 * nr,
                                 offset=off).reshape(nr, 2)
            off += 4 * nr
            starts = runs[:, 0].astype(np.int64)
            ends = starts + runs[:, 1].astype(np.int64)
            if nr == 0 or (ends > 0xFFFF).any() or \
                    (nr > 1 and (starts[1:] <= ends[:-1] + 1).any()):
                raise ValueError(
                    f"run container {i}: runs not disjoint ascending "
                    f"in-bounds intervals (payload at byte offset {po})")
            if int((ends - starts + 1).sum()) != card:
                raise ValueError(
                    f"run container {i}: stored cardinality {card} "
                    f"!= run length total (payload at byte offset {po})")
            out_conts.append(RunContainer(runs.astype(np.int32)))
        else:
            raise ValueError(
                f"bad container kind {kind} for container {i} "
                f"(kind directory at byte offset {12 + 2 * n + i})")
        out_keys.append(int(keys[i]))
    if off != len(buf):
        raise ValueError(
            f"trailing garbage: {len(buf) - off} byte(s) past the last "
            f"container payload (at byte offset {off})")
    return RoaringBitmap(out_keys, out_conts)


def serialized_size_bytes(bm: RoaringBitmap, format: str = "rj02") -> int:
    """Size in bytes ``bm`` serializes to in the given ``format``
    ("rj02" | "portable" | "frozen"), computed WITHOUT serializing
    (the CRoaring ``portable_size_in_bytes`` parity API).

    Complexity: O(containers); no payload bytes are touched.  See
    docs/FORMAT.md for the per-format size formulas.
    """
    if format == "rj02":
        size = 12 + 5 * len(bm.keys)
        for c in bm.containers:
            if isinstance(c, ArrayContainer):
                size += 2 * c.card
            elif isinstance(c, BitsetContainer):
                size += 8 * BITSET_WORDS
            else:
                size += 2 + 4 * c.runs.shape[0]
        return size
    if format == "portable":
        conts = [_portable_canonical(c) for c in bm.containers]
        n = len(conts)
        has_run = any(isinstance(c, RunContainer) for c in conts)
        if has_run:
            size = 4 + (n + 7) // 8
            if n >= NO_OFFSET_THRESHOLD:
                size += 4 * n
        else:
            size = 8 + 4 * n
        size += 4 * n
        return size + sum(_portable_payload_size(c) for c in conts)
    if format == "frozen":
        n = len(bm.keys)
        n_bitset = sum(isinstance(c, BitsetContainer) for c in bm.containers)
        n_values = sum(c.card for c in bm.containers
                       if isinstance(c, ArrayContainer))
        n_runs = sum(c.runs.shape[0] for c in bm.containers
                     if isinstance(c, RunContainer))
        size = _align(32 + 5 * n, 4) + 8 * n
        size = _align(size, 8) + 8 * BITSET_WORDS * n_bitset + 2 * n_values
        return _align(size, 4) + 8 * n_runs
    raise ValueError(f"unknown serialization format {format!r}")


# ---------------------------------------------------------------------------
# portable: the CRoaring / RoaringFormatSpec interchange layout
# ---------------------------------------------------------------------------

def _portable_canonical(c):
    """The portable format infers container kind (run flag, else
    cardinality > 4096 => bitset), so writers must canonicalize: a
    bitset holding <= 4096 values becomes an array, a >4096-value
    array (cannot exist under ARRAY_MAX, kept for safety) a bitset."""
    if isinstance(c, RunContainer):
        return c
    if c.card > ARRAY_MAX:
        return c if isinstance(c, BitsetContainer) else c.to_bitset()
    return c if isinstance(c, ArrayContainer) \
        else ArrayContainer(c.to_array_values())


def _portable_payload_size(c) -> int:
    if isinstance(c, ArrayContainer):
        return 2 * c.card
    if isinstance(c, BitsetContainer):
        return 8 * BITSET_WORDS
    return 2 + 4 * c.runs.shape[0]


def serialize_portable(bm: RoaringBitmap) -> bytes:
    """Serialize ``bm`` to the CRoaring portable interchange format
    (RoaringFormatSpec; what ``roaring_bitmap_portable_serialize``
    writes and CRoaring/RoaringBitmap-Java/roaring-rs read).

    Args: ``bm`` any RoaringBitmap; kinds are canonicalized first
    (bitsets <= 4096 values become arrays) because the wire format
    infers kind from the run-flag bitmap and the cardinality.

    Returns ``bytes``.  Complexity: O(total payload bytes).  No
    checksum -- pair with RJ02 when corruption detection matters
    (docs/FORMAT.md sections 3-4).
    """
    conts = [_portable_canonical(c) for c in bm.containers]
    n = len(conts)
    run_flags = np.array([isinstance(c, RunContainer) for c in conts],
                         dtype=bool)
    has_run = bool(run_flags.any())
    parts = []
    if has_run:
        parts.append(struct.pack("<HH", SERIAL_COOKIE, n - 1))
        bits = np.zeros((n + 7) // 8, np.uint8)
        idx = np.flatnonzero(run_flags)
        np.bitwise_or.at(bits, idx >> 3,
                         (1 << (idx & 7)).astype(np.uint8))
        parts.append(bits.tobytes())
    else:
        parts.append(struct.pack("<II", SERIAL_COOKIE_NO_RUNCONTAINER, n))
    desc = np.empty(2 * n, np.uint16)
    if n:
        desc[0::2] = np.asarray(bm.keys, np.uint16)
        desc[1::2] = np.asarray([c.card - 1 for c in conts], np.uint16)
    parts.append(desc.tobytes())
    with_offsets = (not has_run) or n >= NO_OFFSET_THRESHOLD
    sizes = [_portable_payload_size(c) for c in conts]
    if with_offsets:
        first = sum(len(p) for p in parts) + 4 * n
        offs = first + np.concatenate(
            ([0], np.cumsum(sizes[:-1]))) if n else np.zeros(0)
        parts.append(np.asarray(offs, np.uint32).tobytes())
    for c in conts:
        if isinstance(c, ArrayContainer):
            parts.append(c.values.tobytes())
        elif isinstance(c, BitsetContainer):
            parts.append(c.words.tobytes())
        else:
            runs = c.runs.astype(np.uint16)
            parts.append(struct.pack("<H", runs.shape[0]))
            parts.append(runs.tobytes())
    return b"".join(parts)


def deserialize_portable(buf: bytes) -> RoaringBitmap:
    """Parse a CRoaring portable payload (any compliant writer's
    output) into a RoaringBitmap.

    Args: ``buf`` bytes-like.  Returns a new RoaringBitmap whose
    container kinds follow the format's inference rule (run flag,
    else cardinality > 4096 => bitset, else array).

    Raises ``ValueError`` with the byte offset and container index on
    truncation, bad cookies, unsorted keys/values, offset-header
    mismatches, cardinality cross-check failures, or trailing bytes.
    The format carries no checksum, so corruption that preserves all
    structural invariants (e.g. a flipped key byte that stays sorted)
    is undetectable by design -- see docs/FORMAT.md section 4.
    Complexity: O(total payload bytes).
    """
    buf = bytes(buf)
    _need(buf, 0, 4, "portable cookie")
    (cookie16,) = struct.unpack_from("<H", buf, 0)
    if cookie16 == SERIAL_COOKIE:
        (n_minus_1,) = struct.unpack_from("<H", buf, 2)
        n = n_minus_1 + 1
        has_run = True
        off = 4
        flag_bytes = (n + 7) // 8
        _need(buf, off, flag_bytes, "run-container flag bitmap")
        flags = np.frombuffer(buf, np.uint8, flag_bytes, off)
        run_flags = np.unpackbits(flags, bitorder="little")[:n].astype(bool)
        off += flag_bytes
    else:
        (cookie32,) = struct.unpack_from("<I", buf, 0)
        if cookie32 != SERIAL_COOKIE_NO_RUNCONTAINER:
            raise ValueError(
                f"bad cookie {cookie16}; not a portable roaring payload "
                "(at byte offset 0)")
        _need(buf, 0, 8, "portable header")
        (n,) = struct.unpack_from("<I", buf, 4)
        has_run = False
        run_flags = np.zeros(n, dtype=bool)
        off = 8
    if n > _MAX_CONTAINERS:
        raise ValueError(
            f"container count {n} exceeds the 65536 maximum "
            "(count field at byte offset 4)")
    desc_off = off
    _need(buf, off, 4 * n, f"descriptive header of {n} container(s)")
    desc = np.frombuffer(buf, np.uint16, 2 * n, off)
    keys, cards = desc[0::2], desc[1::2].astype(np.int64) + 1
    off += 4 * n
    if n > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError(
            "container keys not strictly increasing "
            f"(descriptive header at byte offset {desc_off})")
    with_offsets = (not has_run) or n >= NO_OFFSET_THRESHOLD
    offsets = None
    if with_offsets:
        _need(buf, off, 4 * n, f"offset header of {n} container(s)")
        offsets = np.frombuffer(buf, np.uint32, n, off)
        off += 4 * n
    out_keys, out_conts = [], []
    for i in range(n):
        card = int(cards[i])
        po = off
        if offsets is not None and int(offsets[i]) != po:
            raise ValueError(
                f"offset header mismatch for container {i}: stored "
                f"{int(offsets[i])}, payload actually at byte offset {po}")
        if run_flags[i]:
            _need(buf, off, 2, f"run count of container {i}")
            (nr,) = struct.unpack_from("<H", buf, off)
            off += 2
            _need(buf, off, 4 * nr, f"run container {i} ({nr} runs)")
            runs = np.frombuffer(buf, np.uint16, 2 * nr, off).reshape(nr, 2)
            off += 4 * nr
            starts = runs[:, 0].astype(np.int64)
            ends = starts + runs[:, 1].astype(np.int64)
            if nr == 0 or (ends > 0xFFFF).any() or \
                    (nr > 1 and (starts[1:] <= ends[:-1] + 1).any()):
                raise ValueError(
                    f"run container {i}: runs not disjoint ascending "
                    f"in-bounds intervals (payload at byte offset {po})")
            if int((ends - starts + 1).sum()) != card:
                raise ValueError(
                    f"run container {i}: stored cardinality {card} "
                    f"!= run length total (payload at byte offset {po})")
            out_conts.append(RunContainer(runs.astype(np.int32)))
        elif card > ARRAY_MAX:
            _need(buf, off, 8 * BITSET_WORDS, f"bitset container {i}")
            words = np.frombuffer(buf, np.uint64, BITSET_WORDS, off)
            off += 8 * BITSET_WORDS
            pop = int(np.bitwise_count(words).sum())
            if pop != card:
                raise ValueError(
                    f"bitset container {i}: stored cardinality {card} "
                    f"!= popcount {pop} (payload at byte offset {po})")
            out_conts.append(BitsetContainer(words.copy(), card))
        else:
            _need(buf, off, 2 * card, f"array container {i} ({card} values)")
            vals = np.frombuffer(buf, np.uint16, card, off)
            off += 2 * card
            if card > 1 and not (vals[1:] > vals[:-1]).all():
                raise ValueError(
                    f"array container {i}: values not strictly increasing "
                    f"(payload at byte offset {po})")
            out_conts.append(ArrayContainer(vals.copy()))
        out_keys.append(int(keys[i]))
    if off != len(buf):
        raise ValueError(
            f"trailing garbage: {len(buf) - off} byte(s) past the last "
            f"container payload (at byte offset {off})")
    return RoaringBitmap(out_keys, out_conts)


# ---------------------------------------------------------------------------
# frozen: zero-copy view-based layout for mmap-ed snapshots
# ---------------------------------------------------------------------------

def _align(off: int, to: int) -> int:
    return (off + to - 1) // to * to


def _bad_direc(dir_off: int):
    raise ValueError(
        "frozen directory entry out of zone bounds or cardinality "
        f"mismatch (directory at byte offset {dir_off})")


def _as_u8(buf) -> np.ndarray:
    """Any bytes-like / ndarray / memmap as a flat uint8 array WITHOUT
    copying (views into the result alias the caller's buffer)."""
    if isinstance(buf, np.ndarray):
        # .view(np.ndarray) strips subclasses (np.memmap): the subclass
        # __array_finalize__ hook taxes EVERY downstream slice, which
        # dominates directory-walk time on large mapped snapshots.
        return buf.reshape(-1).view(np.uint8).view(np.ndarray)
    return np.frombuffer(buf, dtype=np.uint8)


def serialize_frozen(bm: RoaringBitmap) -> bytes:
    """Serialize ``bm`` to the frozen zero-copy layout: payloads
    grouped into per-kind zones (bitset words, array values, run
    pairs) behind a vectorized directory, every zone aligned for
    direct numpy views (docs/FORMAT.md section 5).

    Args: ``bm`` any RoaringBitmap; kinds are preserved exactly.
    Returns ``bytes`` whose :func:`deserialize_frozen` twin copies
    ZERO payload bytes.  Complexity: O(total payload bytes) to write.
    """
    n = len(bm.keys)
    kinds = np.empty(n, np.uint8)
    cards = np.empty(n, np.uint16)
    direc = np.zeros((n, 2), np.uint32)
    bitset_rows, values_parts, run_parts = [], [], []
    n_bitset = n_values = n_runs = 0
    for i, c in enumerate(bm.containers):
        cards[i] = c.card - 1
        if isinstance(c, ArrayContainer):
            kinds[i] = 1
            direc[i] = (n_values, c.card)
            values_parts.append(c.values)
            n_values += c.card
        elif isinstance(c, BitsetContainer):
            kinds[i] = 2
            direc[i] = (n_bitset, 0)
            bitset_rows.append(c.words)
            n_bitset += 1
        else:
            kinds[i] = 3
            nr = c.runs.shape[0]
            direc[i] = (n_runs, nr)
            run_parts.append(c.runs.astype(np.int32))
            n_runs += nr
    dir_off = _align(32 + 5 * n, 4)
    bitset_off = _align(dir_off + 8 * n, 8)
    values_off = bitset_off + 8 * BITSET_WORDS * n_bitset
    runs_off = _align(values_off + 2 * n_values, 4)
    total = runs_off + 8 * n_runs
    out = bytearray(total)
    out[0:8] = MAGIC_FROZEN
    struct.pack_into("<IIIIQ", out, 8, n, n_bitset, n_values, n_runs, total)
    out[32:32 + 2 * n] = np.asarray(bm.keys, np.uint16).tobytes()
    out[32 + 2 * n:32 + 3 * n] = kinds.tobytes()
    out[32 + 3 * n:32 + 5 * n] = cards.tobytes()
    out[dir_off:dir_off + 8 * n] = direc.tobytes()
    pos = bitset_off
    for words in bitset_rows:
        out[pos:pos + 8 * BITSET_WORDS] = words.tobytes()
        pos += 8 * BITSET_WORDS
    pos = values_off
    for vals in values_parts:
        out[pos:pos + 2 * vals.size] = vals.tobytes()
        pos += 2 * vals.size
    pos = runs_off
    for runs in run_parts:
        out[pos:pos + 8 * runs.shape[0]] = runs.tobytes()
        pos += 8 * runs.shape[0]
    return bytes(out)


def deserialize_frozen(buf) -> RoaringBitmap:
    """Reconstruct a RoaringBitmap as pure numpy VIEWS over ``buf``:
    zero payload bytes are read or copied (``np.shares_memory`` holds
    for every container payload), so mapping a multi-GB snapshot and
    calling this costs directory-validation time only -- payload pages
    fault in lazily as queries touch them.

    Args: ``buf`` bytes, memoryview, ``np.memmap`` or any uint8
    ndarray (pass a ``np.memmap(path, np.uint8, "r")`` for the mmap
    path; :func:`load_frozen` does exactly that).

    Returns a RoaringBitmap whose container payloads alias ``buf``.
    Buffers from ``bytes`` or read-only maps yield non-writeable
    views; every ``RoaringBitmap`` mutator is copy-on-write, so
    frozen-backed bitmaps stay safely immutable underneath.

    Raises ``ValueError`` (byte offset + container index included) on
    bad magic, size mismatches, unsorted keys, bad kinds, or directory
    entries pointing outside their zone -- all validated VECTORIZED
    over the directory; payload zones are never touched (trusted local
    format, docs/FORMAT.md section 5).  Complexity: O(containers) for
    the directory walk; O(1) payload bytes.
    """
    u8 = _as_u8(buf)
    if u8.size < 32:
        raise ValueError(
            f"truncated frozen payload: need 32 byte(s) for header "
            f"at byte offset 0, but only {u8.size} remain")
    head = u8[:32].tobytes()
    if head[:8] != MAGIC_FROZEN:
        raise ValueError(
            "bad magic; not an RJFZ frozen roaring payload "
            "(at byte offset 0)")
    n, n_bitset, n_values, n_runs, total = struct.unpack_from("<IIIIQ",
                                                              head, 8)
    if n > _MAX_CONTAINERS:
        raise ValueError(
            f"container count {n} exceeds the 65536 maximum "
            "(count field at byte offset 8)")
    if total != u8.size:
        raise ValueError(
            f"frozen payload size mismatch: header says {total} byte(s), "
            f"buffer has {u8.size} (size field at byte offset 24)")
    dir_off = _align(32 + 5 * n, 4)
    bitset_off = _align(dir_off + 8 * n, 8)
    values_off = bitset_off + 8 * BITSET_WORDS * n_bitset
    runs_off = _align(values_off + 2 * n_values, 4)
    if runs_off + 8 * n_runs != total:
        raise ValueError(
            "frozen zone sizes inconsistent with the header counts "
            "(directory at byte offset 32)")
    keys_l = u8[32:32 + 2 * n].view(np.uint16).tolist()
    kinds_l = u8[32 + 2 * n:32 + 3 * n].tolist()
    cards_l = u8[32 + 3 * n:32 + 5 * n].view(np.uint16).tolist()
    direc_l = u8[dir_off:dir_off + 8 * n].view(np.uint32) \
        .reshape(n, 2).tolist()
    bitset_zone = u8[bitset_off:values_off].view(np.uint64).reshape(
        n_bitset, BITSET_WORDS)
    values_zone = u8[values_off:values_off + 2 * n_values].view(np.uint16)
    run_zone = u8[runs_off:runs_off + 8 * n_runs].view(np.int32).reshape(
        n_runs, 2)
    # Validation runs as SCALAR checks inside the construction loop: on
    # the tiny per-container arrays involved, vectorized numpy checks
    # cost ~30x the whole loop (cold-start opens thousands of frozen
    # payloads, so the constant here is what snapshot-open time IS).
    conts: list = []
    append = conts.append
    n_bit_seen = 0
    prev_key = -1
    for i in range(n):            # views only: no payload reads/copies
        k = kinds_l[i]
        s, c = direc_l[i]
        key = keys_l[i]
        if key <= prev_key:
            raise ValueError(
                "container keys not strictly increasing "
                "(key directory at byte offset 32)")
        prev_key = key
        if k == 2:
            if s >= n_bitset:
                _bad_direc(dir_off)
            n_bit_seen += 1
            append(BitsetContainer(bitset_zone[s], cards_l[i] + 1))
        elif k == 1:
            if c != cards_l[i] + 1 or s + c > n_values:
                _bad_direc(dir_off)
            append(ArrayContainer(values_zone[s:s + c]))
        elif k == 3:
            if c < 1 or s + c > n_runs:
                _bad_direc(dir_off)
            append(RunContainer(run_zone[s:s + c]))
        else:
            raise ValueError(
                f"bad container kind {k} for container {i} "
                f"(kind directory at byte offset {32 + 2 * n + i})")
    if n_bit_seen != n_bitset:
        _bad_direc(dir_off)
    return RoaringBitmap(keys_l, conts)


def write_frozen(path, bm: RoaringBitmap) -> int:
    """Write ``bm`` in the frozen layout to ``path`` (a str/Path).
    Returns the number of bytes written.  Read it back zero-copy with
    :func:`load_frozen`."""
    payload = serialize_frozen(bm)
    with open(path, "wb") as f:
        f.write(payload)
    return len(payload)


def load_frozen(path) -> RoaringBitmap:
    """Map ``path`` (written by :func:`write_frozen`) read-only and
    return a RoaringBitmap of views over the map: O(containers)
    directory work, zero payload reads -- pages fault in lazily as
    queries touch them (docs/FORMAT.md section 5)."""
    return deserialize_frozen(np.memmap(path, dtype=np.uint8, mode="r"))


# ---------------------------------------------------------------------------
# snapshot archive: many named frozen bitmaps, one mmap-able file
# ---------------------------------------------------------------------------

class LazyBitmaps(MutableMapping):
    """Name -> RoaringBitmap mapping over a snapshot archive that
    defers each entry's directory walk until the entry is FIRST read
    (``docs/FORMAT.md`` section 6): opening a 100k-term snapshot costs
    table-parse time only, and a query that touches 4 terms pays for 4
    ``deserialize_frozen`` calls -- the rest of the file is never
    walked (and with mmap, never paged in).

    Behaves as an ordinary mutable mapping (``dict(m)``, ``m[k]``,
    ``.get``/``.items``/``.values``, assignment) -- materialized
    entries are cached, assignments shadow pending entries.  Keys are
    available without materializing anything (``len``, ``in``,
    iteration)."""

    __slots__ = ("_buf", "_order", "_pending", "_cache")

    def __init__(self, buf, order: list, pending: dict):
        self._buf = buf
        self._order = order                 # archive key order
        self._pending = pending             # name -> (pay_off, pay_len)
        self._cache: dict = {}

    def __getitem__(self, key):
        try:
            return self._cache[key]
        except KeyError:
            off, ln = self._pending.pop(key)     # KeyError if absent
            bm = self._cache[key] = deserialize_frozen(
                self._buf[off:off + ln])
            return bm

    def __setitem__(self, key, value):
        if key not in self._cache and key not in self._pending:
            self._order.append(key)
        self._pending.pop(key, None)
        self._cache[key] = value

    def __delitem__(self, key):
        if self._cache.pop(key, None) is None and \
                self._pending.pop(key, None) is None:
            raise KeyError(key)
        self._order.remove(key)

    def __iter__(self):
        return iter(self._order)

    def __len__(self):
        return len(self._order)

    def __contains__(self, key):
        return key in self._cache or key in self._pending


class FrozenSnapshot:
    """A read-only view over a snapshot archive: ``bitmaps`` is a
    :class:`LazyBitmaps` mapping of name -> frozen-view RoaringBitmap,
    every entry aliasing the archive's single buffer (``buffer``) and
    materialized on first access; ``meta`` is the writer's uint32 (the
    streaming index builder stores ``n_docs`` there); ``nbytes`` the
    archive size.  See docs/FORMAT.md section 6."""

    __slots__ = ("bitmaps", "meta", "nbytes", "buffer")

    def __init__(self, bitmaps, meta: int, nbytes: int, buffer):
        self.bitmaps = bitmaps
        self.meta = meta
        self.nbytes = nbytes
        self.buffer = buffer


def write_snapshot(path, named, *, meta: int = 0) -> int:
    """Write a snapshot archive of named bitmaps to ``path``.

    Args: ``named`` a mapping (or iterable of pairs) of ``str`` name
    -> RoaringBitmap, each stored in the frozen layout, 8-aligned so
    :func:`read_snapshot` views them in place; ``meta`` a uint32 the
    reader gets back verbatim (``StreamingIndexBuilder`` stores
    ``n_docs``).

    Returns bytes written.  Complexity: O(total payload bytes), one
    sequential write.
    """
    items = list(named.items()) if hasattr(named, "items") else list(named)
    names = [str(k).encode("utf-8") for k, _ in items]
    payloads = [serialize_frozen(bm) for _, bm in items]
    n = len(items)
    table_off = 24
    names_off = table_off + 24 * n
    name_offs, pos = [], names_off
    for nm in names:
        name_offs.append(pos)
        pos += len(nm)
    pay_offs, pos = [], _align(pos, 8)
    for p in payloads:
        pay_offs.append(pos)
        pos += _align(len(p), 8)
    total = pos
    out = bytearray(total)
    out[0:8] = MAGIC_SNAPSHOT
    struct.pack_into("<IIQ", out, 8, n, meta, total)
    for i in range(n):
        struct.pack_into("<IIQQ", out, table_off + 24 * i,
                         name_offs[i], len(names[i]),
                         pay_offs[i], len(payloads[i]))
        out[name_offs[i]:name_offs[i] + len(names[i])] = names[i]
        out[pay_offs[i]:pay_offs[i] + len(payloads[i])] = payloads[i]
    with open(path, "wb") as f:
        f.write(out)
    return total


def read_snapshot(path, *, mmap: bool = True) -> FrozenSnapshot:
    """Open a snapshot archive written by :func:`write_snapshot`.

    Args: ``path`` the archive; ``mmap`` maps it read-only (the
    zero-copy cold-start path -- payload pages fault in lazily) or,
    when False, reads it into memory first (same views, private
    buffer).

    Returns a :class:`FrozenSnapshot` whose ``bitmaps`` are LAZY: the
    entry table is parsed and bounds-checked vectorized up front, but
    each bitmap's directory walk (:func:`deserialize_frozen`) is
    deferred to first access, so open time is O(entry table) no matter
    how large the payloads are.  Raises ``ValueError`` on bad magic /
    size mismatches / out-of-bounds table entries.
    """
    if mmap:
        u8 = np.memmap(path, dtype=np.uint8, mode="r").view(np.ndarray)
    else:
        with open(path, "rb") as f:
            u8 = np.frombuffer(f.read(), dtype=np.uint8)
    if u8.size < 24 or u8[:8].tobytes() != MAGIC_SNAPSHOT:
        raise ValueError(
            "bad magic; not an RJSN snapshot archive (at byte offset 0)")
    n, meta, total = struct.unpack_from("<IIQ", u8[:24].tobytes(), 8)
    if total != u8.size:
        raise ValueError(
            f"snapshot size mismatch: header says {total} byte(s), "
            f"file has {u8.size} (size field at byte offset 16)")
    table = u8[24:24 + 24 * n]
    if table.size != 24 * n:
        raise ValueError(
            f"truncated snapshot: need {24 * n} byte(s) for the entry "
            f"table at byte offset 24, but only {u8.size - 24} remain")
    ent = table.view(np.dtype([("name_off", "<u4"), ("name_len", "<u4"),
                               ("pay_off", "<u8"), ("pay_len", "<u8")]))
    oob = (ent["name_off"].astype(np.uint64) + ent["name_len"] > total) \
        | (ent["pay_off"] + ent["pay_len"] > total)
    if oob.any():
        i = int(np.flatnonzero(oob)[0])
        raise ValueError(
            f"snapshot entry {i} points outside the archive "
            f"(entry at byte offset {24 + 24 * i})")
    name_offs = ent["name_off"].tolist()
    name_lens = ent["name_len"].tolist()
    pay_offs = ent["pay_off"].tolist()
    pay_lens = ent["pay_len"].tolist()
    order, pending = [], {}
    for i in range(n):
        a = name_offs[i]
        name = u8[a:a + name_lens[i]].tobytes().decode("utf-8")
        order.append(name)
        pending[name] = (pay_offs[i], pay_lens[i])
    return FrozenSnapshot(LazyBitmaps(u8, order, pending),
                          meta, int(total), u8)


def sniff_format(buf) -> str:
    """Identify which serde layout ``buf`` holds ("rj02" | "portable"
    | "frozen" | "snapshot") from its magic/cookie -- the dispatcher
    behind ``RoaringBitmap.deserialize(format="auto")``.  Raises
    ``ValueError`` when no layout matches."""
    u8 = _as_u8(buf)
    head = u8[:8].tobytes()
    if head[:4] == MAGIC:
        return "rj02"
    if head == MAGIC_FROZEN:
        return "frozen"
    if head == MAGIC_SNAPSHOT:
        return "snapshot"
    if len(head) >= 4:
        (c16,) = struct.unpack_from("<H", head, 0)
        if c16 == SERIAL_COOKIE:
            return "portable"
        (c32,) = struct.unpack_from("<I", head, 0)
        if c32 == SERIAL_COOKIE_NO_RUNCONTAINER:
            return "portable"
    raise ValueError("unrecognized roaring serialization format")
