"""The port's serialization (``repro_torch.core.serde``) against the JAX
package's, byte for byte.

Every case (each container kind, a bitset holding at most 4,096 values,
mixed chunks, the empty bitmap, a full chunk, key 65535, run-heavy
bitmaps, the 4,096 / 4,097 boundary) goes through RJ02, portable and
frozen in both packages: the bytes are equal, ``serialized_size_bytes``
equals their length, and each package reads the other's bytes back to
the same set with the same container kinds.  The corruption cases of
``tests/core/test_serde.py`` and ``tests/core/test_serde_formats.py``
raise ``ValueError`` with the same message in both packages.  Frozen
bitmaps are read-only views that share memory with their buffer and stay
byte-identical under point updates; snapshot archives are byte-identical
and their entries stay unmaterialized until first read.
"""

import struct
import zlib

import numpy as np
import pytest

import repro.core as J
from repro.core import serde as jserde
from repro.core.builder import from_dense as j_from_dense
import repro_torch.core as T
from repro_torch.core import serde as tserde
from repro_torch.core.builder import from_dense as t_from_dense

FORMATS = ("rj02", "portable", "frozen")
SER = {"rj02": "serialize", "portable": "serialize_portable",
       "frozen": "serialize_frozen"}
DE = {"rj02": "deserialize", "portable": "deserialize_portable",
      "frozen": "deserialize_frozen"}


def _mixed_values(rng, n_chunks):
    """Values mixing sparse arrays, dense bitsets, runs and the 4,096 /
    4,097 boundary across chunks (``tests/core/test_serde.py``'s mix)."""
    parts = []
    for _ in range(n_chunks):
        base = np.uint32(int(rng.integers(0, 64)) << 16)
        style = rng.integers(0, 4)
        if style == 0:
            vals = rng.integers(0, 1 << 16, int(rng.integers(1, 400)),
                                dtype=np.uint32)
        elif style == 1:
            vals = rng.choice(1 << 16, int(rng.integers(4097, 20000)),
                              replace=False).astype(np.uint32)
        elif style == 2:
            lo = int(rng.integers(0, 1 << 15))
            vals = np.arange(lo, lo + int(rng.integers(100, 30000)),
                             dtype=np.uint32)
        else:
            vals = rng.choice(1 << 16, 4096 + int(rng.integers(0, 2)),
                              replace=False).astype(np.uint32)
        parts.append(base + vals)
    return np.concatenate(parts)


def _case_values():
    rng = np.random.default_rng(22)
    top = np.uint32(0xFFFF0000)
    return {
        "empty": (np.zeros(0, np.uint32), False),
        "array": (rng.choice(1 << 20, 300, replace=False), False),
        "bitset": (rng.choice(1 << 16, 20000, replace=False), False),
        "run": (np.arange(100, 30000), True),
        "mixed": (_mixed_values(rng, 5), True),
        "mixed_small": (_mixed_values(rng, 2), True),
        "full_chunk": (np.arange(1 << 16), True),
        "key_65535": (np.concatenate([top + rng.choice(1 << 16, 900,
                                                       replace=False),
                                      [0xFFFFFFFF, 7]]), False),
        "run_heavy": (np.concatenate([np.arange(10, 500),
                                      np.arange(60000, 65536),
                                      (5 << 16) + np.arange(0, 1 << 16, 2),
                                      (9 << 16) + np.arange(3, 40000)]),
                      True),
        "boundary_4096": (np.arange(4096) * 3, False),
        "boundary_4097": (np.arange(4097) * 3, False),
    }


CASES = _case_values()


def _twins(name):
    """The case as a (JAX, port) pair of bitmaps with the same kinds."""
    if name == "bitset_below_4096":           # a bitset of 4,096 values
        dense = np.zeros(1 << 16, bool)
        dense[:4096] = True
        return j_from_dense(dense), t_from_dense(dense)
    vals, optimize = CASES[name]
    vals = np.asarray(vals, np.uint32)
    j, t = J.RoaringBitmap.from_values(vals), T.RoaringBitmap.from_values(vals)
    if optimize:
        j.run_optimize()
        t.run_optimize()
    return j, t


NAMES = [*CASES, "bitset_below_4096"]


def _same(j, t):
    assert j.keys == t.keys
    assert [c.kind for c in j.containers] == [c.kind for c in t.containers]
    assert np.array_equal(j.to_array(), t.to_array())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", NAMES)
def test_bytes_match_jax(name, fmt):
    j, t = _twins(name)
    _same(j, t)
    jb = getattr(jserde, SER[fmt])(j)
    tb = getattr(tserde, SER[fmt])(t)
    assert tb == jb
    assert t.serialize(fmt) == jb
    assert tserde.serialized_size_bytes(t, format=fmt) == len(tb)
    assert jserde.serialized_size_bytes(j, format=fmt) == len(jb)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", NAMES)
def test_each_package_reads_the_others_bytes(name, fmt):
    j, t = _twins(name)
    from_jax = getattr(tserde, DE[fmt])(getattr(jserde, SER[fmt])(j))
    from_port = getattr(jserde, DE[fmt])(getattr(tserde, SER[fmt])(t))
    _same(from_port, from_jax)
    assert np.array_equal(from_jax.to_array(), j.to_array())
    assert T.RoaringBitmap.deserialize(j.serialize(fmt)) == from_jax
    assert tserde.sniff_format(t.serialize(fmt)) == fmt


def test_bitmap_methods_reject_unknown_formats():
    _, t = _twins("mixed")
    with pytest.raises(ValueError):
        t.serialize("msgpack")
    with pytest.raises(ValueError):
        T.RoaringBitmap.deserialize(b"????????", format="auto")
    with pytest.raises(ValueError):
        T.RoaringBitmap.deserialize(t.serialize(), format="json")


def test_portable_golden_vectors():
    want = bytes.fromhex("3a300000" "01000000" "0000" "0200" "10000000"
                         "010002000300")
    one = T.RoaringBitmap.from_values([1, 2, 3])
    assert tserde.serialize_portable(one) == want
    assert tserde.deserialize_portable(want) == one
    run = T.RoaringBitmap.from_range(0, 100).run_optimize()
    want = bytes.fromhex("3b300000" "01" "0000" "6300" "0100" "0000" "6300")
    assert tserde.serialize_portable(run) == want
    assert tserde.deserialize_portable(want) == run


# -- corruption: the JAX package's cases, raised the same way in both ----

def _refresh_crc(payload: bytearray) -> bytes:
    payload[4:8] = struct.pack("<I", zlib.crc32(bytes(payload[8:])))
    return bytes(payload)


def _corrupt_cases():
    """(label, format, buffer) of every corruption case of the JAX
    package's serde tests, built from the JAX package's bytes."""
    rng = np.random.default_rng(7)
    j, _ = _twins("mixed")
    payload = jserde.serialize(j)
    out = [(f"truncated at {cut}", "rj02", payload[:cut])
           for cut in sorted({1, 3, 4, 6, 8, 10, len(payload) // 2,
                              len(payload) - 1})]
    out += [("magic only", "rj02", jserde.MAGIC),
            ("bad magic", "rj02", b"XXXX" + b"\x00" * 12),
            ("empty", "rj02", b"")]
    small = bytearray(jserde.serialize(J.RoaringBitmap.from_values([1, 2,
                                                                    3])))
    kind = bytearray(small)
    kind[14] = 9
    out.append(("bad kind", "rj02", _refresh_crc(kind)))
    flip = bytearray(small)
    flip[12] ^= 0xFF
    out.append(("key flip", "rj02", bytes(flip)))
    crc = bytearray(payload)
    crc[-1] ^= 1
    out.append(("crc", "rj02", bytes(crc)))
    for pos in rng.choice(len(payload), 24, replace=False).tolist():
        p = bytearray(payload)
        p[pos] ^= int(rng.integers(1, 256))
        out.append((f"flip at {pos}", "rj02", bytes(p)))
    swap = bytearray(payload)
    swap[12:14], swap[14:16] = swap[14:16], swap[12:14]
    out.append(("unsorted keys", "rj02", _refresh_crc(swap)))
    out.append(("trailing", "rj02",
                _refresh_crc(bytearray(payload + b"\x00\x07"))))
    two = bytearray(jserde.serialize(J.RoaringBitmap.from_values(
        [5, (1 << 16) + 1, (1 << 16) + 9])))
    two[12 + 4 + 1] = 9
    out.append(("kind of container 1", "rj02", _refresh_crc(two)))
    dense = J.RoaringBitmap.from_values(rng.choice(1 << 16, 5000,
                                                   replace=False))
    card = bytearray(jserde.serialize(dense))
    struct.pack_into("<H", card, 15, 4998)
    out.append(("bitset card", "rj02", _refresh_crc(card)))
    base = jserde.serialize_portable(j)
    for pos in (0, 1, 2, 3):
        p = bytearray(base)
        p[pos] ^= 0xFF
        out.append((f"portable header byte {pos}", "portable", bytes(p)))
    out += [("portable truncated", "portable", base[:-1]),
            ("portable trailing", "portable", base + b"\x00"),
            ("frozen truncated", "frozen",
             jserde.serialize_frozen(j)[:40]),
            ("sniff", "auto", b"????????")]
    return out


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("label,fmt,buf", CORRUPT,
                         ids=[c[0] for c in CORRUPT])
def test_corruption_raises_the_same_in_both(label, fmt, buf):
    with pytest.raises(ValueError) as jerr:
        J.RoaringBitmap.deserialize(buf, format=fmt)
    with pytest.raises(ValueError) as terr:
        T.RoaringBitmap.deserialize(buf, format=fmt)
    assert str(terr.value) == str(jerr.value)


def test_portable_flip_sweep_never_a_silent_lie():
    j, t = _twins("mixed")
    payload = tserde.serialize_portable(t)
    rng = np.random.default_rng(3)
    for pos in rng.choice(len(payload), 128, replace=False).tolist():
        p = bytearray(payload)
        p[pos] ^= int(rng.integers(1, 256))
        try:
            y = tserde.deserialize_portable(bytes(p))
        except ValueError:
            with pytest.raises(ValueError):
                jserde.deserialize_portable(bytes(p))
            continue
        assert y != t
        assert np.array_equal(
            y.to_array(), jserde.deserialize_portable(bytes(p)).to_array())


# -- frozen views and snapshot archives ---------------------------------

def test_frozen_views_share_memory_and_mutation_is_copy_on_write():
    _, t = _twins("mixed")
    raw = tserde.serialize_frozen(t)
    buf = np.frombuffer(raw, np.uint8)
    y = tserde.deserialize_frozen(buf)
    kinds = set()
    for c in y.containers:
        kinds.add(c.kind)
        payload = (c.words if c.kind == "bitset" else
                   c.values if c.kind == "array" else c.runs)
        assert np.shares_memory(payload, buf)
        assert not payload.flags.writeable
    assert kinds == {"array", "bitset", "run"}
    y.add(12345)
    y.remove(int(t.to_array()[0]))
    y.run_optimize()
    assert bytes(buf) == raw
    assert tserde.deserialize_frozen(buf) == t


def _named():
    return {name: _twins(name) for name in NAMES}


@pytest.mark.parametrize("mmap", [True, False])
def test_snapshot_archives_are_byte_identical(tmp_path, mmap):
    named = _named()
    jp, tp = tmp_path / "j.snap", tmp_path / "t.snap"
    nj = jserde.write_snapshot(jp, {k: v[0] for k, v in named.items()},
                               meta=1 << 24)
    nt = tserde.write_snapshot(tp, {k: v[1] for k, v in named.items()},
                               meta=1 << 24)
    assert nj == nt and jp.read_bytes() == tp.read_bytes()
    snap = tserde.read_snapshot(jp, mmap=mmap)
    assert snap.meta == 1 << 24 and snap.nbytes == nj
    assert isinstance(snap.bitmaps, tserde.LazyBitmaps)
    assert list(snap.bitmaps) == list(named)
    assert set(snap.bitmaps._pending) == set(named)     # nothing walked
    got = snap.bitmaps["mixed"]
    assert set(snap.bitmaps._pending) == set(named) - {"mixed"}
    assert np.array_equal(got.to_array(), named["mixed"][0].to_array())
    for c in got.containers:
        payload = (c.words if c.kind == "bitset" else
                   c.values if c.kind == "array" else c.runs)
        assert np.shares_memory(payload, snap.buffer)
    for k, (j, _) in named.items():
        _same(j, snap.bitmaps[k])
    back = jserde.read_snapshot(tp, mmap=mmap)
    for k, (_, t) in named.items():
        _same(back.bitmaps[k], t)


def test_snapshot_bad_magic_raises_in_both(tmp_path):
    p = tmp_path / "bad.snap"
    p.write_bytes(b"NOTASNAP" + b"\x00" * 24)
    with pytest.raises(ValueError, match="magic") as jerr:
        jserde.read_snapshot(p)
    with pytest.raises(ValueError, match="magic") as terr:
        tserde.read_snapshot(p)
    assert str(terr.value) == str(jerr.value)


def test_core_exports_the_serde_names():
    assert sorted(n for n in J.__all__ if n in dir(jserde)) == \
        sorted(n for n in T.__all__ if n in dir(tserde))
    for name in ("serialize", "deserialize", "write_snapshot",
                 "read_snapshot", "LazyBitmaps", "FrozenSnapshot",
                 "load_frozen", "write_frozen", "serialized_size_bytes"):
        assert getattr(T, name) is getattr(tserde, name)


def test_write_and_load_frozen_files(tmp_path):
    j, t = _twins("run_heavy")
    jserde.write_frozen(tmp_path / "j.rf", j)
    tserde.write_frozen(tmp_path / "t.rf", t)
    assert (tmp_path / "j.rf").read_bytes() == (tmp_path / "t.rf").read_bytes()
    _same(j, tserde.load_frozen(tmp_path / "j.rf"))
