"""The port's BitmapArena on the CPU: the stat contract of
``tests/core/test_arena.py`` (zero uploads on a warm re-query, a minimal
incremental patch, the copy-on-write patch, row release and reuse,
refcounts on shared containers), with the JAX package's arena run beside
it on the same seeded bitmaps wherever the two can be compared.
"""

import numpy as np
import pytest
import torch

from repro.core import BitmapArena as JArena
from repro.core import RoaringBitmap as JBitmap
from repro.core import aggregate as jagg
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.core import aggregate
from repro_torch.core import containers as C

CPU = "cpu"


def bm(values):
    return RoaringBitmap.from_values(np.asarray(list(values), np.uint32))


def mixed_bitmaps(rng, k=8):
    """Array/bitset/run mix across overlapping chunk keys (JAX package's
    bitmaps; convert with ``_twin``)."""
    out = []
    for i in range(k):
        kind = ("array", "bitset", "run")[i % 3]
        if kind == "array":
            vals = rng.choice(1 << 18, 300, replace=False)
        elif kind == "bitset":
            vals = rng.choice(1 << 17, 30000, replace=False)
        else:
            starts = rng.choice(1 << 17, 20)
            vals = np.unique(np.concatenate(
                [np.arange(s, s + 400) for s in starts]))
        out.append(JBitmap.from_values(np.asarray(vals, np.uint32)))
    return out


def _twin(b):
    return convert.bitmap_from_parts(*convert.bitmap_to_parts(b))


def _dev(arena):
    return arena.device_slab()[: arena._n].numpy().view(np.uint32)


def test_adopt_and_lookup_content():
    rng = np.random.default_rng(0)
    bms = [_twin(b) for b in mixed_bitmaps(rng)]
    arena = BitmapArena(capacity=2, device=CPU)          # forces growth
    assert arena.adopt_many(bms) > 0
    for b in bms:
        assert arena.resident(b)
        for c in b.containers:
            rid = arena.lookup(c)
            assert rid is not None and rid > 0
            assert np.array_equal(arena.host_row(rid),
                                  C.container_words64(c))
    assert not arena.host_row(0).any()                   # reserved zero
    assert arena.adopt_many(bms) == 0                    # warm no-op


def test_warm_requery_uploads_nothing():
    rng = np.random.default_rng(6)
    jb = mixed_bitmaps(rng)
    tb = [_twin(b) for b in jb]
    ja, arena = JArena(), BitmapArena(device=CPU)
    ja.adopt_frozen(jb)
    arena.adopt_frozen(tb)
    ja.sync()
    arena.sync()
    up0 = arena.stats.rows_uploaded
    assert up0 == arena._n == ja.stats.rows_uploaded     # one bulk upload
    want = jagg.or_many(jb, backend="ref", arena=ja)
    for _ in range(2):
        got = aggregate.or_many(tb, backend="ref", arena=arena)
        assert convert.bitmap_to_parts(got)[0] == \
            convert.bitmap_to_parts(want)[0]
        assert got == _twin(want)
        assert arena.stats.rows_uploaded == up0
    assert arena.stats.host_rows_staged == 0
    assert arena.adopt_frozen(tb) == 0


def test_incremental_patch_is_minimal():
    rng = np.random.default_rng(1)
    jb = mixed_bitmaps(rng)
    tb = [_twin(b) for b in jb]
    ja, arena = JArena(), BitmapArena(device=CPU)
    for a, bs in ((ja, jb), (arena, tb)):
        a.adopt_many(bs)
        a.device_slab()
        bs[1].add(3)                             # one bitset container
        assert a.adopt(bs[1]) == 1
        a.device_slab()
    assert arena.stats.as_dict() == ja.stats.as_dict()
    assert arena.stats.rows_patched == 1
    host = arena._host[: arena._n].view(np.uint32).reshape(-1, 2048)
    assert np.array_equal(_dev(arena), host)


def test_copy_on_write_patch():
    """A slab handed out before a patch keeps its contents; the upload
    copies the host mirror instead of aliasing it."""
    arena = BitmapArena(device=CPU)
    b = bm(range(70000, 90000))
    arena.adopt(b)
    before = arena.device_slab()
    snapshot = before.clone()
    assert before.data_ptr() != arena._host.ctypes.data
    b.add(1)                                     # new chunk 0 row
    arena.adopt(b)
    after = arena.device_slab()
    assert after is not before
    assert torch.equal(before, snapshot)
    assert not torch.equal(after, snapshot)
    arena._host[1, 0] ^= np.uint64(1)            # mirror edit, no adopt
    assert torch.equal(before, snapshot)


def test_release_and_row_reuse():
    arena = BitmapArena(device=CPU)
    a = bm(range(100))
    arena.adopt(a)
    rows = arena.n_rows
    for v in range(100):
        a.remove(v)
    arena.adopt(a)
    assert arena.n_rows == rows - 1
    assert arena.stats.rows_freed == 1
    b = bm(range(50))
    arena.adopt(b)
    assert arena.n_rows == rows
    rid = arena.lookup(b.containers[0])
    assert np.array_equal(arena.host_row(rid),
                          C.container_words64(b.containers[0]))
    arena.release(a)
    arena.release(b)
    assert arena.n_rows == 1                     # only the zero row left


@pytest.mark.parametrize("bulk", [False, True])
def test_shared_container_refcount(bulk):
    a = bm(range(5000, 9000))
    shared = a.containers[0]
    b = RoaringBitmap([0], [shared])
    arena = BitmapArena(device=CPU)
    adopt = arena.adopt_frozen if bulk else arena.adopt
    adopt(a)
    rows = arena.n_rows
    adopt(b)
    assert arena.n_rows == rows                  # no second promotion
    arena.release(a)
    assert arena.lookup(shared) is not None      # b still holds the row
    arena.release(b)
    assert arena.lookup(shared) is None


def test_growth_after_upload_stays_on_device():
    rng = np.random.default_rng(4)
    tb = [_twin(b) for b in mixed_bitmaps(rng, 4)]
    arena = BitmapArena(capacity=2, device=CPU)
    arena.adopt(tb[0])
    arena.device_slab()
    up0 = arena.stats.rows_uploaded
    arena.adopt_many(tb[1:])                     # grows the capacity
    slab = arena.device_slab()
    assert slab.shape[0] == arena.capacity
    assert arena.stats.rows_uploaded == up0 + arena.stats.rows_patched
    host = arena._host.view(np.uint32).reshape(-1, 2048)
    assert np.array_equal(slab.numpy().view(np.uint32), host)


def test_bulk_rows_match_jax_arena():
    rng = np.random.default_rng(5)
    jb = [b.run_optimize() for b in mixed_bitmaps(rng, 9)]
    tb = [_twin(b) for b in jb]
    ja, arena = JArena(), BitmapArena(device=CPU)
    assert arena.adopt_frozen(tb) == ja.adopt_frozen(jb)
    assert arena.n_rows == ja.n_rows
    assert np.array_equal(arena._host[: arena._n], ja._host[: ja._n])
    ja.sync()
    arena.sync()
    assert np.array_equal(_dev(arena), np.asarray(ja.device_slab())
                          [: ja._n])
    assert arena.stats.as_dict() == ja.stats.as_dict()
