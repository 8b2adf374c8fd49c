"""The port's two-by-two algebra (``repro_torch.core.pairwise``: merge_one,
pairwise_card, jaccard_matrix; the RoaringBitmap operators, counts and
similarity methods; InvertedIndex.count_and / jaccard) against the JAX
package's, on the same bitmaps carried across with ``convert``.

Each is run twice: with ``backend="ref"`` on both sides (the port on
``device="cpu"``), so the class planner launches the plain versions of the
pair kernels, and with the default backend, so both packages take their
numpy host twins (the array x array token join, its ``nu > 4096``
fallback, the grouped probe, the blocked popcount).  The bitmaps mix
array, bitset and run containers over more than 16 keys.  Tolerance 0:
equal keys, container kinds and payloads, equal counts, and float64
Jaccard / cosine with equal bits.
"""

import numpy as np
import pytest
import torch

from repro.core import RoaringBitmap as JBitmap
from repro.core import pairwise as jpw
from repro.data.index import InvertedIndex as JIndex
from repro_torch import convert
from repro_torch.core import BitmapArena
from repro_torch.core import pairwise as tpw
from repro_torch.data.index import InvertedIndex as TIndex
from repro_torch.kernels import ops as tops

OPS = ("and", "or", "xor", "andnot")
BACKENDS = (None, "ref")


def _mixed(rng, n_chunks=22, p_array=0.25):
    """A JAX-package bitmap whose chunks are absent, sparse arrays, dense
    bitsets, runs, full, or at the 4096/4097 array-bitset edge."""
    parts = []
    for c in range(n_chunks):
        base = c << 16
        r = rng.random()
        if r < 0.12:
            continue
        if r < 0.12 + p_array:
            parts.append(base + rng.choice(
                1 << 16, int(rng.integers(1, 3000)), replace=False))
        elif r < 0.62:
            parts.append(base + rng.choice(
                1 << 16, int(rng.integers(5000, 40000)), replace=False))
        elif r < 0.8:
            lo = int(rng.integers(0, 1 << 15))
            parts.append(np.arange(base + lo,
                                   base + lo + int(rng.integers(64, 30000))))
        elif r < 0.88:
            parts.append(np.arange(base, base + (1 << 16)))
        else:
            parts.append(base + rng.choice(
                1 << 16, 4096 + int(rng.integers(0, 2)), replace=False))
    vals = np.unique(np.concatenate(parts)).astype(np.uint32)
    return JBitmap.from_values(vals).run_optimize()


def _port(jb):
    return convert.bitmap_from_parts(*convert.bitmap_to_parts(jb))


def _same(tb, jb):
    tk, tkinds, tp = convert.bitmap_to_parts(tb)
    jk, jkinds, jp = convert.bitmap_to_parts(jb)
    return (tk == jk and tkinds == jkinds
            and all(np.array_equal(x, y) for x, y in zip(tp, jp)))


@pytest.fixture(scope="module")
def bitmaps():
    """Six JAX-package bitmaps of more than 16 keys, every container kind
    present, two of them sharing most chunks, plus their port twins."""
    rng = np.random.default_rng(2024)
    js = [_mixed(rng) for _ in range(5)]
    js.append(JBitmap.from_values(np.concatenate(
        [js[0].to_array()[::2], np.arange(3 << 16, (3 << 16) + 9000,
                                          dtype=np.uint32)])))
    kinds = {c.kind for b in js for c in b.containers}
    assert kinds == {"array", "bitset", "run"}
    assert all(len(b.keys) > 16 for b in js)
    return js, [_port(b) for b in js]


def _kw(backend):
    return {} if backend is None else {"backend": backend}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", OPS)
def test_merge_one_matches_jax(bitmaps, op, backend):
    js, ts = bitmaps
    for i, j in ((0, 1), (2, 3), (4, 0), (0, 5), (3, 3)):
        want = jpw.merge_one(js[i], js[j], op, **_kw(backend))
        got = tpw.merge_one(ts[i], ts[j], op, device="cpu", **_kw(backend))
        assert _same(got, want), (op, i, j)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pairwise_card_one_op_and_mixed(bitmaps, backend):
    js, ts = bitmaps
    idx = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (2, 2), (1, 4)]
    for ops in OPS + (list(np.resize(OPS, len(idx))),):
        want = jpw.pairwise_card(ops, [(js[i], js[j]) for i, j in idx],
                                 **_kw(backend))
        got = tpw.pairwise_card(ops, [(ts[i], ts[j]) for i, j in idx],
                                device="cpu", **_kw(backend))
        assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_jaccard_matrix_matches_jax(bitmaps, backend):
    js, ts = bitmaps
    want = jpw.jaccard_matrix(js + [JBitmap()], **_kw(backend))
    got = tpw.jaccard_matrix(ts + [_port(JBitmap())], device="cpu",
                             **_kw(backend))
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()
    assert tpw.jaccard_matrix(ts[:1], device="cpu").tolist() == [[1.0]]


def test_host_token_join_past_4096_containers():
    """More than 4096 unique array containers in the array x array class
    take the replicated-probe fallback of the host twin."""
    rng = np.random.default_rng(7)
    keys = np.arange(2100, dtype=np.uint32) << 16
    js = [JBitmap.from_values(np.repeat(keys, 3) + rng.integers(
        0, 40, keys.size * 3).astype(np.uint32)) for _ in range(3)]
    ts = [_port(b) for b in js]
    pairs = [(0, 1), (1, 2), (0, 2), (1, 1)]
    want = jpw.pairwise_card("and", [(js[i], js[j]) for i, j in pairs])
    got = tpw.pairwise_card("and", [(ts[i], ts[j]) for i, j in pairs],
                            device="cpu")
    assert np.array_equal(got, want) and got[3] == ts[1].cardinality


def test_bitmap_methods_match_jax(bitmaps):
    js, ts = bitmaps
    for i, j in ((0, 1), (2, 5), (3, 3), (4, 2)):
        ja, jb, ta, tb = js[i], js[j], ts[i], ts[j]
        assert ta.and_card(tb, device="cpu") == ja.and_card(jb)
        assert ta.or_card(tb, device="cpu") == ja.or_card(jb)
        assert ta.andnot_card(tb, device="cpu") == ja.andnot_card(jb)
        assert ta.xor_card(tb, device="cpu") == ja.xor_card(jb)
        for name in ("jaccard", "cosine"):
            got = getattr(ta, name)(tb, device="cpu")
            want = getattr(ja, name)(jb)
            assert np.float64(got).tobytes() == np.float64(want).tobytes()
        assert ta.intersects(tb, device="cpu") == ja.intersects(jb)
        assert _same(ta.andnot(tb, device="cpu"), ja.andnot(jb))
        for op in OPS:
            assert _same(ta._merge(tb, op, device="cpu"),
                         ja._merge(jb, op))
    empty_t, empty_j = _port(JBitmap()), JBitmap()
    assert empty_t.jaccard(empty_t, device="cpu") == \
        empty_j.jaccard(empty_j) == 1.0
    assert empty_t.cosine(ts[0], device="cpu") == empty_j.cosine(js[0])
    assert not empty_t.intersects(ts[0], device="cpu")


def test_static_methods_match_jax(bitmaps):
    from repro_torch.core import RoaringBitmap as TBitmap
    js, ts = bitmaps
    ops = ["and", "xor", "or", "andnot"]
    want = JBitmap.pairwise_card(ops, list(zip(js[:4], js[1:5])),
                                 backend="ref")
    got = TBitmap.pairwise_card(ops, list(zip(ts[:4], ts[1:5])),
                                backend="ref", device="cpu")
    assert np.array_equal(got, want)
    assert TBitmap.jaccard_matrix(ts[:4], device="cpu").tobytes() == \
        JBitmap.jaccard_matrix(js[:4]).tobytes()


def test_operators_on_the_port_device(bitmaps, monkeypatch):
    """The operators resolve their device like every entry point; with
    the default device mapped to the CPU they equal the JAX package's."""
    js, ts = bitmaps
    real = tops.resolve_device
    monkeypatch.setattr(tops, "resolve_device",
                        lambda device=None, arena=None:
                        real("cpu" if device is None else device, arena))
    for i, j in ((0, 1), (5, 0)):
        assert _same(ts[i] & ts[j], js[i] & js[j])
        assert _same(ts[i] | ts[j], js[i] | js[j])
        assert _same(ts[i] ^ ts[j], js[i] ^ js[j])
        assert _same(ts[i] - ts[j], js[i] - js[j])


def test_operators_raise_without_gpu(bitmaps):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    _, ts = bitmaps
    small = [convert.bitmap_from_parts([1], ["array"],
                                       [np.array([3], np.uint16)])] * 2
    for a, b in ((ts[0], ts[1]), tuple(small)):
        for call in (lambda: a & b, lambda: a | b, lambda: a ^ b,
                     lambda: a - b, lambda: a.and_card(b),
                     lambda: a.jaccard(b),
                     lambda: tpw.pairwise_card("and", [(a, b)]),
                     lambda: tpw.jaccard_matrix([a, b])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


@pytest.mark.parametrize("arena", [False, True])
def test_index_count_and_jaccard(bitmaps, arena):
    js, ts = bitmaps
    names = [f"t{i}" for i in range(len(js))]
    jix = JIndex.from_postings(dict(zip(names, js)), 6 << 16)
    tix = TIndex.from_postings(
        dict(zip(names, ts)), 6 << 16, device="cpu",
        arena=BitmapArena(device="cpu") if arena else None)
    for a, b in ((0, 1), (2, 5), (4, 4), (3, 0)):
        ta, tb = names[a], names[b]
        assert tix.count_and(ta, tb) == jix.count_and(ta, tb)
        assert np.float64(tix.jaccard(ta, tb)).tobytes() == \
            np.float64(jix.jaccard(ta, tb)).tobytes()
    assert tix.count_and("t0", "nope") == jix.count_and("t0", "nope") == 0
    assert tix.jaccard("nope", "none") == jix.jaccard("nope", "none") == 1.0


# ---------------------------------------------------------------------------
# the planner's contract: one launch per class, no hidden host fallback
# ---------------------------------------------------------------------------

_ENTRY = ("bitset_pair_op", "bitset_pair_card", "array_bitset_probe",
          "array_pair_masks", "array_intersect_card")


def _spy(monkeypatch):
    calls = {name: 0 for name in _ENTRY}
    for name in _ENTRY:
        real = getattr(tops, name)

        def wrapped(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, wrapped)
    return calls


def test_one_launch_per_class(bitmaps, monkeypatch):
    js, ts = bitmaps
    calls = _spy(monkeypatch)
    pairs = [(ts[i], ts[j]) for i in range(6) for j in range(6)]
    tpw.pairwise_card("and", pairs, backend="ref", device="cpu")
    assert calls["array_intersect_card"] == 1
    assert calls["array_bitset_probe"] == 1
    assert calls["bitset_pair_card"] == 1
    assert calls["bitset_pair_op"] == calls["array_pair_masks"] == 0
    for op in OPS:
        for i, j in ((0, 5), (1, 2), (2, 4)):
            before = dict(calls)
            tpw.merge_one(ts[i], ts[j], op, backend="ref", device="cpu")
            delta = {k: calls[k] - before[k] for k in calls}
            assert max(delta.values()) == 1, (op, delta)
            assert delta["bitset_pair_card"] == 0
            assert delta["array_intersect_card"] == 0


def test_small_pairs_stay_on_the_host(monkeypatch):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(3)
    j = [JBitmap.from_values(rng.integers(0, 8 << 16, 5000,
                                          dtype=np.uint32))
         for _ in range(2)]
    t = [_port(b) for b in j]
    assert len(t[0].keys) + len(t[1].keys) == 16
    for op in OPS:
        assert _same(tpw.merge_one(t[0], t[1], op, backend="ref",
                                   device="cpu"),
                     jpw.merge_one(j[0], j[1], op, backend="ref"))
    assert np.array_equal(
        tpw.pairwise_card("xor", [tuple(t)], backend="ref", device="cpu"),
        jpw.pairwise_card("xor", [tuple(j)], backend="ref"))
    assert sum(calls.values()) == 0


@pytest.mark.parametrize("name", _ENTRY)
def test_kernel_failure_is_not_served_by_the_host(bitmaps, monkeypatch,
                                                  name):
    """A kernel entry point that raises propagates out of merge_one and
    pairwise_card: neither answers from the scalar host merge instead."""
    _, ts = bitmaps

    def boom(*a, **kw):
        raise RuntimeError(f"{name} failed")
    monkeypatch.setattr(tops, name, boom)
    monkeypatch.setattr(tpw, "_merge_host", lambda *a: pytest.fail(
        "served by the host merge"))
    with pytest.raises(RuntimeError, match=name):
        if name in ("bitset_pair_op", "array_pair_masks"):
            tpw.merge_one(ts[0], ts[5], "and", backend="ref",
                          device="cpu")
        elif name == "array_bitset_probe":
            tpw.merge_one(ts[0], ts[5], "and", backend="ref", device="cpu")
            tpw.pairwise_card("and", [(ts[0], ts[5])], backend="ref",
                              device="cpu")
        else:
            tpw.pairwise_card("and", [(ts[0], ts[5])], backend="ref",
                              device="cpu")
