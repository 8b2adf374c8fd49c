"""The port's ``RoaringTensor`` (``repro_torch.core.tensor``) against the
JAX package's (``repro.core.tensor``), on the CPU.

Every case of ``tests/core/test_tensor.py`` is carried across: the same
seeded bitmaps are built in both packages (through ``convert``'s parts),
each operation runs in both, and all five components -- keys, kinds,
cards, aux and the slab's bits -- must be equal (``convert.
tensor_to_parts``), as must counts and float32 Jaccard bits.  The JAX side
runs once with ``repro.kernels.ops.set_default_backend("pallas")`` (its
Pallas kernels in interpret mode) and once with ``"ref"``; its results are
computed once per backend and shared.  Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RoaringBitmap as JBitmap
from repro.core import tensor as jt
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import BitmapArena, aggregate
from repro_torch.core import tensor as pt
from repro_torch.kernels import bitset_convert, pair_ops, segment_ops

BACKENDS = ("pallas", "ref")
OPS = ("__and__", "__or__", "__xor__", "andnot")
COUNTS = ("and_card", "or_card", "xor_card", "andnot_card")
PW_OPS = ["and", "or", "xor", "andnot", "and", "or", "xor"]
PW_LHS = [0, 1, 2, 3, 0, 0, 2]
PW_RHS = [3, 2, 1, 0, 0, 3, 2]


def _port(bms):
    return [convert.bitmap_from_parts(*convert.bitmap_to_parts(b))
            for b in bms]


@pytest.fixture(scope="module")
def pairs():
    """The bitmaps of ``tests/core/test_tensor.py``'s ``pairs`` (same
    seed), in both packages, and their tensors at capacity 8."""
    rng = np.random.default_rng(0xC0FFEE)

    def rand(n, hi):
        return JBitmap.from_values(rng.integers(0, hi, n).astype(np.uint32))
    a = [rand(30000, 1 << 19), rand(400, 1 << 18),
         JBitmap.from_range(5000, 180_000).run_optimize(), JBitmap()]
    b = [rand(15000, 1 << 19), JBitmap.from_range(0, 90_000),
         rand(70000, 1 << 18), rand(100, 1 << 16)]
    q = rng.integers(0, 1 << 19, (len(a), 200)).astype(np.uint32)
    q[:, :3] = [0, 5000, 179_999]
    pa, pb = _port(a), _port(b)
    return dict(
        a=a, b=b, pa=pa, pb=pb, q=q,
        ja=jt.RoaringTensor.from_bitmaps(a, capacity=8),
        jb=jt.RoaringTensor.from_bitmaps(b, capacity=8),
        ta=pt.RoaringTensor.from_bitmaps(pa, capacity=8, device="cpu"),
        tb=pt.RoaringTensor.from_bitmaps(pb, capacity=8, device="cpu"))


@pytest.fixture(scope="module")
def jx(pairs):
    """``jx(backend, name)``: the JAX package's result of one operation
    under that default backend, as numpy, computed once."""
    ja, jb, q = pairs["ja"], pairs["jb"], pairs["q"]
    parts = convert.tensor_to_parts
    calls = {
        "to_words": lambda: np.asarray(ja.to_words()),
        "run_optimize": lambda: parts(ja.run_optimize()),
        "run_optimize_b": lambda: parts(jb.run_optimize()),
        "reduce_or_a": lambda: parts(ja.reduce_or()),
        "reduce_or_b": lambda: parts(jb.reduce_or()),
        "contains": lambda: np.asarray(ja.contains(jnp.asarray(q))),
        "contains_ro": lambda: np.asarray(
            ja.run_optimize().contains(jnp.asarray(q))),
        "jaccard": lambda: np.asarray(ja.jaccard(jb)),
        "pairwise": lambda: np.asarray(ja.pairwise_card(
            jb, PW_OPS, lhs_idx=PW_LHS, rhs_idx=PW_RHS)),
        "pairwise_one": lambda: np.asarray(ja.pairwise_card(jb, "xor")),
        "align": lambda: tuple(np.asarray(x) for x in ja._align(jb)),
    }
    for op in OPS:
        calls[op] = (lambda o: lambda: parts(getattr(ja, o)(jb)))(op)
    for op in COUNTS:
        calls[op] = (lambda o: lambda: np.asarray(getattr(ja, o)(jb)))(op)
    cache = {}

    def run(backend, name):
        if (backend, name) not in cache:
            prev = jops._DEFAULT
            jops.set_default_backend(backend)
            try:
                cache[backend, name] = calls[name]()
            finally:
                jops.set_default_backend(prev)
        return cache[backend, name]
    return run


def _same(got, want_parts):
    for g, w, name in zip(convert.tensor_to_parts(got), want_parts,
                          ("keys", "kinds", "cards", "aux", "slab")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


def test_roundtrip(pairs):
    ta = pairs["ta"]
    _same(ta, convert.tensor_to_parts(pairs["ja"]))
    assert ta.slab.dtype == torch.int16 and ta.device.type == "cpu"
    assert ta.to_bitmaps() == pairs["pa"]
    assert ta.cardinality().dtype == torch.int32
    assert ta.cardinality().tolist() == [x.cardinality for x in pairs["a"]]
    assert np.array_equal(ta.packed_nbytes().numpy(),
                          np.asarray(pairs["ja"].packed_nbytes()))
    assert ta.batch == 4 and ta.capacity == 8


@pytest.mark.parametrize("backend", BACKENDS)
def test_to_words(pairs, jx, backend):
    got = pairs["ta"].to_words()
    assert got.shape == (4, 8, 2048) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), jx(backend,
                                                          "to_words"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", OPS)
def test_binary_ops(pairs, jx, op, backend):
    got = getattr(pairs["ta"], op)(pairs["tb"])
    _same(got, jx(backend, op))
    # the host oracle: the JAX package's numpy RoaringBitmap algebra
    assert got.to_bitmaps() == _port([getattr(x, op)(y) for x, y in
                                      zip(pairs["a"], pairs["b"])])


@pytest.mark.parametrize("backend", BACKENDS)
def test_count_only(pairs, jx, backend):
    ta, tb = pairs["ta"], pairs["tb"]
    for op in COUNTS:
        got = getattr(ta, op)(tb)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), jx(backend, op)), op
    jac = ta.jaccard(tb)
    assert jac.dtype == torch.float32
    assert np.array_equal(jac.numpy().view(np.int32),
                          jx(backend, "jaccard").view(np.int32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_contains(pairs, jx, backend):
    ta, q = pairs["ta"], pairs["q"]
    got = ta.contains(q).numpy()
    assert np.array_equal(got, jx(backend, "contains"))
    assert np.array_equal(ta.contains(torch.from_numpy(q.astype(np.int64)))
                          .numpy(), got)
    for i, bm in enumerate(pairs["pa"]):
        assert np.array_equal(got[i], bm.contains_many(q[i])), i
    ro = ta.run_optimize()
    assert (ro.kinds == pt.KIND_RUN).any()
    assert np.array_equal(ro.contains(q).numpy(),
                          jx(backend, "contains_ro"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_optimize_device(pairs, jx, backend):
    ro = pairs["ta"].run_optimize()
    _same(ro, jx(backend, "run_optimize"))
    _same(pairs["tb"].run_optimize(), jx(backend, "run_optimize_b"))
    assert ro.to_bitmaps() == pairs["pa"]
    assert (ro.kinds == pt.KIND_RUN).any()
    host = [x.copy().run_optimize().memory_bytes() for x in pairs["pa"]]
    assert ro.packed_nbytes().tolist() == host


def test_composition_without_jit(pairs):
    """``test_jit_composition``'s expression, composed eagerly: the port
    has no jit, and needs none."""
    ta, tb, ja, jb = pairs["ta"], pairs["tb"], pairs["ja"], pairs["jb"]

    @jax.jit
    def f(x, y):
        return ((x & y) | (x ^ y)).cardinality()

    got = ((ta & tb) | (ta ^ tb)).cardinality()
    assert got.tolist() == np.asarray(f(ja, jb)).tolist()
    assert got.tolist() == [(x | y).cardinality for x, y in
                            zip(pairs["a"], pairs["b"])]


def test_block_mask_words():
    jbm = JBitmap.from_values([0, 5, 31, 32, 100, 127, 128, 4000])
    want = np.asarray(jt.block_mask_words([jbm, JBitmap()], 128))
    (bm,) = _port([jbm])
    got = pt.block_mask_words([bm, _port([JBitmap()])[0]], 128,
                              device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert int(got[0, 0]) == 1 | (1 << 5) | -(1 << 31)
    wide = pt.block_mask_words([bm], 65536, device="cpu")
    assert np.array_equal(wide.numpy().view(np.uint32),
                          np.asarray(jt.block_mask_words([jbm], 65536)))
    with pytest.raises(ValueError):
        pt.block_mask_words([bm], 65537, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_or(pairs, jx, backend):
    ta, tb = pairs["ta"], pairs["tb"]
    segment_ops.reset_launches()
    got = ta.reduce_or()
    _same(got, jx(backend, "reduce_or_a"))
    _same(tb.reduce_or(backend="ref"), jx(backend, "reduce_or_b"))
    assert segment_ops.launches == 0          # CPU: the plain version
    union = np.unique(np.concatenate([bm.to_array() for bm in pairs["pa"]]))
    assert np.array_equal(got.to_bitmaps()[0].to_array(), union)


def test_reduce_or_of_empty_rows():
    t = pt.RoaringTensor.from_bitmaps(_port([JBitmap(), JBitmap()]),
                                      capacity=2, device="cpu")
    j = jt.RoaringTensor.from_bitmaps([JBitmap(), JBitmap()], capacity=2)
    _same(t.reduce_or(), convert.tensor_to_parts(j.reduce_or()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pairwise_card_mixed_ops_repeated_rows(pairs, jx, backend):
    ta, tb = pairs["ta"], pairs["tb"]
    got = ta.pairwise_card(tb, PW_OPS, lhs_idx=PW_LHS, rhs_idx=PW_RHS)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), jx(backend, "pairwise"))
    assert np.array_equal(ta.pairwise_card(tb, "xor").numpy(),
                          jx(backend, "pairwise_one"))
    with pytest.raises(ValueError, match="one op per pair"):
        ta.pairwise_card(tb, ["and"] * 3)
    with pytest.raises(ValueError, match="row counts differ"):
        ta.pairwise_card(tb, "and", lhs_idx=[0, 1])


def test_align_matches_jax(pairs, jx):
    want = jx("ref", "align")
    got = pairs["ta"]._align(pairs["tb"])
    assert np.array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy().view(np.uint32), w)
    for g, w in zip(got[3:], want[3:]):
        assert np.array_equal(g.numpy(), w)


def test_take(pairs):
    ta, ja = pairs["ta"], pairs["ja"]
    idx = [3, 0, 0, 2]
    _same(ta.take(idx), convert.tensor_to_parts(ja.take(idx)))
    _same(ta.take(np.array(idx, np.int32)),
          convert.tensor_to_parts(ja.take(idx)))
    assert ta.take([]).batch == 0
    with pytest.raises(IndexError):
        ta.take([0, 4])
    with pytest.raises(IndexError):
        ta.take([-1])
    with pytest.raises(IndexError):
        ja.take(jnp.asarray([0, 4]))


def test_helpers_match_jax():
    """``_extract_runs`` / ``_num_runs_words`` on words with up to 16,433
    runs (more than 2,048 keep their first 2,048), bits 0 and 65535 set
    and runs across word boundaries; ``_runs_to_words`` on runs to 65535,
    ends past it, overlapping garbage runs and a run count of 0; the slab
    views both ways."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, (6, 2048), dtype=np.uint32)
    words[1] = 0
    words[2] = 0xFFFFFFFF
    words[3] = 0
    words[3, 10], words[3, 11], words[3, 2047] = 1 << 31, 1, 1 << 31
    for _ in range(6):
        words[4] &= rng.integers(0, 1 << 32, 2048, dtype=np.uint32)
    tw = torch.from_numpy(words.view(np.int32))
    js, jn = jt._extract_runs(jnp.asarray(words))
    ps, pn = pt._extract_runs(tw)
    assert np.array_equal(ps.numpy().view(np.uint16), np.asarray(js))
    assert np.array_equal(pn.numpy(), np.asarray(jn))
    assert pn[3] == 2 and pn[5] > 2048
    assert np.array_equal(pt._num_runs_words(tw).numpy(),
                          np.asarray(jt._num_runs_words(jnp.asarray(words))))
    slab = np.zeros((5, 4096), np.uint16)
    slab[0, :6] = [0, 0, 5, 10, 65535, 0]
    slab[1, :4] = [100, 65535, 7, 3]
    slab[2] = rng.integers(0, 1 << 16, 4096)
    slab[3, :4] = [65535, 0, 0, 65535]
    nr = np.array([3, 2, 2048, 2, 0], np.int32)
    jw = jt._runs_to_words(jnp.asarray(slab), jnp.asarray(nr))
    pw = pt._runs_to_words(torch.from_numpy(slab.view(np.int16)),
                           torch.from_numpy(nr))
    assert np.array_equal(pw.numpy().view(np.uint32), np.asarray(jw))
    s16 = torch.from_numpy(slab.view(np.int16))
    assert np.array_equal(
        pt.slab16_to_words32(s16).numpy().view(np.uint32),
        np.asarray(jt.slab16_to_words32(jnp.asarray(slab))))
    assert np.array_equal(
        pt.words32_to_slab16(tw).numpy().view(np.uint16),
        np.asarray(jt.words32_to_slab16(jnp.asarray(words))))


def test_repack_matches_jax():
    """``repack`` straight from words with tracked cards, runs allowed or
    not: unsorted keys, empty slots, cards 0, a run-count tie and a bitset
    of more than 2,047 runs."""
    rng = np.random.default_rng(9)
    words = np.zeros((2, 4, 2048), np.uint32)
    words[0, 0, :10] = 0xFFFFFFFF                       # one run of 320
    words[0, 1] = rng.integers(0, 1 << 32, 2048, dtype=np.uint32)
    words[0, 2, 0] = 0b111                              # card 3, one run
    words[1, 0] = 0x55555555                            # 32,768 runs
    words[1, 1, 5] = 1 << 7
    words[1, 3, 2047] = 1 << 31
    keys = np.array([[9, 2, 5, 0x7FFFFFFF], [4, 1, 3, 0]], np.int32)
    cards = np.array([[320, int(np.bitwise_count(words[0, 1]).sum()), 3, 0],
                      [32768, 1, 0, 1]], np.int32)
    for runs in (False, True):
        want = jt.repack(jnp.asarray(keys), jnp.asarray(cards),
                         jnp.asarray(words), allow_runs=runs)
        got = pt.repack(torch.from_numpy(keys), torch.from_numpy(cards),
                        torch.from_numpy(words.view(np.int32)),
                        allow_runs=runs)
        _same(got, convert.tensor_to_parts(want))


def test_to_arena_then_or_many(pairs):
    ta = pairs["ta"]
    arena, bms = ta.to_arena()
    assert arena.device.type == "cpu"
    assert bms == pairs["pa"] and all(arena.resident(b) for b in bms)
    got = aggregate.or_many(bms, arena=arena, backend="ref")
    union = np.unique(np.concatenate([b.to_array() for b in bms]))
    assert np.array_equal(got.to_array(), union)
    mine = BitmapArena(device="cpu")
    assert ta.to_arena(mine)[0] is mine


def test_parts_round_trip(pairs):
    ta = pairs["ta"]
    parts = convert.tensor_to_parts(ta)
    assert parts[4].dtype == np.uint16
    again = convert.tensor_from_parts(*parts, device="cpu")
    _same(again, parts)
    _same(again, convert.tensor_to_parts(pairs["ja"]))


def test_from_bitmaps_capacity(pairs):
    with pytest.raises(ValueError, match="capacity"):
        pt.RoaringTensor.from_bitmaps(pairs["pa"], capacity=1,
                                      device="cpu")
    auto = pt.RoaringTensor.from_bitmaps(pairs["pa"], device="cpu")
    want = jt.RoaringTensor.from_bitmaps(pairs["a"])
    _same(auto, convert.tensor_to_parts(want))


def test_cpu_tensor_launches_no_kernel(pairs):
    for mod in (bitset_convert, pair_ops, segment_ops):
        mod.reset_launches()
    ta, tb = pairs["ta"], pairs["tb"]
    (ta & tb).to_words()
    ta.and_card(tb)
    ta.reduce_or()
    assert bitset_convert.launches == pair_ops.launches == \
        segment_ops.launches == 0
