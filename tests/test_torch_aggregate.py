"""The port's wide-aggregation planner against the JAX package's, on the
CPU: seeded sweeps over container-kind mix x op x K, with and without an
arena, one plan at a time and coalesced through ``execute_plans``.

Both packages run the same seeded bitmaps (the port's are built from the
JAX package's parts through ``repro_torch.convert``).  They run with
``backend="ref"`` (the kernel route, through the plain versions) and with
the default backend, where both make the same ``prefer_kernel`` choice on
the CPU.  Results must be equal container by container -- the same keys,
kinds and payloads -- and the arenas' ``ArenaStats`` counters must agree.
Modelled on ``tests/core/test_wide_differential.py`` at mesh size 1.
"""

import numpy as np
import pytest

from repro.core import RoaringBitmap as JBitmap
from repro.core import aggregate as jagg
from repro.core.arena import BitmapArena as JArena
from repro_torch import convert
from repro_torch.core import aggregate as tagg
from repro_torch.core.arena import BitmapArena as TArena

CHUNK = 1 << 16
CPU = "cpu"


def _mixed_bitmap(rng, mix, shared):
    """One bitmap of the requested container-kind mix; ``shared`` is a
    dense block in every bitmap (pins threshold ties, keeps AND
    non-empty)."""
    parts = [shared]
    if mix in ("array", "mixed"):
        parts.append(rng.integers(0, 4 * CHUNK, 2500, dtype=np.uint32))
    if mix in ("bitset", "mixed"):
        base = int(rng.integers(0, 3)) * CHUNK
        parts.append(base + rng.integers(0, 2 * CHUNK, 45000,
                                         dtype=np.uint32))
    if mix in ("run", "mixed"):
        lo = int(rng.integers(0, 2 * CHUNK))
        parts.append(np.arange(lo, lo + int(rng.integers(5000, 30000)),
                               dtype=np.uint32))
    bm = JBitmap.from_values(np.unique(np.concatenate(parts)))
    if mix == "run":
        bm.run_optimize()
    return bm


def _bitmaps(seed, mix, k):
    rng = np.random.default_rng(seed)
    shared = (5 * CHUNK + rng.integers(0, CHUNK, 9000, dtype=np.uint32))
    jb = [_mixed_bitmap(rng, mix, shared) for _ in range(k)]
    # a dense array-only chunk held by two bitmaps: the prefer_kernel case
    dense = 9 * CHUNK + rng.choice(CHUNK, 3000, replace=False)
    jb[0] = JBitmap.from_values(np.concatenate([jb[0].to_array(), dense]))
    jb[1] = JBitmap.from_values(np.concatenate([jb[1].to_array(),
                                                dense[::2] + 1]))
    tb = [convert.bitmap_from_parts(*convert.bitmap_to_parts(b))
          for b in jb]
    weights = [int(x) for x in rng.integers(1, 8, k)]
    return jb, tb, weights


def _same(got, want):
    """Container by container: keys, kinds and payloads."""
    gk, gkinds, gp = convert.bitmap_to_parts(got)
    wk, wkinds, wp = convert.bitmap_to_parts(want)
    assert gk == wk
    assert gkinds == wkinds
    for a, b in zip(gp, wp):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _cases(k, weights):
    return [("or", 0, None), ("xor", 0, None), ("and", 0, None),
            ("andnot", 0, None),
            ("threshold", max(2, k // 2), None),
            ("threshold", k, None),                    # tie: count == K
            ("threshold", sum(weights), weights),      # weighted tie
            ("threshold", sum(weights) // 2, weights)]


def _args(op, bms):
    return (bms[0], bms[1:]) if op == "andnot" else (bms,)


@pytest.mark.parametrize("backend", ["ref", None])
@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("mix", ["array", "bitset", "run", "mixed"])
def test_wide_ops_match_jax(mix, k, arena, backend):
    jb, tb, weights = _bitmaps(100 + k, mix, k)
    ja = tr = None
    if arena:
        ja, tr = JArena(), TArena(device=CPU)
        ja.adopt_many(jb[::2])                  # half resident, half cold
        tr.adopt_many(tb[::2])
    for op, t, w in _cases(k, weights):
        extra = {"t": t, "weights": w} if op == "threshold" else {}
        want = getattr(jagg, f"{op}_many")(*_args(op, jb), backend=backend,
                                           arena=ja, **extra)
        got = getattr(tagg, f"{op}_many")(*_args(op, tb), backend=backend,
                                          arena=tr,
                                          device=None if arena else CPU,
                                          **extra)
        _same(got, want)
    if arena:
        assert tr.stats.as_dict() == ja.stats.as_dict()


@pytest.mark.parametrize("backend", ["ref", None])
@pytest.mark.parametrize("arena", [False, True])
def test_coalesced_plans_match_jax(arena, backend):
    jb, tb, weights = _bitmaps(7, "mixed", 6)
    ja = tr = None
    if arena:
        ja, tr = JArena(), TArena(device=CPU)
        ja.adopt_many(jb)
        tr.adopt_many(tb)
    spec = [("threshold", 2, None), ("threshold", 3, None),
            ("threshold", 6, None), ("or", 0, None), ("and", 0, None),
            ("threshold", sum(weights) // 2, weights), ("xor", 0, None),
            ("andnot", 0, None)]
    jplans = [jagg.plan_wide(op, jb, t, w, backend=backend, arena=ja)
              for op, t, w in spec]
    tplans = [tagg.plan_wide(op, tb, t, w, backend=backend, arena=tr,
                             device=None if arena else CPU)
              for op, t, w in spec]
    for jp, tp in zip(jplans, tplans):
        assert tp.op == jp.op and tp.threshold == jp.threshold
        assert tp.seg_keys == jp.seg_keys
        assert [len(r) for r in tp.seg_rows] == \
            [len(r) for r in jp.seg_rows]
    want = jagg.execute_plans(jplans, backend=backend)
    got = tagg.execute_plans(tplans, backend=backend)
    for g, w in zip(got, want):
        _same(g, w)
    if arena:
        assert tr.stats.as_dict() == ja.stats.as_dict()
    # bit-identical to finishing each plan alone
    for g, (op, t, w) in zip(got, spec):
        extra = {"t": t, "weights": w} if op == "threshold" else {}
        _same(g, getattr(tagg, f"{op}_many")(
            *_args(op, tb), backend=backend, arena=tr,
            device=None if arena else CPU, **extra))


def test_deep_batch_buckets_by_depth():
    """>= 64 segments split into power-of-two depth buckets, one launch
    each; results still match the JAX package."""
    rng = np.random.default_rng(3)
    jb = []
    for i in range(9):
        keys = rng.choice(96, 80 if i < 2 else 8, replace=False)
        vals = np.concatenate([k * CHUNK + rng.choice(CHUNK, 5000,
                                                       replace=False)
                               for k in keys])
        jb.append(JBitmap.from_values(vals))
    tb = [convert.bitmap_from_parts(*convert.bitmap_to_parts(b))
          for b in jb]
    ja, tr = JArena(), TArena(device=CPU)
    ja.adopt_many(jb)
    tr.adopt_many(tb)
    for op in ("or", "xor", "and"):
        want = getattr(jagg, f"{op}_many")(jb, backend="ref", arena=ja)
        got = getattr(tagg, f"{op}_many")(tb, backend="ref", arena=tr)
        _same(got, want)
    assert tr.stats.device_gathers == ja.stats.device_gathers > 3


def test_validation_matches_jax():
    jb, tb, _ = _bitmaps(5, "array", 3)
    for bad in ({"t": 0}, {"t": 2, "weights": [1, 2]},
                {"t": 2, "weights": [1, 0, 1]}):
        with pytest.raises(ValueError):
            jagg.threshold_many(jb, **bad)
        with pytest.raises(ValueError):
            tagg.threshold_many(tb, device=CPU, **bad)
    with pytest.raises(ValueError):
        tagg.plan_wide("nand", tb, device=CPU)
    with pytest.raises(ValueError):
        tagg.plan_wide("andnot", [], device=CPU)
