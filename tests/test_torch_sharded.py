"""The port's sharded boolean paths on the CPU, in one process: the wide
mesh (``repro_torch.dist``), the arena's per-shard slabs, the sharded wide
aggregates with and without an arena, ``execute_plans(mesh=)``, the query
server with ``mesh=`` and ``RoaringTensor.reduce_or(mesh=)``.

A ``WideMesh`` of S CPU devices runs every shard in this process.  The JAX
package's sharded runs need forced host devices in subprocesses, so its
SINGLE-device aggregates are the reference: they are what the JAX
package's own sharded tests hold its sharded runs to.  Results must be
equal container by container for S in {1, 2, 3, 4}; the per-shard
``ArenaStats`` must show warm queries uploading no row and one edit
patching one row on one shard.  The JAX package's ``_shard_plan`` is
compared with the port's directly.
"""

import numpy as np
import pytest
import torch

from repro.core import RoaringBitmap as JBitmap
from repro.core import aggregate as jagg
from repro.data.index import InvertedIndex as JIndex
from repro.serve import Query as JQuery
from repro.serve import QueryServer as JServer
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.core import aggregate as tagg
from repro_torch.core.arena import ShardSlabs
from repro_torch.core.tensor import RoaringTensor
from repro_torch.data.index import InvertedIndex
from repro_torch.dist import WideMesh, ctx
from repro_torch.serve import FaultInjector, Query, QueryServer

CPU = "cpu"
CHUNK = 1 << 16
SIZES = (1, 2, 3, 4)


def _mesh(s):
    return WideMesh([CPU] * s)


def _same(got, want):
    """Container by container: keys, kinds and payloads."""
    gk, gkinds, gp = convert.bitmap_to_parts(got)
    wk, wkinds, wp = convert.bitmap_to_parts(want)
    assert gk == wk
    assert gkinds == wkinds
    for a, b in zip(gp, wp):
        assert np.array_equal(a, b)


def _bitmaps(seed, k=7):
    """K bitmaps with array, bitset and run chunks, and four dense ones
    whose chunks are all bitsets (the AND kernel segments)."""
    rng = np.random.default_rng(seed)
    jb = []
    for _ in range(k):
        parts = [rng.integers(0, 4 * CHUNK, 3000, dtype=np.uint32)]
        lo = int(rng.integers(0, 2 * CHUNK))
        parts.append(np.arange(lo, lo + 50000, dtype=np.uint32))
        parts.append(5 * CHUNK + rng.integers(0, CHUNK, 9000,
                                              dtype=np.uint32))
        jb.append(JBitmap.from_values(np.unique(np.concatenate(parts))))
    dense = [JBitmap.from_values(np.unique(rng.integers(
        0, 4 * CHUNK, 180000, dtype=np.uint32))) for _ in range(4)]
    assert all(c.kind == "bitset" for d in dense for c in d.containers)
    to_t = [convert.bitmap_from_parts(*convert.bitmap_to_parts(b))
            for b in jb + dense]
    return jb, dense, to_t[:k], to_t[k:]


CASES = [("or", None, None), ("xor", None, None), ("andnot", None, None),
         ("threshold", 3, None), ("threshold", 9, [1, 2, 3, 1, 2, 3, 4]),
         ("and", None, None), ("and2", None, None)]


def _run(pkg, op, t, w, bms, dense, **kw):
    if op == "and":
        return pkg.and_many(dense, **kw)
    if op == "and2":                # 2 operands: shards 2, 3 hold no rows
        return pkg.and_many(dense[:2], **kw)
    if op == "andnot":
        return pkg.andnot_many(bms[0], bms[1:], **kw)
    if op == "threshold":
        return pkg.threshold_many(bms, t, weights=w, **kw)
    return getattr(pkg, f"{op}_many")(bms, **kw)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_resolve_wide_cases():
    assert ctx.wide_mesh() is None
    assert ctx.resolve_wide(None) == (None, 1, None)
    m = _mesh(3)
    assert ctx.resolve_wide(m) == (m, 3, "wide")

    class Opaque:
        pass
    o = Opaque()
    assert ctx.resolve_wide(o) == (o, 1, None)

    class TwoD:
        axis_names = ("a", "b")
        devices = (CPU, CPU)
    with pytest.raises(ValueError, match="1-D"):
        ctx.resolve_wide(TwoD())
    ctx.set_wide_mesh(m)
    try:
        assert ctx.resolve_wide(None) == (m, 3, "wide")
        assert tagg._mesh_size(None) == 3
    finally:
        ctx.set_wide_mesh(None)
    assert tagg._resolve_mesh(None) is None


def test_wide_mesh_identity_and_install():
    assert _mesh(2) == _mesh(2) and hash(_mesh(2)) == hash(_mesh(2))
    assert _mesh(2) != _mesh(3)
    assert WideMesh([CPU], axis="x") != WideMesh([CPU])
    with pytest.raises(ValueError):
        WideMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ctx.install_wide_mesh(2)
        assert ctx.wide_mesh() is None


def test_set_default_mesh_shards_every_aggregate():
    jb, dense, tb, td = _bitmaps(1)
    arena = BitmapArena(device=CPU)
    tagg.set_default_mesh(_mesh(3))
    try:
        got = tagg.or_many(tb, arena=arena)
        assert arena._shards is not None and arena._shards.size == 3
    finally:
        tagg.set_default_mesh(None)
    _same(got, jagg.or_many(jb))


# ---------------------------------------------------------------------------
# per-shard slabs
# ---------------------------------------------------------------------------

def _host_rows(arena):
    return arena._host.view(np.int32).reshape(-1, 2048)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_shard_slab_layout(s):
    _, _, tb, td = _bitmaps(2)
    arena = BitmapArena(capacity=8, device=CPU)
    arena.adopt_many(tb + td)
    shards = arena.shard_slabs(_mesh(s))
    assert isinstance(shards, ShardSlabs)
    cap_s = -(-arena.capacity // s)
    ids = np.arange(arena.n_rows)
    assert np.array_equal(shards.positions(ids),
                          (ids % s) * cap_s + ids // s)
    host = _host_rows(arena)
    for k in range(s):
        slab = shards.shard_slab(k).numpy()
        rows = host[k::s]
        assert slab.shape == (cap_s, 2048)
        assert np.array_equal(slab[: rows.shape[0]], rows)
    table = shards.assembled().numpy()
    assert np.array_equal(table[shards.positions(ids)], host[ids])
    assert not table[0].any()                 # global row 0: zero
    assert [st.rows_uploaded for st in shards.stats] == [
        -(-(arena._n - k) // s) for k in range(s)]
    assert arena.stats.rows_uploaded == 0     # the slab never uploaded
    assert arena.shard_slabs(_mesh(s)) is shards
    assert arena.shard_slabs(_mesh(s + 1)) is not shards
    with pytest.raises(ValueError, match="mesh"):
        BitmapArena(device=CPU).shard_slabs(None)


def test_shard_slabs_patch_only_dirty_shards_copy_on_write():
    jb, dense, tb, td = _bitmaps(3)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb)
    shards = arena.shard_slabs(_mesh(4))
    before = shards.assembled()
    snap = before.clone()
    up0 = [st.rows_uploaded for st in shards.stats]
    tb[2].add(7 * CHUNK + 5)                  # a new container: one row
    arena.adopt(tb[2])
    tb[4].add(int(tb[4].to_array()[0]) ^ 1)   # edits one container
    arena.adopt(tb[4])
    after = shards.assembled()
    assert torch.equal(before, snap)          # handed out earlier: intact
    patched = [st.rows_patched for st in shards.stats]
    assert sum(patched) == 2 and max(patched) == 1
    assert [st.rows_uploaded - u for st, u in
            zip(shards.stats, up0)] == patched
    ids = np.arange(arena.n_rows)
    assert np.array_equal(after.numpy()[shards.positions(ids)],
                          _host_rows(arena)[ids])


def test_shard_slabs_grow_on_the_device():
    """Growth pads every shard on the device: rows already there do not
    cross again, only the new ones."""
    _, _, tb, _ = _bitmaps(4)
    arena = BitmapArena(capacity=4, device=CPU)
    arena.adopt_many(tb[:1])
    shards = arena.shard_slabs(_mesh(3))
    shards.assembled()                        # built before the growth
    cap0, n0 = shards.cap_s, arena._n
    up0 = sum(st.rows_uploaded for st in shards.stats)
    arena.adopt_many(tb[1:])                  # grows the arena
    assert arena.capacity > 3 * cap0
    ids = np.arange(arena.n_rows)
    table = shards.assembled().numpy()
    assert shards.cap_s == -(-arena.capacity // 3)
    assert np.array_equal(table[shards.positions(ids)],
                          _host_rows(arena)[ids])
    assert sum(st.rows_uploaded for st in shards.stats) - up0 == \
        arena._n - n0


def test_shards_on_distinct_devices_raise():
    """Shards on distinct devices each hold a slab; a meta device, which
    holds no rows, cannot be one of them."""
    arena = BitmapArena(device=CPU)
    with pytest.raises(ValueError, match="meta device"):
        arena.shard_slabs(WideMesh([CPU, "meta"]))


def test_sync_fences_the_shard_slabs():
    _, _, tb, _ = _bitmaps(5)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb)
    shards = arena.shard_slabs(_mesh(2))
    shards.assembled()
    tb[1].add(9 * CHUNK)
    arena.adopt(tb[1])
    assert shards._pending
    arena.sync()
    assert not shards._pending


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["or", "andnot", "threshold"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_shard_plan_matches_jax(op, d):
    sizes = [1, 5, 2, 8, 3, 4]
    w = None if op != "threshold" else \
        [list(range(1, n + 1)) for n in sizes]
    assert tagg._shard_plan(sizes, d, op, w) == \
        jagg._shard_plan(sizes, d, op, w)


# ---------------------------------------------------------------------------
# the sharded aggregates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("op,t,w", CASES)
def test_sharded_aggregates_match_jax(s, op, t, w):
    """Without an arena (rows from the host, each shard's split copied to
    its device) and with one (rows read from the per-shard slabs)."""
    jb, dense, tb, td = _bitmaps(10 + s)
    want = _run(jagg, op, t, w, jb, dense, backend="ref")
    mesh = _mesh(s)
    _same(_run(tagg, op, t, w, tb, td, device=CPU, mesh=mesh,
               backend="ref"), want)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb + td)
    _same(_run(tagg, op, t, w, tb, td, arena=arena, mesh=mesh,
               backend="ref"), want)
    _same(_run(tagg, op, t, w, tb, td, arena=arena, mesh=mesh), want)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_cold_rows_on_every_shard(s):
    """Cold operands ride the staged block and point at position 0 (the
    arena's zero row) while resident rows of every shard, the shards >= 1
    included, are read in place; never-adopted rows are staged, not
    uploaded, and the answers are the JAX package's."""
    jb, dense, tb, td = _bitmaps(20 + s)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb[:3] + td[:2])         # the rest stay cold
    mesh = _mesh(s)
    shards = arena.shard_slabs(mesh)
    shards.assembled()
    owners = {int(r) % s for r in arena._row_of.values()}
    assert owners == set(range(s))            # resident rows on all shards
    up0 = [st.rows_uploaded for st in shards.stats]
    st0 = arena.stats.host_rows_staged
    for op, t, w in CASES:
        _same(_run(tagg, op, t, w, tb, td, arena=arena, mesh=mesh,
                   backend="ref"),
              _run(jagg, op, t, w, jb, dense, backend="ref"))
    assert [st.rows_uploaded for st in shards.stats] == up0
    assert arena.stats.host_rows_staged > st0


def test_warm_sharded_aggregates_upload_nothing():
    jb, dense, tb, td = _bitmaps(30)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb + td)
    mesh = _mesh(4)

    def run_all():
        return [_run(tagg, op, t, w, tb, td, arena=arena, mesh=mesh)
                for op, t, w in CASES]
    first = run_all()
    shards = arena.shard_slabs(mesh)
    up0 = [st.rows_uploaded for st in shards.stats]
    g0 = [st.device_gathers for st in shards.stats]
    staged0 = arena.stats.host_rows_staged
    assert sum(up0) > 0
    for a, b in zip(run_all(), first):
        _same(a, b)
    assert [st.rows_uploaded for st in shards.stats] == up0
    assert arena.stats.host_rows_staged == staged0
    assert all(b > a for a, b in zip(g0, (st.device_gathers
                                           for st in shards.stats)))
    assert arena.stats.rows_uploaded == 0
    tb[3].add(7 * CHUNK + 1)                  # one new container row
    arena.adopt(tb[3])
    jb[3].add(7 * CHUNK + 1)
    rp0 = [st.rows_patched for st in shards.stats]
    _same(tagg.or_many(tb, arena=arena, mesh=mesh), jagg.or_many(jb))
    deltas = [st.rows_patched - r for st, r in zip(shards.stats, rp0)]
    assert sum(deltas) == 1 and max(deltas) == 1


@pytest.mark.parametrize("s", [1, 3, 4])
def test_execute_plans_mesh_coalesces_per_segment_t(s):
    """Coalesced threshold plans with their own T and weights, and the
    other classes, through ``execute_plans(mesh=)``."""
    jb, dense, tb, td = _bitmaps(40 + s)
    arena = BitmapArena(device=CPU)
    arena.adopt_many(tb + td)
    specs = [("threshold", jb[:5], tb[:5], 2, None),
             ("threshold", jb[1:], tb[1:], 4, None),
             ("threshold", jb, tb, 11, [3, 1, 2, 4, 1, 2, 3]),
             ("or", jb[:3], tb[:3], 0, None),
             ("and", dense, td, 0, None),
             ("andnot", jb, tb, 0, None)]
    jplans = [jagg.plan_wide(op, j, t, w, backend="ref")
              for op, j, _, t, w in specs]
    want = jagg.execute_plans(jplans, backend="ref")
    tplans = [tagg.plan_wide(op, x, t, w, backend="ref", arena=arena)
              for op, _, x, t, w in specs]
    for got, w in zip(tagg.execute_plans(tplans, backend="ref",
                                         mesh=_mesh(s)), want):
        _same(got, w)


@pytest.mark.parametrize("s", [2, 4])
def test_bitmap_many_takes_mesh(s):
    jb, dense, tb, td = _bitmaps(50)
    mesh = _mesh(s)
    _same(RoaringBitmap.or_many(tb, device=CPU, mesh=mesh),
          JBitmap.or_many(jb))
    _same(RoaringBitmap.and_many(td, device=CPU, mesh=mesh),
          JBitmap.and_many(dense))
    _same(RoaringBitmap.xor_many(tb, device=CPU, mesh=mesh),
          JBitmap.xor_many(jb))
    _same(RoaringBitmap.andnot_many(tb[0], tb[1:], device=CPU, mesh=mesh),
          JBitmap.andnot_many(jb[0], jb[1:]))
    _same(RoaringBitmap.threshold_many(tb, 3, device=CPU, mesh=mesh),
          JBitmap.threshold_many(jb, 3))


# ---------------------------------------------------------------------------
# the server and reduce_or
# ---------------------------------------------------------------------------

VOCAB = [f"t{i}" for i in range(24)]


def _docs():
    rng = np.random.default_rng(0xFA17)
    return [[VOCAB[j] for j in rng.choice(len(VOCAB), int(rng.integers(
        3, 9)), replace=False)] for _ in range(900)]


def _queries(mod):
    return [mod.or_("t1", "t2", "t3"), mod.and_("t1", "t2"),
            mod.xor_("t4", "t5", "t6"), mod.andnot("t1", "t7", "t8"),
            mod.threshold(["t1", "t2", "t3", "t4", "t5"], 3),
            mod.threshold(["t1", "t2", "t3"], 4, weights=[3, 1, 2]),
            mod.similar("t2", 5), mod.similar("t7", 3, metric="cosine")]


def _values(tickets):
    out = []
    for t in tickets:
        assert t.result.ok, t.result
        v = t.result.value
        out.append(v if isinstance(v, list) else v.to_array().tolist())
    return out


@pytest.mark.parametrize("s", [2, 4])
def test_server_with_mesh_under_slab_mismatch(s):
    docs = _docs()
    ref = JServer(JIndex().build(docs), backend="ref")
    jt = [ref.submit(q) for q in _queries(JQuery)]
    ref.run_until_idle()
    want = _values(jt)
    ix = InvertedIndex(arena=BitmapArena(device=CPU)).build(docs)
    mesh = _mesh(s)
    srv = QueryServer(ix, backend="ref", mesh=mesh,
                      faults=FaultInjector.script({"slab_mismatch": [True]}))
    tickets = [srv.submit(q) for q in _queries(Query)]
    srv.run_until_idle()
    assert _values(tickets) == want
    assert srv.stats().replans == 1 and srv.stats().host_fallbacks == 0
    shards = ix.arena.shard_slabs(mesh)
    up0 = [st.rows_uploaded for st in shards.stats]
    again = [srv.submit(q) for q in _queries(Query)]
    srv.run_until_idle()
    assert _values(again) == want
    assert [st.rows_uploaded for st in shards.stats] == up0
    dead = QueryServer(ix, backend="ref", mesh=mesh,
                       faults=FaultInjector.script({"dispatch_raise":
                                                    "always"}))
    ts = [dead.submit(q) for q in _queries(Query)]
    dead.run_until_idle()
    assert _values(ts) == want
    assert all(t.telemetry.degraded for t in ts)


@pytest.mark.parametrize("s", SIZES)
def test_reduce_or_mesh(s):
    jb, dense, tb, td = _bitmaps(60)
    t = RoaringTensor.from_bitmaps(tb + td, device=CPU)
    got = t.reduce_or(mesh=_mesh(s)).to_bitmaps()[0]
    _same(got, t.reduce_or().to_bitmaps()[0])
    assert np.array_equal(got.to_array(),
                          jagg.or_many(jb + dense).to_array())
