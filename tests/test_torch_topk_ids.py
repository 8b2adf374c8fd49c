"""The port's plain versions of the sharded similarity kernels
(``repro_torch.kernels.ref.similarity_score_ids`` / ``topk_select_ids`` /
``similarity_topk_ids``, and ``kernels.ops.similarity_topk_ids`` /
``topk_merge``) against the JAX package's jnp oracle and its Pallas
kernels run in interpret mode, on the same seeded numpy inputs; and the
bit-sliced counters of the sharded threshold path (``segment_counters``,
``bitsliced_add``, ``counters_ge``) against the JAX package's.

Inputs: ragged slots (empty ones among them) whose rows the port reads
through positions into a larger table (the JAX side gets the gathered
rows), exact ties between slots, every metric, ``n_valid`` below the slot
count with all-zero pad rows, an excluded global id inside and outside the
slots, k from 1 past the slot count.  The labelled select alone: its
exhaustion rounds (the lowest id in a group taken earlier among them),
degenerate lists, and 5,000 entries, past the 1,024 one block of the
CUDA kernel sorts.  The tolerance is 0: ids and intersections equal,
float32 scores bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

WORDS = tref.WORDS
METRICS = tref.METRICS


def _case(seed, slots=12, c=4, n_valid=None, density=0.03):
    """Slots of 0..3 rows each (slots 2 and 3 copy slot 1: exact ties),
    rows held in a table twice as large, read through positions; the
    slots at or past ``n_valid`` are padding with no rows and card 0, as
    the sharded engine lays them out."""
    rng = np.random.default_rng(seed)
    n_valid = slots if n_valid is None else n_valid
    rows, row_col, starts, cards = [], [], [0], []
    first = None
    for i in range(slots):
        if i >= n_valid:
            src = []
        elif i in (2, 3) and first is not None:
            src = first
        else:
            src = []
            for col in np.sort(rng.choice(c, int(rng.integers(0, 4)),
                                          replace=False)):
                w = (rng.random(WORDS) < density).astype(np.uint32) \
                    * rng.integers(1, 1 << 32, WORDS, dtype=np.uint32)
                src.append((w, int(col)))
        if i == 1:
            first = src
        for w, col in src:
            rows.append(w)
            row_col.append(col)
        starts.append(len(rows))
        cards.append(sum(int(np.bitwise_count(w).sum()) for w, _ in src))
    n = len(rows)
    table = rng.integers(0, 1 << 32, (2 * n + 3, WORDS), dtype=np.uint32)
    table[-1] = 0                                 # the shard's zero row
    pos = rng.permutation(table.shape[0] - 1)[:n].astype(np.int32)
    if n:
        table[pos] = np.stack(rows)
    q = (rng.random((c, WORDS)) < density * 3).astype(np.uint32) \
        * rng.integers(1, 1 << 32, (c, WORDS), dtype=np.uint32)
    gidx = np.sort(rng.choice(1000, slots, replace=False)).astype(np.int32)
    gidx[n_valid:] = 1000                         # pad slots: id n
    return dict(table=table, pos=pos,
                rows=table[pos] if n else np.zeros((1, WORDS), np.uint32),
                row_col=np.asarray(row_col, np.int32),
                starts=np.asarray(starts, np.int32), q=q,
                q_card=int(np.bitwise_count(q).sum()),
                cards=np.asarray(cards, np.int32), gidx=gidx,
                n_valid=n_valid)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _j_args(x, n_rows=40):
    """The JAX side's arguments: the gathered rows, padded with zero rows
    to one shape, so its jit compiles once per metric and k."""
    n = x["row_col"].size
    rows = np.zeros((n_rows, WORDS), np.uint32)
    rows[:n] = x["rows"][:n]
    row_col = np.zeros(n_rows, np.int32)
    row_col[:n] = x["row_col"]
    return (jnp.asarray(rows), jnp.asarray(row_col),
            jnp.asarray(x["starts"]), jnp.asarray(x["q"]), x["q_card"],
            jnp.asarray(x["cards"]), jnp.asarray(x["gidx"]))


def _t_args(x):
    return (_t(x["table"]), _t(x["pos"]), _t(x["row_col"]),
            _t(x["starts"]), _t(x["q"]), x["q_card"], _t(x["cards"]),
            _t(x["gidx"]))


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w), (g, w)


def _np(out):
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_valid", [12, 7])
def test_score_ids_matches_jax_oracle(metric, n_valid):
    """The score stage alone, against the oracle's per-slot scores (the
    oracle's select over every slot, k = L, gives them back in order)."""
    x = _case(1, n_valid=n_valid)
    for exclude in (-1, int(x["gidx"][0]), int(x["gidx"][5]), 999):
        score, inter = tref.similarity_score_ids(
            *_t_args(x), n_valid, exclude, metric=metric)
        jrows = jnp.asarray(x["rows"])
        per = jref.popcount_words(jrows & jnp.asarray(x["q"])[
            jnp.asarray(x["row_col"] if x["row_col"].size else [0])])
        seg = np.searchsorted(x["starts"][1:], np.arange(per.shape[0]),
                              side="right")
        inter_j = np.zeros(len(x["cards"]), np.int64)
        if x["row_col"].size:
            np.add.at(inter_j, seg, np.asarray(per, np.int64))
        want = np.asarray(jref.similarity_scores(
            jnp.asarray(inter_j.astype(np.int32)), jnp.int32(x["q_card"]),
            jnp.asarray(x["cards"]), metric))
        want = np.where(x["gidx"] == exclude, np.float32(-1.0), want)
        want = np.where(np.arange(want.size) >= n_valid, np.float32(-2.0),
                        want)
        _same((score.numpy(), inter.numpy()),
              (want.astype(np.float32), inter_j.astype(np.int32)))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_valid", [12, 5, 1])
@pytest.mark.parametrize("k", [1, 3, 15])
def test_similarity_topk_ids_matches_jax(metric, n_valid, k):
    """The port's plain version and ``ops.similarity_topk_ids`` (backend
    None and "ref" on CPU tensors) against the JAX oracle and its Pallas
    kernel in interpret mode; k past the slot count and past n_valid
    included."""
    x = _case(2 + n_valid, n_valid=n_valid)
    for exclude in (-1, int(x["gidx"][n_valid - 1])):
        want = {}
        for be in ("ref", "pallas"):
            want[be] = jops.similarity_topk_ids(
                *_j_args(x), metric=metric, k=k, jmax=4, n_valid=n_valid,
                exclude=exclude, backend=be)
        _same(want["ref"], want["pallas"])
        got = tref.similarity_topk_ids(*_t_args(x), n_valid, exclude,
                                       metric=metric, k=k)
        _same(_np(got), want["ref"])
        for be in (None, "ref"):
            got = tops.similarity_topk_ids(
                *_t_args(x), metric=metric, k=k, n_valid=n_valid,
                exclude=exclude, backend=be)
            _same(_np(got), want["ref"])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [1, 4, 40])
def test_topk_merge_matches_jax(seed, k):
    """Gathered lists with repeated ids (pad entries, entries masked
    earlier), scores on a coarse grid so ties abound, and k past M."""
    rng = np.random.default_rng(40 + seed)
    m = 24
    score = (rng.integers(-2, 6, m) / 4).astype(np.float32)
    gidx = rng.integers(0, 10, m).astype(np.int32)
    inter = rng.integers(0, 50, m).astype(np.int32)
    want = {be: jops.topk_merge(jnp.asarray(score), jnp.asarray(inter),
                                jnp.asarray(gidx), k, backend=be)
            for be in ("ref", "pallas")}
    _same(want["ref"], want["pallas"])
    got = tref.topk_select_ids(_t(score), _t(inter), _t(gidx), k)
    _same(_np(got), want["ref"])
    got = tops.topk_merge(_t(score), _t(inter), _t(gidx), k)
    _same(_np(got), want["ref"])


def test_topk_merge_tie_rule():
    """Merged k-lists resolve equal scores to the lowest global index:
    the case of the JAX package's own tie-rule test."""
    score = np.array([.5, .9, .9, .1, .9, .5], np.float32)
    inter = np.array([5, 9, 9, 1, 9, 5], np.int32)
    gidx = np.array([40, 31, 7, 2, 19, 3], np.int32)
    for be in (None, "ref"):
        idx, sco, itr = tops.topk_merge(_t(score), _t(inter), _t(gidx), 4,
                                        backend=be)
        assert idx.tolist() == [7, 19, 31, 3]
        assert np.array_equal(sco.numpy(),
                              np.array([.9, .9, .9, .5], np.float32))
        assert itr.tolist() == [9, 9, 9, 5]


def _merge_both(score, inter, gidx, k):
    """The JAX oracle and Pallas (interpret) answers, required equal, and
    the port's plain version and ``ops.topk_merge`` held to them."""
    score = np.asarray(score, np.float32)
    inter = np.asarray(inter, np.int32)
    gidx = np.asarray(gidx, np.int32)
    want = {be: jops.topk_merge(jnp.asarray(score), jnp.asarray(inter),
                                jnp.asarray(gidx), k, backend=be)
            for be in ("ref", "pallas")}
    _same(want["ref"], want["pallas"])
    _same(_np(tref.topk_select_ids(_t(score), _t(inter), _t(gidx), k)),
          want["ref"])
    _same(_np(tops.topk_merge(_t(score), _t(inter), _t(gidx), k)),
          want["ref"])
    return tuple(np.asarray(w) for w in want["ref"])


def test_topk_merge_exhaustion_rounds():
    """Once every group above -2.0 is taken, each later round repeats the
    lowest id over every entry at or above -2.0, at -2.0, with the largest
    inter of that id's entries, taken ones included."""
    idx, sco, itr = _merge_both([.5, .9, -2, .9, -1, .5],
                                [5, 9, 77, 3, 1, 6], [40, 7, 2, 7, 9, 3], 8)
    assert idx.tolist() == [7, 3, 40, 9, 2, 2, 2, 2]
    assert itr.tolist() == [9, 6, 5, 1, 77, 77, 77, 77]
    assert np.array_equal(sco, np.array([.9, .5, .5, -1, -2, -2, -2, -2],
                                        np.float32))
    # the lowest id belongs to a group taken in the first round
    idx, sco, itr = _merge_both([.9, -2, .3, -2], [4, 50, 8, 60],
                                [1, 5, 3, 1], 5)
    assert idx.tolist() == [1, 3, 1, 1, 1]
    assert itr.tolist() == [4, 8, 60, 60, 60]
    assert sco.tolist() == [np.float32(.9), np.float32(.3), -2, -2, -2]


@pytest.mark.parametrize("case", ["all equal", "one id", "excluded",
                                  "all padding"])
def test_topk_merge_degenerate_lists(case):
    """Every entry equal (one group), one id on every entry (a group per
    score), -1.0 excluded entries among valid ones, and only -2.0
    padding; k past the entry count."""
    rng = np.random.default_rng(11)
    m = 12
    score = (rng.integers(0, 4, m) / 4).astype(np.float32)
    gidx = rng.integers(0, 6, m).astype(np.int32)
    inter = rng.integers(0, 30, m).astype(np.int32)
    if case == "all equal":
        score[:], gidx[:], inter[:] = 0.5, 3, 7
    elif case == "one id":
        gidx[:] = 4
    elif case == "excluded":
        score[::3] = -1.0
    else:
        score[:] = -2.0
    for k in (1, 5, m + 3):
        _merge_both(score, inter, gidx, k)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_topk_merge_past_the_kernel_chunk(k):
    """5,000 entries, past the 1,024 entries one block of the kernel sorts
    in shared memory: ties on a coarse score grid, repeated ids, -1.0 and
    -2.0 entries."""
    rng = np.random.default_rng(12 + k)
    m = 5000
    score = (rng.integers(-8, 40, m) / 32).astype(np.float32)
    score = np.where(score < -0.125, np.float32(-2.0),
                     np.where(score < 0, np.float32(-1.0), score))
    gidx = rng.integers(0, 3000, m).astype(np.int32)
    inter = rng.integers(0, 1000, m).astype(np.int32)
    score_j, inter_j, gidx_j = (jnp.asarray(score), jnp.asarray(inter),
                                jnp.asarray(gidx))
    want = jops.topk_merge(score_j, inter_j, gidx_j, k, backend="ref")
    if k <= 10:                  # Pallas interpret unrolls k rounds
        _same(jops.topk_merge(score_j, inter_j, gidx_j, k,
                              backend="pallas"), want)
    _same(_np(tref.topk_select_ids(_t(score), _t(inter), _t(gidx), k)),
          want)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    from repro_torch.kernels import topk_ops
    x = _case(9, n_valid=8)
    topk_ops.reset_launches()
    got = topk_ops.similarity_topk_ids(*_t_args(x), 8, int(x["gidx"][2]),
                                       metric="cosine", k=5)
    want = tref.similarity_topk_ids(*_t_args(x), 8, int(x["gidx"][2]),
                                    metric="cosine", k=5)
    _same(_np(got), _np(want))
    assert topk_ops.launches == 0
    assert set(topk_ops.launches_by_stage.values()) == {0}


def test_topk_merge_rejects_empty_and_k0():
    z = torch.zeros(0)
    with pytest.raises(ValueError):
        tops.topk_merge(z, z.int(), z.int(), 1)
    one = torch.zeros(1)
    with pytest.raises(ValueError):
        tops.topk_merge(one, one.int(), one.int(), 0)


def test_ids_route_does_not_fall_back_to_cpu():
    """The labelled wrappers raise for a tensor that is not on the CPU or
    a GPU, and a forced "cuda" backend raises on CPU tensors."""
    from repro_torch.kernels import topk_ops
    meta = dict(dtype=torch.int32, device="meta")
    rows = torch.zeros((2, WORDS), **meta)
    z = torch.zeros(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        topk_ops.similarity_score_ids(rows, z, z, z[:2], rows, 1, z[:1],
                                      z[:1], 1, metric="jaccard")
    with pytest.raises(ValueError, match="CUDA"):
        topk_ops.topk_merge(torch.zeros(4, device="meta"),
                            torch.zeros(4, **meta), torch.zeros(4, **meta),
                            2)
    x = _case(3)
    with pytest.raises(ValueError, match="cuda"):
        tops.similarity_topk_ids(*_t_args(x), metric="jaccard", k=2,
                                 n_valid=12, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tops.topk_merge(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32), 2,
                        backend="cuda")


# ---------------------------------------------------------------------------
# bit-sliced counters of the sharded threshold path
# ---------------------------------------------------------------------------

def _counter_case(seed, lens=(3, 0, 5, 1, 2), weighted=True):
    rng = np.random.default_rng(seed)
    n = sum(lens)
    slab = rng.integers(0, 1 << 32, (max(n, 1), WORDS), dtype=np.uint32)
    slab &= rng.integers(0, 1 << 32, slab.shape, dtype=np.uint32)
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    w = rng.integers(1, 6, max(n, 1)).astype(np.int32) if weighted else None
    return slab, starts, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lens", [(3, 0, 5, 1, 2), (0,), (7,)])
def test_segment_counters_match_jax(weighted, lens):
    slab, starts, w = _counter_case(5, lens, weighted)
    jmax = max(1, max(lens))
    planes = 6
    want = jref.segment_counters(
        jnp.asarray(slab), jnp.asarray(starts), jmax=jmax, planes=planes,
        weights=None if w is None else jnp.asarray(w))
    for be in (None, "ref"):
        got = tops.segment_counters(_t(slab), _t(starts), jmax=jmax,
                                    planes=planes,
                                    weights=None if w is None else _t(w),
                                    backend=be)
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want))


def test_segment_counters_chunked_passes_agree(monkeypatch):
    """Many segments in several passes give the one-pass counters."""
    slab, starts, w = _counter_case(6, tuple([2, 1, 0, 3] * 6))
    args = (_t(slab), _t(starts))
    kw = dict(jmax=3, planes=5, weights=_t(w))
    whole = tref.segment_counters(*args, **kw)
    monkeypatch.setattr(tref, "_COUNT_ELEMS", 3 * WORDS * 5)
    assert torch.equal(tref.segment_counters(*args, **kw), whole)


def test_bitsliced_add_and_counters_ge_match_jax():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 32, (4, 5, WORDS), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (4, 5, WORDS), dtype=np.uint32)
    want = np.asarray(jref.bitsliced_add(jnp.asarray(a), jnp.asarray(b)))
    got = tref.bitsliced_add(_t(a), _t(b))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for t in (0, 1, 7, 19, 31, 32, 40):
        want = np.asarray(jref.counters_ge(jnp.asarray(a), t))
        got = tref.counters_ge(_t(a), t)
        assert np.array_equal(got.numpy().view(np.uint32), want), t
    tv = np.array([1, 9, 17, 30], np.int32)
    want = np.asarray(jref.counters_ge(jnp.asarray(a), jnp.asarray(tv)))
    got = tref.counters_ge(_t(a), torch.from_numpy(tv))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_counters_add_to_the_threshold_of_the_whole():
    """Counters of two row halves, added bit-sliced and compared with T,
    give the single-segment threshold reduce of all the rows."""
    slab, starts, w = _counter_case(8, (6,))
    for t in (1, 4, 9, 30):
        want, _ = tref.segment_reduce(_t(slab), _t(starts), "threshold",
                                      jmax=6, threshold=t, weights=_t(w))
        halves = [tref.segment_counters(
            _t(slab[i::2]), torch.tensor([0, 3], dtype=torch.int32),
            jmax=3, planes=5, weights=_t(w[i::2])) for i in (0, 1)]
        got = tref.counters_ge(tref.bitsliced_add(*halves), t)
        assert torch.equal(got, want), t
