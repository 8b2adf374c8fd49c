"""The port's plain segment_reduce versions (``repro_torch.kernels.ref``)
against the JAX package's jnp oracle and its Pallas kernel run in interpret
mode, on the same seeded numpy inputs.

op in {or, and, xor, andnot, threshold} x {scalar T, per-segment T,
weights}, over the three row sources (slab, ids, dual).  Inputs include
empty segments, jmax=1, segment lengths that are not powers of two, T
exactly attained and T above every count.  The tolerance is exact: words
must be bit-identical and cards equal (integer work).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import segment_ops as jseg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_ops as tseg

WORDS = tref.WORDS

LENS = {
    "ragged": [3, 0, 5, 1, 0, 7, 2],          # empty + non-pow2 segments
    "jmax1": [1, 1, 1, 1, 1],
    "one_long": [6],
}
CASES = [("or", None), ("and", None), ("xor", None), ("andnot", None),
         ("threshold", "scalar"), ("threshold", "per_segment"),
         ("threshold", "weights")]


def _inputs(seed, lens, n_table=40, n_staged=6):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, (n_table, WORDS), dtype=np.uint32)
    table[0] = 0
    table[3] = table[4] = table[5]            # pin exact threshold ties
    staged = rng.integers(0, 1 << 32, (n_staged, WORDS), dtype=np.uint32)
    staged[0] = 0
    n = int(sum(lens))
    ids = rng.integers(1, n_table, n).astype(np.int32)
    ids[: min(n, 3)] = [3, 4, 5][: min(n, 3)]
    cold = rng.random(n) < 0.3
    pos = np.where(cold, 0, ids).astype(np.int32)
    sidx = np.where(cold, rng.integers(1, n_staged, n), 0).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    weights = rng.integers(1, 5, n).astype(np.int32)
    return dict(table=table, staged=staged, ids=ids, pos=pos, sidx=sidx,
                starts=starts, weights=weights)


def _threshold(x, lens, tmode):
    """T per case: scalar 2; per segment, T = the attainable max on some
    segments (exact tie), above every count on others, mid elsewhere."""
    lens = np.asarray(lens)
    if tmode == "scalar":
        return 2
    w = x["weights"] if tmode == "weights" else np.ones_like(x["weights"])
    tot = np.add.reduceat(w, x["starts"][:-1]) if w.size else \
        np.zeros(lens.size, np.int64)
    tot = np.where(lens > 0, tot, 0)
    t = np.maximum(1, tot // 2)
    t[::3] = np.maximum(1, tot[::3])            # exactly attainable
    t[1::3] = tot[1::3] + 1                     # above every count
    return t.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _check(words_t, cards_t, words_j, cards_j):
    assert np.array_equal(words_t.numpy().view(np.uint32),
                          np.asarray(words_j))
    assert np.array_equal(cards_t.numpy(), np.asarray(cards_j))


@pytest.mark.parametrize("shape", sorted(LENS))
@pytest.mark.parametrize("op,tmode", CASES)
def test_slab_matches_jax(shape, op, tmode):
    lens = LENS[shape]
    x = _inputs(7, lens)
    jmax = max(1, max(lens))
    slab = x["table"][x["ids"]]
    t = _threshold(x, lens, tmode) if op == "threshold" else 0
    w = x["weights"] if tmode == "weights" else None
    tw, tc = tref.segment_reduce(
        _t(slab), _t(x["starts"]), op, jmax=jmax,
        threshold=t if np.isscalar(t) else _t(t),
        weights=None if w is None else _t(w))
    jw, jc = jref.segment_reduce(
        jnp.asarray(slab), jnp.asarray(x["starts"]), op, jmax=jmax,
        threshold=t if np.isscalar(t) else jnp.asarray(t),
        weights=None if w is None else jnp.asarray(w))
    _check(tw, tc, jw, jc)
    empty = np.asarray(lens) == 0
    assert not tw.numpy()[empty].any() and not tc.numpy()[empty].any()


@pytest.mark.parametrize("shape", ["ragged", "jmax1"])
@pytest.mark.parametrize("op,tmode", CASES)
def test_slab_matches_pallas_interpret(shape, op, tmode):
    lens = LENS[shape]
    x = _inputs(11, lens)
    jmax = max(1, max(lens))
    slab = x["table"][x["ids"]]
    t = _threshold(x, lens, tmode) if op == "threshold" else 0
    w = x["weights"] if tmode == "weights" else None
    planes = wbits = None
    if op == "threshold":
        tot = int(np.max(t)) if not np.isscalar(t) else t
        bound = jmax * (4 if w is not None else 1)
        planes = max(tseg.counter_planes(bound), int(tot).bit_length())
        wbits = 3 if w is not None else 1
    tw, tc = tref.segment_reduce(
        _t(slab), _t(x["starts"]), op, jmax=jmax,
        threshold=t if np.isscalar(t) else _t(t),
        weights=None if w is None else _t(w))
    kw = {} if planes is None else dict(planes=planes, wbits=wbits)
    jw, jc = jseg.segment_reduce(
        jnp.asarray(slab), jnp.asarray(x["starts"]), op, jmax=jmax,
        threshold=t if np.isscalar(t) else jnp.asarray(t),
        weights=None if w is None else jnp.asarray(w), interpret=True, **kw)
    _check(tw, tc, jw, jc)


@pytest.mark.parametrize("source", ["ids", "dual"])
@pytest.mark.parametrize("op,tmode", CASES)
def test_row_sources_match_jax(source, op, tmode):
    lens = LENS["ragged"]
    x = _inputs(13, lens)
    t = _threshold(x, lens, tmode) if op == "threshold" else 0
    w = x["weights"] if tmode == "weights" else None
    kw_t = dict(jmax=7, threshold=t if np.isscalar(t) else _t(t),
                weights=None if w is None else _t(w))
    kw_j = dict(jmax=7, threshold=t if np.isscalar(t) else jnp.asarray(t),
                weights=None if w is None else jnp.asarray(w))
    if source == "ids":
        tw, tc = tref.segment_reduce_rows(_t(x["table"]), _t(x["ids"]),
                                          _t(x["starts"]), op, **kw_t)
        jw, jc = jref.segment_reduce_rows(
            jnp.asarray(x["table"]), jnp.asarray(x["ids"]),
            jnp.asarray(x["starts"]), op, **kw_j)
    else:
        tw, tc = tref.segment_reduce_rows_dual(
            _t(x["table"]), _t(x["staged"]), _t(x["pos"]), _t(x["sidx"]),
            _t(x["starts"]), op, **kw_t)
        jw, jc = jref.segment_reduce_rows_dual(
            jnp.asarray(x["table"]), jnp.asarray(x["staged"]),
            jnp.asarray(x["pos"]), jnp.asarray(x["sidx"]),
            jnp.asarray(x["starts"]), op, **kw_j)
    _check(tw, tc, jw, jc)


@pytest.mark.parametrize("op", tseg.OPS)
def test_all_empty_segments_without_rows(op):
    """No rows at all: every segment reduces to zero words and card 0."""
    slab = torch.zeros((0, WORDS), dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int32)
    words, cards = tref.segment_reduce(slab, starts, op, jmax=1,
                                       threshold=1)
    assert words.shape == (3, WORDS) and not words.any()
    assert cards.tolist() == [0, 0, 0]


def test_gather_rows_dual_matches_jax():
    x = _inputs(17, LENS["ragged"])
    got = tref.gather_rows_dual(_t(x["table"]), _t(x["staged"]),
                                _t(x["pos"]), _t(x["sidx"]))
    want = jref.gather_rows_dual(
        jnp.asarray(x["table"]), jnp.asarray(x["staged"]),
        jnp.asarray(x["pos"]), jnp.asarray(x["sidx"]))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_popcount_words_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 32, (5, WORDS), dtype=np.uint32)
    w[0] = 0xFFFFFFFF
    w[1] = 0
    assert np.array_equal(tref.popcount_words(_t(w)).numpy(),
                          np.asarray(jref.popcount_words(jnp.asarray(w))))


@pytest.mark.parametrize("backend", [None, "ref"])
def test_wrappers_take_plain_version_on_cpu(backend):
    """On a CPU tensor every wrapper (and every backend but "cuda") is the
    plain version, and no kernel launch is counted."""
    lens = LENS["ragged"]
    x = _inputs(19, lens)
    n0 = tseg.launches
    slab = _t(x["table"][x["ids"]])
    want = tref.segment_reduce(slab, _t(x["starts"]), "xor", jmax=7)
    for fn in (tseg.segment_reduce,
               lambda *a, **k: tops.segment_reduce(*a, backend=backend,
                                                   **k)):
        got = fn(slab, _t(x["starts"]), "xor", jmax=7)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = tops.segment_reduce_rows(_t(x["table"]), _t(x["ids"]),
                                   _t(x["starts"]), "xor", jmax=7,
                                   backend=backend)
    assert torch.equal(got[0], want[0])
    got = tops.segment_reduce_rows_dual(
        _t(x["table"]), _t(x["staged"]), _t(x["pos"]), _t(x["sidx"]),
        _t(x["starts"]), "or", jmax=7, backend=backend)
    assert torch.equal(got[1], tref.segment_reduce_rows_dual(
        _t(x["table"]), _t(x["staged"]), _t(x["pos"]), _t(x["sidx"]),
        _t(x["starts"]), "or", jmax=7)[1])
    assert tseg.launches == n0


def test_forced_cuda_backend_raises_on_cpu_tensor():
    x = _inputs(23, LENS["jmax1"])
    with pytest.raises(ValueError, match="cuda"):
        tops.segment_reduce(_t(x["table"][x["ids"]]), _t(x["starts"]), "or",
                            jmax=1, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tops.segment_reduce(_t(x["table"][x["ids"]]), _t(x["starts"]), "or",
                            jmax=1, backend="pallas")


def test_counter_planes_matches_jax():
    for j in (1, 2, 3, 7, 8, 255, 256):
        assert tseg.counter_planes(j) == jseg.counter_planes(j)
    assert tseg.OPS == jseg.OPS
