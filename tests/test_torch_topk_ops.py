"""The port's plain similarity top-k versions (``repro_torch.kernels.ref``:
the score stage, the select stage and the two in turn) against the JAX
package's jnp oracle and its Pallas kernel run in interpret mode, on the
same seeded numpy inputs.

Inputs: ragged candidates, empty ones among them, duplicate candidates
that tie exactly, every metric, ``exclude`` in {-1, 0, T-1, out of range},
k from 1 to T, a zero query cardinality and cardinalities near 2^31-1.
The tolerance is 0: indices and intersections must be equal and the
float32 scores bit-identical, since the top-k tie order rides on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pairwise import _scores_host as j_scores_host
from repro.kernels import ref as jref
from repro.kernels import topk_ops as jtopk
from repro_torch.core.pairwise import _scores_host as t_scores_host
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_ops as ttopk

WORDS = tref.WORDS
METRICS = tref.METRICS


def _case(seed, t=16, c=4, density=0.02, dup=True):
    """Ragged candidate rows (0..4 each, one key column each), a query
    block, cardinalities consistent with the rows; candidates 2..4 are
    copies of candidate 1 (exact score ties)."""
    rng = np.random.default_rng(seed)
    per = [[] for _ in range(t)]
    rows, row_col, starts, cards = [], [], [0], []
    for i in range(t):
        if dup and 2 <= i <= 4:
            src = per[1]
        else:
            src = []
            for _ in range(int(rng.integers(0, 5))):
                w = (rng.random(WORDS) < density).astype(np.uint32) \
                    * rng.integers(1, 1 << 32, WORDS, dtype=np.uint32)
                src.append((w, int(rng.integers(0, c))))
        per[i] = src
        for w, col in src:
            rows.append(w)
            row_col.append(col)
        starts.append(len(rows))
        cards.append(sum(int(np.bitwise_count(w).sum()) for w, _ in src))
    q = (rng.random((c, WORDS)) < density * 3).astype(np.uint32) \
        * rng.integers(1, 1 << 32, (c, WORDS), dtype=np.uint32)
    return dict(
        rows=np.stack(rows) if rows else np.zeros((1, WORDS), np.uint32),
        row_col=np.asarray(row_col if row_col else [0], np.int32),
        starts=np.asarray(starts, np.int32), q=q,
        q_card=int(np.bitwise_count(q).sum()),
        cards=np.asarray(cards, np.int32))


def _torch(x):
    return dict(rows=torch.from_numpy(x["rows"].view(np.int32)),
                row_col=torch.from_numpy(x["row_col"]),
                starts=torch.from_numpy(x["starts"]),
                q=torch.from_numpy(x["q"].view(np.int32)),
                cards=torch.from_numpy(x["cards"]))


def _jax(x):
    return (jnp.asarray(x["rows"]), jnp.asarray(x["row_col"]),
            jnp.asarray(x["starts"]), jnp.asarray(x["q"]))


def _same(got, want):
    """Exact equality of (idx, score, inter): score compared as bits."""
    gi, gs, gn = (np.asarray(a) for a in got)
    wi, ws, wn = (np.asarray(a) for a in want)
    assert np.array_equal(gi, wi), (gi, wi)
    assert np.array_equal(gs.view(np.int32), ws.view(np.int32)), (gs, ws)
    assert np.array_equal(gn, wn), (gn, wn)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("exclude", [-1, 0, 15, 99])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_plain_topk_matches_jax_oracle(metric, exclude, k):
    x = _case(1)
    tx = _torch(x)
    want = jref.similarity_topk(*_jax(x), jnp.int32(x["q_card"]),
                                jnp.asarray(x["cards"]), jnp.int32(exclude),
                                metric=metric, k=k)
    got = tref.similarity_topk(tx["rows"], tx["row_col"], tx["starts"],
                               tx["q"], x["q_card"], tx["cards"], exclude,
                               metric=metric, k=k)
    _same(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("exclude", [-1, 3])
def test_plain_topk_matches_pallas_interpret(metric, exclude):
    x = _case(2, t=12)
    tx = _torch(x)
    jmax = max(1, int(np.diff(x["starts"]).max()))
    want = jtopk.similarity_topk(*_jax(x), jnp.int32(x["q_card"]),
                                 jnp.asarray(x["cards"]),
                                 jnp.int32(exclude), metric=metric, k=6,
                                 jmax=jmax, interpret=True)
    got = tops.similarity_topk(tx["rows"], tx["row_col"], tx["starts"],
                               tx["q"], x["q_card"], tx["cards"],
                               metric=metric, k=6, exclude=exclude,
                               backend="ref")
    _same(got, want)


def test_ties_go_to_the_lowest_index():
    """Candidates 1..4 are copies: their scores tie exactly, and a k that
    cuts through the group keeps the lowest indices, in order."""
    x = _case(3)
    tx = _torch(x)
    score, inter = tref.similarity_score(
        tx["rows"], tx["row_col"], tx["starts"], tx["q"], x["q_card"],
        tx["cards"], metric="jaccard")
    assert len({float(s) for s in score[1:5]}) == 1
    for k in range(1, 17):
        idx, sc, _ = tref.topk_select(score, inter, k)
        order = np.argsort(-score.numpy(), kind="stable")[:k]
        assert idx.tolist() == order.tolist()


@pytest.mark.parametrize("metric", METRICS)
def test_empty_candidates_and_empty_query(metric):
    """Candidates without rows score from inter = 0; with q_card = 0 an
    empty candidate's zero denominator scores 1.0 (containment: all)."""
    x = _case(4)
    tx = _torch(x)
    zq = torch.zeros_like(tx["q"])
    score, inter = tref.similarity_score(
        tx["rows"], tx["row_col"], tx["starts"], zq, 0, tx["cards"],
        metric=metric)
    want = jref.similarity_scores(jnp.asarray(inter.numpy()), jnp.int32(0),
                                  jnp.asarray(x["cards"]), metric)
    assert np.array_equal(score.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    assert not inter.any()
    empty = np.diff(x["starts"]) == 0
    assert empty.any() and (score.numpy()[empty] == 1.0).all()


@pytest.mark.parametrize("metric", METRICS)
def test_scores_bit_identical_near_int32_max(metric):
    """Cardinalities near 2^31-1, where qc * oc and qc + oc round in
    float32: the port's plain and numpy versions give the JAX package's
    bits."""
    rng = np.random.default_rng(5)
    cards = rng.integers(2**31 - 2**24, 2**31, 512).astype(np.int32)
    cards[:4] = [2**31 - 1, 0, 1, 4097]
    inter = (cards.astype(np.int64) * rng.random(512)).astype(np.int32)
    for q_card in (2**31 - 1, 2**31 - 3, 4097, 0):
        want = np.asarray(jref.similarity_scores(
            jnp.asarray(inter), jnp.int32(q_card), jnp.asarray(cards),
            metric))
        got = tref.similarity_scores(torch.from_numpy(inter), q_card,
                                     torch.from_numpy(cards), metric)
        host = t_scores_host(inter, q_card, cards, metric)
        for other in (got.numpy(), host,
                      j_scores_host(inter, q_card, cards, metric)):
            assert np.array_equal(other.view(np.int32),
                                  want.view(np.int32)), q_card


@pytest.mark.parametrize("k", [1, 10, 100, 512])
def test_select_matches_jax_with_many_ties(k):
    rng = np.random.default_rng(6)
    score = (rng.integers(0, 5, 512) / 4).astype(np.float32)
    score[7] = -1.0                              # an excluded candidate
    inter = rng.integers(0, 1000, 512).astype(np.int32)
    want = jref.topk_select(jnp.asarray(score), jnp.asarray(inter), k)
    got = tref.topk_select(torch.from_numpy(score), torch.from_numpy(inter),
                           k)
    _same(got, want)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    x = _case(7)
    tx = _torch(x)
    ttopk.reset_launches()
    got = ttopk.similarity_topk(tx["rows"], tx["row_col"], tx["starts"],
                                tx["q"], x["q_card"], tx["cards"], 2,
                                metric="cosine", k=5)
    want = tref.similarity_topk(tx["rows"], tx["row_col"], tx["starts"],
                                tx["q"], x["q_card"], tx["cards"], 2,
                                metric="cosine", k=5)
    _same(got, want)
    assert ttopk.launches == 0
    assert ttopk.launches_by_stage == {"score": 0, "select": 0}


def test_bad_arguments_raise():
    x = _case(8)
    tx = _torch(x)
    args = (tx["rows"], tx["row_col"], tx["starts"], tx["q"], x["q_card"],
            tx["cards"])
    with pytest.raises(ValueError, match="metric"):
        ttopk.similarity_score(*args, metric="dice")
    score, inter = ttopk.similarity_score(*args, metric="jaccard")
    for k in (0, 17):
        with pytest.raises(ValueError, match="k="):
            ttopk.topk_select(score, inter, k)
    with pytest.raises(ValueError, match="cuda"):
        tops.similarity_topk(*args, metric="jaccard", k=3, backend="cuda")
