"""The CUDA kernels against their plain PyTorch versions, on the card.

segment_reduce: every row source (slab, ids, dual) x op, with empty
segments, one-row segments, per-segment T, weights and T above every
count; words bit-identical and cards equal (integer work).  The similarity
score and select kernels: every metric, exclusion, ragged and empty
candidates, duplicates that tie, a zero query cardinality and cards near
2^31-1; indices and intersections equal and float32 scores bit-identical
(tolerance 0).  Then ``similar`` and the ``QueryServer`` on the card
against the CPU's answers, and a trapping score launch that the server
resolves as an error instead of serving it from the host.  The pair
kernels (bitset pair op and count, array x bitset probe, array pair masks
and count) against their plain versions at the edge cases (M = 0 and 1,
cards 0, 1 and 4,096, identical and disjoint arrays, the values 0 and
65535, mixed op ids with -1 and 7, all-zero and all-ones words), each with
one off-contract input that must not fault, and ``merge_one`` /
``pairwise_card`` with ``backend="cuda"`` against ``backend="ref"``.  The
conversion kernels (array_to_bitset, bitset_set_many) and the popcount
against their plain versions, off-contract values, cards and duplicates
included, bit-equal.  The section-4 kernels (the fused bitset op and
count for every op, the A-side array intersection, and the difference on
top of it) against their plain versions at the edge cases (M = 0 and 1;
cards 0, 1, 4,096, above 4,096 and negative; one side empty; an A value of
65537 beside B's padding) and at M = 8,192, with ``ops`` routing to them
by default on CUDA tensors.  And a ``RoaringTensor`` built with the default
device, which lands on the card and launches array_to_bitset, the pair
kernels and segment_reduce, against the same tensor on the CPU.  The
sharded similarity kernels (the score over ids and the labelled select)
against their plain versions, pad slots, exclusion and k past the entry
count included, a bad position trapping; and ``similar(mesh=)`` and the
sharded aggregates over shards on the card against the CPU's answers.
The labelled select past the 1,024 entries one block sorts (levels of
chunks, one block in device memory), its exhaustion rounds and -0.0
beside +0.0.  The single-device select's rounds past every entry above
-2.0, scores all below -2.0, signed zeros and sorted inputs past one tile
of its rank by counting; the count-only array kernel at row counts around
its four rows a block and on mixed cards.
The Roaring block-sparse decode attention kernel against its plain version
(float32 within 2e-5, bfloat16 within one bf16 ulp, rows with nothing
visible exactly 0) at the live Gemma2 head shape and edge cases, ``ops``
routing to it, its wrapper refusing bad inputs (misaligned k or v rows
among them), the split count forced to 1, 2, 3 and the block count with
the kernel's partials against the plain split step, and Jamba's decode
shape (g = 4 query heads a KV head, D = 128, softcap 0); a decode step of
the reduced gemma2 model with the kernel against ``backend="ref"``, and
the serving engine on the card against the CPU's tokens.  The Mamba
layer's chunked selective scan on the card against the per-token float32
recurrence.  DeepSeek-V2's MLA at full width: the absorbed attention (both
of the JAX package's bf16 flavours) against keys and values decompressed
in float32 from the same caches; the ``sparse_topk_blocks`` gather route
against the decode attention kernel at Gemma2-27B's decode shape with
every block gathered; and xLSTM's chunkwise-parallel mLSTM against its
per-token recurrence at full width.  One train step of the reduced
qwen2.5-3b model (float32 masters, remat on), rerun bit-equal; two steps'
losses against the CPU's; the same for the other families' reduced models
(Mixtral, DeepSeek-V2, a two-layer Jamba pattern, xLSTM with either mLSTM
form, HuBERT on an audio batch); and AdamW's update on the card from the
CPU's inputs within 2 ulps of the CPU's.  The device mesh: Qwen2.5-3B at
full width and 2 layers, every leaf a DTensor on the (1, 1) mesh of an
NCCL group of one, two steps bit-equal to the plain steps; and arena
shards on (card, CPU), the sharded aggregates and ``similar(mesh=)``
against the CPU's answers.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither JAX nor ``repro``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    array_ops, bitset_convert, bitset_ops, harley_seal, ops, pair_ops, ref,
    segment_ops, topk_ops,
)
from repro_torch.kernels.ref import ARRAY_CAP, METRICS, WORDS

pytestmark = pytest.mark.cuda

SOURCES = ("slab", "ids", "dual")
CASES = [("or", None, False), ("and", None, False), ("xor", None, False),
         ("andnot", None, False), ("threshold", "scalar", False),
         ("threshold", "per_segment", False),
         ("threshold", "per_segment", True)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, lens, n_table=64, n_staged=8):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, (n_table, WORDS), dtype=np.uint32)
    table[0] = 0                                  # reserved zero row
    table[5] = table[6] = table[7]                # exact count ties
    staged = rng.integers(0, 1 << 32, (n_staged, WORDS), dtype=np.uint32)
    staged[0] = 0
    n = int(sum(lens))
    ids = rng.integers(1, n_table, n).astype(np.int32)
    cold = rng.random(n) < 0.3
    pos = np.where(cold, 0, ids).astype(np.int32)
    sidx = np.where(cold, rng.integers(1, n_staged, n), 0).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    weights = rng.integers(1, 5, n).astype(np.int32)
    return table, staged, ids, pos, sidx, starts, weights


def _call(fn_src, dev, arrays, op, tmode, weighted, jmax):
    table, staged, ids, pos, sidx, starts, weights = arrays
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    s = starts.shape[0] - 1
    kw = dict(jmax=jmax)
    planes = None
    if op == "threshold":
        lens = np.diff(starts)
        if tmode == "scalar":
            kw["threshold"] = 2
        else:
            tv = np.maximum(1, (lens * (3 if weighted else 1)) // 2)
            tv[::3] = lens[::3] * (4 if weighted else 1) + 1   # unreachable
            kw["threshold"] = t(tv.astype(np.int32))
        tmax = int(np.max(np.asarray(kw["threshold"].cpu()
                                     if tmode != "scalar" else 2)))
        total = int(lens.max()) * (4 if weighted else 1)
        planes = max(1, total.bit_length(), tmax.bit_length())
        if weighted:
            kw["weights"] = t(weights)
    assert s >= 1
    if fn_src == "slab":
        slab = table[ids]
        args = (t(slab), t(starts))
        plain, kern = ref.segment_reduce, segment_ops.segment_reduce
    elif fn_src == "ids":
        args = (t(table), t(ids), t(starts))
        plain, kern = ref.segment_reduce_rows, segment_ops.segment_reduce_rows
    else:
        args = (t(table), t(staged), t(pos), t(sidx), t(starts))
        plain = ref.segment_reduce_rows_dual
        kern = segment_ops.segment_reduce_rows_dual
    want_w, want_c = plain(*args, op, **kw)
    n0 = segment_ops.launches
    got_w, got_c = kern(*args, op, planes=planes,
                        wbits=3 if weighted else 1, **kw)
    torch.cuda.synchronize()
    assert segment_ops.launches == n0 + 1
    return want_w, want_c, got_w, got_c


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("op,tmode,weighted", CASES)
@pytest.mark.parametrize("lens", [[3, 0, 5, 1, 0, 7, 2, 9, 4],
                                  [1, 1, 1, 1], [0, 0]])
def test_kernel_matches_plain(cuda, src, op, tmode, weighted, lens):
    jmax = max(1, max(lens))
    got = _call(src, cuda, _inputs(len(lens), lens), op, tmode, weighted,
                jmax)
    want_w, want_c, got_w, got_c = got
    assert torch.equal(got_w, want_w)
    assert torch.equal(got_c, want_c)
    empty = torch.tensor([x == 0 for x in lens], device=cuda)
    assert not got_w[empty].any() and not got_c[empty].any()


def test_kernel_raises_on_bad_input(cuda):
    slab = torch.zeros((4, WORDS), dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segment_ops.segment_reduce(slab.to(torch.int64), starts, "or",
                                   jmax=4)
    with pytest.raises(ValueError):
        segment_ops.segment_reduce(slab, starts.cpu(), "or", jmax=4)
    with pytest.raises(ValueError):
        segment_ops.segment_reduce(slab[:, ::2], starts, "or", jmax=4)


@pytest.mark.parametrize("bad", ["ids", "sidx", "starts"])
def test_out_of_range_index_faults(cuda, bad):
    """An out-of-range row index or segment offset traps in the kernel and
    raises at the next synchronisation instead of reading past the table.
    It runs in a child process: a trap leaves the CUDA context unusable."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = f"""
import torch
from repro_torch.kernels import segment_ops as so
dev = torch.device("cuda")
table = torch.zeros((8, 2048), dtype=torch.int32, device=dev)
staged = torch.zeros((2, 2048), dtype=torch.int32, device=dev)
pos = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
sidx = torch.tensor([0, 0, 1], dtype=torch.int32, device=dev)
starts = torch.tensor([0, 3], dtype=torch.int32, device=dev)
bad = {bad!r}
if bad == "ids":
    pos[1] = 8
elif bad == "sidx":
    sidx[2] = 2
else:
    starts[1] = 4
so.segment_reduce_rows_dual(table, staged, pos, sidx, starts, "or", jmax=3)
torch.cuda.synchronize()
print("NO FAULT")
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0, proc.stdout
    assert "NO FAULT" not in proc.stdout


@pytest.mark.parametrize("t", [1, 5, 14])
def test_default_planes_cover_weights_and_int_t(cuda, t):
    """Without ``planes`` the counter is wide enough for jmax rows of
    weight < 2^wbits and for an int T, so the kernel still equals the plain
    version (14 > 3 * 4 is above every count)."""
    x = _inputs(5, [3, 1, 0, 2])
    table, _, ids, _, _, starts, weights = x
    tt = lambda a: torch.from_numpy(a.view(np.int32)).to(cuda)  # noqa: E731
    args = (tt(table[ids]), tt(starts), "threshold")
    kw = dict(jmax=3, threshold=t, weights=tt(weights))
    want = ref.segment_reduce(*args, **kw)
    got = segment_ops.segment_reduce(*args, wbits=3, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# similarity top-k: score and select
# ---------------------------------------------------------------------------

def _topk_inputs(seed, lens, c=6, case="ragged"):
    """Ragged candidate rows over ``c`` key columns; candidates 1..3 are
    copies of candidate 0 (exact ties).  ``case`` "qcard0" zeroes the
    query, "bigcards" sets cards and q_card near 2^31-1."""
    rng = np.random.default_rng(seed)
    lens = list(lens)
    lens[1:4] = [lens[0]] * 3
    n = int(sum(lens))
    rows = ((rng.random((n, WORDS)) < 0.1).astype(np.uint32)
            * rng.integers(1, 1 << 32, (n, WORDS), dtype=np.uint32))
    row_col = rng.integers(0, c, n).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    for t in (1, 2, 3):
        rows[starts[t]:starts[t + 1]] = rows[:lens[0]]
        row_col[starts[t]:starts[t + 1]] = row_col[:lens[0]]
    q = ((rng.random((c, WORDS)) < 0.3).astype(np.uint32)
         * rng.integers(1, 1 << 32, (c, WORDS), dtype=np.uint32))
    cards = np.add.reduceat(np.bitwise_count(rows).sum(axis=1),
                            starts[:-1]) if n else np.zeros(0)
    cards = np.where(np.diff(starts) > 0, cards, 0).astype(np.int32)
    q_card = int(np.bitwise_count(q).sum())
    if case == "qcard0":
        q[:] = 0
        q_card = 0
    elif case == "bigcards":
        cards = rng.integers(2**31 - 2**20, 2**31, len(lens)).astype(
            np.int32)
        q_card = 2**31 - 1
    if n == 0:
        rows, row_col = np.zeros((1, WORDS), np.uint32), np.zeros(1,
                                                                  np.int32)
    return rows, row_col, starts, q, q_card, cards


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else a.dtype)).to(dev)


LENS = [3, 0, 0, 0, 0, 6, 2, 0, 5, 1, 4, 6, 2, 3]   # 1..3 copy 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("exclude", [-1, 0, len(LENS) - 1])
@pytest.mark.parametrize("case", ["ragged", "qcard0", "bigcards"])
def test_score_kernel_matches_plain(cuda, metric, exclude, case):
    rows, row_col, starts, q, q_card, cards = _topk_inputs(3, LENS,
                                                           case=case)
    args = [_dev(a, cuda) for a in (rows, row_col, starts, q)]
    cards_t = _dev(cards, cuda)
    want = ref.similarity_score(*args, q_card, cards_t, exclude,
                                metric=metric)
    n0 = topk_ops.launches_by_stage["score"]
    got = topk_ops.similarity_score(*args, q_card, cards_t, exclude,
                                    metric=metric)
    torch.cuda.synchronize()
    assert topk_ops.launches_by_stage["score"] == n0 + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("n", [13, 1024, 5000])
@pytest.mark.parametrize("kfrac", [0.0, 0.01, 0.1, 1.0])
def test_select_kernel_matches_plain_and_sort(cuda, n, kfrac):
    rng = np.random.default_rng(n)
    score = (rng.integers(0, 6, n) / 5).astype(np.float32)   # many ties
    score[n // 2] = -1.0
    inter = rng.integers(0, 1 << 20, n).astype(np.int32)
    k = max(1, int(n * kfrac))
    s, i = _dev(score, cuda), _dev(inter, cuda)
    want = ref.topk_select(s, i, k)
    n0 = topk_ops.launches_by_stage["select"]
    got = topk_ops.topk_select(s, i, k)
    torch.cuda.synchronize()
    assert topk_ops.launches_by_stage["select"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    order = torch.sort(s, descending=True, stable=True).indices[:k]
    assert torch.equal(got[0].long(), order)


SELECT_EDGES = {
    "repeat after -3.0": ([0.5, -3.0, 0.25], 3),
    "repeat after -2.0": ([0.5, -2.0, 0.1], 3),
    "all below -2.0": ([-3.0, -5.0, -2.5, -7.0], 4),
    "all below -2.0, k=1": ([-3.0, -5.0, -2.5, -7.0], 1),
    "-2.0 and below": ([-3.0, -2.0, -5.0, -2.0], 4),
    "signed zeros": ([0.0, -0.0, 0.0, 0.5, -0.0], 5),
}


@pytest.mark.parametrize("case", sorted(SELECT_EDGES) + ["a third low"])
def test_select_kernel_off_contract_rounds(cuda, case):
    """The rounds after every entry above -2.0 is taken (the lowest index
    at or above -2.0, at -2.0), every score below -2.0 (the argmax, then
    it again at -2.0), -0.0 beside +0.0 (own bits, lower index first), and
    3,000 entries of which a third lie at or below -2.0 at k = 10 and k =
    T: bit-equal to the plain version, one launch a call."""
    if case == "a third low":
        rng = np.random.default_rng(21)
        score = (rng.integers(-8, 16, 3000) / 8).astype(np.float32)
        score = np.where(score < -0.5, np.float32(-2.5),
                         np.where(score < 0, np.float32(-2.0), score))
        ks = (10, 3000)
    else:
        score, k = SELECT_EDGES[case]
        score, ks = np.asarray(score, np.float32), (k,)
    inter = np.arange(10, 10 + score.size, dtype=np.int32)
    s, i = _dev(score, cuda), _dev(inter, cuda)
    for k in ks:
        want = ref.topk_select(s, i, k)
        n0 = topk_ops.launches_by_stage["select"]
        got = topk_ops.topk_select(s, i, k)
        torch.cuda.synchronize()
        assert topk_ops.launches_by_stage["select"] == n0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("k", [1, 10, 4999])
def test_select_kernel_sorted_inputs_across_tiles(cuda, order, k):
    """5,000 distinct scores sorted either way: the rank select stages its
    keys a tile at a time, starting at its own, and stops once k keys sort
    before its entry; the answer must not depend on where that happens."""
    score = np.linspace(-1.0, 1.0, 5000, dtype=np.float32)
    if order == "descending":
        score = score[::-1].copy()
    inter = np.arange(5000, dtype=np.int32)
    s, i = _dev(score, cuda), _dev(inter, cuda)
    want = ref.topk_select(s, i, k)
    got = topk_ops.topk_select(s, i, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("bad", ["row_col", "starts"])
def test_topk_out_of_range_index_faults(cuda, bad):
    """A key column or candidate offset out of range traps in the score
    kernel instead of reading past the query block or the rows (child
    process: a trap leaves the CUDA context unusable)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = f"""
import torch
from repro_torch.kernels import topk_ops
dev = torch.device("cuda")
rows = torch.zeros((4, 2048), dtype=torch.int32, device=dev)
q = torch.zeros((2, 2048), dtype=torch.int32, device=dev)
col = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
starts = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
cards = torch.zeros(2, dtype=torch.int32, device=dev)
if {bad!r} == "row_col":
    col[2] = 2
else:
    starts[2] = 5
topk_ops.similarity_score(rows, col, starts, q, 0, cards, metric="jaccard")
torch.cuda.synchronize()
print("NO FAULT")
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0, proc.stdout
    assert "NO FAULT" not in proc.stdout


def _index_pair(cuda, arena):
    from repro_torch.core import BitmapArena, RoaringBitmap
    from repro_torch.data.index import InvertedIndex
    rng = np.random.default_rng(21)
    post = {}
    for i in range(24):
        size = int(300_000 / (i + 1) ** 1.3) + 10
        post[f"t{i}"] = np.unique(rng.integers(0, 1 << 19, size,
                                               dtype=np.uint32))
    post["dup"] = post["t2"].copy()
    mk = lambda: {t: RoaringBitmap.from_values(v)  # noqa: E731
                  for t, v in post.items()}
    host = InvertedIndex.from_postings(mk(), 1 << 19, device="cpu")
    card = InvertedIndex.from_postings(
        mk(), 1 << 19, arena=BitmapArena(device=cuda) if arena else None,
        device=None if arena else cuda)
    return host, card


@pytest.mark.parametrize("arena", [False, True])
def test_similar_on_the_card_matches_the_host_route(cuda, arena):
    host, card = _index_pair(cuda, arena)
    topk_ops.reset_launches()
    n = 0
    for metric in METRICS:
        for term in ("t0", "t2", "dup", "t23", "nope"):
            for k in (1, 5, 30):
                got = card.similar(term, k, metric)
                want = host.similar(term, k, metric)
                assert [t for t, _ in got] == [t for t, _ in want]
                assert np.float32([s for _, s in got]).tobytes() == \
                    np.float32([s for _, s in want]).tobytes()
                n += 1
    assert topk_ops.launches_by_stage == {"score": n, "select": n,
                                          "score_ids": 0, "select_ids": 0}


@pytest.mark.parametrize("arena", [False, True])
def test_server_on_the_card_uses_only_kernels(cuda, arena):
    """A fault-free mixed run on the card: every ticket equals the host
    index's single-query answer, both kernels launched, and the recovery
    ladder never fired (no retry, no host fallback, nothing degraded)."""
    from repro_torch.serve import OK, Query, QueryServer
    host, card = _index_pair(cuda, arena)
    rng = np.random.default_rng(5)
    terms = list(host.postings)
    qs = []
    for i in range(60):
        ts = [terms[j] for j in rng.choice(len(terms), 3, replace=False)]
        qs.append([Query.and_(*ts), Query.or_(*ts), Query.xor_(*ts),
                   Query.andnot(*ts), Query.threshold(ts, 2),
                   Query.similar(ts[0], k=1 + i % 7,
                                 metric=METRICS[i % 3])][i % 6])
    segment_ops.reset_launches()
    topk_ops.reset_launches()
    srv = QueryServer(card, max_batch=16)
    tickets = [srv.submit(q) for q in qs]
    srv.run_until_idle()
    st = srv.stats()
    assert st.host_fallbacks == 0 and st.dispatch_retries == 0
    assert segment_ops.launches > 0 and topk_ops.launches > 0
    for t, q in zip(tickets, qs):
        assert t.result.status == OK and not t.telemetry.degraded
        if q.kind == "similar":
            want = host.similar(q.terms[0], q.k, q.metric)
            assert t.result.value == want
        else:
            want = {"and": host.query_and, "or": host.query_or,
                    "xor": host.query_xor}.get(q.kind)
            want = (want(*q.terms) if want else
                    host.query_andnot(q.terms[0], *q.terms[1:])
                    if q.kind == "andnot" else
                    host.query_threshold(list(q.terms), q.t))
            assert np.array_equal(t.result.value.to_array(),
                                  want.to_array())


def test_server_does_not_serve_a_trapping_kernel_from_the_host(cuda):
    """A score launch that traps (a key column corrupted out of range on
    the device) resolves the server's similarity ticket ``ERROR``: no
    retry, no host fallback, nothing degraded (child process: a trap
    leaves the CUDA context unusable)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = """
import json, os, sys
import numpy as np
from repro_torch.core import RoaringBitmap
from repro_torch.data.index import InvertedIndex
from repro_torch.serve import Query, QueryServer
rng = np.random.default_rng(3)
post = {f"t{i}": RoaringBitmap.from_values(np.unique(rng.integers(
    0, 1 << 18, 5000, dtype=np.uint32))) for i in range(8)}
ix = InvertedIndex.from_postings(post, 1 << 18)
eng = ix._sim_engine()[1]
eng._device()[1][0] = 1 << 20            # key column past the query block
srv = QueryServer(ix)
t = srv.submit(Query.similar("t1", k=3))
srv.run_until_idle()
st = srv.stats()
print(json.dumps(dict(status=t.result.status, error=t.result.error,
                      degraded=t.telemetry.degraded,
                      retries=st.dispatch_retries,
                      fallbacks=st.host_fallbacks)), flush=True)
os._exit(0)
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == "error" and out["error"], out
    assert not out["degraded"] and out["retries"] == 0, out
    assert out["fallbacks"] == 0, out


# ---------------------------------------------------------------------------
# the pair kernels: bitset pair, array x bitset probe, array pair
# ---------------------------------------------------------------------------

def _i32(a, dev):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.astype(np.int32)).to(dev)


def _pair_words(rng, m):
    a = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    if m >= 4:
        a[1], b[1] = 0, 0xFFFFFFFF
        a[2], b[2] = 0xFFFFFFFF, 0xFFFFFFFF
        a[3] = b[3]
    ids = np.resize(np.array([0, 1, 2, 3, -1, 7], np.int32), m)
    return a, b, ids


@pytest.mark.parametrize("m", [0, 1, 6, 300])
def test_bitset_pair_kernels_match_plain(cuda, m):
    a, b, ids = _pair_words(np.random.default_rng(m), m)
    ta, tb, ti = _i32(a, cuda), _i32(b, cuda), _i32(ids, cuda)
    want_w, want_c = ref.bitset_pair_op(ta, tb, ti)
    pair_ops.reset_launches()
    got_w, got_c = pair_ops.bitset_pair_op(ta, tb, ti)
    got_c2 = pair_ops.bitset_pair_card(ta, tb, ti)
    torch.cuda.synchronize()
    assert torch.equal(got_w, want_w) and torch.equal(got_c, want_c)
    assert torch.equal(got_c2, want_c)
    assert pair_ops.launches_by_kernel["bitset_pair_op"] == int(m > 0)
    assert pair_ops.launches_by_kernel["bitset_pair_card"] == int(m > 0)


def _probe_case(rng, m):
    cards = np.resize(np.array([0, 1, 4096, 37, 2, 4000], np.int32), m)
    vals = np.zeros((m, ARRAY_CAP), np.int32)
    for r, c in enumerate(cards):
        vals[r, :c] = np.sort(rng.choice(1 << 16, c, replace=False))
    if m > 4:
        vals[4, :2] = [0, 65535]
    words = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    if m > 2:
        words[2] = 0xFFFFFFFF
    return vals, cards, words


@pytest.mark.parametrize("m", [0, 1, 6, 300])
def test_probe_kernel_matches_plain(cuda, m):
    vals, cards, words = _probe_case(np.random.default_rng(m + 1), m)
    args = (_i32(vals, cuda), _i32(cards, cuda), _i32(words, cuda))
    want = ref.array_bitset_probe(*args)
    pair_ops.reset_launches()
    got = pair_ops.array_bitset_probe(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert pair_ops.launches == int(m > 0)


def test_probe_kernel_off_contract_values_stay_in_the_row(cuda):
    """Values outside [0, 65535] and cards outside [0, 4096]: the kernel
    clips the word index as the plain version does, so it reads nothing
    outside the row, raises no fault and equals the plain version."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-2**31, 2**31, (4, ARRAY_CAP),
                        dtype=np.int64).astype(np.int32)
    vals[0, :4] = [-1, 65536, 2**31 - 1, -2**31]
    cards = np.array([9999, -7, 4096, 1], np.int32)
    words = rng.integers(0, 1 << 32, (4, WORDS), dtype=np.uint32)
    args = (_i32(vals, cuda), _i32(cards, cuda), _i32(words, cuda))
    got = pair_ops.array_bitset_probe(*args)
    torch.cuda.synchronize()
    want = ref.array_bitset_probe(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bitset_pair_kernel_extreme_op_ids(cuda):
    rng = np.random.default_rng(6)
    a, b, _ = _pair_words(rng, 4)
    ids = np.array([-2**31, 2**31 - 1, 4, 3], np.int32)
    got = pair_ops.bitset_pair_op(_i32(a, cuda), _i32(b, cuda),
                                  _i32(ids, cuda))
    torch.cuda.synchronize()
    want = a & ~b
    assert np.array_equal(got[0].cpu().numpy().view(np.uint32), want)
    assert np.array_equal(got[1].cpu().numpy(),
                          np.bitwise_count(want).sum(axis=1))


def _array_case(rng, m):
    """Rows cycle through: cards (0, 5), (1, 1) equal, (4096, 1),
    identical arrays, disjoint ranges, a 50% overlap, full x full, the
    values 0 and 65535."""
    ac = np.resize(np.array([0, 1, 4096, 3000, 900, 1000, 4096, 2]), m)
    bc = np.resize(np.array([5, 1, 1, 3000, 800, 1000, 4096, 3]), m)
    a = np.zeros((m, ARRAY_CAP), np.int32)
    b = np.zeros((m, ARRAY_CAP), np.int32)
    for r in range(m):
        kind = r % 8
        x = np.sort(rng.choice(1 << 16, ac[r], replace=False))
        y = np.sort(rng.choice(1 << 16, bc[r], replace=False))
        if kind == 1:
            y = x.copy()
        elif kind == 2:
            y = x[17:18]
        elif kind == 3:
            y = x.copy()
        elif kind == 4:
            x = np.sort(rng.choice(30000, ac[r], replace=False))
            y = 30000 + np.sort(rng.choice(35536, bc[r], replace=False))
        elif kind == 5:
            c = rng.choice(1 << 16, 1500, replace=False)
            x, y = np.sort(c[:1000]), np.sort(c[500:])
        elif kind == 7:
            x, y = np.array([0, 65535]), np.array([0, 7, 65535])
        a[r, :x.size], b[r, :y.size] = x, y
    return a, ac.astype(np.int32), b, bc.astype(np.int32)


@pytest.mark.parametrize("m", [0, 1, 8, 256])
def test_array_pair_kernels_match_plain(cuda, m):
    a, ac, b, bc = _array_case(np.random.default_rng(m + 2), m)
    args = [_i32(x, cuda) for x in (a, ac, b, bc)]
    want = ref.array_pair_masks(*args)
    array_ops.reset_launches()
    got = array_ops.array_pair_masks(*args)
    cnt = array_ops.array_intersect_card(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(cnt, want[2])
    assert array_ops.launches == 2 * int(m > 0)


def test_array_pair_kernel_off_contract_stays_in_bounds(cuda):
    """Unsorted, repeated and out-of-range values and cards outside [0,
    4096]: the searches read only the other row's clamped prefix, so the
    kernel ends without a fault, its masks are 0/1 and zero past the
    clamped cards, and the count is the sum of mask_a."""
    rng = np.random.default_rng(8)
    a = rng.integers(-2**31, 2**31, (4, ARRAY_CAP),
                     dtype=np.int64).astype(np.int32)
    b = rng.integers(-5, 50, (4, ARRAY_CAP)).astype(np.int32)
    a[1, :200] = rng.integers(-5, 50, 200)
    ac = np.array([9999, 200, -3, 4096], np.int32)
    bc = np.array([4096, -1, 77, 123456], np.int32)
    args = [_i32(x, cuda) for x in (a, ac, b, bc)]
    ma, mb, cnt = array_ops.array_pair_masks(*args)
    c2 = array_ops.array_intersect_card(*args)
    torch.cuda.synchronize()
    pos = torch.arange(ARRAY_CAP, device=cuda)
    for m, c in ((ma, ac), (mb, bc)):
        lim = torch.from_numpy(np.clip(c, 0, ARRAY_CAP)).to(cuda)
        assert ((m == 0) | (m == 1)).all()
        assert not m[pos[None, :] >= lim[:, None]].any()
    assert torch.equal(cnt, ma.sum(dim=1, dtype=torch.int32))
    assert torch.equal(c2, cnt)


def _mixed_card_case(rng, m):
    """Cards cycling through 0, 1, 64 and 4,096 on each side, out of step
    (B above the 512 values a warp stages, and below), B holding every
    other value of A plus its own."""
    ac = np.resize(np.array([0, 1, 64, 4096], np.int32), m)
    bc = np.resize(np.array([4096, 64, 1, 0, 64, 4096, 1], np.int32), m)
    a = np.zeros((m, ARRAY_CAP), np.int32)
    b = np.zeros((m, ARRAY_CAP), np.int32)
    for r in range(m):
        x = np.sort(rng.choice(1 << 16, ac[r], replace=False))
        own = rng.choice(1 << 16, bc[r], replace=False)
        y = np.union1d(x[::2], own)[:bc[r]]
        a[r, :x.size], b[r, :y.size] = x, y
        bc[r] = y.size
    return a, ac, b, bc


@pytest.mark.parametrize("m", [1, 7, 8, 9, 8193, "mixed"])
def test_array_intersect_card_kernel_rows(cuda, m):
    """The count kernel takes a warp a row and four rows a block: M = 1,
    7, 8, 9 and 8,193 (path-sized rows of about 64 values), and 1,027 rows
    of mixed cards; equal to the plain count and to the mask kernel's
    count, one launch a call."""
    rng = np.random.default_rng(31)
    if m == "mixed":
        a, ac, b, bc = _mixed_card_case(rng, 1027)
    else:
        a, ac, b, bc = _sparse_case(rng, m)
    args = [_i32(x, cuda) for x in (a, ac, b, bc)]
    want = ref.array_intersect_count(*args)
    n0 = array_ops.launches_by_kernel["array_intersect_card"]
    got = array_ops.array_intersect_card(*args)
    masks = array_ops.array_pair_masks(*args)
    torch.cuda.synchronize()
    assert array_ops.launches_by_kernel["array_intersect_card"] == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(got, masks[2])


def test_pair_wrappers_raise_on_bad_input(cuda):
    z = torch.zeros((4, WORDS), dtype=torch.int32, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    v = torch.zeros((4, ARRAY_CAP), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pair_ops.bitset_pair_op(z.to(torch.int64), z, ids)
    with pytest.raises(ValueError):
        pair_ops.bitset_pair_card(z, z, ids[:3])
    with pytest.raises(ValueError):
        pair_ops.array_bitset_probe(v[:, ::2], ids, z)
    with pytest.raises(ValueError):
        array_ops.array_pair_masks(v, ids, v, ids.cpu())
    with pytest.raises(ValueError):
        array_ops.array_intersect_card(v[:, :WORDS], ids, v, ids)


def _mixed_pair_bitmaps(seed, n=6):
    from repro_torch.core import RoaringBitmap
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        for c in range(24):
            base, r = c << 16, rng.random()
            if r < 0.1:
                continue
            if r < 0.45:
                parts.append(base + rng.choice(1 << 16, int(rng.integers(
                    1, 4000)), replace=False))
            elif r < 0.8:
                parts.append(base + rng.choice(1 << 16, int(rng.integers(
                    5000, 40000)), replace=False))
            else:
                lo = int(rng.integers(0, 1 << 15))
                parts.append(np.arange(base + lo, base + lo + 20000))
        out.append(RoaringBitmap.from_values(
            np.unique(np.concatenate(parts)).astype(np.uint32))
            .run_optimize())
    return out


def test_planner_on_the_card_matches_ref(cuda):
    """merge_one and pairwise_card with backend="cuda" on the card equal
    backend="ref" (the plain versions), and every pair kernel launched."""
    from repro_torch.core import pairwise
    bms = _mixed_pair_bitmaps(31)
    pair_ops.reset_launches()
    array_ops.reset_launches()
    for op in ("and", "or", "xor", "andnot"):
        for i, j in ((0, 1), (2, 3), (4, 4), (5, 0)):
            got = pairwise.merge_one(bms[i], bms[j], op, backend="cuda",
                                     device=cuda)
            want = pairwise.merge_one(bms[i], bms[j], op, backend="ref",
                                      device=cuda)
            host = pairwise.merge_one(bms[i], bms[j], op, device="cpu")
            assert got == want == host
            assert [c.kind for c in got.containers] == \
                [c.kind for c in host.containers]
    pairs = [(bms[i], bms[j]) for i in range(6) for j in range(6)]
    ops = list(np.resize(["and", "or", "xor", "andnot"], len(pairs)))
    got = pairwise.pairwise_card(ops, pairs, backend="cuda", device=cuda)
    want = pairwise.pairwise_card(ops, pairs, backend="ref", device=cuda)
    host = pairwise.pairwise_card(ops, pairs, device="cpu")
    assert np.array_equal(got, want) and np.array_equal(got, host)
    assert min(pair_ops.launches_by_kernel.values()) > 0
    assert array_ops.launches_by_kernel["array_pair_masks"] > 0
    assert array_ops.launches_by_kernel["array_intersect_card"] > 0


def _conversion_case(seed, m):
    """Array rows for the conversion kernels: cards -1, 0, 1, 4,096 and
    5,000 among sparse ones, sorted distinct values below each card with
    garbage after it, the values 0 and 65,535, and off-contract rows with
    duplicates and values outside [0, 65535]; old words with all-zero and
    all-ones rows."""
    rng = np.random.default_rng(seed)
    card = rng.integers(1, 130, m).astype(np.int32)
    card[:5][:m] = np.array([-1, 0, 1, ARRAY_CAP, 5000])[:m]
    vals = rng.integers(-2**31, 2**31, (m, ARRAY_CAP),
                        dtype=np.int64).astype(np.int32)
    for r in range(m):
        c = min(max(int(card[r]), 0), ARRAY_CAP)
        vals[r, :c] = np.sort(rng.choice(1 << 16, c, replace=False))
    if m > 7:
        vals[5, :4] = [0, 65535, 65536, -1]
        vals[6, :6] = [3, 3, 31, 31, 64, 64]
        vals[7, :5] = [-33, 70000, 2**31 - 1, -2**31, 9]
        card[5:8] = [4, 6, 5]
    old = rng.integers(0, 1 << 32, (m, WORDS), dtype=np.uint32)
    old[::3] = 0
    old[1::3] = 0xFFFFFFFF
    return vals, card, old


@pytest.mark.parametrize("m", [0, 1, 8, 300])
def test_conversion_kernels_match_plain(cuda, m):
    vals, card, old = _conversion_case(m + 40, m)
    v, c, o = _i32(vals, cuda), _i32(card, cuda), _i32(old, cuda)
    bitset_convert.reset_launches()
    got = bitset_convert.array_to_bitset(v, c)
    new, delta = bitset_convert.bitset_set_many(o, v, c)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.array_to_bitset(v, c))
    want_new, want_delta = ref.bitset_set_many(o, v, c)
    assert torch.equal(new, want_new) and torch.equal(delta, want_delta)
    assert torch.equal(o, _i32(old, cuda))           # input untouched
    assert bitset_convert.launches_by_kernel == {
        "array_to_bitset": int(m > 0), "bitset_set_many": int(m > 0)}


@pytest.mark.parametrize("m", [0, 1, 8, 300])
def test_popcount_kernel_matches_plain(cuda, m):
    _, _, old = _conversion_case(m + 60, m)
    w = _i32(old, cuda)
    harley_seal.reset_launches()
    got = harley_seal.popcount(w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.popcount_words(w))
    assert harley_seal.launches == int(m > 0)


def test_conversion_wrappers_raise_on_bad_input(cuda):
    v = torch.zeros((4, ARRAY_CAP), dtype=torch.int32, device=cuda)
    c = torch.zeros(4, dtype=torch.int32, device=cuda)
    w = torch.zeros((4, WORDS), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bitset_convert.array_to_bitset(v.to(torch.int64), c)
    with pytest.raises(ValueError):
        bitset_convert.array_to_bitset(v, c[:3])
    with pytest.raises(ValueError):
        bitset_convert.bitset_set_many(w[:, ::2], v[:, :1024], c)
    with pytest.raises(ValueError):
        harley_seal.popcount(w.t())


def test_roaring_tensor_on_the_card(cuda):
    """A RoaringTensor built with the default device lands on the card;
    its operations launch array_to_bitset, the pair kernels and
    segment_reduce and equal the same tensor's on the CPU, component by
    component."""
    from repro_torch import convert
    from repro_torch.core.tensor import RoaringTensor
    bms = _mixed_pair_bitmaps(41)
    t = RoaringTensor.from_bitmaps(bms[:3], capacity=32)
    u = RoaringTensor.from_bitmaps(bms[3:], capacity=32)
    assert t.device.type == "cuda"
    tc = RoaringTensor.from_bitmaps(bms[:3], capacity=32, device="cpu")
    uc = RoaringTensor.from_bitmaps(bms[3:], capacity=32, device="cpu")

    def same(x, y):
        return all(np.array_equal(p, q) for p, q in zip(
            convert.tensor_to_parts(x), convert.tensor_to_parts(y)))
    for mod in (bitset_convert, pair_ops, segment_ops):
        mod.reset_launches()
    assert torch.equal(t.to_words().cpu(), tc.to_words())
    for op in ("__and__", "__or__", "__xor__", "andnot"):
        assert same(getattr(t, op)(u), getattr(tc, op)(uc)), op
    assert torch.equal(t.and_card(u).cpu(), tc.and_card(uc))
    assert torch.equal(t.jaccard(u).cpu(), tc.jaccard(uc))
    got = t.pairwise_card(u, ["and", "xor", "or"], lhs_idx=[0, 2, 2],
                          rhs_idx=[1, 1, 0])
    assert torch.equal(got.cpu(), tc.pairwise_card(
        uc, ["and", "xor", "or"], lhs_idx=[0, 2, 2], rhs_idx=[1, 1, 0]))
    assert same(t.reduce_or(), tc.reduce_or())
    assert same(t.run_optimize(), tc.run_optimize())
    q = np.random.default_rng(3).integers(0, 24 << 16, (3, 500))
    assert torch.equal(t.contains(q).cpu(), tc.contains(q))
    assert t.to_bitmaps() == bms[:3]
    torch.cuda.synchronize()
    assert bitset_convert.launches_by_kernel["array_to_bitset"] > 0
    assert pair_ops.launches_by_kernel["bitset_pair_op"] > 0
    assert pair_ops.launches_by_kernel["bitset_pair_card"] > 0
    assert segment_ops.launches == 1


# ---------------------------------------------------------------------------
# the section-4 kernels: fused bitset op and count, A-side intersection
# ---------------------------------------------------------------------------

SECTION4_OPS = ("and", "or", "xor", "andnot")


@pytest.mark.parametrize("m", [0, 1, 6, 300, 8192])
def test_bitset_op_kernels_match_plain(cuda, m):
    a, b, _ = _pair_words(np.random.default_rng(m + 70), m)
    ta, tb = _i32(a, cuda), _i32(b, cuda)
    bitset_ops.reset_launches()
    for op in SECTION4_OPS:
        want_w, want_c = ref.bitset_op(ta, tb, op)
        got_w, got_c = bitset_ops.bitset_op(ta, tb, op)
        got_c2 = bitset_ops.bitset_op_card(ta, tb, op)
        torch.cuda.synchronize()
        assert torch.equal(got_w, want_w) and torch.equal(got_c, want_c)
        assert torch.equal(got_c2, want_c)
    assert bitset_ops.launches_by_kernel == {
        "bitset_op": 4 * int(m > 0), "bitset_op_card": 4 * int(m > 0)}


def _intersect_case(rng, m):
    """_array_case's rows, and for m >= 8: B empty in row 1, a card above
    4,096 in row 6, a negative card in row 4, and in row 7 A = [0, 65535,
    65537] against B = [0, 7, 65535] padded with 65537."""
    a, ac, b, bc = _array_case(rng, m)
    if m >= 8:
        bc[1], ac[6], bc[4] = 0, 5000, -3
        a[7, :3], ac[7] = [0, 65535, 65537], 3
        b[7, 3:] = 65537
    return a, ac, b, bc


def _sparse_case(rng, m, mean=64):
    """m rows of about ``mean`` sorted distinct values each side, B holding
    every other value of its A row (the index's 0.1% density)."""
    gaps = rng.integers(1, 2 * (65536 // mean), (m, 256))
    a = np.cumsum(gaps, axis=1) - 1
    ac = (a < 65536).sum(axis=1).astype(np.int32)
    a = np.pad(np.where(a < 65536, a, 0), ((0, 0), (0, ARRAY_CAP - 256)))
    b = np.zeros_like(a)
    b[:, :128] = a[:, :256:2]
    bc = (ac + 1) // 2
    return a.astype(np.int32), ac, b.astype(np.int32), bc.astype(np.int32)


@pytest.mark.parametrize("m", [0, 1, 8, 256, 8192])
def test_array_intersect_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(m + 80)
    x = _intersect_case(rng, m) if m <= 256 else _sparse_case(rng, m)
    args = [_i32(v, cuda) for v in x]
    want = ref.array_intersect_mask(*args)
    array_ops.reset_launches()
    got = array_ops.array_intersect(*args)
    keep, diff = array_ops.array_difference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ck, cd = array_ops.array_difference(*[v.cpu() for v in args])
    assert torch.equal(keep.cpu(), ck) and torch.equal(diff.cpu(), cd)
    assert array_ops.launches_by_kernel["array_intersect"] == 2 * int(m > 0)
    if 8 <= m <= 256:
        assert want[0][7, :4].tolist() == [1, 1, 0, 0]


def _row12_case(rng, kind, m):
    """Rows for the A-side intersection's cases: ``tree`` A at 4,096
    values against B of 513 to 4,000 values (past 512), half of them A's;
    ``full`` both sides at 4,096, identical on even rows; ``off`` the
    value 65537 at A's last valid slot beside B padded with 65537, a
    negative card on either side, cards above 4,096 on either side, and
    A unsorted with repeats; ``mixed`` cards cycling through 0, 1, 64 and
    4,096 on each side, out of step."""
    a = np.zeros((m, ARRAY_CAP), np.int32)
    b = np.zeros((m, ARRAY_CAP), np.int32)
    if kind == "tree":
        ac = np.full(m, 4096)
        bc = rng.integers(513, 4001, m)
    elif kind == "full":
        ac = bc = np.full(m, 4096)
    elif kind == "off":
        ac = np.resize(np.array([300, -1, 64, 5000, 4095, 40]), m)
        bc = np.resize(np.array([200, 64, -7, 100, 4097, 64]), m)
    else:
        ac = np.resize(np.array([0, 1, 64, 4096]), m)
        bc = np.resize(np.array([4096, 64, 1, 0, 64, 4096, 1]), m)
    for r in range(m):
        na, nb = np.clip([ac[r], bc[r]], 0, ARRAY_CAP)
        x = np.sort(rng.choice(1 << 16, na, replace=False))
        own = rng.choice(1 << 16, nb, replace=False)
        y = np.union1d(x[::2], own)[:nb]
        if kind == "full" and r % 2 == 0:
            y = x
        a[r, :na], b[r, :y.size] = x, y
    if kind == "off":
        a[0::6, 299], b[0::6, 200:] = 65537, 65537
        a[5::6, :40] = rng.integers(0, 1 << 16, (a[5::6].shape[0], 40))
        a[5::6, 10:20] = a[5::6, :1]
    return a, ac.astype(np.int32), b, bc.astype(np.int32)


@pytest.mark.parametrize("kind,m", [("tree", 64), ("full", 64),
                                    ("off", 48), ("mixed", 1027),
                                    ("mixed", 2049), ("tree", 2049)])
def test_array_intersect_kernel_cases(cuda, kind, m):
    """Each mask, count and difference bit-equal to the plain versions,
    at row counts on both sides of the kernel's early-load limit (2,048
    rows)."""
    x = _row12_case(np.random.default_rng(m + len(kind)), kind, m)
    args = [_i32(v, cuda) for v in x]
    want = ref.array_intersect_mask(*args)
    array_ops.reset_launches()
    got = array_ops.array_intersect(*args)
    keep, diff = array_ops.array_difference(*args)
    again = array_ops.array_intersect(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    ck, cd = array_ops.array_difference(*[v.cpu() for v in args])
    assert torch.equal(keep.cpu(), ck) and torch.equal(diff.cpu(), cd)
    assert array_ops.launches_by_kernel["array_intersect"] == 3
    if kind == "off":
        assert int(got[0][0, 299]) == 0          # 65537 never matches


def test_section4_ops_route_to_the_kernels_by_default(cuda):
    a, b, _ = _pair_words(np.random.default_rng(90), 16)
    ta, tb = _i32(a, cuda), _i32(b, cuda)
    x = [_i32(v, cuda) for v in _intersect_case(np.random.default_rng(91),
                                                 8)]
    bitset_ops.reset_launches()
    array_ops.reset_launches()
    for op in SECTION4_OPS:
        w, c = ops.bitset_op(ta, tb, op)
        assert torch.equal(ops.bitset_op_card(ta, tb, op), c)
        rw, rc = ops.bitset_op(ta, tb, op, backend="ref")
        assert torch.equal(w, rw) and torch.equal(c, rc)
    m, c = ops.array_intersect(*x)
    rm, rc = ops.array_intersect(*x, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(m, rm) and torch.equal(c, rc)
    assert bitset_ops.launches_by_kernel == {"bitset_op": 4,
                                             "bitset_op_card": 4}
    assert array_ops.launches_by_kernel["array_intersect"] == 1
    m, c = ops.array_intersect(*x, backend="cuda")
    assert array_ops.launches_by_kernel["array_intersect"] == 2


def test_section4_wrappers_raise_on_bad_input(cuda):
    z = torch.zeros((4, WORDS), dtype=torch.int32, device=cuda)
    v = torch.zeros((4, ARRAY_CAP), dtype=torch.int32, device=cuda)
    c = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unknown op"):
        bitset_ops.bitset_op(z, z, "nand")
    with pytest.raises(ValueError, match="unknown op"):
        ops.bitset_op_card(z, z, "AND")
    with pytest.raises(TypeError):
        bitset_ops.bitset_op(z.to(torch.int64), z, "and")
    with pytest.raises(ValueError):
        bitset_ops.bitset_op_card(z, z[:3], "or")
    with pytest.raises(ValueError):
        array_ops.array_intersect(v[:, ::2], c, v[:, :WORDS], c)
    with pytest.raises(ValueError):
        array_ops.array_intersect(v, c, v, c.cpu())


# ---------------------------------------------------------------------------
# the sharded similarity kernels (score over ids, labelled select) and the
# sharded paths on the card
# ---------------------------------------------------------------------------

def _ids_inputs(seed, lens, n_valid, c=6):
    """``_topk_inputs`` rows scattered into a larger table, read through
    positions; slots at or past ``n_valid`` are padding with no rows, id
    1000 and card 0."""
    rows, row_col, starts, q, q_card, cards = _topk_inputs(seed, lens, c)
    starts[n_valid + 1:] = starts[n_valid]       # pad slots: no rows
    rng = np.random.default_rng(seed + 1)
    n = int(starts[-1])
    table = rng.integers(0, 1 << 32, (2 * n + 5, WORDS), dtype=np.uint32)
    pos = rng.permutation(table.shape[0])[:n].astype(np.int32)
    table[pos] = rows[:n]
    gidx = np.sort(rng.choice(999, len(lens), replace=False)).astype(
        np.int32)
    gidx[n_valid:] = 1000
    cards[n_valid:] = 0
    return table, pos, row_col[:n], starts, q, q_card, cards, gidx


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_valid", [len(LENS), 5])
@pytest.mark.parametrize("exclude", [-1, "first", 999])
def test_score_ids_kernel_matches_plain(cuda, metric, n_valid, exclude):
    table, pos, col, starts, q, q_card, cards, gidx = _ids_inputs(
        4, LENS, n_valid)
    ex = int(gidx[0]) if exclude == "first" else exclude
    args = [_dev(a, cuda) for a in (table, pos, col, starts, q)]
    rest = (_dev(cards, cuda), _dev(gidx, cuda), n_valid, ex)
    want = ref.similarity_score_ids(*args, q_card, *rest, metric=metric)
    n0 = topk_ops.launches_by_stage["score_ids"]
    got = topk_ops.similarity_score_ids(*args, q_card, *rest,
                                        metric=metric)
    torch.cuda.synchronize()
    assert topk_ops.launches_by_stage["score_ids"] == n0 + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("n", [1, 13, 400, 3000])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_select_ids_kernel_matches_plain(cuda, n, k):
    """Coarse scores (ties), repeated ids, pad entries at -2.0 and k past
    n: the rounds after every entry is masked must match too."""
    rng = np.random.default_rng(n + k)
    score = (rng.integers(-2, 6, n) / 4).astype(np.float32)
    gidx = rng.integers(0, max(2, n // 3), n).astype(np.int32)
    inter = rng.integers(0, 1 << 20, n).astype(np.int32)
    s, i, g = _dev(score, cuda), _dev(inter, cuda), _dev(gidx, cuda)
    want = ref.topk_select_ids(s, i, g, k)
    n0 = topk_ops.launches_by_stage["select_ids"]
    got = topk_ops.topk_merge(s, i, g, k)
    torch.cuda.synchronize()
    assert topk_ops.launches_by_stage["select_ids"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n,k", [(1025, 10), (5000, 1), (5000, 600),
                                 (5000, 5007), (65536, 10), (65536, 513)])
def test_select_ids_kernel_past_one_block(cuda, n, k):
    """Past the 1,024 entries one block sorts: levels of chunks (k <=
    512), one block sorting in device memory (k > 512); ties,
    repeated ids, -1.0 and -2.0 entries, k past n; bit-equal."""
    rng = np.random.default_rng(n + k)
    score = (rng.integers(-8, 40, n) / 32).astype(np.float32)
    score = np.where(score < -0.125, np.float32(-2.0),
                     np.where(score < 0, np.float32(-1.0), score))
    gidx = rng.integers(0, max(2, n // 2), n).astype(np.int32)
    inter = rng.integers(0, 1 << 20, n).astype(np.int32)
    s, i, g = _dev(score, cuda), _dev(inter, cuda), _dev(gidx, cuda)
    want = ref.topk_select_ids(s, i, g, k)
    got = topk_ops.topk_merge(s, i, g, k)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_select_ids_kernel_exhaustion_rounds(cuda):
    """The rounds after every group above -2.0 is taken repeat the lowest
    id at -2.0 with the largest inter of its entries."""
    args = [torch.tensor(x, device=cuda) for x in (
        [.5, .9, -2, .9, -1, .5], [5, 9, 77, 3, 1, 6], [40, 7, 2, 7, 9, 3])]
    args[1:] = [a.to(torch.int32) for a in args[1:]]
    idx, sco, itr = topk_ops.topk_merge(*args, 8)
    assert idx.tolist() == [7, 3, 40, 9, 2, 2, 2, 2]
    assert itr.tolist() == [9, 6, 5, 1, 77, 77, 77, 77]
    assert sco.cpu().tolist() == [np.float32(x) for x in
                                  (.9, .5, .5, -1, -2, -2, -2, -2)]


@pytest.mark.parametrize("score,gidx", [
    ([-0.0, 0.0, 0.5], [0, 1, 2]),
    ([0.0, -0.0], [5, 7]),
    ([0.0, -0.0], [7, 5]),
    ([-0.0, -0.0, 0.0, -0.0], [4, 2, 1, 3]),
    ([-0.0, -0.0, -0.0], [4, 2, 4]),
])
def test_select_ids_kernel_signed_zeros(cuda, score, gidx):
    """-0.0 and +0.0 tie in the key, so the lower id goes first; a group
    at zero is +0.0 while an entry of +0.0 with an id at or past its own
    remains, else -0.0: bit-equal to the plain version."""
    score = np.asarray(score, np.float32)
    args = [_dev(score, cuda),
            _dev(np.arange(10, 10 + score.size, dtype=np.int32), cuda),
            _dev(np.asarray(gidx, np.int32), cuda)]
    for k in (1, score.size, score.size + 2):
        want = ref.topk_select_ids(*args, k)
        got = topk_ops.topk_merge(*args, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_ids_kernels_fault_on_a_bad_position(cuda):
    """A position past the table traps in the score-over-ids kernel (child
    process: a trap leaves the CUDA context unusable)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = """
import torch
from repro_torch.kernels import topk_ops
dev = torch.device("cuda")
i32 = dict(dtype=torch.int32, device=dev)
table = torch.zeros((4, 2048), **i32)
q = torch.zeros((2, 2048), **i32)
pos = torch.tensor([0, 1, 4], **i32)
col = torch.tensor([0, 1, 1], **i32)
starts = torch.tensor([0, 2, 3], **i32)
z = torch.zeros(2, **i32)
topk_ops.similarity_score_ids(table, pos, col, starts, q, 0, z, z, 2,
                              metric="jaccard")
torch.cuda.synchronize()
print("NO FAULT")
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0, proc.stdout
    assert "NO FAULT" not in proc.stdout


@pytest.mark.parametrize("s", [2, 3])
def test_sharded_similar_on_the_card(cuda, s):
    """``similar(mesh=)`` over S shards on the card equals the CPU's
    single-device answers, with S score-over-ids and S + 1 labelled
    select launches a query."""
    from repro_torch.dist import WideMesh
    host, card = _index_pair(cuda, True)
    mesh = WideMesh([cuda] * s)
    topk_ops.reset_launches()
    n = 0
    for metric in METRICS:
        for term in ("t0", "dup", "nope"):
            for k in (1, 5, 30):
                got = card.similar(term, k, metric, mesh=mesh)
                want = host.similar(term, k, metric)
                assert [t for t, _ in got] == [t for t, _ in want]
                assert np.float32([x for _, x in got]).tobytes() == \
                    np.float32([x for _, x in want]).tobytes()
                n += 1
    assert topk_ops.launches_by_stage == {
        "score": 0, "select": 0, "score_ids": s * n,
        "select_ids": (s + 1) * n}


def test_sharded_aggregates_on_the_card(cuda):
    from repro_torch.core import BitmapArena
    from repro_torch.core import aggregate
    from repro_torch.dist import WideMesh
    host, card = _index_pair(cuda, True)
    mesh = WideMesh([cuda] * 3)
    terms = ["t0", "t1", "t2", "t3", "t5"]
    bms = [card.postings[t] for t in terms]
    hb = [host.postings[t] for t in terms]
    arena = card.arena
    segment_ops.reset_launches()
    for name, kw in (("or_many", {}), ("and_many", {}), ("xor_many", {}),
                     ("threshold_many", dict(t=2)),
                     ("threshold_many", dict(t=4, weights=[1, 2, 3, 1, 2]))):
        got = getattr(aggregate, name)(bms, arena=arena, mesh=mesh, **kw)
        want = getattr(aggregate, name)(hb, device="cpu", **kw)
        assert got == want, name
    got = aggregate.andnot_many(bms[0], bms[1:], arena=arena, mesh=mesh)
    assert got == aggregate.andnot_many(hb[0], hb[1:], device="cpu")
    assert segment_ops.launches > 0
    assert isinstance(arena, BitmapArena)


# ---------------------------------------------------------------------------
# Roaring block-sparse decode attention
# ---------------------------------------------------------------------------

def _bsa_case(seed, b, h, hkv, d, s, bs, dtype, kv_len=None, words=None,
              density=0.25):
    rng = np.random.default_rng(seed)
    nblk = s // bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    if words is None:
        bits = rng.random((b, nblk)) < density
        words = np.zeros((b, max(1, -(-nblk // 32))), np.uint32)
        for i, j in zip(*np.nonzero(bits)):
            words[i, j >> 5] |= np.uint32(1) << np.uint32(j & 31)
    if kv_len is None:
        kv_len = rng.integers(1, s + 1, b)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt),
            torch.from_numpy(np.asarray(words, np.uint32).view(np.int32)),
            torch.as_tensor(np.asarray(kv_len, np.int32)))


def _within_one_bf16_ulp(got, want):
    """Every element within one bfloat16 ulp of ``want``'s magnitude, and
    exact zeros where ``want`` is 0."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return bool(((g - w).abs() <= ulp).all() and (g[w == 0] == 0).all())


BSA_CASES = {
    "live": (4, 32, 16, 128, 2048, 128, "bfloat16", 50.0, {}),
    "jamba_g4": (4, 32, 8, 128, 2048, 128, "bfloat16", 0.0, {}),
    "f32": (2, 8, 2, 64, 1024, 128, "float32", 0.0, {}),
    "g1": (2, 4, 4, 128, 512, 128, "float32", 5.0, {}),
    "g8": (2, 16, 2, 64, 512, 128, "bfloat16", 0.0, {}),
    "d256": (2, 4, 2, 256, 512, 128, "bfloat16", 50.0, {}),
    "block256": (3, 16, 8, 64, 1024, 256, "float32", 0.0, {}),
    "b64": (64, 4, 2, 64, 512, 64, "bfloat16", 0.0, {}),
    "empty": (2, 4, 2, 64, 512, 128, "float32", 0.0,
              dict(words=np.zeros((2, 1), np.uint32))),
    "full": (2, 4, 2, 64, 512, 128, "bfloat16", 0.0,
             dict(words=np.full((2, 1), 0xFFFFFFFF, np.uint32))),
    "kv_edges": (4, 4, 2, 64, 512, 128, "float32", 0.0,
                 dict(kv_len=[0, 1, 200, 512],
                      words=np.full((4, 1), 0b1011, np.uint32))),
}


@pytest.mark.parametrize("name", sorted(BSA_CASES))
def test_decode_attention_kernel_matches_plain(cuda, name):
    from repro_torch.kernels import block_sparse_attn as bsa
    b, h, hkv, d, s, bs, dtype, softcap, kw = BSA_CASES[name]
    args = [x.to(cuda) for x in _bsa_case(7, b, h, hkv, d, s, bs, dtype,
                                          **kw)]
    bsa.reset_launches()
    got = bsa.decode_attention(*args, block_size=bs, softcap=softcap)
    torch.cuda.synchronize()
    assert bsa.launches == 1
    want = ref.block_sparse_attention_decode(*args, block_size=bs,
                                             softcap=softcap)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        assert bool((got[want == 0] == 0).all())
    else:
        assert _within_one_bf16_ulp(got, want)


def test_decode_attention_ops_route(cuda):
    from repro_torch.kernels import block_sparse_attn as bsa
    args = [x.to(cuda) for x in _bsa_case(3, 2, 8, 2, 64, 512, 128,
                                          "bfloat16")]
    bsa.reset_launches()
    a = ops.decode_attention(*args)
    b = ops.decode_attention(*args, backend="cuda")
    c = ops.decode_attention(*args, backend="ref")
    assert bsa.launches == 2
    assert torch.equal(a, b) and _within_one_bf16_ulp(a, c)


def test_decode_attention_wrapper_raises_on_bad_input(cuda):
    from repro_torch.kernels import block_sparse_attn as bsa
    q, k, v, words, kvl = [x.to(cuda) for x in _bsa_case(
        3, 2, 8, 2, 64, 512, 128, "bfloat16")]
    with pytest.raises(TypeError):
        bsa.decode_attention(q, k.float(), v, words, kvl)
    with pytest.raises(TypeError):
        bsa.decode_attention(q, k, v, words, kvl.long())
    with pytest.raises(ValueError, match="head dim"):
        bsa.decode_attention(q[..., :12].contiguous(),
                             k[..., :12].contiguous(),
                             v[..., :12].contiguous(), words, kvl)
    with pytest.raises(ValueError, match="block_size"):
        bsa.decode_attention(q, k, v, words, kvl, block_size=48)
    with pytest.raises(ValueError, match="block_mask_words"):
        bsa.decode_attention(q, k, v, words[:, :0], kvl)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        bsa.decode_attention(q[:, :7].contiguous(), k, v, words, kvl)


def test_decode_attention_rejects_misaligned_rows(cuda):
    """k and v are read with 16-byte cp.async: a contiguous view that
    starts 2 bytes into its storage raises."""
    from repro_torch.kernels import block_sparse_attn as bsa
    q, k, v, words, kvl = [x.to(cuda) for x in _bsa_case(
        3, 2, 8, 2, 64, 512, 128, "bfloat16")]
    for name in ("k", "v"):
        flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)
        bad = flat[1:].view(v.shape)
        bad.copy_(v)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        kv = (bad, v) if name == "k" else (k, bad)
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            bsa.decode_attention(q, *kv, words, kvl)


@pytest.mark.parametrize("splits", [1, 2, 3, 16])
def test_decode_attention_splits_and_partials(cuda, splits):
    """P forced to 1, 2, 3 and the block count: the output against the
    plain version, the kernel's partials against
    ``ref.decode_attention_partials`` (each (m, l, acc) row within 2e-5 of
    its largest magnitude, at least 1), the plain merge of the kernel's
    partials against its own merge, and the same bits on a second run."""
    from repro_torch.kernels import block_sparse_attn as bsa
    args = [x.to(cuda) for x in _bsa_case(
        5, 4, 8, 2, 128, 2048, 128, "float32",
        kv_len=[0, 70, 1000, 2048])]
    out, part = bsa.decode_attention_with_partials(*args, block_size=128,
                                                   softcap=30.0,
                                                   splits=splits)
    again = bsa.decode_attention(*args, block_size=128, softcap=30.0,
                                 splits=splits)
    torch.cuda.synchronize()
    want = ref.block_sparse_attention_decode(*args, block_size=128,
                                             softcap=30.0)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(out, again)
    assert bool((out[0] == 0).all())
    if splits == 1:
        assert part is None
        return
    plain = ref.decode_attention_partials(*args, splits, block_size=128,
                                          softcap=30.0)
    scale = plain.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    assert float(((part - plain).abs() / scale).max()) <= 2e-5
    torch.testing.assert_close(ref.combine_partials(part), out, atol=2e-5,
                               rtol=2e-5)


def _reduced_gemma(dtype, device, seed=0, **kw):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(configs.get_config("gemma2_27b", reduced=True),
                              compute_dtype=dtype, **kw)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return cfg, model.to(device)


def test_model_decode_kernel_against_plain(cuda):
    """A decode step of the reduced gemma2 model on the card launches the
    kernel once a global layer; from the same state the plain version
    (``backend="ref"``) gives logits within 4 bf16 ulps at |logit| < 8."""
    from repro_torch.kernels import block_sparse_attn as bsa
    cfg, model = _reduced_gemma("bfloat16", cuda)
    toks = torch.randint(0, cfg.vocab, (2, 193),
                         generator=torch.Generator().manual_seed(1))
    _, st = model.prefill(toks[:, :192].to(cuda), s_max=512)
    words = torch.full((2, 1), 0b1011, dtype=torch.int32, device=cuda)
    bsa.reset_launches()
    a, _ = model.decode_step(st, toks[:, 192].to(cuda), words)
    n_global = sum(m == "global" for m, _ in cfg.layer_kinds)
    assert bsa.launches == n_global
    b, _ = model.decode_step(st, toks[:, 192].to(cuda), words,
                             backend="ref")
    assert bsa.launches == n_global
    torch.testing.assert_close(a.float(), b.float(), atol=0.125, rtol=0)


def test_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the reduced gemma2 model in float32 compute on the
    card equal the CPU's, with 32-token blocks (the mask hides four of
    the prompt's six blocks), a constraint and a pinned block; the kernel
    launches once a global layer a new token; every page comes back."""
    from repro_torch.core import RoaringBitmap
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.serve import BlockPolicy, Engine, VocabConstraint
    prompts = np.random.default_rng(5).integers(0, 512, (2, 192)).astype(
        np.int32)
    outs = {}
    for dev in ("cpu", cuda):
        cfg, model = _reduced_gemma("float32", dev, attn_block_size=32)
        con = VocabConstraint(cfg.vocab, RoaringBitmap.from_values(
            np.arange(100, 300)), device=dev)
        eng = Engine(model, max_seq=512, constraint=con,
                     policy=BlockPolicy(1, 1,
                                        RoaringBitmap.from_values([0, 3])))
        bsa.reset_launches()
        outs[str(dev)] = eng.generate(prompts, 6)
        n_global = sum(m == "global" for m, _ in cfg.layer_kinds)
        assert bsa.launches == (0 if dev == "cpu" else 6 * n_global)
        assert ((outs[str(dev)] >= 100) & (outs[str(dev)] < 300)).all()
        eng.release_all()
        assert eng.allocator.n_free == eng.allocator.n_pages
    assert np.array_equal(outs["cpu"], outs[str(cuda)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_matches_the_per_token_recurrence(cuda, dtype):
    """The Mamba layer's chunked selective scan on the card against the
    plain per-token float32 recurrence on the same card, on one layer's
    inputs at Jamba's state width (ds 16, chunks of 128, 512 tokens): the
    float32 outputs and the final h within atol 1e-6, rtol 1e-5 (the
    doubling scan associates the recurrence in another order)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import ssm
    cfg = dataclasses.replace(configs.get_config("jamba_v01_52b",
                                                 reduced=True),
                              ssm_d_state=16, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    m = ssm.Mamba(cfg, tdt, cuda, torch.Generator(cuda).manual_seed(0))
    x = torch.randn((2, 512, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)).to(tdt)
    _, _, xi, dt, bmat, cmat = ssm.scan_inputs(x, m, cfg)
    y, h = ssm.selective_scan(xi, dt, bmat, cmat, m.A_log, cfg.ssm_chunk,
                              torch.float32)
    want_y, want_h = ssm.selective_scan_steps(xi, dt, bmat, cmat, m.A_log)
    torch.testing.assert_close(y, want_y, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(h, want_h, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_matches_decompressed(cuda, dtype):
    """DeepSeek-V2's MLA at full width (128 heads, kv_lora 512, rope 64)
    over a 2,048-row cache on the card: the absorbed attention, both
    flavours, against keys and values decompressed per head in float32
    from the same caches, within 1e-5 (float32) or 2^-5 (bfloat16) of each
    head's largest output."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    cfg = configs.get_config("deepseek_v2_236b")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(5)
    p = L.MLA(cfg, tdt, cuda, gen)
    b, s = 4, 2048
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda).to(tdt)
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
    ckv, kr = L._mla_ckv(x, p, cfg, pos)
    kv_len = torch.tensor([2048, 2000, 1023, 1], dtype=torch.int32,
                          device=cuda)
    q_nope, q_rope = L._mla_q(x[:, -1:], p, cfg, (kv_len - 1)[:, None])
    args = (q_nope[:, 0], q_rope[:, 0], ckv, kr, kv_len, p, cfg)
    want = L.mla_attend_decompressed(*args)
    top = want.abs().amax(dim=-1, keepdim=True)
    for ctx_f32 in (True, False):
        got = L.mla_attend_absorbed(*args, ctx_f32=ctx_f32)
        err = float(((got.float() - want).abs() / top).max())
        assert err <= (1e-5 if dtype == "float32" else 2.0 ** -5), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_route_against_row_17(cuda, dtype):
    """The ``sparse_topk_blocks`` gather route (plain PyTorch) against the
    row-17 kernel at Gemma2-27B's decode head shape (32 / 16 heads of
    128, 8,192 positions, softcap 50, kv_len 5,121-5,160, the engine's
    sink + local mask), topk = every block: float32 within 2e-5, bfloat16
    within 8 bf16 ulps of each row's largest output (the route rounds the
    weights to bf16 before the PV product, the kernel does not)."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.models import layers as L
    from repro_torch.serve import BlockPolicy
    from repro_torch.core.tensor import block_mask_words
    tdt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(6)
    b, h, hkv, d, s, bs = 4, 32, 16, 128, 8192, 128
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(tdt)
    k = (torch.randn((b, hkv, s, d), generator=gen, device=cuda) * 0.3
         ).to(tdt)
    v = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(tdt)
    kv = [5121 + 13 * i for i in range(b)]
    words = block_mask_words([BlockPolicy(1, 8).visible_set(
        n, bs, device=cuda) for n in kv], s // bs, device=cuda)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=cuda)
    want = bsa.decode_attention(q, k, v, words, kv_len, block_size=bs,
                                softcap=50.0)
    got = L.decode_attention_block_gather(q, k, v, kv_len, words,
                                          block_size=bs, topk=s // bs,
                                          softcap=50.0)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        g, w = got.float(), want.float()
        top = w.abs().amax(dim=-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        assert float(((g - w).abs() / ulp).max()) <= 8.0


def test_chunked_mlstm_matches_the_recurrence(cuda):
    """xLSTM-350M's mLSTM at full width (4 heads of 512) on the card: the
    chunkwise-parallel form (chunks of 64 over 1,024 tokens) against the
    per-token float32 recurrence on the same inputs, h and the final C, n
    and m within 1e-5 of each one's largest magnitude."""
    from repro_torch import configs
    from repro_torch.models import ssm
    cfg = configs.get_config("xlstm_350m")
    gen = torch.Generator(cuda).manual_seed(7)
    p = ssm.MLSTM(cfg, torch.bfloat16, cuda, gen)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen,
                    device=cuda).bfloat16()
    di = cfg.ssm_expand * cfg.d_model
    ins = ssm.mlstm_inputs((x @ p.up)[..., :di], p, cfg)
    st0 = ssm.mlstm_init_state(cfg, 4, cuda)
    h_c, st_c = ssm.mlstm_chunked(*ins, st0, cfg.xlstm_chunk)
    h_s, st_s = ssm.mlstm_steps(*ins, st0)
    for got, want in ((h_c, h_s), *((st_c[k], st_s[k]) for k in "Cnm")):
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * max(top, 1.0)


# the other families' reduced configs: (arch, overrides, batch kind, S);
# the Jamba case is a two-layer pattern at the reduced widths, four chunks
# of its scan, as in tests/test_torch_train_moe.py
FAMILY_CASES = {
    "mixtral": ("mixtral_8x7b", {}, "tokens", 128),
    "deepseek": ("deepseek_v2_236b", {}, "tokens", 128),
    "jamba2": ("jamba_v01_52b", dict(
        n_layers=2, pattern=(("mamba", "moe"), ("global", "mlp")),
        ssm_chunk=32), "tokens", 128),
    "xlstm-steps": ("xlstm_350m", dict(xlstm_chunk=0), "tokens", 64),
    "xlstm-chunked": ("xlstm_350m", dict(xlstm_chunk=16), "tokens", 64),
    "hubert": ("hubert_xlarge", {}, "audio", 64),
}


def _train_setup(dtype, dev, case=("qwen2_5_3b", {}, "tokens", 128)):
    """A reduced model (reduced qwen2.5-3b by default, or a
    ``FAMILY_CASES`` entry) with float32 masters drawn on the CPU from
    seed 3 (so every device starts from the same values), AdamW's state,
    and a batch of 2 sequences of S: tokens, or for an audio case S
    frontend embeddings and no tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    arch, kw, kind, s = case
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              compute_dtype=dtype, remat="block", **kw)
    src = Transformer(cfg, device="cpu", param_dtype="float32",
                      generator=torch.Generator().manual_seed(3))
    model = Transformer(cfg, device=dev, param_dtype="float32")
    model.load_state_dict(src.state_dict())
    model.requires_grad_(True)
    state = adamw.init_state(dict(model.named_parameters()))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, s + 1))
    if kind == "audio":
        batch = {"frontend_embeds": torch.from_numpy(rng.standard_normal(
                     (2, s, cfg.frontend_dim)).astype(np.float32)).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    else:
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    return cfg, model, state, batch


def _one_step(cfg, model, state, batch, steps=1):
    """``steps`` train steps on ``batch`` -> (parameters, m and v, each
    step's metrics)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=10))
    metrics = []
    for _ in range(steps):
        _, state, m = step(model, state, batch)
        metrics.append(m)
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: {n: t.clone() for n, t in state[k].items()}
             for k in ("m", "v")}, metrics)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_reruns_bit_equal(cuda, dtype):
    """One train step of the reduced model on the card (remat on), run
    twice from the same parameters and AdamW state: parameters, m, v and
    the metrics bit-equal (the embedding's backward is deterministic)."""
    runs = []
    for _ in range(2):
        runs.append(_one_step(*_train_setup(dtype, cuda)))
    (p1, s1, m1), (p2, s2, m2) = runs
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["m"][k], s2["m"][k]), k
        assert torch.equal(s1["v"][k], s2["v"][k]), k
    for k in m1[0]:
        assert torch.equal(m1[0][k], m2[0][k]), k


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """The same two float32 steps on the card and on the CPU: each step's
    loss within 1e-5 relative and grad norm within 1e-4 relative (the
    float32 tolerances of the CPU tests against JAX; TF32 is off by
    default).  The second step's loss is computed from the parameters the
    card's AdamW wrote."""
    cpu = _one_step(*_train_setup("float32", "cpu"), steps=2)[2]
    gpu = _one_step(*_train_setup("float32", cuda), steps=2)[2]
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        for key, tol in (("loss", 1e-5), ("ce_loss", 1e-5),
                         ("grad_norm", 1e-4)):
            a, b = float(g[key]), float(c[key])
            assert abs(a - b) <= tol * abs(b), (i, key, a, b)
        assert float(g["lr"]) == float(c["lr"]), i


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_train_step_reruns_bit_equal(cuda, case):
    """One bf16 train step of each family's reduced model on the card
    (remat on), run twice from the same parameters and AdamW state:
    parameters, m, v and the metrics bit-equal.  The MoE dispatch's
    gather back adds only the zeros of dropped choices to its one repeated
    row, and the routing counts add one constant, so their atomics give
    the same sums in any order."""
    runs = []
    for _ in range(2):
        runs.append(_one_step(*_train_setup("bfloat16", cuda,
                                            FAMILY_CASES[case])))
    (p1, s1, m1), (p2, s2, m2) = runs
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["m"][k], s2["m"][k]), k
        assert torch.equal(s1["v"][k], s2["v"][k]), k
    for k in m1[0]:
        assert torch.equal(m1[0][k], m2[0][k]), k


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_train_step_on_the_card_matches_the_cpu(cuda, case):
    """The same float32 step of each family's reduced model on the card
    and on the CPU: its loss and router loss within 1e-5 relative and
    grad norm within 1e-4 relative, as for qwen2.5-3b above.  One step:
    a second one starts from parameters AdamW moved by about lr wherever
    a gradient is float32 noise, so its grad norm carries the two
    devices' rounding apart (xLSTM's second step: 3.8e-4 relative between
    card and CPU; on the CPU alone its chunked and per-token mLSTM, equal
    in exact arithmetic, give second-step norms 2.1e-4 apart)."""
    cpu = _one_step(*_train_setup("float32", "cpu", FAMILY_CASES[case]))[2]
    gpu = _one_step(*_train_setup("float32", cuda, FAMILY_CASES[case]))[2]
    for key, tol in (("loss", 1e-5), ("ce_loss", 1e-5),
                     ("router_aux", 1e-5), ("grad_norm", 1e-4)):
        a, b = float(gpu[0][key]), float(cpu[0][key])
        assert abs(a - b) <= tol * abs(b), (key, a, b)


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_on_the_card_matches_the_cpu(cuda, clip):
    """``adamw.apply_updates`` on the card from the CPU's own inputs (the
    reduced qwen2.5-3b's leaves, seeded numpy parameters, gradients and a
    random state at step 3; the clip idle and active): parameters, m and v
    within 2 float32 ulps of each leaf's largest magnitude of the CPU's
    (the bound tests/test_torch_optim.py holds the CPU to JAX with), lr
    equal, the grad norm within 1e-6 relative (each device orders a leaf's
    sum of squares its own way).  This holds the card's 0-dim scalars, one
    set a device, against the CPU's arithmetic."""
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    cfg = configs.get_config("qwen2_5_3b", reduced=True)
    shapes = {k: tuple(p.shape) for k, p in Transformer(
        cfg, device="cpu", param_dtype="float32").named_parameters()}
    rng = np.random.default_rng(11)

    def draw(scale, positive=False):
        out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
               for k, s in shapes.items()}
        return {k: np.abs(x) for k, x in out.items()} if positive else out
    p, g, m, v = draw(1.0), draw(0.3), draw(0.05), draw(0.01, True)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50,
                            grad_clip=clip)
    got = {}
    for dev in ("cpu", cuda):
        def on(tree):
            return {k: torch.from_numpy(x.copy()).to(dev)
                    for k, x in tree.items()}
        state = {"m": on(m), "v": on(v),
                 "step": torch.tensor(3, dtype=torch.int32)}
        params, state, metrics = adamw.apply_updates(on(p), on(g), state,
                                                     opt)
        got[str(dev)] = ({"p": params, "m": state["m"], "v": state["v"]},
                         metrics)
    (card, mc), (host, mh) = got[str(cuda)], got["cpu"]
    gn = float(mh["grad_norm"])
    assert abs(float(mc["grad_norm"]) - gn) <= 1e-6 * gn
    if clip < gn:
        assert gn > 2 * clip            # the clip is active in this case
    assert float(mc["lr"]) == float(mh["lr"])
    for name in ("p", "m", "v"):
        for k, want in host[name].items():
            want = want.numpy()
            err = np.abs(card[name][k].cpu().numpy().astype(np.float64)
                         - want).max()
            assert err <= 2 * np.spacing(np.abs(want).max()), (name, k)


# ---------------------------------------------------------------------------
# the device mesh: the sharded step on an NCCL group of one, arena shards
# on the card and the CPU
# ---------------------------------------------------------------------------

def test_sharded_step_on_an_nccl_group_of_one(cuda, monkeypatch):
    """Qwen2.5-3B at full width, 2 layers, batch 1 x 256: every leaf a
    DTensor on the (1, 1) mesh of an NCCL group of one; two steps' losses
    and gradient norms bit-equal to the plain steps (each shard is the
    whole tensor)."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import ctx
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    cfg = dataclasses.replace(configs.get_config("qwen2_5_3b"), n_layers=2)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, 256), generator=gen,
                         dtype=torch.int32).to(cuda)
    batch = {"tokens": toks, "labels": toks}
    dist.init_process_group("nccl", device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh()
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        out = []
        for sharded in (False, True):
            model = Transformer(cfg, device=cuda, param_dtype="float32",
                                generator=torch.Generator(cuda)
                                .manual_seed(0))
            model.requires_grad_(True)
            state = adamw.init_state(dict(model.named_parameters()))
            b = dict(batch)
            if sharded:
                state, b = TS.shard_train_state(model, state, b, mesh)
                assert all(ctx.is_dtensor(p) for p in model.parameters())
            step = TS.make_train_step(cfg, adamw.AdamWConfig(
                warmup_steps=1))
            hist = []
            for _ in range(2):
                _, state, m = step(model, state, b)
                hist.append([float(m[k].full_tensor() if ctx.is_dtensor(
                    m[k]) else m[k]) for k in ("loss", "grad_norm")])
            out.append(hist)
            del model, state
        assert out[0] == out[1]
    finally:
        dist.destroy_process_group()


def test_shard_slabs_on_the_card_and_the_cpu(cuda):
    """Arena shards on (card, CPU): one slab a shard on its device, the
    rows a launch reads from the other device gathered to it; the sharded
    aggregates and ``similar(mesh=)`` equal the one-device answers."""
    from repro_torch.core import aggregate
    from repro_torch.dist import WideMesh
    host, card = _index_pair(cuda, True)
    mesh = WideMesh([cuda, "cpu"])
    shards = card.arena.shard_slabs(mesh)
    assert shards.distinct
    terms = ["t0", "t1", "t2", "t3", "t5"]
    bms = [card.postings[t] for t in terms]
    hb = [host.postings[t] for t in terms]
    for name, kw in (("or_many", {}), ("and_many", {}), ("xor_many", {}),
                     ("threshold_many", dict(t=2))):
        got = getattr(aggregate, name)(bms, arena=card.arena, mesh=mesh,
                                       **kw)
        assert got == getattr(aggregate, name)(hb, device="cpu", **kw), name
    for metric in METRICS:
        for term in ("t0", "dup"):
            got = card.similar(term, 5, metric, mesh=mesh)
            want = host.similar(term, 5, metric)
            assert [t for t, _ in got] == [t for t, _ in want]
            assert np.float32([x for _, x in got]).tobytes() == \
                np.float32([x for _, x in want]).tobytes()
    assert shards._bufs[0].device.type == "cuda"
    assert shards._bufs[1].device.type == "cpu"
    assert sum(st.rows_gathered for st in shards.stats) > 0
