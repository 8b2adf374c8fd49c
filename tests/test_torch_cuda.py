"""The CUDA kernels against their plain PyTorch versions, on the card.

segment_reduce: every row source (slab, ids, dual) x op, with empty
segments, one-row segments, per-segment T, weights and T above every
count; words bit-identical and cards equal (integer work).  The similarity
score and select kernels: every metric, exclusion, ragged and empty
candidates, duplicates that tie, a zero query cardinality and cards near
2^31-1; indices and intersections equal and float32 scores bit-identical
(tolerance 0).  Then ``similar`` and the ``QueryServer`` on the card
against the CPU's answers, and a trapping score launch that the server
resolves as an error instead of serving it from the host.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither JAX nor ``repro``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, segment_ops, topk_ops
from repro_torch.kernels.ref import METRICS, WORDS

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
    assert topk_ops.launches_by_stage == {"score": n, "select": n}


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
