#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository; it needs one CUDA device and the CUDA
toolkit (``nvcc``).  Phases, each timed:

1. Device and build: the card's name and power limit, and every kernel
   source under ``src/repro_torch/kernels/csrc/`` built at once, one nvcc
   each, in parallel.
2. segment_reduce against plain: every row source (slab, ids, dual) x op
   (or, and, xor, andnot, threshold, weighted threshold) at the main path's
   shapes (256 segments, about 10^5 rows) and at small edge cases; words
   must be bit-identical to the plain PyTorch version on the card and cards
   equal.  Kernel, plain and bytes-bound times are printed.
2b. The similarity score and select kernels against their plain versions:
   1,024 ragged candidates (about 2.3 * 10^5 rows, empty candidates, one
   at the maximum of 256 rows, duplicates that tie), every metric,
   ``exclude`` in {-1, 0, T-1}, a zero query cardinality and cards near
   2^31-1 for the score; k in {1, 10, 100, T} for the select, also on
   scores with many ties.  Indices, intersections and float32 score bits
   must be equal; the select must also equal ``torch.sort`` (stable),
   whose time is printed beside the kernel's.
3. Boolean queries at real scale: an ``InvertedIndex`` over 2^24 documents
   and 1,024 terms on a ``BitmapArena`` on the card (64 dense bitset
   terms, 960 sparse array terms), 64 queries of each boolean class run
   one at a time and coalesced through ``aggregate.execute_plans``, every
   answer checked against an independent numpy oracle; then the two other
   segment_reduce front ends (cold staged rows, no arena).
4. Similarity at real scale on the same index: the engine built through
   ``InvertedIndex.similar`` (its build time and device bytes), 64
   member-term queries per metric at k = 10, 16 at k = 100 and 4 unknown
   terms, each equal to an independent numpy oracle (packed sets, popcount
   of the AND, float32 scores, stable argsort) and each launching the
   score and the select kernel exactly once; latency, idle share and
   kernel time per query.
5. The ``QueryServer`` on the same index: 256 mixed tickets (32 of each
   boolean class, 64 ``similar``) through ``run_until_idle``, every value
   equal to the oracle (so to the single-query calls of phases 3 and 4,
   which equal it), and in this fault-free run no retry, no host fallback
   and no degraded ticket; tickets/s and ticket latency.  Then scripted
   faults on a smaller index (2^20 documents, 64 terms): one
   ``dispatch_raise`` retries once, a ``slab_mismatch`` after one postings
   edit repatches only that row, and ``dispatch_raise`` always degrades
   every ticket to the host, flagged, with the same answers.

Launch counts are set to 0 just before each of phases 3, 4 and 5 and read
just after it; a kernel that a phase's path runs and that launched no time
there fails the script.  Then one JSON line with every kernel's numbers,
and the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device, when the
repository's sources are missing, or when any phase fails.  A detailed
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12         # 32-bit lane ops; the data sheet's fp32 rate
N_DOCS = 1 << 24              # 256 chunks of 2^16 documents
N_DENSE, N_SPARSE = 64, 960
QUERIES = 64
CLASSES = ("and", "or", "xor", "andnot", "threshold", "threshold_w")
OPS = (("or", None), ("and", None), ("xor", None), ("andnot", None),
       ("threshold", "per_segment"), ("threshold", "weights"))
SOURCES = ("slab", "ids", "dual")
SOURCES_CU = ("segment_reduce", "similarity_topk")   # csrc/<name>.cu
METRICS = ("jaccard", "cosine", "containment")
SIM_T = 1024                  # candidates at the main path: the terms


def log(msg: str) -> None:
    print(msg, flush=True)


def _reset_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels import segment_ops, topk_ops
    segment_ops.reset_launches()
    topk_ops.reset_launches()


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def _kernel_inputs(dev, gen, lens, n_table, n_staged):
    """Random rows, segment offsets, ids, dual-source positions (about one
    slot in ten cold, from a staged block) and weights, on the card."""
    def rand_rows(n):
        return torch.randint(-2**31, 2**31, (n, 2048), dtype=torch.int32,
                             device=dev, generator=gen)
    starts = torch.zeros(len(lens) + 1, dtype=torch.int32)
    starts[1:] = torch.cumsum(torch.tensor(lens, dtype=torch.int32), 0)
    r = int(starts[-1])
    table = rand_rows(max(n_table, r))            # the slab source's rows
    table[0] = 0                                  # the reserved zero row
    staged = rand_rows(n_staged)
    staged[0] = 0
    ids = torch.randint(1, n_table, (r,), dtype=torch.int32, device=dev,
                        generator=gen)
    cold = torch.rand(r, device=dev, generator=gen) < 0.1
    pos = torch.where(cold, 0, ids).to(torch.int32)
    sidx = torch.where(cold, torch.randint(1, n_staged, (r,), device=dev,
                                           generator=gen), 0)
    weights = torch.randint(1, 5, (r,), dtype=torch.int32, device=dev,
                            generator=gen)
    return dict(table=table, staged=staged, starts=starts.to(dev), ids=ids,
                pos=pos, sidx=sidx.to(torch.int32), weights=weights,
                lens=np.asarray(lens))


def _op_args(x, op, tmode):
    """Keyword arguments of one op case: T per segment (some exactly
    attainable, some above every count) and, for weights, the counter
    widths."""
    from repro_torch.kernels.segment_ops import counter_planes
    lens = x["lens"]
    jmax = max(1, int(lens.max()))
    kw = dict(jmax=jmax)
    if op != "threshold":
        return kw, {}
    scale = 4 if tmode == "weights" else 1
    t = np.maximum(1, (lens * scale) // 3)
    t[::5] = np.maximum(1, lens[::5])             # attainable by every row
    t[1::5] = lens[1::5] * scale + 1              # above every count
    kw["threshold"] = torch.from_numpy(t.astype(np.int32)).to(
        x["starts"].device)
    extra = {"planes": max(counter_planes(jmax * scale),
                           int(t.max()).bit_length())}
    if tmode == "weights":
        kw["weights"] = x["weights"]
        extra["wbits"] = 3
    return kw, extra


def _source_call(src, x):
    """(plain function, kernel wrapper, positional tensors) of a source."""
    from repro_torch.kernels import ref, segment_ops as so
    if src == "slab":
        return (ref.segment_reduce, so.segment_reduce,
                (x["table"][: int(x["starts"][-1])], x["starts"]))
    if src == "ids":
        return (ref.segment_reduce_rows, so.segment_reduce_rows,
                (x["table"], x["ids"], x["starts"]))
    return (ref.segment_reduce_rows_dual, so.segment_reduce_rows_dual,
            (x["table"], x["staged"], x["pos"], x["sidx"], x["starts"]))


def _time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up (CUDA
    events).  The warm-up's result is returned."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _device_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` runs after one warm-up: the
    sum of the card's event durations in a profiler window, per run.
    Unlike CUDA events around a loop, it leaves out the host's time
    between launches, which is most of it for a kernel of microseconds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _device_busy_us(prof, ())[0] / reps / 1e3


def _bound(src, op, tmode, x, planes):
    """Least time for the work, in ms, and what bounds it: bytes (every
    needed row read once, outputs written once, index vectors read once)
    against operations (one op per word per row for the folds; for the
    counters about two per plane, per weight bit, per word per row)."""
    s = len(x["lens"])
    r = int(x["lens"].sum())
    idx = {"slab": 0, "ids": 4, "dual": 8}[src] * r
    nbytes = r * 8192 + s * 8192 + 4 * s + 4 * (s + 1) + idx
    ops = r * 2048
    if op == "threshold":
        nbytes += 4 * s + (4 * r if tmode == "weights" else 0)
        wset = (float(np.mean([bin(w).count("1") for w in
                               x["weights"].cpu().tolist()]))
                if tmode == "weights" else 1.0)
        ops = r * 2048 * 2 * planes * wset + s * 2048 * 4 * planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, seed, failures, segments=256, max_len=781):
    from repro_torch.kernels import segment_ops as so
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    # main-path shapes: 256 segments, about 10^5 rows, a few empty
    lens = rng.integers(1, max_len + 1, segments)
    lens[rng.choice(segments, 4, replace=False)] = 0
    shapes = {"main": (lens.tolist(), 100_000, 4096),
              "edge": ([3, 0, 5, 1, 0, 7, 2, 9, 4], 64, 8),
              "jmax1": ([1, 1, 1, 1, 1], 16, 4)}
    cases = []
    max_err = 0
    for shape, (ls, n_table, n_staged) in shapes.items():
        x = _kernel_inputs(dev, gen, ls, n_table, n_staged)
        big = shape == "main"
        for src in SOURCES:
            plain, kern, args = _source_call(src, x)
            for op, tmode in OPS:
                kw, extra = _op_args(x, op, tmode)
                want, plain_ms = _time_ms(lambda: plain(*args, op, **kw),
                                          3 if big else 1)
                got, ms = _time_ms(lambda: kern(*args, op, **kw, **extra),
                                   20 if big else 1)
                same = torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1])
                for g, w in zip(got, want):
                    if g.numel():
                        max_err = max(max_err, int(
                            (g.to(torch.int64) - w).abs().max()))
                name = f"{shape}/{src}/{op}" + (f"/{tmode}" if tmode else "")
                if not same:
                    failures.append(f"kernel != plain: {name}")
                bound_ms, bound_by = _bound(src, op, tmode, x,
                                            extra.get("planes", 1))
                cases.append(dict(case=name, rows=int(x["lens"].sum()),
                                  segments=len(ls), equal=same,
                                  ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by))
                if big:
                    log(f"  {name:34s} equal={same} kernel {ms:.4f} ms  "
                        f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms "
                        f"({bound_by})")
        del x
        torch.cuda.empty_cache()
    log("  library_ms: null -- no single PyTorch call computes a segmented "
        "bitwise reduce fused with a popcount")
    n_small = sum(1 for c in cases if not c["case"].startswith("main"))
    log(f"  {n_small} edge cases: "
        f"{sum(c['equal'] for c in cases if not c['case'].startswith('main'))}"
        f" equal; launches so far {so.launches}")
    return cases, max_err


# ---------------------------------------------------------------------------
# phase 2b: the similarity score and select kernels against their plain
# versions
# ---------------------------------------------------------------------------

def _cards_of(rows, starts):
    """(T,) int32 popcount of each candidate's rows (plain torch, in
    blocks of rows so the int64 popcount stays small)."""
    from repro_torch.kernels.ref import popcount_words
    per = torch.cat([popcount_words(rows[i:i + 8192])
                     for i in range(0, rows.shape[0], 8192)])
    t = starts.shape[0] - 1
    seg = torch.searchsorted(starts[1:].long(),
                             torch.arange(rows.shape[0], device=rows.device),
                             right=True)
    return torch.zeros(t, dtype=torch.int64, device=rows.device).index_add_(
        0, seg, per.long()).to(torch.int32)


def _topk_inputs(dev, seed, n_cand=SIM_T, n_cols=256):
    """Main-path shapes: T = 1,024 candidates over 256 key columns, most
    with 192-256 rows (at most one per column, as in an engine), eight
    empty, one at the maximum of 256, and candidates 10-19 copies of
    candidate 9 (exact ties); random words on the card."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = rng.integers(192, n_cols + 1, n_cand)
    lens[rng.choice(np.arange(20, n_cand - 2), 8, replace=False)] = 0
    lens[n_cand - 2] = n_cols
    lens[10:20] = lens[9]
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    cols = [np.sort(rng.choice(n_cols, n, replace=False)) for n in lens]
    for t in range(10, 20):
        cols[t] = cols[9]
    row_col = np.concatenate(cols).astype(np.int32)
    rows = torch.randint(-2**31, 2**31, (int(starts[-1]), 2048),
                         dtype=torch.int32, device=dev, generator=gen)
    s9 = int(starts[9])
    for t in range(10, 20):
        rows[int(starts[t]):int(starts[t + 1])] = rows[s9:int(starts[10])]
    q = torch.randint(-2**31, 2**31, (n_cols, 2048), dtype=torch.int32,
                      device=dev, generator=gen)
    st = torch.from_numpy(starts).to(dev)
    from repro_torch.kernels.ref import popcount_words
    return dict(rows=rows, row_col=torch.from_numpy(row_col).to(dev),
                starts=st, q=q, q_card=int(popcount_words(q).sum()),
                cards=_cards_of(rows, st), lens=lens)


def _score_bound(x):
    n, t = x["rows"].shape[0], len(x["lens"])
    nbytes = (n * 8192 + x["q"].shape[0] * 8192 + 4 * n + 4 * (t + 1)
              + 4 * t + 8 * t)
    ops = n * 2048 * 2                         # an AND and a popcount
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _select_bound(t, k):
    t_bytes = (8 * t + 12 * k) / HBM_BYTES_PER_S * 1e3
    t_ops = k * t / INT_OPS_PER_S * 1e3        # k rounds of T compares
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bits_equal(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _err(got, want):
    return max((float((g.double() - w.double()).abs().max())
                if g.numel() else 0.0) for g, w in zip(got, want))


def phase_topk_kernels(dev, seed, failures):
    """Score and select against their plain versions: exact equality of
    indices, intersections and float32 score bits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_ops as tk
    x = _topk_inputs(dev, seed + 10)
    t = len(x["lens"])
    args = (x["rows"], x["row_col"], x["starts"])
    cases, max_err = [], 0.0
    scores = {}
    variants = [("main", x["q"], x["q_card"], x["cards"]),
                ("q_card0", torch.zeros_like(x["q"]), 0, x["cards"]),
                ("cards_2^31", x["q"], 2**31 - 1, torch.randint(
                    2**31 - 2**20, 2**31, (t,), dtype=torch.int32,
                    device=dev))]
    for name, q, qc, cards in variants:
        for metric in METRICS:
            for exclude in (-1, 0, t - 1):
                big = name == "main" and exclude == -1
                want, plain_ms = _time_ms(lambda: ref.similarity_score(
                    *args, q, qc, cards, exclude, metric=metric),
                    3 if big else 1)
                got, ms = _time_ms(lambda: tk.similarity_score(
                    *args, q, qc, cards, exclude, metric=metric),
                    20 if big else 1)
                same = _bits_equal(got, want)
                max_err = max(max_err, _err(got, want))
                case = f"score/{name}/{metric}/exclude={exclude}"
                if not same:
                    failures.append(f"kernel != plain: {case}")
                bound_ms, bound_by = _score_bound(x)
                cases.append(dict(case=case, equal=same, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None))
                if big:
                    log(f"  {case:40s} equal={same} kernel {ms:.4f} ms  "
                        f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms"
                        f" ({bound_by})")
                if name == "main" and exclude == 0:
                    scores[metric] = got
    rng = np.random.default_rng(seed + 11)
    ties = torch.from_numpy((rng.integers(0, 6, t) / 5).astype(
        np.float32)).to(dev)
    scores["ties"] = (ties, x["cards"])
    for name, (score, inter) in scores.items():
        for k in sorted({k for k in (1, 10, 100, t) if k <= t}):
            timed = name == "jaccard" and k in (10, 100)
            want, plain_ms = _time_ms(lambda: ref.topk_select(
                score, inter, k), 3 if timed else 1)
            got, ms = _time_ms(lambda: tk.topk_select(score, inter, k),
                               50 if timed else 1)
            lib, lib_ms = _time_ms(lambda: torch.sort(
                score, descending=True, stable=True).indices[:k],
                50 if timed else 1)
            same = _bits_equal(got, want) and torch.equal(got[0].long(),
                                                          lib)
            device = {}
            if timed:                   # launch-bound: time on the device
                device = dict(
                    device_ms=_device_ms(lambda: tk.topk_select(
                        score, inter, k), 50),
                    device_plain_ms=_device_ms(lambda: ref.topk_select(
                        score, inter, k), 3),
                    device_library_ms=_device_ms(lambda: torch.sort(
                        score, descending=True, stable=True).indices[:k],
                        50))
            max_err = max(max_err, _err(got, want))
            case = f"select/{name}/k={k}"
            if not same:
                failures.append(f"kernel != plain: {case}")
            bound_ms, bound_by = _select_bound(t, k)
            cases.append(dict(case=case, equal=same, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms,
                              **device))
            if timed:
                log(f"  {case:40s} equal={same} events: kernel {ms:.4f} ms"
                    f"  plain {plain_ms:.3f} ms  torch.sort {lib_ms:.4f} ms"
                    f"; device: kernel {device['device_ms']:.4f} ms  plain "
                    f"{device['device_plain_ms']:.3f} ms  torch.sort "
                    f"{device['device_library_ms']:.4f} ms; bound "
                    f"{bound_ms:.6f} ms ({bound_by})")
    info = dict(candidates=t, rows=int(x["rows"].shape[0]),
                empty=int((x["lens"] == 0).sum()),
                longest=int(x["lens"].max()))
    log(f"  {len(cases)} cases, {sum(c['equal'] for c in cases)} equal; "
        f"{info['rows']} rows over {t} candidates ({info['empty']} empty, "
        f"longest {info['longest']}); launches so far {tk.launches_by_stage}")
    del x, scores
    torch.cuda.empty_cache()
    return cases, max_err, info


# ---------------------------------------------------------------------------
# phase 3: the main path at real scale
# ---------------------------------------------------------------------------

def _dense_words(dev, gen, p):
    """(N_DOCS / 64,) uint64 words of independent random bits of density
    ``p``, drawn on the card."""
    bits = torch.rand(N_DOCS, device=dev, generator=gen) < p
    shifted = bits.view(-1, 64).to(torch.int64) << torch.arange(64,
                                                                device=dev)
    return shifted.sum(dim=1).cpu().numpy().view(np.uint64)


def _packed(values, n_words=N_DOCS // 64):
    words = np.zeros(n_words, np.uint64)
    np.bitwise_or.at(words, values >> 6,
                     np.uint64(1) << (values & 63).astype(np.uint64))
    return words


def _to_packed(bm):
    """A result bitmap as (N_DOCS / 64,) uint64 words."""
    from repro_torch.core import containers as C
    out = np.zeros((N_DOCS >> 16, 1024), np.uint64)
    for k, c in zip(bm.keys, bm.containers):
        out[k] = C.container_words64(c)
    return out.reshape(-1)


def build_corpus(dev, seed):
    """Postings and oracle sets: 64 dense terms (densities log-uniform in
    [8%, 50%], random bits, so bitset containers in every chunk) and 960
    sparse terms (about 0.1%: array containers)."""
    from repro_torch import convert
    from repro_torch.core import RoaringBitmap
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    postings, sets, df = {}, {}, {}
    for i in range(N_DENSE):
        p = float(np.exp(rng.uniform(np.log(0.08), np.log(0.5))))
        w = _dense_words(dev, gen, p)
        chunks = w.reshape(-1, 1024)
        cards = np.bitwise_count(chunks).sum(axis=1)
        keys = [k for k in range(chunks.shape[0]) if cards[k]]
        bm = convert.bitmap_from_parts(
            keys, ["bitset"] * len(keys), [chunks[k] for k in keys])
        t = f"d{i}"
        postings[t], sets[t], df[t] = bm, w, int(cards.sum())
    for i in range(N_SPARSE):
        p = float(np.exp(rng.uniform(np.log(0.0007), np.log(0.0014))))
        vals = np.unique(rng.integers(0, N_DOCS, int(p * N_DOCS),
                                      dtype=np.uint32))
        t = f"s{i}"
        postings[t] = RoaringBitmap.from_values(vals)
        sets[t], df[t] = vals, int(vals.size)
    return postings, sets, df


def make_traffic(seed, df):
    """64 queries per class, K in [2, 8], terms drawn within a tier in
    proportion to their document frequency.  AND filters on dense terms
    only; OR, XOR and threshold mix the tiers half and half; ANDNOT keeps
    a dense term and drops mixed ones."""
    rng = np.random.default_rng(seed + 2)
    tiers = {}
    for tier in ("d", "s"):
        names = [t for t in df if t[0] == tier]
        w = np.asarray([df[t] for t in names], np.float64)
        tiers[tier] = (names, w / w.sum())

    def draw(tier, n, exclude=()):
        names, p = tiers[tier]
        out = []
        while len(out) < n:
            t = str(rng.choice(names, p=p))
            if t not in out and t not in exclude:
                out.append(t)
        return out

    def mixed(k, exclude=()):
        return draw("d", (k + 1) // 2, exclude) + draw("s", k // 2, exclude)

    traffic = {c: [] for c in CLASSES}
    for _ in range(QUERIES):
        k = int(rng.integers(2, 9))
        traffic["and"].append(dict(terms=draw("d", k)))
        traffic["or"].append(dict(terms=mixed(k)))
        traffic["xor"].append(dict(terms=mixed(k)))
        keep = draw("d", 1)
        traffic["andnot"].append(dict(terms=keep + mixed(k - 1, keep)))
        traffic["threshold"].append(dict(terms=mixed(k),
                                         t=int(rng.integers(2, k + 1))))
        w = [int(x) for x in rng.integers(1, 5, k)]
        traffic["threshold_w"].append(dict(
            terms=mixed(k), weights=w, t=int(rng.integers(2, sum(w) + 1))))
    return traffic


class Oracle:
    """Independent numpy answers from packed document sets (2^24 bits, or
    ``n_words`` 64-bit words)."""

    def __init__(self, sets, n_words=N_DOCS // 64):
        self._src = sets
        self._n_words = n_words
        self._packed = {}

    def words(self, term):
        w = self._packed.get(term)
        if w is None:
            src = self._src[term]
            w = src if src.dtype == np.uint64 else \
                _packed(src, self._n_words)
            self._packed[term] = w
        return w

    def answer(self, cls, q):
        ws = [self.words(t) for t in q["terms"]]
        if cls == "and":
            return np.bitwise_and.reduce(ws)
        if cls == "or":
            return np.bitwise_or.reduce(ws)
        if cls == "xor":
            return np.bitwise_xor.reduce(ws)
        if cls == "andnot":
            return ws[0] & ~np.bitwise_or.reduce(ws[1:])
        cnt = np.zeros(ws[0].size * 64, np.uint8)
        for w, wt in zip(ws, q.get("weights") or [1] * len(ws)):
            cnt += np.unpackbits(w.view(np.uint8), bitorder="little") * \
                np.uint8(wt)
        return np.packbits(cnt >= q["t"], bitorder="little").view(np.uint64)


def _run_query(index, cls, q):
    terms = q["terms"]
    if cls == "and":
        return index.query_and(*terms)
    if cls == "or":
        return index.query_or(*terms)
    if cls == "xor":
        return index.query_xor(*terms)
    if cls == "andnot":
        return index.query_andnot(terms[0], *terms[1:])
    return index.query_threshold(terms, q["t"], weights=q.get("weights"))


def _plan(index, cls, q):
    from repro_torch.core import aggregate
    bms = [index._get(t) for t in q["terms"]]
    op = {"threshold_w": "threshold"}.get(cls, cls)
    return aggregate.plan_wide(op, bms, q.get("t", 0), q.get("weights"),
                               arena=index.arena)


def _device_busy_us(prof, names):
    """Sum of device-side event durations (kernels and copies), and of the
    kernels whose names contain one of ``names``, in microseconds."""
    busy = kern = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.time_range.elapsed_us()
            busy += d
            if any(n in e.name for n in names):
                kern += d
    return busy, kern


def phase_main_path(dev, seed, failures):
    from repro_torch.core import BitmapArena, RoaringBitmap, aggregate
    from repro_torch.data.index import InvertedIndex
    from repro_torch.kernels import segment_ops as so
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    postings, sets, df = build_corpus(dev, seed)
    n_conts = sum(len(b.containers) for b in postings.values())
    kinds = {}
    for b in postings.values():
        for c in b.containers:
            kinds[c.kind] = kinds.get(c.kind, 0) + 1
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    arena = BitmapArena(capacity=n_conts + 1, device=dev)
    index = InvertedIndex.from_postings(postings, N_DOCS, arena=arena)
    arena.sync()
    t_index = time.perf_counter() - t0
    slab = arena.device_slab()
    info = dict(documents=N_DOCS, terms=len(postings), containers=n_conts,
                kinds=kinds, arena_rows=arena.n_rows,
                arena_bytes=slab.numel() * 4,
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                corpus_s=t_gen, index_s=t_index)
    log(f"  corpus {t_gen:.1f} s; index + arena upload {t_index:.1f} s: "
        f"{n_conts} containers {kinds}, arena {info['arena_bytes']} bytes, "
        f"max_memory_allocated {info['max_memory_allocated']}")
    traffic = make_traffic(seed, df)
    oracle = Oracle(sets)
    answers = {c: [oracle.answer(c, q) for q in qs]
               for c, qs in traffic.items()}

    _reset_counts()                         # the boolean path starts here
    up0 = arena.stats.rows_uploaded
    classes = {}
    for cls in CLASSES:
        lat, launched, wrong = [], 0, 0
        for q, want in zip(traffic[cls], answers[cls]):
            n0 = so.launches
            t = time.perf_counter()
            got = _run_query(index, cls, q)
            torch.cuda.synchronize(dev)
            lat.append((time.perf_counter() - t) * 1e3)
            launched += so.launches > n0
            wrong += not np.array_equal(_to_packed(got), want)
        n0 = so.launches
        t = time.perf_counter()
        plans = [_plan(index, cls, q) for q in traffic[cls]]
        outs = aggregate.execute_plans(plans)
        torch.cuda.synchronize(dev)
        coalesced_ms = (time.perf_counter() - t) * 1e3
        coalesced_launches = so.launches - n0
        wrong_c = sum(not np.array_equal(_to_packed(g), w)
                      for g, w in zip(outs, answers[cls]))
        # device busy share over a window of single queries
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for q in traffic[cls][:16]:
                _run_query(index, cls, q)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t) * 1e6
        busy_us, kern_us = _device_busy_us(
            prof, ("reduce_kernel", "threshold_kernel"))
        idle = 1.0 - busy_us / wall_us if busy_us > 0 else None
        classes[cls] = dict(
            queries=len(lat), p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)), launched=launched,
            wrong=wrong, coalesced_ms=coalesced_ms,
            coalesced_launches=coalesced_launches, coalesced_wrong=wrong_c,
            profiled_queries=16, device_busy_us=busy_us,
            kernel_us=kern_us, wall_us=wall_us, idle_share=idle)
        log(f"  {cls:12s} p50 {classes[cls]['p50_ms']:.2f} ms  p99 "
            f"{classes[cls]['p99_ms']:.2f} ms  launched {launched}/"
            f"{len(lat)}  wrong {wrong}  coalesced {coalesced_ms:.1f} ms "
            f"({coalesced_launches} launches, wrong {wrong_c})  idle "
            + (f"{idle:.4f}" if idle is not None else "not measured")
            + f"  kernel {kern_us / 16:.1f} us/query")
        if wrong or wrong_c:
            failures.append(f"{cls}: {wrong} single and {wrong_c} "
                            f"coalesced answers differ from the oracle")
        if launched * 2 < len(lat):
            failures.append(f"{cls}: kernel launched on only {launched} "
                            f"of {len(lat)} queries")
    if arena.stats.rows_uploaded != up0:
        failures.append("warm queries uploaded container rows")

    # the other two front ends of the same planner: cold rows staged next
    # to the resident slab (dual), and no arena at all (slab)
    rng = np.random.default_rng(seed + 3)
    fronts = {}
    for name in ("dual", "slab"):
        wrong = 0
        n0 = dict(so.launches_by_source)
        for i in range(8):
            q = traffic["or"][i]
            bms = [index._get(t) for t in q["terms"]]
            want = answers["or"][i]
            if name == "dual":
                vals = np.unique(rng.integers(0, N_DOCS, 200_000,
                                              dtype=np.uint32))
                bms.append(RoaringBitmap.from_values(vals))
                want = want | _packed(vals)
                got = aggregate.or_many(bms, arena=arena)
            else:
                got = aggregate.threshold_many(bms, 2, device=dev)
                want = oracle.answer("threshold", dict(terms=q["terms"],
                                                       t=2))
            wrong += not np.array_equal(_to_packed(got), want)
        used = so.launches_by_source[name] - n0[name]
        fronts[name] = dict(queries=8, launches=used, wrong=wrong)
        log(f"  front end {name}: {used} launches over 8 queries, "
            f"wrong {wrong}")
        if wrong or used == 0:
            failures.append(f"front end {name}: {wrong} wrong, "
                            f"{used} launches")
    launches = so.launches                  # the boolean path ends here
    by_source = dict(so.launches_by_source)
    info.update(classes=classes, fronts=fronts, launches=launches,
                launches_by_source=by_source)
    return info, dict(index=index, postings=postings, sets=sets,
                      traffic=traffic, answers=answers)


# ---------------------------------------------------------------------------
# phase 4: similarity on the main path
# ---------------------------------------------------------------------------

def _scores_f32(inter, q_card, cards, metric):
    """The metric in float32, one rounding per step: (qc + oc) - inter,
    sqrt(qc * oc), or qc; a zero denominator scores 1.0."""
    fi = np.asarray(inter).astype(np.float32)
    qc = np.float32(q_card)
    oc = np.asarray(cards).astype(np.float32)
    if metric == "jaccard":
        denom = (qc + oc) - fi
    elif metric == "cosine":
        denom = np.sqrt(qc * oc)
    else:
        denom = np.full_like(oc, qc)
    return np.divide(fi, denom, out=np.ones_like(fi), where=denom > 0)


class SimOracle:
    """Independent numpy top-k over packed document sets: intersections by
    popcount of the packed AND (a sparse term's set is its values, so its
    AND with the query is the count of its values whose bit the query
    has), float32 scores and a stable argsort."""

    def __init__(self, terms, sets, n_words):
        self.terms = list(terms)
        self.n_words = n_words
        dense = [i for i, t in enumerate(self.terms)
                 if sets[t].dtype == np.uint64]
        self.dense_idx = np.asarray(dense, np.int64)
        self.dense = np.stack([sets[self.terms[i]][:n_words]
                               for i in dense])
        vals, owner = [], []
        for i, t in enumerate(self.terms):
            if sets[t].dtype != np.uint64:
                v = sets[t][sets[t] < n_words * 64]
                vals.append(v)
                owner.append(np.full(v.size, i, np.int32))
        self.vals = np.concatenate(vals)
        self.owner = np.concatenate(owner)
        self.sets = sets
        self.cards = np.zeros(len(self.terms), np.int64)
        self.cards[self.dense_idx] = np.bitwise_count(self.dense).sum(axis=1)
        self.cards += np.bincount(self.owner, minlength=len(self.terms))

    def words(self, term):
        s = self.sets.get(term)
        if s is None:
            return np.zeros(self.n_words, np.uint64)
        if s.dtype == np.uint64:
            return s[: self.n_words]
        w = np.zeros(self.n_words, np.uint64)
        v = s[s < self.n_words * 64]
        np.bitwise_or.at(w, v >> 6, np.uint64(1) << (v & 63).astype(
            np.uint64))
        return w

    def inter(self, qw):
        out = np.zeros(len(self.terms), np.int64)
        out[self.dense_idx] = np.bitwise_count(self.dense & qw).sum(axis=1)
        bit = (qw[self.vals >> 6] >> (self.vals & 63).astype(np.uint64)) \
            & np.uint64(1)
        out += np.bincount(self.owner, weights=bit,
                           minlength=len(self.terms)).astype(np.int64)
        return out

    def topk(self, term, k, metric, inter=None):
        qw = self.words(term)
        qc = int(np.bitwise_count(qw).sum())
        if inter is None:
            inter = self.inter(qw)
        score = _scores_f32(inter, qc, self.cards, metric)
        n = len(self.terms)
        if term in self.sets:
            score[self.terms.index(term)] = np.float32(-1.0)
            n -= 1
        order = np.argsort(-score, kind="stable")[: min(k, n)]
        return [(self.terms[i], float(score[i])) for i in order.tolist()]


def _same_sim(got, want):
    return [t for t, _ in got] == [t for t, _ in want] and \
        np.float32([s for _, s in got]).tobytes() == \
        np.float32([s for _, s in want]).tobytes()


def sim_traffic(seed, terms):
    """64 member terms (16 dense, 48 sparse) for k = 10, 16 more (8 and 8)
    for k = 100, and 4 unknown terms, each under all three metrics."""
    rng = np.random.default_rng(seed + 4)
    dense = [t for t in terms if t[0] == "d"]
    sparse = [t for t in terms if t[0] == "s"]
    d = list(rng.choice(dense, 24, replace=False))
    s = list(rng.choice(sparse, 56, replace=False))
    out = []
    for metric in METRICS:
        out += [(str(t), 10, metric) for t in d[:16] + s[:48]]
        out += [(str(t), 100, metric) for t in d[16:] + s[48:]]
        out += [(f"unknown-{i}", 10, metric) for i in range(4)]
    return out


def phase_similarity(dev, index, sets, seed, failures):
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk
    from torch.profiler import ProfilerActivity, profile

    terms = list(index.postings)
    t0 = time.perf_counter()
    oracle = SimOracle(terms, sets, N_DOCS // 64)
    traffic = sim_traffic(seed, terms)
    inters = {}
    for term, _, _ in traffic:
        if term not in inters:
            inters[term] = oracle.inter(oracle.words(term))
    answers = [oracle.topk(t, k, m, inters[t]) for t, k, m in traffic]
    oracle_s = time.perf_counter() - t0
    log(f"  oracle: {len(inters)} query sets x {len(terms)} terms, "
        f"{oracle_s:.1f} s")

    _reset_counts()                         # the similarity path starts here
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    first = index.similar(traffic[0][0], traffic[0][1], traffic[0][2])
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t
    eng = index._sim_engine()[1]
    engine_bytes = eng._device()[0].numel() * 4
    mem_delta = torch.cuda.memory_allocated(dev) - mem0
    log(f"  engine build through similar(): {build_s:.2f} s; "
        f"{eng.rows.shape[0]} candidate rows, device rows {engine_bytes} "
        f"bytes (allocated +{mem_delta}) beside the "
        f"{index.arena.device_slab().numel() * 4}-byte arena")
    wrong = 0 if _same_sim(first, answers[0]) else 1
    lat: dict = {}
    bad_launch = 0
    for (term, k, metric), want in zip(traffic[1:], answers[1:]):
        n0 = dict(tk.launches_by_stage)
        t = time.perf_counter()
        got = index.similar(term, k, metric)
        lat.setdefault((metric, k), []).append(
            (time.perf_counter() - t) * 1e3)
        wrong += not _same_sim(got, want)
        bad_launch += any(tk.launches_by_stage[s] != n0[s] + 1
                          for s in n0)
    classes = {}
    for metric in METRICS:
        qs = [(t, k) for t, k, m in traffic if m == metric and k == 10][:16]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for term, k in qs:
                index.similar(term, k, metric)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t) * 1e6
        busy, kern = _device_busy_us(prof, ("score_kernel",
                                            "select_kernel"))
        sel = _device_busy_us(prof, ("select_kernel",))[1]
        for k in (10, 100):
            ls = lat.get((metric, k), [])
            classes[f"{metric}/k={k}"] = dict(
                queries=len(ls), p50_ms=float(np.percentile(ls, 50)),
                p99_ms=float(np.percentile(ls, 99)))
        classes[f"{metric}/k=10"].update(
            profiled_queries=len(qs), device_busy_us=busy, kernel_us=kern,
            score_us=kern - sel, select_us=sel, wall_us=wall_us,
            idle_share=1.0 - busy / wall_us if busy > 0 else None)
        c = classes[f"{metric}/k=10"]
        log(f"  {metric:12s} k=10 p50 {c['p50_ms']:.3f} ms  p99 "
            f"{c['p99_ms']:.3f} ms; k=100 p50 "
            f"{classes[f'{metric}/k=100']['p50_ms']:.3f} ms; idle "
            + (f"{c['idle_share']:.4f}" if c["idle_share"] is not None
               else "not measured")
            + f"  kernels {kern / len(qs):.1f} us/query (score "
            f"{(kern - sel) / len(qs):.1f}, select {sel / len(qs):.1f})")
    launches = dict(tk.launches_by_stage)   # the similarity path ends here
    log(f"  {len(traffic)} queries: wrong {wrong}, queries not launching "
        f"each stage once {bad_launch}; launches {launches}, "
        f"segment_reduce {so.launches}")
    if wrong:
        failures.append(f"similarity: {wrong} answers differ from the "
                        f"oracle")
    if bad_launch:
        failures.append(f"similarity: {bad_launch} queries did not launch "
                        f"each stage exactly once")
    if min(launches.values()) == 0:
        failures.append("similarity: a kernel never launched")
    sim_cases = [dict(term=t, k=k, metric=m, answer=a)
                 for (t, k, m), a in zip(traffic, answers)]
    return dict(queries=len(traffic), wrong=wrong, bad_launch=bad_launch,
                launches=launches, classes=classes, build_s=build_s,
                engine_rows=int(eng.rows.shape[0]),
                engine_device_bytes=engine_bytes,
                allocated_delta=mem_delta, oracle_s=oracle_s), sim_cases


# ---------------------------------------------------------------------------
# phase 5: the QueryServer
# ---------------------------------------------------------------------------

def _ticket_query(cls, q):
    from repro_torch.serve import Query
    if cls == "similar":
        return Query.similar(q["term"], k=q["k"], metric=q["metric"])
    terms = q["terms"]
    if cls == "and":
        return Query.and_(*terms)
    if cls == "or":
        return Query.or_(*terms)
    if cls == "xor":
        return Query.xor_(*terms)
    if cls == "andnot":
        return Query.andnot(terms[0], *terms[1:])
    return Query.threshold(terms, q["t"], q.get("weights"))


def _check_tickets(tickets, wants, to_packed, label, failures):
    """Every ticket OK and equal to its expected answer."""
    from repro_torch.serve import OK
    wrong = 0
    for t, (cls, want) in zip(tickets, wants):
        if t.result.status != OK:
            wrong += 1
        elif cls == "similar":
            wrong += not _same_sim(t.result.value, want)
        else:
            wrong += not np.array_equal(to_packed(t.result.value), want)
    if wrong:
        failures.append(f"{label}: {wrong} tickets wrong or not OK")
    return wrong


def phase_server(dev, index, traffic, answers, sim_cases, failures,
                 per_class=32):
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk
    from repro_torch.serve import QueryServer
    work = [(cls, q, answers[cls][i]) for cls in CLASSES
            for i, q in enumerate(traffic[cls][:per_class])]
    work += [("similar", c, c["answer"]) for c in sim_cases
             if c["k"] == 10 and not c["term"].startswith("unknown")][::3]
    order = np.random.default_rng(5).permutation(len(work))
    work = [work[i] for i in order]
    _reset_counts()                         # the serving path starts here
    srv = QueryServer(index)
    t0 = time.perf_counter()
    tickets = [srv.submit(_ticket_query(cls, q)) for cls, q, _ in work]
    t1 = time.perf_counter()
    srv.run_until_idle()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    launches = dict(segment_reduce=so.launches, **tk.launches_by_stage)
    st = srv.stats()                        # the serving path ends here
    wrong = _check_tickets(tickets, [(c, w) for c, _, w in work],
                           _to_packed, "server", failures)
    degraded = sum(t.telemetry.degraded for t in tickets)
    lat = [t.telemetry.latency * 1e3 for t in tickets]
    info = dict(tickets=len(tickets), wrong=wrong, degraded=degraded,
                stats=st.as_dict(), launches=launches, submit_s=t1 - t0,
                run_s=t2 - t1, tickets_per_s=len(tickets) / (t2 - t0),
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)))
    log(f"  {len(tickets)} tickets in {st.batches} batches over {st.ticks} "
        f"ticks: admission {t1 - t0:.2f} s, run {t2 - t1:.2f} s, "
        f"{info['tickets_per_s']:.1f} tickets/s, latency p50 "
        f"{info['p50_ms']:.1f} ms p99 {info['p99_ms']:.1f} ms; wrong "
        f"{wrong}; host_fallbacks {st.host_fallbacks}, dispatch_retries "
        f"{st.dispatch_retries}, degraded {degraded}; launches {launches}")
    if st.host_fallbacks or st.dispatch_retries or degraded:
        failures.append("server: the fault-free run retried or fell back "
                        "to the host")
    if min(launches.values()) == 0:
        failures.append(f"server: a kernel never launched {launches}")
    return info


def phase_server_faults(dev, postings, sets, seed, failures, chunks=16,
                        n_dense=16, n_sparse=48):
    """Scripted faults on a smaller index (the first ``chunks`` chunks of
    16 dense and 48 sparse terms, on its own arena): one dispatch_raise
    retries once; a slab_mismatch after one postings edit repatches only
    the edited row; dispatch_raise always degrades to the host and still
    answers right."""
    from repro_torch import convert
    from repro_torch.core import BitmapArena
    from repro_torch.data.index import InvertedIndex
    from repro_torch.serve import FakeClock, FaultInjector, QueryServer
    n_words = chunks << 10
    names = [f"d{i}" for i in range(n_dense)] + \
        [f"s{i}" for i in range(n_sparse)]
    small, small_sets = {}, {}
    for t in names:
        keys, kinds, payloads = convert.bitmap_to_parts(postings[t])
        j = int(np.searchsorted(keys, chunks))
        small[t] = convert.bitmap_from_parts(keys[:j], kinds[:j],
                                             payloads[:j])
        s = sets[t]
        small_sets[t] = s[:n_words].copy() if s.dtype == np.uint64 else \
            s[s < n_words * 64]
    index = InvertedIndex.from_postings(
        small, n_words * 64, arena=BitmapArena(capacity=4096, device=dev))
    rng = np.random.default_rng(seed + 6)
    specs = []
    for cls in CLASSES:
        for _ in range(4):
            ts = [str(x) for x in rng.choice(names[:n_dense], 2,
                                             replace=False)] + \
                [str(x) for x in rng.choice(names[n_dense:], 2,
                                            replace=False)]
            q = dict(terms=ts, t=2)
            if cls == "threshold_w":
                q["weights"] = [1, 2, 3, 1]
            specs.append((cls, q))
    for i in range(8):
        specs.append(("similar", dict(term=names[i * 7],
                                      k=1 + i, metric=METRICS[i % 3])))

    def answers(sets_now):
        oracle = Oracle(sets_now, n_words)
        sim = SimOracle(names, sets_now, n_words)
        out = []
        for cls, q in specs:
            if cls == "similar":
                out.append((cls, sim.topk(q["term"], q["k"], q["metric"])))
            else:
                out.append((cls, np.asarray(oracle.answer(cls, q))))
        return out

    def to_packed(bm):
        return _to_packed(bm)[:n_words]

    def run(script, edit=None):
        clock = FakeClock()
        srv = QueryServer(index, clock=clock,
                          faults=FaultInjector.script(script))
        tickets = [srv.submit(_ticket_query(c, q)) for c, q in specs]
        if edit is not None:
            edit()
        srv.run_until_idle()
        return srv.stats(), tickets

    runs = {}
    want = answers(small_sets)
    st, tickets = run({"dispatch_raise": [True]})
    runs["dispatch_raise once"] = dict(
        stats=st.as_dict(), wrong=_check_tickets(
            tickets, want, to_packed, "dispatch_raise once", failures))
    if st.dispatch_retries != 1 or st.host_fallbacks:
        failures.append(f"dispatch_raise once: {st}")

    # one postings edit between admission and dispatch: a new document in
    # an existing bitset chunk of d0 (one container, one arena row)
    doc = int(np.flatnonzero(~np.unpackbits(
        small_sets["d0"].view(np.uint8), bitorder="little").astype(bool))[0])
    edited = dict(small_sets)
    edited["d0"] = small_sets["d0"].copy()
    edited["d0"][doc >> 6] |= np.uint64(1) << np.uint64(doc & 63)
    st, tickets = run({"slab_mismatch": [True]},
                      edit=lambda: index.postings["d0"].add(doc))
    want = answers(edited)
    runs["slab_mismatch after one edit"] = dict(
        stats=st.as_dict(), wrong=_check_tickets(
            tickets, want, to_packed, "slab_mismatch", failures))
    if st.replans != 1 or st.rows_repatched != 1 or st.host_fallbacks:
        failures.append(f"slab_mismatch: {st}")

    st, tickets = run({"dispatch_raise": "always"})
    degraded = sum(t.telemetry.degraded for t in tickets)
    runs["dispatch_raise always"] = dict(
        stats=st.as_dict(), degraded=degraded, wrong=_check_tickets(
            tickets, want, to_packed, "dispatch_raise always", failures))
    if degraded != len(tickets) or st.host_fallbacks < 1:
        failures.append(f"dispatch_raise always: {degraded} degraded, {st}")
    for name, r in runs.items():
        s = r["stats"]
        log(f"  {name:30s} wrong {r['wrong']}  retries "
            f"{s['dispatch_retries']}  replans {s['replans']}  "
            f"rows_repatched {s['rows_repatched']}  host_fallbacks "
            f"{s['host_fallbacks']}"
            + (f"  degraded {r['degraded']}" if "degraded" in r else ""))
    return dict(tickets=len(specs), documents=n_words * 64,
                terms=len(names), runs=runs)


# ---------------------------------------------------------------------------

def _build_all():
    """Build every kernel source at once, one nvcc each, in parallel.
    Returns {source: (seconds, registers, spill stores)}."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def one(name):
        t = time.perf_counter()
        _build.library(name)
        return name, time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES_CU)) as pool:
        done = dict(pool.map(one, SOURCES_CU))
    out = {}
    for name, secs in done.items():
        ptxas = _build.build_logs.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                            ptxas)]
        out[name] = (secs, regs, spill)
        log(f"  {name}: nvcc {secs:.2f} s; " + (
            f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, spill stores up to {max(spill, default=0)} bytes"
            if regs else "library was already built, no report"))
    return out


def _kernel_line(main_path, sim, cases, topk_cases, max_err, topk_err):
    rep = next(c for c in cases if c["case"] == "main/ids/or")
    score = next(c for c in topk_cases
                 if c["case"] == "score/main/jaccard/exclude=-1")
    select = next(c for c in topk_cases if c["case"] == "select/jaccard/k=10")
    src = "src/repro_torch/kernels/csrc/"

    def row(name, source, replaces, launches, err, c):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c.get("library_ms")}

    return {"kernels": [
        # no single PyTorch call computes a segmented bitwise reduce fused
        # with a popcount, nor a segmented AND-popcount fused with a score
        row("segment_reduce", "segment_reduce.cu",
            "src/repro/kernels/segment_ops.py:243", main_path["launches"],
            max_err, dict(rep, library_ms=None)),
        row("similarity_score", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:147", sim["launches"]["score"],
            topk_err, score),
        # times on the device (the profiler), since CUDA events around a
        # loop of launches of microseconds time the host; library_ms:
        # torch.sort(stable, descending)[:k], the same function
        row("similarity_select", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:166", sim["launches"]["select"],
            topk_err, dict(select, ms=select["device_ms"],
                           plain_ms=select["device_plain_ms"],
                           library_ms=select["device_library_ms"]))]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the repository root (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    dev = torch.device("cuda")
    failures: list[str] = []
    t_all = time.perf_counter()
    phases = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phases[name] = time.perf_counter() - t
        log(f"phase {name}: {phases[name]:.1f} s")
        return out

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    builds = phase("1 (build every kernel)", _build_all)
    cases, max_err = phase("2 (segment_reduce against plain)",
                           phase_kernels, dev, args.seed, failures)
    log(f"  {len(cases)} cases, max_abs_err {max_err}")
    topk_cases, topk_err, topk_info = phase(
        "2b (score and select against plain)", phase_topk_kernels, dev,
        args.seed, failures)
    log(f"  {len(topk_cases)} cases, max_abs_err {topk_err}")
    main_path, ctx = phase("3 (boolean queries at real scale)",
                           phase_main_path, dev, args.seed, failures)
    sim, sim_cases = phase("4 (similarity at real scale)",
                           phase_similarity, dev, ctx["index"],
                           ctx["sets"], args.seed, failures)
    server = phase("5 (query server)", phase_server, dev, ctx["index"],
                   ctx["traffic"], ctx["answers"], sim_cases, failures)
    server["faults"] = phase("5 (query server under scripted faults)",
                             phase_server_faults, dev, ctx["postings"],
                             ctx["sets"], args.seed, failures)

    kernels = _kernel_line(main_path, sim, cases, topk_cases, max_err,
                           topk_err)
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(dict(
        card=card, builds=builds, kernel_cases=cases,
        topk_cases=topk_cases, topk_inputs=topk_info, main_path=main_path,
        similarity=sim, server=server, kernels=kernels["kernels"],
        phases_s=phases, failures=failures,
        total_s=time.perf_counter() - t_all), indent=1, default=str))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
