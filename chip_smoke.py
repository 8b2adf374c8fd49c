#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository; it needs one CUDA device and the CUDA
toolkit (``nvcc``).  Phases, each timed:

1. Device and build: the card's name and power limit, and the time to
   build ``src/repro_torch/kernels/csrc/segment_reduce.cu`` with nvcc.
2. Kernel against plain: every row source (slab, ids, dual) x op (or, and,
   xor, andnot, threshold, weighted threshold) at the main path's shapes
   (256 segments, about 10^5 rows) and at small edge cases; words must be
   bit-identical to the plain PyTorch version on the card and cards equal.
   Kernel, plain and bytes-bound times are printed.
3. The main path at real scale: an ``InvertedIndex`` over 2^24 documents
   and 1,024 terms on a ``BitmapArena`` on the card (64 dense bitset
   terms, 960 sparse array terms), 64 queries of each boolean class run
   one at a time and coalesced through ``aggregate.execute_plans``, every
   answer checked against an independent numpy oracle; then the two other
   kernel front ends (cold staged rows, no arena).  Launch counts are set
   to 0 before this phase and read after it.
4. One JSON line with the kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

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


def log(msg: str) -> None:
    print(msg, flush=True)


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
# phase 3: the main path at real scale
# ---------------------------------------------------------------------------

def _dense_words(dev, gen, p):
    """(N_DOCS / 64,) uint64 words of independent random bits of density
    ``p``, drawn on the card."""
    bits = torch.rand(N_DOCS, device=dev, generator=gen) < p
    shifted = bits.view(-1, 64).to(torch.int64) << torch.arange(64,
                                                                device=dev)
    return shifted.sum(dim=1).cpu().numpy().view(np.uint64)


def _packed(values):
    words = np.zeros(N_DOCS // 64, np.uint64)
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
    """Independent numpy answers from packed 2^24-bit document sets."""

    def __init__(self, sets):
        self._src = sets
        self._packed = {}

    def words(self, term):
        w = self._packed.get(term)
        if w is None:
            src = self._src[term]
            w = src if src.dtype == np.uint64 else _packed(src)
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
        cnt = np.zeros(N_DOCS, np.uint8)
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


def _device_busy_us(prof):
    """Sum of device-side event durations (kernels and copies), and of the
    segment_reduce kernels alone, in microseconds."""
    busy = kern = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.time_range.elapsed_us()
            busy += d
            if "reduce_kernel" in e.name or "threshold_kernel" in e.name:
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

    so.reset_launches()                     # the main path starts here
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
        busy_us, kern_us = _device_busy_us(prof)
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
    launches = so.launches                  # the main path ends here
    by_source = dict(so.launches_by_source)
    info.update(classes=classes, fronts=fronts, launches=launches,
                launches_by_source=by_source)
    return info


# ---------------------------------------------------------------------------

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
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    failures: list[str] = []
    t_all = time.perf_counter()

    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    t_build = time.perf_counter()
    _build.library("segment_reduce")
    build_s = time.perf_counter() - t_build
    ptxas = _build.build_logs.get("segment_reduce", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
    spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas)]
    log(f"  ptxas: {len(regs)} kernels, {min(regs, default=0)}-"
        f"{max(regs, default=0)} registers, spill stores up to "
        f"{max(spill, default=0)} bytes" if regs else
        "  ptxas: library was already built, no report")
    log(f"phase 1 (device and build): nvcc build {build_s:.2f} s; "
        f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    cases, max_err = phase_kernels(dev, args.seed, failures)
    log(f"phase 2 (kernel against plain, {len(cases)} cases, "
        f"max_abs_err {max_err}): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    main_path = phase_main_path(dev, args.seed, failures)
    log(f"phase 3 (main path at real scale): "
        f"{time.perf_counter() - t:.1f} s")

    rep = next(c for c in cases if c["case"] == "main/ids/or")
    kernels = {"kernels": [{
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_ops.py:243",
        "launches": main_path["launches"], "max_abs_err": max_err,
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        # no single PyTorch call computes a segmented bitwise reduce fused
        # with a popcount
        "library_ms": None}]}
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(dict(
        card=card, build_s=build_s, registers=regs, spill_stores=spill,
        kernel_cases=cases,
        main_path=main_path, kernels=kernels["kernels"],
        failures=failures, total_s=time.perf_counter() - t_all),
        indent=1, default=str))
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
