"""Wide-aggregation planner: K-bitmap OR/AND/XOR/ANDNOT/threshold, one
kernel launch per op class.

The port of the JAX package's ``core/aggregate.py``.  The
paper's wide union (section 5.8, ``roaring_bitmap_or_many``) streams
containers through an in-register accumulator; sections 4.1.2 and 5.9 ask
for the logical op and the population count in the same pass.  Kaser &
Lemire extend wide aggregation past OR/AND ("Compressed bitmap indexes:
beyond unions and intersections") and to T-occurrence queries ("Threshold
and Symmetric Functions over Bitmaps").

The planner walks the K input bitmaps' key lists once and groups containers
by 16-bit chunk key.  Each key is then either

  * a **pass-through** -- singleton keys (OR/XOR) are shared zero-copy;
    full-chunk runs short-circuit OR; groups a host fast path can finish
    cheaply stay on the host: run-only groups reduce with a vectorized
    boundary sweep at interval granularity, array-only XOR/threshold
    groups count occurrences with bincount, small all-array unions
    concatenate, and AND anchors on the smallest member with vectorized
    membership filtering;
  * or a **slab segment** -- every remaining container becomes a 2048-word
    row (array containers of one OR/XOR group collapse into a single
    indicator row first, unless they are arena-resident), and one
    ``kernels.ops.segment_reduce*`` launch produces each segment's reduced
    words fused with its cardinality.

Kernel results are repacked via ``optimize`` (run_optimize semantics), so
the output uses the memory-optimal container kind per chunk.

With an ``arena`` (core/arena.py), resident containers plan as slab row
ids: the kernel gathers them from the device slab, and only cold rows are
staged per call.  Every entry point runs on ``device`` ("cuda" unless the
caller passes another; with an arena, the arena's device).
``execute_plan_host`` is the numpy-only route the query server degrades
to.

**Sharded path.**  With a ``dist.WideMesh`` of S > 1 shards (``mesh=``, or
installed with ``set_default_mesh``), each slab segment's rows go
round-robin to the shards (``_shard_plan``), every shard runs the same
segmented reduce on its rows, and the partials fold on the mesh's first
device by the JAX package's exchange rules:

  * OR / XOR partials fold with the op (both are associative and
    commutative over disjoint row sets);
  * ANDNOT replicates the minuend on every shard, so the local partials
    ``a & ~local_or`` fold with AND: ``(a & ~x) & (a & ~y) == a & ~(x|y)``;
  * AND exchanges an occupancy mask with the partials: a shard holding no
    rows of a segment contributes all ones (the kernel's empty-segment
    zeros would be wrong to fold), and a segment no shard holds is empty;
  * threshold exchanges bit-sliced occurrence counters
    (``kernels.ops.segment_counters``), added across shards before one
    comparator pass.

With an arena, every shard reads its resident rows from the arena's
per-shard slabs through their positions (``ShardSlabs``), and only cold
rows ride a small staged block whose row 0 is zero, so a warm sharded
aggregate moves ids to the card and no container rows.  The JAX package
runs each shard inside ``shard_map`` and all-gathers the partials; the port
launches each shard in turn from one process and gathers them with
``.to()``.  A one-shard mesh takes the single-device path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.core.containers import (
    ARRAY_MAX, CHUNK, ArrayContainer, BitsetContainer, Container,
    RunContainer, optimize,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import WORDS
from repro_torch.kernels.segment_ops import counter_planes

__all__ = ["or_many", "and_many", "xor_many", "andnot_many",
           "threshold_many", "set_default_mesh", "WidePlan", "plan_wide",
           "execute_plans", "execute_plan_host"]


def set_default_mesh(mesh) -> None:
    """Install the mesh of every wide aggregate not given ``mesh=`` (None
    restores the single-device path).  It is stored in ``dist.ctx``, so
    this and ``ctx.set_wide_mesh`` / ``ctx.install_wide_mesh`` are one."""
    from repro_torch.dist import ctx
    ctx.set_wide_mesh(mesh)


def _resolve_mesh(mesh):
    from repro_torch.dist import ctx
    return ctx.resolve_wide(mesh)[0]


def _mesh_size(mesh) -> int:
    from repro_torch.dist import ctx
    return ctx.resolve_wide(mesh)[1]


def _bitmap_cls():
    from repro_torch.core.bitmap import RoaringBitmap  # bitmap imports us
    return RoaringBitmap


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _group(bitmaps) -> dict[int, list[Container]]:
    groups: dict[int, list[Container]] = {}
    for bm in bitmaps:
        for k, c in zip(bm.keys, bm.containers):
            groups.setdefault(k, []).append(c)
    return groups


def _build(merged: dict[int, Container]):
    RB = _bitmap_cls()
    keys = sorted(merged)
    return RB(keys, [merged[k] for k in keys])


def _full_run() -> RunContainer:
    return RunContainer(np.array([[0, CHUNK - 1]], np.int32))


def _is_full(c: Container) -> bool:
    """card == 2^16 without touching the O(runs) card property."""
    if isinstance(c, RunContainer):
        return (c.runs.shape[0] == 1 and int(c.runs[0, 0]) == 0
                and int(c.runs[0, 1]) == CHUNK - 1)
    return c.card == CHUNK


# ---------------------------------------------------------------------------
# promotion helpers (host side of the slab)
# ---------------------------------------------------------------------------

_words_row = C.container_words64      # container -> (1024,) uint64 words


def _array_indicator(arrays: list[ArrayContainer], op: str) -> np.ndarray:
    """(CHUNK,) 0/1 indicator of the OR / XOR of the group's arrays.

    OR: duplicate values across members are harmless, so plain indicator
    stores suffice.  XOR: the parity of the occurrence counts (bincount is
    a counting sort: O(values), no comparison sort)."""
    vals = arrays[0].values if len(arrays) == 1 else \
        np.concatenate([a.values for a in arrays])
    if op == "or" or len(arrays) == 1:
        ind = np.zeros(CHUNK, np.uint8)
        ind[vals] = 1
        return ind
    return (np.bincount(vals, minlength=CHUNK) & 1).astype(np.uint8)


def _indicator_row(arrays: list[ArrayContainer], op: str) -> np.ndarray:
    """Collapse every array container of one group into a single bitset
    row of the slab."""
    return np.packbits(_array_indicator(arrays, op),
                       bitorder="little").view(np.uint64)


def _row_ref(c: Container, arena):
    """Slab-row reference for one container: the arena row id (int) when
    the container is resident, else its promoted (1024,) uint64 words.
    ``_dispatch`` gathers int refs on-device (zero PCIe) and stages only
    the ndarray refs per call (see core/arena.py)."""
    if arena is not None:
        rid = arena.lookup(c)
        if rid is not None:
            return rid
    return _words_row(c)


def _array_rows(arrays: list[ArrayContainer], op: str, arena) -> list:
    """Slab rows for one group's array containers.  Without an arena the
    group collapses into a single indicator row (host bincount).  With an
    arena, resident arrays keep their individual device rows -- reducing
    them row-wise is bit-identical to the collapsed indicator for "or" /
    "xor" (parity per value is associative) -- and only the cold remainder
    collapses into one staged indicator row."""
    if not arrays:
        return []
    if arena is None:
        return [_indicator_row(arrays, op)]
    rows: list = []
    cold: list[ArrayContainer] = []
    for a in arrays:
        rid = arena.lookup(a)
        if rid is not None:
            rows.append(rid)
        else:
            cold.append(a)
    if cold:
        rows.append(_indicator_row(cold, op))
    return rows


def _from_indicator(ind: np.ndarray) -> Container | None:
    """(CHUNK,) 0/1 indicator -> optimal container (None when empty)."""
    card = int(ind.sum())
    if card == 0:
        return None
    if card <= ARRAY_MAX:
        return optimize(ArrayContainer(np.flatnonzero(ind).astype(np.uint16)))
    words = np.packbits(ind.astype(np.uint8),
                        bitorder="little").view(np.uint64)
    return optimize(BitsetContainer(words, card))


def _count_arrays(arrays: list[ArrayContainer], op: str,
                  t: int) -> Container | None:
    """All-array group fast path: occurrence counting via bincount, entirely
    on the host.  op "xor" keeps odd counts, "threshold" counts >= t."""
    vals = arrays[0].values if len(arrays) == 1 else \
        np.concatenate([a.values for a in arrays])
    cnt = np.bincount(vals, minlength=CHUNK)
    ind = (cnt & 1) if op == "xor" else (cnt >= t)
    return _from_indicator(ind.astype(np.uint8))


_SUB = np.int64(1) << 40        # andnot sweep: subtrahend coverage marker


def _sweep_run_groups(run_groups: list[tuple], op: str,
                      t: int) -> dict[int, Container]:
    """Run-only groups, ALL reduced in one vectorized boundary sweep at
    *interval* granularity (never expanding to 2^16 bits) -- the host twin
    of the slab's single dispatch.

    Each group is ``(key, containers)`` or ``(key, containers, weights)``;
    runs are lifted into a global coordinate space (``key << 16 | start``);
    chunks never overlap, so one sweep serves every group.  Each member's
    runs are disjoint, hence the (weighted) coverage count over an
    elementary interval equals the summed weight of members containing it:
    OR is count >= 1, AND count == K (per group), XOR odd count, threshold
    count >= t.  ANDNOT weights the minuend (the FIRST container of each
    group) 1 and every subtrahend ``_SUB``, keeping intervals with coverage
    exactly 1.  ``run_groups`` must be key-sorted."""
    out: dict[int, Container] = {}
    if not run_groups:
        return out
    starts_l, ends_l, delta_l = [], [], []
    for grp in run_groups:
        k, conts = grp[0], grp[1]
        wts = grp[2] if len(grp) > 2 else None
        if op == "andnot":
            wts = [1] + [_SUB] * (len(conts) - 1)
        r = conts[0].runs if len(conts) == 1 else \
            np.concatenate([c.runs for c in conts])
        if wts is not None:                 # weighted / andnot groups only
            delta_l.append(np.repeat(np.asarray(wts, np.int64),
                                     [c.runs.shape[0] for c in conts]))
        s = r[:, 0].astype(np.int64) + (np.int64(k) << 16)
        starts_l.append(s)
        ends_l.append(s + r[:, 1] + 1)                  # exclusive
    starts = np.concatenate(starts_l)
    ends = np.concatenate(ends_l)
    if delta_l:
        wdelta = np.concatenate(delta_l)
    else:
        wdelta = np.ones(starts.size, np.int64)
    pts = np.concatenate((starts, ends))
    delta = np.concatenate((wdelta, -wdelta))
    order = np.argsort(pts, kind="stable")
    upts, first = np.unique(pts[order], return_index=True)
    cov = np.cumsum(np.add.reduceat(delta[order], first))[:-1]  # / interval
    if op == "or":
        keep = cov >= 1
    elif op == "xor":
        keep = (cov & 1) == 1
    elif op == "and":
        gk = np.array([g[0] for g in run_groups], np.int64)
        gn = np.array([len(g[1]) for g in run_groups], np.int64)
        need = gn[np.searchsorted(gk, upts[:-1] >> 16)]
        keep = cov >= need                 # gap intervals have cov 0 < need
    elif op == "andnot":
        keep = cov == 1                    # minuend present, no subtrahend
    else:
        keep = cov >= t
    lo, hi = upts[:-1][keep], upts[1:][keep]
    if lo.size == 0:
        return out
    # merge contiguous intervals, but never across a chunk-key border
    same_key = (lo[1:] >> 16) == ((hi[:-1] - 1) >> 16)
    brk = np.concatenate(([True], (lo[1:] > hi[:-1]) | ~same_key))
    si = np.flatnonzero(brk)
    ei = np.concatenate((si[1:] - 1, [lo.size - 1]))
    rlo, rhi = lo[si], hi[ei]
    rkey = rlo >> 16
    runs_all = np.stack([rlo - (rkey << 16), rhi - 1 - rlo],
                        axis=1).astype(np.int32)
    uk, kfirst = np.unique(rkey, return_index=True)
    bounds = np.concatenate((kfirst, [rkey.size]))
    for i, k in enumerate(uk.tolist()):
        out[int(k)] = optimize(RunContainer(runs_all[bounds[i]:bounds[i + 1]]))
    return out


def _member_mask(vals: np.ndarray, c: Container) -> np.ndarray:
    """Boolean membership of the sorted uint16 ``vals`` in container ``c``
    (the AND / ANDNOT fast paths' vectorized membership probe)."""
    if isinstance(c, BitsetContainer):
        return C.bitset_test_many(c.words, vals)
    if isinstance(c, ArrayContainer):
        if c.values.size == 0:
            return np.zeros(vals.size, bool)
        idx = np.searchsorted(c.values, vals)
        idx[idx == c.values.size] = c.values.size - 1
        return c.values[idx] == vals
    starts = c.runs[:, 0]
    v = vals.astype(np.int32)
    i = np.searchsorted(starts, v, side="right") - 1
    i_c = np.maximum(i, 0)
    return (i >= 0) & (v <= starts[i_c] + c.runs[i_c, 1])


def _filter_values(vals: np.ndarray, c: Container) -> np.ndarray:
    """Keep the sorted uint16 ``vals`` that are members of ``c``."""
    if vals.size == 0:
        return vals
    return vals[_member_mask(vals, c)]


def _filter_values_out(vals: np.ndarray, c: Container) -> np.ndarray:
    """Keep the sorted uint16 ``vals`` that are NOT members of ``c``."""
    if vals.size == 0:
        return vals
    return vals[~_member_mask(vals, c)]


# ---------------------------------------------------------------------------
# the single kernel dispatch
# ---------------------------------------------------------------------------

def _planes_for(totals: list[int], threshold: int) -> int:
    """Bit-sliced counter width for a threshold dispatch: wide enough for
    the largest attainable per-segment count AND for every bit of ``t``
    (the comparator reads t bit-by-bit; truncating high bits would compare
    against t mod 2^planes)."""
    return max(counter_planes(max(totals)), int(threshold).bit_length())


def _repack_segments(seg_keys, words: torch.Tensor,
                     cards: torch.Tensor) -> dict[int, Container]:
    """(words, card) per segment -> optimal container kind per chunk.
    Only the words of non-empty segments come back from the device."""
    out: dict[int, Container] = {}
    cards = cards.cpu().numpy()
    live = np.flatnonzero(cards)
    if live.size == 0:
        return out
    if live.size < cards.size:
        words = words[torch.from_numpy(live).to(words.device)]
    w64 = words.cpu().numpy().view(np.uint64)     # (live, 1024)
    for i, j in enumerate(live.tolist()):
        # each container owns its words, not a view of the batch
        out[seg_keys[j]] = optimize(
            C._result_from_bitset(w64[i].copy(), int(cards[j])))
    return out


def _dispatch(seg_keys: list, seg_rows: list[list], op: str, threshold,
              backend, device: torch.device,
              seg_weights: list[list[int]] | None = None,
              arena=None, mesh=None) -> dict:
    """Reduce every pending segment in one kernel launch per depth bucket
    and repack each segment's (words, card) into the optimal container kind.
    With a mesh of more than one shard, the rows shard across it instead
    (``_shard_reduce`` / ``_shard_reduce_arena``).

    ``seg_keys`` are opaque hashable identities (plain chunk keys for one
    query; ``(query, chunk-key)`` tuples on the coalesced multi-query
    path).  ``threshold`` is an int, or -- for op "threshold" -- a
    per-segment sequence aligned with ``seg_keys`` (each coalesced query
    carries its own T into the same launch).  With an ``arena``, row
    entries may be int slab-row ids: those are read from the resident
    device slab, and only ndarray rows are staged per call."""
    if not seg_keys:
        return {}
    tvec = None if isinstance(threshold, (int, np.integer)) else \
        [int(x) for x in threshold]

    def _t(i: int) -> int:
        return tvec[i] if tvec is not None else threshold

    # peel single-row segments: reducing one row is the identity (a lone
    # minuend for "andnot"; for "threshold" the row survives iff its own
    # weight reaches t), so a host popcount beats staging the row for a
    # launch.  Arena-resident singletons (int row ids) are NOT peeled:
    # their words are already on the device.
    peeled: dict = {}
    keep = [i for i, rows in enumerate(seg_rows)
            if len(rows) > 1 or not isinstance(rows[0], np.ndarray)]
    if len(keep) != len(seg_keys):
        for i, (key, rows) in enumerate(zip(seg_keys, seg_rows)):
            if len(rows) != 1 or not isinstance(rows[0], np.ndarray):
                continue
            if op == "threshold" and \
                    (seg_weights[i][0] if seg_weights else 1) < _t(i):
                continue
            card = int(np.bitwise_count(rows[0]).sum())
            if card:
                peeled[key] = optimize(C._result_from_bitset(rows[0], card))
        seg_keys = [seg_keys[i] for i in keep]
        seg_rows = [seg_rows[i] for i in keep]
        if seg_weights is not None:
            seg_weights = [seg_weights[i] for i in keep]
        if tvec is not None:
            tvec = [tvec[i] for i in keep]
        if not seg_keys:
            return peeled
    mesh = _resolve_mesh(mesh)
    if mesh is not None and _mesh_size(mesh) > 1:
        lens = [len(r) for r in seg_rows]
        tmax = max(tvec) if tvec is not None else threshold
        planes = None
        if op == "threshold" and seg_weights is not None:
            planes = _planes_for([sum(w) for w in seg_weights], tmax)
        t_arg = threshold if tvec is None else tvec
        if arena is not None:
            words, cards = _shard_reduce_arena(
                arena, seg_rows, lens, seg_weights, op, t_arg, backend,
                mesh, planes=planes, tmax=tmax)
        else:
            slab64 = np.stack([w for rows in seg_rows for w in rows])
            words, cards = _shard_reduce(
                torch.from_numpy(slab64.view(np.int32).reshape(-1, WORDS)),
                lens, seg_weights, op, t_arg, backend, mesh, planes=planes,
                tmax=tmax)
        peeled.update(_repack_segments(seg_keys, words, cards))
        return peeled
    # bucket segments by depth: one deep segment would otherwise set the
    # counter width (planes, from jmax) of every shallow coalesced
    # threshold segment, and the plain version's (S, jmax, WORDS) gather.
    # Small batches stay in ONE launch, where extra launches cost more
    # than they save.  (The kernel walks each segment's own length, and,
    # unlike the JAX package, nothing pads rows or segments to powers of
    # two: there is no per-shape compilation to reuse.)
    by_depth: dict[int, list[int]] = {}
    if len(seg_rows) >= 64:
        for i, rows in enumerate(seg_rows):
            by_depth.setdefault(_pow2(len(rows)), []).append(i)
    else:
        by_depth[_pow2(max(len(r) for r in seg_rows))] = \
            list(range(len(seg_rows)))
    for jmax, idxs in sorted(by_depth.items()):
        rows_g = [seg_rows[i] for i in idxs]
        lens = [len(r) for r in rows_g]
        wts_g = None if seg_weights is None else \
            [seg_weights[i] for i in idxs]
        tv_g = None if tvec is None else [tvec[i] for i in idxs]
        planes = None
        wbits = 1
        if op == "threshold" and wts_g is not None:
            planes = _planes_for([sum(w) for w in wts_g],
                                 max(tv_g) if tv_g is not None
                                 else threshold)
            wbits = max(int(w).bit_length() for ws in wts_g for w in ws)
        t_arg = threshold if tv_g is None else \
            torch.tensor(tv_g, dtype=torch.int32).to(device)
        starts = np.zeros(len(lens) + 1, np.int32)
        starts[1:] = np.cumsum(lens)
        starts_t = torch.from_numpy(starts).to(device)
        weights = None
        if wts_g is not None:
            weights = torch.from_numpy(np.concatenate(
                [np.asarray(w, np.int32) for w in wts_g])).to(device)
        kw = dict(jmax=jmax, threshold=t_arg, weights=weights,
                  planes=planes, wbits=wbits, backend=backend)
        if arena is None:
            slab64 = np.stack([w for rows in rows_g for w in rows])
            slab = torch.from_numpy(
                slab64.view(np.int32).reshape(-1, WORDS)).to(device)
            words, cards = kops.segment_reduce(slab, starts_t, op, **kw)
        else:
            pos, sidx, staged = _stage_arena_rows(arena, rows_g)
            if staged is None:              # warm: pure resident gather
                words, cards = kops.segment_reduce_rows(
                    arena.device_slab(), pos, starts_t, op, **kw)
            else:
                words, cards = kops.segment_reduce_rows_dual(
                    arena.device_slab(), staged, pos, sidx, starts_t, op,
                    **kw)
        peeled.update(_repack_segments([seg_keys[i] for i in idxs], words,
                                       cards))
    return peeled


def _stage_arena_rows(arena, rows_g: list[list]):
    """Turn one depth bucket's row refs into dual-source gather inputs
    ``(pos, sidx, staged)`` on the arena's device: resident ids index the
    arena's device slab by position, cold ndarray rows stage into a small
    host block (row 0 reserved zero) indexed by ``sidx``.  Exactly one side
    of each slot is a real row and the other a zero row, so
    ``table[pos] | staged[sidx]`` is exact slot selection and the resident
    slab is never copied per call.  Warm queries return ``staged=None``
    (and ``sidx=None``): the only host->device traffic is ``pos``."""
    pos: list[int] = []
    sidx: list[int] = []
    host: list[np.ndarray] = []
    for rows in rows_g:
        for r in rows:
            if isinstance(r, np.ndarray):
                pos.append(0)               # arena row 0: reserved zero
                sidx.append(1 + len(host))
                host.append(r)
            else:
                pos.append(int(r))
                sidx.append(0)              # staged row 0: reserved zero
    dev = arena.device
    staged = sidx_t = None
    if host:
        hb = np.zeros((1 + len(host), 1024), np.uint64)
        hb[1:] = np.stack(host)
        staged = torch.from_numpy(
            hb.view(np.int32).reshape(-1, WORDS)).to(dev)
        sidx_t = torch.tensor(sidx, dtype=torch.int32).to(dev)
        arena.stats.host_rows_staged += len(host)
    arena.stats.device_gathers += 1
    return torch.tensor(pos, dtype=torch.int32).to(dev), sidx_t, staged


# ---------------------------------------------------------------------------
# the sharded dispatch
# ---------------------------------------------------------------------------

def _shard_plan(seg_sizes: list[int], d: int, op: str,
                seg_weights: list[list[int]] | None):
    """Round-robin each segment's rows across ``d`` shards.

    Returns per shard (row ids into the segment-major slab, per-row
    weights, segment starts); every shard sees the SAME segment structure
    (some local segments may be empty -> the kernel's identity).  For
    "andnot" the minuend (each segment's row 0) is REPLICATED on every
    shard so the local partials ``a & ~local_or`` fold with AND."""
    ids = [[] for _ in range(d)]
    wts = [[] for _ in range(d)]
    starts = [[0] for _ in range(d)]
    base = 0
    for si, nrow in enumerate(seg_sizes):
        w = None if seg_weights is None else seg_weights[si]
        for dev in range(d):
            if op == "andnot":
                mine = [base] + list(range(base + 1 + dev, base + nrow, d))
                mw = [1] * len(mine)
            else:
                mine = list(range(base + dev, base + nrow, d))
                mw = [1] * len(mine) if w is None else \
                    [w[i - base] for i in mine]
            ids[dev].extend(mine)
            wts[dev].extend(mw)
            starts[dev].append(len(ids[dev]))
        base += nrow
    return ids, wts, starts


def _shard_planes(op, planes, seg_sizes, seg_weights, threshold, tmax):
    """The counter width of a sharded threshold: wide enough for the
    total weight of a segment over every shard, and for every bit of T."""
    if op != "threshold" or planes is not None:
        return planes
    return _planes_for(seg_sizes if seg_weights is None else
                       [sum(w) for w in seg_weights],
                       tmax if tmax is not None else threshold)


def _shard_partial(op, starts, jmax, planes, weights, reduce, rows):
    """One shard's contribution: bit-sliced counters of ``rows()`` for
    "threshold"; else the words of ``reduce(op)`` (the segmented kernel),
    with, for "and", the all-ones identity in the shard's empty segments
    and its occupancy mask."""
    if op == "threshold":
        return kops.segment_counters(rows(), starts, jmax=jmax,
                                     planes=planes, weights=weights)
    pw, _ = reduce(op)
    if op == "and":
        occ = (starts[1:] - starts[:-1]) > 0
        return torch.where(occ[:, None], pw, -1), occ
    return pw


def _fold(op, partials: list, threshold, merge: torch.device):
    """Fold the shards' partials on ``merge`` into (words (S, WORDS),
    cards (S,)), by the exchange rules of the module docstring."""
    if op == "threshold":
        tot = partials[0].to(merge)
        for p in partials[1:]:
            tot = kref.bitsliced_add(tot, p.to(merge))
        t = threshold if isinstance(threshold, (int, np.integer)) else \
            torch.tensor(threshold, dtype=torch.int32, device=merge)
        words = kref.counters_ge(tot, t)
    elif op == "and":
        words, occ = (x.to(merge) for x in partials[0])
        for pw, po in partials[1:]:
            words = words & pw.to(merge)
            occ = occ | po.to(merge)
        words = torch.where(occ[:, None], words, 0)
    else:
        words = partials[0].to(merge)
        for pw in partials[1:]:
            pw = pw.to(merge)
            words = words | pw if op == "or" else \
                words ^ pw if op == "xor" else words & pw
    return words, kref._popcount_rows(words)


def _upload(dev, *arrays) -> list[torch.Tensor]:
    """Int arrays to ``dev`` as int32 in one copy; a tensor view each."""
    arrays = [np.asarray(a, np.int64) for a in arrays]
    both = torch.from_numpy(np.concatenate(arrays).astype(np.int32)).to(dev)
    return both.split([a.size for a in arrays])


def _jmax(starts: list[int]) -> int:
    return max(1, int(np.diff(starts).max(initial=1)))


def _shard_reduce(slab: torch.Tensor, seg_sizes: list[int],
                  seg_weights: list[list[int]] | None, op: str, threshold,
                  backend, mesh, planes: int | None = None,
                  tmax: int | None = None):
    """Sharded segmented reduce of rows without an arena: split the rows
    of ``slab`` (N, WORDS) int32, segment-major, across the mesh
    (``_shard_plan``), copy each shard's rows to its device, reduce them
    with the segmented kernel, and fold the partials (``_fold``).  Returns
    (words (S, WORDS), cards (S,)) on the mesh's first device, the
    single-device plan's bits."""
    devices = mesh.devices
    ids, wts, starts = _shard_plan(seg_sizes, len(devices), op, seg_weights)
    planes = _shard_planes(op, planes, seg_sizes, seg_weights, threshold,
                           tmax)
    partials = []
    for dev, ids_d, w_d, st_d in zip(devices, ids, wts, starts):
        (sel,) = _upload(slab.device, ids_d)
        rows = slab.index_select(0, sel.long()).to(dev)
        w_t, st_t = _upload(dev, w_d, st_d)
        jmax = _jmax(st_d)
        partials.append(_shard_partial(
            op, st_t, jmax, planes, w_t,
            lambda o: kops.segment_reduce(rows, st_t, o, jmax=jmax,
                                          backend=backend),
            lambda: rows))
    return _fold(op, partials, threshold, devices[0])


def _shard_reduce_arena(arena, seg_rows: list[list], seg_sizes: list[int],
                        seg_weights: list[list[int]] | None, op: str,
                        threshold, backend, mesh, planes: int | None = None,
                        tmax: int | None = None):
    """Sharded segmented reduce over arena row refs: the routing and the
    folds of ``_shard_reduce``, with every shard reading its resident rows
    from the arena's per-shard slabs through their positions
    (``ShardSlabs.assembled``; ids cross to the card, never container
    words) and its cold rows from a small staged block whose row 0 is
    zero, so ``table[pos] | staged[sidx]`` selects each slot's one real
    row.  A cold slot's position is 0, the arena's reserved zero row.
    Where the shards sit on distinct devices each shard's resident rows
    are gathered to its device first (``ShardSlabs.gather``)."""
    shards = arena.shard_slabs(mesh)
    devices = mesh.devices
    ids, wts, starts = _shard_plan(seg_sizes, len(devices), op, seg_weights)
    planes = _shard_planes(op, planes, seg_sizes, seg_weights, threshold,
                           tmax)
    flat = [r for rows in seg_rows for r in rows]
    pos = np.zeros(len(flat), np.int64)
    sidx = np.zeros(len(flat), np.int64)
    rid = np.full(len(flat), -1, np.int64)      # resident slots' row ids
    host: list[np.ndarray] = []
    for i, r in enumerate(flat):
        if isinstance(r, np.ndarray):
            sidx[i] = 1 + len(host)         # staged row 0: reserved zero
            host.append(r)
        else:
            rid[i] = r
    res = rid >= 0
    if res.any() and not shards.distinct:
        pos[res] = shards.positions(rid[res])
    hb = None
    if host:
        hb = np.zeros((1 + len(host), 1024), np.uint64)
        hb[1:] = np.stack(host)
        hb = torch.from_numpy(hb.view(np.int32).reshape(-1, WORDS))
        arena.stats.host_rows_staged += len(host)
    for st in shards.stats:
        st.device_gathers += 1
    # one device: every shard reads the one buffer and one staged block;
    # distinct devices: each shard's rows gathered to it (ShardSlabs.gather)
    table = None if shards.distinct else shards.assembled()
    staged = None if hb is None or shards.distinct else hb.to(shards.device)
    partials = []
    for d, (dev, ids_d, w_d, st_d) in enumerate(zip(devices, ids, wts,
                                                    starts)):
        sel = np.asarray(ids_d, np.int64)
        pos_d = pos[sel]
        if shards.distinct:
            mine = np.flatnonzero(res[sel])
            table, pos_d[mine] = shards.gather(rid[sel[mine]], dev, d)
            staged = None if hb is None else hb.to(dev)
        pos_t, sidx_t, w_t, st_t = _upload(dev, pos_d, sidx[sel], w_d,
                                           st_d)
        jmax = _jmax(st_d)
        if staged is None:
            def reduce(o):
                return kops.segment_reduce_rows(table, pos_t, st_t, o,
                                                jmax=jmax, backend=backend)

            def rows():
                return table[pos_t.long()]
        else:
            def reduce(o):
                return kops.segment_reduce_rows_dual(
                    table, staged, pos_t, sidx_t, st_t, o, jmax=jmax,
                    backend=backend)

            def rows():
                return kref.gather_rows_dual(table, staged, pos_t, sidx_t)
        partials.append(_shard_partial(op, st_t, jmax, planes, w_t, reduce,
                                       rows))
    return _fold(op, partials, threshold, devices[0])


# ---------------------------------------------------------------------------
# query plans: planning separated from dispatch so N queries can coalesce
# into ONE launch per op class
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WidePlan:
    """One wide aggregate, planned but not yet dispatched.

    ``merged`` holds every chunk the host fast paths already resolved
    (zero-copy pass-throughs, run sweeps, bincount groups); ``seg_keys`` /
    ``seg_rows`` describe the dense remainder awaiting the slab kernel.
    ``execute_plans`` coalesces many plans into one ``segment_reduce``
    launch per op class -- a query id is just another segment coordinate --
    and ``execute_plan_host`` is the numpy-only version the query server
    degrades to when a kernel batch keeps failing (the same rows and the
    same repack, so the same result).

    With an ``arena`` (core/arena.py), ``seg_rows`` entries may be int
    device-slab row ids instead of promoted uint64 rows: those never
    cross to the device at dispatch.  ``device`` is where the plan's
    kernel runs (the arena's device when there is one).
    ``execute_plans`` only coalesces plans that share the same arena (or
    its absence) and device."""
    op: str                               # dispatch class (OPS member)
    threshold: int                        # per-plan T (0 off-threshold)
    merged: dict[int, Container]          # host-resolved chunks
    seg_keys: list[int]                   # chunk key per pending segment
    seg_rows: list[list]                  # uint64 row | arena row id each
    seg_weights: list[list[int]] | None = None
    arena: object | None = None           # BitmapArena owning the id rows
    device: torch.device | None = None    # where the pending rows reduce

    def slab_bytes(self) -> int:
        """Bytes this plan adds to a coalesced slab (the admission queue's
        max-bytes accounting)."""
        return sum(len(r) for r in self.seg_rows) * 8192


def plan_wide(op: str, bitmaps, t: int = 0, weights=None, *,
              backend: str | None = None, arena=None,
              device=None) -> WidePlan:
    """Plan one wide aggregate without dispatching it.

    ``op`` is "or" | "and" | "xor" | "andnot" | "threshold"; for "andnot"
    the FIRST bitmap is the minuend and the rest are subtrahends; for
    "threshold", ``t`` / ``weights`` follow ``threshold_many`` (t == 1
    degenerates to an "or" plan and coalesces with the or class).
    Validation errors (bad op, t < 1, bad weights) raise here, at
    admission time -- never inside a dispatch batch.

    ``arena``: a ``core.arena.BitmapArena``; containers already resident
    in it plan as device-slab row ids (no promotion, no staging at
    dispatch).  Containers the arena does not know stage per-call exactly
    as without one -- results are bit-identical either way, residency is
    purely a transfer optimization (adopt bitmaps first to get warm
    plans).

    ``device``: where the kernel runs, "cuda" by default (raises when no
    GPU is present); with an arena, the arena's device, and naming
    another raises."""
    dev = kops.resolve_device(device, arena)
    prefer = kops.prefer_kernel(backend, dev)
    bitmaps = list(bitmaps)
    if op == "or":
        plan = _plan_or(bitmaps, prefer, arena)
    elif op == "xor":
        plan = _plan_xor(bitmaps, arena)
    elif op == "and":
        plan = _plan_and(bitmaps, arena)
    elif op == "andnot":
        if not bitmaps:
            raise ValueError("andnot needs at least the minuend")
        plan = _plan_andnot(bitmaps[0], bitmaps[1:], arena)
    elif op == "threshold":
        plan = _plan_threshold(bitmaps, t, weights, prefer, arena)
    else:
        raise ValueError(f"unknown wide op {op!r}")
    plan.device = dev
    return plan


def _finish(plan: WidePlan, backend, mesh):
    merged = dict(plan.merged)
    merged.update(_dispatch(plan.seg_keys, plan.seg_rows, plan.op,
                            plan.threshold, backend, plan.device,
                            seg_weights=plan.seg_weights, arena=plan.arena,
                            mesh=mesh))
    return _build(merged)


def execute_plans(plans, *, backend: str | None = None,
                  mesh=None) -> list:
    """Execute many ``WidePlan``s with ONE slab launch per op class.

    Every plan's pending segments join one slab per op (threshold plans
    ride together via per-segment T -- see ``kernels.ops.segment_reduce``),
    so a batch of N queries costs O(op classes) dispatches, not O(N).
    Returns one RoaringBitmap per plan, bit-identical to finishing each
    plan alone: segment results are independent by construction, and the
    repack path is shared.  With a ``mesh`` of more than one shard, each
    class's rows shard across it (one launch per shard)."""
    plans = list(plans)
    results = [dict(p.merged) for p in plans]
    by_op: dict[tuple, list[int]] = {}   # (op, arena, device) class
    for i, p in enumerate(plans):
        if p.seg_keys:
            by_op.setdefault((p.op, id(p.arena), p.device), []).append(i)
    for (op, _, dev), idxs in by_op.items():
        keys: list = []
        rows: list[list] = []
        wts: list[list[int]] = []
        ts: list[int] = []
        any_w = any(plans[i].seg_weights is not None for i in idxs)
        for i in idxs:
            p = plans[i]
            keys.extend((i, k) for k in p.seg_keys)
            rows.extend(p.seg_rows)
            ts.extend([p.threshold] * len(p.seg_keys))
            if any_w:
                wts.extend(p.seg_weights if p.seg_weights is not None
                           else [[1] * len(r) for r in p.seg_rows])
        out = _dispatch(keys, rows, op,
                        ts if op == "threshold" else 0, backend, dev,
                        seg_weights=wts if any_w else None,
                        arena=plans[idxs[0]].arena, mesh=mesh)
        for (i, k), cont in out.items():
            results[i][k] = cont
    return [_build(r) for r in results]


def execute_plan_host(plan: WidePlan):
    """Numpy-only execution of one plan: the query server's degraded route
    when a kernel batch keeps failing.

    Reduces each pending segment's uint64 rows with exact host bit math
    (the rows the kernel would read) and repacks through the same
    ``optimize(C._result_from_bitset(...))``, so the result equals the
    kernel plan's.  It touches no tensor: arena row ids resolve through
    the arena's host mirror, never the device slab."""
    merged = dict(plan.merged)
    for i, (key, seg) in enumerate(zip(plan.seg_keys, plan.seg_rows)):
        if plan.arena is not None:
            seg = [r if isinstance(r, np.ndarray)
                   else plan.arena.host_row(r) for r in seg]
        stack = np.stack(seg)                       # (R, 1024) uint64
        if plan.op == "or":
            w = np.bitwise_or.reduce(stack, axis=0)
        elif plan.op == "and":
            w = np.bitwise_and.reduce(stack, axis=0)
        elif plan.op == "xor":
            w = np.bitwise_xor.reduce(stack, axis=0)
        elif plan.op == "andnot":
            w = stack[0]
            if stack.shape[0] > 1:
                w = w & ~np.bitwise_or.reduce(stack[1:], axis=0)
        elif plan.op == "threshold":
            bits = np.unpackbits(stack.view(np.uint8), axis=1,
                                 bitorder="little").astype(np.int64)
            if plan.seg_weights is not None:
                bits *= np.asarray(plan.seg_weights[i],
                                   np.int64)[:, None]
            keepbits = bits.sum(axis=0) >= plan.threshold
            w = np.packbits(keepbits, bitorder="little").view(np.uint64)
        else:
            raise ValueError(plan.op)
        card = int(np.bitwise_count(w).sum())
        if card:
            merged[key] = optimize(C._result_from_bitset(w.copy(), card))
    return _build(merged)


# ---------------------------------------------------------------------------
# public wide aggregates
# ---------------------------------------------------------------------------

def or_many(bitmaps, *, backend: str | None = None, arena=None,
            device=None, mesh=None):
    """Union of K bitmaps in one kernel launch (paper section 5.8).
    ``arena``: resident containers are read from the device slab without
    per-call staging; ``device`` as in ``plan_wide``; ``mesh`` a
    ``dist.WideMesh``: with more than one shard, one launch a shard and
    the partials folded (see the module docstring)."""
    return _finish(plan_wide("or", bitmaps, backend=backend, arena=arena,
                             device=device), backend, mesh)


def _plan_or(bitmaps, prefer_kernel: bool, arena=None) -> WidePlan:
    if len(bitmaps) <= 1:
        return WidePlan("or", 0,
                        dict(zip(bitmaps[0].keys, bitmaps[0].containers))
                        if bitmaps else {}, [], [])
    groups = _group(bitmaps)
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    run_groups: list[tuple[int, list[RunContainer]]] = []
    for k in sorted(groups):
        g = groups[k]
        if len(g) == 1:
            merged[k] = g[0]                       # zero-copy pass-through
            continue
        if all(isinstance(c, RunContainer) for c in g):
            run_groups.append((k, g))              # interval-level union
            continue
        if any(_is_full(c) for c in g):
            merged[k] = _full_run()                # full-chunk short-circuit
            continue
        arrays = [c for c in g if isinstance(c, ArrayContainer)]
        others = [c for c in g if not isinstance(c, ArrayContainer)]
        if not others:
            if sum(a.card for a in arrays) <= ARRAY_MAX:
                merged[k] = ArrayContainer(
                    np.unique(np.concatenate([a.values for a in arrays])))
                continue
            if not prefer_kernel:
                c = _from_indicator(_array_indicator(arrays, "or"))
                if c is not None:
                    merged[k] = c
                continue
        rows = _array_rows(arrays, "or", arena)
        rows.extend(_row_ref(c, arena) for c in others)
        seg_keys.append(k)
        seg_rows.append(rows)
    merged.update(_sweep_run_groups(run_groups, "or", 0))
    return WidePlan("or", 0, merged, seg_keys, seg_rows, arena=arena)


def xor_many(bitmaps, *, backend: str | None = None, arena=None,
             device=None, mesh=None):
    """Wide symmetric difference: a value survives iff it occurs in an odd
    number of inputs (K-ary XOR).  ``arena``: resident containers dispatch
    from the device slab without per-call staging (see ``plan_wide``);
    ``mesh`` as in ``or_many``."""
    return _finish(plan_wide("xor", bitmaps, backend=backend, arena=arena,
                             device=device), backend, mesh)


def _plan_xor(bitmaps, arena=None) -> WidePlan:
    if len(bitmaps) <= 1:
        return WidePlan("xor", 0,
                        dict(zip(bitmaps[0].keys, bitmaps[0].containers))
                        if bitmaps else {}, [], [])
    groups = _group(bitmaps)
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    run_groups: list[tuple[int, list[RunContainer]]] = []
    for k in sorted(groups):
        g = groups[k]
        if len(g) == 1:
            merged[k] = g[0]
            continue
        if all(isinstance(c, RunContainer) for c in g):
            run_groups.append((k, g))              # interval-level parity
            continue
        arrays = [c for c in g if isinstance(c, ArrayContainer)]
        others = [c for c in g if not isinstance(c, ArrayContainer)]
        if not others:
            c = _count_arrays(arrays, "xor", 0)    # host occurrence parity
            if c is not None:
                merged[k] = c
            continue
        rows = _array_rows(arrays, "xor", arena)
        rows.extend(_row_ref(c, arena) for c in others)
        seg_keys.append(k)
        seg_rows.append(rows)
    merged.update(_sweep_run_groups(run_groups, "xor", 0))
    return WidePlan("xor", 0, merged, seg_keys, seg_rows, arena=arena)


def and_many(bitmaps, *, backend: str | None = None, arena=None,
             device=None, mesh=None):
    """Intersection of K bitmaps: cardinality-ascending key pruning with
    empty-key early exit, array-anchored host filtering for sparse groups,
    one kernel launch for the dense remainder.  ``arena`` / ``device`` as
    in ``plan_wide``; ``mesh`` as in ``or_many`` (each shard sends its
    occupancy with its partial, so a shard without rows of a segment does
    not zero it)."""
    return _finish(plan_wide("and", bitmaps, backend=backend, arena=arena,
                             device=device), backend, mesh)


def _plan_and(bitmaps, arena=None) -> WidePlan:
    if len(bitmaps) <= 1:
        return WidePlan("and", 0,
                        dict(zip(bitmaps[0].keys, bitmaps[0].containers))
                        if bitmaps else {}, [], [])
    order = sorted(bitmaps, key=lambda b: b.cardinality)
    common = set(order[0].keys)
    for bm in order[1:]:
        common &= set(bm.keys)
        if not common:
            return WidePlan("and", 0, {}, [], [])  # empty-key early exit
    lookup = [dict(zip(bm.keys, bm.containers)) for bm in bitmaps]
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    run_groups: list[tuple[int, list[RunContainer]]] = []
    for k in sorted(common):
        g = sorted((lk[k] for lk in lookup), key=lambda c: c.card)
        if all(isinstance(c, RunContainer) for c in g):
            run_groups.append((k, g))              # interval intersection
            continue
        smallest = g[0]
        if isinstance(smallest, RunContainer) and smallest.card <= ARRAY_MAX:
            smallest = ArrayContainer(smallest.to_array_values())
        if isinstance(smallest, ArrayContainer):
            # array-anchored: the result is a subset of the smallest member,
            # so vectorized membership probes beat promoting the group
            vals = smallest.values
            for c in g[1:]:
                vals = _filter_values(vals, c)
                if vals.size == 0:
                    break
            if vals.size:
                merged[k] = ArrayContainer(vals)
            continue
        seg_keys.append(k)
        seg_rows.append([_row_ref(c, arena) for c in g])
    merged.update(_sweep_run_groups(run_groups, "and", 0))
    return WidePlan("and", 0, merged, seg_keys, seg_rows, arena=arena)


def andnot_many(minuend, subtrahends, *, backend: str | None = None,
                arena=None, device=None, mesh=None):
    """Difference chain ``a - (b1 | b2 | ...)`` as ONE plan: subtrahends
    OR-reduce segment-wise and a fused ANDNOT finalizes in the kernel
    ("Compressed bitmap indexes: beyond unions and intersections",
    Kaser & Lemire -- never materializes the intermediate union).

    Keys absent from every subtrahend pass through zero-copy; keys whose
    subtrahend group contains a full chunk drop immediately; array-probe
    and interval-sweep fast paths mirror the other aggregates.
    ``arena``: resident containers dispatch from the device slab without
    per-call staging (see ``plan_wide``); ``mesh`` as in ``or_many`` (the
    minuend is replicated on every shard)."""
    return _finish(plan_wide("andnot", [minuend, *subtrahends],
                             backend=backend, arena=arena, device=device),
                   backend, mesh)


def _plan_andnot(minuend, subtrahends, arena=None) -> WidePlan:
    if not subtrahends:
        return WidePlan("andnot", 0,
                        dict(zip(minuend.keys, minuend.containers)),
                        [], [])
    sub_groups = _group(subtrahends)
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    run_groups: list[tuple[int, list[Container]]] = []
    for k, c in zip(minuend.keys, minuend.containers):
        g = sub_groups.get(k)
        if g is None:
            merged[k] = c                          # zero-copy pass-through
            continue
        if any(_is_full(x) for x in g):
            continue                               # chunk fully subtracted
        if isinstance(c, RunContainer) and \
                all(isinstance(x, RunContainer) for x in g):
            run_groups.append((k, [c] + g))        # interval-level diff
            continue
        cc = c
        if isinstance(cc, RunContainer) and cc.card <= ARRAY_MAX:
            cc = ArrayContainer(cc.to_array_values())
        if isinstance(cc, ArrayContainer):
            # array-anchored: the result is a subset of the minuend, so
            # vectorized NOT-member probes beat promoting the group
            vals = cc.values
            for x in sorted(g, key=lambda q: -q.card):
                vals = _filter_values_out(vals, x)
                if vals.size == 0:
                    break
            if vals.size:
                merged[k] = ArrayContainer(vals)
            continue
        arrays = [x for x in g if isinstance(x, ArrayContainer)]
        others = [x for x in g if not isinstance(x, ArrayContainer)]
        rows = [_row_ref(c, arena)]                # minuend is row 0
        rows.extend(_array_rows(arrays, "or", arena))
        rows.extend(_row_ref(x, arena) for x in others)
        seg_keys.append(k)
        seg_rows.append(rows)
    merged.update(_sweep_run_groups(run_groups, "andnot", 0))
    return WidePlan("andnot", 0, merged, seg_keys, seg_rows, arena=arena)


def _check_weights(weights, k: int) -> list[int] | None:
    """Validate per-bitmap threshold weights; None when they degenerate to
    the unweighted path (all 1).  The total weight must fit int32: the
    kernel's counters and the jnp oracle accumulate in int32 (the host
    fast paths are int64, and results must not depend on container kind).
    """
    if weights is None:
        return None
    w = [int(x) for x in weights]
    if len(w) != k:
        raise ValueError(f"need one weight per bitmap: {len(w)} != {k}")
    if any(x < 1 for x in w):
        raise ValueError(f"weights must be >= 1, got {w}")
    if sum(w) >= 1 << 31:
        raise ValueError(
            f"total weight {sum(w)} overflows the int32 counter domain")
    return None if all(x == 1 for x in w) else w


def threshold_many(bitmaps, t: int, *, weights=None,
                   backend: str | None = None, arena=None, device=None,
                   mesh=None):
    """T-occurrence query: values whose (weighted) occurrence count over
    the K inputs reaches ``t`` (Kaser & Lemire's threshold function; T=1 is
    union, unweighted T=K intersection).

    ``weights`` are per-bitmap positive integers added into the same
    bit-sliced counter circuit (weight 1 everywhere degenerates to the
    unweighted plan, bit for bit).  Keys whose total attainable weight
    stays below ``t`` are pruned on the host.  ``arena``: resident
    containers dispatch from the device slab without per-call staging
    (see ``plan_wide``); ``mesh`` as in ``or_many`` (the shards exchange
    bit-sliced counters)."""
    return _finish(plan_wide("threshold", bitmaps, t, weights,
                             backend=backend, arena=arena, device=device),
                   backend, mesh)


def _plan_threshold(bitmaps, t, weights, prefer_kernel: bool,
                    arena=None) -> WidePlan:
    t = int(t)
    if t < 1:
        raise ValueError(f"threshold must be >= 1, got {t}")
    weights = _check_weights(weights, len(bitmaps))
    if not bitmaps or (weights is None and t > len(bitmaps)) or \
            (weights is not None and t > sum(weights)):
        return WidePlan("threshold", t, {}, [], [])
    if t == 1:
        return _plan_or(bitmaps, prefer_kernel, arena)  # the "or" class
    if weights is not None:
        return _plan_threshold_weighted(bitmaps, t, weights, arena)
    groups = _group(bitmaps)
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    run_groups: list[tuple[int, list[RunContainer]]] = []
    for k in sorted(groups):
        g = groups[k]
        if len(g) < t:
            continue                               # can never reach T
        if all(isinstance(c, RunContainer) for c in g):
            run_groups.append((k, g))              # interval-level counting
            continue
        if all(isinstance(c, ArrayContainer) for c in g):
            c = _count_arrays(g, "threshold", t)   # host occurrence counts
            if c is not None:
                merged[k] = c
            continue
        seg_keys.append(k)
        seg_rows.append([_row_ref(c, arena) for c in g])
    merged.update(_sweep_run_groups(run_groups, "threshold", t))
    return WidePlan("threshold", t, merged, seg_keys, seg_rows,
                    arena=arena)


def _plan_threshold_weighted(bitmaps, t: int, weights: list[int],
                             arena=None) -> WidePlan:
    """Weighted threshold body: identical planning shape, with per-member
    weights threaded through the sweep, the bincount fast path, and the
    kernel's shift-and-add counter circuit."""
    groups: dict[int, list[tuple[Container, int]]] = {}
    for bm, w in zip(bitmaps, weights):
        for k, c in zip(bm.keys, bm.containers):
            groups.setdefault(k, []).append((c, w))
    merged: dict[int, Container] = {}
    seg_keys: list[int] = []
    seg_rows: list[list[np.ndarray]] = []
    seg_wts: list[list[int]] = []
    run_groups: list[tuple] = []
    for k in sorted(groups):
        g = groups[k]
        if sum(w for _, w in g) < t:
            continue                               # can never reach T
        if all(isinstance(c, RunContainer) for c, _ in g):
            run_groups.append((k, [c for c, _ in g], [w for _, w in g]))
            continue
        if all(isinstance(c, ArrayContainer) for c, _ in g):
            vals = np.concatenate([c.values for c, _ in g])
            wrep = np.repeat(np.asarray([w for _, w in g], np.int64),
                             [c.values.size for c, _ in g])
            # bincount's float64 sums are exact for int totals < 2^53
            # (weights are bounded to the int32 domain by _check_weights)
            cnt = np.bincount(vals, weights=wrep, minlength=CHUNK)
            c = _from_indicator((cnt >= t).astype(np.uint8))
            if c is not None:
                merged[k] = c
            continue
        seg_keys.append(k)
        seg_rows.append([_row_ref(c, arena) for c, _ in g])
        seg_wts.append([w for _, w in g])
    merged.update(_sweep_run_groups(run_groups, "threshold", t))
    return WidePlan("threshold", t, merged, seg_keys, seg_rows, seg_wts,
                    arena=arena)
