"""Batched pairwise set algebra and top-k similarity: the port of the JAX
package's ``core/pairwise.py``.

Two-by-two algebra (the paper's central contribution, sections 4.2-4.5,
and its fast counts, section 5.9).  Given one ``a ⊕ b`` (:func:`merge_one`)
or M pairs at once (:func:`pairwise_card`, :func:`jaccard_matrix`: the
similarity join of "Compressed bitmap indexes: beyond unions and
intersections", Kaser & Lemire), the planner key-merges every pair,
buckets the matched container pairs by type class and launches ONE kernel
per class instead of one per pair:

  * **bitset x bitset**: stacked ``(M, WORDS)`` word rows through
    ``kernels.pair_ops.bitset_pair_op`` -- an op id per row, fused with
    the popcount (count-only twin ``bitset_pair_card`` for the counts);
  * **array x array**: padded ``(M, ARRAY_CAP)`` value rows through
    ``kernels.array_ops`` -- two-sided masks for the materializing ops,
    the count alone for the counts;
  * **array x bitset**: each array value probes its bitset row
    (``kernels.pair_ops.array_bitset_probe``) for AND and an array-minuend
    ANDNOT; OR, XOR and a bitset-minuend ANDNOT promote the array side to
    the bitset domain on the host and ride the bitset class;
  * **run containers** stay on the host interval sweeps (section 2.3).

Every count derives from the pair's intersection cardinality by
inclusion-exclusion, so the count planner only ever runs AND.  A pair of
at most ``SMALL_PAIR`` keys in all stays on the scalar host merge, as on a
TPU.  On the CPU with no forced backend each class runs a vectorized numpy
twin instead (an inverted token join for array x array, a per-key grouped
probe for array x bitset, a blocked popcount for bitset x bitset), exactly
the JAX package's host twins; ``backend="cuda"`` or ``"ref"`` forces the
class launches.  Every route gives the same containers and counts.

Similarity (:class:`SimilarityEngine`): the scores do not leave the card
either -- a query is one score launch and one select launch
(``kernels/topk_ops.py``) and only k results come back.  With ``mesh=``
(a ``dist.WideMesh`` of S > 1 shards) the pruned candidates are scored
shard by shard over the arena's per-shard slabs and the S k-lists merge
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.core.containers import (
    ArrayContainer, BitsetContainer, Container, RunContainer,
    container_from_values, positions_to_bitset,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ARRAY_CAP, METRICS, PAIR_OPS, WORDS

__all__ = ["pairwise_card", "jaccard_matrix", "merge_one", "OP_IDS",
           "METRICS", "SimilarityEngine"]

OP_IDS = {o: i for i, o in enumerate(PAIR_OPS)}   # the kernels' row op ids

# below this many total keys a single pair stays on the scalar host merge:
# the class bookkeeping costs more than a handful of container ops
SMALL_PAIR = 16

_HOST_BLOCK = 8192      # bitset rows per host block (8 kB each -> <= 64 MB)
_KCODE = {ArrayContainer: 1, BitsetContainer: 2, RunContainer: 3}


def _bitmap_cls():
    from repro_torch.core.bitmap import RoaringBitmap  # bitmap imports us
    return RoaringBitmap


def _words32(w64: np.ndarray) -> np.ndarray:
    return w64.view(np.uint32)


def _result_words(w32_row: np.ndarray, card: int) -> Container:
    # .copy(): a view would pin the whole (M, WORDS) batch output alive
    # for the lifetime of one surviving container
    w64 = np.ascontiguousarray(w32_row).view(np.uint64).copy()
    return C._result_from_bitset(w64, card)


def _to_dev(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host int32 (or uint32, reinterpreted) array on ``dev``."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _host_mask(t: torch.Tensor) -> np.ndarray:
    """A kernel's 0/1 int32 mask as a host bool array (narrowed on its
    device first, so a quarter of the bytes cross)."""
    return t.to(torch.bool).cpu().numpy()


# ---------------------------------------------------------------------------
# scalar host twins (kept for small pairs)
# ---------------------------------------------------------------------------

def _merge_host(a, b, op: str):
    """Scalar key-merge (the paper's top-level layout): one container op
    per matched key.  Small pairs stay here; large pairs batch by class."""
    fn = C.OPS[op][0]
    keys, conts = [], []
    i = j = 0
    a_keys, b_keys = a.keys, b.keys
    na, nb = len(a_keys), len(b_keys)
    while i < na and j < nb:
        ka, kb = a_keys[i], b_keys[j]
        if ka == kb:
            c = fn(a.containers[i], b.containers[j])
            if c.card:
                keys.append(ka)
                conts.append(c)
            i += 1
            j += 1
        elif ka < kb:
            if op in ("or", "xor", "andnot"):
                keys.append(ka)
                conts.append(a.containers[i])
            i += 1
        else:
            if op in ("or", "xor"):
                keys.append(kb)
                conts.append(b.containers[j])
            j += 1
    if op in ("or", "xor", "andnot"):
        while i < na:
            keys.append(a_keys[i])
            conts.append(a.containers[i])
            i += 1
    if op in ("or", "xor"):
        while j < nb:
            keys.append(b_keys[j])
            conts.append(b.containers[j])
            j += 1
    return _bitmap_cls()(keys, conts)


def _and_card_host(a, b) -> int:
    """Scalar fast-count twin (paper section 5.9) for small pairs."""
    cnt = 0
    i = j = 0
    while i < len(a.keys) and j < len(b.keys):
        ka, kb = a.keys[i], b.keys[j]
        if ka == kb:
            cnt += C.container_and_card(a.containers[i], b.containers[j])
            i += 1
            j += 1
        elif ka < kb:
            i += 1
        else:
            j += 1
    return cnt


# ---------------------------------------------------------------------------
# materializing two-by-two merge (one pair, class-batched)
# ---------------------------------------------------------------------------

def merge_one(a, b, op: str, *, backend: str | None = None, device=None):
    """``a ⊕ b`` through the type-grouped pair planner: matched container
    pairs bucket by class and each class is one kernel launch; unmatched
    keys pass through zero-copy exactly like the scalar merge.

    ``device``: where the launches run, "cuda" by default (raises when no
    GPU is present).  ``backend`` as in ``kernels.ops``.  On the CPU with
    no forced backend, and for a pair of at most ``SMALL_PAIR`` keys, the
    scalar host merge answers: numpy already vectorizes each container op,
    so there is no launch overhead for class batching to amortize."""
    dev = kops.resolve_device(device)
    if op not in OP_IDS:
        raise ValueError(op)
    na, nb = len(a.keys), len(b.keys)
    if na + nb <= SMALL_PAIR or not kops.prefer_kernel(backend, dev):
        return _merge_host(a, b, op)
    fn = C.OPS[op][0]
    ka = np.asarray(a.keys, np.int64)
    kb = np.asarray(b.keys, np.int64)
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                    return_indices=True)
    out: dict[int, Container] = {}
    if op in ("or", "xor", "andnot"):
        for i in np.setdiff1d(np.arange(na), ia,
                              assume_unique=True).tolist():
            out[a.keys[i]] = a.containers[i]
    if op in ("or", "xor"):
        for j in np.setdiff1d(np.arange(nb), ib,
                              assume_unique=True).tolist():
            out[b.keys[j]] = b.containers[j]

    aa: list[tuple[int, np.ndarray, np.ndarray]] = []
    probe: list[tuple[int, np.ndarray, np.ndarray, bool]] = []
    bb: list[tuple[int, np.ndarray, np.ndarray]] = []
    for k, i, j in zip(common.tolist(), ia.tolist(), ib.tolist()):
        ca, cb = a.containers[i], b.containers[j]
        xa = isinstance(ca, ArrayContainer)
        xb = isinstance(cb, ArrayContainer)
        if xa and xb:
            aa.append((int(k), ca.values, cb.values))
            continue
        if isinstance(ca, RunContainer) or isinstance(cb, RunContainer):
            c = fn(ca, cb)               # run fast paths stay on host
            if c.card:
                out[int(k)] = c
        elif xa or xb:
            if op == "and":
                arr, bs = (ca, cb) if xa else (cb, ca)   # AND commutes
                probe.append((int(k), arr.values, bs.words, False))
            elif op == "andnot" and xa:
                probe.append((int(k), ca.values, cb.words, True))
            else:
                # or / xor / bitset-minuend andnot: promote the array side
                # to the bitset domain and ride the bitset class
                wa = positions_to_bitset(ca.values) if xa else ca.words
                wb = positions_to_bitset(cb.values) if xb else cb.words
                bb.append((int(k), wa, wb))
        else:
            bb.append((int(k), ca.words, cb.words))
    _merge_aa(out, aa, op, backend, dev)
    _merge_probe(out, probe, backend, dev)
    _merge_bb(out, bb, op, backend, dev)
    keys = sorted(out)
    return _bitmap_cls()(keys, [out[k] for k in keys])


def _assemble_aa(x: np.ndarray, y: np.ndarray, ha: np.ndarray,
                 hb: np.ndarray, op: str) -> np.ndarray:
    """Result values of one array-array pair from the two-sided masks."""
    if op == "and":
        return x[ha]
    if op == "andnot":
        return x[~ha]
    if op == "or":
        return np.sort(np.concatenate((x, y[~hb])))
    return np.sort(np.concatenate((x[~ha], y[~hb])))          # xor


def _array_rows(arrays) -> tuple[np.ndarray, np.ndarray]:
    """(M, ARRAY_CAP) int32 value rows (zero past each card) and (M,)
    int32 cards of uint16 value arrays."""
    vals = np.zeros((len(arrays), ARRAY_CAP), np.int32)
    cards = np.zeros(len(arrays), np.int32)
    for r, v in enumerate(arrays):
        vals[r, :v.size] = v
        cards[r] = v.size
    return vals, cards


def _merge_aa(out: dict, entries: list, op: str, backend, dev) -> None:
    """array x array class: ONE two-sided-mask launch feeds all ops."""
    if not entries:
        return
    av, ac = _array_rows([x for _, x, _ in entries])
    bv, bc = _array_rows([y for _, _, y in entries])
    ma, mb, _ = kops.array_pair_masks(
        _to_dev(av, dev), _to_dev(ac, dev), _to_dev(bv, dev),
        _to_dev(bc, dev), backend=backend)
    ma = _host_mask(ma)
    mb = _host_mask(mb)
    for r, (k, x, y) in enumerate(entries):
        vals = _assemble_aa(x, y, ma[r, :x.size], mb[r, :y.size], op)
        if vals.size:
            out[k] = container_from_values(vals)


def _mask_in(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Membership of sorted ``x`` in sorted ``y`` (vectorized probe)."""
    if y.size == 0:
        return np.zeros(x.size, bool)
    idx = np.searchsorted(y, x)
    idx[idx == y.size] = y.size - 1
    return y[idx] == x


def _merge_probe(out: dict, entries: list, backend, dev) -> None:
    """array x bitset class (AND / array-minuend ANDNOT): one probe
    launch; ``invert`` keeps the misses instead of the hits."""
    if not entries:
        return
    vals, cards = _array_rows([v for _, v, _, _ in entries])
    words = np.stack([_words32(w) for _, _, w, _ in entries])
    mask, _ = kops.array_bitset_probe(
        _to_dev(vals, dev), _to_dev(cards, dev), _to_dev(words, dev),
        backend=backend)
    mask = _host_mask(mask)
    for r, (k, v, _, inv) in enumerate(entries):
        hit = mask[r, :v.size]
        kept = v[~hit] if inv else v[hit]
        if kept.size:
            out[k] = ArrayContainer(kept)


def _merge_bb(out: dict, entries: list, op: str, backend, dev) -> None:
    """bitset x bitset class: one stacked-words launch, op id per row."""
    if not entries:
        return
    a32 = np.stack([_words32(wa) for _, wa, _ in entries])
    b32 = np.stack([_words32(wb) for _, _, wb in entries])
    opids = np.full(len(entries), OP_IDS[op], np.int32)
    w, cards = kops.bitset_pair_op(_to_dev(a32, dev), _to_dev(b32, dev),
                                   opids, backend=backend)
    w = w.cpu().numpy()
    cards = cards.cpu().numpy()
    for r, (k, _, _) in enumerate(entries):
        if cards[r]:
            out[k] = _result_words(w[r], int(cards[r]))


# ---------------------------------------------------------------------------
# count-only batch (M pairs, one launch per class)
# ---------------------------------------------------------------------------

def pairwise_card(ops, pairs, *, backend: str | None = None,
                  device=None) -> np.ndarray:
    """Batched count-only pairwise set algebra over M bitmap pairs.

    ``ops`` is one op name ("and" | "or" | "xor" | "andnot") or a length-M
    sequence of per-pair names; ``pairs`` is a sequence of
    ``(RoaringBitmap, RoaringBitmap)``; ``device`` and ``backend`` as for
    :func:`merge_one`.  Returns (M,) int64 counts.

    Every count derives from the pair's intersection cardinality by
    inclusion-exclusion (paper section 5.9), so the batched engine only
    ever runs AND over the matched container pairs -- O(container-type
    classes) launches regardless of M."""
    dev = kops.resolve_device(device)
    pairs = list(pairs)
    m = len(pairs)
    if isinstance(ops, str):
        op_list = [ops] * m
    else:
        op_list = [str(o) for o in ops]
        if len(op_list) != m:
            raise ValueError(
                f"need one op per pair: {len(op_list)} != {m}")
    for o in op_list:
        if o not in OP_IDS:
            raise ValueError(o)
    if m == 0:
        return np.zeros(0, np.int64)
    uniq, ia, ib = _dedupe(pairs)
    if m == 1 and len(pairs[0][0].keys) + len(pairs[0][1].keys) \
            <= SMALL_PAIR:
        inter = np.array([_and_card_host(*pairs[0])], np.int64)
    else:
        inter = _inter_counts(uniq, ia, ib, backend, dev)
    cards = np.array([bm.cardinality for bm in uniq], np.int64)
    ca, cb = cards[ia], cards[ib]
    opv = np.array([OP_IDS[o] for o in op_list], np.int64)
    return np.where(opv == 0, inter,
                    np.where(opv == 1, ca + cb - inter,
                             np.where(opv == 2, ca + cb - 2 * inter,
                                      ca - inter)))


def _dedupe(pairs):
    """Unique bitmap objects + per-pair indices into the unique list."""
    seen: dict[int, int] = {}
    uniq = []
    for a, b in pairs:
        for bmp in (a, b):
            if id(bmp) not in seen:
                seen[id(bmp)] = len(uniq)
                uniq.append(bmp)
    ia = np.array([seen[id(a)] for a, _ in pairs], np.int64)
    ib = np.array([seen[id(b)] for _, b in pairs], np.int64)
    return uniq, ia, ib


def _tables(bitmaps):
    """Per-(bitmap, chunk-key) kind codes and container indices."""
    all_keys = sorted({k for bm in bitmaps for k in bm.keys})
    kidx = {k: i for i, k in enumerate(all_keys)}
    n, nk = len(bitmaps), len(all_keys)
    kind = np.zeros((n, nk), np.int8)
    cidx = np.zeros((n, nk), np.int32)
    for i, bm in enumerate(bitmaps):
        for j, (k, c) in enumerate(zip(bm.keys, bm.containers)):
            col = kidx[k]
            kind[i, col] = _KCODE[type(c)]
            cidx[i, col] = j
    return kind, cidx


def _inter_counts(uniq, ia, ib, backend, dev) -> np.ndarray:
    """(M,) intersection cardinalities: vectorized key matching over a
    presence table, then one batched AND-count launch per class.

    The host twins exploit the all-pairs structure: a container shared by
    many pairs enters the computation ONCE (an inverted token join for
    array x array, a per-key grouped probe for array x bitset), so the
    work scales with total postings, not postings-times-pairs."""
    m = ia.size
    kind, cidx = _tables(uniq)
    if kind.shape[1] == 0:
        return np.zeros(m, np.int64)
    kind_a, kind_b = kind[ia], kind[ib]
    pe, ke = np.nonzero((kind_a > 0) & (kind_b > 0))
    if pe.size == 0:
        return np.zeros(m, np.int64)
    ja, jb = ia[pe], ib[pe]
    ka, kb = kind[ja, ke], kind[jb, ke]
    conts_a = [uniq[i].containers[cidx[i, k]]
               for i, k in zip(ja.tolist(), ke.tolist())]
    conts_b = [uniq[i].containers[cidx[i, k]]
               for i, k in zip(jb.tolist(), ke.tolist())]
    counts = np.zeros(pe.size, np.int64)

    is_run = (ka == 3) | (kb == 3)
    is_aa = (ka == 1) & (kb == 1)
    is_bb = (ka == 2) & (kb == 2)
    is_ab = ~(is_run | is_aa | is_bb)

    for e in np.flatnonzero(is_run).tolist():      # run fast paths: host
        counts[e] = C.container_and_card(conts_a[e], conts_b[e])

    idx = np.flatnonzero(is_aa)
    if idx.size:
        counts[idx] = _aa_counts(ke[idx],
                                 [conts_a[e] for e in idx.tolist()],
                                 [conts_b[e] for e in idx.tolist()],
                                 backend, dev)
    idx = np.flatnonzero(is_ab)
    if idx.size:
        arrs, sets = [], []
        for e in idx.tolist():
            x, y = conts_a[e], conts_b[e]
            if not isinstance(x, ArrayContainer):
                x, y = y, x
            arrs.append(x)
            sets.append(y)
        counts[idx] = _ab_counts(ke[idx], arrs, sets, backend, dev)
    idx = np.flatnonzero(is_bb)
    if idx.size:
        counts[idx] = _bb_counts([conts_a[e] for e in idx.tolist()],
                                 [conts_b[e] for e in idx.tolist()],
                                 backend, dev)
    inter = np.zeros(m, np.int64)
    np.add.at(inter, pe, counts)
    return inter


def _aa_counts(keys_e, xs, ys, backend, dev) -> np.ndarray:
    """array x array intersection counts.

    Kernel route: padded value rows, one count-only launch.  Host route:
    an inverted token join -- every unique container's values enter ONE
    key-prefixed token stream; tokens shared by g containers emit
    g*(g-1)/2 co-occurrence pairs (one vectorized pass per rank offset),
    accumulating a container-pair count matrix that all entries read off.
    Work scales with total postings, never postings x pairs."""
    n = len(xs)
    if kops.prefer_kernel(backend, dev):
        av, ac = _array_rows([x.values for x in xs])
        bv, bc = _array_rows([y.values for y in ys])
        return kops.array_intersect_card(
            _to_dev(av, dev), _to_dev(ac, dev), _to_dev(bv, dev),
            _to_dev(bc, dev), backend=backend).cpu().numpy().astype(
                np.int64)
    # unique containers; token = key << 16 | value, so containers of
    # different chunk keys never collide
    uid: dict[int, int] = {}
    pool: list[np.ndarray] = []
    ua = np.empty(n, np.int64)
    ub = np.empty(n, np.int64)
    for r, (k, x, y) in enumerate(zip(keys_e.tolist(), xs, ys)):
        for side, c in ((ua, x), (ub, y)):
            u = uid.get(id(c))
            if u is None:
                u = uid[id(c)] = len(pool)
                pool.append(c.values.astype(np.int64)
                            + (np.int64(k) << 16))
            side[r] = u
    nu = len(pool)
    if nu > 4096:
        # the co-occurrence matrix would be nu^2: fall back to the
        # replicated per-entry membership probe (still one bulk op)
        return _aa_counts_probe(keys_e, xs, ys)
    lens = np.array([v.size for v in pool], np.int64)
    tokens = np.concatenate(pool)
    owner = np.repeat(np.arange(nu, dtype=np.int64), lens)
    comb = tokens * nu + owner                # value-major, owner-minor
    comb.sort()
    val_of = comb // nu
    own_of = comb % nu
    g = np.zeros((nu, nu), np.int32)
    d = 1
    while d < comb.size:
        same = val_of[d:] == val_of[:-d]
        if not same.any():
            break
        np.add.at(g, (own_of[:-d][same], own_of[d:][same]), 1)
        d += 1
    res = (g[ua, ub] + g[ub, ua]).astype(np.int64)
    self_pair = ua == ub             # a container against itself: |values|
    if self_pair.any():
        res[self_pair] = lens[ua[self_pair]]
    return res


def _aa_counts_probe(keys_e, xs, ys) -> np.ndarray:
    """Replicated-entry fallback: offset-concatenate both sides (entry id
    in the high bits keeps entries apart in one sort order) and count
    matches of A's stream in B's with a single vectorized probe."""
    n = len(xs)
    lens_a = np.array([x.values.size for x in xs], np.int64)
    lens_b = np.array([y.values.size for y in ys], np.int64)
    eids = np.arange(n, dtype=np.int64) << 16
    a_all = np.concatenate([x.values for x in xs]).astype(np.int64) \
        + np.repeat(eids, lens_a)
    b_all = np.concatenate([y.values for y in ys]).astype(np.int64) \
        + np.repeat(eids, lens_b)
    hit = _mask_in(a_all, b_all)
    eid_a = np.repeat(np.arange(n), lens_a)
    return np.bincount(eid_a[hit], minlength=n).astype(np.int64)


def _ab_counts(keys_e, arrs, sets, backend, dev) -> np.ndarray:
    """array x bitset probe counts.

    Kernel route: one batched probe launch.  Host route: per chunk key,
    every unique array's values probe ALL of that key's unique bitsets at
    once (word gather + bit test, segment-summed per array), so each
    value is touched once per bitset instead of once per pair."""
    n = len(arrs)
    if kops.prefer_kernel(backend, dev):
        vals, cards = _array_rows([x.values for x in arrs])
        words = np.stack([_words32(y.words) for y in sets])
        _, cnt = kops.array_bitset_probe(
            _to_dev(vals, dev), _to_dev(cards, dev), _to_dev(words, dev),
            backend=backend)
        return cnt.cpu().numpy().astype(np.int64)
    out = np.zeros(n, np.int64)
    order = np.argsort(keys_e, kind="stable")
    bounds = np.flatnonzero(np.concatenate(
        ([True], np.diff(keys_e[order]) != 0, [True])))
    for s, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        ent = order[s:e]                      # entries of one chunk key
        aid: dict[int, int] = {}
        bid: dict[int, int] = {}
        a_list: list[np.ndarray] = []
        b_list: list[np.ndarray] = []
        ea = np.empty(ent.size, np.int64)
        eb = np.empty(ent.size, np.int64)
        for r, i in enumerate(ent.tolist()):
            u = aid.get(id(arrs[i]))
            if u is None:
                u = aid[id(arrs[i])] = len(a_list)
                a_list.append(arrs[i].values)
            ea[r] = u
            u = bid.get(id(sets[i]))
            if u is None:
                u = bid[id(sets[i])] = len(b_list)
                b_list.append(sets[i].words)
            eb[r] = u
        lens = np.array([v.size for v in a_list], np.int64)
        vals = np.concatenate(a_list).astype(np.int64)
        stack = np.stack(b_list)              # (nb, 1024) uint64
        bits = ((stack[:, vals >> 6]
                 >> (vals & 63).astype(np.uint64)) & np.uint64(1))
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        seg = np.add.reduceat(bits, starts, axis=1)   # (nb, na)
        out[ent] = seg[eb, ea]
    return out


def _bb_counts(xs, ys, backend, dev) -> np.ndarray:
    """bitset x bitset AND-popcount counts, one launch."""
    n = len(xs)
    if kops.prefer_kernel(backend, dev):
        a32 = np.stack([_words32(x.words) for x in xs])
        b32 = np.stack([_words32(y.words) for y in ys])
        return kops.bitset_pair_card(
            _to_dev(a32, dev), _to_dev(b32, dev), np.zeros(n, np.int32),
            backend=backend).cpu().numpy().astype(np.int64)
    out = np.zeros(n, np.int64)
    for lo in range(0, n, _HOST_BLOCK):
        hi = min(lo + _HOST_BLOCK, n)
        a64 = np.stack([x.words for x in xs[lo:hi]])
        b64 = np.stack([y.words for y in ys[lo:hi]])
        out[lo:hi] = np.bitwise_count(a64 & b64).sum(axis=1)
    return out


def jaccard_matrix(bitmaps, *, backend: str | None = None,
                   device=None) -> np.ndarray:
    """(N, N) float64 Jaccard similarity matrix over N bitmaps: the
    all-pairs similarity join, planned as one batched AND-count launch per
    container-type class over all N*(N-1)/2 pairs (not one per pair).
    The diagonal is 1.0, and so is an empty pair."""
    dev = kops.resolve_device(device)
    bitmaps = list(bitmaps)
    n = len(bitmaps)
    out = np.ones((n, n), np.float64)
    if n < 2:
        return out
    iu, ju = np.triu_indices(n, k=1)
    pairs = [(bitmaps[i], bitmaps[j]) for i, j in zip(iu.tolist(),
                                                      ju.tolist())]
    inter = pairwise_card("and", pairs, backend=backend,
                          device=dev).astype(np.float64)
    cards = np.array([bm.cardinality for bm in bitmaps], np.float64)
    union = cards[iu] + cards[ju] - inter
    sim = np.divide(inter, union, out=np.ones_like(inter),
                    where=union > 0)
    out[iu, ju] = sim
    out[ju, iu] = sim
    return out


# ---------------------------------------------------------------------------
# top-k similarity engine
# ---------------------------------------------------------------------------

def _scores_host(inter, q_card, cards, metric: str) -> np.ndarray:
    """Numpy version of ``kernels.ref.similarity_scores``: float32 in the
    same operation order, so host selection gives the kernel's bits and
    its tie order."""
    interf = np.asarray(inter).astype(np.float32)
    qc = np.float32(q_card)
    oc = np.asarray(cards).astype(np.float32)
    if metric == "jaccard":
        denom = qc + oc - interf
    elif metric == "cosine":
        denom = np.sqrt(qc * oc)
    elif metric == "containment":
        denom = np.broadcast_to(qc, oc.shape)
    else:
        raise ValueError(metric)
    return np.divide(interf, denom, out=np.ones_like(interf),
                     where=denom > 0)


def _is_member(query) -> bool:
    return isinstance(query, (int, np.integer))


class SimilarityEngine:
    """Top-k similarity joins against a fixed candidate set, one score and
    one select launch per query on the card.

    Construction promotes every candidate container to a bitset row once,
    into a candidate-major slab over the global chunk-key set (the layout
    ``kernels/topk_ops.py`` consumes), with a device copy made at the first
    kernel query.  Memory: 8 KiB per candidate container, on the host and
    on the device (a query-serving cache; the stored bitmaps keep their
    compressed kinds).

    Routes (``backend`` of :meth:`topk`): on the card, and whenever a
    kernel backend is forced ("cuda", "ref"), the score and select stages
    run through ``kernels.ops.similarity_topk``; on the CPU by default,
    and always with "host", the candidate-pruning planner runs in numpy:
    every candidate's score is bounded above by the metric at ``inter =
    min(|Q|, |C|)``, the k best bounds are scored exactly to fix the
    running k-th score, and every candidate whose bound falls below it is
    skipped.  Every route evaluates the score in float32 in one operation
    order and breaks ties toward the lower candidate index, so all of them
    return the same bits.

    With an ``arena`` (``core/arena.py``) the slab is an arena view: the
    candidates are adopted into the shared arena, the engine keeps slab row
    ids, its host rows are a gather from the arena's host mirror, and its
    device rows a gather from the arena's device slab (taken at the first
    kernel query after a build).  A postings edit then costs one
    :meth:`refresh`: the arena repatches only the changed rows and the
    next query gathers again from the patched slab.

    With a ``mesh`` of S > 1 shards (and an arena) every query that is not
    forced to the host takes the sharded route (:meth:`_topk_sharded`):
    the same pruning as the host sweep picks the survivors, survivor ``t``
    goes to shard ``t % S``, each shard scores and selects its survivors
    over the arena's per-shard slabs (``kernels.ops.similarity_topk_ids``:
    two launches), and one labelled select merges the S k-lists
    (``kernels.ops.topk_merge``).  Ties go to the lowest global index at
    both selects, so the answer is the single-device engine's.
    """

    def __init__(self, bitmaps, *, arena=None, device=None, mesh=None):
        """``bitmaps``: the candidate set, index-aligned with results.
        ``arena``: an optional shared ``BitmapArena``; the candidates are
        adopted into it and the engine becomes a view over its slab.
        ``device``: where kernel queries run, "cuda" by default (raises
        when no GPU is present); with an arena, the arena's device.
        ``mesh``: an optional 1-D ``dist.WideMesh``; with more than one
        shard the engine runs the sharded route over the arena's per-shard
        slabs, which needs an arena.  A 1-shard mesh gives the
        single-device engine."""
        self._bitmaps = list(bitmaps)
        self._arena = arena
        self.device = kops.resolve_device(device, arena)
        self._mesh = None
        self._nshards = 1
        if mesh is not None:
            from repro_torch.dist import ctx
            m, size, _ = ctx.resolve_wide(mesh)
            if size > 1:
                if arena is None:
                    raise ValueError("sharded SimilarityEngine (mesh=) "
                                     "requires an arena-backed engine")
                self._mesh, self._nshards = m, size
        self._build()

    def _build(self) -> None:
        bitmaps = self._bitmaps
        arena = self._arena
        self.n = len(bitmaps)
        self.cards = np.array([bm.cardinality for bm in bitmaps], np.int64)
        if self.cards.size and int(self.cards.max()) >= 2**31:
            # the kernel route carries cardinalities as int32; refuse to
            # build rather than wrap on one route only
            raise ValueError("candidate cardinality >= 2^31 unsupported")
        if arena is not None:
            arena.adopt_many(bitmaps)
        keys = sorted({k for bm in bitmaps for k in bm.keys})
        self.key_col = {k: i for i, k in enumerate(keys)}
        self.n_keys = len(keys)
        rows, row_col = [], []
        starts = np.zeros(self.n + 1, np.int32)
        for i, bm in enumerate(bitmaps):
            for k, c in zip(bm.keys, bm.containers):
                rows.append(arena.lookup(c) if arena is not None
                            else C.container_words64(c))
                row_col.append(self.key_col[k])
            starts[i + 1] = len(rows)
        if arena is not None:
            self.row_ids = np.asarray(rows, np.int32)
            self.rows = arena.host_rows(self.row_ids) if rows else \
                np.zeros((0, 1024), np.uint64)
            self._snap = tuple((id(bm), bm._version) for bm in bitmaps)
        else:
            self.row_ids = None
            self.rows = np.stack(rows) if rows else \
                np.zeros((0, 1024), np.uint64)
            self._snap = None
        self.row_col = np.asarray(row_col, np.int32)
        self.starts = starts
        self._dev = None                         # made at the first query

    def refresh(self) -> bool:
        """Revalidate an arena-backed engine: re-adopt candidates whose
        ``_version`` moved (the arena repatches only their changed rows),
        rebuild the host index arrays, and drop the device view, so the
        next query gathers again from the patched slab on the device.
        Returns True when anything changed, False when every candidate is
        current.  The arena's patch is out of place, so a stale view would
        still answer, from the old rows: dropping it is what keeps the
        answers current."""
        if self._arena is None:
            raise ValueError("refresh() requires an arena-backed engine")
        snap = tuple((id(bm), bm._version) for bm in self._bitmaps)
        if snap == self._snap:
            return False
        self._build()
        return True

    # -- query preparation ----------------------------------------------

    def _query_words(self, query) -> np.ndarray:
        """(C, 1024) uint64 host query rows over the global keys.
        ``query`` is a candidate index (its rows come from the slab) or a
        RoaringBitmap (keys outside the candidate set are dropped: no
        candidate row can meet them)."""
        q64 = np.zeros((max(self.n_keys, 1), 1024), np.uint64)
        if _is_member(query):
            s, e = int(self.starts[query]), int(self.starts[query + 1])
            q64[self.row_col[s:e]] = self.rows[s:e]
            return q64
        cols, rows = self._bitmap_rows(query)
        if cols:
            q64[cols] = np.stack(rows)
        return q64

    def _bitmap_rows(self, query) -> tuple[list[int], list[np.ndarray]]:
        """Key columns and uint64 rows of a bitmap query's containers
        whose keys some candidate has."""
        cols, rows = [], []
        for k, cont in zip(query.keys, query.containers):
            col = self.key_col.get(k)
            if col is not None:
                cols.append(col)
                rows.append(C.container_words64(cont))
        return cols, rows

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _query_words_dev(self, query) -> torch.Tensor:
        """(C, WORDS) int32 query block on the device.  A member query
        copies its rows from the resident device rows (no container words
        cross from the host); a bitmap query ships only its occupied
        rows."""
        dev_rows, dev_col, _, _ = self._device()
        out = torch.zeros((max(self.n_keys, 1), WORDS), dtype=torch.int32,
                          device=self.device)
        if _is_member(query):
            s, e = int(self.starts[query]), int(self.starts[query + 1])
            if s < e:
                out.index_copy_(0, dev_col[s:e].long(), dev_rows[s:e])
            return out
        cols, rows = self._bitmap_rows(query)
        if cols:
            out.index_copy_(
                0, self._to_device(np.asarray(cols, np.int64)),
                self._to_device(np.stack(rows).view(np.int32)
                                .reshape(-1, WORDS)))
        return out

    def _device(self):
        """(rows, row_col, starts, cards) on the device, made once per
        build.  With an arena the rows are gathered from the arena's
        resident slab on the device (counted in ``device_gathers``)."""
        if self._dev is None:
            if self._arena is not None and self.row_ids.size:
                rows = self._arena.device_slab().index_select(
                    0, self._to_device(self.row_ids.astype(np.int64)))
                self._arena.stats.device_gathers += 1
            elif self.rows.size:
                rows = self._to_device(
                    self.rows.view(np.int32).reshape(-1, WORDS))
            else:
                rows = torch.zeros((1, WORDS), dtype=torch.int32,
                                   device=self.device)
            self._dev = (
                rows,
                self._to_device(self.row_col if self.row_col.size else
                                np.zeros(1, np.int32)),
                self._to_device(self.starts),
                self._to_device(self.cards.astype(np.int32)),
            )
        return self._dev

    # -- the query surface ----------------------------------------------

    def _check_query(self, query, k: int) -> tuple[int | None, int, int]:
        """(exclude, query cardinality, k clamped to the candidates)."""
        if _is_member(query):
            exclude = int(query)
            if not 0 <= exclude < self.n:
                raise IndexError(f"candidate index {exclude} out of "
                                 f"range [0, {self.n})")
            qc = int(self.cards[exclude])
        else:
            exclude = None
            qc = query.cardinality
        k = min(int(k), self.n - (1 if exclude is not None else 0))
        if k > 0 and qc >= 2**31:                # int32 on the kernel route
            raise ValueError("query cardinality >= 2^31 unsupported")
        return exclude, qc, k

    def _shortcut(self, exclude, qc: int, k: int, metric: str):
        """The result where no route has work to do -- nothing to return,
        or no candidate with a row -- else None."""
        if k <= 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        if self.rows.shape[0] == 0:              # all candidates empty
            score = _scores_host(np.zeros(self.n, np.int64), qc,
                                 self.cards, metric)
            if exclude is not None:
                score[exclude] = np.float32(-1.0)
            order = np.argsort(-score, kind="stable")[:k]
            return (order.astype(np.int64), score[order],
                    np.zeros(k, np.int64))
        return None

    def _use_kernel(self, backend) -> bool:
        return backend != "host" and kops.prefer_kernel(backend,
                                                        self.device)

    def _topk_kernel(self, q_words: torch.Tensor, qc: int, k: int,
                     metric: str, exclude, backend):
        dev_rows, dev_col, dev_starts, dev_cards = self._device()
        idx, score, inter = kops.similarity_topk(
            dev_rows, dev_col, dev_starts, q_words, qc, dev_cards,
            metric=metric, k=k, exclude=-1 if exclude is None else exclude,
            backend=backend)
        return (idx.cpu().numpy().astype(np.int64), score.cpu().numpy(),
                inter.cpu().numpy().astype(np.int64))

    def topk(self, query, k: int, metric: str = "jaccard", *,
             backend: str | None = None
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k most similar candidates to ``query``.

        query:   a candidate index (int; excluded from its own result) or a
                 RoaringBitmap.
        k:       results wanted; clamped to the candidate count.
        metric:  "jaccard" | "cosine" | "containment".
        backend: None (the kernels on the card, the pruned host sweep on
                 the CPU), "cuda" or "ref" (the kernel route with the CUDA
                 kernels or their plain versions), or "host" (the numpy
                 sweep, the query server's degraded route).  Every route
                 returns the same bits.

        Returns (idx (k',) int64, score (k',) float32, inter (k',) int64),
        best first; ties at equal score order by ascending index.
        """
        if metric not in METRICS:
            raise ValueError(metric)
        exclude, qc, k = self._check_query(query, k)
        done = self._shortcut(exclude, qc, k, metric)
        if done is not None:
            return done
        if self._mesh is not None and backend != "host":
            return self._topk_sharded(query, qc, k, metric, exclude,
                                      backend)
        if self._use_kernel(backend):
            return self._topk_kernel(self._query_words_dev(query), qc, k,
                                     metric, exclude, backend)
        return self._topk_host(self._query_words(query), qc, k, metric,
                               exclude)

    # -- sharded route (per-shard arena slabs, k-lists merged) ----------

    def _query_words_dev_sharded(self, query, shards) -> torch.Tensor:
        """(C, WORDS) int32 query block on the shards' device: a member
        query reads its rows from the per-shard slabs of the shards that
        own them (no container words cross from the host); a bitmap query
        ships only its occupied rows."""
        out = torch.zeros((max(self.n_keys, 1), WORDS), dtype=torch.int32,
                          device=shards.device)
        if _is_member(query):
            s, e = int(self.starts[query]), int(self.starts[query + 1])
            if s < e:
                if shards.distinct:
                    table, pos = shards.gather(self.row_ids[s:e],
                                               shards.device, 0)
                else:
                    table = shards.assembled()
                    pos = shards.positions(self.row_ids[s:e])
                out.index_copy_(
                    0, torch.from_numpy(self.row_col[s:e].astype(np.int64))
                    .to(shards.device),
                    table.index_select(
                        0, torch.from_numpy(pos).to(shards.device)))
            return out
        cols, rows = self._bitmap_rows(query)
        if cols:
            out.index_copy_(
                0, torch.from_numpy(np.asarray(cols, np.int64))
                .to(shards.device),
                torch.from_numpy(np.stack(rows).view(np.int32)
                                 .reshape(-1, WORDS)).to(shards.device))
        return out

    def _plan_sharded(self, q64, qc, k, metric, exclude, shards) -> list:
        """Host planning of one sharded query: the pruning of
        :meth:`_topk_host` (bounds, the k best bounds scored exactly, the
        running k-th score tau, survivors = bound >= tau), so the same
        candidates survive; then survivor ``t`` goes to shard ``t % S``.

        Returns, per shard, ``(n_valid, n_rows, ints)``: its count of
        survivors, their count of rows R, and one int32 array holding in
        turn the assembled-slab positions (R) and key columns (R) of those
        rows, the row offsets (L + 1), global ids (L) and cardinalities (L)
        of the slots.  Every shard has L = the largest survivor count (at
        least 1) slots; a shard's slots past its own count are padding with
        no rows, id ``n`` and card 0.  Nothing else is padded: there is no
        compilation to reuse."""
        ub = _scores_host(np.minimum(qc, self.cards), qc, self.cards,
                          metric)
        if exclude is not None:
            ub[exclude] = np.float32(-1.0)
        seeds = np.argsort(-ub, kind="stable")[:k]
        tau = _scores_host(self._host_inter(seeds, q64), qc,
                           self.cards[seeds], metric).min()
        # exact seed scores are <= their bounds, so the seeds survive; the
        # excluded candidate's bound is -1 < 0 <= tau, so it never does
        surv = np.flatnonzero(ub >= tau)
        S = self._nshards
        home = surv % S
        slots = max(1, int(np.bincount(home, minlength=S).max()))
        out = []
        for s in range(S):
            cs = surv[home == s]                 # ascending global ids
            gidx = np.full(slots, self.n, np.int64)
            gidx[: cs.size] = cs
            cards = np.zeros(slots, np.int64)
            cards[: cs.size] = self.cards[cs]
            lens, ridx = self._rows_of(cs)
            starts = np.zeros(slots + 1, np.int64)
            starts[1: cs.size + 1] = np.cumsum(lens)
            starts[cs.size + 1:] = starts[cs.size]
            # distinct devices: the row ids, gathered at launch time
            pos = self.row_ids[ridx] if shards.distinct else \
                shards.positions(self.row_ids[ridx])
            out.append((int(cs.size), int(ridx.size), np.concatenate(
                [pos, self.row_col[ridx], starts, gidx, cards]).astype(
                    np.int32)))
        return out

    def _topk_sharded(self, query, qc, k, metric, exclude, backend):
        """The sharded route: :meth:`_plan_sharded` picks and places the
        survivors; each shard scores its survivors, reading their rows from
        the per-shard slabs through their positions (ids cross from the
        host, never container words), and selects its k best; the S
        k-lists are gathered on the merge device (the mesh's first) and
        one labelled select merges them.  Ties go to the lowest global
        candidate index at both selects, so the answer is the
        single-device route's.  Where the shards sit on distinct devices
        each shard's survivor rows are gathered to it first
        (``ShardSlabs.gather``)."""
        shards = self._arena.shard_slabs(self._mesh)
        plan = self._plan_sharded(self._query_words(query), qc, k, metric,
                                  exclude, shards)
        q_words = self._query_words_dev_sharded(query, shards)
        table = None if shards.distinct else shards.assembled()
        for st in shards.stats:
            st.device_gathers += 1
        merge = self._mesh.devices[0]
        ex = -1 if exclude is None else exclude
        lists = []
        for d, ((n_valid, r, ints), dev) in enumerate(zip(
                plan, self._mesh.devices)):
            if shards.distinct:       # the shard's rows gathered to it
                table, ints[:r] = shards.gather(ints[:r], dev, d)
            ints = torch.from_numpy(ints).to(dev)      # one copy a shard
            slots = (ints.shape[0] - 2 * r - 1) // 3
            pos, col, starts, gidx, cards = ints.split(
                [r, r, slots + 1, slots, slots])
            out = kops.similarity_topk_ids(
                table, pos, col, starts, q_words.to(dev), qc, cards, gidx,
                metric=metric, k=k, n_valid=n_valid, exclude=ex,
                backend=backend)
            lists.append([t.to(merge) for t in out])
        gidx, score, inter = (torch.cat(parts) for parts in zip(*lists))
        idx, score, inter = kops.topk_merge(score, inter, gidx, k,
                                            backend=backend)
        return (idx.cpu().numpy().astype(np.int64), score.cpu().numpy(),
                inter.cpu().numpy().astype(np.int64))

    def topk_batch(self, queries, k: int, metric: str = "jaccard", *,
                   backend: str | None = None) -> list:
        """``[self.topk(q, k, metric, backend=backend) for q in queries]``
        (the query server's similarity batch).  On the kernel route each
        query runs its own score and select launches, and on the sharded
        route its own shard launches and merge, as the JAX package's
        kernel and sharded routes loop per query."""
        if metric not in METRICS:
            raise ValueError(metric)
        return [self.topk(q, k, metric, backend=backend) for q in queries]

    # -- pruned host route ----------------------------------------------

    def _rows_of(self, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(row count of each selected candidate, the indices of their
        rows in candidate order)."""
        lens = (self.starts[sel + 1] - self.starts[sel]).astype(np.int64)
        offs = np.repeat(np.cumsum(lens) - lens, lens)
        ridx = np.arange(int(lens.sum())) - offs + np.repeat(
            self.starts[sel].astype(np.int64), lens)
        return lens, ridx

    def _host_inter(self, sel: np.ndarray, q64: np.ndarray) -> np.ndarray:
        """Exact intersection cardinalities of the selected candidates:
        gather their rows, AND with the query's key columns, popcount,
        sum per candidate."""
        out = np.zeros(sel.size, np.int64)
        lens, ridx = self._rows_of(sel)
        if ridx.size == 0:
            return out
        per = np.bitwise_count(
            self.rows[ridx] & q64[self.row_col[ridx]]).sum(axis=1)
        np.add.at(out, np.repeat(np.arange(sel.size), lens),
                  per.astype(np.int64))
        return out

    def _topk_host(self, q64, qc, k, metric, exclude):
        """The pruning planner: score upper bounds from cardinalities alone
        (the metric at ``inter = min(|Q|, |C|)``, monotone in inter, so a
        true float32 bound), exact scores for the k best bounds to fix the
        running k-th score, and no work for a candidate whose bound falls
        strictly below it."""
        ub = _scores_host(np.minimum(qc, self.cards), qc, self.cards,
                          metric)
        if exclude is not None:
            ub[exclude] = np.float32(-1.0)
        order_ub = np.argsort(-ub, kind="stable")
        seeds = order_ub[:k]
        score = np.full(self.n, np.float32(-1.0), np.float32)
        inter = np.zeros(self.n, np.int64)
        inter[seeds] = self._host_inter(seeds, q64)
        score[seeds] = _scores_host(inter[seeds], qc, self.cards[seeds],
                                    metric)
        tau = score[seeds].min()                 # running k-th score
        rest = order_ub[k:]
        survivors = rest[ub[rest] >= tau]        # bound < tau: skipped
        if survivors.size:
            inter[survivors] = self._host_inter(survivors, q64)
            score[survivors] = _scores_host(
                inter[survivors], qc, self.cards[survivors], metric)
        if exclude is not None:
            score[exclude] = np.float32(-1.0)
        order = np.argsort(-score, kind="stable")[:k]
        return order.astype(np.int64), score[order], inter[order]
