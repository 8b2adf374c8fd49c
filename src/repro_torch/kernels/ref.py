"""Plain PyTorch versions of the port's kernels.

These are the torch twins of the JAX package's ``kernels/ref.py`` for the
segmented wide aggregation, for the similarity top-k (its score and select
stages, and their labelled twins for one shard of the sharded engine), for
the paper's section-4 primitives (the fused bitset op and count, the
sorted-array intersection), for the two-by-two pair classes (bitset x
bitset, array x bitset, array x array), for the array <-> bitset
conversions and for the Roaring block-sparse decode attention.  The CPU
tests run them against the JAX reference, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.  On the
card's main path only what the JAX package also leaves outside its kernels
runs here: :func:`bitset_to_array` (plain jnp on every JAX backend), the
popcount of run starts, which ``RoaringTensor`` forces to the plain version
as the JAX class does, and the sharded threshold's bit-sliced counters and
the sharded folds' popcount (plain jnp there too).

Word layout: one Roaring bitset container = 2048 32-bit words, bit ``i`` in
word ``i >> 5`` at position ``i & 31``.  Words are held as bit-reinterpreted
``torch.int32`` (this torch build has no ``~`` or ``>>`` on ``uint32``);
convert to and from numpy ``uint32`` at the boundary with ``.view``.
``>>`` on int32 shifts arithmetically, so every shift below is masked.
"""

from __future__ import annotations

import torch

WORDS = 2048            # 32-bit words per 2^16-bit container
CONTAINER_BITS = 1 << 16
ARRAY_CAP = 4096        # fixed capacity of the array-value slab
PAIR_OPS = ("and", "or", "xor", "andnot")   # index == per-row op id

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount_u32(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words, int64 (SWAR in int64, so no
    intermediate can overflow or sign-extend)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) >> 24) & 0xFF


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """(..., WORDS) int32 words -> (...,) int32 cardinality."""
    return popcount_u32(words).sum(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# the fused bitset op and count (paper sections 4.1.2 and 5.9)
# ---------------------------------------------------------------------------

_POP_CHUNK = 16384      # rows per popcount pass: int64 temporaries of
                        # 256 MiB (16 KiB a row)


def _apply(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"unknown op {op!r}; expected one of {PAIR_OPS}")


def _popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """:func:`popcount_words` of (N, WORDS) rows, ``_POP_CHUNK`` rows at a
    time."""
    out = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    for lo in range(0, words.shape[0], _POP_CHUNK):
        out[lo:lo + _POP_CHUNK] = popcount_words(words[lo:lo + _POP_CHUNK])
    return out


def bitset_op(a: torch.Tensor, b: torch.Tensor, op: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One logical op over every row: (words (N, WORDS) int32, card (N,)
    int32) of ``a op b``.  a, b: (N, WORDS) int32 words; op in
    ``PAIR_OPS`` (andnot is ``a & ~b``); any other op raises ValueError.
    N = 0 gives empty tensors."""
    r = _apply(a.to(torch.int32), b.to(torch.int32), op)
    return r, _popcount_rows(r)


def bitset_op_card(a: torch.Tensor, b: torch.Tensor, op: str
                   ) -> torch.Tensor:
    """Count-only :func:`bitset_op`: (N,) int32."""
    return bitset_op(a, b, op)[1]


def segment_reduce(slab: torch.Tensor, starts: torch.Tensor, op: str, *,
                   jmax: int, threshold=0,
                   weights: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment OR/AND/XOR/ANDNOT/threshold reduction + cardinality.

    slab: (N, WORDS) int32 rows grouped segment-major; starts: (S + 1,)
    int32 row offsets (segment ``s`` owns rows ``starts[s]:starts[s+1]``);
    jmax: an upper bound on the segment length.  Returns (words (S, WORDS)
    int32, cards (S,) int32).  Empty segments reduce to zero words and card
    0 for every op, AND included.

    op "andnot" treats each segment's first row as the minuend:
    row0 & ~(row1 | row2 | ...).  ``weights`` (N,) int32 are per-row
    occurrence weights for op "threshold" (default 1 per row).
    ``threshold`` is an int or a (S,) int32 tensor of per-segment
    thresholds (the coalesced multi-query path).
    """
    dev = slab.device
    slab = slab.to(torch.int32)
    starts = starts.to(device=dev, dtype=torch.int64)
    n = slab.shape[0]
    s = starts.shape[0] - 1
    seg_len = starts[1:] - starts[:-1]                          # (S,)
    if n == 0:                                  # every segment is empty
        return (torch.zeros((s, WORDS), dtype=torch.int32, device=dev),
                torch.zeros((s,), dtype=torch.int32, device=dev))
    row = starts[:-1, None] + torch.arange(jmax, device=dev)[None, :]
    valid = row < starts[1:, None]                              # (S, jmax)
    rows = row.clamp(max=n - 1)
    g = slab[rows]                                      # (S, jmax, WORDS)
    if op == "threshold":
        g = torch.where(valid[..., None], g, 0)
        if weights is None:
            w = torch.ones((s, jmax), dtype=torch.int32, device=dev)
        else:
            w = weights.to(device=dev, dtype=torch.int32)[rows]
        w = torch.where(valid, w, 0)
        t = torch.as_tensor(threshold, dtype=torch.int64, device=dev)
        if t.ndim == 1:
            t = t[:, None]                                      # (S, 1)
        out = torch.zeros((s, WORDS), dtype=torch.int64, device=dev)
        for b in range(32):
            cnt = (((g >> b) & 1) * w[..., None]).sum(dim=1,
                                                      dtype=torch.int64)
            out |= (cnt >= t).to(torch.int64) << b
        out = out.to(torch.int32)       # wraps bit 31 into the sign bit
    elif op == "andnot":
        g = torch.where(valid[..., None], g, 0)
        rest = torch.zeros((s, WORDS), dtype=torch.int32, device=dev)
        for j in range(1, jmax):
            rest |= g[:, j]
        out = g[:, 0] & ~rest
    elif op in ("or", "and", "xor"):
        ident = -1 if op == "and" else 0
        g = torch.where(valid[..., None], g, ident)
        out = g[:, 0].clone()
        for j in range(1, jmax):
            if op == "or":
                out |= g[:, j]
            elif op == "and":
                out &= g[:, j]
            else:
                out ^= g[:, j]
    else:
        raise ValueError(op)
    out = torch.where((seg_len > 0)[:, None], out, 0)
    return out, popcount_words(out)


def segment_reduce_rows(table: torch.Tensor, ids: torch.Tensor,
                        starts: torch.Tensor, op: str, *, jmax: int,
                        threshold=0, weights: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_reduce` over ``table[ids]`` (``ids`` index a resident
    arena slab segment-major; padding points at the reserved zero row 0)."""
    slab = table[ids.to(device=table.device, dtype=torch.int64)]
    return segment_reduce(slab, starts, op, jmax=jmax, threshold=threshold,
                          weights=weights)


def gather_rows_dual(table: torch.Tensor, staged: torch.Tensor,
                     pos: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """Two-source row gather: slot ``i`` reads ``table[pos[i]] |
    staged[sidx[i]]``.  Exactly one side of every slot is a real row and
    the other a reserved all-zero row, so the OR is exact slot selection."""
    return (table[pos.to(device=table.device, dtype=torch.int64)]
            | staged[sidx.to(device=staged.device, dtype=torch.int64)])


def segment_reduce_rows_dual(table: torch.Tensor, staged: torch.Tensor,
                             pos: torch.Tensor, sidx: torch.Tensor,
                             starts: torch.Tensor, op: str, *, jmax: int,
                             threshold=0,
                             weights: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_reduce` over :func:`gather_rows_dual` rows: resident
    rows from the arena slab by position, cold rows from a small per-call
    ``staged`` block."""
    slab = gather_rows_dual(table, staged, pos, sidx)
    return segment_reduce(slab, starts, op, jmax=jmax, threshold=threshold,
                          weights=weights)


METRICS = ("jaccard", "cosine", "containment")   # index == metric id


def similarity_scores(inter: torch.Tensor, q_card, cards: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Similarity scores from intersection cardinalities, float32.

    jaccard = |A∩B| / |A∪B|, cosine = |A∩B| / sqrt(|A||B|), containment =
    |A∩B| / |A| (the query side), all from the AND cardinality by
    inclusion-exclusion.  A zero denominator scores 1.0.  The formula runs
    in float32 in a fixed operation order (each step rounded on its own),
    the order of the JAX package's ``similarity_scores``, of the CUDA
    kernel's finalize and of the numpy host version
    (``core.pairwise._scores_host``), so all of them give the same bits
    and the same top-k tie order."""
    interf = inter.to(torch.float32)
    qc = torch.as_tensor(q_card, device=inter.device).to(torch.float32)
    oc = cards.to(device=inter.device, dtype=torch.float32)
    if metric == "jaccard":
        denom = qc + oc - interf
    elif metric == "cosine":
        # torch.sqrt on float32 CPU tensors is not correctly rounded (its
        # vectorized path is off by an ulp on about 0.7% of large
        # products); the float64 root rounded once to float32 is, as is
        # the kernel's __fsqrt_rn and numpy's np.sqrt
        denom = torch.sqrt((qc * oc).to(torch.float64)).to(torch.float32)
    elif metric == "containment":
        denom = qc.expand(oc.shape)
    else:
        raise ValueError(metric)
    return torch.where(denom > 0, interf / denom, torch.ones_like(interf))


def similarity_score(rows: torch.Tensor, row_col: torch.Tensor,
                     starts: torch.Tensor, q_words: torch.Tensor, q_card,
                     cards: torch.Tensor, exclude: int = -1, *,
                     metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The score stage: per-candidate intersection cardinality and score.

    rows: (N, WORDS) int32 candidate rows, candidate-major (candidate ``t``
    owns rows ``starts[t]:starts[t+1]``); row_col: (N,) int32 column of
    each row's chunk key in ``q_words`` (C, WORDS) int32; q_card: the
    query's cardinality; cards: (T,) int32.  ``exclude`` is a candidate
    index scored -1.0 (-1: none).  Returns (score (T,) float32, inter (T,)
    int32).  The intersection is summed per candidate, never as a global
    prefix: the grand total over all candidates can overflow int32 where
    no candidate's own count can."""
    dev = rows.device
    starts = starts.to(device=dev, dtype=torch.int64)
    t = starts.shape[0] - 1
    n = rows.shape[0]
    per_row = popcount_words(
        rows & q_words[row_col.to(device=dev, dtype=torch.int64)])
    seg = torch.searchsorted(starts[1:], torch.arange(n, device=dev),
                             right=True)
    inter = torch.zeros(t, dtype=torch.int64, device=dev).index_add_(
        0, seg, per_row.to(torch.int64)).to(torch.int32)
    score = similarity_scores(inter, q_card, cards, metric)
    if 0 <= exclude < t:
        score[exclude] = -1.0
    return score, inter


def topk_select(score: torch.Tensor, inter: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The select stage: k rounds of (max, lowest index of the max), each
    recording the winner's value at that round, then masking it with -2.0
    -- the order of a stable descending sort (-0.0 and +0.0 tie).  A
    round's value is the entry's own score, or -2.0 once every entry above
    -2.0 is taken and the rounds repeat the lowest index at or above -2.0.
    score: (T,) float32, never NaN; inter: (T,) int32; 1 <= k <= T.
    Returns (idx (k,) int32, score (k,) float32, inter (k,) int32)."""
    if not 1 <= k <= score.shape[0]:
        raise ValueError(f"k={k} outside [1, {score.shape[0]}]")
    work = score.clone()
    picks, tops = [], []
    for _ in range(k):
        j = torch.argmax(work)              # the first maximum wins
        picks.append(j)
        tops.append(work[j].clone())
        work[j] = -2.0
    idx = torch.stack(picks)
    return idx.to(torch.int32), torch.stack(tops), inter[idx].to(torch.int32)


def similarity_topk(rows: torch.Tensor, row_col: torch.Tensor,
                    starts: torch.Tensor, q_words: torch.Tensor, q_card,
                    cards: torch.Tensor, exclude: int = -1, *,
                    metric: str, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score then select: (idx (k,) int32, score (k,) float32, inter (k,)
    int32), best first, ties to the lowest candidate index."""
    score, inter = similarity_score(rows, row_col, starts, q_words, q_card,
                                    cards, exclude, metric=metric)
    return topk_select(score, inter, k)


def similarity_score_ids(table: torch.Tensor, pos: torch.Tensor,
                         row_col: torch.Tensor, starts: torch.Tensor,
                         q_words: torch.Tensor, q_card, cards: torch.Tensor,
                         gidx: torch.Tensor, n_valid: int, exclude: int = -1,
                         *, metric: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The score stage of one shard: :func:`similarity_score` over a
    candidate subset whose rows are ``table[pos]`` (a shard's slab read
    through local positions), each slot labelled with its global
    candidate id ``gidx`` (L,).  The slot whose global id is ``exclude``
    scores -1.0, and then every slot at or past ``n_valid`` (layout
    padding) scores -2.0 -- in that order, since an all-zero pad row would
    otherwise score 1.0 under the zero-denominator convention.  Returns
    (score (L,) float32, inter (L,) int32)."""
    rows = table[pos.to(device=table.device, dtype=torch.int64)]
    score, inter = similarity_score(rows, row_col, starts, q_words, q_card,
                                    cards, -1, metric=metric)
    slot = torch.arange(score.shape[0], device=score.device)
    score = torch.where(gidx.to(score.device) == exclude, -1.0, score)
    score = torch.where(slot >= n_valid, -2.0, score)
    return score, inter


def topk_select_ids(score: torch.Tensor, inter: torch.Tensor,
                    gidx: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k over labelled entries: k rounds of (max score, lowest global
    id ``gidx`` among the maxes); every entry with that id and score is
    masked to -2.0 together, and the round's intersection is the largest
    of theirs (at least 0).  It is the shard-merge tie rule: applied to
    each shard's candidates and again to the gathered S*k lists, it gives
    the order of :func:`topk_select` over all candidates, ties to the
    lowest global index.  Any k >= 1: once every entry is masked, rounds
    repeat the lowest id among the -2.0 entries, as the JAX package's do.
    A round's max is jnp.max's: +0.0 if any entry holds +0.0 bits among
    maxima of zero, -0.0 only when every one of them is -0.0.
    Returns (gidx (k,) int32, score (k,) float32, inter (k,) int32)."""
    if k < 1 or score.shape[0] < 1:
        raise ValueError(f"need k >= 1 and >= 1 entry, got k={k}, "
                         f"{score.shape[0]} entries")
    big = torch.tensor(2**31 - 1, dtype=torch.int32, device=score.device)
    gidx = gidx.to(torch.int32)
    inter = inter.to(torch.int32)
    work = score.to(torch.float32).clone()
    ids, tops, inters = [], [], []
    pos_zero = torch.zeros((), dtype=torch.float32, device=score.device)
    for _ in range(k):
        m = work.max()
        # jnp.max's zero: +0.0 while any entry holds +0.0 bits
        m = torch.where((m == 0) & (work.view(torch.int32) == 0).any(),
                        pos_zero, m)
        w = torch.where(work == m, gidx, big).min()
        hit = (gidx == w) & (work == m)
        ids.append(w)
        tops.append(m)
        inters.append(torch.where(hit, inter, 0).max())
        work = torch.where(hit, -2.0, work)
    return torch.stack(ids), torch.stack(tops), torch.stack(inters)


def similarity_topk_ids(table: torch.Tensor, pos: torch.Tensor,
                        row_col: torch.Tensor, starts: torch.Tensor,
                        q_words: torch.Tensor, q_card, cards: torch.Tensor,
                        gidx: torch.Tensor, n_valid: int, exclude: int = -1,
                        *, metric: str, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's score then select: (gidx (k,) int32, score (k,)
    float32, inter (k,) int32), best first, ties to the lowest global
    id."""
    score, inter = similarity_score_ids(table, pos, row_col, starts,
                                        q_words, q_card, cards, gidx,
                                        n_valid, exclude, metric=metric)
    return topk_select_ids(score, inter, gidx, k)


# ---------------------------------------------------------------------------
# two-by-two pair classes
# ---------------------------------------------------------------------------

def bitset_pair_op(a: torch.Tensor, b: torch.Tensor, opids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixed-op batched bitset algebra: row ``r`` applies ``PAIR_OPS[i]``
    for op id ``i = opids[r]`` -- 0 and, 1 or, 2 xor, and andnot for EVERY
    other id (3, negative, above 3), as the TPU kernel selects.

    a, b: (M, WORDS) int32 words; opids: (M,) int.  Returns (words (M,
    WORDS) int32, cards (M,) int32)."""
    sel = opids.to(device=a.device, dtype=torch.int32)[:, None]
    r = torch.where(sel == 0, a & b,
                    torch.where(sel == 1, a | b,
                                torch.where(sel == 2, a ^ b, a & ~b)))
    return r, popcount_words(r)


def bitset_pair_card(a: torch.Tensor, b: torch.Tensor,
                     opids: torch.Tensor) -> torch.Tensor:
    """Count-only :func:`bitset_pair_op`: (M,) int32."""
    return bitset_pair_op(a, b, opids)[1]


def _slots_below(card: torch.Tensor) -> torch.Tensor:
    """(M, ARRAY_CAP) bool: slot < card, so a card outside [0, ARRAY_CAP]
    acts clamped."""
    pos = torch.arange(ARRAY_CAP, device=card.device)
    return pos[None, :] < card.to(torch.int64)[:, None]


_INT32_MAX = 2**31 - 1
_ARRAY_CHUNK = 4096     # rows per pass of the sorted-array searches: int64
                        # search indices of 128 MiB (32 KiB a row)


def _found(rows: torch.Tensor, card: torch.Tensor, probes: torch.Tensor
           ) -> torch.Tensor:
    """(M, P) bool: whether each probe occurs among the first ``card[r]``
    slots of its row (sorted there).  A batched ``searchsorted`` and one
    gather, O(M * ARRAY_CAP) memory; the slots at and above the card are
    padded with INT32_MAX, which keeps the row sorted, and the lower bound
    must fall below the card, so a padding slot never matches -- the JAX
    reference's rule (its Pallas kernel pads with a value that an
    off-contract probe of 65537 matches)."""
    padded = torch.where(_slots_below(card), rows, _INT32_MAX)
    idx = torch.searchsorted(padded, probes)
    n = card.to(torch.int64).clamp(0, ARRAY_CAP)[:, None]
    hit = torch.gather(padded, 1, idx.clamp(max=ARRAY_CAP - 1)) == probes
    return hit & (idx < n)


def _intersect_chunks(a_vals, a_card, b_vals, b_card, b_side: bool):
    """Per ``_ARRAY_CHUNK`` rows: (row slice, A-side hits, B-side hits or
    None), bool (rows, ARRAY_CAP), 0 at and above each side's card."""
    for lo in range(0, a_vals.shape[0], _ARRAY_CHUNK):
        s = slice(lo, lo + _ARRAY_CHUNK)
        av, bv = a_vals[s].to(torch.int32), b_vals[s].to(torch.int32)
        ac, bc = a_card[s], b_card[s]
        hit_a = _found(bv, bc, av) & _slots_below(ac)
        hit_b = _found(av, ac, bv) & _slots_below(bc) if b_side else None
        yield s, hit_a, hit_b


def array_intersect_mask(a_vals: torch.Tensor, a_card: torch.Tensor,
                         b_vals: torch.Tensor, b_card: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted-array intersection, A's side (paper section 4.2): mask[r, i]
    = 1 where A's slot i (< a_card) holds a value of B's first b_card
    slots, and count = the sum of the mask.

    a_vals, b_vals: (M, ARRAY_CAP) int32, sorted and distinct in [0,
    65535] below their card; a_card, b_card: (M,) int (a card outside [0,
    ARRAY_CAP] acts clamped).  Returns (mask (M, ARRAY_CAP) int32, count
    (M,) int32).  The JAX reference's mask is bool and built from an
    all-vs-all (M, 4096, 4096) compare cube; here A is searched in B, in
    row chunks, with the same values."""
    mask = torch.empty(a_vals.shape, dtype=torch.int32,
                       device=a_vals.device)
    for s, hit, _ in _intersect_chunks(a_vals, a_card, b_vals, b_card,
                                       False):
        mask[s] = hit
    return mask, mask.sum(dim=-1, dtype=torch.int32)


def array_pair_masks(a_vals: torch.Tensor, a_card: torch.Tensor,
                     b_vals: torch.Tensor, b_card: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-sided membership of sorted array pairs: mask_a as in
    :func:`array_intersect_mask`, mask_b the same from B's side, count =
    sum of mask_a.

    Returns (mask_a, mask_b (M, ARRAY_CAP) int32, count (M,) int32).  Each
    side is searched in the other (not the JAX reference's all-vs-all
    cube, 16 MiB a row); the masks are the same."""
    mask_a = torch.empty(a_vals.shape, dtype=torch.int32,
                         device=a_vals.device)
    mask_b = torch.empty_like(mask_a)
    for s, hit_a, hit_b in _intersect_chunks(a_vals, a_card, b_vals, b_card,
                                             True):
        mask_a[s], mask_b[s] = hit_a, hit_b
    return mask_a, mask_b, mask_a.sum(dim=-1, dtype=torch.int32)


def array_intersect_count(a_vals: torch.Tensor, a_card: torch.Tensor,
                          b_vals: torch.Tensor, b_card: torch.Tensor
                          ) -> torch.Tensor:
    """Count-only :func:`array_intersect_mask`: (M,) int32 |A ∩ B| per
    row, no mask kept."""
    count = torch.empty(a_vals.shape[0], dtype=torch.int32,
                        device=a_vals.device)
    for s, hit, _ in _intersect_chunks(a_vals, a_card, b_vals, b_card,
                                       False):
        count[s] = hit.sum(dim=-1, dtype=torch.int32)
    return count


def array_bitset_probe(vals: torch.Tensor, card: torch.Tensor,
                       words: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit test of each array value in its row's bitset: mask[r, i] = bit
    ``vals[r, i]`` of ``words[r]`` for slots below card[r], else 0.

    vals: (M, ARRAY_CAP) int32; card: (M,) int; words: (M, WORDS) int32.
    Returns (mask (M, ARRAY_CAP) int32, count (M,) int32).  A value
    outside [0, 65535] is outside the contract: its word index is clipped
    to [0, WORDS - 1] and its bit is ``value & 31``, as the JAX reference
    does (the Pallas kernel gives 0 there instead)."""
    vals = vals.to(torch.int32)
    widx = (vals >> 5).clamp(0, WORDS - 1).to(torch.int64)
    w = torch.gather(words, 1, widx)
    bit = (w >> (vals & 31)) & 1
    mask = torch.where(_slots_below(card), bit, 0).to(torch.int32)
    return mask, mask.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# array <-> bitset conversion (paper sections 3.1 / 3.2)
# ---------------------------------------------------------------------------

_BITS_CHUNK = 2048      # rows per pass of bitset_to_array: < 400 MiB of
                        # temporaries (64 KiB of bits a row and at most
                        # 4,127 positions of 16 bytes)


def array_to_bitset(values: torch.Tensor, card: torch.Tensor
                    ) -> torch.Tensor:
    """(M, ARRAY_CAP) int values, (M,) card -> (M, WORDS) int32 words.

    The first ``card[r]`` slots of row r are its values (a card above
    ARRAY_CAP makes every slot valid, one of 0 or below none).  Each valid
    value v in [0, 65535] ADDS ``1 << (v & 31)`` to word ``v >> 5`` modulo
    2^32, the JAX package's disjoint-sum trick: distinct values make that an
    OR, and a repeated value carries into the next bit, as in both JAX
    versions.  A value outside [0, 65535] drops, as in the Pallas kernel
    (the JAX ``ref.array_to_bitset`` instead wraps a negative word index).
    Only the valid slots are gathered, so no scatter index is out of
    range; memory is about 20 KiB a row (a mask and int64 words) and 40
    bytes a valid value."""
    m = values.shape[0]
    vals = values.to(torch.int32)
    valid = _slots_below(card) & (vals >= 0) & (vals < CONTAINER_BITS)
    r, c = valid.nonzero(as_tuple=True)
    v = vals[r, c].to(torch.int64)
    out = torch.zeros(m * WORDS, dtype=torch.int64, device=values.device)
    out.index_add_(0, r * WORDS + (v >> 5), torch.ones_like(v) << (v & 31))
    return (out & 0xFFFFFFFF).to(torch.int32).view(m, WORDS)


def bitset_set_many(words: torch.Tensor, values: torch.Tensor,
                    card: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """OR an array container into existing (M, WORDS) int32 words,
    tracking the cardinality change with the paper's XOR trick (section
    3.2).  Returns (new words, delta (M,) int32 = popcount(old ^ new))."""
    new = words | array_to_bitset(values, card)
    return new, popcount_words(words ^ new)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(M, WORDS) int32 -> (M, CONTAINER_BITS) bool: bit i of the container
    at column i (words read as little-endian bytes, as CPU and GPU are)."""
    b = words.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((b[..., None] >> shifts) & 1).view(words.shape[0], -1).bool()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_bits`: (M, CONTAINER_BITS) bool -> (M,
    WORDS) int32."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = bits.view(bits.shape[0], -1, 8).to(torch.uint8) << shifts
    return b.sum(dim=-1, dtype=torch.uint8).view(torch.int32)


def first_positions(words: torch.Tensor, limit: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first ``limit`` set bits of each row, in order: (row, rank,
    position) int64 triples.  Words past the ``limit``-th set bit are
    masked first, so at most ``limit + 31`` positions a row are listed."""
    per = popcount_u32(words)
    before = torch.cumsum(per, dim=1) - per
    bits = unpack_bits(torch.where(before < limit, words, 0))
    r, pos = bits.nonzero(as_tuple=True)
    counts = torch.bincount(r, minlength=words.shape[0])
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(r.numel(), device=words.device) - first[r]
    keep = rank < limit
    return r[keep], rank[keep], pos[keep]


def bitset_to_array(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, WORDS) int32 -> ((N, ARRAY_CAP) int32 sorted values, (N,) int32
    card), the section 3.1 extraction.  Positions beyond the cardinality
    are padded with CONTAINER_BITS (an impossible value); a row of more
    than ARRAY_CAP bits keeps its ARRAY_CAP smallest, matching the
    fixed-capacity layout.  The JAX reference expands a 2^16-long prefix
    sum a row; this lists the set bits instead, in chunks of rows."""
    n = words.shape[0]
    vals = torch.full((n, ARRAY_CAP), CONTAINER_BITS, dtype=torch.int32,
                      device=words.device)
    for lo in range(0, n, _BITS_CHUNK):
        r, rank, pos = first_positions(words[lo:lo + _BITS_CHUNK], ARRAY_CAP)
        vals[lo + r, rank] = pos.to(torch.int32)
    return vals, popcount_words(words)


# ---------------------------------------------------------------------------
# bit-sliced occurrence counters: the exchange of the sharded threshold path
# (each shard counts its rows, the shards' counters are added bit-sliced,
# then one comparator pass gives the words).  Plain PyTorch on every device,
# as the JAX package's are plain jnp on every backend: no Pallas site.
# ---------------------------------------------------------------------------

_COUNT_ELEMS = 1 << 24  # gathered words per pass of segment_counters: int64
                        # temporaries of 128 MiB


def segment_counters(slab: torch.Tensor, starts: torch.Tensor, *, jmax: int,
                     planes: int, weights: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Per-segment bit-sliced occurrence counters: for every one of the
    2^16 bit positions, the (weighted) count of the segment's rows that set
    it, as (S, planes, WORDS) int32 words where plane ``p`` holds bit ``p``
    of each count.  slab (N, WORDS) int32 rows segment-major, starts
    (S + 1,), jmax >= the longest segment, weights (N,) int32 (default 1);
    every count must be below 2^planes."""
    dev = slab.device
    starts = starts.to(device=dev, dtype=torch.int64)
    n, s = slab.shape[0], starts.shape[0] - 1
    out = torch.zeros((s, planes, WORDS), dtype=torch.int32, device=dev)
    if n == 0 or s == 0:
        return out
    step = max(1, _COUNT_ELEMS // (jmax * WORDS))
    for lo in range(0, s, step):
        st = starts[lo:lo + step + 1]
        row = st[:-1, None] + torch.arange(jmax, device=dev)[None, :]
        valid = row < st[1:, None]
        rows = row.clamp(max=n - 1)
        g = torch.where(valid[..., None], slab[rows], 0)
        w = torch.ones_like(rows, dtype=torch.int64) if weights is None \
            else weights.to(device=dev, dtype=torch.int64)[rows]
        w = torch.where(valid, w, 0)
        acc = torch.zeros((st.shape[0] - 1, planes, WORDS),
                          dtype=torch.int64, device=dev)
        for b in range(32):
            cnt = (((g >> b) & 1) * w[..., None]).sum(dim=1)
            for p in range(planes):
                acc[:, p] |= ((cnt >> p) & 1) << b
        out[lo:lo + step] = acc.to(torch.int32)   # bit 31 into the sign
    return out


def bitsliced_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ripple-carry add of two bit-sliced counter sets (..., planes, WORDS)
    int32.  The sum keeps ``planes`` planes: callers size them so that the
    total over every shard fits."""
    carry = torch.zeros_like(a[..., 0, :])
    out = []
    for i in range(a.shape[-2]):
        ai, bi = a[..., i, :], b[..., i, :]
        out.append(ai ^ bi ^ carry)
        carry = (ai & bi) | (carry & (ai ^ bi))
    return torch.stack(out, dim=-2)


def counters_ge(planes_arr: torch.Tensor, t) -> torch.Tensor:
    """Bitwise magnitude comparator: the words of the positions whose
    bit-sliced count (..., planes, WORDS) is >= ``t``, an int or a (S,)
    tensor of per-segment thresholds against (S, planes, WORDS) counters.
    Only the low ``planes`` bits of ``t`` are read.  Returns (..., WORDS)
    int32."""
    t = torch.as_tensor(t, dtype=torch.int64, device=planes_arr.device)
    if t.ndim == 1:
        t = t[:, None]                  # broadcast over the word lanes
    gt = torch.zeros_like(planes_arr[..., 0, :])
    eq = torch.full_like(gt, -1)
    for i in reversed(range(planes_arr.shape[-2])):
        ci = planes_arr[..., i, :]
        tmask = (-((t >> i) & 1)).to(torch.int32)   # all ones or zero
        gt = gt | (eq & ci & ~tmask)
        eq = eq & ~(ci ^ tmask)
    return gt | eq


# ---------------------------------------------------------------------------
# Roaring block-sparse decode attention (one new token over a KV cache)
# ---------------------------------------------------------------------------

NEG_INF = -1e30         # the TPU kernel's mask value (finite: exp -> 0)


def block_mask_bits(block_mask_words: torch.Tensor,
                    n_blocks: int) -> torch.Tensor:
    """(B, W) int32 words (bit-reinterpreted uint32) -> (B, n_blocks) bool,
    block ``j`` in word ``j >> 5`` at bit ``j & 31``.  The arithmetic shift
    of int32 leaves the low bit exact, so no widening is needed."""
    blk = torch.arange(n_blocks, device=block_mask_words.device)
    words = block_mask_words.to(torch.int32)[:, blk >> 5]
    return ((words >> (blk & 31).to(torch.int32)) & 1).bool()


def block_sparse_attention_decode(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  block_mask_words: torch.Tensor,
                                  kv_len: torch.Tensor, block_size: int = 128,
                                  sm_scale: float | None = None,
                                  softcap: float = 0.0) -> torch.Tensor:
    """Decode attention where key/value blocks are visible only if their bit
    is set in a Roaring bitset container row.

    q (B, H, D); k, v (B, Hkv, S, D); block_mask_words (B, ceil(S/bs/32))
    int32; kv_len (B,).  Returns (B, H, D) in q's dtype.

    This computes the JAX package's Pallas kernel's function
    (``repro/kernels/block_sparse_attn.py``): q.k in float32, then
    ``* sm_scale``, then the softcap, then -1e30 past ``kv_len`` and on
    invisible blocks, an exact softmax with float32 weights times float32
    values, and zeros where no position is visible.  The JAX package's
    ``ref.block_sparse_attention_decode`` instead rounds the weights to the
    cache dtype before the PV product, a different function in bfloat16
    (ROADMAP Queue 3); the port follows the kernel."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.matmul(qg, k.float().transpose(-1, -2)) * scale  # (b,hkv,g,s)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    pos = torch.arange(s, device=q.device)
    visible = block_mask_bits(block_mask_words, -(-s // block_size))[
        :, pos // block_size]
    visible &= pos[None, :] < kv_len.to(pos.device)[:, None]
    sc = torch.where(visible[:, None, None, :], sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)
    out = torch.where(visible.any(dim=-1)[:, None, None, None], out, 0.0)
    return out.reshape(b, h, d).to(q.dtype)


SPLIT_CHUNK = 8         # keys a unit of the decode kernel's split


def decode_attention_partials(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              block_mask_words: torch.Tensor,
                              kv_len: torch.Tensor, splits: int, *,
                              block_size: int = 128,
                              sm_scale: float | None = None,
                              softcap: float = 0.0) -> torch.Tensor:
    """The split step of the decode kernel (flash-decoding), plainly: each
    (sequence, KV head) row's visible keys below kv_len, in ascending
    order, are cut into chunks of ``SPLIT_CHUNK`` keys per visible block
    (the last visible block's chunks only up to kv_len), and the N chunks
    into ``splits`` = P ranges [p N / P, (p + 1) N / P).  Range p's
    partial over its keys is m = the largest score (-1e30 if it has
    none), l = sum e^(s - m) and acc = sum e^(s - m) v, with the scores of
    :func:`block_sparse_attention_decode`.  Returns (B, H, P, D + 2)
    float32, each row (m, l, acc).  Used by no main path: it is what the
    kernel's partials are checked against."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    nblk = s // block_size
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.matmul(qg, k.float().transpose(-1, -2)) * scale  # (b,hkv,g,s)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    kvl = kv_len.to(device=q.device, dtype=torch.int64)
    blk = torch.arange(nblk, device=q.device)
    vis_blk = block_mask_bits(block_mask_words, nblk) \
        & (blk[None, :] * block_size < kvl[:, None])
    pos = torch.arange(s, device=q.device)
    valid = vis_blk[:, pos // block_size] & (pos[None, :] < kvl[:, None])
    rank = torch.cumsum(vis_blk.to(torch.int64), dim=1) - 1
    unit = (rank[:, pos // block_size] * (block_size // SPLIT_CHUNK)
            + (pos % block_size)[None, :] // SPLIT_CHUNK)         # (b, s)
    n_units = torch.where(valid, unit + 1, 0).amax(dim=1)          # (b,)
    lo = n_units[:, None] * torch.arange(1, splits + 1,
                                         device=q.device) // splits
    owner = torch.searchsorted(lo, unit.contiguous(), right=True)  # (b, s)
    vf = v.float()
    parts = []
    for p in range(splits):
        sel = (valid & (owner == p))[:, None, None, :]
        sp = torch.where(sel, sc, NEG_INF)
        m = sp.amax(dim=-1, keepdim=True)
        e = torch.exp(sp - m) * sel
        acc = torch.matmul(e, vf)                                # (b,hkv,g,d)
        parts.append(torch.cat([m, e.sum(dim=-1, keepdim=True), acc], -1))
    return torch.stack(parts, dim=3).reshape(b, h, splits, d + 2)


def combine_partials(partials: torch.Tensor) -> torch.Tensor:
    """The merge step, plainly: (B, H, P, D + 2) float32 partials (m, l,
    acc) -> (B, H, D) float32, m = max_p m_p, l = sum_p l_p e^(m_p - m),
    out = sum_p acc_p e^(m_p - m) / l, or 0 where l = 0."""
    m = partials[..., 0]
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))              # (b, h, p)
    lsum = (partials[..., 1] * w).sum(dim=-1)
    acc = (partials[..., 2:] * w[..., None]).sum(dim=-2)
    return torch.where(lsum[..., None] > 0,
                       acc / torch.where(lsum > 0, lsum, 1.0)[..., None],
                       0.0)
