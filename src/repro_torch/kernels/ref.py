"""Plain PyTorch versions of the port's kernels.

These are the torch twins of the JAX package's ``kernels/ref.py`` for the
segmented wide-aggregation slice.  The CPU tests run them against the JAX
reference, and ``chip_smoke.py`` holds the CUDA kernel against them on the
card.  Nothing on the card's main path calls them.

Word layout: one Roaring bitset container = 2048 32-bit words, bit ``i`` in
word ``i >> 5`` at position ``i & 31``.  Words are held as bit-reinterpreted
``torch.int32`` (this torch build has no ``~`` or ``>>`` on ``uint32``);
convert to and from numpy ``uint32`` at the boundary with ``.view``.
``>>`` on int32 shifts arithmetically, so every shift below is masked.
"""

from __future__ import annotations

import torch

WORDS = 2048            # 32-bit words per 2^16-bit container

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """(..., WORDS) int32 words -> (...,) int32 cardinality (SWAR popcount
    in int64, so no intermediate can overflow or sign-extend)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = ((v * 0x01010101) >> 24) & 0xFF
    return v.sum(dim=-1).to(torch.int32)


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
