"""Segmented wide-aggregation kernel: K-way OR/AND/XOR/ANDNOT/threshold
reductions fused with cardinality, one CUDA launch per call.

The host planner (``repro_torch.core.aggregate``) stacks every container
that shares a 16-bit chunk key into consecutive rows and describes the
segments with a row-offset vector ``starts`` (S + 1,): segment ``s`` owns
rows ``starts[s]:starts[s+1]``.  One launch produces, per segment, the
reduced words and their popcount.  The rows come from one of three sources,
each its own wrapper:

  * :func:`segment_reduce` -- a slab of rows in segment order;
  * :func:`segment_reduce_rows` -- ``table[ids]``, rows of a resident
    ``BitmapArena`` slab;
  * :func:`segment_reduce_rows_dual` -- ``table[pos] | staged[sidx]``, the
    resident slab plus a small per-call block of cold rows.

The kernel (``csrc/segment_reduce.cu``) folds the gather into its loads.
On a CUDA tensor each wrapper launches it or raises; on a CPU tensor it
takes the plain version in ``kernels/ref.py``.  ``launches`` counts kernel
launches (CPU calls do not count), ``launches_by_source`` splits the count
by row source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import WORDS

OPS = ("or", "and", "xor", "andnot", "threshold")
_SOURCES = ("slab", "ids", "dual")
MAX_PLANES = 31         # total weight < 2^31 (aggregate._check_weights)

launches = 0
launches_by_source = {src: 0 for src in _SOURCES}


def counter_planes(jmax: int) -> int:
    """Bit-sliced counter planes needed to count up to ``jmax`` inputs."""
    return max(1, int(jmax).bit_length())


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for src in _SOURCES:
        launches_by_source[src] = 0


@functools.cache
def _kernel():
    """The C entry point, built and bound on first use."""
    fn = _build.library("segment_reduce").segment_reduce_cuda
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, n, p, n, p, p, n, i, p, i, i, p, p, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor | None, device: torch.device,
           ndim: int, width: int | None = None) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim or (width is not None and t.shape[-1] != width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim == 2 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(src: str, table, staged, pos, sidx, starts, op, jmax,
            threshold, weights, planes, wbits):
    """Validate, allocate the outputs and launch on the current stream.
    Offsets and row indices are checked on the device, inside the kernel
    (a bad one traps there and raises at the next synchronisation), so
    the host never waits on them."""
    global launches
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"table is on {dev}; the kernel needs CUDA")
    n_seg = starts.shape[0] - 1
    tvec = None                     # T is read by the threshold body only
    if op == "threshold" and isinstance(threshold, torch.Tensor):
        tvec = threshold
        if tvec.dim() == 0:
            tvec = tvec.reshape(1).expand(n_seg).contiguous()
    elif op == "threshold":
        tvec = torch.full((n_seg,), int(threshold), dtype=torch.int32,
                          device=dev)
    for name, t, nd, wd in (("table", table, 2, WORDS),
                            ("staged", staged, 2, WORDS),
                            ("ids", pos, 1, None), ("sidx", sidx, 1, None),
                            ("starts", starts, 1, None),
                            ("threshold", tvec, 1, None),
                            ("weights", weights, 1, None)):
        _check(name, t, dev, nd, wd)
    if n_seg < 1 or (tvec is not None and tvec.shape[0] != n_seg):
        raise ValueError("need >= 1 segment and one threshold per segment")
    slots = table.shape[0] if src == "slab" else pos.shape[0]
    if src == "dual" and sidx.shape[0] != slots:
        raise ValueError("pos and sidx must have one entry per slot")
    if weights is not None and weights.shape[0] < slots:
        raise ValueError("weights need one entry per row")
    if planes is None:
        # wide enough for jmax rows of weight < 2^wbits, and for an int T
        planes = counter_planes(jmax * ((1 << wbits) - 1))
        if not isinstance(threshold, torch.Tensor):
            planes = max(planes, int(threshold).bit_length())
    if op == "threshold" and not (1 <= planes <= MAX_PLANES
                                  and 1 <= wbits <= MAX_PLANES):
        raise ValueError(f"planes={planes}, wbits={wbits} out of range")
    out = torch.empty((n_seg, WORDS), dtype=torch.int32, device=dev)
    cards = torch.zeros((n_seg,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(table), table.shape[0], _ptr(staged),
                 0 if staged is None else staged.shape[0], _ptr(pos),
                 _ptr(sidx), slots, _SOURCES.index(src), _ptr(starts),
                 n_seg, OPS.index(op), _ptr(tvec), _ptr(weights), planes,
                 wbits, _ptr(out), _ptr(cards), stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce_cuda({src}, {op}) failed: "
                           f"cudaError {err}")
    launches += 1
    launches_by_source[src] += 1
    return out, cards


def segment_reduce(slab: torch.Tensor, starts: torch.Tensor, op: str, *,
                   jmax: int, threshold=0,
                   weights: torch.Tensor | None = None,
                   planes: int | None = None, wbits: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segmented K-way reduction fused with cardinality.

    slab:   (N, WORDS) int32 rows, segment-major.
    starts: (S + 1,) int32 row offsets; empty segments give zero words and
            card 0 for every op.
    op:     "or" | "and" | "xor" | "andnot" | "threshold"; "andnot" treats
            each segment's first row as the minuend: row0 & ~OR(rest).
    jmax:   an upper bound on the segment length (it sets the default
            counter width; the kernel walks each segment's own length).
    threshold: T for op "threshold": an int, or a (S,) int32 tensor of
            per-segment thresholds (coalesced multi-query batches).
    weights: (N,) int32 per-row weights for op "threshold" (default 1);
            ``wbits`` is the bit width of the largest weight and
            ``planes`` the counter width (default: wide enough for jmax
            rows of weight < 2^wbits and for an int T); every segment's
            total weight and every T must be < 2^planes.

    Returns (words (S, WORDS) int32, cards (S,) int32) on slab's device.
    """
    if slab.device.type == "cpu":
        return ref.segment_reduce(slab, starts, op, jmax=jmax,
                                  threshold=threshold, weights=weights)
    return _launch("slab", slab, None, None, None, starts, op, jmax,
                   threshold, weights, planes, wbits)


def segment_reduce_rows(table: torch.Tensor, ids: torch.Tensor,
                        starts: torch.Tensor, op: str, *, jmax: int,
                        threshold=0, weights: torch.Tensor | None = None,
                        planes: int | None = None, wbits: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_reduce` over ``table[ids]``: ``ids`` (R,) int32 index
    a device-resident arena slab segment-major, so a warm query moves only
    ``ids`` and ``starts`` to the card.  The gather happens inside the
    kernel's loads."""
    if table.device.type == "cpu":
        return ref.segment_reduce_rows(table, ids, starts, op, jmax=jmax,
                                       threshold=threshold, weights=weights)
    return _launch("ids", table, None, ids, None, starts, op, jmax,
                   threshold, weights, planes, wbits)


def segment_reduce_rows_dual(table: torch.Tensor, staged: torch.Tensor,
                             pos: torch.Tensor, sidx: torch.Tensor,
                             starts: torch.Tensor, op: str, *, jmax: int,
                             threshold=0,
                             weights: torch.Tensor | None = None,
                             planes: int | None = None, wbits: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_reduce` over ``table[pos] | staged[sidx]``: resident
    rows by slab position, cold rows from a small per-call ``staged``
    block whose row 0 is zero (as is the table's), so the OR selects the
    one real row of each slot.  The resident slab is never copied."""
    if table.device.type == "cpu":
        return ref.segment_reduce_rows_dual(
            table, staged, pos, sidx, starts, op, jmax=jmax,
            threshold=threshold, weights=weights)
    return _launch("dual", table, staged, pos, sidx, starts, op, jmax,
                   threshold, weights, planes, wbits)
