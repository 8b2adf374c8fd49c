"""Similarity top-k: a score kernel and a select kernel, two CUDA launches,
and their labelled twins for one shard of the sharded engine.

``core.pairwise.SimilarityEngine`` lays its candidates out once, on the
device, in the form the JAX package's ``kernels/topk_ops.py`` consumes:

  * ``rows``    (N, WORDS) int32: every candidate container as a bitset row,
    candidate-major (candidate ``t`` owns rows ``starts[t]:starts[t+1]``;
    ragged, possibly empty);
  * ``row_col`` (N,) int32: the column of each row's chunk key in the query
    block, so a query without that key contributes nothing;
  * ``q_words`` (C, WORDS) int32: the query's containers over the global
    key columns, the only per-query block;
  * ``cards``   (T,) int32 candidate cardinalities.

:func:`similarity_score` launches the score kernel (intersection
cardinality and float32 metric per candidate) and :func:`topk_select` the
select kernel (the k rounds of max with ties to the lowest index, as one
rank by counting: one launch whatever k), both from
``csrc/similarity_topk.cu``; :func:`similarity_topk` runs the two in turn,
and only the k results leave the card.

The sharded engine (``SimilarityEngine(mesh=)``) gives each shard a subset
of the candidates, each slot labelled with its global candidate id:
:func:`similarity_score_ids` scores a shard's slots, reading their rows from
the shard's own slab through local positions, and :func:`topk_merge`
selects over labelled entries with ties to the lowest global id (one
sort-and-rank pass, not k rounds) -- once per shard, and once over the
gathered S*k lists.  :func:`similarity_topk_ids`
runs the first two in turn.  The JAX package's ``similarity_topk_ids``
selects inside its score call; here the two are separate launches.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it takes the plain version in ``kernels/ref.py``.  ``launches``
counts kernel launches (CPU calls do not count), ``launches_by_stage``
splits them into "score", "select", "score_ids" and "select_ids".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import METRICS, WORDS

_STAGES = ("score", "select", "score_ids", "select_ids")

launches = 0
launches_by_stage = {stage: 0 for stage in _STAGES}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for stage in _STAGES:
        launches_by_stage[stage] = 0


@functools.cache
def _kernels():
    """The C entry points (score, select, score_ids, select_ids and the
    labelled select's scratch size), built and bound on first use."""
    lib = _build.library("similarity_topk")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    score = lib.similarity_score_cuda
    score.argtypes = [p, n, p, p, i, p, n, i, p, i, i, p, p, p]
    score.restype = ctypes.c_int
    select = lib.similarity_select_cuda
    select.argtypes = [p, p, i, i, p, p, p, p, p]
    select.restype = ctypes.c_int
    score_ids = lib.similarity_score_ids_cuda
    score_ids.argtypes = [p, n, p, p, n, p, i, p, n, i, p, p, i, i, i, p, p,
                          p]
    score_ids.restype = ctypes.c_int
    select_ids = lib.similarity_select_ids_cuda
    select_ids.argtypes = [p, p, p, n, i, p, p, p, p, p]
    select_ids.restype = ctypes.c_int
    lib.similarity_select_ids_workspace.argtypes = [n, i]
    lib.similarity_select_ids_workspace.restype = ctypes.c_size_t
    return (score, select, score_ids, select_ids,
            lib.similarity_select_ids_workspace)


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype, ndim: int, width: int | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or (width is not None and t.shape[-1] != width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim == 2 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _count(stage: str) -> None:
    global launches
    launches += 1
    launches_by_stage[stage] += 1


def similarity_score(rows: torch.Tensor, row_col: torch.Tensor,
                     starts: torch.Tensor, q_words: torch.Tensor,
                     q_card: int, cards: torch.Tensor, exclude: int = -1, *,
                     metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The score stage: (score (T,) float32, inter (T,) int32).

    rows (N, WORDS), row_col (N,), starts (T + 1,), q_words (C, WORDS) and
    cards (T,) are int32 tensors on one device; ``q_card`` is the query's
    cardinality (< 2^31); ``exclude`` a candidate index scored -1.0 (-1:
    none); ``metric`` one of ``METRICS``.  Row offsets and key columns are
    checked on the device, inside the kernel: a bad one traps there and
    raises at the next synchronisation, so the host never waits on them."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if rows.device.type == "cpu":
        return ref.similarity_score(rows, row_col, starts, q_words, q_card,
                                    cards, exclude, metric=metric)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"rows are on {dev}; the kernel needs CUDA")
    for name, t, nd, wd in (("rows", rows, 2, WORDS),
                            ("row_col", row_col, 1, None),
                            ("starts", starts, 1, None),
                            ("q_words", q_words, 2, WORDS),
                            ("cards", cards, 1, None)):
        _check(name, t, dev, torch.int32, nd, wd)
    n_cand = starts.shape[0] - 1
    if row_col.shape[0] != rows.shape[0] or cards.shape[0] != n_cand:
        raise ValueError("need one row_col per row and one card per "
                         "candidate")
    if not 0 <= int(q_card) < 2**31 or q_words.shape[0] < 1:
        raise ValueError("need 0 <= q_card < 2^31 and >= 1 query row")
    score = torch.empty(n_cand, dtype=torch.float32, device=dev)
    inter = torch.empty(n_cand, dtype=torch.int32, device=dev)
    fn = _kernels()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), rows.shape[0], row_col.data_ptr(),
                 starts.data_ptr(), n_cand, q_words.data_ptr(),
                 q_words.shape[0], int(q_card), cards.data_ptr(),
                 int(exclude), METRICS.index(metric), score.data_ptr(),
                 inter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"similarity_score_cuda failed: cudaError {err}")
    _count("score")
    return score, inter


def topk_select(score: torch.Tensor, inter: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The select stage: (idx (k,) int32, score (k,) float32, inter (k,)
    int32), best first, ties to the lowest index; 1 <= k <= T.  Each
    round's score is its value after the earlier rounds' masking: the
    entry's own, or -2.0 once every entry above -2.0 is taken (see
    ``ref.topk_select``).  On CUDA, one launch and no scratch."""
    n = score.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if score.device.type == "cpu":
        return ref.topk_select(score, inter, k)
    dev = score.device
    if dev.type != "cuda":
        raise ValueError(f"score is on {dev}; the kernel needs CUDA")
    _check("score", score, dev, torch.float32, 1)
    _check("inter", inter, dev, torch.int32, 1)
    if inter.shape[0] != n:
        raise ValueError("score and inter differ in length")
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.float32, device=dev)
    top_inter = torch.empty(k, dtype=torch.int32, device=dev)
    fn = _kernels()[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(score.data_ptr(), inter.data_ptr(), n, k, None,
                 idx.data_ptr(), top.data_ptr(), top_inter.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"similarity_select_cuda failed: cudaError {err}")
    _count("select")
    return idx, top, top_inter


def similarity_topk(rows: torch.Tensor, row_col: torch.Tensor,
                    starts: torch.Tensor, q_words: torch.Tensor, q_card: int,
                    cards: torch.Tensor, exclude: int = -1, *, metric: str,
                    k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the query against every candidate, then select the best k:
    (idx (k,) int32, score (k,) float32, inter (k,) int32), best first,
    ties at equal score to the lowest candidate index.  On CUDA, two
    launches; the scores never leave the card."""
    score, inter = similarity_score(rows, row_col, starts, q_words, q_card,
                                    cards, exclude, metric=metric)
    return topk_select(score, inter, k)


def similarity_score_ids(table: torch.Tensor, pos: torch.Tensor,
                         row_col: torch.Tensor, starts: torch.Tensor,
                         q_words: torch.Tensor, q_card: int,
                         cards: torch.Tensor, gidx: torch.Tensor,
                         n_valid: int, exclude: int = -1, *, metric: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's score stage: (score (L,) float32, inter (L,) int32).

    table (P, WORDS) is the shard's slab; slot ``t`` owns the entries
    ``starts[t]:starts[t+1]`` of pos and row_col (R,), and reads its rows
    as ``table[pos[r]]`` against ``q_words[row_col[r]]``; cards and gidx
    (L,) are the slots' cardinalities and global candidate ids, all int32
    on one device.  The slot whose global id is ``exclude`` scores -1.0,
    then every slot at or past ``n_valid`` scores -2.0.  Positions, key
    columns and offsets are checked inside the kernel (a bad one traps)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if table.device.type == "cpu":
        return ref.similarity_score_ids(table, pos, row_col, starts,
                                        q_words, q_card, cards, gidx,
                                        n_valid, exclude, metric=metric)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"table is on {dev}; the kernel needs CUDA")
    for name, t, nd, wd in (("table", table, 2, WORDS), ("pos", pos, 1, None),
                            ("row_col", row_col, 1, None),
                            ("starts", starts, 1, None),
                            ("q_words", q_words, 2, WORDS),
                            ("cards", cards, 1, None),
                            ("gidx", gidx, 1, None)):
        _check(name, t, dev, torch.int32, nd, wd)
    n_slots = starts.shape[0] - 1
    if row_col.shape[0] != pos.shape[0] or cards.shape[0] != n_slots \
            or gidx.shape[0] != n_slots:
        raise ValueError("need one row_col per position and one card and "
                         "one id per slot")
    if not 0 <= int(q_card) < 2**31 or q_words.shape[0] < 1 \
            or table.shape[0] < 1:
        raise ValueError("need 0 <= q_card < 2^31, >= 1 query row and >= 1 "
                         "table row")
    score = torch.empty(n_slots, dtype=torch.float32, device=dev)
    inter = torch.empty(n_slots, dtype=torch.int32, device=dev)
    fn = _kernels()[2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), table.shape[0], pos.data_ptr(),
                 row_col.data_ptr(), pos.shape[0], starts.data_ptr(),
                 n_slots, q_words.data_ptr(), q_words.shape[0], int(q_card),
                 cards.data_ptr(), gidx.data_ptr(), int(n_valid),
                 int(exclude), METRICS.index(metric), score.data_ptr(),
                 inter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"similarity_score_ids_cuda failed: cudaError "
                           f"{err}")
    _count("score_ids")
    return score, inter


def topk_merge(score: torch.Tensor, inter: torch.Tensor, gidx: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The labelled select: (gidx (k,) int32, score (k,) float32, inter
    (k,) int32) over 1 <= M <= 2^30 entries labelled with global ids:
    the (id, score) groups by score descending, then id ascending, each
    with its largest inter, then the exhaustion rounds; any k >= 1 (see
    ``ref.topk_select_ids``).  On CUDA one pass (one launch up to 1,024
    entries, a launch a level past that), with scratch only past 1,024."""
    n = score.shape[0]
    if k < 1 or not 1 <= n <= 2**30:
        raise ValueError(f"need k >= 1 and 1 to 2^30 entries, got k={k}, "
                         f"{n} entries")
    if score.device.type == "cpu":
        return ref.topk_select_ids(score, inter, gidx, k)
    dev = score.device
    if dev.type != "cuda":
        raise ValueError(f"score is on {dev}; the kernel needs CUDA")
    _check("score", score, dev, torch.float32, 1)
    _check("inter", inter, dev, torch.int32, 1)
    _check("gidx", gidx, dev, torch.int32, 1)
    if inter.shape[0] != n or gidx.shape[0] != n:
        raise ValueError("score, inter and gidx differ in length")
    kernels = _kernels()
    fn, scratch = kernels[3], kernels[4](n, k)
    work = (torch.empty(scratch, dtype=torch.uint8, device=dev)
            if scratch else None)
    out_gidx = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.float32, device=dev)
    top_inter = torch.empty(k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(score.data_ptr(), inter.data_ptr(), gidx.data_ptr(), n, k,
                 None if work is None else work.data_ptr(),
                 out_gidx.data_ptr(), top.data_ptr(), top_inter.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"similarity_select_ids_cuda failed: cudaError "
                           f"{err}")
    _count("select_ids")
    return out_gidx, top, top_inter


def similarity_topk_ids(table: torch.Tensor, pos: torch.Tensor,
                        row_col: torch.Tensor, starts: torch.Tensor,
                        q_words: torch.Tensor, q_card: int,
                        cards: torch.Tensor, gidx: torch.Tensor,
                        n_valid: int, exclude: int = -1, *, metric: str,
                        k: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's score then labelled select: (gidx (k,) int32, score (k,)
    float32, inter (k,) int32), best first, ties to the lowest global id.
    On CUDA, two launches."""
    score, inter = similarity_score_ids(table, pos, row_col, starts,
                                        q_words, q_card, cards, gidx,
                                        n_valid, exclude, metric=metric)
    return topk_merge(score, inter, gidx, k)
