"""Kernel entry points with a backend switch, and the device rule.

``backend``:
  * None   -- the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (the wrappers in ``segment_ops``, ``topk_ops``,
    ``bitset_ops``, ``pair_ops``, ``array_ops``, ``bitset_convert``,
    ``harley_seal`` and ``block_sparse_attn`` decide by the tensor's
    device);
  * "cuda" -- always the CUDA kernel; a CPU tensor raises;
  * "ref"  -- always the plain PyTorch version (``kernels/ref.py``).

These mirror the JAX package's default / "pallas" / "ref", so CPU tests
can force the same planner choices there and here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import array_ops as _array_ops
from repro_torch.kernels import bitset_convert as _convert
from repro_torch.kernels import bitset_ops as _bitset_ops
from repro_torch.kernels import block_sparse_attn as _bsa
from repro_torch.kernels import harley_seal as _hs
from repro_torch.kernels import pair_ops as _pair_ops
from repro_torch.kernels import ref
from repro_torch.kernels import segment_ops as _segment_ops
from repro_torch.kernels import topk_ops as _topk_ops

BACKENDS = (None, "cuda", "ref")


def resolve_device(device=None, arena=None) -> torch.device:
    """The device a port entry point runs on: the arena's when there is one
    (naming another raises), else ``"cuda"`` unless the caller names
    another.  Raises where CUDA is asked for and no GPU is present: the
    port never quietly falls back to the CPU."""
    if arena is not None:
        if device is not None and torch.device(device) != arena.device:
            raise ValueError(f"device {device} differs from the arena's "
                             f"{arena.device}")
        return arena.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def _check_backend(backend) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def prefer_kernel(backend, device) -> bool:
    """Whether a host planner should route work through the kernel
    wrappers at all, vs staying on its vectorized numpy paths.

    True on CUDA (as on a TPU in the JAX package) and whenever a backend is
    forced, as the tests do; False for the default backend on the CPU,
    where the host paths avoid a round trip that the plain version cannot
    amortize."""
    _check_backend(backend)
    if backend in ("cuda", "ref"):
        return True
    return torch.device(device).type == "cuda"


def _route(backend, table: torch.Tensor) -> bool:
    """True for the plain version, False for the kernel wrapper."""
    _check_backend(backend)
    if backend == "cuda" and table.device.type != "cuda":
        raise ValueError(f"backend 'cuda' given a tensor on {table.device}")
    return backend == "ref"


def popcount(words, *, backend=None):
    """(N,) int32 cardinalities of (N, WORDS) int32 bitset rows."""
    if _route(backend, words):
        return ref.popcount_words(words)
    return _hs.popcount(words)


def bitset_op(a, b, op: str, *, backend=None):
    """One logical op over (N, WORDS) int32 rows: (words, (N,) int32
    card), paper section 4.1.2.  ``op`` in ``ref.PAIR_OPS``; any other
    raises ValueError on every backend."""
    if _route(backend, a):
        return ref.bitset_op(a, b, op)
    return _bitset_ops.bitset_op(a, b, op)


def bitset_op_card(a, b, op: str, *, backend=None):
    """Count-only :func:`bitset_op` (fast counts, paper section 5.9)."""
    if _route(backend, a):
        return ref.bitset_op_card(a, b, op)
    return _bitset_ops.bitset_op_card(a, b, op)


def _values_and_card(values, card, device=None):
    """Contiguous int32 tensors of array rows and their cards, on
    ``device`` (default: the values' own, the CPU for numpy)."""
    values = torch.as_tensor(values, device=device).to(
        torch.int32).contiguous()
    card = torch.as_tensor(card, dtype=torch.int32,
                           device=values.device).contiguous()
    return values, card


def array_to_bitset(values, card, *, backend=None):
    """(M, WORDS) int32 words of (M, ARRAY_CAP) array rows whose first
    ``card[r]`` slots are valid (paper section 3.2's conversion)."""
    values, card = _values_and_card(values, card)
    if _route(backend, values):
        return ref.array_to_bitset(values, card)
    return _convert.array_to_bitset(values, card)


def bitset_set_many(words, values, card, *, backend=None):
    """OR array rows into (M, WORDS) int32 words: (new words, (M,) int32
    cardinality delta), paper section 3.2 fused."""
    values, card = _values_and_card(values, card, words.device)
    if _route(backend, words):
        return ref.bitset_set_many(words, values, card)
    return _convert.bitset_set_many(words, values, card)


def bitset_to_array(words):
    """(values (N, ARRAY_CAP) int32, card (N,) int32) of (N, WORDS) int32
    rows.  Plain PyTorch on every device, as the JAX package's extraction
    is plain jnp on every backend: it is no Pallas site."""
    return ref.bitset_to_array(words)


def segment_reduce(slab, starts, op: str, *, jmax: int, threshold=0,
                   weights=None, planes: int | None = None, wbits: int = 1,
                   backend=None):
    """Segmented K-way OR/AND/XOR/ANDNOT/threshold reduce fused with the
    cardinality; see ``segment_ops.segment_reduce``."""
    if _route(backend, slab):
        return ref.segment_reduce(slab, starts, op, jmax=jmax,
                                  threshold=threshold, weights=weights)
    return _segment_ops.segment_reduce(slab, starts, op, jmax=jmax,
                                       threshold=threshold, weights=weights,
                                       planes=planes, wbits=wbits)


def segment_reduce_rows(table, ids, starts, op: str, *, jmax: int,
                        threshold=0, weights=None, planes: int | None = None,
                        wbits: int = 1, backend=None):
    """Resident-slab reduce over ``table[ids]``; see
    ``segment_ops.segment_reduce_rows``."""
    if _route(backend, table):
        return ref.segment_reduce_rows(table, ids, starts, op, jmax=jmax,
                                       threshold=threshold, weights=weights)
    return _segment_ops.segment_reduce_rows(
        table, ids, starts, op, jmax=jmax, threshold=threshold,
        weights=weights, planes=planes, wbits=wbits)


def segment_reduce_rows_dual(table, staged, pos, sidx, starts, op: str, *,
                             jmax: int, threshold=0, weights=None,
                             planes: int | None = None, wbits: int = 1,
                             backend=None):
    """Dual-source reduce over ``table[pos] | staged[sidx]``; see
    ``segment_ops.segment_reduce_rows_dual``."""
    if _route(backend, table):
        return ref.segment_reduce_rows_dual(
            table, staged, pos, sidx, starts, op, jmax=jmax,
            threshold=threshold, weights=weights)
    return _segment_ops.segment_reduce_rows_dual(
        table, staged, pos, sidx, starts, op, jmax=jmax,
        threshold=threshold, weights=weights, planes=planes, wbits=wbits)


def similarity_topk(rows, row_col, starts, q_words, q_card, cards, *,
                    metric: str, k: int, exclude: int = -1, backend=None):
    """Similarity top-k over a device-resident candidate slab: the score
    launch, then the select launch; only k indices, scores and
    intersections come back.  See ``topk_ops`` for the layout.  Unlike
    the JAX package's, it takes no ``jmax``: the kernel walks each
    candidate's own rows."""
    if _route(backend, rows):
        return ref.similarity_topk(rows, row_col, starts, q_words, q_card,
                                   cards, exclude, metric=metric, k=k)
    return _topk_ops.similarity_topk(rows, row_col, starts, q_words, q_card,
                                     cards, exclude, metric=metric, k=k)


def similarity_topk_ids(table, pos, row_col, starts, q_words, q_card, cards,
                        gidx, *, metric: str, k: int, n_valid: int,
                        exclude: int = -1, backend=None):
    """One shard of the sharded similarity top-k: score the slots (rows
    read as ``table[pos]`` from the shard's slab, each slot labelled with
    its global id ``gidx``, slots at or past ``n_valid`` padding,
    ``exclude`` a global id), then select k with ties to the lowest global
    id.  See ``topk_ops`` for the layout.  Unlike the JAX package's, it
    reads the rows through positions and takes no ``jmax``."""
    if _route(backend, table):
        return ref.similarity_topk_ids(table, pos, row_col, starts, q_words,
                                       q_card, cards, gidx, n_valid, exclude,
                                       metric=metric, k=k)
    return _topk_ops.similarity_topk_ids(table, pos, row_col, starts,
                                         q_words, q_card, cards, gidx,
                                         n_valid, exclude, metric=metric,
                                         k=k)


def topk_merge(score, inter, gidx, k: int, *, backend=None):
    """Merge gathered labelled k-lists (S*k entries) to the global top-k:
    one labelled select, ties to the lowest global id -- the order of a
    select over the unsharded scores."""
    if _route(backend, score):
        return ref.topk_select_ids(score, inter, gidx, k)
    return _topk_ops.topk_merge(score, inter, gidx, k)


def segment_counters(slab, starts, *, jmax: int, planes: int, weights=None,
                     backend=None):
    """Per-segment bit-sliced occurrence counters (S, planes, WORDS) int32,
    the exchange of the sharded threshold path.  Plain PyTorch on every
    device and backend, as the JAX package's are plain jnp on every
    backend: it is no Pallas site."""
    _check_backend(backend)
    return ref.segment_counters(slab, starts, jmax=jmax, planes=planes,
                                weights=weights)


def _opids(opids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(opids, dtype=torch.int32,
                           device=like.device).contiguous()


def bitset_pair_op(a, b, opids, *, backend=None):
    """Mixed-op batched bitset algebra: per-row op ids into
    ``ref.PAIR_OPS`` (any other id is andnot); returns (words, cards) in
    one launch.  ``opids`` may be any integer sequence."""
    opids = _opids(opids, a)
    if _route(backend, a):
        return ref.bitset_pair_op(a, b, opids)
    return _pair_ops.bitset_pair_op(a, b, opids)


def bitset_pair_card(a, b, opids, *, backend=None):
    """Count-only mixed-op batch (fast counts, paper section 5.9)."""
    opids = _opids(opids, a)
    if _route(backend, a):
        return ref.bitset_pair_card(a, b, opids)
    return _pair_ops.bitset_pair_card(a, b, opids)


def array_bitset_probe(vals, card, words, *, backend=None):
    """Batched array x bitset membership probe (mask over the array's
    slots + count per row)."""
    if _route(backend, vals):
        return ref.array_bitset_probe(vals, card, words)
    return _pair_ops.array_bitset_probe(vals, card, words)


def array_intersect(a_vals, a_card, b_vals, b_card, *, backend=None):
    """Batched sorted-array intersection (paper section 4.2): (int32 mask
    (M, ARRAY_CAP) over A's slots, (M,) int32 count)."""
    if _route(backend, a_vals):
        return ref.array_intersect_mask(a_vals, a_card, b_vals, b_card)
    return _array_ops.array_intersect(a_vals, a_card, b_vals, b_card)


def array_pair_masks(a_vals, a_card, b_vals, b_card, *, backend=None):
    """Two-sided membership masks + count for a batch of sorted-array
    pairs: one launch feeds AND/OR/XOR/ANDNOT materialization."""
    if _route(backend, a_vals):
        return ref.array_pair_masks(a_vals, a_card, b_vals, b_card)
    return _array_ops.array_pair_masks(a_vals, a_card, b_vals, b_card)


def array_intersect_card(a_vals, a_card, b_vals, b_card, *, backend=None):
    """Count-only batched sorted-array intersection (M,) int32 -- the
    array x array class of the pairwise count planner."""
    if _route(backend, a_vals):
        return ref.array_intersect_count(a_vals, a_card, b_vals, b_card)
    return _array_ops.array_intersect_card(a_vals, a_card, b_vals, b_card)


def decode_attention(q, k, v, block_mask_words, kv_len, *,
                     block_size: int = _bsa.DEFAULT_BLOCK_SIZE,
                     sm_scale: float | None = None, softcap: float = 0.0,
                     backend=None):
    """Single-token decode attention over a KV cache whose visible blocks
    are the set bits of a Roaring bitset container row: q (B, H, D), k and
    v (B, Hkv, S, D), block_mask_words (B, ceil(S/bs/32)) int32, kv_len
    (B,) -> (B, H, D) in q's dtype.  See ``block_sparse_attn``."""
    kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    if _route(backend, q):
        return ref.block_sparse_attention_decode(
            q, k, v, block_mask_words, kv_len, block_size=block_size,
            sm_scale=sm_scale, softcap=softcap)
    return _bsa.decode_attention(q, k, v, block_mask_words, kv_len,
                                 block_size=block_size, sm_scale=sm_scale,
                                 softcap=softcap)
