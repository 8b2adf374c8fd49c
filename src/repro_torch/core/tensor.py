"""RoaringTensor: a fixed-capacity device layout for batches of Roaring
bitmaps, the port of the JAX package's ``core/tensor.py``.

Layout (B bitmaps, C container slots each), five tensors on one device:
    keys  (B, C) int32   -- chunk key (high 16 bits); SENTINEL for empty slots
    kinds (B, C) int32   -- 0 empty / 1 array / 2 bitset / 3 run
    cards (B, C) int32   -- tracked cardinality
    aux   (B, C) int32   -- run count for run slots, 0 otherwise
    slab  (B, C, 4096) int16 -- 8 KiB payload, holding the uint16 bits of:
        array : sorted values, tail padded with 0xFFFF
        bitset: 4096 16-bit words (bit i at word i >> 4, position i & 15)
        run   : interleaved [start0, len0, start1, len1, ...]

The slab is int16 because this torch build's uint16 has no shift, compare,
search or gather; every read widens it with ``.to(torch.int32) & 0xFFFF``
(int16's order is not uint16's above 32,767).

Compute plan: binary algebra decompresses both operands to bitset words
(array slots through the ``array_to_bitset`` kernel, run slots through a
prefix sum, bitset slots as a reinterpreting view), runs the mixed-op pair
kernel, then :func:`repack` re-derives the cheapest kinds.  Keys are
aligned with a static-capacity sorted merge; count-only variants never
materialize results (paper section 5.9).  Where the JAX class computes
every kind's words for every slot and then selects, this computes each
kind's words only for the slots of that kind, in row chunks that keep any
temporary under 1 GiB; the results are bit-identical.  It is a plain class
over torch tensors, not a pytree: PyTorch runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import BitmapArena
from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.containers import (
    ARRAY_MAX, MAX_RUNS, ArrayContainer, BitsetContainer, RunContainer,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (
    CONTAINER_BITS, PAIR_OPS, WORDS, first_positions, pack_bits,
    popcount_words,
)

SENTINEL = 0x7FFFFFFF
KIND_EMPTY, KIND_ARRAY, KIND_BITSET, KIND_RUN = 0, 1, 2, 3
SLAB16 = 4096  # 16-bit entries per slab
RUN_PAIRS = SLAB16 // 2

# Row chunks: each keeps its temporaries under 1 GiB.
_WORDS_CHUNK = 32768   # array / bitset slots decompressed at once: 512 MiB
                       # of int32 values and 256 MiB of gathered slab
_RUN_CHUNK = 1024      # run slots: 256 MiB each of delta and prefix sum
_REPACK_CHUNK = 2048   # slots extracted at once: under 400 MiB


def _chunks(n: int, size: int):
    return ((lo, min(lo + size, n)) for lo in range(0, n, size))


class RoaringTensor:
    """A batch of B Roaring bitmaps in C fixed-size container slots."""

    __slots__ = ("keys", "kinds", "cards", "aux", "slab")

    def __init__(self, keys: torch.Tensor, kinds: torch.Tensor,
                 cards: torch.Tensor, aux: torch.Tensor, slab: torch.Tensor):
        self.keys = keys      # (B, C) int32
        self.kinds = kinds    # (B, C) int32
        self.cards = cards    # (B, C) int32
        self.aux = aux        # (B, C) int32
        self.slab = slab      # (B, C, SLAB16) int16

    # -- basic properties -----------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def batch(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def cardinality(self) -> torch.Tensor:
        """(B,) int32 total cardinalities: a reduction over the tracked
        per-container cards, no kernel launch."""
        return torch.where(self.kinds > 0, self.cards, 0).sum(
            dim=1, dtype=torch.int32)

    def take(self, idx) -> "RoaringTensor":
        """Device gather of batch rows: ``take(idx).keys[i] ==
        keys[idx[i]]`` for every component.  Rows may repeat, so
        index-driven pair joins never bridge through host lists (see
        ``pairwise_card``).  Out-of-range indices raise IndexError."""
        idx = torch.as_tensor(idx, dtype=torch.int64,
                              device=self.device).reshape(-1)
        if idx.numel():
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi >= self.batch:
                raise IndexError(f"batch index out of range [0, "
                                 f"{self.batch}): {lo}..{hi}")
        return RoaringTensor(*(x.index_select(0, idx)
                               for x in (self.keys, self.kinds, self.cards,
                                         self.aux, self.slab)))

    def packed_nbytes(self) -> torch.Tensor:
        """(B,) int32: serialized footprint implied by the container kinds
        (what device memory or storage would hold after compaction) -- the
        device twin of RoaringBitmap.memory_bytes."""
        per = torch.where(
            self.kinds == KIND_ARRAY, 2 * self.cards,
            torch.where(self.kinds == KIND_BITSET, 2 * SLAB16,
                        torch.where(self.kinds == KIND_RUN,
                                    4 * self.aux + 2, 0)))
        overhead = torch.where(self.kinds > 0, 8, 0)
        return (per + overhead).sum(dim=1, dtype=torch.int32) + 16

    # ====================================================================
    # construction
    # ====================================================================

    @staticmethod
    def from_bitmaps(bitmaps, capacity: int | None = None, *,
                     device=None) -> "RoaringTensor":
        """Host -> device bridge: the five components are filled in numpy
        and uploaded once, to ``device`` (the card unless the caller names
        another; raises where there is no GPU)."""
        dev = kops.resolve_device(device)
        b = len(bitmaps)
        cap = capacity or max(1, max((len(bm.keys) for bm in bitmaps),
                                     default=1))
        keys = np.full((b, cap), SENTINEL, np.int32)
        kinds = np.zeros((b, cap), np.int32)
        cards = np.zeros((b, cap), np.int32)
        aux = np.zeros((b, cap), np.int32)
        slab = np.zeros((b, cap, SLAB16), np.uint16)
        for i, bm in enumerate(bitmaps):
            n = len(bm.keys)
            if n > cap:
                raise ValueError(
                    f"bitmap {i} has {n} containers > capacity {cap}")
            keys[i, :n] = bm.keys
            for j, c in enumerate(bm.containers):
                cards[i, j] = c.card
                if c.kind == "array":
                    kinds[i, j] = KIND_ARRAY
                    slab[i, j, :c.card] = c.values
                    slab[i, j, c.card:] = 0xFFFF
                elif c.kind == "bitset":
                    kinds[i, j] = KIND_BITSET
                    slab[i, j] = c.words.view(np.uint16)
                else:
                    kinds[i, j] = KIND_RUN
                    nr = c.num_runs()
                    aux[i, j] = nr
                    slab[i, j, :2 * nr] = c.runs.astype(np.uint16).reshape(-1)
        return RoaringTensor(*(torch.from_numpy(x).to(dev) for x in (
            keys, kinds, cards, aux, slab.view(np.int16))))

    def to_bitmaps(self) -> list[RoaringBitmap]:
        """Device -> host bridge: the port's RoaringBitmaps, one a row."""
        keys, kinds, cards, aux = (x.cpu().numpy() for x in (
            self.keys, self.kinds, self.cards, self.aux))
        slab = self.slab.cpu().numpy().view(np.uint16)
        out = []
        for i in range(self.batch):
            ks, cs = [], []
            for j in np.argsort(keys[i], kind="stable"):
                if kinds[i, j] == KIND_EMPTY:
                    continue
                ks.append(int(keys[i, j]))
                if kinds[i, j] == KIND_ARRAY:
                    cs.append(ArrayContainer(slab[i, j, :cards[i, j]].copy()))
                elif kinds[i, j] == KIND_BITSET:
                    cs.append(BitsetContainer(
                        slab[i, j].view(np.uint64).copy(), int(cards[i, j])))
                else:
                    nr = int(aux[i, j])
                    runs = slab[i, j, :2 * nr].astype(np.int32).reshape(nr, 2)
                    cs.append(RunContainer(runs))
            out.append(RoaringBitmap(ks, cs))
        return out

    def to_arena(self, arena=None):
        """Adopt the whole batch into a ``core.arena.BitmapArena`` (the
        host bridge runs once; wide aggregates over the returned bitmaps
        then read the resident slab).

        Args: ``arena`` an existing arena to adopt into, or None for a new
        one on this tensor's device.  Returns ``(arena, bitmaps)`` where
        ``bitmaps[i]`` is the host twin of batch row ``i``, registered in
        the arena; pass them to ``aggregate.or_many(..., arena=arena)``."""
        if arena is None:
            arena = BitmapArena(device=self.device)
        bms = self.to_bitmaps()
        arena.adopt_many(bms)
        return arena, bms

    # ====================================================================
    # bitset-domain decompression
    # ====================================================================

    def _slot_words(self, idx: torch.Tensor) -> torch.Tensor:
        """(N, WORDS) int32 bitset-domain words of the flat slots ``idx``
        ((N,) int64 into B * C; -1 gives a zero row).  Each kind's words
        are computed only for the slots of that kind: array slots with one
        ``array_to_bitset`` launch a chunk, run slots with
        :func:`_runs_to_words`, bitset slots as a view of their slab."""
        kinds = self.kinds.reshape(-1)
        kind = torch.where(idx >= 0, kinds[idx.clamp(min=0)], KIND_EMPTY)
        out = torch.zeros((idx.numel(), WORDS), dtype=torch.int32,
                          device=self.device)
        slab = self.slab.reshape(-1, SLAB16)
        for k, size in ((KIND_BITSET, _WORDS_CHUNK),
                        (KIND_ARRAY, _WORDS_CHUNK), (KIND_RUN, _RUN_CHUNK)):
            rows = (kind == k).nonzero().squeeze(1)
            for lo, hi in _chunks(rows.numel(), size):
                part = rows[lo:hi]
                src = idx[part]
                if k == KIND_BITSET:
                    out[part] = slab16_to_words32(slab[src])
                elif k == KIND_ARRAY:
                    out[part] = kops.array_to_bitset(
                        slab[src].to(torch.int32) & 0xFFFF,
                        self.cards.reshape(-1)[src])
                else:
                    out[part] = _runs_to_words(slab[src],
                                               self.aux.reshape(-1)[src])
        return out

    def to_words(self) -> torch.Tensor:
        """(B, C, WORDS) int32 bitset-domain view of every slot."""
        b, c = self.batch, self.capacity
        idx = torch.arange(b * c, device=self.device)
        return self._slot_words(idx).view(b, c, WORDS)

    # ====================================================================
    # set algebra
    # ====================================================================

    def _align(self, other: "RoaringTensor"):
        """Static-capacity key merge: returns (out_keys (B, Co), a_words,
        b_words (B, Co, WORDS), hit_a, hit_b) with Co = Ca + Cb; a side's
        words are zero where it has no slot of that key."""
        ka = torch.where(self.kinds > 0, self.keys, SENTINEL)
        kb = torch.where(other.kinds > 0, other.keys, SENTINEL)
        allk = torch.sort(torch.cat([ka, kb], dim=1), dim=1).values
        prev = torch.cat([torch.full_like(allk[:, :1], -1), allk[:, :-1]],
                         dim=1)
        outk = torch.sort(torch.where(allk == prev, SENTINEL, allk),
                          dim=1).values
        b, co = outk.shape
        sides = []
        for t, k in ((self, ka), (other, kb)):
            i_c = torch.searchsorted(k, outk).clamp_(max=k.shape[1] - 1)
            hit = (torch.gather(k, 1, i_c) == outk) & (outk != SENTINEL)
            base = torch.arange(b, device=k.device)[:, None] * k.shape[1]
            flat = torch.where(hit, base + i_c, -1).reshape(-1)
            sides.append((t._slot_words(flat).view(b, co, WORDS), hit))
        (aw, hit_a), (bw, hit_b) = sides
        return outk, aw, bw, hit_a, hit_b

    def _binary(self, other: "RoaringTensor", op: str,
                backend: str | None = None) -> "RoaringTensor":
        outk, aw, bw, hit_a, hit_b = self._align(other)
        b, co = outk.shape
        opids = torch.full((b * co,), PAIR_OPS.index(op), dtype=torch.int32,
                           device=outk.device)
        rw, cards = kops.bitset_pair_op(aw.view(b * co, WORDS),
                                        bw.view(b * co, WORDS), opids,
                                        backend=backend)
        cards = cards.view(b, co)
        if op == "and":
            present = hit_a & hit_b
        elif op in ("or", "xor"):
            present = hit_a | hit_b
        else:  # andnot
            present = hit_a
        present = present & (cards > 0)
        return repack(torch.where(present, outk, SENTINEL), cards,
                      rw.view(b, co, WORDS))

    def __and__(self, other):
        return self._binary(other, "and")

    def __or__(self, other):
        return self._binary(other, "or")

    def __xor__(self, other):
        return self._binary(other, "xor")

    def andnot(self, other):
        return self._binary(other, "andnot")

    # count-only variants (paper section 5.9) --------------------------------
    def _binary_card(self, other, op: str, backend=None) -> torch.Tensor:
        outk, aw, bw, _, _ = self._align(other)
        b, co = outk.shape
        opids = torch.full((b * co,), PAIR_OPS.index(op), dtype=torch.int32,
                           device=outk.device)
        cards = kops.bitset_pair_card(aw.view(b * co, WORDS),
                                      bw.view(b * co, WORDS), opids,
                                      backend=backend).view(b, co)
        return cards.sum(dim=1, dtype=torch.int32)

    def pairwise_card(self, other: "RoaringTensor", ops, *,
                      lhs_idx=None, rhs_idx=None,
                      backend: str | None = None) -> torch.Tensor:
        """Batched pair counts with a per-pair op, one mixed-op kernel
        launch (an op id per row).

        Args: ``ops`` is one op name ("and"|"or"|"xor"|"andnot") or a
        length-P sequence; ``lhs_idx`` / ``rhs_idx`` are optional (P,)
        index arrays picking pair rows from ``self`` / ``other`` on the
        device (``take``; no host pair-list bridge), so arbitrary
        similarity-join pair sets -- repeated rows included -- run against
        resident tensors.  Omitted, pairs align row by row (P = B, equal
        batches required).

        Returns (P,) int32 counts."""
        a = self if lhs_idx is None else self.take(lhs_idx)
        b_t = other if rhs_idx is None else other.take(rhs_idx)
        if a.batch != b_t.batch:
            raise ValueError(f"pair row counts differ: {a.batch} != "
                             f"{b_t.batch} (use lhs_idx/rhs_idx)")
        outk, aw, bw, _, _ = a._align(b_t)
        b, co = outk.shape
        if isinstance(ops, str):
            opids = torch.full((b,), PAIR_OPS.index(ops), dtype=torch.int32)
        else:
            opids = torch.tensor([PAIR_OPS.index(o) for o in ops],
                                 dtype=torch.int32)
            if opids.shape[0] != b:
                raise ValueError(f"need one op per pair row: "
                                 f"{opids.shape[0]} != {b}")
        opids = opids.to(outk.device).repeat_interleave(co)
        cards = kops.bitset_pair_card(aw.view(b * co, WORDS),
                                      bw.view(b * co, WORDS), opids,
                                      backend=backend).view(b, co)
        return cards.sum(dim=1, dtype=torch.int32)

    def and_card(self, other) -> torch.Tensor:
        """(B,) intersection cardinalities, row i vs row i: one count-only
        mixed-op launch; the result words never reach device memory (paper
        section 5.9).  ``or_card`` / ``xor_card`` / ``andnot_card`` are
        its siblings; arbitrary pair sets go through
        ``pairwise_card(lhs_idx=, rhs_idx=)``."""
        return self._binary_card(other, "and")

    def or_card(self, other) -> torch.Tensor:
        return self._binary_card(other, "or")

    def xor_card(self, other) -> torch.Tensor:
        return self._binary_card(other, "xor")

    def andnot_card(self, other) -> torch.Tensor:
        return self._binary_card(other, "andnot")

    def jaccard(self, other) -> torch.Tensor:
        """(B,) float32 per-row Jaccard similarities from one count-only
        launch (empty-vs-empty rows score 1.0, as on the host)."""
        inter = self.and_card(other).to(torch.float32)
        union = (self.cardinality() + other.cardinality()).to(
            torch.float32) - inter
        return torch.where(union > 0, inter / union, torch.ones_like(inter))

    # ====================================================================
    # membership (paper section 5.6)
    # ====================================================================

    def contains(self, queries) -> torch.Tensor:
        """Batched membership (paper section 5.6): (B, Q) values in [0,
        2^32) (int64 or uint32) -> (B, Q) bool.  No kernel launch: a key
        search, then the probe of the slot's kind (bitset bit test, array
        binary search, run-start binary search), vectorized over (B, Q).
        The searches bisect in place, a gather a step, so no slab row is
        copied per query."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.int64)
        else:
            q = torch.from_numpy(np.asarray(queries, np.int64)).to(
                self.device)
        hi = (q >> 16).to(torch.int32)
        lo = (q & 0xFFFF).to(torch.int32)
        ks = torch.where(self.kinds > 0, self.keys, SENTINEL)
        idx_c = torch.searchsorted(ks, hi).clamp_(max=self.capacity - 1)
        hit = torch.gather(ks, 1, idx_c) == hi
        kind = torch.gather(self.kinds, 1, idx_c)
        card = torch.gather(self.cards, 1, idx_c)
        aux = torch.gather(self.aux, 1, idx_c)
        slot = torch.arange(self.batch, device=self.device)[:, None] \
            * self.capacity + idx_c
        slab = self.slab.reshape(-1, SLAB16)

        def at(pos):
            return slab[slot, pos.long()].to(torch.int32) & 0xFFFF

        # bitset probe (paper's `bt`)
        in_bitset = ((at(lo >> 4) >> (lo & 15)) & 1).bool()
        # array probe: binary search in the sorted slab (tail = 0xFFFF)
        pos = _bisect(at, SLAB16, lo, right=False)
        in_array = (pos < card) & (at(pos.clamp(max=SLAB16 - 1)) == lo)
        # run probe: binary search over the run starts (even positions)

        def start(i):
            return torch.where(i < aux, at(2 * i), CONTAINER_BITS)

        r = _bisect(start, RUN_PAIRS, lo, right=True) - 1
        r_c = r.clamp(0, RUN_PAIRS - 1)
        s_at, l_at = at(2 * r_c), at(2 * r_c + 1)
        in_run = (r >= 0) & (r < aux) & (lo >= s_at) & (lo <= s_at + l_at)

        found = torch.where(kind == KIND_BITSET, in_bitset,
                            torch.where(kind == KIND_ARRAY, in_array,
                                        (kind == KIND_RUN) & in_run))
        return hit & found

    # ====================================================================
    # wide aggregation (paper section 5.8 on device)
    # ====================================================================

    def reduce_or(self, backend: str | None = None,
                  mesh=None) -> "RoaringTensor":
        """OR-reduce the whole batch axis into a single bitmap using one
        ``segment_reduce`` launch (a host bridge: the segment plan depends
        on the concrete keys).

        Every non-empty slot of every batch row becomes one slab row;
        slots sharing a chunk key across the batch form a segment; the
        kernel that powers ``RoaringBitmap.or_many`` reduces them fused
        with the cardinality.  Only the live slots are decompressed.  With
        a ``mesh`` (``dist.WideMesh``) of more than one shard, each
        segment's rows shard across it, one launch a shard, and the
        partials fold with OR (``aggregate._shard_reduce``).  Returns a
        batch-1 tensor whose capacity is the number of distinct keys
        rounded up to a power of two, as in the JAX package (the sharded
        route: the number of distinct keys, as there)."""
        dev = self.device
        keys = self.keys.reshape(-1).cpu().numpy()
        kinds = self.kinds.reshape(-1).cpu().numpy()
        live = np.flatnonzero(kinds != KIND_EMPTY)
        if live.size == 0:
            z = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            return RoaringTensor(torch.full_like(z, SENTINEL), z, z.clone(),
                                 z.clone(), torch.zeros(
                                     (1, 1, SLAB16), dtype=torch.int16,
                                     device=dev))
        order = live[np.argsort(keys[live], kind="stable")]
        sorted_keys = keys[order]
        uniq, first = np.unique(sorted_keys, return_index=True)
        starts = np.concatenate((first, [sorted_keys.size])).astype(np.int32)
        from repro_torch.core import aggregate
        mesh = aggregate._resolve_mesh(mesh)
        if mesh is not None and aggregate._mesh_size(mesh) > 1:
            slab = self._slot_words(torch.from_numpy(order).to(dev))
            rw, cards = aggregate._shard_reduce(
                slab, np.diff(starts).tolist(), None, "or", 0, backend, mesh)
            return repack(torch.from_numpy(uniq.astype(np.int32)).to(
                rw.device)[None, :], cards[None, :], rw[None])
        jmax = int(np.diff(starts).max())
        s_pad = 1 if uniq.size <= 1 else 1 << (uniq.size - 1).bit_length()
        out_keys = np.full(s_pad, SENTINEL, np.int32)
        out_keys[:uniq.size] = uniq
        # padded segments are empty -> card 0 -> dropped by repack
        starts = np.concatenate(
            (starts, np.full(s_pad - uniq.size, starts[-1], np.int32)))
        slab = self._slot_words(torch.from_numpy(order).to(dev))
        rw, cards = kops.segment_reduce(slab, torch.from_numpy(starts).to(dev),
                                        "or", jmax=jmax, backend=backend)
        return repack(torch.from_numpy(out_keys).to(dev)[None, :],
                      cards[None, :], rw[None])

    # ====================================================================
    # maintenance
    # ====================================================================

    def run_optimize(self) -> "RoaringTensor":
        """Device-side roaring_bitmap_run_optimize: re-derive the cheapest
        kind, runs included."""
        keys = torch.where(self.kinds > 0, self.keys, SENTINEL)
        return repack(keys, torch.where(self.kinds > 0, self.cards, 0),
                      self.to_words(), allow_runs=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _bisect(read, n: int, target: torch.Tensor, right: bool) -> torch.Tensor:
    """Elementwise ``searchsorted`` (left, or right) of ``target`` in a
    sorted sequence of length ``n`` whose element i is ``read(i)``:
    ``n.bit_length()`` halvings, each one gather."""
    lo = torch.zeros_like(target, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        mid = (lo + hi) >> 1
        v = read(mid.clamp(max=n - 1))
        go = (v <= target) if right else (v < target)
        active = lo < hi
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def slab16_to_words32(slab: torch.Tensor) -> torch.Tensor:
    """(..., 4096) int16 -> (..., 2048) int32, little-endian packing: word
    i = slab[2i] | slab[2i + 1] << 16.  A reinterpreting view (CPU and GPU
    are little-endian), sharing memory with a contiguous ``slab``."""
    return slab.contiguous().view(torch.int32)


def words32_to_slab16(words: torch.Tensor) -> torch.Tensor:
    """(..., 2048) int32 -> (..., 4096) int16, the inverse view."""
    return words.contiguous().view(torch.int16)


def _runs_to_words(flat_slab: torch.Tensor, n_runs: torch.Tensor
                   ) -> torch.Tensor:
    """(N, 4096) int16 interleaved runs + (N,) run counts -> (N, WORDS)
    int32, via delta coding and a prefix sum over the 2^16 universe, in
    chunks of rows.  A run whose end passes 65535 is cut there."""
    n = flat_slab.shape[0]
    dev = flat_slab.device
    out = torch.empty((n, WORDS), dtype=torch.int32, device=dev)
    slot = torch.arange(RUN_PAIRS, device=dev)
    for lo, hi in _chunks(n, _RUN_CHUNK):
        v = flat_slab[lo:hi].to(torch.int32) & 0xFFFF
        starts, lens = v[:, 0::2], v[:, 1::2]
        valid = slot[None, :] < n_runs[lo:hi, None]
        # an invalid run and an end at or past 65536 land in column 65536,
        # which the prefix sum never reads
        s = torch.where(valid, starts, CONTAINER_BITS).to(torch.int64)
        e = torch.where(valid, (starts + lens + 1).clamp(
            max=CONTAINER_BITS), CONTAINER_BITS).to(torch.int64)
        delta = torch.zeros((hi - lo, CONTAINER_BITS + 1), dtype=torch.int32,
                            device=dev)
        one = torch.ones_like(s, dtype=torch.int32)
        delta.scatter_add_(1, s, one)
        delta.scatter_add_(1, e, -one)
        occ = torch.cumsum(delta[:, :CONTAINER_BITS], dim=1,
                           dtype=torch.int32) > 0
        out[lo:hi] = pack_bits(occ)
    return out


def _run_starts(words: torch.Tensor) -> torch.Tensor:
    """(N, WORDS) int32 -> words with bit p set where bit p starts a run
    of 1s (bit p - 1 clear, across word boundaries)."""
    carry = torch.cat([torch.zeros_like(words[:, :1]),
                       (words[:, :-1] >> 31) & 1], dim=1)
    return words & ~((words << 1) | carry)


def _num_runs_words(words: torch.Tensor) -> torch.Tensor:
    """(N, WORDS) int32 -> (N,) int32 number of runs of consecutive 1s."""
    return kops.popcount(_run_starts(words), backend="ref")


def _extract_runs(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, WORDS) int32 -> (slab (N, 4096) int16 interleaved runs, n_runs
    (N,) int32).  Only meaningful when n_runs <= 2047; a row of more runs
    keeps its first 2048, as in the JAX package."""
    n = words.shape[0]
    starts = _run_starts(words)
    nxt = torch.cat([words[:, 1:] & 1, torch.zeros_like(words[:, :1])],
                    dim=1)
    ends = words & ~(((words >> 1) & 0x7FFFFFFF) | (nxt << 31))
    slab = torch.zeros((n, SLAB16), dtype=torch.int32, device=words.device)
    for lo, hi in _chunks(n, _REPACK_CHUNK):
        r, k, s = first_positions(starts[lo:hi], RUN_PAIRS)
        e = first_positions(ends[lo:hi], RUN_PAIRS)[2]
        slab[lo + r, 2 * k] = s.to(torch.int32)
        slab[lo + r, 2 * k + 1] = (e - s).to(torch.int32)
    return slab.to(torch.int16), popcount_words(starts)


def repack(keys: torch.Tensor, cards: torch.Tensor, words: torch.Tensor,
           allow_runs: bool = False) -> RoaringTensor:
    """Re-derive canonical kinds and slabs from bitset-domain words.

    keys: (B, C) int32 with SENTINEL for empty; cards: (B, C); words: (B,
    C, WORDS) int32.  The paper's result-kind policy: array if card <=
    4096 else bitset; runs only when ``allow_runs`` (run_optimize).  Slots
    are re-sorted by key so searches stay valid.  Each kind's slab is
    computed only for the slots that keep it, written straight into its
    sorted position."""
    b, c = keys.shape
    dev = keys.device
    empty = (keys == SENTINEL) | (cards == 0)
    keys = torch.where(empty, SENTINEL, keys)
    cards = torch.where(empty, 0, cards).to(torch.int32)
    kind = torch.where(empty, KIND_EMPTY,
                       torch.where(cards <= ARRAY_MAX, KIND_ARRAY,
                                   KIND_BITSET)).to(torch.int32)
    aux = torch.zeros_like(cards)
    flat = words.reshape(b * c, WORDS)
    if allow_runs:
        n_runs = torch.cat([_num_runs_words(flat[lo:hi])
                            for lo, hi in _chunks(b * c, _WORDS_CHUNK)]
                           + [aux.new_zeros(0)]).view(b, c)
        run_bytes = 4 * n_runs + 2
        arr_bytes = torch.where(cards <= ARRAY_MAX, 2 * cards, 1 << 30)
        best_run = (n_runs <= MAX_RUNS) & (run_bytes < arr_bytes) & \
                   (run_bytes < 2 * SLAB16) & ~empty
        kind = torch.where(best_run, KIND_RUN, kind)
        aux = torch.where(best_run, n_runs, aux)

    # canonicalize slot order (empties at the end); dest[i, j] is where
    # slot j of row i goes
    order = torch.argsort(keys, dim=1, stable=True)
    dest = torch.empty_like(order).scatter_(
        1, order, torch.arange(c, device=dev).expand(b, c).contiguous())
    dest = (torch.arange(b, device=dev)[:, None] * c + dest).reshape(-1)
    slab = torch.zeros((b * c, SLAB16), dtype=torch.int16, device=dev)
    flat_kind = kind.reshape(-1)
    for k in (KIND_ARRAY, KIND_BITSET, KIND_RUN):
        rows = (flat_kind == k).nonzero().squeeze(1)
        for lo, hi in _chunks(rows.numel(), _REPACK_CHUNK):
            src = rows[lo:hi]
            w = flat[src]
            if k == KIND_ARRAY:
                # clip pads 65536 -> 0xFFFF for the sorted-tail invariant
                vals = kops.bitset_to_array(w)[0].clamp_(max=CONTAINER_BITS
                                                         - 1)
                slab[dest[src]] = vals.to(torch.int16)
            elif k == KIND_BITSET:
                slab[dest[src]] = words32_to_slab16(w)
            else:
                slab[dest[src]] = _extract_runs(w)[0]
    keys, kind, cards, aux = (torch.gather(x, 1, order)
                              for x in (keys, kind, cards, aux))
    return RoaringTensor(keys, kind, cards, aux, slab.view(b, c, SLAB16))


# ---------------------------------------------------------------------------
# attention-mask utilities (serving integration)
# ---------------------------------------------------------------------------

def block_mask_words(bitmaps, n_blocks: int, *, device=None) -> torch.Tensor:
    """Host bridge: per-sequence visible-block sets -> (B, ceil(n/32))
    int32 words (bit-reinterpreted uint32) for a block-sparse attention
    kernel, on ``device`` (the card unless the caller names another).  The
    universe must fit one container (n_blocks <= 65536)."""
    if n_blocks > CONTAINER_BITS:
        raise ValueError(f"n_blocks {n_blocks} > {CONTAINER_BITS}")
    dev = kops.resolve_device(device)
    n_words = max(1, (n_blocks + 31) // 32)
    out = np.zeros((len(bitmaps), n_words), np.uint32)
    for i, bm in enumerate(bitmaps):
        vals = bm.to_array()
        vals = vals[vals < n_blocks]
        np.bitwise_or.at(out[i], vals >> 5,
                         np.uint32(1) << (vals & np.uint32(31)))
    return torch.from_numpy(out.view(np.int32)).to(dev)
