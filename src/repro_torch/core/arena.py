"""Device-resident bitmap arena: promote containers once, query forever.

Container rows are promoted once into a slab on the device; a host-side
directory maps container objects to slab rows, and warm queries move only
row ids, segment offsets and results between host and card -- never
container payloads.

Layout and lifecycle:

* **Host mirror** ``_host`` -- ``(capacity, 1024)`` uint64, the
  authoritative copy.  Row 0 is permanently reserved all-zero so kernel
  paths can pad with id 0.
* **Device slab** ``_dev`` -- ``(capacity, 2048)`` int32 tensor on the
  arena's device, uploaded lazily on the first :meth:`device_slab` call as
  a copy of the mirror (never an alias of it).  Edits batch into one
  out-of-place ``index_put``: the patched slab is a fresh tensor, so a
  slab handed out before the patch does not change -- copy-on-write, at
  the price of one slab copy on the device per patch batch.
* **Directory** -- ``id(container) -> row``.  ``RoaringBitmap`` mutators
  replace container objects, so a stale bitmap's new containers miss the
  lookup and are staged per call -- bit-identical either way.  The
  per-bitmap ``_version`` snapshot decides when :meth:`adopt` re-walks a
  bitmap; rows shared between bitmaps are refcounted.

* **Per-shard slabs** (:meth:`BitmapArena.shard_slabs`, the sharded
  engine's and the sharded aggregates' storage) -- the rows round-robined
  over the shards of a ``dist.WideMesh``: global row ``r`` on shard
  ``r % S`` at local index ``r // S``.  See :class:`ShardSlabs`.

Typical use::

    arena = BitmapArena()                        # on "cuda"
    arena.adopt_many(bitmaps)                    # promote once
    or_many(bitmaps, arena=arena)                # warm: zero row uploads
    bitmaps[0].add(7)                            # host edit
    arena.adopt(bitmaps[0])                      # patches 1 row
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.ref import WORDS


@dataclasses.dataclass
class ArenaStats:
    """Monotone transfer/patch counters -- the observability contract the
    zero-transfer tests assert against.

    ``rows_uploaded`` counts every container row that crossed host ->
    device (initial slab upload + incremental patches); a warm re-query
    must leave it unchanged.  ``host_rows_staged`` is bumped by
    ``aggregate._dispatch`` for each non-resident row it had to stage
    per call (an arena miss).  ``device_gathers`` counts dispatches that
    gathered resident rows on the device.
    """

    rows_promoted: int = 0      # container -> word-row promotions (host)
    rows_uploaded: int = 0      # rows that crossed host -> device
    rows_patched: int = 0       # scatter updates to already-device rows
    rows_freed: int = 0         # rows released back to the free list
    revalidations: int = 0      # adopt() calls that found a stale version
    device_gathers: int = 0     # on-device row gathers
    host_rows_staged: int = 0   # per-call staged rows (arena misses)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ShardStats(ArenaStats):
    """A shard's :class:`ArenaStats`, and ``rows_gathered``: rows its
    launches read from slabs on other devices (:meth:`ShardSlabs.gather`;
    0 where every shard sits on one device)."""

    rows_gathered: int = 0      # rows that crossed from another shard


@dataclasses.dataclass
class _Entry:
    """Per-registered-bitmap directory entry (strong refs keep ``id``
    keys valid for the arena's lifetime)."""
    bm: object
    version: int
    conts: dict            # chunk key -> container object at last adopt


class BitmapArena:
    """Device-resident container slab with generation-tracked incremental
    maintenance; see the module docstring for the layout.

    Args:
        capacity: initial row capacity (grows by doubling; device growth
            concatenates zero rows on the device, never re-uploads).
        device: where the slab lives; ``"cuda"`` by default, which raises
            when no GPU is present.  Pass ``"cpu"`` for the plain path.
    """

    def __init__(self, capacity: int = 64, device=None):
        self.device = resolve_device(device)
        cap = max(int(capacity), 2)
        self._host = np.zeros((cap, 1024), np.uint64)
        self._n = 1                       # row 0 reserved all-zero
        self._free: list[int] = []
        self._dev: torch.Tensor | None = None   # lazy (capacity, WORDS)
        self._dirty: list[int] = []       # host rows not yet on the device
        self._entries: dict[int, _Entry] = {}   # id(bm) -> _Entry
        self._row_of: dict[int, int] = {}       # id(container) -> row
        self._ref: dict[int, int] = {}          # row -> refcount
        self._shards: ShardSlabs | None = None  # per-shard slab mode
        self.stats = ArenaStats()

    # -- directory ----------------------------------------------------

    def lookup(self, cont) -> int | None:
        """Row id for a *container object*, or None if not resident."""
        return self._row_of.get(id(cont))

    def resident(self, bm) -> bool:
        """True iff ``bm`` is registered at its current ``_version``."""
        e = self._entries.get(id(bm))
        return e is not None and e.version == bm._version

    @property
    def n_rows(self) -> int:
        """Allocated rows (including reserved row 0)."""
        return self._n - len(self._free)

    @property
    def capacity(self) -> int:
        """Slab row capacity (doubles on growth; 8 KiB per row)."""
        return self._host.shape[0]

    # -- adoption / incremental maintenance ---------------------------

    def adopt(self, bm) -> int:
        """Register ``bm`` (or revalidate its generation), promoting only
        containers that changed since the last adopt.  Returns the number
        of rows promoted (0 for the warm no-op).  Dirty rows reach the
        device in one batch at the next :meth:`device_slab`."""
        e = self._entries.get(id(bm))
        if e is not None and e.version == bm._version:
            return 0
        if e is None:
            e = _Entry(bm, -1, {})
            self._entries[id(bm)] = e
        else:
            self.stats.revalidations += 1
        cur = dict(zip(bm.keys, bm.containers))
        for k, old in list(e.conts.items()):
            if cur.get(k) is old:
                continue
            self._release_cont(old)
            del e.conts[k]
        changed = 0
        for k, c in cur.items():
            if e.conts.get(k) is c:
                continue
            self._register_cont(c)
            e.conts[k] = c
            changed += 1
        e.version = bm._version
        return changed

    def adopt_many(self, bitmaps) -> int:
        """:meth:`adopt` each bitmap; returns total rows promoted."""
        return sum(self.adopt(bm) for bm in bitmaps)

    def adopt_frozen(self, bitmaps) -> int:
        """Bulk-promote a whole set of bitmaps: one vectorized host
        conversion (``containers_to_word_rows``) and one transfer at the
        next :meth:`device_slab`, instead of per-container Python work.
        Results are bit-identical to per-bitmap :meth:`adopt`.

        ``bitmaps`` is one RoaringBitmap or an iterable of them.  Returns
        the number of rows promoted."""
        if hasattr(bitmaps, "containers"):      # a single RoaringBitmap
            bitmaps = [bitmaps]
        bitmaps = list(bitmaps)
        fresh, seen = [], set()
        for bm in bitmaps:
            e = self._entries.get(id(bm))
            if e is not None and e.version == bm._version:
                continue
            for c in bm.containers:
                ci = id(c)
                if ci not in self._row_of and ci not in seen:
                    seen.add(ci)
                    fresh.append(c)
        if fresh:
            rows = C.containers_to_word_rows(fresh)
            ids = [self._alloc() for _ in fresh]
            self._host[np.asarray(ids)] = rows
            for c, rid in zip(fresh, ids):
                self._row_of[id(c)] = rid
                self._ref[rid] = 0              # adopt() bumps it below
            self.stats.rows_promoted += len(fresh)
            self._note_dirty(ids)
        for bm in bitmaps:
            self.adopt(bm)
        return len(fresh)

    def revalidate(self) -> int:
        """Re-adopt every registered bitmap whose version moved (the query
        server's ``slab_mismatch`` rung).  Returns the rows promoted."""
        return sum(self.adopt(e.bm) for e in list(self._entries.values()))

    def release(self, bm) -> None:
        """Drop ``bm`` from the arena, freeing rows not shared with
        other registered bitmaps."""
        e = self._entries.pop(id(bm), None)
        if e is None:
            return
        for c in e.conts.values():
            self._release_cont(c)

    def _register_cont(self, c) -> int:
        rid = self._row_of.get(id(c))
        if rid is not None:
            self._ref[rid] += 1
            return rid
        rid = self._alloc()
        self._host[rid] = C.container_words64(c)
        self._row_of[id(c)] = rid
        self._ref[rid] = 1
        self.stats.rows_promoted += 1
        self._note_dirty([rid])
        return rid

    def _release_cont(self, c) -> None:
        rid = self._row_of.get(id(c))
        if rid is None:
            return
        self._ref[rid] -= 1
        if self._ref[rid] == 0:
            del self._ref[rid]
            del self._row_of[id(c)]
            self._free.append(rid)
            self.stats.rows_freed += 1

    def _note_dirty(self, ids) -> None:
        """Record host-mirror edits against every device view: the slab's
        dirty list and, in per-shard slab mode, the owning shards' pending
        rows.  A view never uploaded skips this, since its first upload
        reads the whole mirror anyway."""
        if self._dev is not None:
            self._dirty.extend(ids)
        if self._shards is not None:
            self._shards.note_many(ids)

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n == self._host.shape[0]:
            self._grow()
        rid = self._n
        self._n += 1
        return rid

    def _grow(self) -> None:
        cap = self._host.shape[0] * 2
        host = np.zeros((cap, 1024), np.uint64)
        host[: self._n] = self._host[: self._n]
        self._host = host
        if self._dev is not None:
            # grow on the device: existing rows never cross again
            pad = torch.zeros((cap - self._dev.shape[0], WORDS),
                              dtype=torch.int32, device=self.device)
            self._dev = torch.cat([self._dev, pad])

    # -- host/device views --------------------------------------------

    def host_row(self, rid: int) -> np.ndarray:
        """(1024,) uint64 view of one row in the host mirror."""
        return self._host[int(rid)]

    def host_rows(self, ids) -> np.ndarray:
        """Gather ``ids`` rows from the host mirror (a copy): the same
        bytes as promoting the containers again, without the promotion."""
        return self._host[np.asarray(ids, np.int64)]

    def device_slab(self) -> torch.Tensor:
        """The resident ``(capacity, 2048)`` int32 slab, uploaded lazily on
        first call, with pending edits applied in one batch after.

        The patch is out of place (a fresh tensor), so a slab handed out
        earlier keeps its contents -- copy-on-write."""
        if self._dev is None:
            host32 = torch.from_numpy(
                self._host.view(np.int32).reshape(-1, WORDS))
            # copy=True: from_numpy aliases the mirror, and .to() would
            # hand back that alias on the CPU
            self._dev = host32.to(self.device, copy=True)
            self.stats.rows_uploaded += self._n
            self._dirty = []
        elif self._dirty:
            ids = np.array(sorted(set(self._dirty)), np.int64)
            rows = np.ascontiguousarray(self._host[ids])
            rows32 = torch.from_numpy(
                rows.view(np.int32).reshape(len(ids), WORDS))
            self._dev = self._dev.index_put(
                (torch.from_numpy(ids).to(self.device),),
                rows32.to(self.device))
            self.stats.rows_uploaded += len(ids)
            self.stats.rows_patched += len(ids)
            self._dirty = []
        return self._dev

    def sync(self) -> None:
        """Flush pending patches (uploading the slab if it never was) and
        wait until the device copy is ready; in per-shard slab mode the
        shard slabs are flushed and waited for too."""
        self.device_slab()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._shards is not None:
            self._shards.sync()

    # -- per-shard slab mode -------------------------------------------

    def shard_slabs(self, mesh=None) -> "ShardSlabs":
        """Per-shard slab mode: the arena's rows round-robined over the
        devices of a 1-D mesh (``dist.WideMesh``), the host mirror still
        authoritative, each shard patched copy-on-write.  Every shard must
        sit on one device (see :class:`ShardSlabs`).

        The first call stripes the host mirror into S slabs (one upload);
        later calls return the same :class:`ShardSlabs`, whose
        slabs take the host's edits shard by shard (only shards owning
        dirty rows patch).  Another mesh rebuilds.  ``mesh=None`` reads
        the installed mesh (``dist.ctx.resolve_wide``).  Shards may sit on
        one device (one buffer) or on distinct ones (one slab each; see
        :class:`ShardSlabs`)."""
        from repro_torch.dist import ctx
        mesh, size, _ = ctx.resolve_wide(mesh)
        if mesh is None:
            raise ValueError("shard_slabs needs a mesh (none installed)")
        if self._shards is None or self._shards.mesh != mesh:
            self._shards = ShardSlabs(self, mesh, size)
        return self._shards


class ShardSlabs:
    """Round-robin per-shard slabs over a 1-D mesh: the storage of the
    sharded ``SimilarityEngine`` and of the sharded wide aggregates.

    * Global row ``r`` lives on shard ``r % S`` at local index ``r // S``
      (so the map never changes when the arena grows); shard ``s`` is a
      ``(cap_s, WORDS)`` int32 slab, ``cap_s = ceil(capacity / S)``.
    * The S slabs are the S row blocks of one ``(S * cap_s, WORDS)``
      buffer on the mesh's device: the JAX package's ``assembled()`` array,
      here one allocation instead of a view over S device buffers.  Global
      row ``r`` sits at position ``(r % S) * cap_s + r // S``
      (:meth:`positions`), and a shard's launch reads its rows there,
      wherever the round-robin placed them -- without a gathered copy,
      where the JAX package gathers them with a take from the assembled
      array.  Position 0 is global row 0, the arena's reserved zero row,
      so pad slots and cold rows point at it as in the JAX package.  (A
      shard's own slab has no such row: its local row 0 is global row
      ``s``, which holds data on every shard ``s >= 1``.)
    * Where every shard of the mesh sits on one device (S slabs on one
      card, or on the CPU), a shard's rows can be read by every other
      shard's launch in place.  Where the shards sit on distinct devices
      (``distinct``), shard ``s``'s slab is its own ``(cap_s, WORDS)``
      buffer on ``mesh.devices[s]``, as the JAX package places one slab a
      device, and a launch reads the rows it needs through
      :meth:`gather`: each owner selects its rows on its own device, the
      selection crosses to the launch's device (``.to``), and the rows
      that crossed are counted in the reading shard's
      ``stats[s].rows_gathered``.  A shard on the meta device holds no
      rows: such a mesh raises.
    * Host edits batch into one out-of-place patch of the buffer; only
      shards owning dirty rows take rows, and a slab handed out earlier
      keeps its contents (copy-on-write).  Growth pads each shard on the
      device; existing rows never cross again.

    ``stats[s]`` is shard ``s``'s ``ArenaStats``: its uploads and patches
    are counted here, not in the arena's own stats (which keep counting
    the single-device slab); a warm sharded query leaves their
    ``rows_uploaded`` unchanged.
    """

    def __init__(self, arena: BitmapArena, mesh, size: int):
        self.distinct = len(set(mesh.devices)) > 1
        if self.distinct and any(d.type == "meta" for d in mesh.devices):
            raise ValueError(
                f"per-shard arena slabs on distinct devices hold rows on "
                f"each; the mesh has a meta device "
                f"({sorted(map(str, set(mesh.devices)))})")
        self.arena = arena
        self.mesh = mesh
        self.size = int(size)
        self.device = mesh.devices[0]
        self.cap_s = 0
        self._buf: torch.Tensor | None = None    # (S * cap_s, WORDS) int32
        self._bufs: list[torch.Tensor] | None = None  # distinct: one a shard
        self._pending: set[int] = set()      # global rows dirty since flush
        self.stats = [ShardStats() for _ in range(self.size)]

    def note_many(self, ids) -> None:
        """Mark global rows dirty (the arena calls this on host edits)."""
        if self._buf is not None or self._bufs is not None:
            self._pending.update(int(r) for r in ids)

    def _ensure(self) -> None:
        """Build the slabs at first use; afterwards grow them (zero rows
        on the device) and flush pending rows (one out-of-place patch)."""
        if self.distinct:
            return self._ensure_distinct()
        S = self.size
        host = self.arena._host
        need = -(-host.shape[0] // S)
        if self._buf is None:
            block = np.zeros((S, need, 1024), np.uint64)
            for s in range(S):
                rows_s = host[s::S]
                block[s, : rows_s.shape[0]] = rows_s
                self.stats[s].rows_uploaded += max(
                    0, -(-(self.arena._n - s) // S))
            self._buf = torch.from_numpy(
                block.view(np.int32).reshape(-1, WORDS)).to(self.device)
            self.cap_s = need
            self._pending.clear()
            return
        if need > self.cap_s:
            grown = torch.zeros((S, need, WORDS), dtype=torch.int32,
                                device=self.device)
            grown[:, : self.cap_s] = self._buf.view(S, self.cap_s, WORDS)
            self._buf = grown.view(S * need, WORDS)
            self.cap_s = need
        if self._pending:
            rids = np.array(sorted(self._pending), np.int64)
            rows = torch.from_numpy(np.ascontiguousarray(
                host[rids]).view(np.int32).reshape(len(rids), WORDS))
            pos = (rids % S) * self.cap_s + rids // S
            self._buf = self._buf.index_put(
                (torch.from_numpy(pos).to(self.device),),
                rows.to(self.device))
            for s, n in zip(*np.unique(rids % S, return_counts=True)):
                self.stats[s].rows_uploaded += int(n)
                self.stats[s].rows_patched += int(n)
            self._pending.clear()

    def _ensure_distinct(self) -> None:
        """:meth:`_ensure` for shards on distinct devices: shard ``s``'s
        slab on ``mesh.devices[s]``, grown and patched there alone."""
        S = self.size
        host = self.arena._host
        need = -(-host.shape[0] // S)
        if self._bufs is None:
            self._bufs = []
            for s, dev in enumerate(self.mesh.devices):
                block = np.zeros((need, 1024), np.uint64)
                rows_s = host[s::S]
                block[: rows_s.shape[0]] = rows_s
                self.stats[s].rows_uploaded += max(
                    0, -(-(self.arena._n - s) // S))
                self._bufs.append(torch.from_numpy(
                    block.view(np.int32).reshape(-1, WORDS)).to(dev))
            self.cap_s = need
            self._pending.clear()
            return
        if need > self.cap_s:
            for s, buf in enumerate(self._bufs):
                grown = torch.zeros((need, WORDS), dtype=torch.int32,
                                    device=buf.device)
                grown[: self.cap_s] = buf
                self._bufs[s] = grown
            self.cap_s = need
        if self._pending:
            rids = np.array(sorted(self._pending), np.int64)
            for s in np.unique(rids % S):
                mine = rids[rids % S == s]
                rows = torch.from_numpy(np.ascontiguousarray(
                    host[mine]).view(np.int32).reshape(len(mine), WORDS))
                dev = self.mesh.devices[s]
                self._bufs[s] = self._bufs[s].index_put(
                    (torch.from_numpy(mine // S).to(dev),), rows.to(dev))
                self.stats[s].rows_uploaded += len(mine)
                self.stats[s].rows_patched += len(mine)
            self._pending.clear()

    def gather(self, ids, device, reader: int):
        """Rows of global ids ``ids`` for a launch on ``device`` by shard
        ``reader``, from slabs on distinct devices: -> (a ``(1 + U,
        WORDS)`` int32 table on ``device`` whose row 0 is zero and whose
        other rows are the U distinct ids' rows, the position of each id
        in it (numpy int64)).  Each owner selects its rows on its own
        device; the rows that cross to ``device`` from another are counted
        in ``stats[reader].rows_gathered``."""
        self._ensure()
        ids = np.asarray(ids, np.int64)
        uniq, inv = np.unique(ids, return_inverse=True)
        at = np.zeros(uniq.size, np.int64)
        parts = [torch.zeros((1, WORDS), dtype=torch.int32, device=device)]
        n = 1
        for s in np.unique(uniq % self.size):
            sel = np.flatnonzero(uniq % self.size == s)
            owner = self.mesh.devices[s]
            rows = self._bufs[s].index_select(
                0, torch.from_numpy(uniq[sel] // self.size).to(owner))
            parts.append(rows.to(device))
            if owner != device:
                self.stats[reader].rows_gathered += int(sel.size)
            at[sel] = n + np.arange(sel.size)
            n += sel.size
        return torch.cat(parts), at[inv.reshape(-1)]

    def positions(self, ids) -> np.ndarray:
        """Positions of global rows ``ids`` in :meth:`assembled`:
        ``(r % S) * cap_s + r // S``, the JAX package's numbers (numpy;
        flushed first, since growth changes ``cap_s``)."""
        self._ensure()
        ids = np.asarray(ids, np.int64)
        return (ids % self.size) * self.cap_s + ids // self.size

    def assembled(self) -> torch.Tensor:
        """The ``(S * cap_s, WORDS)`` int32 buffer of every shard's slab,
        flushed; index it with :meth:`positions`.  On distinct devices the
        slabs are joined on the mesh's first device (a copy: the sharded
        paths read through :meth:`gather` instead)."""
        self._ensure()
        if self.distinct:
            return torch.cat([b.to(self.device) for b in self._bufs])
        return self._buf

    def shard_slab(self, s: int) -> torch.Tensor:
        """Shard ``s``'s ``(cap_s, WORDS)`` int32 slab (a view), flushed."""
        self._ensure()
        if self.distinct:
            return self._bufs[s]
        return self._buf[s * self.cap_s:(s + 1) * self.cap_s]

    def sync(self) -> None:
        """Flush every shard and wait for its device."""
        self._ensure()
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
