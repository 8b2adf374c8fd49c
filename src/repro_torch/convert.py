"""Carry Roaring state across packages as plain numpy parts.

A bitmap's parts are its chunk keys, its container kinds ("array",
"bitset" or "run") and each container's payload: the sorted uint16
``values`` of an array, the (1024,) uint64 ``words`` of a bitset, or the
(R, 2) int32 ``[start, length]`` ``runs`` of a run container.
:func:`bitmap_to_parts` reads them off any object with ``keys`` and
``containers`` of those kinds, so a JAX-package bitmap converts without this
module importing that package.

An index's parts are its postings alone: the similarity engine, the arena
and the query server are derived from the postings at run time, so two
indexes built from the same parts answer every query alike.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.containers import (
    ArrayContainer, BitsetContainer, RunContainer,
)
from repro_torch.data.index import InvertedIndex

_PAYLOAD = {"array": "values", "bitset": "words", "run": "runs"}


def bitmap_to_parts(bm) -> tuple[list[int], list[str], list[np.ndarray]]:
    """(keys, kinds, payloads) of a bitmap; payloads are copies."""
    kinds = [c.kind for c in bm.containers]
    payloads = [np.array(getattr(c, _PAYLOAD[k]))
                for c, k in zip(bm.containers, kinds)]
    return [int(k) for k in bm.keys], kinds, payloads


def bitmap_from_parts(keys, kinds, payloads) -> RoaringBitmap:
    """The port's RoaringBitmap with exactly these containers."""
    conts = []
    for kind, p in zip(kinds, payloads, strict=True):
        if kind == "array":
            conts.append(ArrayContainer(np.array(p, np.uint16)))
        elif kind == "bitset":
            conts.append(BitsetContainer(np.array(p, np.uint64)))
        elif kind == "run":
            conts.append(RunContainer(np.array(p, np.int32).reshape(-1, 2)))
        else:
            raise ValueError(f"unknown container kind {kind!r}")
    keys = [int(k) for k in keys]
    if len(keys) != len(conts) or keys != sorted(set(keys)):
        raise ValueError("keys must be strictly increasing, one per "
                         "container")
    return RoaringBitmap(keys, conts)


def index_from_parts(postings_parts, n_docs: int, *, arena=None,
                     device=None) -> InvertedIndex:
    """An InvertedIndex over ``{term: (keys, kinds, payloads)}``."""
    return InvertedIndex.from_postings(
        {t: bitmap_from_parts(*parts) for t, parts in postings_parts.items()},
        n_docs, arena=arena, device=device)
