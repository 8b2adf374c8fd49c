"""Pure-python *scalar* twins of the vectorized container algorithms, the
port's copy of the JAX package's ``repro/core/scalar.py`` (numpy only).

The paper (section 5.10, Tables 10/13) compares CRoaring with its SIMD
optimizations disabled ("scalar code") against the SIMD build.  In this
reproduction the numpy path plays the role of the SIMD code; this module is
the deliberately scalar counterpart: element-at-a-time loops with no numpy
vector ops, for the scalar ablation and the equivalence tests.  Like the
JAX package's ``repro.core``, ``repro_torch.core`` does not export it:
callers write ``from repro_torch.core import scalar``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.containers import BITSET_WORDS

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount64(w: int) -> int:
    """Scalar SWAR popcount of one 64-bit word (paper section 4.1 baseline)."""
    w -= (w >> 1) & _M1
    w = (w & _M2) + ((w >> 2) & _M2)
    w = (w + (w >> 4)) & _M4
    return ((w * 0x0101010101010101) & 0xFFFFFFFFFFFFFFFF) >> 56


def bitset_popcount(words) -> int:
    """Word-at-a-time population count of a bitset container."""
    return sum(popcount64(int(w)) for w in words)


def bitset_op(a, b, op: str):
    """Word-at-a-time logical op + cardinality (the scalar form of the
    paper's section 4.1.2 fused loop).  Returns (words, card)."""
    out = np.zeros(BITSET_WORDS, dtype=np.uint64)
    card = 0
    for i in range(BITSET_WORDS):
        x, y = int(a[i]), int(b[i])
        if op == "and":
            r = x & y
        elif op == "or":
            r = x | y
        elif op == "xor":
            r = x ^ y
        else:
            r = x & ~y & 0xFFFFFFFFFFFFFFFF
        out[i] = r
        card += popcount64(r)
    return out, card


def intersect(a, b):
    """Two-pointer scalar intersection of sorted uint16 arrays."""
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = int(a[i]), int(b[j])
        if x == y:
            out.append(x)
            i += 1
            j += 1
        elif x < y:
            i += 1
        else:
            j += 1
    return np.asarray(out, dtype=np.uint16)


def union(a, b):
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = int(a[i]), int(b[j])
        if x == y:
            out.append(x)
            i += 1
            j += 1
        elif x < y:
            out.append(x)
            i += 1
        else:
            out.append(y)
            j += 1
    while i < na:
        out.append(int(a[i]))
        i += 1
    while j < nb:
        out.append(int(b[j]))
        j += 1
    return np.asarray(out, dtype=np.uint16)


def difference(a, b):
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = int(a[i]), int(b[j])
        if x == y:
            i += 1
            j += 1
        elif x < y:
            out.append(x)
            i += 1
        else:
            j += 1
    while i < na:
        out.append(int(a[i]))
        i += 1
    return np.asarray(out, dtype=np.uint16)


def symmetric_difference(a, b):
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = int(a[i]), int(b[j])
        if x == y:
            i += 1
            j += 1
        elif x < y:
            out.append(x)
            i += 1
        else:
            out.append(y)
            j += 1
    while i < na:
        out.append(int(a[i]))
        i += 1
    while j < nb:
        out.append(int(b[j]))
        j += 1
    return np.asarray(out, dtype=np.uint16)


def bitset_to_positions(words):
    """Scalar blsi/tzcnt extraction loop (paper section 3.1)."""
    out = []
    for i in range(BITSET_WORDS):
        w = int(words[i])
        base = i << 6
        while w:
            t = w & (-w)            # blsi
            out.append(base + (t.bit_length() - 1))   # tzcnt
            w ^= t
    return np.asarray(out, dtype=np.uint16)


def bitset_set_many(words, values) -> int:
    """Scalar branchless set-with-cardinality loop (paper section 3.2)."""
    card_delta = 0
    for v in values:
        v = int(v)
        old = int(words[v >> 6])
        new = old | (1 << (v & 63))
        card_delta += (old ^ new) >> (v & 63)
        words[v >> 6] = np.uint64(new)
    return card_delta
