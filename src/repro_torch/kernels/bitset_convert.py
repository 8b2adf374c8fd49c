"""Array -> bitset conversion kernels, from ``csrc/bitset_convert.cu``.

  * :func:`array_to_bitset` -- (M, ARRAY_CAP) int32 values and (M,) int32
    cards to (M, WORDS) int32 words: the decompression of array slots
    that every ``RoaringTensor`` operation runs (``to_words``);
  * :func:`bitset_set_many` -- the same values ORed into existing words,
    with the cardinality change popcount(old ^ new) (paper section 3.2).

Values at and above a row's card are ignored; a valid value ADDS its bit
(a repeated value carries into the next bit) and one outside [0, 65535]
drops -- see ``ref.array_to_bitset``.  On a CUDA tensor each wrapper
launches its kernel or raises; on a CPU tensor it takes the plain version
in ``kernels/ref.py``.  ``launches`` counts kernel launches (CPU calls and
M = 0 do not count); ``launches_by_kernel`` splits them by wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pair_ops import check_rows
from repro_torch.kernels.ref import ARRAY_CAP, WORDS

_KERNELS = ("array_to_bitset", "bitset_set_many")

launches = 0
launches_by_kernel = {name: 0 for name in _KERNELS}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for name in _KERNELS:
        launches_by_kernel[name] = 0


def _count(name: str) -> None:
    global launches
    launches += 1
    launches_by_kernel[name] += 1


@functools.cache
def _kernels():
    """The two C entry points, built and bound on first use."""
    lib = _build.library("bitset_convert")
    p, n = ctypes.c_void_p, ctypes.c_int64
    a2b = lib.array_to_bitset_cuda
    a2b.argtypes = [p, p, n, p, p]
    a2b.restype = ctypes.c_int
    set_many = lib.bitset_set_many_cuda
    set_many.argtypes = [p, p, p, n, p, p, p]
    set_many.restype = ctypes.c_int
    return a2b, set_many


def array_to_bitset(values: torch.Tensor, card: torch.Tensor
                    ) -> torch.Tensor:
    """(M, WORDS) int32 words of the first ``card[r]`` values of each row.

    values: (M, ARRAY_CAP) int32; card: (M,) int32 on the same device."""
    if values.device.type == "cpu":
        return ref.array_to_bitset(values, card)
    m = values.shape[0]
    dev = check_rows([("values", values, ARRAY_CAP), ("card", card, None)],
                     m)
    words = torch.empty((m, WORDS), dtype=torch.int32, device=dev)
    if m == 0:
        return words
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[0](values.data_ptr(), card.data_ptr(), m,
                            words.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"array_to_bitset_cuda failed: cudaError {err}")
    _count("array_to_bitset")
    return words


def bitset_set_many(words: torch.Tensor, values: torch.Tensor,
                    card: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(new words (M, WORDS) int32, delta (M,) int32): ``words`` ORed with
    the bits of the first ``card[r]`` values of each row, and the number of
    bits that changed.  The input words are not modified.

    words: (M, WORDS) int32; values: (M, ARRAY_CAP) int32; card: (M,)
    int32, all on one device."""
    if words.device.type == "cpu":
        return ref.bitset_set_many(words, values, card)
    m = words.shape[0]
    dev = check_rows([("words", words, WORDS), ("values", values, ARRAY_CAP),
                      ("card", card, None)], m)
    new = torch.empty((m, WORDS), dtype=torch.int32, device=dev)
    delta = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return new, delta
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[1](words.data_ptr(), values.data_ptr(),
                            card.data_ptr(), m, new.data_ptr(),
                            delta.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bitset_set_many_cuda failed: cudaError {err}")
    _count("bitset_set_many")
    return new, delta
