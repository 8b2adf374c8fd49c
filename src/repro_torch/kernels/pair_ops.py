"""Two-by-two container kernels: the bitset pair kernel and the array x
bitset probe, from ``csrc/pair_ops.cu``.

The pair planner (``repro_torch.core.pairwise``) key-merges bitmap pairs,
buckets the matched container pairs by class and launches one kernel per
class.  Here:

  * :func:`bitset_pair_op` -- bitset x bitset: (M, WORDS) int32 rows of
    both sides and an op id per row (``ref.PAIR_OPS``; any id other than
    0-2 is andnot), giving the result words and their popcount;
    :func:`bitset_pair_card` the count only (the words never leave
    registers: the fast counts of paper section 5.9);
  * :func:`array_bitset_probe` -- array x bitset: (M, ARRAY_CAP) int32
    array values (slots at and above ``card`` ignored) tested against
    their (M, WORDS) bitset rows, giving a 0/1 mask over the slots and its
    count.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it takes the plain version in ``kernels/ref.py``.  ``launches``
counts kernel launches (CPU calls and M = 0 do not count);
``launches_by_kernel`` splits them by wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import ARRAY_CAP, WORDS

_KERNELS = ("bitset_pair_op", "bitset_pair_card", "array_bitset_probe")

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
    lib = _build.library("pair_ops")
    p, n = ctypes.c_void_p, ctypes.c_int64
    pair = lib.bitset_pair_cuda
    pair.argtypes = [p, p, p, n, p, p, p]
    pair.restype = ctypes.c_int
    probe = lib.array_bitset_probe_cuda
    probe.argtypes = [p, p, p, n, p, p, p]
    probe.restype = ctypes.c_int
    return pair, probe


def check_rows(tensors, rows: int) -> torch.device:
    """Raise unless every ``(name, tensor, width)`` is a contiguous int32
    CUDA tensor of ``rows`` rows on one device (``width`` None: 1-D;
    else 2-D of that width, 16-byte aligned).  Returns the device."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{tensors[0][0]} is on {dev}; the kernel needs "
                         "CUDA")
    for name, t, width in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        shape = (rows,) if width is None else (rows, width)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if width is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return dev


def _bitset_pair(a, b, opids, write_words: bool):
    m = a.shape[0]
    dev = check_rows([("a", a, WORDS), ("b", b, WORDS),
                      ("opids", opids, None)], m)
    words = (torch.empty((m, WORDS), dtype=torch.int32, device=dev)
             if write_words else None)
    cards = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return words, cards
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[0](a.data_ptr(), b.data_ptr(), opids.data_ptr(), m,
                            None if words is None else words.data_ptr(),
                            cards.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bitset_pair_cuda failed: cudaError {err}")
    _count("bitset_pair_op" if write_words else "bitset_pair_card")
    return words, cards


def bitset_pair_op(a: torch.Tensor, b: torch.Tensor, opids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(words (M, WORDS) int32, cards (M,) int32) of ``a op b`` per row.

    a, b: (M, WORDS) int32; opids: (M,) int32 on the same device."""
    if a.device.type == "cpu":
        return ref.bitset_pair_op(a, b, opids)
    return _bitset_pair(a, b, opids, True)


def bitset_pair_card(a: torch.Tensor, b: torch.Tensor,
                     opids: torch.Tensor) -> torch.Tensor:
    """(M,) int32 popcount of ``a op b`` per row, no words written."""
    if a.device.type == "cpu":
        return ref.bitset_pair_card(a, b, opids)
    return _bitset_pair(a, b, opids, False)[1]


def array_bitset_probe(vals: torch.Tensor, card: torch.Tensor,
                       words: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask (M, ARRAY_CAP) int32, count (M,) int32): bit ``vals[r, i]``
    of ``words[r]`` for slots below ``card[r]``, else 0.

    vals: (M, ARRAY_CAP) int32; card: (M,) int32; words: (M, WORDS)
    int32."""
    if vals.device.type == "cpu":
        return ref.array_bitset_probe(vals, card, words)
    m = vals.shape[0]
    dev = check_rows([("vals", vals, ARRAY_CAP), ("card", card, None),
                      ("words", words, WORDS)], m)
    mask = torch.empty((m, ARRAY_CAP), dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return mask, count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[1](vals.data_ptr(), card.data_ptr(),
                            words.data_ptr(), m, mask.data_ptr(),
                            count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"array_bitset_probe_cuda failed: cudaError "
                           f"{err}")
    _count("array_bitset_probe")
    return mask, count
