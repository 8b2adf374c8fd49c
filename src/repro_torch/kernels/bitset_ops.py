"""Fused bitset op + cardinality (paper section 4.1.2), from
``csrc/bitset_ops.cu``: one logical op for the whole call over (N, WORDS)
int32 rows of both sides.

  * :func:`bitset_op` -- the result words and their popcount;
  * :func:`bitset_op_card` -- the popcount only: the words never leave
    registers (the fast counts of paper section 5.9).

``op`` is one of ``ref.PAIR_OPS`` ("and", "or", "xor", "andnot" = a & ~b);
any other raises ValueError on every route.  N = 0 gives empty tensors and
launches nothing.  On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it takes the plain version in ``kernels/ref.py``.
``launches`` counts kernel launches (CPU calls and N = 0 do not count);
``launches_by_kernel`` splits them by wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pair_ops import check_rows
from repro_torch.kernels.ref import PAIR_OPS, WORDS

_KERNELS = ("bitset_op", "bitset_op_card")

launches = 0
launches_by_kernel = {name: 0 for name in _KERNELS}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for name in _KERNELS:
        launches_by_kernel[name] = 0


@functools.cache
def _kernel():
    """The C entry point, built and bound on first use."""
    fn = _build.library("bitset_ops").bitset_op_cuda
    p, n = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, ctypes.c_int, n, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _op_id(op: str) -> int:
    """The kernel's op id of ``op`` (its index in ``PAIR_OPS``); raises
    ValueError for any other op."""
    if op not in PAIR_OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {PAIR_OPS}")
    return PAIR_OPS.index(op)


def _launch(a, b, op: str, write_words: bool):
    global launches
    oid = _op_id(op)
    m = a.shape[0]
    dev = check_rows([("a", a, WORDS), ("b", b, WORDS)], m)
    words = (torch.empty((m, WORDS), dtype=torch.int32, device=dev)
             if write_words else None)
    cards = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return words, cards
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(), oid, m,
                        None if words is None else words.data_ptr(),
                        cards.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bitset_op_cuda failed: cudaError {err}")
    name = "bitset_op" if write_words else "bitset_op_card"
    launches += 1
    launches_by_kernel[name] += 1
    return words, cards


def bitset_op(a: torch.Tensor, b: torch.Tensor, op: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(words (N, WORDS) int32, card (N,) int32) of ``a op b`` per row.

    a, b: (N, WORDS) int32 on one device."""
    if a.device.type == "cpu":
        return ref.bitset_op(a, b, op)
    return _launch(a, b, op, True)


def bitset_op_card(a: torch.Tensor, b: torch.Tensor, op: str
                   ) -> torch.Tensor:
    """(N,) int32 popcount of ``a op b`` per row, no words written."""
    if a.device.type == "cpu":
        return ref.bitset_op_card(a, b, op)
    return _launch(a, b, op, False)[1]
