"""Sorted-array kernels from ``csrc/array_ops.cu``: the A-side
intersection mask and count, the two-sided membership masks and count, or
the count alone.

Pairs are stacked as (M, ARRAY_CAP) int32 value rows per side, each sorted
and distinct in [0, 65535] below its (M,) card (slots at and above the
card are ignored; a card outside [0, ARRAY_CAP] acts clamped).

  * :func:`array_intersect` -- A's 0/1 mask and |A ∩ B| (paper section
    4.2), and :func:`array_difference` on top of it (section 4.4);
  * :func:`array_pair_masks` -- both sides' masks and the count: one launch
    feeds AND, OR, XOR and ANDNOT materialization in the pair planner
    (``repro_torch.core.pairwise``, sections 4.2-4.5);
  * :func:`array_intersect_card` -- the count only.

On a CUDA tensor each kernel wrapper launches its kernel or raises; on a
CPU tensor it takes the plain version in ``kernels/ref.py``.  ``launches``
counts kernel launches (CPU calls and M = 0 do not count);
``launches_by_kernel`` splits them by wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pair_ops import check_rows
from repro_torch.kernels.ref import ARRAY_CAP

_KERNELS = ("array_intersect", "array_pair_masks",
            "array_intersect_card")

launches = 0
launches_by_kernel = {name: 0 for name in _KERNELS}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for name in _KERNELS:
        launches_by_kernel[name] = 0


@functools.cache
def _kernels():
    """The three C entry points (pair masks, A-side intersection, count),
    built and bound on first use."""
    lib = _build.library("array_ops")
    p, n = ctypes.c_void_p, ctypes.c_int64
    pair = lib.array_pair_cuda
    pair.argtypes = [p, p, p, p, n, p, p, p, p]
    pair.restype = ctypes.c_int
    inter = lib.array_intersect_cuda
    inter.argtypes = [p, p, p, p, n, p, p, p]
    inter.restype = ctypes.c_int
    card = lib.array_intersect_card_cuda
    card.argtypes = [p, p, p, p, n, p, p]
    card.restype = ctypes.c_int
    return pair, inter, card


def _count(name: str) -> None:
    global launches
    launches += 1
    launches_by_kernel[name] += 1


def _check_arrays(a_vals, a_card, b_vals, b_card) -> torch.device:
    return check_rows([("a_vals", a_vals, ARRAY_CAP),
                       ("a_card", a_card, None),
                       ("b_vals", b_vals, ARRAY_CAP),
                       ("b_card", b_card, None)], a_vals.shape[0])


def array_intersect(a_vals: torch.Tensor, a_card: torch.Tensor,
                    b_vals: torch.Tensor, b_card: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask (M, ARRAY_CAP) int32, count (M,) int32): which of A's slots
    hold a value of B, and |A ∩ B|.  Slots at and above a card never match.

    a_vals, b_vals: (M, ARRAY_CAP) int32; a_card, b_card: (M,) int32."""
    if a_vals.device.type == "cpu":
        return ref.array_intersect_mask(a_vals, a_card, b_vals, b_card)
    m = a_vals.shape[0]
    dev = _check_arrays(a_vals, a_card, b_vals, b_card)
    mask = torch.empty((m, ARRAY_CAP), dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return mask, count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[1](a_vals.data_ptr(), a_card.data_ptr(),
                            b_vals.data_ptr(), b_card.data_ptr(), m,
                            mask.data_ptr(), count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"array_intersect_cuda failed: cudaError {err}")
    _count("array_intersect")
    return mask, count


def array_difference(a_vals: torch.Tensor, a_card: torch.Tensor,
                     b_vals: torch.Tensor, b_card: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A \\ B over A's slots (paper section 4.4): (keep (M, ARRAY_CAP)
    int32, count (M,) int32).  keep = valid * (1 - mask) of
    :func:`array_intersect`, plain PyTorch on the tensors' device, as the
    JAX function computes it; count = clamp(a_card, 0, ARRAY_CAP) - |A ∩
    B|, the sum of keep.  (The JAX function's count is a_card - |A ∩ B|,
    which differs from the sum of its own keep for a card outside [0,
    ARRAY_CAP].)"""
    mask, inter = array_intersect(a_vals, a_card, b_vals, b_card)
    pos = torch.arange(ARRAY_CAP, device=mask.device)
    keep = (1 - mask).mul_(pos[None, :] < a_card[:, None])
    return keep, a_card.clamp(0, ARRAY_CAP).to(torch.int32) - inter


def array_pair_masks(a_vals: torch.Tensor, a_card: torch.Tensor,
                     b_vals: torch.Tensor, b_card: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mask_a, mask_b (M, ARRAY_CAP) int32, count (M,) int32): which of
    A's slots hold a value of B, which of B's a value of A, and |A ∩ B|.

    a_vals, b_vals: (M, ARRAY_CAP) int32; a_card, b_card: (M,) int32."""
    if a_vals.device.type == "cpu":
        return ref.array_pair_masks(a_vals, a_card, b_vals, b_card)
    m = a_vals.shape[0]
    dev = _check_arrays(a_vals, a_card, b_vals, b_card)
    mask_a = torch.empty((m, ARRAY_CAP), dtype=torch.int32, device=dev)
    mask_b = torch.empty((m, ARRAY_CAP), dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return mask_a, mask_b, count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[0](a_vals.data_ptr(), a_card.data_ptr(),
                            b_vals.data_ptr(), b_card.data_ptr(), m,
                            mask_a.data_ptr(), mask_b.data_ptr(),
                            count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"array_pair_cuda failed: cudaError {err}")
    _count("array_pair_masks")
    return mask_a, mask_b, count


def array_intersect_card(a_vals: torch.Tensor, a_card: torch.Tensor,
                         b_vals: torch.Tensor, b_card: torch.Tensor
                         ) -> torch.Tensor:
    """(M,) int32 |A ∩ B| per row, no masks written: on CUDA one launch
    of a warp a row (``intersect_card_kernel``).

    a_vals, b_vals: (M, ARRAY_CAP) int32; a_card, b_card: (M,) int32."""
    if a_vals.device.type == "cpu":
        return ref.array_intersect_count(a_vals, a_card, b_vals, b_card)
    m = a_vals.shape[0]
    dev = _check_arrays(a_vals, a_card, b_vals, b_card)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernels()[2](a_vals.data_ptr(), a_card.data_ptr(),
                            b_vals.data_ptr(), b_card.data_ptr(), m,
                            count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"array_intersect_card_cuda failed: cudaError "
                           f"{err}")
    _count("array_intersect_card")
    return count
