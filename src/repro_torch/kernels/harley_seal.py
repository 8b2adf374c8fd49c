"""Container popcount, from ``csrc/popcount.cu``: (N, WORDS) int32 words
to (N,) int32 cardinalities.

The JAX package's kernel of this name runs the paper's Harley-Seal
carry-save circuit (section 4.1.1), the TPU's way to count bits without a
popcount instruction; Hopper has one, so the CUDA kernel is a ``__popc``
per word and a block sum.  On a CUDA tensor :func:`popcount` launches it
or raises; on a CPU tensor it takes ``ref.popcount_words``.  ``launches``
counts kernel launches (CPU calls and N = 0 do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pair_ops import check_rows
from repro_torch.kernels.ref import WORDS

launches = 0
launches_by_kernel = {"popcount": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    launches_by_kernel["popcount"] = 0


@functools.cache
def _kernel():
    """The C entry point, built and bound on first use."""
    fn = _build.library("popcount").popcount_cuda
    p, n = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, n, p, p]
    fn.restype = ctypes.c_int
    return fn


def popcount(words: torch.Tensor) -> torch.Tensor:
    """(N,) int32 number of set bits of each (WORDS,) int32 row."""
    global launches
    if words.device.type == "cpu":
        return ref.popcount_words(words)
    n = words.shape[0]
    dev = check_rows([("words", words, WORDS)], n)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(words.data_ptr(), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"popcount_cuda failed: cudaError {err}")
    launches += 1
    launches_by_kernel["popcount"] += 1
    return out
