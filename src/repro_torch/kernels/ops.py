"""Kernel entry points with a backend switch, and the device rule.

``backend``:
  * None   -- the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (the wrapper in ``segment_ops`` decides by the tensor's
    device);
  * "cuda" -- always the CUDA kernel; a CPU tensor raises;
  * "ref"  -- always the plain PyTorch version (``kernels/ref.py``).

These mirror the JAX package's default / "pallas" / "ref", so CPU tests
can force the same planner choices there and here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import segment_ops as _segment_ops

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
    """True for the plain version, False for the ``segment_ops`` wrapper."""
    _check_backend(backend)
    if backend == "cuda" and table.device.type != "cuda":
        raise ValueError(f"backend 'cuda' given a tensor on {table.device}")
    return backend == "ref"


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
