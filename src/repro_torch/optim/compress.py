"""Top-k gradient compression with Roaring coordinate sets, the port of the
JAX package's ``repro/optim/compress.py``.

Each replica sends its top-k magnitudes as (values, coordinates) instead of
its dense gradient; the coordinate set is a Roaring bitmap on the
bookkeeping side (sorted ids, clustered, run-friendly).  ``sparse_allreduce``
takes one gradient a replica of a ``dist.WideMesh`` (the port's
one-process model of the JAX package's ``shard_map``): it gathers the k
(value, index) pairs of every replica onto the merge device
(``mesh.devices[0]``), scatter-adds them and divides by the replica count.
Error feedback keeps what was not sent as a residual.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.serde import serialized_size_bytes


def topk_sparsify(g: torch.Tensor, k: int):
    """Dense gradient -> (values (k,), indices (k,) int32, dense residual).
    Among equal magnitudes the lowest index comes first, as in
    ``jax.lax.top_k`` (a stable descending sort; ``torch.topk`` does not
    specify its order of ties)."""
    flat = g.reshape(-1).float()
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx.to(torch.int32), residual.reshape(g.shape)


def densify(values: torch.Tensor, indices: torch.Tensor, shape):
    n = int(np.prod(shape))
    out = torch.zeros(n, dtype=torch.float32, device=values.device)
    return out.index_add_(0, indices.long(), values.float()).reshape(shape)


def sparse_allreduce(grads, mesh, k: int, residuals=None):
    """grads: one tensor a replica, replica r's on ``mesh.devices[r]``.
    Returns (the reduced dense gradient averaged over the replicas, on the
    merge device, and each replica's new residual on its device)."""
    if len(grads) != len(mesh.devices):
        raise ValueError(f"{len(grads)} gradients for a mesh of "
                         f"{len(mesh.devices)} replicas")
    merge = mesh.devices[0]
    vals, idxs, new_res = [], [], []
    for r, g in enumerate(grads):
        g = g.to(mesh.devices[r])
        if residuals is not None:
            g = g + residuals[r]
        v, i, res = topk_sparsify(g, k)
        vals.append(v.to(merge))
        idxs.append(i.to(merge))
        new_res.append(res)
    dense = densify(torch.cat(vals), torch.cat(idxs), grads[0].shape)
    # a 0-dim divisor on the device: a host scalar would multiply by its
    # reciprocal on CUDA
    r = torch.tensor(float(len(grads)), device=merge)
    return dense / r, new_res


def coordinate_bitmap(indices) -> RoaringBitmap:
    """Host-side: the transmitted coordinate set as a Roaring bitmap."""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return RoaringBitmap.from_values(np.asarray(indices, np.uint32))


def wire_bytes_dense(n: int) -> int:
    return 4 * n


def wire_bytes_sparse(indices) -> int:
    """4 bytes a value + the Roaring-serialized coordinate set."""
    bm = coordinate_bitmap(indices)
    return 4 * len(bm) + serialized_size_bytes(bm.run_optimize())
