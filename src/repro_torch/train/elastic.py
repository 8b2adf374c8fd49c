"""Elastic scaling: replan the mesh when hosts join or leave, and place
restored state; the port of the JAX package's ``repro/train/elastic.py``.

Checkpoints store whole leaves (train/checkpoint.py), so after a topology
change the state is restored and placed again, with no format migration.
``plan_mesh`` and ``rebatch_plan`` are pure Python, copied.  ``reshard``
places a restored tree on one device.  The JAX package's
``make_mesh_from_plan`` builds a (data, model) device mesh for its
sharding rules; one process of the port has no such mesh (ROADMAP Queue 1
item 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    used_chips: int
    idle_chips: int


def plan_mesh(available_chips: int, model_parallel: int = 16,
              chips_per_pod: int = 256) -> MeshPlan:
    """Largest usable mesh with a fixed model axis."""
    if available_chips < model_parallel:
        raise ValueError(
            f"need >= {model_parallel} chips for TP={model_parallel}")
    if available_chips >= 2 * chips_per_pod:
        pods = available_chips // chips_per_pod
        data = chips_per_pod // model_parallel
        shape = (pods, data, model_parallel)
        names = ("pod", "data", "model")
    else:
        data = available_chips // model_parallel
        shape = (data, model_parallel)
        names = ("data", "model")
    used = int(np.prod(shape))
    return MeshPlan(shape, names, used, available_chips - used)


def reshard(tree, device):
    """A (host or other-device) tree of tensors or arrays, nested dicts,
    lists or tuples, placed on ``device``."""
    if isinstance(tree, dict):
        return {k: reshard(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


def rebatch_plan(global_batch: int, old_dp: int, new_dp: int) -> dict:
    """Keep the global batch (approximately) constant across elastic events
    by adjusting the per-replica microbatch, adding gradient accumulation
    when the new replica count would otherwise need a bigger-than-before
    microbatch (memory-safe).  The effective batch rounds UP to the nearest
    achievable size; it never shrinks."""
    old_per = max(1, global_batch // max(old_dp, 1))
    accum = 1
    while True:
        per = -(-global_batch // (new_dp * accum))   # ceil
        if per <= old_per or accum >= global_batch:
            break
        accum += 1
    return {"per_replica_batch": per, "grad_accum": accum,
            "effective_batch": per * new_dp * accum}
