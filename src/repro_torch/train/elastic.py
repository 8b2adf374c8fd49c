"""Elastic scaling: replan the mesh when hosts join or leave, and place
restored state; the port of the JAX package's ``repro/train/elastic.py``.

Checkpoints store whole leaves (train/checkpoint.py), so re-sharding
after a topology change is: plan a new mesh from the surviving card count
(``plan_mesh``), build its ``DeviceMesh`` (``make_mesh_from_plan``),
rebuild the shardings with the same rules engine (``dist.sharding``) and
``reshard`` the restored tree onto them -- no format migration.
``plan_mesh`` keeps the model axis fixed (TP degree is a property of the
model, not the fleet) and gives the remainder to data/pod axes.
``plan_mesh`` and ``rebatch_plan`` are pure Python, copied.
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


def make_mesh_from_plan(plan: MeshPlan, device_type: str | None = None):
    """The ``DeviceMesh`` of ``plan``: its shape and axis names over the
    default process group's first ``plan.used_chips`` ranks (the idle
    ones are left out).  ``device_type`` defaults to "cuda" where a card
    is present, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(plan.used_chips).reshape(plan.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=plan.axis_names)


def reshard(tree, shardings):
    """Place a (host or other-device) tree of tensors or arrays -- nested
    dicts, lists or tuples of whole leaves -- onto ``shardings``: a tree of
    ``dist.sharding.Sharding`` of the same structure (each leaf becomes a
    DTensor, ``distribute_tensor`` of the whole leaf on the mesh's device
    type), or one ``torch.device`` (each leaf a plain tensor there)."""
    if isinstance(shardings, (str, torch.device)):
        device = shardings
        if isinstance(tree, dict):
            return {k: reshard(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(reshard(v, device) for v in tree)
        return torch.as_tensor(tree).to(device)
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: reshard(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard(v, s) for v, s in zip(tree, shardings,
                                                          strict=True))
    mesh = shardings.mesh
    x = tree.full_tensor() if hasattr(tree, "full_tensor") else \
        torch.as_tensor(tree)
    if x.device.type != "meta":
        x = x.to(mesh.device_type)
    return distribute_tensor(x, mesh, shardings.placements())


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
