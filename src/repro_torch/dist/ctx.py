"""The wide-aggregation mesh: the port of the wide-mesh half of the JAX
package's ``dist/ctx.py``.

The JAX package's sharded paths run under one controller: one process
maps a function over a 1-D ``("wide",)`` device mesh (``shard_map``) and
all-gathers the shards' partials.  The port keeps that design.  A
:class:`WideMesh` is a 1-D tuple of ``torch.device``; one process launches
each shard's kernel on that shard's device and gathers the partials with
``.to(merge device)`` and ``torch.cat``.  Devices may repeat, so S shards
can sit on one card (or on the CPU, as the tests run them).

``set_wide_mesh`` installs the default mesh of every sharded entry point
that is not given ``mesh=``; :func:`resolve_wide` is the one rule by which
each of them reads a mesh request.
"""

from __future__ import annotations

import torch

WIDE_AXIS = "wide"

_WIDE_MESH = None


class WideMesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, repeats
    allowed; a CUDA device raises where no GPU is present) along one named
    ``axis``.  Shard ``s`` runs on
    ``devices[s]``; ``devices[0]`` is where partials merge.  Two meshes
    are equal when their devices and axis are."""

    def __init__(self, devices, axis: str = WIDE_AXIS):
        from repro_torch.kernels.ops import resolve_device
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a WideMesh needs at least one device")
        self.axis_names = (axis,)

    def __eq__(self, other) -> bool:
        return isinstance(other, WideMesh) and \
            (self.devices, self.axis_names) == (other.devices,
                                                other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return (f"WideMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def set_wide_mesh(mesh) -> None:
    """Install (or clear, with None) the default mesh of every sharded
    entry point (``core.aggregate.set_default_mesh`` stores here)."""
    global _WIDE_MESH
    _WIDE_MESH = mesh


def wide_mesh():
    """The installed default mesh, or None."""
    return _WIDE_MESH


def install_wide_mesh(n: int | None = None) -> WideMesh:
    """Install a mesh over the first ``n`` visible CUDA devices (all of
    them for None) and return it.  Raises when fewer than ``n`` (or no)
    devices are visible.  A 1-device mesh is safe: the sharded paths then
    take the single-device route."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else int(n)
    if n < 1 or n > have:
        raise RuntimeError(f"install_wide_mesh({n}) needs {max(n, 1)} CUDA "
                           f"devices; {have} are visible")
    mesh = WideMesh([torch.device("cuda", i) for i in range(n)])
    set_wide_mesh(mesh)
    return mesh


def resolve_wide(mesh):
    """Resolve a mesh request to ``(mesh, size, axis)``.

    ``mesh=None`` falls back to the installed :func:`wide_mesh`; no mesh
    anywhere gives ``(None, 1, None)``, the single-device identity every
    sharded path degrades to.  An object without ``axis_names`` passes
    through with size 1 (the sharded paths then take the single-device
    route).  A mesh must be 1-D: the wide paths round-robin rows over one
    axis, and a flattened 2-D mesh would scramble the shard-to-device map
    the arena's per-shard slabs key on."""
    if mesh is None:
        mesh = wide_mesh()
    if mesh is None:
        return None, 1, None
    names = getattr(mesh, "axis_names", None)
    if names is None:
        return mesh, 1, None
    if len(names) != 1:
        raise ValueError(f"wide sharding needs a 1-D mesh; got axes "
                         f"{names!r}")
    return mesh, len(mesh.devices), names[0]
