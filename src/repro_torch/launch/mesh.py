"""Production meshes, the card's constants for the roofline, and the
wide-aggregation mesh: the port of the JAX package's ``launch/mesh.py``.

The JAX package's constants are a TPU v5e's; these are one NVIDIA H100
SXM's.  ``make_production_mesh`` and ``make_local_mesh`` are
``torch.distributed`` ``DeviceMesh``es over the default process group's
ranks, one card a rank: the group comes from ``torchrun`` (``launch.train
--distributed``), or, for the dry run's 256- and 512-rank meshes in one
process, from PyTorch's fake backend (``launch.dryrun``).
``make_wide_mesh`` is the port's 1-D mesh over the local cards.  Defined
as functions, so importing this module touches no device and starts no
process group.
"""

from __future__ import annotations

import torch

from repro_torch.dist.ctx import WideMesh

# One H100 SXM (NVIDIA's H100 data sheet, SXM part, dense rates without
# sparsity, at the full 700 W power limit).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 900e9               # bytes/s, NVLink 4, all 18 links together
# The device memory a program may allocate on one card: ``torch.cuda.
# get_device_properties(0).total_memory`` of an "NVIDIA H100 80GB HBM3"
# (chip_smoke.py phase 17 prints it; the data sheet's "80 GB" is rounded).
HBM_BYTES = 85_017_493_504


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) = ('data', 'model') -- 256 cards.
    Multi-pod:  (2, 16, 16) = ('pod', 'data', 'model') -- 512 cards.
    Needs a default process group of exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device_type: str | None = None):
    """A ('data', 'model') mesh over the default process group's world of
    n ranks: (n // mp, mp), mp = min(model_parallel, n), as the JAX
    package shapes whatever its host has.  ``device_type`` defaults to
    "cuda" where a card is present, else "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    mp = max(1, min(int(model_parallel), n))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def make_wide_mesh(n: int | None = None) -> WideMesh:
    """A 1-D ``WideMesh`` over the first ``n`` local cards (all of them
    for None; at most as many as there are) for the sharded wide
    aggregation, as the JAX package's ``make_wide_mesh`` spans its
    devices.  A one-card mesh makes the sharded paths take the
    single-device route.  Raises where no card is present."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("make_wide_mesh: no CUDA device is available")
    n = have if n is None else max(1, min(int(n), have))
    return WideMesh([torch.device("cuda", i) for i in range(n)])
