"""The card's constants for the roofline, and the wide-aggregation mesh:
the port of the JAX package's ``launch/mesh.py``.

The JAX package's constants are a TPU v5e's; these are one NVIDIA H100
SXM's.  ``make_wide_mesh`` is the port's over the local cards.  The JAX
package's ``make_production_mesh`` (256 or 512 chips on a (data, model)
mesh) and ``make_local_mesh`` are not ported: one process of the port has
no device mesh for them to shape, and their counterpart, ``torch.distributed``
over several processes and cards, comes with the parameter-sharding rules
(ROADMAP Queue 1 item 7).  Defined as functions, so importing this module
touches no device.
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
