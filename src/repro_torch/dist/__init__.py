"""repro_torch.dist -- the mesh context (ctx: the model's device mesh and
the wide mesh the sharded bitmap paths run on) and the name-pattern
parameter sharding rules (sharding)."""

from repro_torch.dist import ctx, sharding  # noqa: F401
from repro_torch.dist.ctx import (
    WIDE_AXIS, WideMesh, install_wide_mesh, resolve_wide, set_wide_mesh,
    wide_mesh,
)

__all__ = ["WIDE_AXIS", "WideMesh", "install_wide_mesh", "resolve_wide",
           "set_wide_mesh", "wide_mesh"]
