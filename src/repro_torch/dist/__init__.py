"""repro_torch.dist -- the wide mesh that the sharded bitmap paths run on."""

from repro_torch.dist.ctx import (
    WIDE_AXIS, WideMesh, install_wide_mesh, resolve_wide, set_wide_mesh,
    wide_mesh,
)

__all__ = ["WIDE_AXIS", "WideMesh", "install_wide_mesh", "resolve_wide",
           "set_wide_mesh", "wide_mesh"]
