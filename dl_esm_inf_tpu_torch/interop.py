"""Carry a model state across from the JAX package.

The JAX package's stacked layout pads tiles to 128 lanes and the port's
does not, so the two exchange the INTERNAL points only: the global
``(gny, gnx)`` arrays that ``model.gather()`` returns in either package.
Halo cells are rebuilt by scattering and a full-depth halo exchange.
"""
from __future__ import annotations

import numpy as np

from .core import kinds, layout


def load_reference_state(model, arrays: dict, istep0: int) -> None:
    """Load a NEMOLite2D state into the port's ``model``.

    ``arrays`` holds the global internal ``sshn``, ``un`` and ``vn``
    (``(gny, gnx)`` numpy arrays, e.g. from the JAX model's ``gather()``)
    and, optionally, the inputs the state was computed with: ``tmask``
    (global T mask) and ``depth`` (scalar or global T-point array).
    Those must equal the port model's own, or the states would belong
    to different problems; a mismatch raises ``ValueError``.  ``istep0``
    is the number of steps the state has taken (it sets the model time
    of the tidal forcing)."""
    grid = model.grid
    d = grid.decomp
    shape = (d.global_ny, d.global_nx)
    if "tmask" in arrays and not np.array_equal(
            np.asarray(arrays["tmask"]), grid.global_tmask()):
        raise ValueError("tmask differs from the model's grid tmask")
    npdt = kinds.np_dtype(grid.dtype)
    if "depth" in arrays:
        want = np.asarray(arrays["depth"], dtype=npdt)
        have = (np.asarray(model.depth, dtype=npdt) if model.depth is not None
                else layout.unstack_internal(d, model.bathymetry.cpu().numpy()))
        if want.shape != have.shape or not np.array_equal(want, have):
            raise ValueError("depth differs from the model's bathymetry")
    for name, field in (("sshn", model.sshn_t), ("un", model.un),
                        ("vn", model.vn)):
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"{name}: expected global internal {shape}, "
                             f"got {a.shape}")
        field.set_data(layout.stack_global(d, a, mode="zeros", dtype=npdt))
        if d.halo:
            field.halo_exchange(d.halo)
    model._istep0 = int(istep0)
    model._sync_face_ssh()
