"""Test oracles, mirroring the reference's self-checking test programs.

The port's own copy of ``dl_esm_inf_tpu/testing.py`` (numpy only):

* :func:`hill_stacked` / :func:`init_field_hill` — the analytic halo
  oracle of tests/dist_mem/test_halos.f90:153-189: a unique value per
  *global* staggered position, ``10000*xpos + ypos``, offset-aware.
* :func:`unique_global_values` — the scatter/gather oracle of
  tests/dist_mem/test_reduction.f90:114-123: ``i + j*global_nx``
  (0-based here; identical values to the reference's 1-based formula).
"""
from __future__ import annotations

import numpy as np

from .core.constants import GridPoints, Offset
from .core.field import Field


def stagger_shift(field: Field) -> tuple[float, float]:
    """Physical (x, y) shift of this field's points relative to T points
    (test_halos.f90:164-187)."""
    g = field.grid
    sx = sy = 0.0
    sign = {Offset.SW: -0.5, Offset.NE: +0.5}[g.offset]
    if field.defined_on == GridPoints.U:
        sx = sign * g.dx
    elif field.defined_on == GridPoints.V:
        sy = sign * g.dy
    elif field.defined_on == GridPoints.F:
        sx, sy = sign * g.dx, sign * g.dy
    return sx, sy


def hill_stacked(field: Field) -> np.ndarray:
    """The hill oracle evaluated at every cell of the stacked array
    (halos and padding included: the formula extends naturally, like the
    reference's xt/yt extension into external points)."""
    g = field.grid
    sx, sy = stagger_shift(field)
    xpos = g.xt_1d() + sx
    ypos = g.yt_1d() + sy
    return 10000.0 * xpos[None, :] + ypos[:, None]


def init_field_hill(field: Field, poison: float = -666.0) -> None:
    """Internal points get the hill value; everything else a plausible
    but wrong poison (test_halos.f90:127-151 uses replicated edge values;
    any wrong value serves)."""
    h = hill_stacked(field)
    m = field.internal_mask_np()
    field.set_data(np.where(m, h, poison))


def unique_global_values(global_nx: int, global_ny: int) -> np.ndarray:
    j, i = np.meshgrid(np.arange(global_ny), np.arange(global_nx),
                       indexing="ij")
    return (i + j * global_nx).astype(np.float64)
