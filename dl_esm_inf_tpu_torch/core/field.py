"""Fields on the staggered grid.

Counterpart of ``dl_esm_inf_tpu/core/field.py`` (reference ``r2d_field``).
A field's storage is one tensor in stacked local-shard layout on its
grid's device: every tile with its halo ring, zero-filled on creation.
The staggering truth table (which points are the field's *internal*
region) is :func:`staggering_offsets`, as in the JAX package.

This slice carries what the NEMOLite2D flagship uses: data get/set,
the plain halo exchange, checksum, gather and the internal mask.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kinds, layout
from .constants import ALL_POINTS, GridPoints, Offset
from .grid import Grid
from ..parallel import halo as halo_mod
from ..parallel.collectives import gather_to_host, masked_sum


def staggering_offsets(grid: Grid, point) -> tuple[int, int]:
    """(off_x, off_y) of the field's global internal region start."""
    point = GridPoints(point)
    off_x = off_y = 0
    if grid.offset == Offset.SW:
        if point in (GridPoints.U, GridPoints.F) and not grid.wrap_x:
            off_x = 1
        if point in (GridPoints.V, GridPoints.F) and not grid.wrap_y:
            off_y = 1
    return off_x, off_y


class Field:
    """A real 2D field bound to a grid-point type (reference r2d_field)."""

    def __init__(self, grid: Grid, grid_points, init_global_data=None,
                 dtype=None):
        if grid.decomp is None or not grid._initialised:
            raise RuntimeError(
                "grid must be decomposed and initialised before creating "
                "fields (reference requires grid_init first)")
        self.grid = grid
        self.defined_on = GridPoints(grid_points)
        self.dtype = kinds.as_dtype(dtype) if dtype is not None else grid.dtype
        self._off = staggering_offsets(grid, self.defined_on)
        d = grid.decomp
        if init_global_data is not None:
            g = np.asarray(init_global_data)
            if g.shape != (d.global_ny, d.global_nx):
                raise ValueError(
                    f"init_global_data shape {g.shape} != "
                    f"{(d.global_ny, d.global_nx)}")
            self.set_data(layout.stack_global(
                d, g, mode="zeros", dtype=kinds.np_dtype(self.dtype)))
        else:
            self.data = torch.zeros(grid.array_shape, dtype=self.dtype,
                                    device=grid.device)

    @property
    def internal_mask(self) -> torch.Tensor:
        """Mask selecting in-domain internal points of every tile."""
        if self.defined_on == ALL_POINTS:
            return torch.ones(self.grid.array_shape, dtype=self.dtype,
                              device=self.grid.device)
        return self.grid.region_mask(*self._off, dtype=self.dtype)

    # --- communication ------------------------------------------------------
    def halo_exchange(self, depth: int = 1) -> None:
        """Refresh this field's halo ring to ``depth`` (<= the halo
        width).  Only the plain transport exists in the port so far."""
        self.data = halo_mod.exchange(self.data, self.grid.halo_spec, depth)

    # --- reductions / gather -------------------------------------------------
    def checksum(self) -> float:
        """Sum of |internal points| over all tiles (reference
        fld_checksum), accumulated in the checksum dtype."""
        return masked_sum(self.data.abs(), self.internal_mask)

    def gather_inner_data(self) -> np.ndarray:
        """The global (global_ny, global_nx) array of internal points as
        a host array (reference gather_inner_data)."""
        return gather_to_host(layout.unstack_internal(self.grid.decomp,
                                                      self.data))

    # --- host <-> device ------------------------------------------------------
    def get_data(self) -> np.ndarray:
        """Host copy of the stacked array (reference get_data)."""
        return gather_to_host(self.data)

    def set_data(self, array) -> None:
        """Replace the stacked array from host data (reference set_data)."""
        arr = (array if isinstance(array, torch.Tensor)
               else torch.as_tensor(np.asarray(array)))
        if tuple(arr.shape) != self.grid.array_shape:
            raise ValueError(
                f"set_data expects stacked shape {self.grid.array_shape}, "
                f"got {tuple(arr.shape)}")
        self.data = arr.to(device=self.grid.device, dtype=self.dtype,
                           memory_format=torch.contiguous_format, copy=True)


def field_checksum(field: Field) -> float:
    """fld_checksum (field_mod.f90:1209-1219)."""
    return field.checksum()
