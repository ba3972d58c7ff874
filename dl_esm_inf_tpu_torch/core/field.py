"""Fields on the staggered grid.

Counterpart of ``dl_esm_inf_tpu/core/field.py`` (reference ``r2d_field``).
A field's storage is one tensor in stacked local-shard layout on its
grid's device: every tile with its halo ring, zero-filled on creation.
The staggering truth table (which points are the field's *internal*
region) is :func:`staggering_offsets`, as in the JAX package.

This slice carries what the models use: data get/set, the plain halo
exchange, checksum, gather, the internal and external (global boundary
ring, ``GO_EXTERNAL_PTS``) masks and multi-level fields
(``levels=N``: data of shape ``(N, ny, nx)`` whose level axis rides one
halo exchange, checksum and gather).
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
    """A real field bound to a grid-point type (reference r2d_field).

    ``levels=None`` gives the reference's 2D field; ``levels=N`` a
    multi-level field of shape ``(N, ny, nx)``: the level axis is a
    leading dim of the same stacked tensor, carried whole through the
    exchange, the checksum and the gather."""

    def __init__(self, grid: Grid, grid_points, init_global_data=None,
                 dtype=None, levels: int | None = None):
        if grid.decomp is None or not grid._initialised:
            raise RuntimeError(
                "grid must be decomposed and initialised before creating "
                "fields (reference requires grid_init first)")
        if levels is not None and levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        self.grid = grid
        self.defined_on = GridPoints(grid_points)
        self.dtype = kinds.as_dtype(dtype) if dtype is not None else grid.dtype
        self._off = staggering_offsets(grid, self.defined_on)
        self.levels = None if levels is None else int(levels)
        d = grid.decomp
        if init_global_data is not None:
            g = np.asarray(init_global_data)
            want = self._lead + (d.global_ny, d.global_nx)
            if g.shape != want:
                raise ValueError(
                    f"init_global_data shape {g.shape} != {want}")
            self.set_data(self._stack(g))
        else:
            self.data = torch.zeros(self._lead + grid.array_shape,
                                    dtype=self.dtype, device=grid.device)

    @property
    def _lead(self) -> tuple:
        return () if self.levels is None else (self.levels,)

    def _stack(self, g: np.ndarray) -> np.ndarray:
        """Host scatter of global data (levels first) with zero halos."""
        d, npdt = self.grid.decomp, kinds.np_dtype(self.dtype)
        if self.levels is None:
            return layout.stack_global(d, g, mode="zeros", dtype=npdt)
        return np.stack([layout.stack_global(d, g[k], mode="zeros",
                                             dtype=npdt)
                         for k in range(self.levels)])

    @property
    def internal_mask(self) -> torch.Tensor:
        """Mask selecting in-domain internal points of every tile; 2D,
        it broadcasts over the levels of a multi-level field."""
        if self.defined_on == ALL_POINTS:
            return torch.ones(self.grid.array_shape, dtype=self.dtype,
                              device=self.grid.device)
        return self.grid.region_mask(*self._off, dtype=self.dtype)

    def internal_mask_np(self) -> np.ndarray:
        """:attr:`internal_mask` as a host bool array."""
        if self.defined_on == ALL_POINTS:
            return np.ones(self.grid.array_shape, dtype=bool)
        return layout.region_mask(self.grid.decomp, *self._off)

    @property
    def external_mask(self) -> torch.Tensor:
        """Mask of this field's GLOBAL boundary ring: whole minus
        internal in global coordinates (field_mod.f90:604-622), the
        same cells whatever the decomposition.  ALL_POINTS fields have
        whole == internal (field_mod.f90:624-650): the ring is empty."""
        if self.defined_on == ALL_POINTS:
            return torch.zeros(self.grid.array_shape, dtype=self.dtype,
                               device=self.grid.device)
        return self.grid.external_mask(*self._off, dtype=self.dtype)

    def external_mask_np(self) -> np.ndarray:
        """:attr:`external_mask` as a host bool array."""
        if self.defined_on == ALL_POINTS:
            return np.zeros(self.grid.array_shape, dtype=bool)
        return layout.external_mask(self.grid.decomp, *self._off)

    # --- communication ------------------------------------------------------
    def halo_exchange(self, depth: int = 1) -> None:
        """Refresh this field's halo ring to ``depth`` (<= the halo
        width), every level at once.  Only the plain transport exists
        in the port so far."""
        self.data = halo_mod.exchange(self.data, self.grid.halo_spec, depth)

    # --- reductions / gather -------------------------------------------------
    def checksum(self) -> float:
        """Sum of |internal points| over all tiles and levels (reference
        fld_checksum), accumulated in the checksum dtype."""
        return masked_sum(self.data.abs(), self.internal_mask)

    def gather_inner_data(self) -> np.ndarray:
        """The global ``(global_ny, global_nx)`` array of internal points
        (``(levels, global_ny, global_nx)`` for a multi-level field) as a
        host array (reference gather_inner_data)."""
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
        want = self._lead + self.grid.array_shape
        if tuple(arr.shape) != want:
            raise ValueError(
                f"set_data expects stacked shape {want}, "
                f"got {tuple(arr.shape)}")
        self.data = arr.to(device=self.grid.device, dtype=self.dtype,
                           memory_format=torch.contiguous_format, copy=True)


def field_checksum(field: Field) -> float:
    """fld_checksum (field_mod.f90:1209-1219)."""
    return field.checksum()
