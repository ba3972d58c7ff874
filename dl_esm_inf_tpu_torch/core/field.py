"""Fields on the staggered grid.

Counterpart of ``dl_esm_inf_tpu/core/field.py`` (reference ``r2d_field``).
A field's storage is one tensor per rank in stacked local-shard layout on
its grid's device: the rank's block of tiles, each with its halo ring,
zero-filled on creation.  Host arrays in and out (``init_global_data``,
:meth:`Field.set_data`, :meth:`Field.get_data`, the gathers) are whole:
the stacked layout of every rank's block, or the global domain.  With
more than one rank the reductions, gathers and exchanges are
collective.
The staggering truth table (which points are the field's *internal*
region) is :func:`staggering_offsets`, as in the JAX package.

It carries the JAX field's surface: the internal and whole regions of
each tile, data get/set and the device sub-region IO, the halo exchange
under both transports (``"ppermute"``, the plain exchange; ``"remote_dma"``,
the exchange kernel of :mod:`..parallel.halo_kernel` on a CUDA grid),
the single-tile periodic wrap copies, checksum, integral, max_abs,
gather, the internal and external (global boundary ring,
``GO_EXTERNAL_PTS``) masks, multi-level fields (``levels=N``: data of
shape ``(N, ny, nx)`` whose level axis rides one halo exchange, checksum
and gather) and the module-level copy/set/free operations.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kinds, layout
from .constants import ALL_POINTS, BC_PERIODIC, GridPoints, NBOUNDARY, Offset
from .grid import Grid
from .region import Halo, Region
from ..parallel import halo as halo_mod
from ..parallel import halo_kernel
from ..parallel.collectives import gather_to_host, global_max, masked_sum


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
        self.halos = _periodic_bc_halos(self)

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

    # --- regions ------------------------------------------------------------
    @property
    def num_halos(self) -> int:
        return len(self.halos)

    def internal_region(self, rank: int = 0) -> Region:
        """Internal region of one tile, in its local coordinates (the
        reference's per-rank ``field%internal``)."""
        d = self.grid.decomp
        if self.defined_on == ALL_POINTS:
            return Region(0, d.local_nx, 0, d.local_ny)
        sub = d.subdomains[rank]
        gx0, gy0 = sub.global_.xstart, sub.global_.ystart
        h = d.halo
        xs = h + max(self._off[0] - gx0, 0)
        ys = h + max(self._off[1] - gy0, 0)
        return Region(xs, h + sub.global_.nx, ys, h + sub.global_.ny)

    @property
    def internal(self) -> Region:
        """Tile 0's internal region (one tile: THE internal region)."""
        return self.internal_region(0)

    def whole_region(self, rank: int = 0) -> Region:
        """internal +/- NBOUNDARY (reference field_mod.f90:604-622)."""
        if self.defined_on == ALL_POINTS:
            return self.internal_region(rank)
        return self.internal_region(rank).grow(NBOUNDARY)

    @property
    def whole(self) -> Region:
        return self.whole_region(0)

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
            return np.ones(self.grid.global_array_shape, dtype=bool)
        return self.grid.region_mask_np(*self._off)

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
            return np.zeros(self.grid.global_array_shape, dtype=bool)
        return self.grid.external_mask_np(*self._off)

    # --- communication ------------------------------------------------------
    def halo_exchange(self, depth: int = 1,
                      transport: str = "ppermute") -> None:
        """Refresh this field's halo ring to ``depth`` (<= the halo
        width), every level at once (field_mod.f90:1231-1256).

        ``transport``: ``"ppermute"``, the plain exchange of
        :mod:`..parallel.halo`, which assigns a new tensor to
        :attr:`data`, or ``"remote_dma"``, the exchange kernel
        (:func:`..parallel.halo_kernel.remote_dma_exchange`: one launch on
        a CUDA grid, its plain version on the CPU).  With every tile on
        this rank and ``depth`` at most the tile extent, ``"remote_dma"``
        updates :attr:`data` in place, on the card and on the CPU alike
        (only the halo ring is written): a tensor taken from
        :attr:`data` before the call sees the exchange.  Otherwise it
        assigns a new tensor.  The names are the JAX package's."""
        if transport == "ppermute":
            self.data = halo_mod.exchange(self.data, self.grid.halo_spec,
                                          depth)
        elif transport == "remote_dma":
            self.data = halo_kernel.remote_dma_exchange(
                self.data, self.grid.halo_spec, depth)
        else:
            raise ValueError(f"unknown halo transport {transport!r}")

    def apply_periodic_bcs(self) -> None:
        """Apply the single-tile periodic wrap copies of :attr:`halos`
        (reference init_periodic_bc_halos targets, field_mod.f90:
        1394-1464); on a split axis the wrap is part of
        :meth:`halo_exchange`."""
        for hd in self.halos:
            copy_field_patch(self, hd.source, hd.dest)

    # --- reductions / gather -------------------------------------------------
    def checksum(self) -> float:
        """Sum of |internal points| over all tiles and levels (reference
        fld_checksum), accumulated in the checksum dtype."""
        return masked_sum(self.data.abs(), self.internal_mask)

    def integral(self) -> float:
        """Signed sum of internal points over all tiles (the building
        block of volume and mass diagnostics)."""
        return masked_sum(self.data, self.internal_mask)

    def max_abs(self) -> float:
        """max |internal points| over all tiles (CFL monitoring)."""
        return global_max(self.data.abs() * self.internal_mask)

    def gather_inner_data(self) -> np.ndarray:
        """The global ``(global_ny, global_nx)`` array of internal points
        (``(levels, global_ny, global_nx)`` for a multi-level field) as a
        host array (reference gather_inner_data)."""
        return layout.unstack_internal(self.grid.decomp, self.get_data())

    # --- host <-> device ------------------------------------------------------
    def get_data(self) -> np.ndarray:
        """Host copy of the whole stacked array (reference get_data)."""
        return gather_to_host(self.data, self.grid.halo_spec)

    def set_data(self, array) -> None:
        """Replace the data from the whole stacked array (reference
        set_data); this rank keeps its block."""
        arr = (array if isinstance(array, torch.Tensor)
               else torch.as_tensor(np.asarray(array)))
        want = self._lead + self.grid.global_array_shape
        if tuple(arr.shape) != want:
            raise ValueError(
                f"set_data expects stacked shape {want}, "
                f"got {tuple(arr.shape)}")
        self.data = self.grid.local_block(arr).to(
            device=self.grid.device, dtype=self.dtype,
            memory_format=torch.contiguous_format, copy=True)

    def read_from_device(self, region: Region) -> np.ndarray:
        """Host copy of a sub-region of the stacked array (the
        reference's partial device-to-host sync, field_mod.f90:407-465);
        across ranks, of the gathered whole."""
        sy, sx = region.slices()
        if self.grid.halo_spec.num_ranks > 1:
            return self.get_data()[..., sy, sx]
        return gather_to_host(self.data[..., sy, sx])

    def write_to_device(self, region: Region, values) -> None:
        """Update a sub-region from host values (reference
        write_to_device, field_mod.f90:467-525); across ranks, through
        the gathered whole."""
        sy, sx = region.slices()
        if self.grid.halo_spec.num_ranks > 1:
            whole = self.get_data()
            whole[..., sy, sx] = np.asarray(values)
            self.set_data(whole)
            return
        data = self.data.clone()
        data[..., sy, sx] = torch.as_tensor(
            np.asarray(values, dtype=kinds.np_dtype(self.dtype)))
        self.data = data

    def local_view(self, rank: int = 0) -> np.ndarray:
        """One tile's local array, halo ring included (the reference's
        per-rank ``field%data``); a host copy."""
        return layout.shard_view(self.grid.decomp, self.get_data(), rank)


# ---------------------------------------------------------------------------
# Module-level operations of the reference's interface
# (field_mod.f90:191-194)
# ---------------------------------------------------------------------------

def copy_field(field_in: Field, field_out: Field) -> None:
    """copy_2dfield (field_mod.f90:1152-1174)."""
    field_out.data = field_in.data.to(field_out.dtype, copy=True)


def copy_field_patch(field: Field, src: Region, dest: Region) -> None:
    """copy_2dfield_patch (field_mod.f90:1179-1187); the regions are in
    the whole stacked layout."""
    ssy, ssx = src.slices()
    dsy, dsx = dest.slices()
    if field.grid.halo_spec.num_ranks > 1:
        whole = field.get_data()
        whole[..., dsy, dsx] = whole[..., ssy, ssx]
        field.set_data(whole)
        return
    data = field.data.clone()
    data[..., dsy, dsx] = field.data[..., ssy, ssx]
    field.data = data


def set_field(fld: Field, val) -> None:
    """set_field (field_mod.f90:1191-1202)."""
    fld.data = torch.full(fld._lead + fld.grid.array_shape, val,
                          dtype=fld.dtype, device=fld.grid.device)


def field_checksum(field: Field) -> float:
    """fld_checksum (field_mod.f90:1209-1219)."""
    return field.checksum()


def free_field(fld: Field) -> None:
    """r2d_free_field (field_mod.f90:395-403)."""
    fld.data = None


def _periodic_bc_halos(fld: Field) -> tuple[Halo, ...]:
    """Wrap-copy descriptors for periodic BCs on a single tile
    (reference init_periodic_bc_halos, field_mod.f90:1394-1464).  They
    exist only along periodic axes that are not split: on a split axis
    the wrap rides the halo exchange, and a copy within tile 0 would
    overwrite its seam halos with the wrong tile's data."""
    if fld.defined_on == ALL_POINTS:
        return ()
    halos: list[Halo] = []
    r = fld.internal_region(0)
    d = fld.grid.decomp
    if fld.grid.boundary_conditions[0] == BC_PERIODIC and d.nprocx == 1:
        # E-most column <- W-most internal column, W-most <- E-most
        halos.append(Halo(
            source=Region(r.xstart, r.xstart + 1, r.ystart, r.ystop),
            dest=Region(r.xstop, r.xstop + 1, r.ystart, r.ystop)))
        halos.append(Halo(
            source=Region(r.xstop - 1, r.xstop, r.ystart, r.ystop),
            dest=Region(r.xstart - 1, r.xstart, r.ystart, r.ystop)))
    if fld.grid.boundary_conditions[1] == BC_PERIODIC and d.nprocy == 1:
        halos.append(Halo(
            source=Region(r.xstart - 1, r.xstop + 1, r.ystart, r.ystart + 1),
            dest=Region(r.xstart - 1, r.xstop + 1, r.ystop, r.ystop + 1)))
        halos.append(Halo(
            source=Region(r.xstart - 1, r.xstop + 1, r.ystop - 1, r.ystop),
            dest=Region(r.xstart - 1, r.xstop + 1, r.ystart - 1, r.ystart)))
    return tuple(halos)
