"""Conversions between global arrays and the stacked local-shard layout.

The framework stores every field as one array of shape
``(nprocy*local_ny, nprocx*local_nx)``: all shards side by side, each
carrying its own halo ring + alignment padding (see parallel/halo.py).
These helpers convert between that layout and plain ``(global_ny,
global_nx)`` arrays:

* :func:`stack_global` — scatter: the analogue of the field constructor's
  ``init_global_data`` path (reference field_mod.f90:378-389) and of
  ``grid_init``'s tmask boundary replication (grid_mod.f90:400-431).
* :func:`unstack_internal` — gather: the analogue of
  ``gather_inner_data`` (field_mod.f90:1313-1390), without MPI — the
  stacked array's internal blocks are disjoint, so gathering is a pure
  (device-side) reshape/slice.
"""
from __future__ import annotations

import numpy as np

from .decomposition import Decomposition


def stack_global(decomp: Decomposition, global_arr, mode: str = "edge",
                 dtype=None) -> np.ndarray:
    """Host-side scatter of a ``(global_ny, global_nx)`` array.

    ``mode``:
      * ``"edge"`` — halo/padding cells replicate the nearest in-domain
        value (the reference's tmask boundary fill, grid_mod.f90:415-431).
        Note inter-shard halo cells then hold the *correct* neighbour
        values (as if freshly exchanged).
      * ``"zeros"`` — every cell outside a shard's internal region is 0
        (the reference's freshly-scattered field: halos stale at 0,
        field_mod.f90:357-389).
    """
    g = np.asarray(global_arr)
    if dtype is not None:
        g = g.astype(dtype, copy=False)
    if g.shape != (decomp.global_ny, decomp.global_nx):
        raise ValueError(
            f"global array shape {g.shape} != "
            f"({decomp.global_ny}, {decomp.global_nx})")
    h = decomp.halo
    w, hgt = decomp.tile_nx, decomp.tile_ny
    lx, ly = decomp.local_nx, decomp.local_ny
    px, py = decomp.nprocx, decomp.nprocy

    # Extend the global array by h on the south/west and by
    # (padding + h + alignment) on the north/east, replicating edges.
    ext = np.pad(g, ((h, py * hgt - decomp.global_ny + h + (ly - 2 * h - hgt)),
                     (h, px * w - decomp.global_nx + h + (lx - 2 * h - w))),
                 mode="edge")

    out = np.empty((py * ly, px * lx), dtype=g.dtype)
    for iy in range(py):
        for ix in range(px):
            win = ext[iy * hgt: iy * hgt + ly, ix * w: ix * w + lx]
            out[iy * ly: (iy + 1) * ly, ix * lx: (ix + 1) * lx] = win

    if mode == "zeros":
        out *= internal_mask(decomp).astype(g.dtype)
    elif mode != "edge":
        raise ValueError(f"unknown stack mode {mode!r}")
    return out


def internal_mask(decomp: Decomposition) -> np.ndarray:
    """Boolean stacked-layout mask of in-domain internal (T-region) cells."""
    return region_mask(decomp)


def region_mask(decomp: Decomposition, off_x: int = 0, off_y: int = 0) -> np.ndarray:
    """Stacked-layout bool mask of cells inside the *global* region

    ``[off_x, global_nx) x [off_y, global_ny)`` restricted to each shard's
    internal (non-halo) block.  ``off_*`` encode the staggering truth
    table (reference field_mod.f90:652-1122): e.g. SW-offset U points use
    ``off_x=1``.
    """
    h = decomp.halo
    w, hgt = decomp.tile_nx, decomp.tile_ny
    lx, ly = decomp.local_nx, decomp.local_ny
    px, py = decomp.nprocx, decomp.nprocy

    xi = np.arange(px * lx)
    yi = np.arange(py * ly)
    lxi = xi % lx
    lyi = yi % ly
    gx = (xi // lx) * w + lxi - h
    gy = (yi // ly) * hgt + lyi - h
    mx = (lxi >= h) & (lxi < h + w) & (gx >= off_x) & (gx < decomp.global_nx)
    my = (lyi >= h) & (lyi < h + hgt) & (gy >= off_y) & (gy < decomp.global_ny)
    return my[:, None] & mx[None, :]


def external_mask(decomp: Decomposition, off_x: int = 0,
                  off_y: int = 0) -> np.ndarray:
    """Stacked-layout bool mask of the GLOBAL boundary ring: the whole
    region (internal grown by NBOUNDARY=1) minus the internal region,
    in *global* coordinates (reference whole-minus-internal,
    field_mod.f90:604-622, GO_EXTERNAL_PTS kernel_mod.f90:35-37).

    Membership is a pure function of each cell's global coordinate —
    never of its shard position — so the written cell set is
    decomposition-invariant by construction.  It matches the serial
    reference exactly; under decomposition it deliberately EXCLUDES the
    reference's per-rank seam-halo cells (which mirror a neighbour's
    interior and would make the written set layout-dependent).  Ring
    cells outside the global domain land on the boundary shards'
    halo/padding cells that carry those coordinates.
    """
    gx = global_x_index(decomp)
    gy = global_y_index(decomp)
    wx = (gx >= off_x - 1) & (gx <= decomp.global_nx)
    wy = (gy >= off_y - 1) & (gy <= decomp.global_ny)
    ix = (gx >= off_x) & (gx < decomp.global_nx)
    iy = (gy >= off_y) & (gy < decomp.global_ny)
    whole = wy[:, None] & wx[None, :]
    internal = iy[:, None] & ix[None, :]
    return whole & ~internal


def global_x_index(decomp: Decomposition) -> np.ndarray:
    """Per stacked-column global (0-based) T index; halo/padding columns

    extend beyond [0, global_nx) exactly like the reference extends xt/yt
    into external points (grid_mod.f90:547-556).
    """
    lx, w, h = decomp.local_nx, decomp.tile_nx, decomp.halo
    xi = np.arange(decomp.nprocx * lx)
    return (xi // lx) * w + (xi % lx) - h


def global_y_index(decomp: Decomposition) -> np.ndarray:
    ly, hgt, h = decomp.local_ny, decomp.tile_ny, decomp.halo
    yi = np.arange(decomp.nprocy * ly)
    return (yi // ly) * hgt + (yi % ly) - h


def unstack_internal(decomp: Decomposition, stacked):
    """Gather the in-domain internal points into a ``(..., gny, gnx)``
    array (leading dims — e.g. a multi-level field's level axis — are
    carried through).

    Works on NumPy or JAX arrays (pure reshape/slice; on device this
    lowers to local slicing + a resharding gather when jitted).
    """
    h = decomp.halo
    w, hgt = decomp.tile_nx, decomp.tile_ny
    lx, ly = decomp.local_nx, decomp.local_ny
    px, py = decomp.nprocx, decomp.nprocy
    lead = stacked.shape[:-2]
    a = stacked.reshape(lead + (py, ly, px, lx))[..., :, h: h + hgt,
                                                 :, h: h + w]
    a = a.reshape(lead + (py * hgt, px * w))
    return a[..., : decomp.global_ny, : decomp.global_nx]


def shard_view(decomp: Decomposition, stacked, rank: int):
    """One rank's local array (halo ring included) — the analogue of the

    reference's per-rank ``field%data``.  A view for NumPy inputs."""
    sy, sx = decomp.shard_slices(rank)
    return stacked[..., sy, sx]
