"""Halo exchange for the stacked local-shard layout, on one device.

Counterpart of ``dl_esm_inf_tpu/parallel/halo.py``.  A field is ONE
tensor of shape ``(nprocy*local_ny, nprocx*local_nx)``: every logical
shard (tile) sits side by side with its own halo ring.  In this slice
all tiles live on one device — the JAX package's over-decomposition
case on a 1x1 mesh (``repx = nprocx``, ``repy = nprocy``) — so every
seam is a local strip shift and no message leaves the device.

One exchange is two phases:

1. **x phase**: ``depth`` interior edge *columns* move east and west.
2. **y phase**: ``depth`` edge *rows* of the FULL padded width (the x
   halos just received included) move north and south, so diagonal
   corners arrive by sequencing.

Periodic axes add the wrap pair.  A tile with no neighbour in some
direction keeps its existing boundary values.  Fields are grouped by
dtype and leading shape, and strips of one group move together; fields
of different dtypes are never stacked into one message, so an int32
halo is never upcast through a float.

The two phases are separable, so an exchange is also a gather by a row
and a column index (:func:`exchange_index`): the geometry the exchange
kernels of :mod:`.halo_kernel` and the flagship sweep evaluate on the
card.  :func:`_exchange_blocks` stays their plain version.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class HaloSpec:
    """Static facts the exchange needs.

    ``repx``/``repy`` are the over-decomposition factors: logical tiles
    per device along each axis.  On one device they equal
    ``nprocx``/``nprocy``."""

    nprocx: int
    nprocy: int
    halo: int
    tile_nx: int
    tile_ny: int
    local_nx: int
    local_ny: int
    wrap_x: bool
    wrap_y: bool
    repx: int = 1
    repy: int = 1

    @property
    def array_shape(self) -> tuple[int, int]:
        return (self.nprocy * self.local_ny, self.nprocx * self.local_nx)


def _exchange_blocks(blks, spec: HaloSpec, depth: int):
    """Exchange several stacked-layout tensors; returns new tensors.

    Every tile's edge strips shift one slot along the tile axis (tile t
    receives tile t-1's east strip and tile t+1's west strip); the
    wrap pair closes the ring on periodic axes, and tiles without a
    neighbour keep their own values.  Inputs are not modified."""
    h, d = spec.halo, depth
    w, hgt = spec.tile_nx, spec.tile_ny
    rx, ry = spec.repx, spec.repy
    ly, lx = spec.local_ny, spec.local_nx
    blks = list(blks)
    do_x = spec.nprocx > 1 or spec.wrap_x
    do_y = spec.nprocy > 1 or spec.wrap_y
    if not (do_x or do_y):
        return tuple(blks)
    _check_one_device(spec)

    groups: list[tuple[tuple, list[int]]] = []
    for k, b in enumerate(blks):
        sig = (b.dtype, tuple(b.shape[:-2]))
        for gsig, idxs in groups:
            if gsig == sig:
                idxs.append(k)
                break
        else:
            groups.append((sig, [k]))

    def batch(strips):
        """Per-field strips -> one stacked message per group."""
        return [torch.stack([strips[k] for k in idxs])
                for _, idxs in groups]

    def unbatch(msgs, k):
        for msg, (_, idxs) in zip(msgs, groups):
            if k in idxs:
                return msg[idxs.index(k)]
        raise AssertionError(k)

    # (..., ry*ly, rx*lx) -> (..., ry, ly, rx, lx): views of fresh copies,
    # so the slice assignments below write the outputs
    out = [b.clone() for b in blks]
    vs = [b.reshape(b.shape[:-2] + (ry, ly, rx, lx)) for b in out]

    if do_x:
        # strips: (..., ry, ly, rx, d); the tile-column axis is -2
        east_src = batch([v[..., h + w - d: h + w] for v in vs])
        west_src = batch([v[..., h: h + d] for v in vs])
        from_west = [torch.roll(m, 1, dims=-2) for m in east_src]
        from_east = [torch.roll(m, -1, dims=-2) for m in west_src]
        gcol = torch.arange(rx, device=out[0].device)
        has_w = ((gcol > 0) | spec.wrap_x)[:, None]
        has_e = ((gcol < rx - 1) | spec.wrap_x)[:, None]
        for k, v in enumerate(vs):
            v[..., h - d: h] = torch.where(
                has_w, unbatch(from_west, k), v[..., h - d: h])
            v[..., h + w: h + w + d] = torch.where(
                has_e, unbatch(from_east, k), v[..., h + w: h + w + d])

    if do_y:
        # strips: (..., ry, d, rx, lx); the tile-row axis is -4
        north_src = batch([v[..., h + hgt - d: h + hgt, :, :] for v in vs])
        south_src = batch([v[..., h: h + d, :, :] for v in vs])
        from_south = [torch.roll(m, 1, dims=-4) for m in north_src]
        from_north = [torch.roll(m, -1, dims=-4) for m in south_src]
        grow = torch.arange(ry, device=out[0].device)
        has_s = ((grow > 0) | spec.wrap_y)[:, None, None, None]
        has_n = ((grow < ry - 1) | spec.wrap_y)[:, None, None, None]
        for k, v in enumerate(vs):
            v[..., h - d: h, :, :] = torch.where(
                has_s, unbatch(from_south, k), v[..., h - d: h, :, :])
            v[..., h + hgt: h + hgt + d, :, :] = torch.where(
                has_n, unbatch(from_north, k),
                v[..., h + hgt: h + hgt + d, :, :])

    return tuple(out)


def _check_depth(spec: HaloSpec, depth: int) -> None:
    if depth < 1 or depth > spec.halo:
        raise ValueError(
            f"halo-exchange depth {depth} outside [1, halo={spec.halo}]")


def _check_one_device(spec: HaloSpec) -> None:
    if spec.repx != spec.nprocx or spec.repy != spec.nprocy:
        raise NotImplementedError(
            "single-device exchange: every tile must live on this device "
            f"(repx={spec.repx}, repy={spec.repy}, nprocx={spec.nprocx}, "
            f"nprocy={spec.nprocy})")


def _axis_index(i, h, d, t, l, n, wrap):
    k, r = i // l, i % l
    west = (r >= h - d) & (r < h) & ((k > 0) | wrap)
    east = (r >= h + t) & (r < h + t + d) & ((k < n - 1) | wrap)
    src = torch.where(west, ((k - 1) % n) * l + r + t, i)
    return torch.where(east, ((k + 1) % n) * l + r - t, src)


def exchange_index(spec: HaloSpec, depth: int,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, cols)``: the exchange of ``depth`` as a gather,
    ``exchange(a) == a.index_select(-2, rows).index_select(-1, cols)``.

    The x phase moves columns over every row of a tile and the y phase
    then moves full-width rows, so the two are separable: a point in a
    west (south) halo strip of depth ``depth`` reads the column (row)
    ``tile_nx`` (``tile_ny``) further on in the tile before it, one in an
    east (north) strip the one as far back in the tile after it, where
    that neighbour exists (wrap pairs on periodic axes); every other
    point reads itself.  The Python mirror of ``csrc/halo_remap.cuh``,
    the geometry both exchange kernels use."""
    _check_depth(spec, depth)
    _check_one_device(spec)
    h = spec.halo
    ny, nx = spec.array_shape
    rows = _axis_index(torch.arange(ny, device=device), h, depth,
                       spec.tile_ny, spec.local_ny, spec.nprocy, spec.wrap_y)
    cols = _axis_index(torch.arange(nx, device=device), h, depth,
                       spec.tile_nx, spec.local_nx, spec.nprocx, spec.wrap_x)
    return rows, cols


def exchange(data: torch.Tensor, spec: HaloSpec,
             depth: int = 1) -> torch.Tensor:
    """Refresh the halo ring(s) of one stacked-layout tensor (leading
    dims are carried along).  Functional: returns a new tensor."""
    _check_depth(spec, depth)
    return _exchange_blocks((data,), spec, depth)[0]


def exchange_multi(arrays, spec: HaloSpec, depth: int = 1) -> list:
    """Exchange several same-layout fields in one call."""
    _check_depth(spec, depth)
    return list(_exchange_blocks(tuple(arrays), spec, depth))


def exchange_multi_fn(spec: HaloSpec, depth: int = 1):
    """``fn(blks) -> blks``: the exchange bound to (spec, depth), the
    shape a model's step schedule calls once per step or sweep."""
    _check_depth(spec, depth)

    def fn(blks):
        return _exchange_blocks(tuple(blks), spec, depth)
    return fn
