"""Stencil primitives for stacked-layout blocks.

Counterpart of ``dl_esm_inf_tpu/ops/stencils.py``.  Shifts replace index
arithmetic: ``xp(a)[j, i] == a[j, i+1]``.  They are whole-block
``torch.roll``s: values that wrap around the block edge land in halo or
padding cells and are never read as results (the pad-and-mask
contract).  All helpers work on any tensor of rank >= 2.
"""
from __future__ import annotations

import torch


def xp(a):
    """a[j, i+1] (east neighbour)."""
    return torch.roll(a, -1, -1)


def xm(a):
    """a[j, i-1] (west neighbour)."""
    return torch.roll(a, 1, -1)


def yp(a):
    """a[j+1, i] (north neighbour)."""
    return torch.roll(a, -1, -2)


def ym(a):
    """a[j-1, i] (south neighbour)."""
    return torch.roll(a, 1, -2)


def shift(a, dx: int = 0, dy: int = 0):
    """a[j+dy, i+dx]."""
    out = a
    if dy:
        out = torch.roll(out, -dy, -2)
    if dx:
        out = torch.roll(out, -dx, -1)
    return out


def ddx(a, dx: float):
    """(a[j, i+1] - a[j, i]) / dx — forward difference onto U faces."""
    return (xp(a) - a) / dx


def ddx_back(a, dx: float):
    """(a[j, i] - a[j, i-1]) / dx — backward difference onto T centres."""
    return (a - xm(a)) / dx


def ddy(a, dy: float):
    return (yp(a) - a) / dy


def ddy_back(a, dy: float):
    return (a - ym(a)) / dy


def avg_x(a):
    """0.5*(a[j,i] + a[j,i+1]) — T->U interpolation (NE offset)."""
    return 0.5 * (a + xp(a))


def avg_x_back(a):
    """0.5*(a[j,i-1] + a[j,i]) — U->T interpolation (NE offset)."""
    return 0.5 * (a + xm(a))


def avg_y(a):
    return 0.5 * (a + yp(a))


def avg_y_back(a):
    return 0.5 * (a + ym(a))


def pack_mask_bits(masks) -> torch.Tensor:
    """Pack 0/1 masks (constant in time) into one int8 bitfield: one
    byte per point instead of one float plane per mask."""
    masks = list(masks)
    if len(masks) > 8:
        raise ValueError(
            f"pack_mask_bits holds at most 8 masks in the int8 code, "
            f"got {len(masks)}; split into two codes")
    code = sum(torch.as_tensor(m).to(torch.int32) << k
               for k, m in enumerate(masks))
    return code.to(torch.int8)


def unpack_mask_bits(codes, n: int, dtype):
    """Inverse of :func:`pack_mask_bits` — shifts and ands only."""
    c = codes.to(torch.int32)
    return tuple(((c >> k) & 1).to(dtype) for k in range(n))
