"""The finite-difference grid.

Counterpart of ``dl_esm_inf_tpu/core/grid.py`` (reference ``grid_type``
+ ``grid_init``).  It validates the grid kind, offset convention and
boundary conditions, owns the domain decomposition, holds the T-point
mask with its edge replication, the constant scale factors ``dx``/``dy``
and the :class:`~..parallel.halo.HaloSpec`.

Differences from the JAX package: there is no device mesh and no
sharding.  A grid lives on ONE explicit ``torch.device``, and all
shards of its decomposition are tiles of one stacked tensor on it.
The per-point (curvilinear) scale factors and the lazily built metric
arrays come in a later slice; :meth:`Grid.scatter_exchanged` brings
global coefficient arrays (solver couplings, face depths) in.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kinds, layout
from .constants import (ARAKAWA_B, ARAKAWA_C, BC, BC_PERIODIC, GridKind,
                        Offset)
from .decomposition import Decomposition, decompose as _decompose
from ..parallel import environment as env
from ..parallel.halo import HaloSpec


class Grid:
    """An Arakawa-C staggered grid on one device."""

    def __init__(self, grid_name=ARAKAWA_C,
                 boundary_conditions=(BC.EXTERNAL, BC.EXTERNAL, BC.NONE),
                 grid_offsets=Offset.NE, dtype=None, device="cpu"):
        kind = GridKind(grid_name)
        if kind == ARAKAWA_B:
            raise NotImplementedError(
                "ARAKAWA_B grids are declared but not supported "
                "(reference parity: grid_mod.f90:46 is never usable)")
        self.name = kind
        offset = Offset(grid_offsets)
        if offset not in (Offset.SW, Offset.NE):
            raise NotImplementedError(
                f"offset convention {offset!r} not supported (only SW/NE, "
                "matching the reference's implemented paths)")
        self.offset = offset
        bcs = tuple(BC(b) for b in boundary_conditions)
        if len(bcs) != 3:
            raise ValueError("boundary_conditions must have 3 entries (x,y,z)")
        self.boundary_conditions = bcs
        self.device = env.resolve_device(device)
        self.dtype = (kinds.as_dtype(dtype) if dtype is not None
                      else kinds.wp(self.device))

        # Filled in by decompose()/init():
        self.decomp: Decomposition | None = None
        self.halo_spec: HaloSpec | None = None
        self.global_nx = 0
        self.global_ny = 0
        self.dx = None
        self.dy = None
        self.time_step = None
        self.tmask = None          # stacked int32 tensor on self.device
        self._tmask_np = None      # host copy for mask derivation
        self._initialised = False
        self._region_masks = {}

    # ------------------------------------------------------------------
    @property
    def wrap_x(self) -> bool:
        return self.boundary_conditions[0] == BC_PERIODIC

    @property
    def wrap_y(self) -> bool:
        return self.boundary_conditions[1] == BC_PERIODIC

    @property
    def array_shape(self) -> tuple[int, int]:
        """Shape of the stacked array: (nprocy*ny, nprocx*nx)."""
        return (self.decomp.array_ny, self.decomp.array_nx)

    # ------------------------------------------------------------------
    def decompose(self, domainx: int, domainy: int, ndomains=None,
                  ndomainx=None, ndomainy=None, halo_width: int = 1,
                  align: int | None = None,
                  align_y: int = 1) -> Decomposition:
        """Decompose the global domain into tiles (reference
        go_decompose).  With no sizing given the domain is one tile;
        every tile lives on this grid's device."""
        if ndomains is None and ndomainx is None and ndomainy is None:
            ndomains = 1
        decomp = _decompose(domainx, domainy, ndomains=ndomains,
                            ndomainx=ndomainx, ndomainy=ndomainy,
                            halo_width=halo_width, align=align,
                            align_y=align_y)
        for axis, wrap, nproc, tile, glob in (
                ("x", self.wrap_x, decomp.nprocx, decomp.tile_nx,
                 domainx),
                ("y", self.wrap_y, decomp.nprocy, decomp.tile_ny,
                 domainy)):
            if wrap and nproc * tile != glob:
                raise ValueError(
                    f"periodic {axis} axis requires the global extent "
                    f"({glob}) to divide evenly into {nproc} tiles "
                    f"(got tile={tile}); choose a divisible size or a "
                    "different process grid")

        self.decomp = decomp
        self.global_nx = domainx
        self.global_ny = domainy
        self._initialised = False
        self.tmask = None
        self._tmask_np = None
        self._region_masks.clear()
        self.halo_spec = HaloSpec(
            nprocx=decomp.nprocx, nprocy=decomp.nprocy,
            halo=decomp.halo,
            tile_nx=decomp.tile_nx, tile_ny=decomp.tile_ny,
            local_nx=decomp.local_nx, local_ny=decomp.local_ny,
            wrap_x=self.wrap_x, wrap_y=self.wrap_y,
            repx=decomp.nprocx, repy=decomp.nprocy)
        return self.decomp

    # ------------------------------------------------------------------
    def init(self, dx: float, dy: float, tmask=None,
             time_step: float | None = None) -> None:
        """Flesh out the grid (reference grid_init).

        ``tmask`` is the GLOBAL T-point mask, shape (global_ny,
        global_nx), with 1=wet, 0=dry, -1=wet-outside-domain; all wet if
        omitted.  Halo and padding cells replicate the nearest edge value;
        on periodic axes one halo exchange then gives seam and wrap halo
        cells their partner's values."""
        if self.decomp is None:
            raise RuntimeError("call decompose() before init()")
        self.dx = float(dx)
        self.dy = float(dy)
        if time_step is not None:
            self.time_step = float(time_step)
        if tmask is None:
            tmask = np.ones((self.global_ny, self.global_nx), dtype=np.int32)
        tmask = np.asarray(tmask, dtype=np.int32)
        stacked = torch.from_numpy(
            layout.stack_global(self.decomp, tmask, mode="edge")
        ).to(self.device)
        if (self.wrap_x or self.wrap_y) and self.decomp.halo > 0:
            from ..parallel import halo as halo_mod
            stacked = halo_mod.exchange(stacked, self.halo_spec,
                                        depth=self.decomp.halo)
        self.tmask = stacked
        self._tmask_np = stacked.cpu().numpy()
        self._initialised = True
        self._region_masks.clear()

    def scatter_exchanged(self, global_arr, mode: str = "edge",
                          dtype=None) -> torch.Tensor:
        """Scatter a global ``(gny, gnx)`` array to the stacked layout
        and halo-exchange it to full depth, so every halo cell carries
        its source cell's value (seam- and wrap-correct).  The one way
        coefficient-like operands enter the step programs (solver
        couplings, face depths, boundary masks)."""
        from ..parallel import halo as halo_mod
        dt = kinds.as_dtype(dtype) if dtype is not None else self.dtype
        stacked = torch.from_numpy(layout.stack_global(
            self.decomp, np.asarray(global_arr), mode=mode,
            dtype=kinds.np_dtype(dt))).to(device=self.device, dtype=dt)
        return halo_mod.exchange(stacked, self.halo_spec,
                                 depth=self.decomp.halo)

    def global_tmask(self) -> np.ndarray:
        """The global (global_ny, global_nx) T mask as a host array."""
        return np.asarray(layout.unstack_internal(self.decomp,
                                                  self._tmask_np))

    # ------------------------------------------------------------------
    def region_mask(self, off_x: int = 0, off_y: int = 0,
                    dtype=None) -> torch.Tensor:
        """Mask (1 inside / 0 outside) of a global internal region shifted
        by the staggering offsets, on this grid's device.  Cached."""
        dtype = kinds.as_dtype(dtype) if dtype is not None else self.dtype
        key = (off_x, off_y, dtype)
        if key not in self._region_masks:
            m = layout.region_mask(self.decomp, off_x, off_y)
            self._region_masks[key] = torch.from_numpy(m).to(
                device=self.device, dtype=dtype)
        return self._region_masks[key]


def grid_init(grid: Grid, dx: float, dy: float, tmask=None,
              time_step: float | None = None) -> None:
    """Module-level spelling matching the reference API (grid_mod.f90:330)."""
    grid.init(dx, dy, tmask, time_step=time_step)
