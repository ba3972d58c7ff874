"""The finite-difference grid.

Counterpart of ``dl_esm_inf_tpu/core/grid.py`` (reference ``grid_type``
+ ``grid_init``).  It validates the grid kind, offset convention and
boundary conditions, owns the domain decomposition, holds the T-point
mask with its edge replication, the constant scale factors ``dx``/``dy``,
the lazily built metric arrays (``dx_t`` ... ``gphif``, replaced by
per-point arrays through :meth:`Grid.set_scale_factors`), the region
and external masks and the :class:`~..parallel.halo.HaloSpec`.

Differences from the JAX package: there is no device mesh and no
sharding.  The ranks of the run (:mod:`..parallel.environment`) take
the mesh's place: :func:`rank_grid` lays them out as the JAX package
lays devices out, and each rank holds its block of tiles as one stacked
tensor on its own ``torch.device`` (the card unless the caller passes
another).  One rank holds every tile.  Device tensors (``tmask``, the
masks, ``xt``/``yt``, the metric arrays) are this rank's block; host
arrays (``*_np``, ``xt_1d``/``yt_1d``, :meth:`Grid.global_tmask`) describe
the whole stacked layout.  :meth:`Grid.scatter_exchanged` brings global
coefficient arrays (solver couplings, face depths) in.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kinds, layout
from .constants import (ARAKAWA_B, ARAKAWA_C, BC, BC_PERIODIC, GridKind,
                        Offset)
from .decomposition import Decomposition, decompose as _decompose
from .region import Subdomain
from ..parallel import environment as env
from ..parallel.collectives import gather_to_host
from ..parallel.halo import HaloSpec


def rank_grid(px: int, py: int, nranks: int) -> tuple[int, int]:
    """``(my, mx)``: the rank grid of a ``px x py`` tile decomposition
    over ``nranks`` ranks, each rank holding a ``(py/my) x (px/mx)``
    block of tiles (the JAX package's ``_make_mesh``): the largest grid
    with ``my | py``, ``mx | px`` and ``my*mx <= nranks``, the most
    balanced among equals.  It must use every rank: a rank without tiles
    raises.

    The JAX package has the same limit, without the message: its
    ``_make_mesh`` (``dl_esm_inf_tpu/core/grid.py:46-73``) leaves the
    devices of a process idle, and a process without tiles cannot read a
    global array.  With 2 processes of one CPU device each and
    ``decompose(24, 20, ndomains=3)``, process 1's ``Field.checksum()``
    and ``collectives.global_sum`` raise "Fetching value for `jax.Array`
    that spans non-addressable (non process local) devices is not
    possible", and its ``gather_inner_data()``, a flagship
    ``build(32, 32, ndomains=3).run(10)`` and ``checkpoint.save_fields``
    raise "Array has no addressable shards"; process 0 then waits out a
    Gloo context timeout in those three.  One process runs every one of
    them."""
    best = None
    for my in range(1, py + 1):
        if py % my:
            continue
        for mx in range(1, px + 1):
            if px % mx or my * mx > nranks:
                continue
            key = (my * mx, min(my, mx))   # most ranks, then balanced
            if best is None or key > best[0]:
                best = (key, (my, mx))
    my, mx = best[1]
    if my * mx != nranks:
        raise ValueError(
            f"decomposition {px}x{py} cannot be split over {nranks} ranks "
            f"(at most {my * mx} ranks get an equal block of tiles); "
            "choose a tile count with a factor grid of the rank count")
    return my, mx


class Grid:
    """An Arakawa-C staggered grid on one device.

    ``device=None`` is the card (``cuda``); without one it raises, and
    ``device="cpu"`` runs on the CPU."""

    def __init__(self, grid_name=ARAKAWA_C,
                 boundary_conditions=(BC.EXTERNAL, BC.EXTERNAL, BC.NONE),
                 grid_offsets=Offset.NE, dtype=None, device=None):
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
        self._lazy = {}            # constant metric arrays, built on use
        self._curvi = {}           # per-point scale factors (curvilinear)
        self._curvi_derived: set = set()   # area_* entries derived here

    # ------------------------------------------------------------------
    @property
    def wrap_x(self) -> bool:
        return self.boundary_conditions[0] == BC_PERIODIC

    @property
    def wrap_y(self) -> bool:
        return self.boundary_conditions[1] == BC_PERIODIC

    @property
    def nx(self) -> int:
        """Local tile x extent incl. halos and padding (reference
        grid%nx)."""
        return self.decomp.local_nx

    @property
    def ny(self) -> int:
        return self.decomp.local_ny

    @property
    def array_shape(self) -> tuple[int, int]:
        """Shape of this rank's stacked block: (repy*ny, repx*nx); one
        rank holds the whole (nprocy*ny, nprocx*nx)."""
        return self.halo_spec.array_shape

    @property
    def global_array_shape(self) -> tuple[int, int]:
        """Shape of the whole stacked layout, every rank's block."""
        return (self.decomp.array_ny, self.decomp.array_nx)

    def local_block(self, stacked):
        """This rank's block of a whole-stacked-layout array (leading
        dims carried); the array itself on one rank."""
        spec = self.halo_spec
        if spec.num_ranks == 1:
            return stacked
        iy, ix = spec.rank_coords(env.get_rank())
        ny, nx = spec.array_shape
        return stacked[..., iy * ny: (iy + 1) * ny, ix * nx: (ix + 1) * nx]

    def block_tensor(self, stacked: np.ndarray, dtype=None) -> torch.Tensor:
        """A whole-stacked-layout host array as this rank's block on the
        device."""
        return torch.from_numpy(np.ascontiguousarray(
            self.local_block(stacked))).to(device=self.device, dtype=dtype)

    def subdomain(self, rank: int = 0) -> Subdomain:
        """One tile's subdomain (reference grid%subdomain, per rank)."""
        return self.decomp.subdomains[rank]

    # ------------------------------------------------------------------
    def decompose(self, domainx: int, domainy: int, ndomains=None,
                  ndomainx=None, ndomainy=None, halo_width: int = 1,
                  align: int | None = None,
                  align_y: int = 1) -> Decomposition:
        """Decompose the global domain into tiles (reference
        go_decompose); every tile lives on this grid's device.  With no
        sizing given, the ``GOCEAN_OMP_GRID`` environment variable
        ("NxM") is the (ndomainx, ndomainy) request, as in the JAX
        package (the reference's tiling-grid override,
        field_mod.f90:1473-1503); unset or malformed, the domain has one
        tile per rank (the JAX package's "every device").  The tiles are
        split over the run's ranks by :func:`rank_grid`."""
        if ndomains is None and ndomainx is None and ndomainy is None:
            from ..utils.config import read_env
            tile_grid = read_env().tile_grid
            if tile_grid is not None:
                ndomainx, ndomainy = tile_grid
            else:
                ndomains = env.get_num_ranks()
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
        my, mx = rank_grid(decomp.nprocx, decomp.nprocy,
                           env.get_num_ranks())

        self.decomp = decomp
        self.global_nx = domainx
        self.global_ny = domainy
        self._initialised = False
        self.tmask = None
        self._tmask_np = None
        self._clear_caches()
        self.halo_spec = HaloSpec(
            nprocx=decomp.nprocx, nprocy=decomp.nprocy,
            halo=decomp.halo,
            tile_nx=decomp.tile_nx, tile_ny=decomp.tile_ny,
            local_nx=decomp.local_nx, local_ny=decomp.local_ny,
            wrap_x=self.wrap_x, wrap_y=self.wrap_y,
            repx=decomp.nprocx // mx, repy=decomp.nprocy // my)
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
        stacked = self.block_tensor(
            layout.stack_global(self.decomp, tmask, mode="edge"))
        if (self.wrap_x or self.wrap_y) and self.decomp.halo > 0:
            from ..parallel import halo as halo_mod
            stacked = halo_mod.exchange(stacked, self.halo_spec,
                                        depth=self.decomp.halo)
        self.tmask = stacked
        self._tmask_np = gather_to_host(stacked, self.halo_spec)
        self._initialised = True
        self._clear_caches()

    def _clear_caches(self) -> None:
        self._region_masks.clear()
        self._lazy.clear()
        self._curvi.clear()
        self._curvi_derived.clear()

    def scatter_exchanged(self, global_arr, mode: str = "edge",
                          dtype=None) -> torch.Tensor:
        """Scatter a global ``(gny, gnx)`` array to the stacked layout
        and halo-exchange it to full depth, so every halo cell carries
        its source cell's value (seam- and wrap-correct).  The one way
        coefficient-like operands enter the step programs (solver
        couplings, face depths, boundary masks)."""
        from ..parallel import halo as halo_mod
        dt = kinds.as_dtype(dtype) if dtype is not None else self.dtype
        stacked = self.block_tensor(layout.stack_global(
            self.decomp, np.asarray(global_arr), mode=mode,
            dtype=kinds.np_dtype(dt)), dtype=dt)
        return halo_mod.exchange(stacked, self.halo_spec,
                                 depth=self.decomp.halo)

    # ------------------------------------------------------------------
    # Scale-factor / area / latitude arrays.  The regular grid's constant
    # arrays materialise on first use; set_scale_factors replaces any of
    # them with per-point arrays (GO_ORTHOGONAL_CURVILINEAR,
    # kernel_mod.f90:43-44).
    def _const_array(self, key: str, value: float) -> torch.Tensor:
        if key not in self._lazy:
            self._lazy[key] = torch.full(self.array_shape, value,
                                         dtype=self.dtype,
                                         device=self.device)
        return self._lazy[key]

    def _scale_array(self, name: str, const_key: str, value: float):
        if name in self._curvi:
            return self._curvi[name]
        return self._const_array(const_key, value)

    #: per-point array names set_scale_factors accepts (the reference's
    #: e1/e2/area/gphi families, grid_mod.f90:121-134)
    SCALE_FACTOR_NAMES = ("dx_t", "dx_u", "dx_v", "dx_f",
                          "dy_t", "dy_u", "dy_v", "dy_f",
                          "area_t", "area_u", "area_v",
                          "gphiu", "gphiv", "gphif")

    @property
    def is_curvilinear(self) -> bool:
        """True once per-point scale factors are installed: the grid
        then honours kernels declaring GO_ORTHOGONAL_CURVILINEAR."""
        return bool(self._curvi)

    def set_scale_factors(self, **arrays) -> None:
        """Install per-point scale factors, areas or latitudes.

        Pass GLOBAL ``(global_ny, global_nx)`` arrays for any of
        :data:`SCALE_FACTOR_NAMES`; they are scattered to the stacked
        layout (edge-replicated into halos and padding like the tmask;
        on periodic axes one exchange gives seam halos their wrap
        partner's values) and served by the grid-property getters of
        :mod:`~..api.kernel_meta`.  A missing ``area_*`` is derived as
        ``dx_* * dy_*`` when both are present (grid_mod.f90:505-510)."""
        if not self._initialised:
            raise RuntimeError("call init() before set_scale_factors()")
        unknown = sorted(set(arrays) - set(self.SCALE_FACTOR_NAMES))
        if unknown:
            raise ValueError(
                f"unknown scale-factor name(s) {unknown}; valid names: "
                f"{self.SCALE_FACTOR_NAMES}")
        for name, arr in arrays.items():
            arr = np.asarray(arr, dtype=kinds.np_dtype(self.dtype))
            if arr.shape != (self.global_ny, self.global_nx):
                raise ValueError(
                    f"{name} must be the GLOBAL array "
                    f"({self.global_ny}, {self.global_nx}), got "
                    f"{arr.shape}")
            dev = self.block_tensor(
                layout.stack_global(self.decomp, arr, mode="edge"))
            if (self.wrap_x or self.wrap_y) and self.decomp.halo > 0:
                from ..parallel import halo as halo_mod
                dev = halo_mod.exchange(dev, self.halo_spec,
                                        depth=self.decomp.halo)
            self._curvi[name] = dev
            self._curvi_derived.discard(name)
        for pt in ("t", "u", "v"):
            area = f"area_{pt}"
            inputs_changed = f"dx_{pt}" in arrays or f"dy_{pt}" in arrays
            if area in self._curvi_derived and inputs_changed:
                del self._curvi[area]          # stale derivation
                self._curvi_derived.discard(area)
            if (area not in self._curvi and f"dx_{pt}" in self._curvi
                    and f"dy_{pt}" in self._curvi):
                self._curvi[area] = (self._curvi[f"dx_{pt}"]
                                     * self._curvi[f"dy_{pt}"])
                self._curvi_derived.add(area)

    @property
    def dx_t(self): return self._scale_array("dx_t", "dx_c", self.dx)
    @property
    def dy_t(self): return self._scale_array("dy_t", "dy_c", self.dy)
    @property
    def dx_u(self): return self._scale_array("dx_u", "dx_c", self.dx)
    @property
    def dy_u(self): return self._scale_array("dy_u", "dy_c", self.dy)
    @property
    def dx_v(self): return self._scale_array("dx_v", "dx_c", self.dx)
    @property
    def dy_v(self): return self._scale_array("dy_v", "dy_c", self.dy)
    @property
    def dx_f(self): return self._scale_array("dx_f", "dx_c", self.dx)
    @property
    def dy_f(self): return self._scale_array("dy_f", "dy_c", self.dy)
    @property
    def area_t(self):
        return self._scale_array("area_t", "area", self.dx * self.dy)
    @property
    def area_u(self):
        return self._scale_array("area_u", "area", self.dx * self.dy)
    @property
    def area_v(self):
        return self._scale_array("area_v", "area", self.dx * self.dy)
    #: f-plane latitude, constant 50 degrees (grid_mod.f90:512-523)
    @property
    def gphiu(self): return self._scale_array("gphiu", "gphi", 50.0)
    @property
    def gphiv(self): return self._scale_array("gphiv", "gphi", 50.0)
    @property
    def gphif(self): return self._scale_array("gphif", "gphi", 50.0)

    def get_tmask(self) -> torch.Tensor:
        """Reference grid%get_tmask (grid_mod.f90:169-177): the stacked
        int32 T mask on this grid's device."""
        return self.tmask

    def xt_1d(self) -> np.ndarray:
        """x coordinate of T points per stacked column (host array):
        the global 1-based index times dx, extended into halo and padding
        columns as the reference extends it (grid_mod.f90:536-556)."""
        gx = layout.global_x_index(self.decomp)
        return ((gx + 1) * self.dx).astype(kinds.np_dtype(self.dtype))

    def yt_1d(self) -> np.ndarray:
        gy = layout.global_y_index(self.decomp)
        return ((gy + 1) * self.dy).astype(kinds.np_dtype(self.dtype))

    @property
    def xt(self) -> torch.Tensor:
        """:meth:`xt_1d` broadcast to the stacked array, on the device."""
        if "xt" not in self._lazy:
            self._lazy["xt"] = self.block_tensor(np.broadcast_to(
                self.xt_1d()[None, :], self.global_array_shape))
        return self._lazy["xt"]

    @property
    def yt(self) -> torch.Tensor:
        if "yt" not in self._lazy:
            self._lazy["yt"] = self.block_tensor(np.broadcast_to(
                self.yt_1d()[:, None], self.global_array_shape))
        return self._lazy["yt"]

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
            self._region_masks[key] = self.block_tensor(m, dtype=dtype)
        return self._region_masks[key]

    def region_mask_np(self, off_x: int = 0, off_y: int = 0) -> np.ndarray:
        """:meth:`region_mask` as a host bool array."""
        return layout.region_mask(self.decomp, off_x, off_y)

    def external_mask(self, off_x: int = 0, off_y: int = 0,
                      dtype=None) -> torch.Tensor:
        """Mask of the GLOBAL boundary ring (whole minus internal in
        global coordinates, :func:`~.layout.external_mask`): the write
        mask of ``GO_EXTERNAL_PTS`` kernels.  Cached."""
        dtype = kinds.as_dtype(dtype) if dtype is not None else self.dtype
        key = ("ext", off_x, off_y, dtype)
        if key not in self._region_masks:
            m = layout.external_mask(self.decomp, off_x, off_y)
            self._region_masks[key] = self.block_tensor(m, dtype=dtype)
        return self._region_masks[key]


    def external_mask_np(self, off_x: int = 0, off_y: int = 0) -> np.ndarray:
        """:meth:`external_mask` as a host bool array."""
        return layout.external_mask(self.decomp, off_x, off_y)


def grid_init(grid: Grid, dx: float, dy: float, tmask=None,
              time_step: float | None = None) -> None:
    """Module-level spelling matching the reference API (grid_mod.f90:330)."""
    grid.init(dx, dy, tmask, time_step=time_step)
