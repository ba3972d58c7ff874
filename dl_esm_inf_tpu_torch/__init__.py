"""dl_esm_inf_tpu_torch — the PyTorch/CUDA port of dl_esm_inf_tpu.

The same 2D finite-difference earth-system modelling infrastructure as
the JAX package beside it (Arakawa-C grids, staggered fields, domain
decomposition with halo exchange, reductions), in eager PyTorch, with
hand-written CUDA kernels for the hot paths, and the PSyclone-style
kernel-metadata layer (``api.kernel_meta``: ``invoke``, ``Schedule``,
whose fused sweep is generated as CUDA from the schedule).  It imports
``torch`` and never ``jax``.  A ``Grid`` carries a ``torch.device``: the
card (``cuda``) unless the caller passes another, as the CPU tests do
with ``device="cpu"``; without a card and without a device it raises.

Quick start::

    import dl_esm_inf_tpu_torch as dl

    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)                # on the card
    grid.decompose(jpiglo, jpjglo)
    dl.grid_init(grid, dx, dy, tmask)          # tmask: global (ny, nx)
    u = dl.Field(grid, dl.U_POINTS)
    u.halo_exchange(1)
    print(dl.field_checksum(u))
"""
from .core.constants import (  # noqa: F401
    ARAKAWA_B, ARAKAWA_C, BC, BC_EXTERNAL, BC_NONE, BC_PERIODIC, GridKind,
    GridPoints, NBOUNDARY, Offset, OFFSET_ANY, OFFSET_NE, OFFSET_NW,
    OFFSET_SE, OFFSET_SW, ALL_POINTS, F_POINTS, T_POINTS, U_POINTS, V_POINTS,
    TMASK_DRY, TMASK_OUTSIDE, TMASK_WET)
from .core.decomposition import (  # noqa: F401
    Decomposition, choose_process_grid, decompose, reference_subdomains)
from .core.field import (  # noqa: F401
    Field, copy_field, copy_field_patch, field_checksum, free_field,
    set_field)
from .core.grid import Grid, grid_init  # noqa: F401
from .core.kinds import set_working_precision, wp  # noqa: F401
from .core.region import Halo, Region, Subdomain  # noqa: F401
from .parallel import collectives, halo  # noqa: F401
from .parallel.environment import (  # noqa: F401
    GOceanStop, finalise, get_num_ranks, get_rank, initialise, on_master,
    stop)
from .utils.logging import model_write_log  # noqa: F401

__version__ = "0.1.0"
