"""The reference example program (finite_difference/example/model.f90:
54-109), as the JAX package's ``models/example_model.py`` runs it: build a
4x10 Arakawa-C grid with external BCs and NE offset, decompose it,
create U/V/T/F fields, set each tile's data to its (1-based) rank,
halo-exchange, and checksum.  On the card by default::

    python -m dl_esm_inf_tpu_torch.models.example_model

prints the four checksums (4.00000000E+01 each) and "Example model
set-up complete."
"""
from __future__ import annotations

import numpy as np

from .. import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, F_POINTS, OFFSET_NE,
                T_POINTS, U_POINTS, V_POINTS, Field, Grid, field_checksum,
                finalise, grid_init, initialise)
from ..core import kinds
from ..utils.logging import model_write_log


def init_field_by_rank(field: Field) -> None:
    """field%data(:,:) = rank (model.f90:113-121; reference ranks are
    1-based, so tile k holds k+1 everywhere)."""
    d = field.grid.decomp
    stacked = np.empty(field.grid.array_shape,
                       dtype=kinds.np_dtype(field.dtype))
    for rank in range(d.ndomains):
        sy, sx = d.shard_slices(rank)
        stacked[sy, sx] = float(rank + 1)
    field.set_data(stacked)


def expected_checksum(field: Field) -> float:
    """Analytic checksum: sum over tiles of rank_1based * internal pts."""
    d = field.grid.decomp
    return float(sum((rank + 1) * field.internal_region(rank).npts
                     for rank in range(d.ndomains)))


def run(jpiglo: int = 4, jpjglo: int = 10, ndomains=None, device=None,
        transport: str = "ppermute") -> dict:
    """The example on ``device`` (the card by default); ``transport`` is
    the halo exchange's (``"ppermute"`` or ``"remote_dma"``).  Returns the
    four checksums."""
    initialise()
    grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE), OFFSET_NE,
                device=device)
    grid.decompose(jpiglo, jpjglo, ndomains=ndomains)
    tmask = np.ones((jpjglo, jpiglo), dtype=np.int32)
    grid_init(grid, 1.0, 1.0, tmask)

    fields = {name: Field(grid, pts) for name, pts in
              (("u", U_POINTS), ("v", V_POINTS),
               ("t", T_POINTS), ("f", F_POINTS))}
    for fld in fields.values():
        init_field_by_rank(fld)
        fld.halo_exchange(1, transport=transport)

    sums = {name: field_checksum(fld) for name, fld in fields.items()}
    for name, val in sums.items():
        model_write_log(f"{name.upper()} checksum = {val:.8E}")
    model_write_log("Example model set-up complete.")
    finalise()
    return sums


if __name__ == "__main__":
    run()
