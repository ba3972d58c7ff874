"""Public enumerations of the framework.

Mirrors the reference's grid/field enumerations so that client code
translates one-to-one:

* grid kinds           — reference grid_mod.f90:45-46
* offset conventions   — reference grid_mod.f90:52-60
* boundary conditions  — reference grid_mod.f90:64-69
* grid-point types     — reference field_mod.f90:47-52
* iteration-space enums — reference global_parameters_mod.f90:13-17
"""
from __future__ import annotations

from enum import IntEnum


class GridKind(IntEnum):
    """Supported staggered-grid arrangements (GO_ARAKAWA_C / GO_ARAKAWA_B)."""
    ARAKAWA_C = 0
    #: Declared but rejected at runtime, like the reference (grid_mod.f90:250-260).
    ARAKAWA_B = 1


ARAKAWA_C = GridKind.ARAKAWA_C
ARAKAWA_B = GridKind.ARAKAWA_B


class Offset(IntEnum):
    """How U/V/F points are indexed relative to the T point with the same (i, j).

    SW: points to the south and west of a T point share its indices
    ('shallow' convention).  NE: points to the north and east share its
    indices (NEMO convention).  (reference grid_mod.f90:52-60)
    """
    SW = 0
    SE = 1
    NW = 2
    NE = 3
    ANY = 4


OFFSET_SW = Offset.SW
OFFSET_SE = Offset.SE
OFFSET_NW = Offset.NW
OFFSET_NE = Offset.NE
OFFSET_ANY = Offset.ANY


class BC(IntEnum):
    """Boundary-condition type per dimension (reference grid_mod.f90:64-69)."""
    PERIODIC = 0
    EXTERNAL = 1
    NONE = 2


BC_PERIODIC = BC.PERIODIC
BC_EXTERNAL = BC.EXTERNAL
BC_NONE = BC.NONE


class GridPoints(IntEnum):
    """Which staggered points a field lives on (reference field_mod.f90:47-52)."""
    U = 0
    V = 1
    T = 2
    F = 3
    ALL = 4


U_POINTS = GridPoints.U
V_POINTS = GridPoints.V
T_POINTS = GridPoints.T
F_POINTS = GridPoints.F
ALL_POINTS = GridPoints.ALL

#: Boundary ring width outside the internal region (reference NBOUNDARY,
#: field_mod.f90:227).
NBOUNDARY = 1

# Kernel iteration-space enums (reference global_parameters_mod.f90:13-17).
GO_VERTICES = 0
GO_EDGES = 1
GO_CELLS = 2

#: finite-element stencil marker (reference global_parameters_mod.f90:20-23)
GO_FE = 4
#: maximum object-name length (reference global_parameters_mod.f90:9);
#: irrelevant to Python strings, kept for completeness
NAME_LEN = 1024

# T-mask point classification (reference grid_mod.f90:94-102).
TMASK_WET = 1
TMASK_DRY = 0
TMASK_OUTSIDE = -1
