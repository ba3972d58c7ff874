"""Physical diagnostics for shallow-water clients.

Counterpart of ``dl_esm_inf_tpu/utils/diagnostics.py``.  The reference
library's only diagnostic is the checksum (field_mod.f90:1289-1307); a
production ESM framework also monitors conserved quantities and
stability margins.  All reductions here are masked internal-point sums
and maxima over every tile, accumulated in the checksum dtype
(:func:`..parallel.collectives.masked_sum`).
"""
from __future__ import annotations

import math

import torch

from ..core.field import Field
from ..ops import stencils as st
from ..parallel.collectives import masked_sum


def volume(eta: Field, dx: float, dy: float) -> float:
    """∫ eta dA over internal points (mass anomaly per unit rho)."""
    return eta.integral() * dx * dy


def potential_energy(eta: Field, g: float, dx: float, dy: float) -> float:
    """0.5 g ∫ eta² dA (available PE of the free surface)."""
    return 0.5 * g * masked_sum(torch.square(eta.data),
                                eta.internal_mask) * dx * dy


def kinetic_energy(u: Field, v: Field, depth, dx: float,
                   dy: float, ssh_u: Field | None = None,
                   ssh_v: Field | None = None) -> float:
    """0.5 ∫ h (u² + v²) dA — depth-integrated kinetic energy.

    ``depth`` is a flat-bottom scalar OR a T-point bathymetry plane in
    the fields' stacked layout (e.g. ``NemoLite2D.bathymetry``); face
    depths are the same centred means the model uses.  Passing the face
    ssh fields (``ssh_u``/``ssh_v``) upgrades the weight to the TOTAL
    water column h+eta — the energy the nonlinear flagship actually
    transports."""
    ht = torch.as_tensor(depth, dtype=u.data.dtype, device=u.data.device)
    if ht.dim() == 0:
        hu = hv = ht
    else:
        hu = st.avg_x(ht)
        hv = st.avg_y(ht)
    if ssh_u is not None:
        hu = hu + ssh_u.data
    if ssh_v is not None:
        hv = hv + ssh_v.data
    ke = (masked_sum(hu * torch.square(u.data), u.internal_mask)
          + masked_sum(hv * torch.square(v.data), v.internal_mask))
    return 0.5 * ke * dx * dy


def cfl_number(u: Field, v: Field, dt: float, dx: float, dy: float,
               g: float = 9.81, depth: float | None = None) -> float:
    """Advective (+ optional gravity-wave) Courant number.

    Stability of the forward-backward SW schemes requires roughly
    cfl < 1 with the gravity-wave term included."""
    adv = u.max_abs() * dt / dx + v.max_abs() * dt / dy
    if depth is not None:
        c = math.sqrt(g * depth)
        adv += c * dt * math.sqrt(1.0 / dx ** 2 + 1.0 / dy ** 2)
    return adv
