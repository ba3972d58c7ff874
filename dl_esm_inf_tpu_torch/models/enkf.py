"""Ensemble Kalman filtering (ETKF and LETKF) on the ensemble runner.

Counterpart of ``dl_esm_inf_tpu/models/enkf.py``.  The forecast
ensemble supplies the covariances: the ensemble transform Kalman filter
(Bishop et al. 2001; the square-root form of Hunt et al. 2007) reduces
the observation-space statistics to an (M, M) matrix and an (M,) vector,
takes one symmetric eigendecomposition, and mixes the members point by
point, ``X_a = x̄ + W^T X'``.

Each rank sums over its block of the stacked layout and the partial
sums are all-reduced, the JAX package's ``psum``: the global ETKF's
``(M, M)`` and ``(M,)`` moments in one call, the LETKF's observed
anomalies and means (each observation lives on the one rank whose block
holds its internal cell) in another, and the diagnostics' sums.  Every
rank then decomposes the same matrices and gets the same weights.  The
sums weight each cell by the internal mask times the model's wet mask
(``self._wet``): a halo copy of a cell counts 0, so an N-tile run sums
the same points as a 1-tile run.  Every point of the block, halo copies
included, is updated with the weights of its global position, so the
analysis needs no halo exchange.

Plain PyTorch on the card, as the JAX package runs plain jnp there (no
TPU kernel lies on this path): the moments are matrix products and the
LETKF's per-point eigendecompositions one batched ``torch.linalg.eigh``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..parallel import environment as env
from ..parallel.collectives import all_reduce


#: matrices per batched ``eigh`` call: cuSOLVER's batched solver
#: (``cusolverDnXsyevBatched``, torch 2.11 + CUDA 12.8 on an H100) takes
#: 2^14 matrices of 8, 16 or 33 rows at float32 and float64, and refuses
#: 2^15 or more with CUSOLVER_STATUS_INVALID_VALUE; the LETKF has one
#: matrix per point of the block (2^20 at 1024^2)
EIGH_BATCH = 1 << 14


def _eigh(a):
    """``torch.linalg.eigh`` over a batch of symmetric matrices, in
    calls of at most EIGH_BATCH matrices (each matrix is solved alone, so
    the split changes nothing)."""
    m = a.shape[-1]
    flat = a.reshape(-1, m, m)
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_BATCH)]
    lam = torch.cat([lp for lp, _ in parts]).reshape(a.shape[:-1])
    q = torch.cat([qp for _, qp in parts]).reshape(a.shape)
    return lam, q


def _etkf_weights(S, d, m, inflation):
    """ETKF weight matrix from obs-space moments: returns ``Wtot`` with
    ``Wtot[..., j, k]`` the weight of forecast perturbation j in
    analysis member k; batched over any leading dims (the LETKF's
    per-point ``(points, M, M)`` moments).

    ``S = Y'^T R^-1 Y'``, ``d = Y'^T R^-1 (y - Hx̄)``;
    ``P̃^-1 = (m-1) I / inflation + S``;
    ``w̄ = P̃ d``; ``W_a = sqrt(m-1) P̃^(1/2)``; ``Wtot = w̄ 1^T + W_a``.
    ``Wtot`` does not depend on the eigenvectors' signs or on the basis
    chosen within a repeated eigenvalue."""
    dtype, dev = S.dtype, S.device
    eye = torch.eye(m, dtype=dtype, device=dev)
    rho = torch.as_tensor(inflation, dtype=dtype, device=dev)
    pinv = (m - 1) / rho * eye + S
    lam, q = _eigh(pinv)
    # pinv is SPD by construction ((m-1)/rho > 0, S PSD); clamp anyway
    # so a degenerate ensemble cannot emit NaNs
    lam = torch.clamp(lam, min=1e-30)
    qt = q.transpose(-1, -2)
    p_tilde = (q / lam[..., None, :]) @ qt
    w_mean = (p_tilde @ d[..., None])[..., 0]
    w_anom = torch.sqrt(torch.as_tensor(m - 1, dtype=dtype, device=dev)) * (
        (q / torch.sqrt(lam)[..., None, :]) @ qt)
    return w_mean[..., None] + w_anom


def gaspari_cohn(r):
    """The Gaspari-Cohn 5th-order compactly-supported correlation
    function of ``r = distance / L`` (the standard covariance
    localisation taper; support ``r < 2``)."""
    # clamp before the polynomials: far observations arrive with huge r
    # and r**5 would overflow to inf
    r = torch.clamp(torch.abs(r), max=3.0)
    # the powers as the JAX package's integer_pow forms them (binary
    # powering: r**5 is r * (r*r)*(r*r)), not pow's library call
    r2 = r * r
    r3 = r * r2
    r4 = r2 * r2
    r5 = r * r4
    near = (-0.25 * r5 + 0.5 * r4 + 0.625 * r3 - (5.0 / 3.0) * r2 + 1.0)
    rs = torch.clamp(r, min=1e-12)
    far = ((1.0 / 12.0) * r5 - 0.5 * r4 + 0.625 * r3 + (5.0 / 3.0) * r2
           - 5.0 * r + 4.0 - (2.0 / 3.0) / rs)
    return torch.where(r <= 1.0, near,
                       torch.where(r <= 2.0, far, torch.zeros_like(r)))


def _mix(wtot, f):
    """``f̄ + W^T f'`` of one member-stacked state ``(M, *lead, ly, lx)``:
    ``wtot`` is ``(M, M)`` (global) or ``(ly, lx, M, M)`` (per point)."""
    fm = torch.mean(f, dim=0)
    fp = f - fm[None]
    if wtot.dim() == 2:
        return fm[None] + torch.einsum("mk,m...->k...", wtot, fp)
    M, ly, lx = f.shape[0], f.shape[-2], f.shape[-1]
    flat = fp.reshape(M, -1, ly, lx)
    mixed = torch.einsum("yxmk,mlyx->klyx", wtot, flat)
    return fm[None] + mixed.reshape(fp.shape)


class ETKF:
    """Ensemble transform Kalman filter over an ``Ensemble``.

    ``obs_field`` names the observed state field (default the first,
    the surface elevation in every adapter).  Observations arrive as a
    global ``(gny, gnx)`` value array plus a 0/1 mask of observed
    points (default: every wet internal point), with independent error
    std ``sigma``; ``inflation`` is multiplicative covariance inflation
    (rho >= 1 combats sampling noise from finite M).

    ``localization_radius=L`` (physical units) switches to the LETKF
    (Hunt et al. 2007): every grid point computes its own analysis from
    observations within ``2L``, with Gaspari-Cohn-tapered
    R-localisation.  At ``inflation=1`` points out of range of every
    observation are left exactly unchanged (the transform degenerates
    to the identity); with ``rho > 1`` their anomalies are scaled by
    ``sqrt(rho)`` per analysis.  ``adaptive_inflation`` re-estimates
    rho from the innovation statistics before each analysis (Wang and
    Bishop 2003), clipped to ``[1, inflation_max]``.  ``obs_level``
    picks the observed interface of a multi-level field."""

    def __init__(self, ensemble, *, obs_field: str | None = None,
                 sigma: float = 0.05, inflation: float = 1.0,
                 localization_radius: float | None = None,
                 obs_level: int = 0, adaptive_inflation: bool = False,
                 inflation_max: float = 2.0):
        self.ens = ensemble
        names = list(ensemble._field_names)
        self._obs_idx = (0 if obs_field is None
                         else names.index(obs_field))
        levels = ensemble._fields[self._obs_idx].levels
        if levels is None:
            if obs_level != 0:
                raise ValueError("obs_level applies to multi-level "
                                 "observed fields only")
            self._obs_level = None
        else:
            if not (0 <= obs_level < levels):
                raise ValueError(f"obs_level must be in [0, {levels}), "
                                 f"got {obs_level}")
            self._obs_level = int(obs_level)
        if sigma <= 0:
            raise ValueError("sigma must be > 0")
        if inflation < 1.0:
            raise ValueError("inflation must be >= 1 (multiplicative)")
        if localization_radius is not None and localization_radius <= 0:
            raise ValueError("localization_radius must be > 0 "
                             "(physical units; None = global ETKF)")
        if inflation_max < 1.0:
            raise ValueError("inflation_max must be >= 1")
        self.sigma = float(sigma)
        self.inflation = float(inflation)
        self.adaptive_inflation = bool(adaptive_inflation)
        self.inflation_max = float(inflation_max)
        self.localization_radius = (None if localization_radius is None
                                    else float(localization_radius))
        grid = ensemble.grid
        d = grid.decomp
        # observations count on wet internal points only: a halo copy of
        # a cell weighs 0, so the block's sums are the global ones
        wet = grid.block_tensor(layout.internal_mask(d), dtype=grid.dtype)
        model = ensemble.model
        t_wet = getattr(model, "_t_upd", None)
        if t_wet is None:
            t_wet = getattr(model, "_t_wet", None)
        if t_wet is not None:
            wet = wet * t_wet.to(wet.dtype)
        self._wet = wet
        # per-row / per-column GLOBAL indices of this rank's block (halo
        # cells included, so a halo point gets its interior twin's
        # distances, hence its weights)
        spec = grid.halo_spec
        iy, ix = spec.rank_coords(env.get_rank())
        ny, nx = spec.array_shape
        self._block0 = (iy * ny, ix * nx)
        self._gy = torch.from_numpy(
            layout.global_y_index(d)[iy * ny:(iy + 1) * ny]).to(grid.device)
        self._gx = torch.from_numpy(
            layout.global_x_index(d)[ix * nx:(ix + 1) * nx]).to(grid.device)

    # ------------------------------------------------------------------
    def _observed(self, state):
        eo = state[self._obs_idx]
        return eo if self._obs_level is None else eo[:, self._obs_level]

    def _global_update(self, obs, ow, sig_inv2, rho):
        """The global ETKF: moments summed over the block and
        all-reduced in one call, one (M, M) eigendecomposition, the
        member-space mix at every point."""
        states = self.ens.states
        m = self.ens.n_members
        w = ow * self._wet * sig_inv2
        eo = self._observed(states)
        em = torch.mean(eo, dim=0)
        ep = eo - em[None]
        epf = ep.reshape(m, -1)
        S = epf @ (ep * w[None]).reshape(m, -1).T
        d = epf @ ((obs - em) * w).reshape(-1)
        Sd = all_reduce(torch.cat((S.reshape(-1), d)))
        S, d = Sd[:m * m].reshape(m, m), Sd[m * m:]
        wtot = _etkf_weights(S, d, m, rho)
        return tuple(_mix(wtot, f) for f in states)

    def _localized_update(self, oyi, oxi, ovals, sig_inv2, rho):
        """The LETKF: every point of the block solves its own (M, M)
        analysis from the Gaspari-Cohn-tapered observations.

        The observed points' anomalies and means are gathered by index
        where the JAX package sums a one-hot product (every other term
        of that sum is a signed zero, so the two are equal); an
        observation on a dry point contributes nothing, as there.  The
        taper is the JAX package's ``(p, ly, lx)`` tensor, and weights S
        and d in the same order; without static shapes the observation
        count needs no padding.  Across ranks the rank whose block holds
        an observation's internal cell gives its row, the others zeros,
        and one all-reduce assembles ``yp`` and ``mo`` everywhere."""
        states = self.ens.states
        m = self.ens.n_members
        grid = self.ens.grid
        d = grid.decomp
        dtype, dev = grid.dtype, grid.device
        eo = self._observed(states)
        em = torch.mean(eo, dim=0)
        ep = eo - em[None]
        # the internal copy of each observed global cell, in the whole
        # stacked layout, then in this rank's block (elsewhere: cell 0,
        # deselected)
        h = d.halo
        sy = (oyi // d.tile_ny) * d.local_ny + h + oyi % d.tile_ny
        sx = (oxi // d.tile_nx) * d.local_nx + h + oxi % d.tile_nx
        ly, lx = ep.shape[-2:]
        sy, sx = sy - self._block0[0], sx - self._block0[1]
        mine = (sy >= 0) & (sy < ly) & (sx >= 0) & (sx < lx)
        sy, sx = torch.where(mine, sy, 0), torch.where(mine, sx, 0)
        sel = mine & (self._wet[sy, sx] > 0)
        zero = torch.zeros((), dtype=dtype, device=dev)
        ypm = all_reduce(torch.cat(
            (torch.where(sel, ep[:, sy, sx], zero),
             torch.where(sel, em[sy, sx], zero)[None])).T)  # (p, M + 1)
        yp, mo = ypm[:, :m], ypm[:, m]
        innov = ovals - mo
        # per-point taper of R^-1: the distances broadcast from the
        # block's row and column indices
        fy = (self._gy.to(dtype)[None, :, None]
              - oyi.to(dtype)[:, None, None]) * float(grid.dy)
        fx = (self._gx.to(dtype)[None, None, :]
              - oxi.to(dtype)[:, None, None]) * float(grid.dx)
        rad = torch.as_tensor(self.localization_radius, dtype=dtype,
                              device=dev)
        taper = gaspari_cohn(torch.sqrt(fy * fy + fx * fx) / rad)
        w = taper * sig_inv2                                 # (p, ly, lx)
        p, ly, lx = w.shape
        wf = w.reshape(p, ly * lx).T
        S = (wf @ (yp[:, :, None] * yp[:, None, :]).reshape(p, m * m)
             ).reshape(ly, lx, m, m)
        dloc = (wf @ (yp * innov[:, None])).reshape(ly, lx, m)
        del w, wf, taper
        wtot = _etkf_weights(S, dloc, m, rho)               # (ly, lx, M, M)
        return tuple(_mix(wtot, f) for f in states)

    # ------------------------------------------------------------------
    def analysis(self, obs_global, obs_mask=None) -> dict:
        """Assimilate one batch of observations into the ensemble
        (in place).  Returns obs-space diagnostics: RMS innovation of
        the ensemble mean before and after, the mean spread of the
        observed field before/after (on observed points), and the
        inflation used."""
        ens = self.ens
        grid = ens.grid
        d = grid.decomp
        dtype, dev = grid.dtype, grid.device
        npdt = kinds.np_dtype(dtype)
        obs = grid.block_tensor(layout.stack_global(
            d, np.asarray(obs_global), mode="zeros", dtype=npdt))
        if obs_mask is None:
            ow = torch.ones_like(obs)
        else:
            ow = grid.block_tensor(layout.stack_global(
                d, (np.asarray(obs_mask) != 0).astype(npdt), mode="zeros",
                dtype=npdt))

        before = self._obs_diagnostics(obs, ow)
        if self.adaptive_inflation:
            # Wang & Bishop (2003): consistency wants <d^2> = spread^2 +
            # sigma^2, so the forecast variance deficit is the
            # multiplicative inflation that restores it; clipped to
            # [1, inflation_max] and kept for the next cycle
            rms, spread = before
            est = (rms ** 2 - self.sigma ** 2) / max(spread ** 2, 1e-30)
            self.inflation = float(np.clip(est, 1.0, self.inflation_max))
        sig_inv2 = torch.as_tensor(1.0 / self.sigma ** 2, dtype=dtype,
                                   device=dev)
        if self.localization_radius is None:
            ens.states = self._global_update(obs, ow, sig_inv2,
                                             self.inflation)
        else:
            mask_np = (np.ones((d.global_ny, d.global_nx), bool)
                       if obs_mask is None
                       else np.asarray(obs_mask) != 0)
            iy, ix = np.nonzero(mask_np)
            vals = np.asarray(obs_global)[iy, ix].astype(npdt)
            ens.states = self._localized_update(
                torch.from_numpy(iy).to(dev), torch.from_numpy(ix).to(dev),
                torch.from_numpy(vals).to(dev), sig_inv2, self.inflation)
        after = self._obs_diagnostics(obs, ow)
        return {"rms_innovation_before": before[0],
                "rms_innovation_after": after[0],
                "spread_before": before[1], "spread_after": after[1],
                "inflation": self.inflation}

    def _obs_diagnostics(self, obs, ow):
        """(RMS mean innovation, mean member spread) on observed wet
        internal points; the spread is the population variance's root,
        as ``jnp.var`` gives it.  The three sums are all-reduced in one
        call."""
        w = ow * self._wet
        eo = self._observed(self.ens.states)
        em = torch.mean(eo, dim=0)
        sums = all_reduce(torch.stack((
            torch.sum(w), torch.sum((em - obs) ** 2 * w),
            torch.sum(torch.var(eo, dim=0, correction=0) * w))))
        npts = torch.clamp(sums[0], min=1.0)
        rms = torch.sqrt(sums[1] / npts)
        spread = torch.sqrt(sums[2] / npts)
        return float(rms), float(spread)
