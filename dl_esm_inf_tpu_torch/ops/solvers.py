"""Iterative elliptic solvers (PCG + Chebyshev) on a rank's block.

Counterpart of ``dl_esm_inf_tpu/ops/solvers.py``.  Semi-implicit
free-surface codes need one elliptic solve per time step: a CG with
halo exchanges inside the matvec and global dot products.  Here every
tile a rank holds lives in one stacked tensor, so

* the matvec is a depth-1 halo exchange plus the local 5-point stencil;
* a dot product is one masked reduction of the rank's block,
  accumulated in :func:`..core.kinds.sum_dtype` of the data, then
  all-reduced across ranks (:func:`..parallel.collectives.all_reduce`;
  CG's two dots per iteration in one call, as the JAX package's one
  ``psum``);
* CG's ``lax.while_loop`` becomes a Python loop whose tolerance test
  reads one scalar from the device per iteration.

Two layers, as in the JAX package:

:func:`pcg_block` / :func:`chebyshev_block` — the iterations on one
stacked block, for models that embed a solve in their step
(``models/semi_implicit.py``).

:class:`HelmholtzSolver` — ``(I + lam*L) x = b`` on wet T points with
no-flux walls expressed through the tmask.  ``method="chebyshev",
fused=True`` runs K Chebyshev iterations per pass over memory through
the hand-written kernel ``csrc/helmholtz_cheb_sweep.cu`` on a CUDA grid,
and through the kernel's plain version (:func:`cheb_step` K times) on
the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..parallel import halo as halo_mod
from ..parallel.collectives import all_reduce
from ..parallel.halo import exchange_multi_fn
from . import stencils as st
from .stencil_sweep import RING, StencilSweepKernel, stencil_sweep_reference

#: the process's one wrapper of the fused Chebyshev sweep kernel: state
#: (x, r, d), the 4-bit face code, per sweep the constants
#: (lam_x, lam_y, c1[RING], c2[RING])
helmholtz_cheb_sweep = StencilSweepKernel("helmholtz_cheb_sweep", n_state=3,
                                          has_code=True)


def _exchange_fn(spec, depth: int = 1):
    """``x -> x`` with its halo refreshed to ``depth``."""
    return lambda x: halo_mod.exchange(x, spec, depth)


def _tiny(acc: torch.dtype) -> float:
    return float(torch.finfo(acc).tiny)


def pcg_block(matvec, b, x0, weight, *, tol: float, maxiter: int,
              inv_diag=None):
    """Preconditioned conjugate gradients on one stacked block.

    ``matvec`` accepts a block whose halo ring is stale and returns
    ``A x`` valid on internal cells (it exchanges itself); halo cells of
    every iterate are garbage by contract and are excluded from the dot
    products by ``weight`` (1 on cells counted once globally, 0 on
    halos and padding, ``layout.internal_mask``).  ``inv_diag`` enables
    Jacobi preconditioning.

    Returns ``(x, iters, rel_res)`` with ``x``'s halo ring stale,
    ``iters`` a Python int and ``rel_res`` a 0-dim tensor of the
    accumulation dtype.  Across ranks each dot product is all-reduced,
    so every rank runs the same iterations."""
    acc = kinds.sum_dtype(b.dtype)
    w = weight.to(acc)
    zero = torch.zeros((), dtype=acc, device=b.device)

    def pdot(u, v):
        return all_reduce((u.to(acc) * v.to(acc) * w).sum())

    def pdot2(u1, v1, u2, v2):
        """Two dot products in ONE reduction and one all-reduce."""
        uv = torch.stack((u1.to(acc) * v1.to(acc), u2.to(acc) * v2.to(acc)))
        return all_reduce((uv * w).sum(dim=(-2, -1)))

    def prec(r):
        return r * inv_diag if inv_diag is not None else r

    r = b - matvec(x0)
    z = prec(r)
    rz, rr = pdot2(r, z, r, r).unbind()
    bb = pdot(b, b)
    # relative tolerance against the rhs norm; an all-zero rhs converges
    # immediately (x = x0 if it already solves it)
    tol2 = float(tol) ** 2 * max(float(bb), _tiny(acc))
    x, p, k = x0, z, 0
    while float(rr) > tol2 and k < maxiter:
        ap = matvec(p)
        pap = pdot(p, ap)
        alpha = torch.where(pap != 0, rz / pap, zero)
        x = x + alpha.to(x.dtype) * p
        r = r - alpha.to(r.dtype) * ap
        z = prec(r)
        rz_new, rr = pdot2(r, z, r, r).unbind()
        beta = torch.where(rz != 0, rz_new / rz, zero)
        p = z + beta.to(p.dtype) * p
        rz = rz_new
        k += 1
    rel = torch.sqrt(rr / torch.clamp(bb, min=_tiny(acc)))
    return x, k, rel


class _PCGSolve(torch.autograd.Function):
    """The projected symmetric solve with an implicit backward: the
    forward is CG under ``no_grad``; the backward is one more solve of
    the same symmetric system with the cotangent as right-hand side
    (what ``lax.custom_linear_solve(symmetric=True)`` does in the JAX
    package), so the iterations are never recorded.  Across ranks both
    solves all-reduce their dot products (:func:`pcg_block`), so every
    rank runs the same adjoint iterations and gets its block of one
    gradient."""

    @staticmethod
    def forward(ctx, b, x0, sym_mv, weight, tol, maxiter, inv_diag):
        start = weight * x0
        with torch.no_grad():
            x, _k, _rel = pcg_block(sym_mv, weight * b, start, weight,
                                    tol=tol, maxiter=maxiter,
                                    inv_diag=inv_diag)
        ctx.solve = (sym_mv, start, weight, tol, maxiter, inv_diag)
        return weight * x

    @staticmethod
    def backward(ctx, g):
        sym_mv, start, weight, tol, maxiter, inv_diag = ctx.solve
        with torch.no_grad():
            # the JAX package's solve closes over the forward's start
            # and takes it for the transposed solve too
            y, _k, _rel = pcg_block(sym_mv, g, start, weight, tol=tol,
                                    maxiter=maxiter, inv_diag=inv_diag)
        return weight * (weight * y), None, None, None, None, None, None


def pcg_solve(matvec, b, weight, *, tol: float, maxiter: int,
              inv_diag=None, x0=None, constants=()):
    """Differentiable per-block solve (the contract of :func:`pcg_block`
    without the iteration count), the counterpart of the JAX package's
    ``pcg_solve``: reverse mode never records the CG iterations.

    The raw exchange-then-stencil ``matvec`` is not symmetric on the
    whole padded block (halo rows break it), so both sides are
    projected with ``weight``: ``x -> weight * matvec(weight * x)`` is
    the global symmetric operator on canonical (halo-zeroed) vectors
    and zero elsewhere.  The forward solves it from ``weight * x0`` with
    right-hand side ``weight * b``; the backward solves it with the
    cotangent (implicit differentiation), so the gradient reaches ``b``
    alone: the start ``x0`` carries none, and the operator must be
    constant.  ``constants`` are the tensors ``matvec`` closes over
    (its coefficients); if any of them, ``weight`` or ``inv_diag``
    requires a gradient this raises.  Returns the canonical solution
    (halo cells zero: exchange it before stencil use)."""
    for t in (weight, inv_diag, *constants):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise ValueError(
                "pcg_solve differentiates with respect to the right-hand "
                "side only: the operator's coefficients, weight and "
                "inv_diag must not require a gradient")

    def sym_mv(x):
        return weight * matvec(weight * x)

    start = torch.zeros_like(b) if x0 is None else x0.detach()
    return _PCGSolve.apply(b, start, sym_mv, weight, float(tol),
                           int(maxiter), inv_diag)


def default_tol(dtype) -> float:
    """Dtype-aware default stopping tolerance: 50*eps, floored at 1e-10
    (f64 -> 1e-10, f32 -> 6e-6).  A fixed 1e-10 would make a float32
    solve grind on a residual the iterates cannot represent."""
    return max(float(torch.finfo(kinds.as_dtype(dtype)).eps) * 50.0, 1e-10)


def helmholtz_coefficients(grid, lam_x, lam_y, diag_extra=None):
    """Stacked-layout face/diagonal coefficient tensors for
    ``A = I + lam*L`` with no-flux walls.

    ``L`` is the negated masked 5-point Laplacian: a face conducts only
    between two solver-active cells (wet AND inside the global domain),
    so shard-halo cells evolve exactly like their interior twins and the
    matvec needs only a depth-1 exchange.  Returns ``(e, w, n, s,
    diag)`` on the grid's device.

    ``lam_x``/``lam_y`` are scalars, or ``(gny, gnx)`` global per-face
    coupling arrays (``lam_x[j, i]`` is the face between T cells
    ``(j, i)`` and ``(j, i+1)``, the NE-offset U/V-face convention).
    ``w`` is ``e`` rolled, not an independent product, so the operator
    is symmetric, and SPD for any positive coefficient field.

    ``diag_extra`` (global ``(gny, gnx)`` array) adds per-cell diagonal
    terms: the radiation terms of an implicit open boundary."""
    d = grid.decomp
    gx = layout.global_x_index(d)
    gy = layout.global_y_index(d)
    geo = (((gy >= 0) & (gy < d.global_ny))[:, None]
           & ((gx >= 0) & (gx < d.global_nx))[None, :])
    dtype = grid.dtype
    # halo cells that are copies of real cells (periodic wrap, or the
    # plain shard seam) must conduct: exchanging the strict in-domain
    # mask stamps each halo cell with its source cell's validity, and
    # leaves non-wrap outer halos at their stale False.
    geo_x = halo_mod.exchange(
        grid.block_tensor(geo.astype(kinds.np_dtype(dtype))),
        grid.halo_spec, depth=d.halo)
    a = ((grid.tmask == 1) & (geo_x > 0.5)).to(dtype)

    def face(lam):
        """Stacked per-face coupling: scalar, or a global array scattered
        and exchanged so halo faces carry their source face's value."""
        if np.ndim(lam) == 0:
            return float(lam)
        return grid.scatter_exchanged(lam, mode="edge", dtype=dtype)

    lx_f, ly_f = face(lam_x), face(lam_y)
    e = lx_f * a * torch.roll(a, -1, 1)
    n = ly_f * a * torch.roll(a, -1, 0)
    w = torch.roll(e, 1, 1) * a * torch.roll(a, 1, 1)
    s = torch.roll(n, 1, 0) * a * torch.roll(a, 1, 0)
    diag = 1.0 + e + w + n + s
    if diag_extra is not None:
        diag = diag + a * grid.scatter_exchanged(diag_extra, mode="zeros",
                                                 dtype=dtype)
    return e, w, n, s, diag.to(dtype)


def chebyshev_iterations(lam_min: float, lam_max: float, tol: float) -> int:
    """Iterations for the Chebyshev error bound
    ``2 * ((sqrt(k)-1)/(sqrt(k)+1))^n <= tol``, ``k`` the
    eigenvalue-bound condition number."""
    k = lam_max / lam_min
    rho = (np.sqrt(k) - 1.0) / (np.sqrt(k) + 1.0)
    if rho <= 0:
        return 1
    return max(1, int(np.ceil(np.log(2.0 / tol) / -np.log(rho))))


def _cheb_params(lam_min: float, lam_max: float):
    """``(theta, delta, sigma1)`` of the Chebyshev recurrence."""
    theta = 0.5 * (lam_max + lam_min)
    # delta=0 (identity operator, lam_max == lam_min) degenerates to a
    # single Richardson step; the clamp keeps the recurrence finite and
    # exact in that limit (2*rho1/delta -> 1/theta)
    delta = max(0.5 * (lam_max - lam_min), 1e-30 * theta)
    return theta, delta, theta / delta


def chebyshev_scalars(lam_min: float, lam_max: float,
                      niters: int) -> np.ndarray:
    """Host-computed ``(niters, 2)`` per-iteration recurrence
    coefficients ``(c1_k, c2_k)`` with ``d <- c1*d + c2*r``.  The rho
    sequence is data-independent: that is what lets the iteration run
    as a fused sweep with per-sub-step scalars and no dot products."""
    _theta, delta, sigma1 = _cheb_params(lam_min, lam_max)
    rho = 1.0 / sigma1
    out = np.zeros((niters, 2))
    for k in range(niters):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        out[k] = (rho_new * rho, 2.0 * rho_new / delta)
        rho = rho_new
    return out


def chebyshev_block(b, x0, *, matvec, lam_min: float, lam_max: float,
                    niters: int, exchange_every=None):
    """Chebyshev iteration on one stacked block: no inner products, so
    the only communication is what ``matvec`` does.  It needs
    eigenvalue bounds instead (for the Helmholtz operator
    ``[1, 1 + 4*(lam_x+lam_y)]`` by Gershgorin) and runs a static
    iteration count (:func:`chebyshev_iterations`).  The recurrence
    scalars are the host's float64 :func:`chebyshev_scalars`, each
    cast once to the data's dtype where it is used.

    ``exchange_every=(K, exch_multi_fn)`` selects deep-halo mode:
    ``matvec`` must then omit its exchange, and the iterate triple
    (x, r, d) is refreshed once per K matvecs (``niters`` a multiple of
    K, the halo at least K deep)."""
    theta = _cheb_params(lam_min, lam_max)[0]
    sc = chebyshev_scalars(lam_min, lam_max, niters)

    def one(x, r, d, k):
        x = x + d
        r = r - matvec(d)
        d = float(sc[k, 0]) * d + float(sc[k, 1]) * r
        return x, r, d

    if exchange_every is None:
        r = b - matvec(x0)
        x, d = x0, r / theta
        for k in range(niters):
            x, r, d = one(x, r, d, k)
        return x

    K, exchK = exchange_every
    if niters % K:
        raise ValueError(f"niters={niters} must be a multiple of "
                         f"steps_per_exchange K={K}")
    b, x0 = exchK((b, x0))               # operands halo-consistent
    r = b - matvec(x0)
    x, d = x0, r / theta
    for j in range(niters // K):
        x, r, d = exchK((x, r, d))
        for k in range(j * K, (j + 1) * K):
            x, r, d = one(x, r, d, k)
    return x


def make_helmholtz_matvec(spec, e, w, n, s, diag, exchange: bool = True):
    """Per-block ``x -> (I + lam*L) x`` over the coefficient blocks: one
    depth-1 exchange + 5-point stencil.  Identity on inactive cells (all
    faces 0, diag 1).  ``exchange=False`` omits the halo refresh for
    callers that manage deep halos themselves (each application then
    consumes one valid halo ring)."""
    exch = _exchange_fn(spec, 1) if exchange else (lambda x: x)

    def matvec(x):
        x = exch(x)
        return (diag * x - e * st.xp(x) - w * st.xm(x)
                - n * st.yp(x) - s * st.ym(x))
    return matvec


def cheb_prepare(code, lam_x: float, lam_y: float, dtype):
    """The fused sweep's coefficients from its 4-bit face code (bits e,
    w, n, s): ``(e, w, n, s, diag)`` as the kernel decodes them."""
    be, bw, bn, bs = st.unpack_mask_bits(code, 4, dtype)
    e = lam_x * be
    w = lam_x * bw
    n = lam_y * bn
    s = lam_y * bs
    return e, w, n, s, 1.0 + e + w + n + s


def cheb_step(x, r, d, e, w, n, s, diag, c1: float, c2: float):
    """One Chebyshev iteration, the fused sweep's sub-step (plain
    PyTorch, in the kernel's grouping)."""
    x = x + d
    r = r - (diag * d - e * st.xp(d) - w * st.xm(d)
             - n * st.yp(d) - s * st.ym(d))
    d = c1 * d + c2 * r
    return x, r, d


def cheb_sweep_constants(lam_x: float, lam_y: float, sc) -> list[float]:
    """The kernel's constants for one sweep: ``lam_x, lam_y`` and the
    sweep's (c1, c2) rows, zero-padded to RING sub-steps."""
    c = np.zeros((2, RING))
    c[:, :len(sc)] = np.asarray(sc, dtype=np.float64).T
    return [float(lam_x), float(lam_y), *c[0].tolist(), *c[1].tolist()]


class HelmholtzSolver:
    """``(I + lam*L) x = b`` on a grid's wet T points.

    ``lam_x/lam_y`` are the nondimensional face couplings (a
    semi-implicit free-surface step uses ``g*H*(theta*dt)**2/dx**2``).
    Decomposition invariance (1 tile == N tiles) holds to
    reduction-order roundoff."""

    def __init__(self, grid, lam_x, lam_y, *, tol: float | None = None,
                 maxiter: int | None = None, precondition: bool = True,
                 method: str = "cg", steps_per_exchange: int = 1,
                 fused: bool = False):
        """``method="chebyshev"`` selects the communication-avoiding
        iteration: no inner products (the analytic eigenvalue bounds
        ``[1, 1+4(lam_x+lam_y)]``) and a static iteration count from the
        Chebyshev error bound.  ``steps_per_exchange=K`` (chebyshev
        only) runs K matvecs per depth-K halo exchange, needing
        ``halo_width >= K``; the coefficients are halo-exchanged at
        build time so halo cells compute exactly like their interior
        twins.

        ``fused=True`` (chebyshev only, scalar couplings, K <= 8; the
        JAX package's ``pallas=True``) runs K iterations per pass over
        memory: the face activities packed into one int8 code decoded
        per tile, the recurrence scalars passed per sweep."""
        if grid.halo_spec is None or grid.tmask is None:
            raise ValueError("grid must be initialised (grid_init) "
                             "before building a solver")
        if method not in ("cg", "chebyshev"):
            raise ValueError(f"method must be 'cg' or 'chebyshev', "
                             f"got {method!r}")
        self.grid = grid
        self.method = method
        self.tol = float(tol if tol is not None else default_tol(grid.dtype))
        d = grid.decomp
        self.steps_per_exchange = K = int(steps_per_exchange)
        if K < 1:
            raise ValueError("steps_per_exchange must be >= 1")
        if K > 1:
            if method != "chebyshev":
                raise ValueError(
                    "steps_per_exchange needs method='chebyshev' (CG has a "
                    "dot product between matvecs; there is nothing to "
                    "avoid)")
            if d.halo < K:
                raise ValueError(
                    f"steps_per_exchange={K} needs halo_width >= {K}, grid "
                    f"has {d.halo} (decompose(halo_width=...))")
        self.fused = bool(fused)
        scalar_lam = np.ndim(lam_x) == 0 and np.ndim(lam_y) == 0
        if self.fused:
            if method != "chebyshev":
                raise ValueError(
                    "fused=True needs method='chebyshev': CG's dot products "
                    "force a kernel boundary every iteration, Chebyshev's "
                    "recurrence scalars are data-independent")
            if K > RING:
                raise ValueError(
                    f"the fused Chebyshev sweep takes steps_per_exchange "
                    f"1..{RING}, got {K}")
            if not scalar_lam:
                raise NotImplementedError(
                    "the fused Chebyshev sweep scales its int8 face bits by "
                    "SCALAR lam; per-face arrays run the plain path")
        self._user_maxiter = maxiter is not None
        self.maxiter = int(maxiter if maxiter is not None
                           else 4 * (d.global_nx + d.global_ny))
        self._lam = (float(lam_x), float(lam_y)) if scalar_lam else None
        lam_max = float(np.max(lam_x)) + float(np.max(lam_y))
        self._lam_bounds = (1.0, 1.0 + 4.0 * lam_max)
        coeffs = helmholtz_coefficients(grid, lam_x, lam_y)
        if K > 1 or self.fused:
            # halo cells must carry their interior twin's coefficients so
            # redundant halo compute reproduces the twin exactly
            coeffs = tuple(halo_mod.exchange(c, grid.halo_spec, depth=d.halo)
                           for c in coeffs)
        self._coeffs = tuple(coeffs)
        if self.fused:
            # face-activity bits from the halo-exchanged coefficients:
            # one byte per point of sweep traffic
            self._codes = st.pack_mask_bits(
                [c != 0 for c in coeffs[:4]]).contiguous()
        self._inv_diag = 1.0 / coeffs[4] if precondition else None
        self._weight = grid.region_mask(dtype=grid.dtype)
        self._sweep_cache = {}

    # ------------------------------------------------------------------
    def niters(self) -> int:
        """The Chebyshev iteration count: to the static error bound,
        rounded up to a multiple of K; an explicit ``maxiter`` is a hard
        cap, rounded down to a K multiple (at least one sweep).  The
        CG-sized default maxiter is not a cap for a fixed-count
        iteration."""
        lmin, lmax = self._lam_bounds
        K = self.steps_per_exchange
        n = chebyshev_iterations(lmin, lmax, self.tol)
        n = -(-n // K) * K
        if self._user_maxiter:
            n = min(n, max(K, (self.maxiter // K) * K))
        return n

    def _residual(self, b, x, mv1):
        """Relative residual ``|b - A x| / |b|`` over internal cells, in
        the accumulation dtype (``mv1`` refreshes x's halo itself)."""
        r = b - mv1(x)
        acc = kinds.sum_dtype(b.dtype)
        w = self._weight.to(acc)
        rr = (r.to(acc) ** 2 * w).sum()
        bb = (b.to(acc) ** 2 * w).sum()
        rr, bb = all_reduce(torch.stack((rr, bb))).unbind()
        return torch.sqrt(rr / torch.clamp(bb, min=_tiny(acc)))

    def _make_cheb_sweep(self, K: int):
        """``sweep(x, r, d, sc) -> (x, r, d)``: K Chebyshev iterations as
        one pass, ``sc`` the block's ``(K, 2)`` recurrence scalars.  A
        CUDA grid launches ``csrc/helmholtz_cheb_sweep.cu``; a CPU grid
        runs its plain version, :func:`cheb_step` K times on the whole
        block."""
        if K not in self._sweep_cache:
            lam_x, lam_y = self._lam
            codes = self._codes
            prep = cheb_prepare(codes, lam_x, lam_y, self.grid.dtype)

            def sweep(x, r, d, sc):
                if x.device.type == "cpu":
                    return stencil_sweep_reference(
                        cheb_step, K, (x, r, d), prep,
                        scalars=[(float(a), float(b)) for a, b in sc])
                return helmholtz_cheb_sweep(
                    (x, r, d), (), codes, K=K,
                    consts=cheb_sweep_constants(lam_x, lam_y, sc))
            self._sweep_cache[K] = sweep
        return self._sweep_cache[K]

    def _solve_block(self, b, x0):
        """``(x, iterations, rel_res)`` for stacked blocks ``b``, ``x0``;
        ``x``'s halo is freshly exchanged."""
        spec = self.grid.halo_spec
        exch = _exchange_fn(spec, 1)
        mv1 = make_helmholtz_matvec(spec, *self._coeffs)
        if self.method == "cg":
            x, k, rel = pcg_block(mv1, b, x0, self._weight, tol=self.tol,
                                  maxiter=self.maxiter,
                                  inv_diag=self._inv_diag)
            return exch(x), k, rel
        lmin, lmax = self._lam_bounds
        K = self.steps_per_exchange
        niters = self.niters()
        if self.fused:
            theta = _cheb_params(lmin, lmax)[0]
            sc = chebyshev_scalars(lmin, lmax, niters).reshape(
                niters // K, K, 2)
            exchK = exchange_multi_fn(spec, depth=K)
            sweepK = self._make_cheb_sweep(K)
            r = b - mv1(x0)
            state = (x0, r, r / theta)
            for j in range(niters // K):
                state = sweepK(*exchK(state), sc[j])
            x = state[0]
        elif K == 1:
            x = chebyshev_block(b, x0, matvec=mv1, lam_min=lmin,
                                lam_max=lmax, niters=niters)
        else:
            mv = make_helmholtz_matvec(spec, *self._coeffs, exchange=False)
            x = chebyshev_block(
                b, x0, matvec=mv, lam_min=lmin, lam_max=lmax, niters=niters,
                exchange_every=(K, exchange_multi_fn(spec,
                                                     depth=spec.halo)))
        # one verified residual at the end (the iteration is dot-free)
        return exch(x), niters, self._residual(b, x, mv1)

    def _as_block(self, a) -> torch.Tensor:
        """A T-point Field's data, or a stacked array, on the grid's
        device in the grid's dtype."""
        from ..core.field import Field
        data = a.data if isinstance(a, Field) else torch.as_tensor(a)
        return data.to(device=self.grid.device, dtype=self.grid.dtype)

    def solve(self, b, x0=None):
        """Solve for the stacked rhs ``b`` (a T-point Field, its
        ``.data`` or a stacked array).  Returns ``(x, info)`` with ``x`` a
        stacked tensor (halos freshly exchanged) and ``info`` =
        ``{"iterations", "rel_res", "converged"}``."""
        bdat = self._as_block(b)
        x0dat = (self._as_block(x0) if x0 is not None
                 else torch.zeros_like(bdat))
        x, k, rel = self._solve_block(bdat, x0dat)
        rel = float(rel)
        return x, {"iterations": int(k), "rel_res": rel,
                   "converged": rel <= self.tol}

    def _residual64(self, b64, x64):
        """``b64 - A x64`` in float64 (exchange + stencil upcast), for
        iterative refinement."""
        mv = make_helmholtz_matvec(self.grid.halo_spec,
                                   *(c.to(torch.float64)
                                     for c in self._coeffs))
        return b64 - mv(x64)

    def solve_refined(self, b, refine: int = 2):
        """float64-accurate solve at float32 speed: iterative
        refinement.  Each round solves the correction system in the
        grid's float32 working precision and evaluates the residual in
        float64, so only one matvec per round pays for float64.  Returns
        ``(x64, info)`` with ``info["refined_rel_res"]`` the final f64
        residual norm."""
        if self.grid.dtype != torch.float32:
            raise ValueError(
                "solve_refined refines a 4-byte (float32) working "
                "precision; a float64 grid solves in f64 directly")
        from ..core.field import Field
        raw = b.data if isinstance(b, Field) else torch.as_tensor(b)
        raw = raw.to(self.grid.device)
        b64 = raw.to(torch.float64)
        w64 = self._weight.to(torch.float64)
        bb = float(all_reduce(((b64 * w64) ** 2).sum())) or 1.0

        # the first solve runs at working precision even for an f64 rhs
        x, info = self.solve(raw.to(self.grid.dtype))
        x64 = x.to(torch.float64)
        total, converged = info["iterations"], info["converged"]
        for _ in range(max(refine, 0)):
            r64 = self._residual64(b64, x64)
            dx, dinfo = self.solve(r64.to(self.grid.dtype))
            total += dinfo["iterations"]
            converged = converged and dinfo["converged"]
            x64 = x64 + dx.to(torch.float64)
        r64 = self._residual64(b64, x64)
        rel = float(torch.sqrt(all_reduce(((r64 * w64) ** 2).sum()) / bb))
        return x64, {"iterations": total, "refined_rel_res": rel,
                     "working_rel_res": info["rel_res"],
                     "converged": converged}
