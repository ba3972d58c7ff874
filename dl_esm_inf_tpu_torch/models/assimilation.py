"""Variational data assimilation (4D-Var) by autograd through the models.

Counterpart of ``dl_esm_inf_tpu/models/assimilation.py``.  The time step
is plain PyTorch, so the adjoint model is one reverse-mode pass through
the trajectory: through the halo exchange's slices and rolls, the
models' masked stencils and, for the semi-implicit model, the implicit
solve's adjoint (:func:`..ops.solvers.pcg_solve`).  The CUDA kernels
have no backward, so every path here is the plain one, as the JAX
package's is (``pallas_call`` has no VJP).  ``remat_chunk`` bounds the
adjoint's memory (:mod:`..ops.adjoint`).

Usage::

    m = gravity_wave.build(64, 64, dt=0.05)
    obs = {10: eta_at_10, 20: eta_at_20}        # global (gny, gnx)
    result = assimilate(m, obs, iters=200)
    result["eta0"]                              # recovered initial eta

The optimisers are the port's own (it does not import optax): Adam with
optax's update rule, and ``torch.optim.LBFGS`` with a strong-Wolfe line
search.  Across ranks this raises (ROADMAP M8: the adjoint of the
exchange between ranks).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..ops import stencils as st
from ..parallel import environment as env
from ..parallel.halo import exchange_multi_fn


def _trajectory_runner(model):
    """``(runner, wet_t_mask, make_state)`` for a supported model: the
    runner is a ``(prog, state, base_step) -> state`` closure over the
    model's own operands (``base_step`` is the global index of the
    segment's first step, for time-dependent forcing) and
    ``make_state(x0)`` builds the rest-start state tuple from the
    optimisation variable; raises for configurations without a
    differentiable path."""
    from .gravity_wave import GravityWaveModel
    from .nemolite2d import NemoLite2D
    from .semi_implicit import SemiImplicitModel
    from .shallow import ShallowModel
    from .tracer import CoupledTracer, TracerModel
    from .twolayer import TwoLayerModel

    def rest3(x0):
        return (x0, torch.zeros_like(x0), torch.zeros_like(x0))

    def plain_only(m, what):
        if m.use_fused or m._sweep_K > 1:
            raise ValueError(
                "4D-Var needs the plain differentiable path: build "
                f"{what} without fused/steps_per_sweep (the kernels have "
                "no backward)")

    if isinstance(model, CoupledTracer):
        # source inversion THROUGH the evolving flow: the flow's current
        # state is a constant; the control is the initial tracer (state
        # index 3: pass obs_state_index=3)
        fs = model.flagship
        if fs._ht is not None:
            raise ValueError("coupled-tracer 4D-Var supports flat "
                             "bathymetry")
        flow0 = (fs.sshn_t.data, fs.un.data, fs.vn.data)
        off = int(fs._istep0)            # forcing continuity with the flow
        return ((lambda prog, st_, base: prog(base + off, st_)),
                model._t_upd, lambda x0: flow0 + (x0,))
    if isinstance(model, TracerModel):
        plain_only(model, "the tracer model")
        return ((lambda prog, st_, base: prog(st_)), model._t_upd,
                lambda x0: (x0,))
    if isinstance(model, GravityWaveModel):
        plain_only(model, "the model")
        return ((lambda prog, st_, base: prog(st_)), model._t_upd, rest3)
    if isinstance(model, ShallowModel):
        plain_only(model, "the model")
        ones = torch.ones_like(model.eta.data)        # all-wet periodic
        return ((lambda prog, st_, base: prog(st_)), ones, rest3)
    if isinstance(model, TwoLayerModel):
        plain_only(model, "the model")

        def rest6(x0):
            z = torch.zeros_like(x0)
            return (x0, z, z, z, z, z)        # observe the TOP interface

        return ((lambda prog, st_, base: prog(st_)), model._t_upd, rest6)
    if isinstance(model, SemiImplicitModel):
        if not model.differentiable:
            raise ValueError(
                "build the semi-implicit model with differentiable=True: "
                "the raw CG loop would be recorded iteration by iteration; "
                "pcg_solve differentiates implicitly")
        return ((lambda prog, st_, base: prog(base, *st_)[:3]),
                model._t_upd, rest3)
    if isinstance(model, NemoLite2D):
        # the NONLINEAR flagship: autograd flows through the upwind flux
        # selections (a.e.-valid subgradients)
        if model.use_fused:
            raise ValueError(
                "4D-Var needs the plain differentiable path: build the "
                "flagship without fused=True")
        if model._ht is not None:
            raise ValueError("flagship 4D-Var supports flat bathymetry")
        return ((lambda prog, st_, base: prog(base, tuple(st_),
                                              model._mask_codes)),
                model._t_wet, rest3)
    raise TypeError("assimilation drives the GravityWaveModel, "
                    "ShallowModel, TwoLayerModel, SemiImplicitModel, "
                    "NemoLite2D, TracerModel or CoupledTracer interface, "
                    f"got {type(model).__name__}")


def control_smoother(model, scale: float = 2.0):
    """Diffusion-operator square-root-B (Weaver & Courtier 2001): a
    differentiable map ``w -> x`` applying ``n`` explicit masked-diffusion
    steps, so that a unit impulse in the control variable becomes a
    quasi-Gaussian of std ~``scale`` grid cells in the state.  Land is
    respected through the masked-gradient Laplacian the tracer model
    uses (no smoothing across coastlines)."""
    grid = model.grid
    alpha = 0.25                       # 2D explicit stability limit
    n = max(1, int(np.ceil(scale * scale / (2 * alpha))))
    ones = torch.ones(grid.array_shape, dtype=grid.dtype, device=grid.device)
    uw = getattr(model, "_u_wet", None)
    vw = getattr(model, "_v_wet", None)
    tu = getattr(model, "_t_upd", None)
    uw = ones if uw is None else uw
    vw = ones if vw is None else vw
    tu = ones if tu is None else tu
    exch = exchange_multi_fn(grid.halo_spec, depth=1)

    def smooth(w):
        for _ in range(n):
            (w,) = exch((w,))
            gx = (st.xp(w) - w) * uw       # cell units (dx = dy = 1)
            gy = (st.yp(w) - w) * vw
            lap = (gx - st.xm(gx)) + (gy - st.ym(gy))
            w = torch.where(tu > 0, w + alpha * lap, w)
        return w
    return smooth


def hybrid_controls(model, ensemble, *, smooth_scale: float = 2.0,
                    beta=(1.0, 1.0)):
    """Hybrid 4D-EnVar control variables: the initial-state increment is

        x0 = beta_s * B^(1/2) w  +  beta_e * X' a / sqrt(M-1)

    a smooth static part (:func:`control_smoother`) plus a
    flow-dependent part spanned by the anomalies ``X'`` of the observed
    field in ``ensemble`` (a :class:`.ensemble.Ensemble`).  Returns
    ``(transform, penalty, zero_control)``: ``transform`` maps the
    ``{"w": block, "a": (M,)}`` control to the stacked initial state,
    ``penalty`` is the preconditioned background term
    ``||w||^2 + ||a||^2`` and ``zero_control()`` builds the rest start.
    The ensemble states are constants (the EnVar linearisation)."""
    beta_s, beta_e = float(beta[0]), float(beta[1])
    sm = control_smoother(model, smooth_scale)
    eo = ensemble.states[0]
    em = eo.mean(dim=0)
    norm = 1.0 / np.sqrt(max(ensemble.n_members - 1, 1))
    anoms = (eo - em[None]) * norm

    def transform(x):
        inc = beta_e * torch.einsum("k,kyx->yx", x["a"], anoms)
        return beta_s * sm(x["w"]) + inc

    def penalty(x):
        return (x["w"] ** 2).sum() + (x["a"] ** 2).sum().to(x["w"].dtype)

    def zero_control():
        w = torch.zeros_like(em)
        return {"w": w, "a": torch.zeros((ensemble.n_members,),
                                         dtype=w.dtype, device=w.device)}

    return transform, penalty, zero_control


def make_cost_fn(model, observations: dict, obs_weight=None,
                 background=None, background_weight: float = 0.0,
                 remat_chunk: int | None = None,
                 control_transform=None, control_penalty=None,
                 obs_state_index: int = 0):
    """Build ``cost(x) -> 0-d tensor``, the 4D-Var objective

    ``sum_t ||state_t - obs_t||^2_w  [+ b_w * ||x0 - background||^2_w]``

    over a trajectory started from rest at ``x0``.  ``observations`` maps
    step number (>= 1) to a global ``(gny, gnx)`` array; the misfit is
    taken on wet internal points only, times ``obs_weight`` (a global
    array) where given.  ``obs_state_index`` selects the observed state
    field (0 is the surface elevation in every runner; 2 is v for
    drifter-style observations; 3 the coupled tracer).  Returns
    ``(cost_fn, pack, unpack)``: ``pack`` lifts a global initial field
    into the stacked optimisation variable, ``unpack`` is its inverse
    (always the physical state).

    ``remat_chunk`` checkpoints each segment's time loop (O(n/c + c)
    state copies per n-step segment instead of O(n) intermediate sets,
    one extra forward pass; gradients unchanged).

    ``control_transform`` (e.g. :func:`control_smoother`) makes the
    variable a control vector ``w`` with ``x0 = transform(w)``.  The
    background term is then ``control_penalty(x)`` where given (the
    preconditioned form, hybrid EnVar), else the state-space misfit
    ``||transform(x) - background||^2_w`` where a ``background`` is
    given, else ``||w||^2_w``."""
    env.require_one_rank("4D-Var (the adjoint)", "M8")
    run_seg, t_mask, make_state = _trajectory_runner(model)
    if not observations:
        raise ValueError("observations must map step -> global array")
    steps = sorted(observations)
    if steps[0] < 1:
        raise ValueError("observation steps must be >= 1")
    grid = model.grid
    d = grid.decomp
    npdt = kinds.np_dtype(grid.dtype)

    def stacked(g):
        return torch.from_numpy(layout.stack_global(
            d, np.asarray(g), mode="zeros", dtype=npdt)).to(grid.device)

    w = torch.from_numpy(layout.internal_mask(d).astype(npdt)).to(
        grid.device) * t_mask
    if obs_weight is not None:
        w = w * stacked(obs_weight)
    obs_stacked = {t: stacked(o) for t, o in observations.items()}
    # one program per distinct segment length
    segs = [steps[0]] + [b - a for a, b in zip(steps, steps[1:])]
    progs = {n: model.step_program(n, remat_chunk=remat_chunk)
             for n in set(segs)}
    bg = stacked(background) if background is not None else None

    def cost(x):
        if control_transform is not None:
            eta0 = control_transform(x)
            if not background_weight:
                reg = torch.zeros((), dtype=w.dtype, device=w.device)
            elif control_penalty is not None:
                # preconditioned J_b: regularise the control itself
                reg = background_weight * control_penalty(x)
            elif bg is not None:
                # a PHYSICAL background compares in state space
                reg = background_weight * ((eta0 - bg) ** 2 * w).sum()
            else:
                reg = background_weight * (x ** 2 * w).sum()
        else:
            eta0 = x
            reg = (background_weight * ((eta0 - bg) ** 2 * w).sum()
                   if bg is not None
                   else torch.zeros((), dtype=w.dtype, device=w.device))
        state = make_state(eta0)
        c = reg
        base = 0
        for n, t in zip(segs, steps):
            state = run_seg(progs[n], state, base)
            base = t
            c = c + ((state[obs_state_index] - obs_stacked[t]) ** 2
                     * w).sum()
        return c

    def pack(x0_global):
        return stacked(x0_global)

    def unpack(x_stacked):
        with torch.no_grad():
            if control_transform is not None:
                x_stacked = control_transform(x_stacked)
            return layout.unstack_internal(d, x_stacked).detach().cpu(
            ).numpy()

    return cost, pack, unpack


def _leaves(x):
    """The control's tensors, in a fixed order (a tensor, or the hybrid
    ``{"w", "a"}`` dict)."""
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]


def _rebuild(x, leaves):
    if isinstance(x, dict):
        return dict(zip(sorted(x), leaves))
    return leaves[0]


#: optax.adam's defaults, which ``assimilate`` uses
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam with optax's update rule (``optax.adam`` at its defaults,
    ``ADAM_B1``, ``ADAM_B2``, ``ADAM_EPS``), operation for operation in
    optax's order, so that its iterates follow the JAX package's:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t);  nu_hat = nu / (1 - b2^t)
        x = x + (-lr) * mu_hat / (sqrt(nu_hat) + eps)

    (``torch.optim.Adam`` folds the bias corrections into the step
    size, another rounding.)"""

    def __init__(self, leaves, lr: float):
        self.lr = float(lr)
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves, grads):
        b1, b2 = ADAM_B1, ADAM_B2
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        out = []
        for k, (x, g) in enumerate(zip(leaves, grads)):
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g ** 2) + b2 * self.nu[k]
            mu_hat = self.mu[k] / bc1
            nu_hat = self.nu[k] / bc2
            u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
            out.append(x + u * (-self.lr))
        return out


def assimilate(model, observations: dict, *, iters: int = 200,
               learning_rate: float = 0.2, first_guess=None,
               obs_weight=None, background=None,
               background_weight: float = 0.0,
               remat_chunk: int | None = None,
               optimizer: str = "adam",
               smooth_scale: float | None = None,
               ensemble=None, hybrid_beta=(1.0, 1.0),
               obs_state_index: int = 0) -> dict:
    """Twin-experiment-ready 4D-Var: recover the initial field that best
    explains ``observations`` under ``model``'s dynamics, by descent on
    the autograd gradient of the trajectory misfit.

    ``optimizer="adam"`` (default; :class:`Adam`, ``learning_rate``
    applies) or ``"lbfgs"``: ``torch.optim.LBFGS`` (history 10, as
    optax's ``lbfgs``) with PyTorch's strong-Wolfe line search, one
    quasi-Newton iteration per iteration here (``learning_rate`` is
    ignored).  That line search is not optax's zoom line search, so the
    iterates differ from the JAX package's; both drive these quadratic-
    dominated objectives to the same minimum.

    ``smooth_scale=L`` optimises a control vector through
    :func:`control_smoother` (increments smooth at scale ~L cells).
    ``ensemble=Ensemble(...)`` makes it hybrid 4D-EnVar
    (:func:`hybrid_controls`, weights ``hybrid_beta``);
    ``background_weight`` then scales ``||w||^2 + ||a||^2``.

    Returns ``{"eta0": global array, "cost_history": [...],
    "grad_norm": float}`` (``eta0`` is always the physical state; hybrid
    runs add ``"ensemble_weights"``).  ``grad_norm`` is the largest
    gradient component at the last iterate taken."""
    if optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"optimizer must be 'adam' or 'lbfgs', "
                         f"got {optimizer!r}")
    if ensemble is not None:
        if first_guess is not None:
            raise ValueError("hybrid 4D-EnVar starts from the zero "
                             "control; first_guess is not supported")
        transform, penalty, zero_control = hybrid_controls(
            model, ensemble,
            smooth_scale=2.0 if smooth_scale is None else smooth_scale,
            beta=hybrid_beta)
    else:
        transform = (control_smoother(model, smooth_scale)
                     if smooth_scale is not None else None)
        penalty = None
        if transform is not None and first_guess is not None:
            raise ValueError(
                "smooth_scale optimises a CONTROL vector; a physical "
                "first_guess cannot seed it (the transform is not "
                "inverted here): drop first_guess or smooth_scale")
    cost, pack, unpack = make_cost_fn(
        model, observations, obs_weight=obs_weight, background=background,
        background_weight=background_weight, remat_chunk=remat_chunk,
        control_transform=transform, control_penalty=penalty,
        obs_state_index=obs_state_index)
    d = model.grid.decomp
    if ensemble is not None:
        x = zero_control()
    else:
        x = pack(np.zeros((d.global_ny, d.global_nx))
                 if first_guess is None else first_guess)
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(x)]

    def value_and_grad():
        c = cost(_rebuild(x, leaves))
        grads = torch.autograd.grad(c, leaves)
        return c.detach(), grads

    history = []
    gmax = float("nan")
    if optimizer == "adam":
        opt = Adam(leaves, learning_rate)
        for _ in range(iters):
            c, grads = value_and_grad()
            history.append(float(c))
            gmax = max(float(g.abs().max()) for g in grads)
            leaves = [t.requires_grad_(True)
                      for t in opt.step(leaves, grads)]
    else:
        # one quasi-Newton iteration a step: one evaluation at the
        # iterate, up to 25 in the line search (max_eval bounds both;
        # its default, 5/4 of max_iter, would leave the search none)
        opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=26,
                                history_size=10, tolerance_grad=0.0,
                                tolerance_change=0.0,
                                line_search_fn="strong_wolfe")
        first = []

        def closure():
            opt.zero_grad()
            c = cost(_rebuild(x, leaves))
            c.backward()
            if not first:
                # a step evaluates the current iterate first; the line
                # search's evaluations follow
                first.append((float(c.detach()),
                              max(float(p.grad.abs().max())
                                  for p in leaves)))
            return c

        for _ in range(iters):
            first.clear()
            opt.step(closure)
            c, gmax = first[0]
            history.append(c)
    xf = _rebuild(x, [t.detach() for t in leaves])
    out = {"eta0": unpack(xf), "cost_history": history,
           "grad_norm": gmax}
    if ensemble is not None:
        out["ensemble_weights"] = xf["a"].cpu().numpy()
    return out
