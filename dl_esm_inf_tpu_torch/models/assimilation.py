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
optax's update rule, and :class:`LBFGS`, ``torch.optim.LBFGS``'s update
rule with a strong-Wolfe line search.

Across ranks each rank runs its block of the trajectory, and autograd
crosses the exchange between ranks (:mod:`..parallel.halo`'s strip
transfer); the cost is the :func:`..parallel.collectives.psum` of every
rank's misfit, whose cotangent passes through, so every rank starts the
same backward pass.  The hybrid control's ensemble weights are held
alike by every rank and scale each rank's anomalies: their gradient is
summed over the ranks once (:func:`..parallel.collectives.pbroadcast`).
The optimisers' reductions (L-BFGS's dot products and norms, the
largest gradient component) are all-reduced, so every rank takes the
same steps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import kinds, layout
from ..ops import stencils as st
from ..parallel import environment as env
from ..parallel.collectives import (all_reduce, gather_to_host, global_max,
                                    pbroadcast, psum)
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
    ``penalty`` is this rank's share of the preconditioned background
    term ``||w||^2 + ||a||^2`` (``||w||^2`` of its block; ``||a||^2`` on
    rank 0 only, as ``a`` is held alike by every rank), to be summed over
    the ranks with the cost, and ``zero_control()`` builds the rest
    start.  The ensemble states are constants (the EnVar
    linearisation)."""
    beta_s, beta_e = float(beta[0]), float(beta[1])
    sm = control_smoother(model, smooth_scale)
    eo = ensemble.states[0]
    em = eo.mean(dim=0)
    norm = 1.0 / np.sqrt(max(ensemble.n_members - 1, 1))
    anoms = (eo - em[None]) * norm

    own = 1.0 if env.on_master() else 0.0

    def transform(x):
        inc = beta_e * torch.einsum("k,kyx->yx", pbroadcast(x["a"]), anoms)
        return beta_s * sm(x["w"]) + inc

    def penalty(x):
        a2 = (pbroadcast(x["a"]) ** 2).sum().to(x["w"].dtype)
        # the same operations on every rank: the ranks' backward passes
        # must run their collectives in the same order
        return (x["w"] ** 2).sum() + a2 * own

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
    given, else ``||w||^2_w``.

    Across ranks ``x`` is this rank's block; the cost is summed over
    every rank's (:func:`..parallel.collectives.psum`), ``pack`` keeps
    this rank's block of the global field and ``unpack`` gathers (both
    collective)."""
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
        return grid.block_tensor(layout.stack_global(
            d, np.asarray(g), mode="zeros", dtype=npdt))

    w = grid.block_tensor(layout.internal_mask(d).astype(npdt)) * t_mask
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
        return psum(c)

    def pack(x0_global):
        return stacked(x0_global)

    def unpack(x_stacked):
        with torch.no_grad():
            if control_transform is not None:
                x_stacked = control_transform(x_stacked)
            return layout.unstack_internal(
                d, gather_to_host(x_stacked, grid.halo_spec))

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


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """The minimiser of the cubic through two points with their values
    and slopes, clipped to ``bounds`` (``torch.optim.lbfgs``'s, as it
    computes it)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square.sqrt()
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


class LBFGS:
    """L-BFGS with ``torch.optim.LBFGS``'s update rule at the settings
    ``assimilate`` uses: one quasi-Newton iteration a step, history
    ``history_size``, its strong-Wolfe line search (bracketing, cubic
    zoom, at most ``max_eval - 1`` evaluations), no tolerance stops.  The
    operations are PyTorch's, in its order, so on one rank its iterates
    are ``torch.optim.LBFGS``'s bitwise.

    Its dot products, the largest and the summed |component| are over
    the whole control: across ranks the partial results of the leaves
    that are rank blocks are all-reduced and those of the leaves every
    rank holds alike (``replicated``) added once, so every rank takes the
    same direction and the same step.  ``evaluate(leaves) -> (loss,
    grads)`` is collective: every rank calls it the same number of
    times."""

    def __init__(self, leaves, replicated=None, history_size: int = 10,
                 max_eval: int = 26):
        self.leaves = list(leaves)
        self.history_size = int(history_size)
        self.max_eval = int(max_eval)
        rep = ([False] * len(self.leaves) if replicated is None
               else list(replicated))
        sizes = [t.numel() for t in self.leaves]
        flags = torch.cat([torch.full((n,), r, dtype=torch.bool)
                           for n, r in zip(sizes, rep)])
        dev = self.leaves[0].device
        self._split = (None if env.get_num_ranks() == 1
                       else (flags.logical_not().to(dev), flags.to(dev)))
        self._any_replicated = any(rep)
        self.n_iter = 0
        self.d = self.t = self.H_diag = None
        self.old_dirs, self.old_stps, self.ro = [], [], []
        self.al = [None] * self.history_size
        self.prev_flat_grad = None

    # -- reductions over the whole control ------------------------------
    def _over(self, f, op, *us):
        """``f`` of flat control vectors ``us`` over the whole control:
        across ranks, ``f`` of the rank blocks all-reduced by ``op``,
        combined once with ``f`` of the replicated leaves."""
        if self._split is None:
            return f(*us)
        loc, rep = self._split
        out = all_reduce(f(*(u[loc] for u in us)), op)
        if self._any_replicated:
            r = f(*(u[rep] for u in us))
            out = (out + r if op == dist.ReduceOp.SUM
                   else torch.maximum(out, r))
        return out

    def _dot(self, u, v):
        return self._over(torch.dot, dist.ReduceOp.SUM, u, v)

    def _amax(self, u):
        return self._over(lambda a: a.abs().max(), dist.ReduceOp.MAX, u)

    def _asum(self, u):
        return self._over(lambda a: a.abs().sum(), dist.ReduceOp.SUM, u)

    # -- torch.optim.LBFGS's parameter handling ---------------------------
    @staticmethod
    def _flat(grads):
        return torch.cat([g.reshape(-1) for g in grads], 0)

    def _add_grad(self, step_size, update) -> None:
        offset = 0
        for p in self.leaves:
            numel = p.numel()
            p.add_(update[offset:offset + numel].view_as(p), alpha=step_size)
            offset += numel

    def _directional_evaluate(self, evaluate, x, t, d):
        self._add_grad(t, d)
        with torch.enable_grad():
            loss, grads = evaluate(self.leaves)
        flat_grad = self._flat(grads)
        for p, pdata in zip(self.leaves, x):
            p.copy_(pdata)
        return float(loss), flat_grad

    def _strong_wolfe(self, evaluate, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                      tolerance_change=1e-9, max_ls=25):
        """``torch.optim.lbfgs._strong_wolfe`` with the dot products and
        the norm over the whole control."""
        d_norm = self._amax(d)
        g = g.clone(memory_format=torch.contiguous_format)
        f_new, g_new = self._directional_evaluate(evaluate, x, t, d)
        ls_func_evals = 1
        gtd_new = self._dot(g_new, d)
        t_prev, f_prev, g_prev, gtd_prev = 0, f, g, gtd
        done = False
        ls_iter = 0
        while ls_iter < max_ls:
            if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
                bracket = [t_prev, t]
                bracket_f = [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone(
                    memory_format=torch.contiguous_format)]
                bracket_gtd = [gtd_prev, gtd_new]
                break
            if abs(gtd_new) <= -c2 * gtd:
                bracket, bracket_f, bracket_g = [t], [f_new], [g_new]
                done = True
                break
            if gtd_new >= 0:
                bracket = [t_prev, t]
                bracket_f = [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone(
                    memory_format=torch.contiguous_format)]
                bracket_gtd = [gtd_prev, gtd_new]
                break
            min_step = t + 0.01 * (t - t_prev)
            max_step = t * 10
            tmp = t
            t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new,
                                   gtd_new, bounds=(min_step, max_step))
            t_prev = tmp
            f_prev = f_new
            g_prev = g_new.clone(memory_format=torch.contiguous_format)
            gtd_prev = gtd_new
            f_new, g_new = self._directional_evaluate(evaluate, x, t, d)
            ls_func_evals += 1
            gtd_new = self._dot(g_new, d)
            ls_iter += 1
        if ls_iter == max_ls:
            bracket = [0, t]
            bracket_f = [f, f_new]
            bracket_g = [g, g_new]
        insuf_progress = False
        low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
        while not done and ls_iter < max_ls:
            if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
                break
            t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                                   bracket[1], bracket_f[1], bracket_gtd[1])
            eps = 0.1 * (max(bracket) - min(bracket))
            if min(max(bracket) - t, t - min(bracket)) < eps:
                if insuf_progress or t >= max(bracket) or t <= min(bracket):
                    if abs(t - max(bracket)) < abs(t - min(bracket)):
                        t = max(bracket) - eps
                    else:
                        t = min(bracket) + eps
                    insuf_progress = False
                else:
                    insuf_progress = True
            else:
                insuf_progress = False
            f_new, g_new = self._directional_evaluate(evaluate, x, t, d)
            ls_func_evals += 1
            gtd_new = self._dot(g_new, d)
            ls_iter += 1
            if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
                bracket[high_pos] = t
                bracket_f[high_pos] = f_new
                bracket_g[high_pos] = g_new.clone(
                    memory_format=torch.contiguous_format)
                bracket_gtd[high_pos] = gtd_new
                low_pos, high_pos = ((0, 1) if bracket_f[0] <= bracket_f[1]
                                     else (1, 0))
            else:
                if abs(gtd_new) <= -c2 * gtd:
                    done = True
                elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                    bracket[high_pos] = bracket[low_pos]
                    bracket_f[high_pos] = bracket_f[low_pos]
                    bracket_g[high_pos] = bracket_g[low_pos]
                    bracket_gtd[high_pos] = bracket_gtd[low_pos]
                bracket[low_pos] = t
                bracket_f[low_pos] = f_new
                bracket_g[low_pos] = g_new.clone(
                    memory_format=torch.contiguous_format)
                bracket_gtd[low_pos] = gtd_new
        return bracket_f[low_pos], bracket_g[low_pos], bracket[low_pos]

    @torch.no_grad()
    def step(self, evaluate):
        """One L-BFGS iteration from the current leaves (updated in
        place).  Returns ``(loss, grads)`` at the iterate it started
        from."""
        with torch.enable_grad():
            loss0, grads0 = evaluate(self.leaves)
        loss = float(loss0)
        flat_grad = self._flat(grads0)
        if self._amax(flat_grad) <= 0.0:
            return loss0, grads0
        self.n_iter += 1
        if self.n_iter == 1:
            d = flat_grad.neg()
            self.old_dirs, self.old_stps, self.ro = [], [], []
            self.H_diag = 1
        else:
            y = flat_grad.sub(self.prev_flat_grad)
            s = self.d.mul(self.t)
            ys = self._dot(y, s)
            if ys > 1e-10:
                if len(self.old_dirs) == self.history_size:
                    self.old_dirs.pop(0)
                    self.old_stps.pop(0)
                    self.ro.pop(0)
                self.old_dirs.append(y)
                self.old_stps.append(s)
                self.ro.append(1.0 / ys)
                self.H_diag = ys / self._dot(y, y)
            num_old = len(self.old_dirs)
            al = self.al
            q = flat_grad.neg()
            for i in range(num_old - 1, -1, -1):
                al[i] = self._dot(self.old_stps[i], q) * self.ro[i]
                q.add_(self.old_dirs[i], alpha=-al[i])
            d = r = torch.mul(q, self.H_diag)
            for i in range(num_old):
                be_i = self._dot(self.old_dirs[i], r) * self.ro[i]
                r.add_(self.old_stps[i], alpha=al[i] - be_i)
        if self.prev_flat_grad is None:
            self.prev_flat_grad = flat_grad.clone(
                memory_format=torch.contiguous_format)
        else:
            self.prev_flat_grad.copy_(flat_grad)
        t = (min(1.0, 1.0 / self._asum(flat_grad)) if self.n_iter == 1
             else 1.0)
        gtd = self._dot(flat_grad, d)
        if gtd > 0.0:
            # torch breaks before the line search, keeping this d and t
            self.d, self.t = d, t
            return loss0, grads0
        x_init = [p.clone(memory_format=torch.contiguous_format)
                  for p in self.leaves]
        _loss, _flat_grad, t = self._strong_wolfe(
            evaluate, x_init, t, d, loss, flat_grad, gtd,
            max_ls=self.max_eval - 1)
        self._add_grad(t, d)
        self.d, self.t = d, t
        return loss0, grads0


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
    applies) or ``"lbfgs"``: :class:`LBFGS` (``torch.optim.LBFGS``'s
    rule, history 10, as optax's ``lbfgs``) with PyTorch's strong-Wolfe
    line search, one quasi-Newton iteration per iteration here
    (``learning_rate`` is ignored).  That line search is not optax's zoom line search, so the
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
    gradient component at the last iterate taken.  Collective across
    ranks: every rank gets the same result."""
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
    # the hybrid control's ensemble weights are held alike by every rank
    replicated = ([k == "a" for k in sorted(x)] if isinstance(x, dict)
                  else [False])

    def value_and_grad(leaves):
        c = cost(_rebuild(x, leaves))
        grads = torch.autograd.grad(c, leaves)
        return c.detach(), grads

    def largest(grads):
        return max(global_max(g.abs()) for g in grads)

    history = []
    gmax = float("nan")
    if optimizer == "adam":
        opt = Adam(leaves, learning_rate)
        for _ in range(iters):
            c, grads = value_and_grad(leaves)
            history.append(float(c))
            gmax = largest(grads)
            leaves = [t.requires_grad_(True)
                      for t in opt.step(leaves, grads)]
    else:
        # one quasi-Newton iteration a step: one evaluation at the
        # iterate, up to 25 in the line search
        opt = LBFGS(leaves, replicated, history_size=10, max_eval=26)
        for _ in range(iters):
            c, grads = opt.step(value_and_grad)
            history.append(float(c))
            gmax = largest(grads)
    xf = _rebuild(x, [t.detach() for t in leaves])
    out = {"eta0": unpack(xf), "cost_history": history,
           "grad_norm": gmax}
    if ensemble is not None:
        out["ensemble_weights"] = xf["a"].cpu().numpy()
    return out
