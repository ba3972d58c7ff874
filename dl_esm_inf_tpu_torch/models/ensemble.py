"""Ensemble execution: M perturbed replicas of a model stepped together.

Counterpart of ``dl_esm_inf_tpu/models/ensemble.py``.  An ensemble is a
leading member axis on each state tensor: ``(M, ly, lx)`` blocks, or
``(M, L, ly, lx)`` for multi-level fields.  Every stencil and mask
operation of the models' plain steps broadcasts over it unchanged, and
the halo exchange carries leading axes (it groups strips by dtype and
leading shape, ``parallel/halo.py::_exchange_blocks``), so all members'
edge strips move in the same messages.  Each member runs the exact
operation sequence of the single run: members are bitwise equal to
running the base model M times.

Plain path only (the fused kernels are single-state), as in the JAX
package.  Across ranks each rank steps its block of every member (the
strips of all members cross the rank seams together); host arrays are
whole on every rank, as a field's are: loading scatters the whole
stacked layout to this rank's block, and the gathers are collective.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..parallel import environment as env
from ..parallel import halo as halo_mod
from ..parallel.collectives import gather_to_host
from ..parallel.halo import exchange_multi_fn


def _adapt(model):
    """``(names, state fields, step_fn, exch_depth, flagship)`` for a
    supported model.  ``step_fn(exch, state, istep, forcing) -> state``
    is the model's plain step on member-stacked blocks (``istep`` the
    global step index, ``forcing`` the tidal value of that step of
    ``flagship``, the NemoLite2D whose forcing the step reads, or None)
    and ``exch_depth`` the halo depth its exchange needs.  The models'
    steps read their own masks, which broadcast over the member axis."""
    from . import (gravity_wave, nemolite2d, nlayer, semi_implicit,
                   shallow, tracer, twolayer)
    if getattr(model, "use_fused", False):
        raise ValueError(
            "Ensemble wraps the plain path; build the base model without "
            "fused=True (the fused sweep kernels are single-state)")

    def plain(exch, st_, istep, forcing):
        return tuple(model._block_step(exch, *st_))

    if isinstance(model, gravity_wave.GravityWaveModel):
        return (("eta", "u", "v"), (model.eta, model.u, model.v), plain, 1,
                None)
    if isinstance(model, tracer.TracerModel):
        # steady velocities are member-shared, like masks
        return ("c",), (model.c,), plain, model.reach, None
    if isinstance(model, tracer.CoupledTracer):
        # online-coupled members: each advances its OWN flow and tracer
        fs = model.flagship
        if fs._ht is not None:
            raise ValueError("coupled-tracer ensembles support flat "
                             "bathymetry")

        def step_ct(exch, st_, istep, forcing):
            return model._step(exch, forcing, *st_, fs.depth)

        return (("ssh", "u", "v", "c"),
                (fs.sshn_t, fs.un, fs.vn, model.c), step_ct, 2, fs)
    if isinstance(model, shallow.ShallowModel):
        return (("eta", "u", "v"), (model.eta, model.u, model.v), plain, 1,
                None)
    if isinstance(model, twolayer.TwoLayerModel):
        return (("eta1", "eta2", "u1", "v1", "u2", "v2"),
                (model.eta1, model.eta2, model.u1, model.v1, model.u2,
                 model.v2), plain, 1, None)
    if isinstance(model, nlayer.NLayerModel):
        # multi-level fields: states are (M, L, ly, lx); the step is
        # leading-axis agnostic and the exchange carries both axes
        return (("eta", "u", "v"), (model.eta, model.u, model.v), plain, 1,
                None)
    if isinstance(model, semi_implicit.SemiImplicitModel):
        # the in-step solve must be member-independent: the dot-free
        # Chebyshev iteration broadcasts over the member axis, while CG's
        # dot products would sum ACROSS members
        if model.solver != "chebyshev":
            raise ValueError(
                "an ensemble of implicit models needs solver='chebyshev': "
                "CG's dot products would couple the members into one "
                "scalar")

        def step_si(exch, st_, istep, forcing):
            return tuple(model._block_step(istep, *st_)[:3])

        return (("eta", "u", "v"), (model.eta, model.u, model.v), step_si,
                1, None)
    if isinstance(model, nemolite2d.NemoLite2D):
        if model._ht is not None:
            raise ValueError(
                "flagship ensembles support flat bathymetry (build "
                "without depth=<array>)")

        def step_nl(exch, st_, istep, forcing):
            return tuple(model._block_step(exch, forcing, *st_,
                                           model._mask_codes))

        # deep-halo builds run the communication-free reach-2 chain,
        # which needs a depth-2 refresh, as the model's own step does
        depth = min(model.grid.halo_spec.halo, 2) or 1
        return (("ssh", "u", "v"), (model.sshn_t, model.un, model.vn),
                step_nl, depth, model)
    raise TypeError(f"no ensemble adapter for {type(model).__name__}; "
                    "supported: GravityWaveModel, ShallowModel, "
                    "TwoLayerModel, NLayerModel, "
                    "SemiImplicitModel(chebyshev), NemoLite2D, "
                    "TracerModel, CoupledTracer")


class Ensemble:
    """M replicas of ``model``'s state, stepped together on its device."""

    def __init__(self, model, n_members: int):
        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        self.model = model
        self.n_members = int(n_members)
        (self._field_names, self._fields, self._step_fn,
         self._exch_depth, self._flagship) = _adapt(model)
        self.grid = model.grid
        # every member starts from the base model's current state
        self.states = tuple(
            f.data.expand((self.n_members,) + tuple(f.data.shape)).clone()
            for f in self._fields)
        # continue the base model's clock: time-dependent forcing in the
        # members picks up where the base run left off
        self._istep0 = int(getattr(model, "_istep0", 0))

    # ------------------------------------------------------------------
    def set_member_states(self, field_index: int, globals_m) -> None:
        """Load per-member initial data for one state field from an
        ``(M, gny, gnx)`` global array, or ``(M, levels, gny, gnx)`` for a
        multi-level field (scatter + halo exchange; this rank keeps its
        block)."""
        globals_m = np.asarray(globals_m)
        if globals_m.shape[0] != self.n_members:
            raise ValueError(f"expected leading dim {self.n_members}, "
                             f"got {globals_m.shape}")
        d = self.grid.decomp
        field = self._fields[field_index]
        npdt = kinds.np_dtype(field.dtype)

        def stack(g):
            if g.ndim == 2:
                return layout.stack_global(d, g, mode="zeros", dtype=npdt)
            return np.stack([stack(lvl) for lvl in g])

        whole = np.stack([stack(g) for g in globals_m])
        arr = torch.from_numpy(np.ascontiguousarray(
            self.grid.local_block(whole))).to(device=field.data.device,
                                              dtype=field.dtype)
        arr = halo_mod.exchange(arr, self.grid.halo_spec, depth=d.halo)
        states = list(self.states)
        states[field_index] = arr
        self.states = tuple(states)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int):
        """``prog(istep0, states) -> states`` advancing every member
        ``nsteps`` steps of the model's plain step, one exchange of all
        members' fields a step."""
        exch = exchange_multi_fn(self.grid.halo_spec, depth=self._exch_depth)
        fs = self._flagship

        def prog(istep0, states):
            forcing = (fs.forcing_series(istep0, nsteps) if fs is not None
                       else [None] * nsteps)
            states = tuple(states)
            for i in range(nsteps):
                states = self._step_fn(exch, states, istep0 + i, forcing[i])
            return states
        return prog

    def run(self, nsteps: int) -> None:
        self.states = self.step_program(nsteps)(self._istep0, self.states)
        self._istep0 += nsteps

    # ------------------------------------------------------------------
    def member(self, i: int) -> dict:
        """Gathered global fields of member ``i`` (internal points;
        collective)."""
        d, spec = self.grid.decomp, self.grid.halo_spec
        return {k: layout.unstack_internal(d, gather_to_host(s[i], spec))
                for k, s in zip(self._field_names, self.states)}

    def gather_all(self) -> dict:
        """All members' global fields: ``{name: (M, gny, gnx)}``
        (collective)."""
        d, spec = self.grid.decomp, self.grid.halo_spec
        return {k: layout.unstack_internal(d, gather_to_host(s, spec))
                for k, s in zip(self._field_names, self.states)}

    def save(self, path: str) -> None:
        """Checkpoint all members (global internal form and the model
        clock under ``__step__``) to one ``.npz``, the JAX package's
        format: either package loads the other's file.  Collective:
        every rank gathers, rank 0 writes."""
        fields = self.gather_all()
        if env.on_master():
            np.savez(path, __step__=np.int64(self._istep0), **fields)
        env.barrier()

    def load(self, path: str) -> None:
        """Restore member states saved by :meth:`save` (scatter + halo
        exchange per field; the clock resumes)."""
        with np.load(path) as data:
            for i, name in enumerate(self._field_names):
                self.set_member_states(i, data[name])
            self._istep0 = int(data["__step__"])

    def mean_and_spread(self) -> tuple[dict, dict]:
        """Ensemble mean and standard deviation per state field."""
        g = self.gather_all()
        return ({k: v.mean(axis=0) for k, v in g.items()},
                {k: v.std(axis=0) for k, v in g.items()})
