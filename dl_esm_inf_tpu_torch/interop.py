"""Carry a model state across from the JAX package.

The JAX package's stacked layout pads tiles to 128 lanes and the port's
does not, so the two exchange the INTERNAL points only: the global
``(gny, gnx)`` arrays that ``model.gather()`` returns in either package.
Halo cells are rebuilt by scattering and a full-depth halo exchange.
"""
from __future__ import annotations

import numpy as np

from .core import kinds, layout


def _state_fields(model) -> dict:
    """The model's state Fields under their ``gather()`` names."""
    if hasattr(model, "_fields"):           # the sweep client models
        return {f: getattr(model, f) for f in model._fields}
    return {"sshn": model.sshn_t, "un": model.un, "vn": model.vn}


def load_reference_state(model, arrays: dict, istep0: int = 0) -> None:
    """Load a JAX model's gathered state into the port's ``model``.

    ``arrays`` holds the global internal state fields under the names
    ``model.gather()`` uses (``(gny, gnx)`` numpy arrays, and
    ``(layers, gny, gnx)`` for the multi-level fields of the N-layer
    model, e.g. from the JAX model's ``gather()``): ``sshn/un/vn`` for
    NEMOLite2D, ``eta/u/v`` for the gravity-wave, shallow,
    semi-implicit and N-layer models,
    ``eta1/eta2/u1/v1/u2/v2`` for the two-layer model, ``c`` for the
    tracer; ``sshn/un/vn`` for the PSy-built flagship too
    (``NemoLite2DPsy``).  Optionally it also holds the inputs the state
    was computed with: ``tmask`` (global T mask), ``depth`` (scalar or
    global T-point array, for the models with a depth) and, for the
    tracer, its face
    velocities ``u``/``v`` (scalars or global arrays, as given to
    ``build``).  Those must equal the port model's own, or the states
    would belong to different problems; a mismatch raises
    ``ValueError``.  ``istep0`` is the number of steps the state has
    taken, for the models with a clock (it sets the model time of the
    NEMOLite2D tidal forcing, the step counter of ``NemoLite2DPsy``, and
    the model time of the semi-implicit model's open boundary)."""
    grid = model.grid
    d = grid.decomp
    shape = (d.global_ny, d.global_nx)
    npdt = kinds.np_dtype(grid.dtype)
    fields = _state_fields(model)
    if "tmask" in arrays and not np.array_equal(
            np.asarray(arrays["tmask"]), grid.global_tmask()):
        raise ValueError("tmask differs from the model's grid tmask")
    if "depth" in arrays:
        if not hasattr(model, "depth"):
            raise ValueError(f"{type(model).__name__} has no depth")
        want = np.asarray(arrays["depth"], dtype=npdt)
        have = (np.asarray(model.depth, dtype=npdt) if model.depth is not None
                else layout.unstack_internal(d, model.bathymetry.cpu().numpy()))
        if want.shape != have.shape or not np.array_equal(want, have):
            raise ValueError("depth differs from the model's bathymetry")
    if hasattr(model, "_u"):                # the tracer's face velocities
        for key, vel, wet in (("u", model._u, model._u_wet),
                              ("v", model._v, model._v_wet)):
            if key not in arrays:
                continue
            wet_g = layout.unstack_internal(d, wet.cpu().numpy())
            want = np.broadcast_to(np.asarray(arrays[key], dtype=npdt),
                                   shape) * wet_g
            if not np.array_equal(
                    want, layout.unstack_internal(d, vel.cpu().numpy())):
                raise ValueError(f"{key} differs from the model's "
                                 "velocities")
    missing = [n for n in fields if n not in arrays]
    if missing:
        raise ValueError(f"missing state fields {missing}")
    for name, field in fields.items():
        a = np.asarray(arrays[name])
        want = field._lead + shape
        if a.shape != want:
            raise ValueError(f"{name}: expected global internal {want}, "
                             f"got {a.shape}")
        field.set_data(field._stack(a))
        if d.halo:
            field.halo_exchange(d.halo)
    if hasattr(model, "_istep0"):
        model._istep0 = int(istep0)
    elif hasattr(model, "_step"):           # the PSy-built flagship
        model._step = int(istep0)
    if hasattr(model, "_sync_face_ssh"):
        model._sync_face_ssh()
