"""Fast-path switches shared by the models that have a fused kernel.

Counterpart of ``dl_esm_inf_tpu/ops/fastpath.py``.  A fused sweep
advances K steps per pass over memory and per halo exchange, so K steps
of a stencil of reach ``reach`` must fit the shard halo:
``K * reach <= halo``.  Each kernel also has its own ceiling on K
(``kmax``: 4 for the NEMOLite2D sweep).  The GPU kernels stage 2D tiles
with a ring of ``K * reach`` cells, so no row alignment of the shards
is needed.
"""
from __future__ import annotations


def enable_fast_path(model, *, reach: int, kmax: int,
                     steps_per_sweep: int = 1) -> None:
    """Validate that K sub-steps of ``reach`` fit the kernel and the
    shard halo, then switch the model to its fused kernel."""
    K = int(steps_per_sweep)
    if not 1 <= K <= kmax:
        raise ValueError(
            f"steps_per_sweep must be in [1, {kmax}], got {K}")
    need = K * reach
    if model.grid.halo_spec.halo < need:
        raise ValueError(
            f"the fused sweep with steps_per_sweep={K} needs "
            f"halo_width >= {need} (build(..., halo_width={need}))")
    model.use_fused = True
    model._sweep_K = K


def set_steps_per_exchange(model, *, reach: int,
                           steps_per_sweep: int) -> None:
    """Communication avoidance on the PLAIN path: K chained steps per
    depth-K*reach exchange, the fused kernel's schedule without it."""
    K = int(steps_per_sweep)
    if K < 1:
        raise ValueError(f"steps_per_sweep must be >= 1, got {K}")
    need = K * reach
    if model.grid.halo_spec.halo < need:
        raise ValueError(
            f"steps_per_sweep={K} needs halo_width >= {need}")
    model._sweep_K = K


def fast_path_grid_args(fused: bool, steps_per_sweep: int, reach: int,
                        halo_width: int) -> int:
    """The halo width a model ``build()`` needs: deep enough for the
    K-step sweep, and at least ``reach`` for the fused one-step chain."""
    need = steps_per_sweep * reach
    if fused:
        need = max(need, reach)
    elif steps_per_sweep <= 1:
        return halo_width
    return max(halo_width, need)
