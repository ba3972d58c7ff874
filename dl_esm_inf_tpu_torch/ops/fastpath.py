"""Fast-path switches shared by the models that have a fused kernel.

Counterpart of ``dl_esm_inf_tpu/ops/fastpath.py``.  A fused sweep
advances K steps per pass over memory and per halo exchange, so K steps
of a stencil of reach ``reach`` must fit the shard halo:
``K * reach <= halo``.  Each kernel also has its own ceiling on K
(``kmax``: 4 for the NEMOLite2D sweep, ``8 // reach`` for the client
models' sweeps).  The GPU kernels stage 2D tiles with a ring of
``K * reach`` cells, so no row alignment of the shards is needed.

:class:`SweepClient` is the schedule the client models of the generic
sweep (gravity wave, shallow, two-layer, tracer) share.
"""
from __future__ import annotations

from ..parallel.halo import exchange_multi_fn
from .adjoint import checkpointed_fori
from .stencil_sweep import RING, make_sweep, stencil_sweep_reference


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


class SweepClient:
    """The K-step schedule of a client model of the generic sweep.

    A subclass sets ``sweep_kernel`` (its :class:`~.stencil_sweep.
    StencilSweepKernel`), ``_fields`` (the names of its state Field
    attributes) and, where they differ from the defaults, ``reach`` and
    ``_variant`` (the kernel variant); it sets ``_step_aux`` (the plain
    step's trailing arguments) and ``_sweep_aux`` (the sweep's aux: float
    planes, then the mask code), calls :meth:`_init_fast_path`, and
    defines ``_step_math(*state, *step_aux) -> state``, ``_prepare(aux)
    -> step_aux`` and ``kernel_constants()``.  A model whose kernel takes
    another call (the N-layer model's) overrides :meth:`_make_sweep` and
    :meth:`_sweep_step`."""

    reach = 1
    _variant = 0

    def _init_fast_path(self) -> None:
        #: advance with the fused sweep (the CUDA kernel on a CUDA grid)
        self.use_fused = False
        self._sweep_K = 1
        self._sweep_cache = {}

    def enable_fast_path(self, steps_per_sweep: int = 1) -> None:
        """Switch to the fused sweep (the JAX package's
        ``enable_pallas``); needs ``halo_width >= K * reach``."""
        enable_fast_path(self, reach=self.reach, kmax=RING // self.reach,
                         steps_per_sweep=steps_per_sweep)

    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Communication avoidance on the plain path: K chained steps
        per depth-K*reach exchange."""
        set_steps_per_exchange(self, reach=self.reach,
                               steps_per_sweep=steps_per_sweep)

    def _sweep_step(self, *planes_and_aux):
        """The sweep's one step on its planes: the kernel's plain
        version is this step K times."""
        return self._step_math(*planes_and_aux)

    def _make_sweep(self, K: int):
        """The fused K-step sweep: the CUDA kernel for CUDA tensors, its
        plain version for CPU tensors."""
        if K not in self._sweep_cache:
            self._sweep_cache[K] = make_sweep(
                self.sweep_kernel, self._sweep_step, K=K,
                consts=self.kernel_constants(), prepare=self._prepare,
                variant=self._variant)
        return self._sweep_cache[K]

    def _block_step(self, exch, *state):
        """One plain step after a halo exchange."""
        return tuple(self._step_math(*exch(state), *self._step_aux))

    def step_program(self, nsteps: int, remat_chunk: int | None = None):
        """``prog(state) -> state`` advancing ``nsteps``: ``nsteps // K``
        sweeps of K steps, each after one depth-K*reach exchange, then
        ``nsteps % K`` single steps (through the kernel with K = 1 on
        the fused path).

        ``remat_chunk`` checkpoints the loop of plain steps for
        bounded-memory reverse mode (:func:`..ops.adjoint.
        checkpointed_fori`); the kernels have no backward, so it needs
        the plain path with one step per exchange.  Forward values are
        bitwise unchanged."""
        if remat_chunk is not None and (self.use_fused
                                        or self._sweep_K > 1):
            raise ValueError(
                "remat_chunk needs the plain differentiable path: build "
                "the model without fused/steps_per_sweep")
        spec = self.grid.halo_spec
        K, fused = self._sweep_K, self.use_fused
        exch1 = exchange_multi_fn(spec, depth=self.reach)
        blocked = (K > 1 or fused) and nsteps >= K
        if blocked:
            exchK = exchange_multi_fn(spec, depth=K * self.reach)

        def prog(state):
            state = tuple(state)
            base = 0
            if blocked:
                for _ in range(nsteps // K):
                    s = exchK(state)
                    state = (self._make_sweep(K)(s, self._sweep_aux) if fused
                             else stencil_sweep_reference(
                                 self._step_math, K, s, self._step_aux))
                base = (nsteps // K) * K
            if fused:
                for _ in range(base, nsteps):
                    state = self._make_sweep(1)(exch1(state), self._sweep_aux)
                return state
            # the plain single steps; with remat_chunk, all of them (K = 1)
            return checkpointed_fori(
                nsteps - base, lambda _i, s: self._block_step(exch1, *s),
                state, remat_chunk)
        return prog

    def run(self, nsteps: int) -> None:
        fields = [getattr(self, f) for f in self._fields]
        out = self.step_program(nsteps)(tuple(f.data for f in fields))
        for f, d in zip(fields, out):
            f.data = d

    def gather(self) -> dict:
        return {f: getattr(self, f).gather_inner_data() for f in self._fields}
