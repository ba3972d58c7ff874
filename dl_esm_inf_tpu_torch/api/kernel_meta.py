"""Kernel metadata — the PSyclone-facing API layer.

Counterpart of ``dl_esm_inf_tpu/api/kernel_meta.py``, the analogue of
the reference's ``argument_mod``/``kernel_mod``
(finite_difference/src/argument_mod.f90:39-117, kernel_mod.f90:21-56):
declarative descriptions of what a stencil kernel reads and writes, its
footprint, iteration space and the grid properties it needs.  In the
reference these are inert constants that PSyclone parses to *generate*
the middle layer; here they are live:

* :func:`invoke` runs one kernel call: it halo-exchanges the arguments
  whose stencil reaches off-point, runs the body, merges the writes
  under the declared iteration space and returns the reductions;
* :class:`Schedule` binds a sequence of calls and plans their exchanges
  statically; it runs the sequence as plain PyTorch (``schedule()``) or
  as ONE sweep per application after ONE exchange (``fused``,
  ``fused_program``).  On a CPU grid the sweep is its plain PyTorch
  version; on a CUDA grid it is a CUDA kernel generated from the
  schedule (:mod:`..ops.schedule_sweep`), the PSyclone way, out of each
  kernel's point body: its ``cuda=`` body, or the one derived from its
  torch body (:mod:`..ops.point_trace`).

Differences from the JAX package: every tile a rank holds lies in one
stacked tensor on its device, so a kernel body runs ONCE on the rank's
whole block (the JAX package runs it once per shard).  Shifts agree on
internal points; a reduction over the block, all-reduced across ranks
(:func:`..parallel.collectives.all_reduce` with the access's operation:
equal in every rank's bits, summed in rank order), equals the JAX
package's ``psum``/``pmin``/``pmax`` of per-shard ones up to summation
order.
Kernel bodies are torch functions on :mod:`..ops.stencils` shifts, and
scalars reach them as Python values.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch
import torch.distributed as dist

from ..core.field import Field
from ..ops import schedule_sweep as ss
from ..ops.stencil_sweep import RING, stencil_sweep_reference
from ..ops.stencils import pack_mask_bits, unpack_mask_bits
from ..parallel.collectives import all_reduce
from ..parallel.halo import _exchange_blocks, exchange, exchange_multi


class Access(IntEnum):
    """Argument intents (argument_mod.f90:39-46)."""
    READ = 0
    WRITE = 1
    READWRITE = 2
    INC = 3
    # reductions (globals only)
    MIN = 4
    MAX = 5
    SUM = 6


GO_READ, GO_WRITE, GO_READWRITE, GO_INC = (Access.READ, Access.WRITE,
                                           Access.READWRITE, Access.INC)
GO_MIN, GO_MAX, GO_SUM = Access.MIN, Access.MAX, Access.SUM


class Element(IntEnum):
    """What an argument is defined on (argument_mod.f90:66-71)."""
    R_SCALAR = 0
    I_SCALAR = 1
    CU = 2
    CV = 3
    CT = 4
    CF = 5
    EVERY = 6


(GO_R_SCALAR, GO_I_SCALAR, GO_CU, GO_CV, GO_CT, GO_CF, GO_EVERY) = (
    Element.R_SCALAR, Element.I_SCALAR, Element.CU, Element.CV,
    Element.CT, Element.CF, Element.EVERY)


class GridProp(IntEnum):
    """Grid properties a kernel may request (argument_mod.f90:73-112)."""
    TIME_STEP = 1
    GRID_AREA_T = 2
    GRID_AREA_U = 3
    GRID_AREA_V = 4
    GRID_MASK_T = 5
    GRID_DX_T = 6
    GRID_DX_U = 7
    GRID_DX_V = 8
    GRID_DY_T = 9
    GRID_DY_U = 10
    GRID_DY_V = 11
    GRID_LAT_U = 12
    GRID_LAT_V = 13
    GRID_DX_CONST = 14
    GRID_DY_CONST = 15
    GRID_X_MIN_INDEX = 16
    GRID_X_MAX_INDEX = 17
    GRID_Y_MIN_INDEX = 18
    GRID_Y_MAX_INDEX = 19


# iteration spaces (kernel_mod.f90:35-37)
GO_INTERNAL_PTS = 0
GO_EXTERNAL_PTS = 1
GO_ALL_PTS = 2

# grid-type expectations (kernel_mod.f90:43-44)
GO_ORTHOGONAL_REGULAR = 7
GO_ORTHOGONAL_CURVILINEAR = 8


@dataclass(frozen=True)
class Stencil:
    """3-digit-per-row footprint descriptor (argument_mod.f90:48-52).

    Each row is written as a 3-digit number whose digits describe the
    access at (W, centre, E); rows ordered N, centre, S.  e.g.
    ``Stencil(0, 11, 0)`` reads the point and its East neighbour
    (Python rejects leading-zero literals, so the Fortran 000/011/000
    rows are written 0/11/0).  Following PSyclone's GOcean reading, a
    digit > 1 is the access DEPTH in that direction: ``Stencil(0, 12,
    0)`` reads two points eastward and needs a depth-2 halo, which the
    exchange honours (the reference hardwires depth 1,
    parallel_comms_mod.f90:48).
    """
    first_row: int
    second_row: int
    third_row: int

    def _digits(self) -> tuple:
        out = []
        for row in (self.first_row, self.second_row, self.third_row):
            out.extend(((row // 100) % 10, (row // 10) % 10, row % 10))
        return tuple(out)

    def reaches_off_point(self) -> bool:
        d = self._digits()
        return any(v for i, v in enumerate(d) if i != 4)

    def depth(self) -> int:
        """Halo depth this footprint requires: the largest off-centre
        access depth (0 for pointwise)."""
        d = self._digits()
        return max((v for i, v in enumerate(d) if i != 4), default=0)


go_stencil = Stencil
GO_POINTWISE = Stencil(0, 10, 0)


@dataclass(frozen=True)
class Arg:
    """One kernel argument (go_arg, argument_mod.f90:57-61)."""
    access: Access
    element: object  # Element | GridProp
    stencil: Stencil = GO_POINTWISE

    def __post_init__(self):
        # Access and Element are both IntEnums whose small values
        # collide (Element.R_SCALAR == Access.READ == 0), so a swapped
        # Arg(GO_R_SCALAR, ...) would silently "work": reject anything
        # that is not a member of the expected enum, in BOTH slots.
        if not isinstance(self.access, Access):
            raise TypeError(
                f"Arg.access must be an Access enum, got {self.access!r}")
        if not isinstance(self.element, (Element, GridProp)):
            raise TypeError(
                "Arg.element must be an Element or GridProp enum, got "
                f"{self.element!r}")


go_arg = Arg


@dataclass(frozen=True)
class KernelMeta:
    """kernel_type metadata (kernel_mod.f90:46-50 + conventions).

    ``cuda`` is the port's own field: the kernel's point body in CUDA
    C++ for the fused tier on the card (see :func:`kernel`)."""
    name: str
    args: tuple
    iterates_over: int = GO_INTERNAL_PTS
    index_offset: int = 3  # Offset.NE
    grid_type: int = GO_ORTHOGONAL_REGULAR
    cuda: str | None = None


def kernel(args, iterates_over=GO_INTERNAL_PTS, index_offset=3,
           name: str | None = None, grid_type=GO_ORTHOGONAL_REGULAR,
           cuda: str | None = None):
    """Decorator binding PSyclone-style metadata to a block-level torch
    function.

    The function body receives, positionally: one block per field or
    grid-property argument (in declaration order) and plain Python
    values for scalar arguments; it returns the new blocks of its
    WRITE/READWRITE/INC arguments (in declaration order), then one
    scalar per reduction argument.

    ``grid_type`` declares the mesh geometry the kernel's maths assumes
    (kernel_mod.f90:43-44): a ``GO_ORTHOGONAL_CURVILINEAR`` kernel is
    rejected unless the grid carries per-point scale factors
    (:meth:`~..core.grid.Grid.set_scale_factors`).

    ``cuda`` is the same kernel as a CUDA C++ point body, which the
    fused tier on a CUDA grid compiles into the schedule's sweep
    kernel.  In it, the function's parameter names stand for its
    arguments at one point: a field or grid-property argument ``a``
    reads as ``a(dj, di)`` (dj rows north, di columns east, within its
    declared stencil) and ``a()`` (the point itself); a scalar ``s`` is
    a ``const double``; a written argument ``w`` is assigned
    (``w = value;``, of the field type ``T``).  A ``levels=N`` field
    argument ``e`` reads level by level, ``e(k, dj, di)`` and ``e(k)``
    (``e.levels`` is N); written, ``e[k] = value;`` sets level k and
    ``e = value;`` every level.  Scalars are doubles so that a body can
    fold them as the torch body does on the host, and must be cast
    (``T(s)``) where the torch body meets a tensor.  Following the torch
    body operation for operation makes the kernel equal its plain
    version bitwise on the card.  Without ``cuda``, the fused tier
    derives the point body from the torch body (:mod:`..ops.point_trace`,
    which lists the operations it takes); a hand-written body wins where
    given."""
    def deco(fn):
        fn._meta = KernelMeta(name=name or fn.__name__, args=tuple(args),
                              iterates_over=iterates_over,
                              index_offset=index_offset,
                              grid_type=grid_type, cuda=cuda)
        return fn
    return deco


def _get_time_step(g):
    if g.time_step is None:
        raise ValueError(
            "kernel requests GO_TIME_STEP (argument_mod.f90:75) but the "
            "grid's time step is unset; pass time_step= to grid.init() "
            "or assign grid.time_step")
    return g.time_step


def _const_spacing(g, attr):
    # Reject only when THIS spacing family is per-point: a grid with,
    # say, only per-point latitudes installed still has a constant dx/dy
    prefix = attr.lower() + "_"
    if any(name.startswith(prefix) for name in g._curvi):
        raise ValueError(
            f"kernel requests the constant grid spacing GRID_{attr}_CONST "
            "(argument_mod.f90:105-107) but the grid carries per-point "
            f"{attr.lower()} scale factors; request the per-point "
            "GRID_DX/DY_* array properties instead")
    return getattr(g, attr.lower())


_GRID_PROP_GETTERS = {
    GridProp.TIME_STEP: _get_time_step,
    GridProp.GRID_AREA_T: lambda g: g.area_t,
    GridProp.GRID_AREA_U: lambda g: g.area_u,
    GridProp.GRID_AREA_V: lambda g: g.area_v,
    GridProp.GRID_MASK_T: lambda g: g.tmask,
    GridProp.GRID_DX_T: lambda g: g.dx_t,
    GridProp.GRID_DX_U: lambda g: g.dx_u,
    GridProp.GRID_DX_V: lambda g: g.dx_v,
    GridProp.GRID_DY_T: lambda g: g.dy_t,
    GridProp.GRID_DY_U: lambda g: g.dy_u,
    GridProp.GRID_DY_V: lambda g: g.dy_v,
    GridProp.GRID_LAT_U: lambda g: g.gphiu,
    GridProp.GRID_LAT_V: lambda g: g.gphiv,
    GridProp.GRID_DX_CONST: lambda g: _const_spacing(g, "DX"),
    GridProp.GRID_DY_CONST: lambda g: _const_spacing(g, "DY"),
    # Local internal-region index bounds (argument_mod.f90:109-112): the
    # tiles are shape-uniform, so the template bounds hold for every
    # tile (half-open 0-based; the Fortran values are xstart+1..xstop)
    GridProp.GRID_X_MIN_INDEX: lambda g: g.decomp.halo,
    GridProp.GRID_X_MAX_INDEX: lambda g: g.decomp.halo + g.decomp.tile_nx,
    GridProp.GRID_Y_MIN_INDEX: lambda g: g.decomp.halo,
    GridProp.GRID_Y_MAX_INDEX: lambda g: g.decomp.halo + g.decomp.tile_ny,
}


def _is_scalar_arg(a: Arg) -> bool:
    return a.element in (Element.R_SCALAR, Element.I_SCALAR) or (
        isinstance(a.element, GridProp) and a.element in (
            GridProp.TIME_STEP, GridProp.GRID_DX_CONST,
            GridProp.GRID_DY_CONST, GridProp.GRID_X_MIN_INDEX,
            GridProp.GRID_X_MAX_INDEX, GridProp.GRID_Y_MIN_INDEX,
            GridProp.GRID_Y_MAX_INDEX))


def _is_reduction(a: Arg) -> bool:
    return a.access in (Access.SUM, Access.MIN, Access.MAX)


def _is_written(a: Arg) -> bool:
    return a.access in (Access.WRITE, Access.READWRITE, Access.INC)


def _reads(a: Arg) -> bool:
    return a.access in (Access.READ, Access.READWRITE, Access.INC)


def _reads_off_point(a: Arg) -> bool:
    return _reads(a) and a.stencil.reaches_off_point()


def _space_mask(f, space):
    """The write mask of one field for an iteration space.  Always 2D:
    it broadcasts over any leading (level) dims.

    ``GO_EXTERNAL_PTS`` is the field's GLOBAL boundary ring (whole minus
    internal in global coordinates, field_mod.f90:604-622): see
    Field.external_mask."""
    if space == GO_INTERNAL_PTS:
        return f.internal_mask
    if space == GO_ALL_PTS:
        return torch.ones(f.grid.array_shape, dtype=f.dtype,
                          device=f.grid.device)
    if space == GO_EXTERNAL_PTS:
        return f.external_mask
    raise ValueError(f"unknown iteration space {space!r}")


def _bind_call(meta: KernelMeta, args):
    """Resolve one kernel call's declared Args against caller args.

    SHARED by :func:`invoke` and :class:`Schedule` so the two binding
    paths cannot drift.  Performs the arity and type checks, resolves
    the grid from the first Field, and returns ``(grid, records)``: one
    record per declared argument, in declaration order:

    * ``("gscalar", value, a)`` — hidden grid-property scalar
    * ``("garray", value, a)`` — grid-property array
    * ``("scalar", value, a)`` — caller-supplied scalar
    * ``("reduction", None, a)`` — reduction output slot
    * ``("field", field, a)``
    """
    consumable = [a for a in meta.args
                  if not isinstance(a.element, GridProp)
                  and not (a.element in (Element.R_SCALAR,
                                         Element.I_SCALAR)
                           and _is_reduction(a))]
    if len(args) != len(consumable):
        raise TypeError(
            f"kernel {meta.name} declares {len(consumable)} caller "
            f"arguments (after grid properties and reduction outputs), "
            f"got {len(args)}")
    field_args = [a for a in args if isinstance(a, Field)]
    if not field_args:
        raise ValueError(f"kernel {meta.name} needs at least one Field arg")
    grid = field_args[0].grid
    if any(f.grid is not grid for f in field_args):
        raise ValueError(
            f"kernel {meta.name}: all Field arguments must share one "
            "grid (mixed grids would exchange with the wrong halo "
            "geometry)")
    if (meta.grid_type == GO_ORTHOGONAL_CURVILINEAR
            and not grid.is_curvilinear):
        raise ValueError(
            f"kernel {meta.name} declares GO_ORTHOGONAL_CURVILINEAR "
            "(kernel_mod.f90:43-44) but the grid carries no per-point "
            "scale factors; install them with grid.set_scale_factors() "
            "— serving constants would mis-state the kernel's metric "
            "terms")
    if meta.grid_type not in (GO_ORTHOGONAL_REGULAR,
                              GO_ORTHOGONAL_CURVILINEAR):
        raise ValueError(
            f"kernel {meta.name}: unknown grid_type {meta.grid_type!r}")

    records = []
    it = iter(args)
    for a in meta.args:
        if isinstance(a.element, GridProp):
            getter = _GRID_PROP_GETTERS.get(a.element)
            if getter is None:
                raise NotImplementedError(
                    f"grid property {a.element!r} not available")
            kind = "gscalar" if _is_scalar_arg(a) else "garray"
            records.append((kind, getter(grid), a))
        elif a.element in (Element.R_SCALAR, Element.I_SCALAR):
            if _is_reduction(a):
                records.append(("reduction", None, a))
                continue
            val = next(it)
            if isinstance(val, Field):
                raise TypeError(
                    f"kernel {meta.name}: argument declared scalar "
                    f"received a Field")
            records.append(("scalar", val, a))
        else:
            f = next(it)
            if not isinstance(f, Field):
                raise TypeError(
                    f"kernel {meta.name}: argument declared {a.element!r} "
                    f"must be a Field, got {type(f)}")
            records.append(("field", f, a))
    return grid, records


def _outputs(fn, meta: KernelMeta, outs, n_written: int, n_red: int):
    """The body's results as a tuple of the declared length."""
    if not isinstance(outs, tuple):
        outs = (outs,)
    if len(outs) != n_written + n_red:
        raise ValueError(
            f"kernel {meta.name} returned {len(outs)} output(s); its "
            f"metadata declares {n_written} written field(s) + {n_red} "
            f"reduction(s)")
    return outs


_REDUCE_OPS = {Access.SUM: dist.ReduceOp.SUM, Access.MIN: dist.ReduceOp.MIN,
               Access.MAX: dist.ReduceOp.MAX}


def _reduced(meta: KernelMeta, outs) -> list:
    """A call's reduction results as Python floats, each all-reduced
    across ranks with its declared access (GO_SUM, GO_MIN, GO_MAX)."""
    accs = [a.access for a in meta.args if _is_reduction(a)]
    return [float(all_reduce(r if isinstance(r, torch.Tensor)
                             else torch.tensor(float(r), dtype=torch.float64),
                             _REDUCE_OPS[acc]))
            for acc, r in zip(accs, outs)]


def _merge(mask, new, old):
    """``where(mask, new, old)`` with ``new`` in ``old``'s dtype."""
    new = torch.as_tensor(new, dtype=old.dtype, device=old.device)
    return torch.where(mask > 0, new, old)


def invoke(kern, *args, exchange_halos: bool = True):
    """Apply a metadata-carrying kernel — the PSyclone middle layer.

    ``args`` align with the kernel's declared ``Arg`` list: pass a
    :class:`Field` for CU/CV/CT/CF/EVERY arguments, nothing for grid
    properties (fetched from the grid), and Python numbers for scalars.
    Written fields are updated in place (their ``.data`` is replaced);
    reduction results are returned as Python floats, reduced over every
    rank's block.
    """
    meta: KernelMeta = kern._meta
    grid, records = _bind_call(meta, args)

    # Coalesce the halo refreshes of every off-point-read argument into
    # ONE exchange at the deepest read depth.  INC reads too.
    if exchange_halos:
        need, depth = [], 0
        for kind, val, a in records:
            if kind == "field" and _reads_off_point(a):
                # the depth counts EVERY off-point read, also of a Field
                # bound to several args (the dedup only spares the copy)
                depth = max(depth, a.stencil.depth())
                if all(val is not f for f in need):
                    need.append(val)
        if need:
            fresh = exchange_multi([f.data for f in need], grid.halo_spec,
                                   depth=depth)
            for f, nd in zip(need, fresh):
                f.data = nd

    call_args, written = [], []
    for kind, val, a in records:
        if kind == "reduction":
            continue
        if kind == "field":
            call_args.append(val.data)
            if _is_written(a):
                written.append((val, val.data,
                                _space_mask(val, meta.iterates_over)))
        else:
            call_args.append(val)
    n_red = sum(1 for a in meta.args if _is_reduction(a))
    outs = _outputs(kern, meta, kern(*call_args), len(written), n_red)
    merged = [_merge(m, nb, old)
              for (_, old, m), nb in zip(written, outs)]
    for (f, _, _), nd in zip(written, merged):
        f.data = nd
    reds = tuple(_reduced(meta, outs[len(written):]))
    if n_red == 1:
        return reds[0]
    return reds or None


# ---------------------------------------------------------------------------
# Kernel SCHEDULES: the PSyclone-generated-PSy-layer analogue.
# ---------------------------------------------------------------------------

class Schedule:
    """A sequence of metadata-carrying kernel calls with a static
    exchange plan — the analogue of the PSy layer PSyclone would
    generate from an algorithm's multi-kernel ``invoke`` (SURVEY §3.6).

    ``Schedule((k1, out1, in1, 2.0), (k2, out2, out1), ...)`` binds each
    kernel to concrete Fields/scalars (the caller contract of
    :func:`invoke`) and plans halo exchanges from the metadata: a
    field's halo is stale on entry and after any kernel writes it; a
    kernel whose stencil reads off-point gets one coalesced exchange of
    exactly the stale fields it needs, at the required depth.  Calling
    the schedule runs the calls, exchanges and reductions as plain
    PyTorch; :meth:`fused` and :meth:`fused_program` run the whole
    sequence as one sweep per application.

    ``schedule.exchanges`` exposes the plan (call index -> (slot
    indices, depth)).  USER scalars (the ones supplied in the calls;
    grid-property constants are bound separately and cannot be
    clobbered) may be changed per run via ``schedule(scalars=[...])``.
    """

    def __init__(self, *calls, exchange_halos: bool = True):
        if not calls:
            raise ValueError("empty schedule")
        self._slots: list = []          # distinct Fields, in first-use order
        self._consts: list = []         # grid-property arrays
        #: scalar slots: ("user", default) | ("grid", value)
        self._scalar_src: list = []
        self._masks: list = []          # one per (slot, space)
        mask_index: dict = {}
        self._steps = []                # per call: dict of static plan
        self.exchanges: dict = {}       # call idx -> (slots, depth)
        self._grid = None

        def slot_of(f):
            for i, g in enumerate(self._slots):
                if g is f:
                    return i
            self._slots.append(f)
            return len(self._slots) - 1

        def const_of(val):
            """Dedup grid-property arrays by identity (the getters return
            cached tensors): a duplicate would stream one more plane
            into every tile of the fused sweep."""
            for i, c in enumerate(self._consts):
                if c is val:
                    return i
            self._consts.append(val)
            return len(self._consts) - 1

        clean_depth: dict = {}          # slot -> halo depth known fresh

        for ci, call in enumerate(calls):
            kern, *args = call
            meta: KernelMeta = kern._meta
            grid, records = _bind_call(meta, args)   # shared with invoke
            if self._grid is None:
                self._grid = grid
            if any(v.grid is not self._grid for k, v, _ in records
                   if k == "field"):
                raise ValueError("all fields must share one grid")

            need: dict = {}             # slot -> depth
            binding = []                # per declared arg
            written = []                # (slot, mask index)
            for kind, val, a in records:
                if kind == "gscalar":
                    binding.append(("s", len(self._scalar_src)))
                    self._scalar_src.append(("grid", val))
                elif kind == "scalar":
                    binding.append(("s", len(self._scalar_src)))
                    self._scalar_src.append(("user", val))
                elif kind == "garray":
                    binding.append(("c", const_of(val)))
                elif kind == "reduction":
                    binding.append(("r", None))
                else:
                    si = slot_of(val)
                    binding.append(("f", si))
                    if exchange_halos and _reads_off_point(a):
                        dneed = a.stencil.depth()
                        if clean_depth.get(si, 0) < dneed:
                            need[si] = max(need.get(si, 0), dneed)
                    if _is_written(a):
                        mkey = (si, meta.iterates_over)
                        if mkey not in mask_index:
                            mask_index[mkey] = len(self._masks)
                            self._masks.append(
                                _space_mask(val, meta.iterates_over))
                        written.append((si, mask_index[mkey]))

            exch = None
            if need:
                depth = max(need.values())
                if depth > self._grid.halo_spec.halo:
                    raise ValueError(
                        f"schedule step {ci} needs halo depth {depth} > "
                        f"decomposition halo {self._grid.halo_spec.halo}")
                exch = (tuple(sorted(need)), depth)
                self.exchanges[ci] = exch
                for si in need:
                    clean_depth[si] = depth
            for si, _ in written:       # writes invalidate halos
                clean_depth[si] = 0

            self._steps.append(dict(
                fn=kern, meta=meta, binding=tuple(binding),
                written=tuple(written), exch=exch,
                n_red=sum(1 for a in meta.args if _is_reduction(a))))

        self._fused_cache: dict = {}
        self._fused_mask_codes = None   # packed+exchanged, built once

    def _user_scalar_vector(self, scalars):
        n_user = sum(1 for k, _ in self._scalar_src if k == "user")
        if scalars is None:
            user = [v for k, v in self._scalar_src if k == "user"]
        else:
            user = list(scalars)
            if len(user) != n_user:
                raise ValueError(
                    f"schedule binds {n_user} user scalars, got "
                    f"{len(user)}")
        it = iter(user)
        return [next(it) if k == "user" else v
                for k, v in self._scalar_src]

    @staticmethod
    def _call_args(step, slot_view, consts, scalars):
        return [slot_view(i) if kind == "f"
                else consts[i] if kind == "c"
                else scalars[i]
                for kind, i in step["binding"] if kind != "r"]

    def __call__(self, scalars=None):
        """Run the sequence once as plain PyTorch, with the planned
        exchanges; returns the reductions (one float, a tuple, or
        None)."""
        sc = self._user_scalar_vector(scalars)
        spec = self._grid.halo_spec
        cur = [f.data for f in self._slots]
        reds = []
        for s in self._steps:
            if s["exch"] is not None:
                idx, depth = s["exch"]
                fresh = _exchange_blocks(tuple(cur[i] for i in idx), spec,
                                         depth)
                for i, nb in zip(idx, fresh):
                    cur[i] = nb
            args = self._call_args(s, cur.__getitem__, self._consts, sc)
            outs = _outputs(s["fn"], s["meta"], s["fn"](*args),
                            len(s["written"]), s["n_red"])
            for (si, mi), nb in zip(s["written"], outs):
                cur[si] = _merge(self._masks[mi], nb, cur[si])
            reds.extend(_reduced(s["meta"], outs[len(s["written"]):]))
        for f, d in zip(self._slots, cur):
            f.data = d
        if len(reds) == 1:
            return reds[0]
        return tuple(reds) or None

    # ------------------------------------------------------------------
    # The fused (one sweep per application) execution of a schedule.
    # ------------------------------------------------------------------
    def fused_erosion(self, repeats: int = 1) -> int:
        """Halo-validity erosion of ``repeats`` fused applications of
        the sequence, by DATAFLOW rather than the naive per-call sum.

        Staleness only propagates through slots a later kernel reads:
        each slot carries a margin (how far invalidity has crept in from
        the exchange-valid boundary), a call's inputs need ``margin +
        stencil reach`` valid cells, and its written slots inherit that
        requirement (kept at least at their old margin — the masked
        merge keeps old values where the write mask is 0).  Grid-property
        planes are time-invariant with valid halos, so they contribute
        their reach only.  For the NEMOLite2D schedule this gives 3 for
        one sequence and +2 per further repeat."""
        margin = [0] * len(self._slots)
        worst = 0
        for _ in range(int(repeats)):
            for s in self._steps:
                in_m = 0
                for (kind, idx), a in zip(s["binding"], s["meta"].args):
                    if kind == "f" and _reads(a):
                        in_m = max(in_m, margin[idx] + a.stencil.depth())
                    elif kind == "c" and a.stencil.reaches_off_point():
                        in_m = max(in_m, a.stencil.depth())
                worst = max(worst, in_m)
                for si, _mi in s["written"]:
                    margin[si] = max(margin[si], in_m)
        return worst

    def max_fused_repeats(self) -> int:
        """Largest ``repeats`` whose :meth:`fused_erosion` fits both the
        sweep's window ring and the decomposition halo (capped at the
        ring size: a pointwise schedule never erodes).  Raises with the
        required halo when even ONE application does not fit."""
        cap = min(RING, self._grid.halo_spec.halo)
        need1 = self.fused_erosion(1)
        if need1 > cap:
            if need1 > RING:
                raise ValueError(
                    f"fused schedule: even one application erodes "
                    f"{need1} halo cells > the {RING}-cell window ring — "
                    "no halo_width can fuse this sequence; split the "
                    "schedule or run the plain schedule")
            raise ValueError(
                f"fused schedule: even one application erodes {need1} "
                f"halo cells > decomposition halo "
                f"{self._grid.halo_spec.halo}; "
                f"decompose(halo_width={need1})")
        k = 1
        while k < RING and self.fused_erosion(k + 1) <= cap:
            k += 1
        return k

    def fused(self, scalars=None, *, repeats: int = 1, plain: bool = False):
        """Run the WHOLE kernel sequence, ``repeats`` times, as ONE sweep
        after ONE coalesced exchange at the sequence's erosion depth:
        halo values are computed redundantly inside the sweep, so the
        chain needs no mid-chain communication.  On a CUDA grid the
        sweep is the kernel generated from the schedule; on a CPU grid
        its plain PyTorch version.

        Requirements (checked): no reduction arguments, one field dtype
        (``levels=N`` fields fuse as N planes),
        ``halo_width >=`` :meth:`fused_erosion` ``(repeats)`` (<= the
        8-cell window ring; :meth:`max_fused_repeats` picks the deepest
        legal blocking).  Semantics match calling the schedule
        ``repeats`` times, on internal points; halo cells hold values of
        no meaning.  ``scalars``: None, one flat row, or ``repeats``
        rows (one per repeat).  ``plain=True`` runs the plain version on
        any device: the reference the generated kernel is held against
        (nothing takes it in place of a kernel)."""
        prog, written, ro, _ = self._fused_prog(1, repeats, plain)
        rows = self._repeat_rows(scalars, repeats)
        outs = prog(tuple(self._slots[i].data for i in written),
                    tuple(self._slots[i].data for i in ro), [rows])
        for i, nb in zip(written, outs):
            self._slots[i].data = nb

    def fused_program(self, nsteps: int, *, repeats: int = 1,
                      plain: bool = False):
        """Whole-run fused program: ``nsteps`` applications of the fused
        sweep (each of ``repeats`` repeats), a host loop of exchange +
        sweep.  Returns ``run(scalars=None)``: ``scalars`` may be None
        or one flat row (the same values throughout), a
        length-``nsteps`` sequence of flat rows, or a length-``nsteps``
        sequence of ``repeats``-row groups.  Written fields update in
        place, like :meth:`fused`.  On a CUDA grid the sweep kernels are
        generated and built here; they depend on the schedule's
        structure only, so new scalars or another ``nsteps`` reuse them.
        ``plain`` as in :meth:`fused`."""
        prog, written, ro, _ = self._fused_prog(nsteps, repeats, plain)

        def run(scalars=None):
            try:
                nd = int(np.ndim(scalars)) if scalars is not None else 0
            except Exception:   # noqa: BLE001 — ragged nesting
                nd = 2
            if nd <= 1:
                rows = [self._repeat_rows(scalars, repeats)] * int(nsteps)
            else:
                if len(scalars) != int(nsteps):
                    raise ValueError(
                        f"need {nsteps} per-step scalar entries, got "
                        f"{len(scalars)}")
                rows = [self._repeat_rows(item, repeats)
                        for item in scalars]
            outs = prog(tuple(self._slots[i].data for i in written),
                        tuple(self._slots[i].data for i in ro), rows)
            for i, nb in zip(written, outs):
                self._slots[i].data = nb

        return run

    def _fused_prog(self, nsteps, repeats, plain=False):
        """``(prog, written slots, read-only slots, variants)`` of the
        fused program, cached; ``variants`` maps "full" and "light" to
        ``(sweep, state slots, extra slots)``."""
        key = (int(nsteps), int(repeats), bool(plain))
        if key not in self._fused_cache:
            self._fused_cache[key] = self._build_fused(
                int(repeats), nsteps=int(nsteps), plain=bool(plain))
        return self._fused_cache[key]

    def _repeat_rows(self, scalars, repeats):
        """K user-scalar rows from one flat row (broadcast) or a K-row
        sequence.  Detection is by dimensionality, not element type: a
        flat row may hold 0-d array values."""
        try:
            nd = int(np.ndim(scalars)) if scalars is not None else 0
        except Exception:   # noqa: BLE001 — ragged nesting etc.
            nd = 1
        if nd == 2:
            if len(scalars) != int(repeats):
                raise ValueError(
                    f"per-repeat scalars need {repeats} rows, got "
                    f"{len(scalars)}")
            return [self._user_scalar_vector(r) for r in scalars]
        return [self._user_scalar_vector(scalars)] * int(repeats)

    def _fused_masks(self):
        """The write masks, exchanged at full halo depth (so halo cells
        that mirror a neighbour's internal cells are written too: the
        fused form computes them redundantly) and packed 8 per int8
        plane.  Built once per Schedule."""
        if self._fused_mask_codes is None:
            spec = self._grid.halo_spec
            fmasks = [exchange(m, spec, depth=spec.halo) if spec.halo
                      else m for m in self._masks]
            self._fused_mask_codes = tuple(
                pack_mask_bits(fmasks[i:i + 8]).contiguous()
                for i in range(0, len(fmasks), 8))
        return self._fused_mask_codes

    def _build_fused(self, repeats: int, nsteps: int = 1,
                     plain: bool = False):
        grid = self._grid
        spec = grid.halo_spec
        if any(s["n_red"] for s in self._steps):
            raise NotImplementedError(
                "fused schedules do not support reduction arguments; "
                "run the plain schedule")
        leads = [f.data.dim() - 2 for f in self._slots]
        nlev = [1 if ld == 0 else int(f.data.shape[0])
                for ld, f in zip(leads, self._slots)]
        dts = {f.data.dtype for f in self._slots}
        if len(dts) != 1:
            raise ValueError(
                f"fused schedules need one field dtype, got {dts}")
        dtype = next(iter(dts))
        K = int(repeats)
        if K < 1:
            raise ValueError(f"repeats must be >= 1, got {K}")
        depth_needed = self.fused_erosion(K)
        if depth_needed > spec.halo:
            raise ValueError(
                f"fused schedule: {K} repeat(s) erode {depth_needed} "
                f"halo cells > decomposition halo {spec.halo} "
                f"(decompose(halo_width={depth_needed}))")
        if depth_needed > RING:
            raise ValueError(
                f"fused schedule: {K} repeat(s) erode {depth_needed} "
                f"cells > the {RING}-cell window ring")
        on_card = grid.device.type == "cuda" and not plain
        # per slot: 0 for a 2D field, else its level count
        levels = [n if ld else 0 for n, ld in zip(nlev, leads)]

        # Slots a kernel writes are sweep STATE (stream in and out);
        # never-written slots (e.g. bathymetry) are time-invariant and
        # stream IN only, as read-only planes.
        written_set = sorted({si for s in self._steps
                              for si, _ in s["written"]})
        state_pos = {si: i for i, si in enumerate(written_set)}
        ro_slots = [si for si in range(len(self._slots))
                    if si not in state_pos]
        # SCRATCH slots: written before ever being read in the sequence
        # AND written under ONE iteration-space mask.  Then every cell a
        # later read can touch is either rewritten first in the current
        # application or lies outside the slot's single write mask,
        # where no kernel writes: the time-invariant background.  The
        # multi-step loop streams them as read-only planes for all
        # but the LAST step and emits them once at the end.  With TWO
        # write masks (an interior compute, a stencil read, then a
        # boundary-ring write) the ring cells carry values ACROSS
        # applications, which re-seeding from the background would
        # lose: such slots stay carried.
        seen_read, seen_written = set(), set()
        write_masks: dict = {}
        for s in self._steps:
            for (kind, idx), a in zip(s["binding"], s["meta"].args):
                if kind == "f" and _reads(a) and idx not in seen_written:
                    seen_read.add(idx)
            for si, mi in s["written"]:
                seen_written.add(si)
                write_masks.setdefault(si, set()).add(mi)
        carried_slots = [si for si in written_set
                         if si in seen_read or len(write_masks[si]) > 1]
        scratch_slots = [si for si in written_set
                         if si not in carried_slots]
        ro_start, n_ro_planes = {}, 0
        for si in ro_slots:
            ro_start[si] = n_ro_planes
            n_ro_planes += nlev[si]

        mask_codes = self._fused_masks()
        n_masks = len(self._masks)
        consts = tuple(self._consts)
        steps = self._steps

        def build_sweep(state_slots, extra_slots):
            """One sweep variant: ``state_slots`` stream in AND out;
            ``extra_slots`` (scratch backgrounds) ride as read-only
            planes after the ro planes and re-seed the merge's mask-0
            background on every application.  Returns ``sweep(state
            planes, ro planes, extra planes, K scalar rows) -> state
            planes``."""
            sstart, n_sp = {}, 0
            for si in state_slots:
                sstart[si] = n_sp
                n_sp += nlev[si]
            xstart, n_xp = {}, 0
            for si in extra_slots:
                xstart[si] = n_xp
                n_xp += nlev[si]

            if on_card:
                gen = ss.generate(steps, state_slots=state_slots,
                                  extra_slots=extra_slots,
                                  ro_slots=ro_slots, consts=consts,
                                  n_masks=n_masks, n_scalars=len(
                                      self._scalar_src),
                                  K=K, ring=depth_needed, dtype=dtype,
                                  levels=levels)
                ss.schedule_sweep.build(gen)
                code_stack = torch.stack(mask_codes).contiguous()
                float_c = tuple(c for c in consts if c.dtype == dtype)
                int_c = tuple(c for c in consts if c.dtype == torch.int32)

                def sweep(state_p, ros_p, extra_p, rows):
                    return ss.schedule_sweep(
                        gen, state_p, tuple(extra_p) + tuple(ros_p)
                        + float_c, int_c, code_stack, rows)
                sweep.generated = gen      # its source, tile and form
                return sweep

            def stepf(*args):
                state = args[:n_sp]
                masks, ros, extra = args[n_sp]
                scalars = args[n_sp + 1:]
                # mutable per-slot planes: streamed state plus scratch
                # slots (seeded from their background)
                cur = {}
                for si in state_slots:
                    cur[si] = list(state[sstart[si]: sstart[si] + nlev[si]])
                for si in extra_slots:
                    cur[si] = list(extra[xstart[si]: xstart[si] + nlev[si]])

                def slot_view(si):
                    planes = (cur[si] if si in cur
                              else ros[ro_start[si]:
                                       ro_start[si] + nlev[si]])
                    return (planes[0] if leads[si] == 0
                            else torch.stack(planes))

                for s in steps:
                    args_ = self._call_args(s, slot_view, consts, scalars)
                    outs = _outputs(s["fn"], s["meta"], s["fn"](*args_),
                                    len(s["written"]), 0)
                    for (si, mi), nb in zip(s["written"], outs):
                        if leads[si] == 0:
                            nbs = (nb,)
                        elif torch.as_tensor(nb).dim() == 2:
                            # a 2D result for a levels=N slot broadcasts
                            # to every level (the plain schedule's
                            # broadcasting semantics)
                            nbs = (nb,) * nlev[si]
                        else:
                            if nb.shape[0] != nlev[si]:
                                raise ValueError(
                                    f"kernel '{s['fn'].__name__}' "
                                    f"returned {nb.shape[0]} level "
                                    f"planes for a levels={nlev[si]} "
                                    "field")
                            nbs = tuple(nb[k] for k in range(nlev[si]))
                        for k, nbk in enumerate(nbs):
                            cur[si][k] = _merge(masks[mi], nbk, cur[si][k])
                return tuple(p for si in state_slots for p in cur[si])

            def sweep(state_p, ros_p, extra_p, rows):
                masks = []
                for i, c in enumerate(mask_codes):
                    masks.extend(unpack_mask_bits(
                        c, min(8, n_masks - 8 * i), dtype))
                prepared = (tuple(masks), tuple(ros_p), tuple(extra_p))
                return stencil_sweep_reference(stepf, K, state_p,
                                               (prepared,), scalars=rows)
            return sweep

        sweep_full = build_sweep(written_set, ())
        # the light variant only exists when the multi-step loop can
        # use it (scratch slots present and more than one step)
        use_light = nsteps > 1 and scratch_slots and carried_slots
        sweep_light = (build_sweep(carried_slots, tuple(scratch_slots))
                       if use_light else None)

        def split_planes(arrs, slots_list):
            planes = []
            for si, a in zip(slots_list, arrs):
                if leads[si] == 0:
                    planes.append(a)
                else:
                    planes.extend(a[k] for k in range(nlev[si]))
            return tuple(planes)

        def join_planes(planes, slots_list):
            out, i = [], 0
            for si in slots_list:
                if leads[si] == 0:
                    out.append(planes[i])
                    i += 1
                else:
                    out.append(torch.stack(planes[i:i + nlev[si]]))
                    i += nlev[si]
            return tuple(out)

        def exchanged(blks):
            if not depth_needed or not blks:
                return tuple(blks)
            return _exchange_blocks(tuple(blks), spec, depth_needed)

        def prog(state, ros, sc_steps):
            # scalar rows: one per repeat per step, as Python floats
            sc = [[tuple(float(v) for v in row) for row in rows]
                  for rows in sc_steps]
            # read-only slots: one exchange makes their halos valid for
            # every step (nothing rewrites them)
            ros_p = split_planes(exchanged(ros), ro_slots)

            def one(sweep_fn, slots, st, extra_p, rows):
                planes = split_planes(exchanged(st), slots)
                return join_planes(tuple(sweep_fn(planes, ros_p, extra_p,
                                                  rows)), slots)

            def full(st, rows):
                return one(sweep_full, written_set, st, (), rows)

            if nsteps == 1:
                return full(tuple(state), sc[0])
            if not use_light:
                if not carried_slots:
                    # nothing feeds forward between steps (every written
                    # slot is scratch): n applications == the last one
                    return full(tuple(state), sc[nsteps - 1])
                st = tuple(state)
                for i in range(nsteps):
                    st = full(st, sc[i])
                return st

            # the scratch path: the loop carries (and exchanges) only the
            # read-before-write slots; scratch backgrounds are exchanged
            # once and stream read-only, and the LAST step emits
            # everything through the full sweep
            pos = {si: k for k, si in enumerate(written_set)}
            carried = tuple(state[pos[si]] for si in carried_slots)
            scr_bg = exchanged(tuple(state[pos[si]] for si in scratch_slots))
            scr_p = split_planes(scr_bg, scratch_slots)
            for i in range(nsteps - 1):
                carried = one(sweep_light, carried_slots, carried, scr_p,
                              sc[i])
            merged = [None] * len(written_set)
            for si, v in zip(carried_slots, carried):
                merged[pos[si]] = v
            for si, v in zip(scratch_slots, scr_bg):
                merged[pos[si]] = v
            return full(tuple(merged), sc[nsteps - 1])

        variants = {"full": (sweep_full, written_set, ())}
        if use_light:
            variants["light"] = (sweep_light, carried_slots,
                                 tuple(scratch_slots))
        return prog, written_set, ro_slots, variants


def invoke_schedule(*calls, exchange_halos: bool = True):
    """Build and immediately run a :class:`Schedule`; returns the
    reductions."""
    return Schedule(*calls, exchange_halos=exchange_halos)()
