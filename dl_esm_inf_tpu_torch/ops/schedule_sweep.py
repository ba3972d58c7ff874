"""The fused schedule sweep: a CUDA kernel generated from a kernel schedule.

Replaces the TPU kernel ``dl_esm_inf_tpu/api/kernel_meta.py::
Schedule._build_fused`` (its ``build_sweep`` and the generic sweep
``ops/sweep.py::make_stencil_sweep`` it instantiates): a whole sequence
of metadata kernels, ``repeats`` times, in one pass over device memory.
The TPU kernel traced the kernels' Python bodies with Pallas; here the
sweep is generated as CUDA C++ source from the schedule, the PSyclone
way: :func:`generate` emits one ``.cu`` per schedule STRUCTURE (the
kernels' point bodies, the slot bindings, the mask indices, the plane
counts, K, the ring and the dtype) on the shared skeleton
``csrc/stencil_sweep.cuh``.  A kernel's point body is its hand-written
``cuda=`` body where it has one, else the one :mod:`.point_trace`
derives from its torch body by tracing it.  A ``levels=N`` field takes
N consecutive planes among the state, scratch or read-only planes, and
its body reads it level by level (``a(k, dj, di)``).  Nothing in the
source depends on the number of steps or on scalar values: those ride
each launch as per-repeat constants (doubles, as the torch bodies see
Python floats), so new forcing or another ``run(n)`` reuses the library.
The tile and its window follow the skeleton's tile rule
(:func:`.stencil_sweep.tile`) for the planes a sweep stages.

Inside the kernel, per repeat and per call: the call's outputs are
computed into registers over the window inset by the call's own stencil
depth (``sweep::staged_update``: a call may read off-point a plane that
it writes), merged under the call's write mask (decoded from the int8
code planes), and stored after a barrier; a second barrier closes the
call.  Cells near the window edge that a call cannot compute keep their
old values; the schedule's dataflow erosion
(:meth:`~..api.kernel_meta.Schedule.fused_erosion`), which is the ring,
bounds how far they reach, so the output tile is exact on internal
points.

What bounds it: a call costs two barriers and one pass over the window
per repeat, and the NEMOLite2D schedule has 13 calls; like the other
sweeps, it is bound by in-SM work and barriers, not by its bytes (the
light variant of that schedule moves 61 B per point and sweep at f32).

:class:`ScheduleSweepKernel` (one instance, :data:`schedule_sweep`)
builds a generated source through :func:`.cuda_build.load_library`,
launches it and counts the launches.  The plain PyTorch version of the
same sweep is the kernels' torch bodies applied by
``stencil_sweep_reference`` (in ``Schedule._build_fused``).
"""
from __future__ import annotations

import ctypes
import hashlib
import inspect
import keyword
import re
from dataclasses import dataclass

import torch

from . import point_trace
from .stencil_sweep import RING, Shape, tile

_CTYPES = {torch.float32: "float", torch.float64: "double"}
_RESERVED = {"T", "sweep", "int32_t", "int8_t", "size_t"}


@dataclass(frozen=True)
class GeneratedSweep:
    """One generated sweep kernel: its source and what it takes."""
    name: str             # library name, keyed by a hash of the source
    text: str             # the CUDA C++ source
    dtype: torch.dtype
    K: int                # repeats per launch
    ring: int             # ring cells per side of the staged window
    n_state: int          # float planes in and out
    n_aux: int            # float planes in (scratch, read-only, consts)
    n_int: int            # int32 planes in (consts)
    n_codes: int          # int8 mask-code planes
    n_scalars: int        # scalars per repeat
    smem_bytes: int       # dynamic shared memory per CTA
    tile: Shape           # the skeleton's tile and window

    @property
    def n_consts(self) -> int:
        return self.K * max(self.n_scalars, 1)


def _depth(s, reads) -> int:
    """The call's own read depth: the deepest stencil of the field and
    grid-property arguments it reads."""
    return max((a.stencil.depth()
                for (kind, _), a in zip(s["binding"], s["meta"].args)
                if kind in ("f", "c") and reads(a)), default=0)


def _check_name(kname: str, pname: str) -> None:
    if (not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", pname)
            or pname.startswith("sw_") or pname in _RESERVED
            or keyword.iskeyword(pname)):
        raise ValueError(
            f"kernel {kname}: parameter name {pname!r} cannot name a "
            "variable of its CUDA body (names starting with sw_ and "
            f"{sorted(_RESERVED)} are the generator's)")


def window_tile(n_float: int, n_int: int, n_codes: int, ring: int,
                dtype) -> tuple[Shape, int]:
    """``(shape, bytes)``: the skeleton's tile (:func:`.stencil_sweep.tile`)
    for a window of ``n_float`` planes of ``dtype``, ``n_int`` int32
    planes and ``n_codes`` int8 code planes with ``ring`` cells on every
    side, and the window's bytes.  Raises ``ValueError`` where even the
    smallest tile's window does not fit a CTA."""
    bpp = n_float * dtype.itemsize + 4 * n_int + n_codes
    shape = tile(ring, bpp)
    if shape is None:
        raise ValueError(
            f"schedule sweep needs {(8 + 2 * ring) ** 2 * bpp} B of shared "
            f"memory per CTA even on 8-cell tiles (ring {ring}, {n_float} "
            f"float + {n_int} int32 planes, {dtype}), more than a CTA may "
            "take; use fewer repeats or fewer levels")
    return shape, shape.window_bytes(ring, bpp)


def _specs(s, levels, consts, dtype):
    """The point tracer's argument specs and stencils of one call."""
    specs, stencils = [], []
    for (kind, idx), a in zip(s["binding"], s["meta"].args):
        if kind == "r":
            continue
        if kind == "s":
            specs.append(point_trace.ArgSpec(True))
            stencils.append(None)
        else:
            lev = levels[idx] if kind == "f" else 0
            dt = dtype if kind == "f" else consts[idx].dtype
            specs.append(point_trace.ArgSpec(False, dt, lev))
            stencils.append(a.stencil)
    return specs, stencils


def generate(steps, *, state_slots, extra_slots, ro_slots, consts,
             n_masks: int, n_scalars: int, K: int, ring: int,
             dtype, levels=None) -> GeneratedSweep:
    """The CUDA source of one sweep variant of a schedule.

    ``steps`` is the schedule's call plan (``Schedule._steps``);
    ``state_slots`` stream in and out, ``extra_slots`` (scratch) come in
    as float aux planes that the kernel rewrites in shared memory,
    ``ro_slots`` come in read-only, then the float grid-property
    ``consts`` (int32 ones as int planes).  ``levels[si]`` is slot si's
    level count (0: a 2D field); a ``levels=N`` slot takes N consecutive
    planes wherever it lies.  The aux order is the one
    ``Schedule._build_fused`` passes.  A kernel without a hand-written
    CUDA body gets the one :mod:`.point_trace` derives from its torch
    body; what the tracer refuses raises here, before anything is
    built or launched."""
    from ..api.kernel_meta import _is_written, _reads
    if dtype not in _CTYPES:
        raise TypeError(f"the schedule sweep takes float32/float64 "
                        f"fields, got {dtype}")
    if not 0 <= ring <= RING:
        raise ValueError(f"ring {ring} outside [0, {RING}]")
    if levels is None:
        levels = {si: 0 for si in (*state_slots, *extra_slots, *ro_slots)}
    T = _CTYPES[dtype]
    plane = {}       # (kind, index) -> (value type, [plane pointer per level])

    def place(key, vt, arr, start, n):
        plane[key] = (vt, [f"sw_t.{arr}[{start + k}]" for k in range(n)])
        return start + n
    n_state = 0
    for si in state_slots:
        n_state = place(("f", si), "T", "s", n_state, max(levels[si], 1))
    n_aux = 0
    for si in list(extra_slots) + list(ro_slots):
        n_aux = place(("f", si), "T", "a", n_aux, max(levels[si], 1))
    n_int = 0
    for ci, c in enumerate(consts):
        if c.dtype == dtype:
            n_aux = place(("c", ci), "T", "a", n_aux, 1)
        elif c.dtype == torch.int32:
            n_int = place(("c", ci), "int32_t", "ai", n_int, 1)
        else:
            raise NotImplementedError(
                f"grid-property plane of dtype {c.dtype} in a {dtype} "
                "schedule sweep (it takes the fields' dtype and int32)")
    n_codes = -(-n_masks // 8)
    shape, smem = window_tile(n_state + n_aux, n_int, n_codes, ring, dtype)
    reach = max(-(-ring // K), 1)

    calls = []
    for ci, s in enumerate(steps):
        meta = s["meta"]
        pairs = [(b, a) for b, a in zip(s["binding"], meta.args)
                 if b[0] != "r"]
        if meta.cuda is not None:
            names = list(inspect.signature(s["fn"]).parameters)
            if len(names) != len(pairs):
                raise ValueError(
                    f"kernel {meta.name}: {len(names)} parameters for "
                    f"{len(pairs)} non-reduction arguments")
            for pname in names:
                _check_name(meta.name, pname)
        else:
            names = [f"sw_a{i}" for i in range(len(pairs))]
        written_names = {}
        lines = []
        for pname, ((kind, idx), a) in zip(names, pairs):
            if kind == "s":
                lines.append(f"const double {pname} = sw_sc[{idx}];")
        d = _depth(s, _reads)
        uniq = []
        for si, _ in s["written"]:
            if si not in uniq:
                uniq.append(si)
        dst = [p for si in uniq for p in plane[("f", si)][1]]
        nw = len(dst)
        lines.append(f"{T}* const sw_dst[{nw}] = {{{', '.join(dst)}}};")
        lines.append(
            f"sweep::staged_update<G, {T}, {nw}>(sweep::inset<G>({d}, "
            f"{d}), sw_dst, [&](int sw_i, int, int, {T} (&sw_o)[{nw}]) {{")
        inner = []
        wit = iter(s["written"])
        written_args = []
        for pname, ((kind, idx), a) in zip(names, pairs):
            if kind == "s":
                continue
            vt, ptrs = plane[(kind, idx)]
            nlev = levels[idx] if kind == "f" else 0
            if kind == "f" and _is_written(a):
                si, mi = next(wit)
                written_names.setdefault(si, []).append((pname, mi))
                written_args.append((pname, nlev, dtype))
                if nlev:
                    olds = ", ".join(f"{p}[sw_i]" for p in ptrs)
                    inner.append(f"sweep::LevPut<{vt}, G::WX, G::WC, {nlev}> "
                                 f"{pname}{{{{{ptrs[0]} + sw_i}}, "
                                 f"{{{olds}}}}};")
                else:
                    inner.append(f"sweep::Put<{vt}, G::WX> {pname}{{{{"
                                 f"{ptrs[0]} + sw_i}}, {ptrs[0]}[sw_i]}};")
            elif nlev:
                inner.append(f"const sweep::Lev<{vt}, G::WX, G::WC, {nlev}> "
                             f"{pname}{{{ptrs[0]} + sw_i}};")
            else:
                inner.append(f"const sweep::At<{vt}, G::WX> {pname}"
                             f"{{{ptrs[0]} + sw_i}};")
        if meta.cuda is not None:
            text, how = meta.cuda.strip(), "hand-written"
        else:
            specs, stencils = _specs(s, levels, consts, dtype)
            rec = point_trace.trace(s["fn"], meta.name, specs, stencils)
            text, how = point_trace.cuda_body(rec, names, written_args), \
                "derived"
        inner.append("{")
        inner.extend("  " + ln for ln in text.splitlines())
        inner.append("}")
        k = 0
        for si in uniq:
            for lv, ptr in enumerate(plane[("f", si)][1]):
                inner.append(f"{T} sw_v{k} = {ptr}[sw_i];")
                for pname, mi in written_names[si]:
                    val = f"{pname}.v[{lv}]" if levels[si] else f"{pname}.v"
                    inner.append(f"sw_v{k} = sw_t.bit_set(sw_i, {mi // 8}, "
                                 f"{mi % 8}) ? {val} : sw_v{k};")
                inner.append(f"sw_o[{k}] = sw_v{k};")
                k += 1
        lines.extend("  " + ln for ln in inner)
        lines.append("});")
        lines.append("__syncthreads();")
        calls.append((ci, f"{meta.name} ({how})", d, lines))

    body = []
    for ci, kname, d, lines in calls:
        body.append(f"    // call {ci}: {kname} (read depth {d})")
        body.append("    {")
        body.extend("      " + ln for ln in lines)
        body.append("    }")
    nsc = max(n_scalars, 1)
    summary = ", ".join(k for _, k, _, _ in calls)
    text = f"""\
// Generated by dl_esm_inf_tpu_torch/ops/schedule_sweep.py from a kernel
// schedule; do not edit.  The fused schedule sweep of:
//   {summary}
// {T}, K = {K} repeats, ring {ring}, {shape.ty}x{shape.tx} tiles in a
// {shape.wx}-column window; {n_state} state
// planes, {n_aux} float and {n_int} int32 aux planes, {n_codes} mask-code
// plane(s); {n_scalars} scalars per repeat.
#include "point_ops.cuh"
#include "stencil_sweep.cuh"

namespace {{

struct Consts {{
  double sc[{K}][{nsc}];
}};

struct Step {{
  using T = {T};
  static constexpr int K = {K};
  static constexpr int N = {n_state}, M = {n_aux};
  static constexpr bool CODE = true;
  using Tile = sweep::Tile<T, N, M, CODE, sweep::Ring<K, {reach}, {ring}>,
                           {n_int}, {n_codes}>;
  using G = Tile::G;
  using Consts = ::Consts;

  const Consts* sw_c;

  __device__ explicit Step(const Consts& c) : sw_c(&c) {{}}

  __device__ void substep(Tile& sw_t, int sw_k) const {{
    const double* const sw_sc = sw_c->sc[sw_k];
{chr(10).join(body)}
  }}
}};

}}  // namespace

extern "C" {{

// Number of doubles schedule_sweep_launch expects in `consts`: K rows of
// the schedule's scalars.
int schedule_sweep_num_consts() {{ return sweep::num_consts<Consts>(); }}

// in/out: N state planes; aux: M float planes; auxi: the int32 planes;
// code: the mask-code planes, one after another; all contiguous (ny, nx)
// device arrays.  Launches on `stream` and returns cudaGetLastError().
int schedule_sweep_launch(const void* const* in, void* const* out,
                          const void* const* aux, const void* const* auxi,
                          const void* code, int ny, int nx,
                          const double* consts, int n_consts,
                          void* stream) {{
  if (n_consts != sweep::num_consts<Consts>() || ny < 1 || nx < 1) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  using T = Step::T;
  sweep::PlanesOf<Step> p;
  for (int f = 0; f < Step::N; ++f) {{
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }}
  p.aux[0] = nullptr;
  for (int f = 0; f < Step::M; ++f) p.aux[f] = static_cast<const T*>(aux[f]);
{"".join(f"  p.auxi[{f}] = static_cast<const int32_t*>(auxi[{f}]);{chr(10)}"
         for f in range(n_int))}\
  p.code = static_cast<const int8_t*>(code);
  p.ny = ny;
  p.nx = nx;
  Consts c;
  double* dst = reinterpret_cast<double*>(&c);
  for (int i = 0; i < n_consts; ++i) dst[i] = consts[i];
  return static_cast<int>(
      sweep::launch<Step>(p, c, static_cast<cudaStream_t>(stream)));
}}

}}  // extern "C"
"""
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    return GeneratedSweep(
        name=f"schedule_sweep_{digest}", text=text, dtype=dtype, K=K,
        ring=ring, n_state=n_state, n_aux=n_aux, n_int=n_int,
        n_codes=n_codes, n_scalars=n_scalars, smem_bytes=smem, tile=shape)


class ScheduleSweepKernel:
    """ctypes wrapper of the generated schedule sweeps.

    ``launches`` counts the launches of every generated sweep made
    through this wrapper (and nothing else); callers may reset it."""

    def __init__(self):
        self.launches = 0
        self._fns: dict = {}

    def build(self, gen: GeneratedSweep):
        """Build (once) and bind one generated kernel; returns its
        BuiltLibrary."""
        from .cuda_build import load_library
        built = load_library(gen.name, generated=gen.text)
        if gen.name not in self._fns:
            fn = built.lib.schedule_sweep_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            nconst = built.lib.schedule_sweep_num_consts
            nconst.argtypes = []
            nconst.restype = ctypes.c_int
            if nconst() != gen.n_consts:
                raise RuntimeError(f"{gen.name}: library takes {nconst()} "
                                   f"constants, expected {gen.n_consts}")
            self._fns[gen.name] = fn
        return built

    @staticmethod
    def _check(gen, state, aux, auxi, codes, rows):
        if (len(state) != gen.n_state or len(aux) != gen.n_aux
                or len(auxi) != gen.n_int):
            raise ValueError(
                f"{gen.name}: expected {gen.n_state} state, {gen.n_aux} "
                f"float and {gen.n_int} int32 planes, got {len(state)}, "
                f"{len(aux)} and {len(auxi)}")
        if len(rows) != gen.K or any(len(r) != gen.n_scalars
                                     for r in rows):
            raise ValueError(
                f"{gen.name}: expected {gen.K} rows of {gen.n_scalars} "
                "scalars")
        ref = state[0]
        if ref.device.type != "cuda":
            raise ValueError(f"{gen.name} needs CUDA tensors, got "
                             f"{ref.device}")
        if ref.dim() != 2:
            raise ValueError(f"expected (ly, lx) planes, got "
                             f"{tuple(ref.shape)}")
        named = ([(f"state[{i}]", t, gen.dtype, ref.shape)
                  for i, t in enumerate(state)]
                 + [(f"aux[{i}]", t, gen.dtype, ref.shape)
                    for i, t in enumerate(aux)]
                 + [(f"auxi[{i}]", t, torch.int32, ref.shape)
                    for i, t in enumerate(auxi)]
                 + [("mask_codes", codes, torch.int8,
                     (gen.n_codes,) + tuple(ref.shape))])
        for name, t, dt, shape in named:
            if (t.device != ref.device or t.dtype != dt
                    or tuple(t.shape) != tuple(shape)):
                raise ValueError(
                    f"{name}: expected {dt} {tuple(shape)} on "
                    f"{ref.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def __call__(self, gen: GeneratedSweep, state, aux, auxi, codes, rows):
        """One sweep of ``gen``: ``rows`` holds K rows of the schedule's
        scalars; returns the new state planes."""
        state, aux, auxi = tuple(state), tuple(aux), tuple(auxi)
        self._check(gen, state, aux, auxi, codes, rows)
        self.build(gen)
        flat = [float(v) for r in rows for v in r] if gen.n_scalars \
            else [0.0] * gen.K
        out = tuple(torch.empty_like(s) for s in state)

        def ptrs(ts):
            return (ctypes.c_void_p * max(len(ts), 1))(
                *(t.data_ptr() for t in ts))
        ny, nx = state[0].shape
        err = self._fns[gen.name](
            ptrs(state), ptrs(out), ptrs(aux), ptrs(auxi), codes.data_ptr(),
            ny, nx, (ctypes.c_double * len(flat))(*flat), len(flat),
            torch.cuda.current_stream(state[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{gen.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out


#: the wrapper of every generated schedule sweep
schedule_sweep = ScheduleSweepKernel()
