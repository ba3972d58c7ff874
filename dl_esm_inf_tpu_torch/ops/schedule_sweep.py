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
(:func:`.stencil_sweep.tile`) for the planes a sweep stages.  A window
that does not fit a CTA's shared memory even on 8-cell tiles (a chain of
many levels) takes the skeleton's cluster form instead: the same
generated body on a window split by rows over the CTAs of a thread-block
cluster, each CTA's band in its own shared memory, rows of another band
read from its CTA's (the tile of :func:`.stencil_sweep.cluster_tile`; the
passes' barriers are cluster barriers).  Only a window past the largest
cluster takes the scratch form: the window in a per-CTA slice of a
device buffer, CTAs that take the tiles in turn, the tile of
:func:`.stencil_sweep.scratch_tile`.  The form follows from the window's
size alone (:func:`window_tile` says which form a window takes, and
:attr:`GeneratedSweep.form` which one a sweep took).

Inside the kernel the calls run by a :class:`Plan` that :func:`plan`
works out from the schedule's dataflow (the bindings and stencil depths
that :meth:`~..api.kernel_meta.Schedule.fused_erosion` walks):

* a call that reads each plane it writes only at its own point computes
  and stores in place; one that reads such a plane off-point computes
  into registers and stores after a barrier (staged,
  ``sweep::staged_points``);
* consecutive in-place calls share one pass over the window, running one
  after another at each point (``sweep::for_points``); a point has the
  same thread in every pass, so a call reads what earlier calls stored
  at its own point without a barrier.  A pass loads its scalars once
  (what a body folds from them alone leaves the point loop) and each
  point's mask-code bytes once.  A barrier comes between two calls only
  where the later one reads off-point a plane written since the last
  barrier, or writes a plane read off-point since then (grid properties
  and read-only slots are never written, so they force none); a barrier
  ends each repeat;
* each call computes, in each repeat, only the region its later readers
  and the output tile need (the tile grown by a margin, walking the K
  repeats backwards; never more than the window inset by its depth),
  merged under its write mask (decoded from the int8 code planes).
  Cells it does not compute keep their old values, which nothing that
  reaches the output tile reads, so the tile is exact on internal
  points.

For the NEMOLite2D schedule that is 4 passes and 4 barriers per repeat
(13 calls, of which none reads off-point a plane it writes), where one
pass and two barriers per call took 13 and 26.

What bounds it: like the other sweeps, staging and in-SM work, not its
bytes (the light variant of that schedule moves 61 B per point and
sweep at f32, 19.69 µs at 1024² against 48.3-48.5 µs measured on an
H100).

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
from .stencil_sweep import (RING, Shape, band_rows, cluster_tile,
                            scratch_tile, tile)

_CTYPES = {torch.float32: "float", torch.float64: "double"}

#: the scratch form's threads a CTA, and the most device memory the
#: windows of all its CTAs may take: a launch takes every CTA that can be
#: resident (3 an SM at 29 levels, 190 MB of windows), as long as their
#: windows fit.  On an H100 that beat keeping the windows in the 50 MB
#: L2 with fewer CTAs (6.85 ms a sweep against 14.21 at 32 MiB; 512
#: threads were no faster; PERF.md §6, row 10)
SCRATCH_THREADS = 256
SCRATCH_BYTES = 1 << 30
#: the cluster form's threads a CTA (one CTA an SM; a band of the
#: window has at most a few hundred points; 512 were slower, PERF.md §6)
CLUSTER_THREADS = 256
_RESERVED = {"T", "sweep", "int32_t", "int8_t", "size_t"}


@dataclass(frozen=True)
class Plan:
    """How a generated sweep runs a schedule's calls in each repeat.

    ``passes`` holds the calls of each pass in order (the calls between
    two barriers), the same in every repeat; ``barrier_before[p]`` says
    whether a barrier precedes pass p.  A call that is not ``in_place`` makes a pass of its
    own with a barrier inside (between its computation and its stores).
    ``margins[k][c]`` is the cells around the output tile that call c
    computes in repeat k (None: nothing later reads what it would
    compute there); ``depths[c]`` its own read depth, so it never
    computes beyond the window inset by that depth."""
    names: tuple          # kernel name per call
    in_place: tuple       # per call
    depths: tuple         # per call
    passes: tuple         # per pass: the calls it runs, in order
    barrier_before: tuple  # per pass
    margins: tuple        # [repeat][call] -> int or None

    @property
    def barriers(self) -> int:
        """Barriers per repeat: before passes, inside the staged calls,
        and the one that ends the repeat."""
        return (sum(self.barrier_before)
                + sum(1 for f in self.in_place if not f) + 1)

    def box(self, k: int, c: int, shape: Shape, ring: int):
        """``(y0, y1, x0, x1)``, half open, in window points: what call c
        computes in repeat k on a window of ``shape`` and ``ring`` (as the
        kernel's ``sweep::around``); None where it computes nothing."""
        m, d = self.margins[k][c], self.depths[c]
        if m is None:
            return None
        wy, wx = shape.ty + 2 * ring, shape.wx
        return (max(ring - m, d), min(ring + shape.ty + m, wy - d),
                max(shape.rl - m, d), min(shape.rl + shape.tx + m, wx - d))

    def summary(self) -> str:
        """The plan in one line, as the generated source states it."""
        staged = sum(1 for f in self.in_place if not f)
        return (f"{len(self.passes)} passes and {self.barriers} barriers "
                f"per repeat; {len(self.in_place) - staged} of "
                f"{len(self.in_place)} calls in place")


def _uniq_written(s) -> list:
    out = []
    for si, _ in s["written"]:
        if si not in out:
            out.append(si)
    return out


def plan(steps, *, K: int, ring: int, state_slots) -> Plan:
    """The plan of a sweep of ``steps`` (``Schedule._steps``) repeated K
    times in a window of ``ring`` cells, whose outputs are the slots
    ``state_slots`` (every other written slot, a scratch slot, is needed
    only by later calls).

    Barriers: walking one repeat's calls, a barrier goes before a call
    that reads off-point a slot written since the last barrier (read
    after write) or that writes a slot read off-point since then (write
    after read); a call that reads off-point a slot it writes is staged
    (a pass of its own, its stores after a barrier, so only the first
    hazard applies to it).  Regions: walking the K repeats backwards from
    the output tile (every state slot needed at margin 0), a call
    computes the largest margin at which one of its written slots is
    still needed, and needs each slot it reads at that margin plus the
    argument's stencil depth (a written slot stays needed where it was:
    the masked merge keeps old values).  Raises ``ValueError`` where a
    region and its depth would leave the ring (the ring is smaller than
    the schedule's erosion)."""
    from ..api.kernel_meta import _reads
    names, in_place, depths, reads_off, writes = [], [], [], [], []
    for s in steps:
        w = set(_uniq_written(s))
        off = {idx for (kind, idx), a in zip(s["binding"], s["meta"].args)
               if kind == "f" and _reads(a) and a.stencil.reaches_off_point()}
        names.append(s["meta"].name)
        writes.append(w)
        reads_off.append(off)
        in_place.append(not (off & w))
        depths.append(_depth(s, _reads))

    passes, barrier_before = [], []
    written, read_off = set(), set()
    for c in range(len(steps)):
        raw = bool(reads_off[c] & written)
        war = bool(writes[c] & read_off)
        if not in_place[c]:
            passes.append([c])
            barrier_before.append(raw)
            written, read_off = set(writes[c]), set()
            continue
        if raw or war or not passes or not in_place[passes[-1][0]]:
            passes.append([])
            barrier_before.append(raw or war)
            if raw or war:
                written, read_off = set(), set()
        passes[-1].append(c)
        written |= writes[c]
        read_off |= reads_off[c]

    need = {si: 0 for si in state_slots}
    margins = []
    for _ in range(int(K)):
        row = [None] * len(steps)
        for c in reversed(range(len(steps))):
            ms = [need[si] for si in writes[c] if si in need]
            if not ms:
                continue
            m = max(ms)
            if m + depths[c] > ring:
                raise ValueError(
                    f"call {c} ({names[c]}) needs {m + depths[c]} ring "
                    f"cells, the window has {ring}")
            row[c] = m
            s = steps[c]
            for (kind, idx), a in zip(s["binding"], s["meta"].args):
                if kind == "f" and _reads(a):
                    need[idx] = max(need.get(idx, 0), m + a.stencil.depth())
        margins.append(tuple(row))
    return Plan(names=tuple(names), in_place=tuple(in_place),
                depths=tuple(depths),
                passes=tuple(tuple(p) for p in passes),
                barrier_before=tuple(barrier_before),
                margins=tuple(reversed(margins)))


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
    smem_bytes: int       # dynamic shared memory per CTA (0: scratch)
    tile: Shape           # the skeleton's tile and window
    plan: Plan            # passes, barriers and regions of each repeat
    form: str = "shared"  # the window in one CTA's "shared" memory, in a
    #                       "cluster"'s, or in a device buffer ("scratch")
    window_bytes: int = 0  # the whole window, in any form
    cluster: int = 1      # CTAs that hold one window (0: scratch form)

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
                dtype) -> tuple[Shape, int, int]:
    """``(shape, bytes, cluster)``: the skeleton's tile
    (:func:`.stencil_sweep.tile`) for a window of ``n_float`` planes of
    ``dtype``, ``n_int`` int32 planes and ``n_codes`` int8 code planes
    with ``ring`` cells on every side, the window's bytes, and the CTAs
    that hold it: 1, the shared form.  Where even the smallest tile's
    window does not fit a CTA's shared memory, the cluster form's tile
    (:func:`.stencil_sweep.cluster_tile`, ``ctas`` 0) and its cluster's
    CTAs (4-16);
    past the largest cluster, the scratch form's tile
    (:func:`.stencil_sweep.scratch_tile`, ``ctas`` 0) and 0, its window
    in global memory."""
    bpp = n_float * dtype.itemsize + 4 * n_int + n_codes
    shape, cluster = tile(ring, bpp), 1
    if shape is None:
        shape, cluster = cluster_tile(ring, bpp) or (scratch_tile(ring), 0)
    return shape, shape.window_bytes(ring, bpp), cluster


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
    pl = plan(steps, K=K, ring=ring, state_slots=state_slots)
    shape, window, cluster = window_tile(n_state + n_aux, n_int, n_codes,
                                         ring, dtype)
    form = {0: "scratch", 1: "shared"}.get(cluster, "cluster")
    scratch, band = form == "scratch", form == "cluster"
    # dynamic shared memory a CTA: the window, the rows of a band, or none
    smem = (window // (shape.ty + 2 * ring) * band_rows(shape, ring, cluster)
            if band else 0 if scratch else window)
    reach = max(-(-ring // K), 1)
    # the scalars each call reads: a pass loads them into registers once,
    # so that what a body folds from them alone leaves its point loop
    scalars_used = [set() for _ in steps]
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
                lines.append(f"const double {pname} = sw_s{idx};")
                scalars_used[ci].add(idx)
        uniq = _uniq_written(s)
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
                if nlev and band:
                    olds = ", ".join(f"{p}[sw_i]" for p in ptrs)
                    lines.append(f"sweep::BandLevPut<{vt}, G, {nlev}> "
                                 f"{pname}{{{{{ptrs[0]} + sw_i, sw_y}}, "
                                 f"{{{olds}}}}};")
                elif nlev:
                    olds = ", ".join(f"{p}[sw_i]" for p in ptrs)
                    lines.append(f"sweep::LevPut<{vt}, G::WX, G::WC, {nlev}> "
                                 f"{pname}{{{{{ptrs[0]} + sw_i}}, "
                                 f"{{{olds}}}}};")
                elif band:
                    lines.append(f"sweep::BandPut<{vt}, G> {pname}{{{{"
                                 f"{ptrs[0]} + sw_i, sw_y}}, "
                                 f"{ptrs[0]}[sw_i]}};")
                else:
                    lines.append(f"sweep::Put<{vt}, G::WX> {pname}{{{{"
                                 f"{ptrs[0]} + sw_i}}, {ptrs[0]}[sw_i]}};")
            elif nlev and band:
                lines.append(f"const sweep::BandLev<{vt}, G, {nlev}> "
                             f"{pname}{{{ptrs[0]} + sw_i, sw_y}};")
            elif nlev:
                lines.append(f"const sweep::Lev<{vt}, G::WX, G::WC, {nlev}> "
                             f"{pname}{{{ptrs[0]} + sw_i}};")
            elif band:
                lines.append(f"const sweep::BandAt<{vt}, G> {pname}"
                             f"{{{ptrs[0]} + sw_i, sw_y}};")
            else:
                lines.append(f"const sweep::At<{vt}, G::WX> {pname}"
                             f"{{{ptrs[0]} + sw_i}};")
        if meta.cuda is not None:
            text, how = meta.cuda.strip(), "hand-written"
        else:
            specs, stencils = _specs(s, levels, consts, dtype)
            rec = point_trace.trace(s["fn"], meta.name, specs, stencils)
            text, how = point_trace.cuda_body(rec, names, written_args), \
                "derived"
        lines.append("{")
        lines.extend("  " + ln for ln in text.splitlines())
        lines.append("}")
        # the merge under the write masks into sw_o, which the pass
        # stores at once (in place) or after a barrier (staged)
        k = 0
        for si in uniq:
            for lv, ptr in enumerate(plane[("f", si)][1]):
                lines.append(f"{T} sw_v{k} = {ptr}[sw_i];")
                for pname, mi in written_names[si]:
                    val = f"{pname}.v[{lv}]" if levels[si] else f"{pname}.v"
                    lines.append(f"sw_v{k} = ((sw_cd{mi // 8} >> {mi % 8}) "
                                 f"& 1) ? {val} : sw_v{k};")
                lines.append(f"sw_o[{k}] = sw_v{k};")
                k += 1
        dst = [p for si in uniq for p in plane[("f", si)][1]]
        codes = sorted({mi // 8 for _, mi in s["written"]})
        calls.append((f"{meta.name} ({how})", dst,
                      [f"// call {ci}: {meta.name} ({how}) (read depth "
                       f"{pl.depths[ci]})"] + lines, codes))

    def code_loads(planes, indent):
        """The mask-code bytes of a point, once for the calls that merge
        with them."""
        return [f"{indent}const int sw_cd{c} = sw_t.code[{c} * G::WC + "
                f"sw_i];" for c in planes]

    # the cluster form's barriers order what the cluster's CTAs read
    sync = "sweep::cluster_sync();" if band else "__syncthreads();"
    body = []
    for pi, (cs, bar) in enumerate(zip(pl.passes, pl.barrier_before)):
        staged = not pl.in_place[cs[0]]
        body.append(f"    // pass {pi}: calls {list(cs)}, "
                    + ("staged" if staged else "in place"))
        if bar:
            body.append(f"    {sync}")
        body.append("    {")
        body.extend(f"      const double sw_s{i} = sw_sc[{i}];"
                    for i in sorted(set().union(
                        *(scalars_used[c] for c in cs))))
        for c in cs:
            body.append(f"      const sweep::Box sw_b{c} = sweep::around<G>("
                        f"sw_m[sw_k][{c}], {pl.depths[c]});")
        hull = f"sw_b{cs[0]}"
        for c in cs[1:]:
            hull = f"sweep::hull({hull}, sw_b{c})"
        if staged:
            kname, dst, lines, codes = calls[cs[0]]
            body.append(f"      {T}* const sw_dst[{len(dst)}] = "
                        f"{{{', '.join(dst)}}};")
            body.append(f"      sweep::staged_points<G, {T}, {len(dst)}>("
                        f"sw_b{cs[0]}, sw_dst, [&](int sw_i, "
                        f"{'int sw_y' if band else 'int'}, int, "
                        f"{T} (&sw_o)[{len(dst)}]) {{")
            body.extend(code_loads(codes, "        "))
            body.extend("        " + ln for ln in lines)
            body.append("      });")
        else:
            body.append(f"      sweep::for_points<G>({hull}, [&](int sw_i, "
                        "int sw_y, int sw_x) {")
            body.extend(code_loads(sorted(set().union(
                *(calls[c][3] for c in cs))), "        "))
            for c in cs:
                kname, dst, lines, codes = calls[c]
                body.append(f"        if (sweep::inside(sw_b{c}, sw_y, "
                            "sw_x)) {")
                body.append(f"          {T} sw_o[{len(dst)}];")
                body.append("          {")
                body.extend("            " + ln for ln in lines)
                body.append("          }")
                body.extend(f"          {d}[sw_i] = sw_o[{k}];"
                            for k, d in enumerate(dst))
                body.append("        }")
            body.append("      });")
        body.append("    }")
    body.append(f"    {sync}")
    margins = ",\n        ".join(
        "{" + ", ".join(str(-1 if m is None else m) for m in row) + "}"
        for row in pl.margins)
    nsc = max(n_scalars, 1)
    summary = ", ".join(c[0] for c in calls)
    in_place = ", ".join(str(c) for c, f in enumerate(pl.in_place) if f)
    # the cluster form: the window's rows over a cluster's CTAs, a
    # persistent grid of clusters; the scratch form: the window in a slice
    # of a device buffer per CTA, a persistent grid (the shared form's
    # source is as it was before either)
    ring_type = {"scratch": "ScratchRing", "cluster": "ClusterRing"}.get(
        form, "Ring")
    nt = {"scratch": f", {SCRATCH_THREADS}",
          "cluster": f", {CLUSTER_THREADS}"}.get(form, "")
    form_note = {
        "scratch": (f"// The window ({window} B per CTA) exceeds shared "
                    "memory: the scratch form,\n// in a device buffer of "
                    "schedule_sweep_scratch_stride() B per CTA.\n"),
        "cluster": (f"// The window ({window} B) exceeds a CTA's shared "
                    "memory: the cluster form, its\n// rows split over the "
                    f"{cluster} CTAs of a thread-block cluster ({smem} B "
                    "each).\n")
    }.get(form, "")
    form_entries = {"scratch": """
// Bytes of one CTA's slice of the scratch buffer, and the CTAs a (ny, nx)
// block launches with their windows in `cap` bytes (-1 on a CUDA error).
size_t schedule_sweep_scratch_stride() {
  return sweep::scratch_stride<Step>();
}
int schedule_sweep_ctas(int ny, int nx, long long cap) {
  return sweep::scratch_ctas<Step>(ny, nx, cap);
}
""", "cluster": """
// The clusters a (ny, nx) block launches: one per tile, at most those
// resident at once (0: none can be; -1 on a CUDA error).
int schedule_sweep_clusters(int ny, int nx) {
  return sweep::cluster_count<Step>(ny, nx);
}
"""}.get(form, "")
    scratch_params = ("void* scratch, int ctas,\n                          "
                      if scratch else "")
    launch_call = {
        "scratch": ("sweep::launch_scratch<Step>(\n          p, c, scratch, "
                    "ctas, static_cast<cudaStream_t>(stream))"),
        "cluster": ("sweep::launch_cluster<Step>(\n          p, c, "
                    "static_cast<cudaStream_t>(stream))")}.get(
        form, "sweep::launch<Step>(p, c, static_cast<cudaStream_t>(stream))")
    text = f"""\
// Generated by dl_esm_inf_tpu_torch/ops/schedule_sweep.py from a kernel
// schedule; do not edit.  The fused schedule sweep of:
//   {summary}
// {T}, K = {K} repeats, ring {ring}, {shape.ty}x{shape.tx} tiles in a
// {shape.wx}-column window; {n_state} state
// planes, {n_aux} float and {n_int} int32 aux planes, {n_codes} mask-code
// plane(s); {n_scalars} scalars per repeat.
// Plan: {pl.summary()}
{form_note}// (in place: calls {in_place or "none"}); passes (calls, barrier before):
//   {"; ".join(f"{list(p)}{' B' if b else ''}"
               for p, b in zip(pl.passes, pl.barrier_before))}
// Regions: call c computes the tile grown by sw_m[k][c] cells in repeat
// k (-1: nothing).
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
  using Tile = sweep::Tile<T, N, M, CODE, sweep::{ring_type}<K, {reach}, {ring}{nt}>,
                           {n_int}, {n_codes}>;
  using G = Tile::G;
  using Consts = ::Consts;

  const Consts* sw_c;

  __device__ explicit Step(const Consts& c) : sw_c(&c) {{}}

  __device__ __forceinline__ void substep(Tile& sw_t, int sw_k) const {{
    const double* const sw_sc = sw_c->sc[sw_k];
    constexpr int sw_m[{K}][{len(steps)}] = {{
        {margins}}};
{chr(10).join(body)}
  }}
}};

}}  // namespace

extern "C" {{

// Number of doubles schedule_sweep_launch expects in `consts`: K rows of
// the schedule's scalars.
int schedule_sweep_num_consts() {{ return sweep::num_consts<Consts>(); }}
{form_entries}
// in/out: N state planes; aux: M float planes; auxi: the int32 planes;
// code: the mask-code planes, one after another; all contiguous (ny, nx)
// device arrays.  Launches on `stream` and returns cudaGetLastError().
int schedule_sweep_launch(const void* const* in, void* const* out,
                          const void* const* aux, const void* const* auxi,
                          const void* code, int ny, int nx,
                          const double* consts, int n_consts,
                          {scratch_params}void* stream) {{
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
      {launch_call});
}}

}}  // extern "C"
"""
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    return GeneratedSweep(
        name=f"schedule_sweep_{digest}", text=text, dtype=dtype, K=K,
        ring=ring, n_state=n_state, n_aux=n_aux, n_int=n_int,
        n_codes=n_codes, n_scalars=n_scalars,
        smem_bytes=smem, tile=shape, plan=pl, form=form,
        window_bytes=window, cluster=cluster)


class ScheduleSweepKernel:
    """ctypes wrapper of the generated schedule sweeps.

    ``launches`` counts the launches of every generated sweep made
    through this wrapper (and nothing else); callers may reset it.
    ``generated`` holds every source built, by name.  A sweep of the
    cluster form launches the clusters its library asks for, and raises
    where the device refuses them.  A sweep of the scratch form runs on
    one buffer per device, grown on demand and kept (the wrapper's sweeps
    on one device run one after another on the current stream)."""

    def __init__(self):
        self.launches = 0
        self.generated: dict = {}
        self._fns: dict = {}
        self._scratch: dict = {}        # device -> uint8 buffer

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
                           *((ctypes.c_void_p, ctypes.c_int)
                             if gen.form == "scratch" else ()),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            if gen.form == "cluster":
                built.lib.schedule_sweep_clusters.argtypes = [
                    ctypes.c_int, ctypes.c_int]
                built.lib.schedule_sweep_clusters.restype = ctypes.c_int
            if gen.form == "scratch":
                built.lib.schedule_sweep_scratch_stride.restype = \
                    ctypes.c_size_t
                built.lib.schedule_sweep_ctas.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                built.lib.schedule_sweep_ctas.restype = ctypes.c_int
            nconst = built.lib.schedule_sweep_num_consts
            nconst.argtypes = []
            nconst.restype = ctypes.c_int
            if nconst() != gen.n_consts:
                raise RuntimeError(f"{gen.name}: library takes {nconst()} "
                                   f"constants, expected {gen.n_consts}")
            self._fns[gen.name] = fn
            self.generated[gen.name] = gen
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
        extra = ()
        if gen.form == "scratch":
            extra = self._scratch_args(gen, state[0].device, ny, nx)
        err = self._fns[gen.name](
            ptrs(state), ptrs(out), ptrs(aux), ptrs(auxi), codes.data_ptr(),
            ny, nx, (ctypes.c_double * len(flat))(*flat), len(flat), *extra,
            torch.cuda.current_stream(state[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{gen.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out

    def _scratch_args(self, gen, device, ny: int, nx: int):
        """``(buffer pointer, CTAs)`` of one scratch-form launch on an
        (ny, nx) block: the CTAs the library asks for within
        SCRATCH_BYTES, each with its slice of the device's buffer."""
        lib = self.build(gen).lib
        ctas = lib.schedule_sweep_ctas(ny, nx, SCRATCH_BYTES)
        if ctas < 1:
            raise RuntimeError(f"{gen.name}: the scratch form's CTA count "
                               f"failed ({ctas})")
        need = ctas * lib.schedule_sweep_scratch_stride()
        buf = self._scratch.get(device)
        if buf is None or buf.numel() < need:
            buf = torch.empty(need, dtype=torch.uint8, device=device)
            self._scratch[device] = buf
        return buf.data_ptr(), ctas


#: the wrapper of every generated schedule sweep
schedule_sweep = ScheduleSweepKernel()
