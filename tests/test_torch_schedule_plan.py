"""The generated schedule sweep's plan, on the CPU.

``ops/schedule_sweep.py::plan`` works out from a schedule's dataflow how
the generated kernel runs its calls: which compute in place, which share
a pass over the window, where the barriers go, and what region each
call computes in each repeat.  For the NEMOLite2D (PSy) schedule at
repeats 1-3, the levels=N schedules of ``level_schedules.py`` and seeded
generic schedules of shifts, on every variant the fused tier builds:

* no pass holds a read-after-write or write-after-read hazard between
  two of its calls (a staged call's stores follow its own barrier);
* the regions cover what their readers and the output tile need: a
  forward walk of which window cells hold exact values (a computed cell
  needs its reads exact over the stencil's depth and its old value,
  which the masked merge keeps) leaves every state plane exact on the
  tile;
* the NEMOLite2D schedule takes at most 6 barriers per repeat (4), and
  its generated source states the plan;
* a plan emulator, which applies the kernels' torch bodies pass by pass
  and region by region on each tile's staged window, at float64, equals
  the plain fused tier (held against the JAX package in
  tests/test_torch_schedule.py) on internal points, bitwise.

The generated kernels themselves run in tests/test_torch_gpu.py and
``chip_smoke.py`` phase 10.
"""
import functools
import types

import numpy as np
import pytest
import torch

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch import level_schedules as sc
from dl_esm_inf_tpu_torch.api import kernel_meta as tkm
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
from dl_esm_inf_tpu_torch.ops import schedule_sweep as tss
from dl_esm_inf_tpu_torch.ops import stencil_sweep as sst
from dl_esm_inf_tpu_torch.ops import stencils as tst

torch.set_num_threads(2)

F64 = torch.float64

#: (stencil rows, torch shift) of the generic schedules' shift kernels
SHIFTS = {
    "E": ((0, 11, 0), tst.xp),
    "W": ((0, 110, 0), tst.xm),
    "N": ((10, 10, 0), tst.yp),
    "S": ((0, 10, 10), tst.ym),
    "EE": ((0, 12, 0), lambda a: tst.xp(tst.xp(a))),
}


@functools.lru_cache(maxsize=None)
def _shift(name, space):
    rows, fn = SHIFTS[name]
    args = [tkm.Arg(tkm.GO_WRITE, tkm.GO_CT),
            tkm.Arg(tkm.GO_READ, tkm.GO_CT, tkm.Stencil(*rows)),
            tkm.Arg(tkm.GO_READ, tkm.GO_R_SCALAR)]

    @tkm.kernel(args=args, iterates_over=space, name=f"shift_{name}_{space}")
    def shift_plus(out, x, a):
        return fn(x) + a
    return shift_plus


@tkm.kernel(args=[tkm.Arg(tkm.GO_READWRITE, tkm.GO_CT)], name="halve",
            iterates_over=tkm.GO_ALL_PTS)
def _halve(b):
    return b * 0.5 + 21.0


def _grid(nx, ny, ndom, halo, wrap=False):
    bc = tdl.BC_PERIODIC if wrap else tdl.BC_EXTERNAL
    g = tdl.Grid(tdl.ARAKAWA_C, (bc, bc, tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=F64, device="cpu")
    g.decompose(nx, ny, ndomains=ndom, halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


def _ramp(g, seed):
    return np.random.default_rng(seed).standard_normal(
        (g.global_ny, g.global_nx))


def _psy(ndom):
    m = NemoLite2DPsy(34, 30, ndomains=ndom, halo_width=8, dtype=F64,
                      device="cpu")
    m.set_initial_ssh(gaussian_eta(34, 30, amp=0.2))
    rows = lambda n, r: [[m._scalars_at(i * r + j) for j in range(r)]  # noqa
                         for i in range(n)]
    return m._sched, (m.sshn_t, m.un, m.vn, m.ssha_t, m.ua, m.va), rows


def _levels(kind, levels, ndom):
    g = _grid(40, 36, ndom, 8)
    if kind == "chain":
        fs = sc.ml_fields(g, levels)
        sched = tkm.Schedule(*sc.ml_calls(*fs))
    else:
        fs = sc.bc_fields(g, levels)
        sched = tkm.Schedule(*sc.bc_calls(*fs))
    return sched, fs, None


def _fuzz(trial, ndom):
    """A seeded chain of 1-4 shift kernels (b = shift(a) + s, then
    b = shift(b) + s, ...), internal or all points, walled or periodic,
    with a field set under all points at the end of some."""
    rng = np.random.default_rng(1000 + trial)
    names = [str(x) for x in rng.choice(list(SHIFTS),
                                        size=int(rng.integers(1, 5)))]
    spaces = [tkm.GO_ALL_PTS if rng.integers(0, 3) == 0
              else tkm.GO_INTERNAL_PTS for _ in names]
    wrap = bool(rng.integers(0, 2))
    halo = max(sum(2 if x == "EE" else 1 for x in names), 1)
    g = _grid(40, 40, ndom, 8 if halo <= 4 else halo, wrap)
    a = tdl.Field(g, tdl.T_POINTS, init_global_data=_ramp(g, trial))
    b = tdl.Field(g, tdl.T_POINTS)
    calls, cur = [], a
    for nm, sp in zip(names, spaces):
        calls.append((_shift(nm, sp), b, cur, float(rng.uniform(-1, 1))))
        cur = b
    if trial % 2:
        calls.append((_halve, a))
    return tkm.Schedule(*calls), (a, b), None


#: case id -> (build(ndom) -> (schedule, fields, scalar rows or None),
#: repeats (at most what the halo allows), steps)
CASES = {f"psy r={r}": (_psy, r, 6 // r) for r in (1, 2, 3)}
CASES.update({f"levels {kind} L={lv} r={r}":
              (functools.partial(_levels, kind, lv), r, 3)
              for kind, lv, r in (("chain", 3, 1), ("chain", 8, 1),
                                  ("chain", 3, 2), ("broadcast", 3, 1),
                                  ("broadcast", 8, 3))})
CASES.update({f"fuzz {t} r={r}": (functools.partial(_fuzz, t), r, 3)
              for t in range(8) for r in (1, 2)})
#: past the shared-memory budget: the chain at 29 levels (float64, ring 4)
#: takes the skeleton's cluster form (the case id keeps the name of the
#: form it took before the cluster form existed)
SCRATCH_CASE = "levels chain L=29 r=1 (scratch form)"
CASES[SCRATCH_CASE] = (functools.partial(_levels, "chain", 29), 1, 2)


def _generate_on_card(sched, nsteps, repeats):
    """Build the fused program as on a CUDA grid (the sources are
    generated, nothing is compiled); returns [(generate's arguments,
    GeneratedSweep)] of every variant."""
    captured = []
    real = tss.generate

    def spy(steps, **kw):
        gen = real(steps, **kw)
        captured.append((dict(kw, steps=steps), gen))
        return gen
    grid = sched._grid
    dev, build = grid.device, tss.schedule_sweep.build
    grid.device = types.SimpleNamespace(type="cuda")
    tss.generate = spy
    tss.schedule_sweep.build = lambda gen: None
    try:
        sched._fused_prog(nsteps, repeats)
    finally:
        tss.generate = real
        tss.schedule_sweep.build = build
        grid.device = dev
    return captured


def _repeats(sched, r):
    """The case's repeats, at most what the schedule's halo allows."""
    return min(r, sched.max_fused_repeats())


def _sweeps(case, ndom=1):
    build, r, n = CASES[case]
    sched = build(ndom)[0]
    return _generate_on_card(sched, n, _repeats(sched, r))


def _sets(step):
    """(slots written, slots read off-point) of one call."""
    written = {si for si, _ in step["written"]}
    off = {idx for (kind, idx), a in zip(step["binding"], step["meta"].args)
           if kind == "f" and tkm._reads(a) and a.stencil.reaches_off_point()}
    return written, off


@pytest.mark.parametrize("case", list(CASES))
def test_plan_passes_hold_no_hazard(case):
    """Between two barriers no call reads off-point a slot an earlier one
    wrote, or writes a slot an earlier one read off-point; a call is in
    place exactly where it reads no slot it writes off-point."""
    for kw, gen in _sweeps(case):
        pl, steps = gen.plan, kw["steps"]
        assert sorted(c for p in pl.passes for c in p) == list(range(
            len(steps)))
        segments, seg = [], []
        for cs, bar in zip(pl.passes, pl.barrier_before):
            if bar:
                segments.append(seg)
                seg = []
            for c in cs:
                w, off = _sets(steps[c])
                assert pl.in_place[c] == (not (w & off)), (case, c)
                if pl.in_place[c]:
                    seg.append((w, off))
                else:
                    assert len(cs) == 1
                    seg.append((set(), off))      # reads before its barrier
                    segments.append(seg)
                    seg = [(w, set())]            # stores after it
        segments.append(seg)
        for seg in segments:
            for i, (wa, offa) in enumerate(seg):
                for wb, offb in seg[i + 1:]:
                    assert not (offb & wa), (case, "read after write")
                    assert not (wb & offa), (case, "write after read")
        staged = sum(1 for f in pl.in_place if not f)
        assert pl.barriers == sum(pl.barrier_before) + staged + 1
        # the cluster form's barriers are cluster barriers
        sync = ("sweep::cluster_sync();" if gen.form == "cluster"
                else "__syncthreads();")
        assert gen.text.count(sync) == sum(pl.barrier_before) + 1


def _erode(ok, d):
    """Cells whose square of half-side d lies in ``ok`` (and in the
    window)."""
    if d == 0:
        return ok.copy()
    wy, wx = ok.shape
    out = np.zeros_like(ok)
    inner = np.ones((wy - 2 * d, wx - 2 * d), bool)
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            inner &= ok[d + dy: wy - d + dy, d + dx: wx - d + dx]
    out[d: wy - d, d: wx - d] = inner
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plan_regions_cover_readers_and_tile(case):
    """Walking the repeats forwards from a window that is exact
    everywhere: a cell a call computes is exact where its reads are exact
    over each argument's stencil depth and its written slots' old values
    are exact (the merge keeps them under a zero mask); a cell it does
    not compute is stale.  At the end every state slot is exact on the
    output tile, and every region lies in the window inset by its call's
    depth."""
    for kw, gen in _sweeps(case):
        pl, steps, sh, ring = gen.plan, kw["steps"], gen.tile, gen.ring
        wy, wx = sh.ty + 2 * ring, sh.wx
        slots = {idx for s in steps for (kind, idx) in s["binding"]
                 if kind == "f"}
        exact = {si: np.ones((wy, wx), bool) for si in slots}
        for k in range(gen.K):
            for cs in pl.passes:
                for c in cs:
                    s = steps[c]
                    box = pl.box(k, c, sh, ring)
                    written = {si for si, _ in s["written"]}
                    if box is None:
                        for si in written:
                            exact[si] = np.zeros((wy, wx), bool)
                        continue
                    y0, y1, x0, x1 = box
                    d = pl.depths[c]
                    assert d <= y0 <= y1 <= wy - d and d <= x0 <= x1 <= wx - d
                    ok = np.zeros((wy, wx), bool)
                    ok[y0:y1, x0:x1] = True
                    for (kind, idx), a in zip(s["binding"], s["meta"].args):
                        if kind in ("f", "c") and tkm._reads(a):
                            src = (exact[idx] if kind == "f"
                                   else np.ones((wy, wx), bool))
                            ok &= _erode(src, a.stencil.depth())
                    for si in written:
                        exact[si] = ok & exact[si]
        for si in kw["state_slots"]:
            assert exact[si][ring:ring + sh.ty, sh.rl:sh.rl + sh.tx].all(), \
                (case, si)


@pytest.mark.parametrize("repeats", [1, 2, 3])
def test_psy_plan_takes_at_most_six_barriers(repeats):
    """The NEMOLite2D schedule: every call in place, 4 passes
    (next_sshu+v; continuity+bc_ssh; momentum_u/v and the four boundary
    calls; the three copies) and 4 barriers per repeat where one pass and
    two barriers per call took 13 and 26; the generated source states
    the plan."""
    sweeps = _sweeps(f"psy r={repeats}")
    assert len(sweeps) == 2                      # the full and light variants
    for kw, gen in sweeps:
        pl = gen.plan
        assert pl.barriers <= 6
        assert all(pl.in_place)
        assert pl.passes == ((0, 1), (2, 3), (4, 5, 6, 7, 8, 9),
                             (10, 11, 12))
        assert pl.barrier_before == (False, True, True, True)
        assert pl.barriers == 4
        assert "Plan: 4 passes and 4 barriers per repeat; 13 of 13 calls " \
            "in place" in gen.text
        assert f"sw_m[{repeats}][13]" in gen.text
        # the last repeat computes the tile (margin 0) for the momentum
        # calls and the copies, one repeat back two cells more
        assert pl.margins[-1][4:] == (0,) * 9
        if repeats > 1:
            assert pl.margins[-2][4:10] == (2,) * 6


# --- the plan emulator -------------------------------------------------------

def _layout(kw, dtype):
    """Window planes of each (kind, index) as generate places them:
    [(array, plane)] per level."""
    levels, out = kw["levels"], {}
    n = 0
    for si in kw["state_slots"]:
        k = max(levels[si], 1)
        out[("f", si)] = [("s", n + i) for i in range(k)]
        n += k
    n = 0
    for si in list(kw["extra_slots"]) + list(kw["ro_slots"]):
        k = max(levels[si], 1)
        out[("f", si)] = [("a", n + i) for i in range(k)]
        n += k
    ni = 0
    for ci, c in enumerate(kw["consts"]):
        if c.dtype == dtype:
            out[("c", ci)] = [("a", n)]
            n += 1
        else:
            out[("c", ci)] = [("ai", ni)]
            ni += 1
    return out


def emulate(kw, gen, state, aux, auxi, codes, rows):
    """One sweep of ``gen`` as its plan runs it, on the CPU: for every
    tile of the block, its window staged with reads clamped to the block;
    per repeat, pass and call, the call's torch body on the window's
    planes, merged under its write masks inside its region only; the
    tile's state planes written back."""
    pl, sh, ring, dtype = gen.plan, gen.tile, gen.ring, gen.dtype
    steps, levels = kw["steps"], kw["levels"]
    arrays = {"s": state, "a": aux, "ai": auxi}
    layout = _layout(kw, dtype)
    masks = [((codes[i // 8].to(torch.int32) >> (i % 8)) & 1)
             for i in range(kw["n_masks"])]
    ny, nx = state[0].shape
    wy, wx = sh.ty + 2 * ring, sh.wx
    out = [p.clone() for p in state]
    for by in range(-(-ny // sh.ty)):
        for bx in range(-(-nx // sh.tx)):
            oy, ox = by * sh.ty - ring, bx * sh.tx - sh.rl
            rr = (oy + torch.arange(wy)).clamp(0, ny - 1)
            cc = (ox + torch.arange(wx)).clamp(0, nx - 1)

            def win(p, rr=rr, cc=cc):
                return p[rr][:, cc]
            cur = {key: [win(arrays[a][i]) for a, i in planes]
                   for key, planes in layout.items()}
            wmask = [win(m) > 0 for m in masks]
            for k in range(gen.K):
                for cs in pl.passes:
                    for c in cs:
                        box = pl.box(k, c, sh, ring)
                        if box is None:
                            continue
                        s = steps[c]
                        args = []
                        for (kind, idx), _ in zip(s["binding"],
                                                  s["meta"].args):
                            if kind == "s":
                                args.append(rows[k][idx])
                            elif kind != "r":
                                p = cur[(kind, idx)]
                                lead = kind == "f" and levels[idx]
                                args.append(torch.stack(p) if lead else p[0])
                        outs = tkm._outputs(s["fn"], s["meta"],
                                            s["fn"](*args),
                                            len(s["written"]), 0)
                        region = torch.zeros((wy, wx), dtype=torch.bool)
                        region[box[0]:box[1], box[2]:box[3]] = True
                        for (si, mi), nb in zip(s["written"], outs):
                            planes = cur[("f", si)]
                            nb = torch.as_tensor(nb, dtype=dtype)
                            nbs = ([nb] * len(planes) if nb.dim() == 2
                                   else list(nb))
                            for lv, v in enumerate(nbs):
                                planes[lv] = torch.where(
                                    region & wmask[mi], v, planes[lv])
            y1, x1 = min((by + 1) * sh.ty, ny), min((bx + 1) * sh.tx, nx)
            i = 0
            for si in kw["state_slots"]:
                for p in cur[("f", si)]:
                    out[i][by * sh.ty:y1, bx * sh.tx:x1] = \
                        p[ring:ring + y1 - by * sh.ty,
                          sh.rl:sh.rl + x1 - bx * sh.tx]
                    i += 1
    return tuple(out)


class _Emulated:
    """Stands in for the generated kernels' wrapper: each sweep is the
    plan emulator on the captured source's arguments."""

    def __init__(self, captured):
        self.by_name = {gen.name: (kw, gen) for kw, gen in captured}
        self.launches = 0

    def build(self, gen):
        return None

    def __call__(self, gen, state, aux, auxi, codes, rows):
        self.launches += 1
        kw, g = self.by_name[gen.name]
        return emulate(kw, g, state, aux, auxi, codes, rows)


@pytest.mark.parametrize("ndom", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_emulator_equals_plain_tier(monkeypatch, case, ndom):
    build, r, n = CASES[case]
    sched, fields, rows_of = build(ndom)
    plain_sched, plain_fields, _ = build(ndom)
    r = _repeats(sched, r)
    captured = _generate_on_card(sched, n, r)
    monkeypatch.setattr(tss, "schedule_sweep", _Emulated(captured))
    rows = rows_of(n, r) if rows_of else None
    sched.fused_program(n, repeats=r)(scalars=rows)
    assert tss.schedule_sweep.launches >= 1
    plain_sched.fused_program(n, repeats=r, plain=True)(scalars=rows)
    for a, b in zip(fields, plain_fields):
        got, want = a.gather_inner_data(), b.gather_inner_data()
        assert np.all(np.isfinite(got))
        np.testing.assert_array_equal(got, want, err_msg=case)


def test_scratch_case_takes_the_scratch_form():
    """The case past the budget generates both sweeps in the cluster form
    (which took the scratch form before it existed), on the cluster tile
    of 4 CTAs, with the plan the shared form would run."""
    for kw, gen in _sweeps(SCRATCH_CASE):
        assert gen.form == "cluster" and gen.tile.ctas == 0
        bpp = (gen.n_state + gen.n_aux) * 8 + gen.n_codes
        assert (gen.tile, gen.cluster) == sst.cluster_tile(gen.ring, bpp) \
            == ((20, 24, 4, 32, 0), 4)
        assert gen.plan == tss.plan(kw["steps"], K=gen.K, ring=gen.ring,
                                    state_slots=kw["state_slots"])
