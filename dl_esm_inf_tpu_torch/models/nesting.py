"""One-way and two-way grid nesting: a refined child grid driven by its
parent.

Counterpart of ``dl_esm_inf_tpu/models/nesting.py`` (the AGRIF
capability class, NEMO's nesting layer): a child
:class:`~.gravity_wave.GravityWaveModel` covers a rectangular window of
its parent's domain at ``ratio`` x finer resolution (``dx/r``, ``dt/r``)
and receives its open-boundary values from the parent, space-bilinear
plus time-linear; with ``two_way`` the child's eta is restricted back
onto the parent window after its substeps.  One nest step is one parent
step, ``r`` child substeps and the boundary glue between them, a Python
loop of the models' plain steps (eager, like every step of the port).

Discrete design (what makes the seam exact):

* The child grid keeps the standard one-cell land ring (tmask=0); the
  next ring in, the *boundary ring*, is wet but its ``t_upd`` update
  mask is zeroed on every stacked copy, so the child step never evolves
  it.  Before each child substep the ring's eta is overwritten with
  parent values at the substep's START time ``alpha = k/r``; u/v faces
  next to the ring are updated by the child's own stencil from those
  etas, which reproduces the parent's forward-backward staggering.
* At ``ratio=1`` the bilinear weights and the time blend degenerate to
  the identity, and the child interior equals the parent window to the
  last bit (``tests/test_torch_nesting.py``).

The glue writes with out-of-place ``index_put`` (the JAX package's
``.at[].set``), so autograd flows through the ring scatter, the child
substeps and the feedback.  Plain path only: the glue runs every parent
step, so a parent on the fused sweep or with steps_per_sweep > 1 is
refused, as in the JAX package.

Across ranks the child grid is split over the parent's ranks, and the
glue touches only each rank's own blocks (the JAX package's one program
over sharded arrays, where XLA inserts the collectives):

* **ring samples**: each rank contributes the parent T points of the
  *band* the bilinear plan reads that lie in its block, and one
  :func:`~..parallel.collectives.all_gather` (O(perimeter)) gives every
  rank the band; a rank then interpolates and writes only the ring
  targets in its child block.  The band holds the exact parent values,
  so the ring is bitwise the one-process ring;
* **feedback**: each rank sums the child cells it owns onto their parent
  cells, one all-reduce (:func:`~..parallel.collectives.psum` of the
  partial sums, then :func:`~..parallel.collectives.pbroadcast`: every
  rank writes only the parent cells it owns, so the backward pass sums
  the ranks' cotangents once) gives the sums, and the rank owning each
  parent cell writes its average.  With more than one child cell per
  parent cell the sums add in another order than one process's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds, layout
from ..core.grid import Grid, grid_init
from ..ops import stencils as st
from ..parallel import environment as env
from ..parallel.collectives import all_gather, pbroadcast, psum
from .gravity_wave import GravityWaveModel


# ----------------------------------------------------------------------
# Interpolation index plans (host-side, static)
# ----------------------------------------------------------------------
def _t_point_plan(cy, cx, pj0, pi0, ratio, pny, pnx):
    """Bilinear gather plan from parent T points to child T points.

    Child T cell (cy, cx) sits at parent T-index coordinates
    ``pj0 + (cy + 0.5)/r - 0.5`` (exactly integer when r == 1, so the
    weights degenerate to the identity: the bitwise r=1 invariant)."""
    py = pj0 + (np.asarray(cy, np.float64) + 0.5) / ratio - 0.5
    px = pi0 + (np.asarray(cx, np.float64) + 0.5) / ratio - 0.5
    y0 = np.clip(np.floor(py).astype(np.int64), 0, pny - 2)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, pnx - 2)
    wy = np.clip(py - y0, 0.0, 1.0)
    wx = np.clip(px - x0, 0.0, 1.0)
    return y0, x0, wy, wx


def _bilinear(band, plan):
    """A ring plan's values from the parent band: ``plan`` holds the
    band indices of each target's four corners and its weights."""
    k00, k01, k10, k11, wy, wx = plan
    v00 = band[k00]
    v01 = band[k01]
    v10 = band[k10]
    v11 = band[k11]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _stacked_indices(decomp, gy, gx):
    """Stacked-layout coordinates of the INTERNAL copy of global cells.

    Shard-halo twins are deliberately not touched: the child step opens
    with a halo exchange, which refreshes them from these."""
    h = decomp.halo
    sy = (gy // decomp.tile_ny) * decomp.local_ny + h + gy % decomp.tile_ny
    sx = (gx // decomp.tile_nx) * decomp.local_nx + h + gx % decomp.tile_nx
    return sy, sx


def _device_indices(idx, device):
    return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                 for a in idx)


def _owned(grid, gy, gx):
    """Where the internal copies of global cells ``(gy, gx)`` live:
    ``(owner rank, mine, (by, bx))`` with ``mine`` true for the cells in
    this rank's block and ``(by, bx)`` their block coordinates (0 for the
    others)."""
    spec = grid.halo_spec
    sy, sx = _stacked_indices(grid.decomp, np.asarray(gy), np.asarray(gx))
    ny, nx = spec.array_shape
    owner = (sy // ny) * spec.ranks_x + sx // nx
    mine = owner == env.get_rank()
    iy, ix = spec.rank_coords(env.get_rank())
    return (owner, mine, (np.where(mine, sy - iy * ny, 0),
                          np.where(mine, sx - ix * nx, 0)))


# ----------------------------------------------------------------------
class OneWayNest:
    """A parent model + a refined child over a window of it.

    Parameters
    ----------
    parent : GravityWaveModel
        On the plain path (no fused sweep, no steps_per_sweep).
    origin : (pj0, pi0)
        Parent T-cell of the child window's south-west corner.
    shape : (ph, pw)
        Window extent in parent cells; the child grid is
        ``(ph*ratio, pw*ratio)`` and covers exactly that window.
    ratio : int
        Refinement ratio r >= 1: child dx = parent dx / r and the child
        takes r substeps (dt/r) per parent step.
    two_way : bool
        After the r substeps, restrict the child's eta (conservative
        r x r mean) back onto the parent's window interior (the AGRIF
        "update" phase).  The feedback region is inset two parent cells
        from the window edge, covers wet parent cells only, and is the
        identity at ratio=1, so the bitwise r=1 invariant survives it.
    child_ndomains, child_ndomainx, child_ndomainy
        The child grid's tiles (``Grid.decompose``'s arguments).
    """

    def __init__(self, parent: GravityWaveModel, *, origin, shape,
                 ratio: int, two_way: bool = False, child_ndomains=None,
                 child_ndomainx=None, child_ndomainy=None):
        if parent.use_fused or parent._sweep_K > 1:
            raise ValueError(
                "one-way nesting needs the parent on the plain path (the "
                "boundary glue runs every parent step); build the parent "
                "without fused/steps_per_sweep")
        self.parent = parent
        self.ratio = r = int(ratio)
        if r < 1:
            raise ValueError(f"ratio must be >= 1, got {ratio}")
        pj0, pi0 = (int(v) for v in origin)
        ph, pw = (int(v) for v in shape)
        pdec = parent.grid.decomp
        pny, pnx = pdec.global_ny, pdec.global_nx
        if not (0 <= pi0 and pi0 + pw <= pnx and 0 <= pj0
                and pj0 + ph <= pny):
            raise ValueError(
                f"child window [{pj0}:{pj0 + ph}) x [{pi0}:{pi0 + pw}) "
                f"outside the parent domain {pny}x{pnx}")
        if ph < 4 or pw < 4:
            raise ValueError("child window needs >= 4 parent cells per "
                             "axis (land ring + boundary ring + interior)")
        self.two_way = bool(two_way)
        if self.two_way and (ph < 5 or pw < 5):
            raise ValueError("two-way feedback needs a window of >= 5 "
                             "parent cells per axis (2-cell inset)")
        self.origin = (pj0, pi0)
        self.shape = (ph, pw)
        cny, cnx = ph * r, pw * r

        # Child tmask: the parent window refined piecewise-constant,
        # with the standard one-cell land ring forced on the outside.
        ptm = layout.unstack_internal(pdec, parent.grid._tmask_np)
        tm_c = np.kron(ptm[pj0:pj0 + ph, pi0:pi0 + pw],
                       np.ones((r, r), np.int32)).astype(np.int32)
        tm_c[0, :] = tm_c[-1, :] = 0
        tm_c[:, 0] = tm_c[:, -1] = 0
        ring = np.zeros((cny, cnx), np.int32)
        ring[1, 1:-1] = ring[-2, 1:-1] = 1
        ring[1:-1, 1] = ring[1:-1, -2] = 1
        if not np.all(tm_c[ring == 1] == 1):
            raise ValueError(
                "the child's boundary ring must be wet: move the window "
                "so its edge cells are ocean in the parent tmask")

        pgrid = parent.grid
        dev = pgrid.device
        cgrid = Grid(pgrid.name, pgrid.boundary_conditions, pgrid.offset,
                     dtype=pgrid.dtype, device=dev)
        try:
            cgrid.decompose(cnx, cny, ndomains=child_ndomains,
                            ndomainx=child_ndomainx,
                            ndomainy=child_ndomainy, halo_width=pdec.halo)
        except ValueError as e:
            if "cannot be split over" not in str(e):
                raise
            raise ValueError(
                "the child grid is split over its parent's "
                f"{env.get_num_ranks()} ranks, an equal block of tiles "
                "each: give the child a tile count on a factor grid of "
                f"the rank count ({e})") from e
        grid_init(cgrid, pgrid.dx / r, pgrid.dy / r, tm_c)
        self.child = child = GravityWaveModel(
            cgrid, dt=parent.dt / r, g=parent.g, depth=parent.depth)

        # Freeze the boundary ring: zero t_upd on EVERY stacked copy (halo
        # twins included) so no path evolves it.  The model froze its
        # masks into the tuples its steps read, so those are rebuilt too.
        cdec = cgrid.decomp
        ring_stacked = layout.stack_global(cdec, ring, mode="edge")
        child._t_upd = child._t_upd * cgrid.block_tensor(
            1 - ring_stacked, dtype=child._t_upd.dtype)
        child._mask_codes = st.pack_mask_bits(
            (child._t_upd, child._u_wet, child._v_wet)).contiguous()
        child._step_aux = (child._t_upd, child._u_wet, child._v_wet)
        child._sweep_aux = (child._mask_codes,)

        # Static plans.  The band: every parent T point the ring's
        # bilinear plan reads, with the owner of each and this rank's
        # block coordinates of those it holds.
        dtype = cgrid.dtype
        ry, rx = np.nonzero(ring)
        y0, x0, wy, wx = _t_point_plan(ry, rx, pj0, pi0, r, pny, pnx)
        corners = [(y0 + a) * pnx + x0 + b for a in (0, 1) for b in (0, 1)]
        band = np.unique(np.concatenate(corners))
        owner, mine, blk = _owned(pgrid, band // pnx, band % pnx)
        self._band = (torch.from_numpy(mine).to(dev),
                      *_device_indices(blk, dev),
                      *_device_indices((owner, np.arange(band.size)), dev))
        # the ring targets in this rank's child block, and their plans
        _, mine, blk = _owned(cgrid, ry, rx)
        self._ring_scatter = _device_indices((b[mine] for b in blk), dev)
        self._ring_plan = (
            *_device_indices((np.searchsorted(band, c[mine])
                              for c in corners), dev),
            torch.as_tensor(wy[mine], dtype=dtype, device=dev),
            torch.as_tensor(wx[mine], dtype=dtype, device=dev))

        if self.two_way:
            # Feedback plan: wet parent cells in the window interior
            # (inset 2 parent cells), each fed the r x r mean of its
            # child cells: this rank's child cells with the index of
            # their parent cell, and the parent cells it writes.
            fj, fi = np.mgrid[pj0 + 2:pj0 + ph - 2, pi0 + 2:pi0 + pw - 2]
            wet = ptm[fj, fi] == 1
            slot = np.full(fj.shape, -1)
            slot[wet] = np.arange(int(wet.sum()))
            self._fb_count = int(wet.sum())
            cy, cx = np.mgrid[2 * r:(ph - 2) * r, 2 * r:(pw - 2) * r]
            cslot = slot[cy // r - 2, cx // r - 2]
            _, mine, blk = _owned(cgrid, cy, cx)
            keep = mine & (cslot >= 0)
            self._fb_gather = _device_indices(
                (cslot[keep], blk[0][keep], blk[1][keep]), dev)
            _, mine, blk = _owned(pgrid, fj[wet], fi[wet])
            self._fb_take = torch.from_numpy(np.flatnonzero(mine)).to(dev)
            self._fb_scatter = _device_indices((b[mine] for b in blk), dev)
        self._subnests = ()      # filled by NestSet for telescoping
        self._prog_cache = {}

    # ------------------------------------------------------------------
    def sync_from_parent(self) -> None:
        """Initialise the child's eta from the parent's (bilinear, on the
        host at float64, as the JAX package does; across ranks from the
        gathered parent, and each rank keeps its child block).

        u/v start at rest; for a fine-structure initial condition set
        the child's eta directly instead (``child.set_initial_eta``)."""
        pj0, pi0 = self.origin
        pdec = self.parent.grid.decomp
        cdec = self.child.grid.decomp
        cny, cnx = cdec.global_ny, cdec.global_nx
        cy, cx = np.mgrid[0:cny, 0:cnx]
        y0, x0, wy, wx = _t_point_plan(cy.ravel(), cx.ravel(), pj0, pi0,
                                       self.ratio, pdec.global_ny,
                                       pdec.global_nx)
        pg = self.parent.eta.gather_inner_data()
        vals = ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
                + wy * ((1 - wx) * pg[y0 + 1, x0]
                        + wx * pg[y0 + 1, x0 + 1]))
        eta_c = vals.reshape(cny, cnx)
        tm_c = layout.unstack_internal(cdec, self.child.grid._tmask_np)
        eta_c[np.asarray(tm_c) != 1] = 0.0
        self.child.set_initial_eta(eta_c)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int = 1):
        """``prog(state) -> state``: nsteps x (parent step + r child
        substeps).

        State: ``((p_eta, p_u, p_v), tree)`` in the stacked layout (see
        :func:`_make_nest_program`).  Before child substep k the
        boundary ring's eta is set to the parent field at blend time
        ``alpha = k/r`` (start of substep: with the forward-backward
        stagger the child's own u/v updates then reproduce the parent's
        sequencing, which is what makes r=1 bitwise)."""
        if nsteps not in self._prog_cache:
            self._prog_cache[nsteps] = _make_nest_program(
                self.parent, (self,), nsteps)
        return self._prog_cache[nsteps]

    def run(self, nsteps: int) -> None:
        _run(self.parent, (self,), self.step_program(nsteps))

    # -- pieces shared with NestSet ------------------------------------
    def _ring_values(self, p_eta):
        """The ring's parent samples at this rank's ring targets, from
        the band gathered from every rank (collective)."""
        mine, by, bx, owner, slot = self._band
        local = torch.where(mine, p_eta[by, bx], torch.zeros(
            (), dtype=p_eta.dtype, device=p_eta.device))
        return _bilinear(all_gather(local)[owner, slot], self._ring_plan)

    def _feedback(self, p_eta, c_eta):
        """Restrict the child's eta onto the parent window: the r x r
        sums of every rank's child cells, all-reduced, averaged, written
        where this rank owns the parent cell (collective)."""
        r = self.ratio
        slot, cy, cx = self._fb_gather
        part = torch.zeros(self._fb_count, dtype=c_eta.dtype,
                           device=c_eta.device).index_add(0, slot,
                                                          c_eta[cy, cx])
        avg = pbroadcast(psum(part)) / (r * r)
        return p_eta.index_put(self._fb_scatter, avg[self._fb_take])


def _read_tree(nests):
    """Device state of a nest forest as nested tuples (telescoping
    order)."""
    return tuple(((n.child.eta.data, n.child.u.data, n.child.v.data),
                  _read_tree(n._subnests)) for n in nests)


def _write_tree(nests, tree) -> None:
    for n, (c_state, sub) in zip(nests, tree):
        n.child.eta.data, n.child.u.data, n.child.v.data = c_state
        _write_tree(n._subnests, sub)


def _run(parent, nests, prog) -> None:
    p = parent
    out = prog(((p.eta.data, p.u.data, p.v.data), _read_tree(nests)))
    p.eta.data, p.u.data, p.v.data = out[0]
    _write_tree(nests, out[1])


def _make_nest_program(parent, nests, nsteps: int):
    """``prog(state) -> state`` advancing a parent and a FOREST of nests.

    State: ``((p_eta, p_u, p_v), trees)`` with one ``((c_eta, c_u,
    c_v), subtrees)`` entry per nest.  Nests telescope: a nest whose
    parent model is another nest's child advances inside that child's
    substeps, with its ring times interpolated at the child's (finer)
    cadence.  Per level: one model step, then each nest's
    ring-prescribed substeps (recursing into ITS nests), then each
    two-way nest's feedback (window disjointness at every level makes
    the order immaterial)."""
    npdt = kinds.np_dtype(parent.grid.dtype)
    progs = {}

    def prep(model, ns):
        progs[id(model)] = model.step_program(1)
        for n in ns:
            prep(n.child, n._subnests)

    prep(parent, nests)

    def advance(model, ns, m_state, trees):
        """One step of ``model`` + all descendant nests."""
        rings_old = [n._ring_values(m_state[0]) for n in ns]
        m_eta, m_u, m_v = progs[id(model)](m_state)
        new_trees = []
        for i, n in enumerate(ns):
            ring_new = n._ring_values(m_eta)
            c_state, sub = trees[i]
            r = n.ratio
            for k in range(r):
                if k == 0:
                    vals = rings_old[i]   # exact, no 0-weight blend
                else:
                    # the blend weights rounded to the working dtype, as
                    # the JAX package's dtype scalars are
                    a = npdt.type(k / r)
                    vals = (float(npdt.type(1) - a) * rings_old[i]
                            + float(a) * ring_new)
                c_state = (c_state[0].index_put(n._ring_scatter, vals),
                           c_state[1], c_state[2])
                c_state, sub = advance(n.child, n._subnests, c_state, sub)
            if n.two_way:
                m_eta = n._feedback(m_eta, c_state[0])
            new_trees.append((c_state, sub))
        return (m_eta, m_u, m_v), tuple(new_trees)

    def prog(state):
        m_state, trees = state
        for _ in range(nsteps):
            m_state, trees = advance(parent, nests, tuple(m_state), trees)
        return m_state, trees

    return prog


class NestSet:
    """A forest of nests, siblings AND telescopes, advanced together.

    Takes :class:`OneWayNest` instances and assembles the hierarchy by
    identity: a nest whose ``parent`` is another nest's ``child``
    telescopes inside it; the remaining roots must share one parent
    model.  One-way children are independent: each child's trajectory
    (and the parent's) is bitwise identical to running its nest alone.
    Two-way nests under the same parent model must have disjoint windows
    so their feedbacks commute."""

    def __init__(self, nests):
        nests = tuple(nests)
        if not nests:
            raise ValueError("NestSet needs at least one nest")
        child_models = {id(n.child) for n in nests}
        for n in nests:
            n._subnests = tuple(m for m in nests if m.parent is n.child)
            n._prog_cache.clear()    # hierarchy may have changed
        roots = tuple(n for n in nests
                      if id(n.parent) not in child_models)
        if len({id(n.parent) for n in roots}) != 1:
            raise ValueError(
                "all nests must share the same parent model at the root "
                "(or telescope from another nest's child)")
        by_parent = {}
        for n in nests:
            if n.two_way:
                by_parent.setdefault(id(n.parent), []).append(n)
        for group in by_parent.values():
            fb = [(n.origin, n.shape) for n in group]
            for a in range(len(fb)):
                for b in range(a + 1, len(fb)):
                    (ja, ia), (ha, wa) = fb[a]
                    (jb, ib), (hb, wb) = fb[b]
                    if (ja < jb + hb and jb < ja + ha
                            and ia < ib + wb and ib < ia + wa):
                        raise ValueError(
                            "two-way nests must have disjoint windows "
                            f"(feedback overlaps: {fb[a]} vs {fb[b]})")
        self.parent = roots[0].parent
        self.nests = roots           # root nests; telescopes hang below
        self.all_nests = nests
        self._prog_cache = {}

    def step_program(self, nsteps: int = 1):
        if nsteps not in self._prog_cache:
            self._prog_cache[nsteps] = _make_nest_program(
                self.parent, self.nests, nsteps)
        return self._prog_cache[nsteps]

    def run(self, nsteps: int) -> None:
        _run(self.parent, self.nests, self.step_program(nsteps))
