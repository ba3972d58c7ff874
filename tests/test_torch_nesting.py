"""The PyTorch port's grid nesting against the JAX package.

``models/nesting.py``: ``OneWayNest`` (one-way and two-way) and
``NestSet`` (siblings and telescopes) on the port's gravity-wave model,
at float64 on the CPU.  Each test is the twin of a test of
tests/test_nesting.py: the same seeded inputs go through the JAX package
and the port, the fields are compared, and the JAX test's own assertions
are made on the port's results.  Where the JAX test takes every device
(``ndomains=None``), the port runs 8 tiles on one process.

Tolerances: the port's own invariants bitwise (the ratio-1 child
interior against the parent window, the two-way ratio-1 parent against a
solo run, one-way siblings against their nests alone); port vs JAX
1e-11 absolute (fields of order 0.1-1; the same operations, XLA:CPU
contracting some multiply-adds); the port's decomposition invariance the
JAX tests' 1e-12; the gradient against central differences 1e-6
relative, as the JAX test, and against the JAX gradient 1e-11 relative
to its largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dl_esm_inf_tpu.models import gravity_wave as jgw
from dl_esm_inf_tpu.models import nesting as jnest

from dl_esm_inf_tpu_torch.models import gravity_wave as gw
from dl_esm_inf_tpu_torch.models import nesting as nest

torch.set_num_threads(1)

TOL_JAX = 1e-11
TOL_DECOMP = 1e-12    # tests/test_nesting.py's decomposition tolerance


class _Pkg:
    def __init__(self, gw, nest, kw, every):
        self.gw, self.nest, self.kw, self.every = gw, nest, kw, every


#: ``every`` is the tile count of the JAX tests' ``ndomains=None``
JAX = _Pkg(jgw, jnest, {}, None)
#: the port runs on the card unless told otherwise; these tests run on
#: the CPU, with the JAX tests' 8 devices as 8 tiles
TORCH = _Pkg(gw, nest, dict(device="cpu"), 8)
PKGS = (JAX, TORCH)


def _dom(P, ndom):
    return P.every if ndom is None else ndom


def _build_parent(P, gnx, gny, ndom, dt, depth=10.0, width=0.08):
    parent = P.gw.build(gnx, gny, ndomains=_dom(P, ndom), dt=dt, depth=depth,
                        **P.kw)
    parent.set_initial_eta(gw.gaussian_eta(gnx, gny, width=width))
    return parent


def _nest(P, parent, *, child_ndomains=None, **kw):
    return P.nest.OneWayNest(parent, child_ndomains=_dom(P, child_ndomains),
                             **kw)


def _both(run):
    """``run(P) -> list of global arrays`` for the JAX package and the
    port, compared at TOL_JAX; returns the port's."""
    want, got = (run(P) for P in PKGS)
    assert len(want) == len(got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.all(np.isfinite(g)), i
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_JAX,
                                   err_msg=str(i))
    return got


def test_ratio1_child_matches_parent_bitwise():
    """The child interior equals the parent window bitwise after 30
    steps: the check that the boundary ring stays frozen (a stale mask
    tuple would evolve it and break the equality)."""
    def run(P):
        parent = _build_parent(P, 48, 48, 1, dt=0.02)
        n = _nest(P, parent, origin=(12, 12), shape=(24, 24), ratio=1,
                  child_ndomains=1)
        n.sync_from_parent()
        n.run(30)
        return [parent.eta.gather_inner_data(), parent.u.gather_inner_data(),
                n.child.eta.gather_inner_data(),
                n.child.u.gather_inner_data()]

    pg, pu, cg, cu = _both(run)
    np.testing.assert_array_equal(cg[2:-2, 2:-2], pg[14:34, 14:34])
    np.testing.assert_array_equal(cu[2:-2, 2:-3], pu[14:34, 14:33])


def _decomposition_runs(P, two_way, steps):
    runs = []
    for pdom, cdom in ((1, 1), (None, None)):
        parent = _build_parent(P, 64, 64, pdom, dt=0.02)
        n = _nest(P, parent, origin=(16, 16), shape=(32, 32), ratio=2,
                  two_way=two_way, child_ndomains=cdom)
        n.sync_from_parent()
        n.run(steps)
        runs.append((parent.eta.gather_inner_data(),
                     n.child.eta.gather_inner_data()))
    return runs


@pytest.mark.parametrize("two_way", [False, True],
                         ids=["one_way", "two_way"])
def test_nest_decomposition_invariance(two_way):
    """Twin of test_nest_decomposition_invariance (one-way, 20 steps) and
    of test_two_way_decomposition_invariance (15 steps): 1 tile and 8
    tiles for the parent and the child."""
    steps = 15 if two_way else 20
    got = _both(lambda P: [a for run in _decomposition_runs(P, two_way, steps)
                           for a in run])
    for a, b in zip(got[:2], got[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_DECOMP)


def test_ring_time_staggering():
    r = 3

    def run(P):
        parent = _build_parent(P, 48, 48, 1, dt=0.02)
        eta_pre = parent.eta.gather_inner_data()
        n = _nest(P, parent, origin=(12, 12), shape=(20, 20), ratio=r,
                  child_ndomains=1)
        n.sync_from_parent()
        n.run(1)
        return [eta_pre, parent.eta.gather_inner_data(),
                n.child.eta.gather_inner_data()]

    eta_pre, eta_post, child = _both(run)
    cny, cnx = child.shape
    ring = np.zeros((cny, cnx), bool)
    ring[1, 1:-1] = ring[-2, 1:-1] = True
    ring[1:-1, 1] = ring[1:-1, -2] = True
    ry, rx = np.nonzero(ring)
    y0, x0, wy, wx = nest._t_point_plan(ry, rx, 12, 12, r, 48, 48)
    for a, b in zip(nest._t_point_plan(ry, rx, 12, 12, r, 48, 48),
                    jnest._t_point_plan(ry, rx, 12, 12, r, 48, 48)):
        np.testing.assert_array_equal(a, b)

    def bilin(pg):
        return ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
                + wy * ((1 - wx) * pg[y0 + 1, x0] + wx * pg[y0 + 1, x0 + 1]))

    a = (r - 1) / r
    want = (1 - a) * bilin(eta_pre) + a * bilin(eta_post)
    np.testing.assert_allclose(child[ry, rx], want, rtol=1e-13, atol=1e-13)


def _analytic(n, dx, sigma=1.2):
    x = (np.arange(n) + 0.5) * dx
    r2 = ((x - 16.0)[None, :] ** 2 + (x - 16.0)[:, None] ** 2)
    return np.exp(-r2 / (2 * sigma ** 2))


def _fine_truth(r, dt, depth, nsteps):
    """The uniformly fine truth run (in the port; the accuracy tests'
    reference, not a comparison with JAX)."""
    fine = gw.build(32 * r, 32 * r, ndomains=8, dt=dt / r, depth=depth,
                    dx=1.0 / r, dy=1.0 / r, device="cpu")
    fine.set_initial_eta(_analytic(32 * r, 1.0 / r))
    fine.run(nsteps * r)
    return fine.eta.gather_inner_data()


def _refined(P, r, dt, depth, nsteps, two_way):
    parent = P.gw.build(32, 32, ndomains=_dom(P, None), dt=dt, depth=depth,
                        **P.kw)
    parent.set_initial_eta(_analytic(32, 1.0))
    n = _nest(P, parent, origin=(8, 8), shape=(16, 16), ratio=r,
              two_way=two_way)
    n.child.set_initial_eta(_analytic(32 * r, 1.0 / r)
                            [8 * r:24 * r, 8 * r:24 * r])
    n.run(nsteps)
    return [parent.eta.gather_inner_data(), n.child.eta.gather_inner_data()]


def test_refinement_improves_accuracy():
    r, depth, dt, nsteps = 3, 10.0, 0.05, 10
    truth = _fine_truth(r, dt, depth, nsteps)
    pg, cg_all = _both(lambda P: _refined(P, r, dt, depth, nsteps, False))
    inset = 6
    cg = cg_all[inset:-inset, inset:-inset]
    tr = truth[8 * r + inset:24 * r - inset, 8 * r + inset:24 * r - inset]
    err_nested = np.sqrt(np.mean((cg - tr) ** 2))
    y, x = np.mgrid[8 * r + inset:24 * r - inset,
                    8 * r + inset:24 * r - inset]
    y0, x0, wy, wx = nest._t_point_plan(y.ravel() - 8 * r, x.ravel() - 8 * r,
                                        8, 8, r, 32, 32)
    interp = ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
              + wy * ((1 - wx) * pg[y0 + 1, x0] + wx * pg[y0 + 1, x0 + 1]))
    err_coarse = np.sqrt(np.mean((interp.reshape(cg.shape) - tr) ** 2))
    assert err_nested < 0.5 * err_coarse, (err_nested, err_coarse)
    assert err_nested < 0.05 * np.sqrt(np.mean(tr ** 2))


def test_two_way_ratio1_is_identity():
    """At r=1 the feedback writes back the values the parent holds: the
    two-way parent equals a solo parent run bitwise."""
    def run(P):
        solo = _build_parent(P, 48, 48, 1, dt=0.02)
        solo.run(25)
        parent = _build_parent(P, 48, 48, 1, dt=0.02)
        n = _nest(P, parent, origin=(12, 12), shape=(24, 24), ratio=1,
                  two_way=True, child_ndomains=1)
        n.sync_from_parent()
        n.run(25)
        return [parent.eta.gather_inner_data(), solo.eta.gather_inner_data(),
                parent.u.gather_inner_data(), solo.u.gather_inner_data()]

    pe, se, pu, su = _both(run)
    np.testing.assert_array_equal(pe, se)
    np.testing.assert_array_equal(pu, su)


def test_two_way_feedback_improves_parent():
    r, depth, dt, nsteps = 3, 10.0, 0.05, 10
    truth_c = _fine_truth(r, dt, depth, nsteps).reshape(32, r, 32, r).mean(
        (1, 3))
    errs = {}
    for two_way in (False, True):
        pg = _both(lambda P: _refined(P, r, dt, depth, nsteps, two_way))[0]
        errs[two_way] = np.sqrt(np.mean(
            (pg[11:21, 11:21] - truth_c[11:21, 11:21]) ** 2))
    assert errs[True] < 0.6 * errs[False], errs


WINDOWS = (((8, 8), (20, 20), 2), ((36, 32), (20, 24), 1))


def test_nestset_one_way_children_independent():
    """Sibling one-way children in one NestSet: the parent and the first
    child bitwise equal to that nest run alone."""
    def make(P, two_children):
        parent = _build_parent(P, 64, 64, 1, dt=0.02)
        picks = WINDOWS if two_children else WINDOWS[:1]
        nests = [_nest(P, parent, origin=o, shape=s, ratio=rr,
                       child_ndomains=1) for o, s, rr in picks]
        for n in nests:
            n.sync_from_parent()
        return parent, nests

    def run(P):
        parent_set, nests_set = make(P, True)
        P.nest.NestSet(nests_set).run(15)
        parent_solo, nests_solo = make(P, False)
        nests_solo[0].run(15)
        return [parent_set.eta.gather_inner_data(),
                parent_solo.eta.gather_inner_data(),
                nests_set[0].child.eta.gather_inner_data(),
                nests_solo[0].child.eta.gather_inner_data(),
                nests_set[1].child.eta.gather_inner_data()]

    got = _both(run)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[2], got[3])


def test_nestset_mixed_decomposition_invariance():
    def run(P):
        runs = []
        for dom in (1, None):
            parent = _build_parent(P, 64, 64, dom, dt=0.02)
            n1 = _nest(P, parent, origin=(8, 8), shape=(20, 20), ratio=2,
                       two_way=True, child_ndomains=dom)
            n2 = _nest(P, parent, origin=(36, 32), shape=(20, 24), ratio=3,
                       child_ndomains=dom)
            for n in (n1, n2):
                n.sync_from_parent()
            P.nest.NestSet([n1, n2]).run(10)
            runs.extend([parent.eta.gather_inner_data(),
                         n1.child.eta.gather_inner_data(),
                         n2.child.eta.gather_inner_data()])
        return runs

    got = _both(run)
    for a, b in zip(got[:3], got[3:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_DECOMP)


def test_telescoping_r1_bitwise():
    def run(P):
        parent = _build_parent(P, 64, 64, 1, dt=0.02)
        mid = _nest(P, parent, origin=(16, 16), shape=(32, 32), ratio=1,
                    child_ndomains=1)
        mid.sync_from_parent()
        inner = _nest(P, mid.child, origin=(8, 8), shape=(16, 16), ratio=1,
                      child_ndomains=1)
        inner.sync_from_parent()
        P.nest.NestSet([mid, inner]).run(20)
        return [parent.eta.gather_inner_data(),
                mid.child.eta.gather_inner_data(),
                inner.child.eta.gather_inner_data()]

    pg, mg, ig = _both(run)
    np.testing.assert_array_equal(mg[2:-2, 2:-2], pg[18:46, 18:46])
    np.testing.assert_array_equal(ig[2:-2, 2:-2], pg[26:38, 26:38])


def test_telescoping_two_way_cascade_invariance():
    def run(P):
        runs = []
        for dom in (1, None):
            parent = _build_parent(P, 64, 64, dom, dt=0.02)
            mid = _nest(P, parent, origin=(16, 16), shape=(32, 32), ratio=2,
                        two_way=True, child_ndomains=dom)
            mid.sync_from_parent()
            inner = _nest(P, mid.child, origin=(16, 16), shape=(32, 32),
                          ratio=2, two_way=True, child_ndomains=dom)
            inner.sync_from_parent()
            P.nest.NestSet([mid, inner]).run(6)
            runs.extend([parent.eta.gather_inner_data(),
                         mid.child.eta.gather_inner_data(),
                         inner.child.eta.gather_inner_data()])
        return runs

    got = _both(run)
    for a, b in zip(got[:3], got[3:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_DECOMP)


def test_nest_program_is_differentiable():
    """The gradient of the child's eta energy after 3 nest steps with
    respect to the parent's eta flows through the parent step, the ring
    gathers and scatters, the child substeps and the feedback: equal to
    central differences at 1e-6 relative, as the JAX test, and to the
    JAX gradient."""
    grads, fds, vdots = [], [], []
    for P in PKGS:
        parent = _build_parent(P, 32, 32, 1, dt=0.02)
        n = _nest(P, parent, origin=(8, 8), shape=(16, 16), ratio=2,
                  two_way=True, child_ndomains=1)
        n.sync_from_parent()
        prog = n.step_program(3)
        p, c = parent, n.child
        tree0 = (((c.eta.data, c.u.data, c.v.data), ()),)
        shape = tuple(p.eta.data.shape)
        v = np.random.RandomState(0).normal(size=shape)
        eps = 1e-6
        if P is JAX:
            def loss(p_eta):
                out = prog(((p_eta, p.u.data, p.v.data), tree0))
                return jnp.sum(out[1][0][0][0] ** 2)
            g = np.asarray(jax.grad(loss)(p.eta.data))
            vj = jnp.asarray(v, p.eta.data.dtype)
            fd = (float(loss(p.eta.data + eps * vj))
                  - float(loss(p.eta.data - eps * vj))) / (2 * eps)
        else:
            def loss(p_eta):
                out = prog(((p_eta, p.u.data, p.v.data), tree0))
                return torch.sum(out[1][0][0][0] ** 2)
            x = p.eta.data.clone().requires_grad_(True)
            (gt,) = torch.autograd.grad(loss(x), x)
            g = gt.numpy()
            vt = torch.from_numpy(v)
            with torch.no_grad():
                fd = (float(loss(p.eta.data + eps * vt))
                      - float(loss(p.eta.data - eps * vt))) / (2 * eps)
        grads.append(g)
        fds.append(fd)
        vdots.append(float(np.vdot(g, v)))
    np.testing.assert_allclose(vdots[1], fds[1], rtol=1e-6)
    assert float(np.abs(grads[1]).sum()) > 0.0
    scale = float(np.abs(grads[0]).max())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0,
                               atol=TOL_JAX * scale)


def test_nestset_rejections():
    p1 = _build_parent(TORCH, 64, 64, 1, dt=0.02)
    p2 = _build_parent(TORCH, 64, 64, 1, dt=0.02)
    n1 = nest.OneWayNest(p1, origin=(8, 8), shape=(20, 20), ratio=2)
    with pytest.raises(ValueError, match="same parent"):
        nest.NestSet([n1, nest.OneWayNest(p2, origin=(36, 32),
                                          shape=(20, 20), ratio=2)])
    a = nest.OneWayNest(p1, origin=(8, 8), shape=(20, 20), ratio=2,
                        two_way=True)
    b = nest.OneWayNest(p1, origin=(16, 16), shape=(20, 20), ratio=2,
                        two_way=True)
    with pytest.raises(ValueError, match="disjoint"):
        nest.NestSet([a, b])
    with pytest.raises(ValueError, match="at least one"):
        nest.NestSet([])


def test_rejects_bad_windows():
    parent = _build_parent(TORCH, 48, 48, 1, dt=0.02)
    with pytest.raises(ValueError, match="outside the parent"):
        nest.OneWayNest(parent, origin=(40, 40), shape=(16, 16), ratio=2)
    with pytest.raises(ValueError, match="boundary ring must be wet"):
        # window touching the parent's land ring
        nest.OneWayNest(parent, origin=(0, 0), shape=(16, 16), ratio=2)
    with pytest.raises(ValueError, match="ratio"):
        nest.OneWayNest(parent, origin=(8, 8), shape=(16, 16), ratio=0)
    with pytest.raises(ValueError, match="needs >= 4"):
        nest.OneWayNest(parent, origin=(8, 8), shape=(3, 16), ratio=2)
    with pytest.raises(ValueError, match="two-way feedback"):
        nest.OneWayNest(parent, origin=(8, 8), shape=(4, 16), ratio=2,
                        two_way=True)
    ca = gw.build(64, 64, ndomains=1, dt=0.02, depth=10.0,
                  steps_per_sweep=2, device="cpu")
    with pytest.raises(ValueError, match="plain path"):
        nest.OneWayNest(ca, origin=(16, 16), shape=(16, 16), ratio=2)
    fused = gw.build(64, 64, ndomains=1, dt=0.02, depth=10.0, fused=True,
                     device="cpu")
    with pytest.raises(ValueError, match="plain path"):
        nest.OneWayNest(fused, origin=(16, 16), shape=(16, 16), ratio=2)
