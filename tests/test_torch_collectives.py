"""The port's collectives (dl_esm_inf_tpu_torch/parallel/collectives.py)
on the CPU, no gang: every rank of a gang of 2, 3 or 4 ranks simulated
in one process (``seam.seam_reference``), each collective one gather of
the ranks' parts by ``halo._send_recv`` and an all-reduce their fold in
rank order.

Every rank's result is bitwise the same as every other rank's and as
numpy's rank-order fold of the same seeded parts; against the JAX
package's reduction of the same data over the conftest's CPU devices
(``lax.psum``/``pmin``/``pmax`` under ``shard_map``, or its
``global_sum``/``min``/``max``) MIN and MAX are bitwise, and a sum is
bitwise at 2 ranks and within ``SUM_RTOL`` of the summands' magnitude
at 3 and 4, where XLA may add the ranks' parts in another order.  Also:
the gathers against the whole stacked layout, the gradients of ``psum``,
``pbroadcast`` and ``all_gather`` against their transposition rules, the
collectives' tag beside the exchange's, the one-rank identities, and the
Helmholtz CG solve across 2 simulated ranks against the JAX package's
one-process solve.  The transport on the card runs in chip_smoke.py.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.core import layout as jlayout
from dl_esm_inf_tpu.parallel import collectives as jcoll

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.core import layout as tlayout
from dl_esm_inf_tpu_torch.parallel import collectives as tcoll
from dl_esm_inf_tpu_torch.parallel import environment as tenv
from dl_esm_inf_tpu_torch.parallel import halo as thalo
from dl_esm_inf_tpu_torch.parallel import rdma as trdma
from dl_esm_inf_tpu_torch.parallel import seam
from dl_esm_inf_tpu_torch.parallel.halo import HaloSpec

torch.set_num_threads(2)

WALLED = (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL, jdl.BC_NONE)

OPS = {"sum": (dist.ReduceOp.SUM, np.add, jax.lax.psum),
       "min": (dist.ReduceOp.MIN, np.minimum, jax.lax.pmin),
       "max": (dist.ReduceOp.MAX, np.maximum, jax.lax.pmax)}
DTYPES = {"f32": (torch.float32, np.float32),
          "f64": (torch.float64, np.float64)}
#: a sum of n parts against the JAX package's at 3 and 4 ranks, relative
#: to the sum of the parts' magnitudes: an order of n additions differs
#: from another by at most (n - 1) units of round-off of that magnitude
#: (3.3e-16 at f64, 1.8e-7 at f32 for 4 ranks); at 2 ranks bitwise
SUM_RTOL = {"f64": 1e-15, "f32": 1e-6}


def _fold(parts, fold):
    """numpy's rank-order fold: ``fold(fold(parts[0], parts[1]), ...)``."""
    out = parts[0]
    for p in parts[1:]:
        out = fold(out, p)
    return out


_JAX_REDUCE = {}


def _jax_reduce(parts: np.ndarray, op: str) -> np.ndarray:
    """The JAX package's reduction of ``parts`` (rank r's part is
    ``parts[r]``) over as many of the conftest's CPU devices:
    ``lax.psum``/``pmin``/``pmax`` under ``shard_map``."""
    n = parts.shape[0]
    key = (n, op)
    if key not in _JAX_REDUCE:
        mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
        red = OPS[op][2]
        _JAX_REDUCE[key] = jax.jit(jax.shard_map(
            lambda x: red(x[0], "r"), mesh=mesh, in_specs=P("r"),
            out_specs=P()))
    return np.asarray(_JAX_REDUCE[key](jnp.asarray(parts)))


def _seeded_parts(n: int, shape: tuple, np_dtype, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np_dtype)


# --- all_reduce -----------------------------------------------------------

@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("shape", [(), (5,)], ids=["0d", "vector"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nranks", [2, 3, 4])
def test_all_reduce_folds_in_rank_order(nranks, dtype, shape, op):
    """Every simulated rank's all_reduce of its seeded part: the same bits
    on every rank, equal bitwise to numpy's rank-order fold, on the part's
    dtype, shape and device without a gradient; against the JAX
    package's psum/pmin/pmax of the same parts bitwise (a sum at 3 and 4
    ranks within SUM_RTOL of the parts' magnitude)."""
    tdt, ndt = DTYPES[dtype]
    rop, nfold, _ = OPS[op]
    parts = _seeded_parts(nranks, shape, ndt, seed=nranks * 10 + len(shape))
    got = seam.seam_reference([
        lambda r=r: tcoll.all_reduce(torch.as_tensor(parts[r]), rop)
        for r in range(nranks)])
    want = _fold(list(parts), nfold)
    for r, g in enumerate(got):
        assert g.dtype == tdt and tuple(g.shape) == shape, r
        assert g.device.type == "cpu" and not g.requires_grad
        np.testing.assert_array_equal(g.numpy(), want, err_msg=str(r))
        assert torch.equal(g, got[0])
    ref = _jax_reduce(parts, op)
    if op != "sum" or nranks == 2:
        np.testing.assert_array_equal(got[0].numpy(), ref)
    else:
        scale = np.abs(parts.astype(np.float64)).sum(axis=0)
        err = np.abs(got[0].numpy().astype(np.float64) - ref)
        assert np.all(err <= SUM_RTOL[dtype] * scale), (err, scale)


@pytest.mark.parametrize("nranks", [2, 3, 4])
def test_global_reductions_match_jax(nranks):
    """global_sum/min/max and masked_sum of each simulated rank's rows of
    a seeded 12 x 5 float64 array against the JAX package's global
    reductions of the whole array: min and max bitwise, the sums within
    1e-14 of the sum of magnitudes (a block's 60 or fewer additions in
    torch's order and XLA's differ by at most 59 units of round-off,
    6.6e-15); every rank the same bits."""
    rng = np.random.default_rng(nranks)
    a = rng.standard_normal((12, 5))
    m = (rng.random((12, 5)) > 0.3).astype(np.int32)
    rows = 12 // nranks

    def program(r):
        blk = torch.from_numpy(a[r * rows:(r + 1) * rows])
        mk = torch.from_numpy(m[r * rows:(r + 1) * rows])
        return (tcoll.global_sum(blk), tcoll.global_min(blk),
                tcoll.global_max(blk), tcoll.masked_sum(blk, mk))
    got = seam.seam_reference([lambda r=r: program(r)
                               for r in range(nranks)])
    assert all(g == got[0] for g in got)
    s, lo, hi, ms = got[0]
    ja = jnp.asarray(a)
    assert lo == jcoll.global_min(ja) and hi == jcoll.global_max(ja)
    scale = np.abs(a).sum()
    assert abs(s - jcoll.global_sum(ja)) <= 1e-14 * scale
    assert abs(ms - jcoll.masked_sum(ja, jnp.asarray(m))) <= 1e-14 * scale


def test_other_ops_raise():
    """An op other than SUM, MIN and MAX raises naming it, in one process
    and on simulated ranks."""
    with pytest.raises(ValueError, match="PRODUCT.*not one of SUM, MIN, MAX"):
        tcoll.all_reduce(torch.ones(2), dist.ReduceOp.PRODUCT)
    with pytest.raises(ValueError, match="AVG"):
        seam.seam_reference([
            lambda: tcoll.all_reduce(torch.ones(2), dist.ReduceOp.AVG)] * 2)


def test_one_rank_returns_what_it_returned():
    """With one rank no part moves and nothing is copied that was not:
    all_reduce, psum and pbroadcast return their argument, all_gather a
    view of it, gather_to_host a new array."""
    x = torch.arange(6.0).reshape(2, 3)
    assert tcoll.all_reduce(x) is x
    assert tcoll.all_reduce(x, dist.ReduceOp.MAX) is x
    assert tcoll.psum(x) is x and tcoll.pbroadcast(x) is x
    g = tcoll.all_gather(x)
    assert g.shape == (1, 2, 3) and g.data_ptr() == x.data_ptr()
    h = tcoll.gather_to_host(x)
    assert np.array_equal(h, x.numpy())
    assert not np.shares_memory(h, x.numpy())


def test_parts_move_as_planes_in_one_symmetric_batch():
    """A collective on rank 1 of 3 is one batch of halo._send_recv: its
    part to ranks 0 and 2 and theirs from both, on the collectives' tag,
    each a (1, numel) plane the seam transport takes (rows at one
    pitch), a 0-d part too."""
    batches = []

    def record(sends, recvs):
        batches.append(([(tuple(t.shape), p, a, tag) for t, p, a, tag in
                         sends],
                        [(tuple(t.shape), p, a, tag) for t, p, a, tag in
                         recvs]))
        for t, p, _, _ in recvs:
            assert seam._plane(t) is not None
            t.fill_(10.0 * p)
    sim = tenv.simulated
    sim.rank, sim.ranks, sim.send_recv = 1, 3, record
    try:
        s = tcoll.all_reduce(torch.tensor(1.0))
        v = tcoll.all_gather(torch.ones(2, 2))
    finally:
        del sim.rank, sim.ranks, sim.send_recv
    tag = tcoll.COLLECTIVE_TAG
    assert tag not in (0, 1)
    assert batches == [
        ([((1, 1), 0, True, tag), ((1, 1), 2, True, tag)],
         [((1, 1), 0, True, tag), ((1, 1), 2, True, tag)]),
        ([((1, 4), 0, True, tag), ((1, 4), 2, True, tag)],
         [((1, 4), 0, True, tag), ((1, 4), 2, True, tag)])]
    assert float(s) == 0.0 + 1.0 + 20.0
    assert torch.equal(v[:, 0, 0], torch.tensor([0.0, 1.0, 20.0]))


def test_no_process_group_collective_left():
    """The collectives module calls no collective of the process group:
    every part moves by halo._send_recv."""
    src = inspect.getsource(tcoll)
    assert "dist.all_reduce" not in src and "dist.all_gather" not in src


# --- the gathers ----------------------------------------------------------

def _spec_and_jax(ranks, tiles):
    """(the port's spec of ``ranks`` = (x, y) ranks of ``tiles`` tiles
    each, the JAX package's grid of the same tiles in one process)."""
    px, py = ranks[0] * tiles[0], ranks[1] * tiles[1]
    gnx, gny = 6 * px + 1, 5 * py + 1
    gj = jdl.Grid(jdl.ARAKAWA_C, WALLED, jdl.OFFSET_NE)
    gj.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=2)
    jdl.grid_init(gj, 1.0, 1.0)
    gt = tdl.Grid(tdl.ARAKAWA_C, WALLED, tdl.OFFSET_NE, device="cpu")
    gt.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=2)
    spec = HaloSpec(**{**gt.halo_spec.__dict__, "repx": tiles[0],
                       "repy": tiles[1]})
    assert (spec.ranks_x, spec.ranks_y) == tuple(ranks)
    return spec, gj


def _blocks(a, spec):
    """Whole stacked array -> the ranks' blocks, rank order."""
    ly, lx = spec.array_shape
    return [a[..., iy * ly: (iy + 1) * ly, ix * lx: (ix + 1) * lx]
            for iy, ix in (spec.rank_coords(r)
                           for r in range(spec.num_ranks))]


@pytest.mark.parametrize("ranks,tiles", [((2, 1), (1, 2)), ((1, 2), (2, 1)),
                                         ((3, 1), (1, 1)), ((2, 2), (2, 1))],
                         ids=str)
def test_gather_to_host_with_a_grid_spec(ranks, tiles):
    """Each simulated rank's gather_to_host of its block of a seeded whole
    stacked array (float64 2-D, float32 with 3 levels, the int32 tmask
    layout), placed by the grid's halo spec: the whole array on every
    rank, bitwise, equal to the JAX package's gather_to_host of the same
    array sharded over its grid's mesh; a new array each time."""
    spec, gj = _spec_and_jax(ranks, tiles)
    rng = np.random.default_rng(sum(ranks) + sum(tiles))
    shape = spec.global_array_shape
    arrays = [rng.standard_normal(shape),
              rng.standard_normal((3,) + shape).astype(np.float32),
              rng.integers(0, 2, shape).astype(np.int32)]
    blocks = [_blocks(torch.from_numpy(a), spec) for a in arrays]
    got = seam.seam_reference([
        lambda r=r: [tcoll.gather_to_host(b[r], spec) for b in blocks]
        for r in range(spec.num_ranks)])
    for k, a in enumerate(arrays):
        sharded = jax.device_put(a, NamedSharding(
            gj.mesh, P(*((None,) * (a.ndim - 2)), "y", "x")))
        want = jcoll.gather_to_host(sharded)
        for r, g in enumerate(got):
            assert g[k].dtype == a.dtype
            np.testing.assert_array_equal(g[k], a, err_msg=f"{k} {r}")
            np.testing.assert_array_equal(g[k], want)
    assert not np.shares_memory(got[0][0], got[1][0])


def test_gather_to_host_needs_the_runs_spec():
    """Across ranks without a spec, or with a spec of another rank grid,
    gather_to_host raises on every rank."""
    spec, _ = _spec_and_jax((2, 1), (1, 1))
    for bad in (None, HaloSpec(**{**spec.__dict__, "repx": 2})):
        with pytest.raises(ValueError, match="halo spec"):
            seam.seam_reference([
                lambda: tcoll.gather_to_host(torch.zeros(2, 2), bad)] * 2)


@pytest.mark.parametrize("nranks", [2, 3, 4])
def test_all_gather_stacks_in_rank_order(nranks):
    """all_gather of each simulated rank's seeded band (a vector, as the
    nest's) and of a 2-D part: every rank's stack bitwise numpy's stack
    of the parts in rank order."""
    band = _seeded_parts(nranks, (7,), np.float64, seed=nranks)
    plane = _seeded_parts(nranks, (2, 3), np.float32, seed=nranks + 1)
    got = seam.seam_reference([
        lambda r=r: (tcoll.all_gather(torch.from_numpy(band[r])),
                     tcoll.all_gather(torch.from_numpy(plane[r])))
        for r in range(nranks)])
    for g_band, g_plane in got:
        np.testing.assert_array_equal(g_band.numpy(), band)
        np.testing.assert_array_equal(g_plane.numpy(), plane)


# --- gradients across 2 simulated ranks -----------------------------------

def test_gradients_follow_the_transposition_rules():
    """Across 2 simulated ranks (each rank's backward pass on its own
    thread, as its forward): psum passes the cotangent through (the
    gradient of psum(sum(x^2 m)) is 2 x m on each rank's block); a
    pbroadcast value's gradient sums every rank's cotangent once
    (d/da psum(sum(a_k x_k)) is the sum of every rank's x, d/dx is a);
    all_gather's sums the ranks' weights of this rank's part (each rank
    weights every part by its own seeded weights, mp_check's autograd
    probe)."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 4, 3))
    ms = rng.standard_normal((2, 4, 3))
    a0 = rng.standard_normal(4)
    wts = rng.standard_normal((2, 2, 5))           # rank, part, component
    parts = rng.standard_normal((2, 5))

    def program(r):
        x = torch.from_numpy(xs[r]).requires_grad_(True)
        m = torch.from_numpy(ms[r])
        (g_psum,) = torch.autograd.grad(tcoll.psum((x ** 2 * m).sum()), x)
        a = torch.from_numpy(a0).requires_grad_(True)
        c = tcoll.psum((tcoll.pbroadcast(a)[:, None] * x).sum())
        g_a, g_x = torch.autograd.grad(c, (a, x))
        part = torch.from_numpy(parts[r]).requires_grad_(True)
        w = torch.from_numpy(wts[r])
        (g_part,) = torch.autograd.grad(
            tcoll.psum((tcoll.all_gather(part) * w).sum()), part)
        return g_psum, g_a, g_x, g_part
    got = seam.seam_reference([lambda r=r: program(r) for r in range(2)])
    for r, (g_psum, g_a, g_x, g_part) in enumerate(got):
        np.testing.assert_allclose(g_psum.numpy(), 2 * xs[r] * ms[r],
                                   rtol=1e-15)
        np.testing.assert_allclose(g_a.numpy(), xs.sum(axis=(0, 2)),
                                   rtol=1e-14)
        np.testing.assert_array_equal(g_x.numpy(),
                                      np.broadcast_to(a0[:, None], (4, 3)))
        np.testing.assert_array_equal(g_part.numpy(),
                                      wts[0, r] + wts[1, r])
    assert torch.equal(got[0][1], got[1][1])


# --- the tags -------------------------------------------------------------

def test_exchange_and_all_reduce_interleaved():
    """An exchange, an all_reduce of a partial sum of the exchanged block,
    another exchange and an all_gather, in one program on each of 2x2
    simulated ranks (periodic), one rank run five turns ahead: each
    result equals the same collective run alone, bitwise; the strips and
    the parts move on edges of their own tags (0 and 1 for the exchange,
    the collectives' tag for the parts)."""
    px, py = 2, 2
    spec = HaloSpec(nprocx=px, nprocy=py, halo=2, tile_nx=5, tile_ny=5,
                    local_nx=9, local_ny=9, wrap_x=True, wrap_y=True)
    whole = HaloSpec(**{**spec.__dict__, "repx": px, "repy": py})
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        whole.array_shape))
    blocks = _blocks(a, spec)

    def program(r):
        e1 = thalo.exchange(blocks[r], spec, 2)
        s = tcoll.all_reduce(e1.sum())
        e2 = thalo.exchange(e1 * s, spec, 1)
        g = tcoll.all_gather(e2[2, 2:4])
        return e1, s, e2, g
    fence = trdma.FenceModel()
    got = seam.seam_reference([lambda r=r: program(r) for r in range(4)],
                              order=[1] * 5 + [0, 2, 3], fence=fence)
    e1_alone = [b.contiguous()
                for b in _blocks(thalo.exchange(a, whole, 2), spec)]
    s_alone = seam.seam_reference([lambda r=r: tcoll.all_reduce(
        e1_alone[r].sum()) for r in range(4)])
    e1s = torch.cat([torch.cat(e1_alone[:2], -1),
                     torch.cat(e1_alone[2:], -1)], -2)
    e2_alone = _blocks(thalo.exchange(e1s * s_alone[0], whole, 1), spec)
    for r, (e1, s, e2, g) in enumerate(got):
        assert torch.equal(e1, e1_alone[r]) and torch.equal(s, s_alone[r])
        assert torch.equal(e2, e2_alone[r])
        assert torch.equal(g, torch.stack([e[2, 2:4] for e in e2_alone]))
    tags = {slot[2] for _, kind, slot in fence.trace if kind == "signal"}
    assert tags == {0, 1, tcoll.COLLECTIVE_TAG}


# --- a solve across ranks -------------------------------------------------

def test_cg_solve_on_simulated_ranks_matches_jax():
    """The Helmholtz CG solve (ops/solvers.py; lam 50, an island, tol
    1e-12) on a 2-rank decomposition of a 32^2 float64 grid, every rank
    simulated, its dot products all-reduced in rank order: both ranks
    the same solution bitwise, within 1e-12 of the JAX package's
    one-process solve on the same 2 tiles on wet points, with the same
    iteration count, converged."""
    from dl_esm_inf_tpu.ops import solvers as jso

    from dl_esm_inf_tpu_torch.ops import solvers as tso
    from dl_esm_inf_tpu_torch.parallel import mp_check as mp
    n = 32

    def program():
        g, rhs = mp.solver_case(n, 2, "cpu")
        b = tdl.Field(g, tdl.T_POINTS, init_global_data=rhs)
        s = tso.HelmholtzSolver(g, mp.LAM, mp.LAM, tol=1e-12, method="cg")
        x, info = s.solve(b)
        return tlayout.unstack_internal(
            g.decomp, tcoll.gather_to_host(x, g.halo_spec)), info
    (x0, i0), (x1, i1) = seam.seam_reference([program, program])
    assert np.array_equal(x0, x1) and i0 == i1
    tm = mp.island_tmask(n)
    rhs = np.random.default_rng(3).standard_normal((n, n)) * (tm == 1)
    g = jdl.Grid(jdl.ARAKAWA_C, WALLED, jdl.OFFSET_NE)
    g.decompose(n, n, ndomains=2, halo_width=4)
    jdl.grid_init(g, 1.0, 1.0, tm)
    s = jso.HelmholtzSolver(g, mp.LAM, mp.LAM, tol=1e-12, method="cg")
    x, info = s.solve(jdl.Field(g, jdl.T_POINTS, init_global_data=rhs))
    want = jlayout.unstack_internal(g.decomp, np.asarray(x))
    np.testing.assert_allclose(x0 * (tm == 1), want * (tm == 1), rtol=0,
                               atol=1e-12)
    assert i0["iterations"] == info["iterations"]
    assert i0["converged"] and i0["rel_res"] <= 1e-12
