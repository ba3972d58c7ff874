"""The port's halo-exchange transports against the JAX package.

The exchange kernel (``csrc/halo_exchange.cu``) and the exchange fused
into the flagship sweep (``csrc/nemolite2d_sweep.cu`` with ``EXCH``) both
evaluate the two-phase exchange as one gather, ``out[Y, X] = in[R(Y),
C(X)]`` (``csrc/halo_remap.cuh``, mirrored by
``parallel.halo.exchange_index``).  On the CPU these tests pin that map
bitwise to the port's plain exchange on every cell over a sweep of tile
counts, boundary conditions, halos, depths, dtypes and level counts, and
to the JAX package's ``exchange`` and remote-DMA ``make_block_exchange``
(interpret mode under a 1D mesh, as tests/test_halo_pallas.py drives it).
The flagship with ``transport="fused"`` runs its plain version here (the
exchange, then the K-step sweep) and is held against the JAX fused
transport and the JAX ppermute model, and variable bathymetry through
the fused step against the JAX ``ht`` path.  The kernels themselves are
held against these plain versions on the card by tests/test_torch_gpu.py
and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta as j_gaussian
from dl_esm_inf_tpu.ops.pallas_step import make_fused_step as j_make_fused
from dl_esm_inf_tpu.parallel import halo as jhalo

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.interop import load_reference_state
from dl_esm_inf_tpu_torch.models import nemolite2d as tnl
from dl_esm_inf_tpu_torch.ops import fused_step as tfs
from dl_esm_inf_tpu_torch.parallel import halo as thalo
from dl_esm_inf_tpu_torch.parallel import halo_kernel as thk

from test_halo_pallas import run_1d
from test_sweep_fused import mesh_1d

torch.set_num_threads(2)

CPU = dict(device="cpu")
RTOL, ATOL = 1e-12, 1e-13       # as tests/test_pallas_step.py

TILES = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (4, 4)]
WRAPS = [(False, False), (True, False), (False, True), (True, True)]
_wrap_id = {(False, False): "walled", (True, False): "x-periodic",
            (False, True): "y-periodic", (True, True): "xy-periodic"}


def _bcs(wrap):
    return tuple(tdl.BC_PERIODIC if w else tdl.BC_EXTERNAL
                 for w in wrap) + (tdl.BC_NONE,)


def _extent(tiles, wrap, halo):
    """A global extent that splits into ``tiles`` with tiles >= halo;
    walled axes carry a remainder (padding in the last tile)."""
    base = max(halo, 5)
    return tuple(base * t + (0 if w else 1) for t, w in zip(tiles, wrap))


def _port_grid(tiles, wrap, halo):
    gnx, gny = _extent(tiles, wrap, halo)
    g = tdl.Grid(tdl.ARAKAWA_C, _bcs(wrap), tdl.OFFSET_NE, **CPU)
    g.decompose(gnx, gny, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


def _jax_grid(tiles, wrap, halo):
    gnx, gny = _extent(tiles, wrap, halo)
    g = jdl.Grid(jdl.ARAKAWA_C, _bcs(wrap), jdl.OFFSET_NE)
    g.decompose(gnx, gny, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=halo)
    jdl.grid_init(g, 1.0, 1.0)
    return g


def _unique(shape, dtype, seed=0):
    """Distinct values per cell, permuted from a seed."""
    n = int(np.prod(shape))
    return np.random.default_rng(seed).permutation(n).reshape(shape).astype(
        dtype)


def _gather(a, spec, depth):
    rows, cols = thalo.exchange_index(spec, depth)
    return a.index_select(-2, rows).index_select(-1, cols)


# --- the map ----------------------------------------------------------------

@pytest.mark.parametrize("halo", [1, 2, 8])
@pytest.mark.parametrize("wrap", WRAPS, ids=_wrap_id.get)
@pytest.mark.parametrize("tiles", TILES, ids=str)
def test_exchange_index_matches_plain_exchange(tiles, wrap, halo):
    """The gather by ``exchange_index`` equals the plain two-phase
    exchange bitwise on every cell, at every depth, for float64 and
    int32, 2D and 3 levels; so does the exchange kernel's wrapper (its
    plain version here)."""
    spec = _port_grid(tiles, wrap, halo).halo_spec
    for depth in range(1, halo + 1):
        for dtype in (np.float64, np.int32):
            for lead in ((), (3,)):
                a = torch.from_numpy(_unique(lead + spec.array_shape, dtype,
                                             depth))
                want = thalo._exchange_blocks((a,), spec, depth)[0]
                assert torch.equal(_gather(a, spec, depth), want), (depth,
                                                                   dtype,
                                                                   lead)
                got = thk.make_block_exchange(spec, depth, lead)(a)
                assert torch.equal(got, want)


@pytest.mark.parametrize("wrap", [(False, False), (True, True)],
                         ids=_wrap_id.get)
@pytest.mark.parametrize("tiles", TILES, ids=str)
def test_exchange_index_matches_jax_exchange(tiles, wrap):
    """Against the JAX ppermute exchange on the 8-device CPU mesh (16
    tiles over-decompose it): depth 1 and 2, float64 and int32, 2D and 3
    levels."""
    gj = _jax_grid(tiles, wrap, 2)
    spec = _port_grid(tiles, wrap, 2).halo_spec
    assert tuple(gj.array_shape) == spec.array_shape
    for depth, dtype, lead in ((1, np.float64, ()), (2, np.float64, ()),
                               (2, np.int32, ()), (2, np.float64, (3,))):
        a = _unique(lead + spec.array_shape, dtype, depth)
        want = np.asarray(jhalo.exchange(a, gj.mesh, gj.halo_spec, depth))
        got = _gather(torch.from_numpy(a), spec, depth).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


#: (tiles, wrap, halo): one split axis (the interpret-mode restriction
#: of the JAX remote-DMA kernel), periodic only along it; 1x1 periodic
#: is the self-loopback case of tests/test_halo_pallas.py
JAX_RDMA_CASES = [((1, 1), (True, False), 1), ((2, 1), (False, False), 2),
                  ((2, 1), (True, False), 1), ((1, 2), (False, True), 2),
                  ((4, 1), (True, False), 8), ((1, 4), (False, False), 8)]


@pytest.mark.parametrize("tiles,wrap,halo", JAX_RDMA_CASES,
                         ids=[f"{t}-{_wrap_id[w]}-h{h}"
                              for t, w, h in JAX_RDMA_CASES])
def test_exchange_index_matches_jax_remote_dma(tiles, wrap, halo):
    """Against the JAX remote-DMA block exchange, driven as
    tests/test_halo_pallas.py drives it (interpret mode, 1D mesh): every
    depth at float64, the full depth at int32, depth 1 with 3 levels."""
    gj = _jax_grid(tiles, wrap, halo)
    spec = _port_grid(tiles, wrap, halo).halo_spec
    cases = [(d, np.float64, ()) for d in range(1, halo + 1)]
    cases += [(halo, np.int32, ()), (1, np.float64, (3,))]
    for depth, dtype, lead in cases:
        a = _unique(lead + spec.array_shape, dtype, depth)
        want = run_1d(gj, jnp.asarray(a), depth=depth)
        got = _gather(torch.from_numpy(a), spec, depth).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((depth, dtype,
                                                              lead)))


def test_exchange_index_guards():
    spec = _port_grid((2, 2), (False, False), 2).halo_spec
    with pytest.raises(ValueError, match="depth"):
        thalo.exchange_index(spec, 3)
    with pytest.raises(ValueError, match="depth"):
        thk.make_block_exchange(spec, 0)
    with pytest.raises(ValueError, match="lead_shape"):
        thk.make_block_exchange(spec, 1, (0,))
    fn = thk.make_block_exchange(spec, 1, (3,))
    with pytest.raises(ValueError, match="block"):
        fn(torch.zeros(spec.array_shape, dtype=torch.float64))
    over = thalo.HaloSpec(**{**spec.__dict__, "repx": 1})
    with pytest.raises(NotImplementedError, match="every tile"):
        thalo.exchange_index(over, 1)


def test_exchange_kernel_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain exchange is never taken for it."""
    spec = _port_grid((2, 2), (True, True), 2).halo_spec
    meta = torch.empty(spec.array_shape, dtype=torch.float64, device="meta")
    before = thk.halo_exchange.launches
    with pytest.raises(ValueError, match="CUDA"):
        thk.exchange_kernel(meta, spec, 1)
    assert thk.halo_exchange.launches == before


# --- the fused transport -----------------------------------------------------

GNX, GNY = 48, 64


def _port_flagship(tiles, K, transport, depth=100.0, halo=8, gnx=GNX,
                   gny=GNY):
    g = tdl.Grid(tdl.ARAKAWA_C, _bcs((False, False)), tdl.OFFSET_NE, **CPU)
    g.decompose(gnx, gny, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=halo)
    tdl.grid_init(g, 1000.0, 1000.0, tnl.default_tmask(gnx, gny))
    m = tnl.NemoLite2D(g, depth=depth)
    m.enable_fast_path(K, transport=transport)
    return m


def _jax_flagship(tiles, gnx=GNX, gny=GNY, depth=100.0):
    """The JAX model as tests/test_sweep_fused.py builds it."""
    g = jdl.Grid(jdl.ARAKAWA_C, _bcs((False, False)), jdl.OFFSET_NE)
    g.decompose(gnx, gny, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=8, align=128, align_y=8)
    jdl.grid_init(g, 1000.0, 1000.0, jnl.default_tmask(gnx, gny))
    return jnl.NemoLite2D(g, depth=depth)


def _jax_fused_transport(tiles, K, nsweeps, ssh0):
    """The JAX fused transport (the exchange inside the sweep), driven
    per axis under a 1D mesh as tests/test_sweep_fused.py:148-212 drives
    it; returns the gathered state."""
    mb = _jax_flagship(tiles)
    mb.set_initial_ssh(ssh0)
    spec = mb.grid.halo_spec
    fused = j_make_fused(
        spec.local_ny, spec.local_nx, str(mb.grid.dtype), mb.p, mb.grid.dx,
        mb.grid.dy, mb._fcor, mb.depth, interpret=True, steps_per_sweep=K,
        exchange_spec=spec, exchange_logical_ids=True)
    mesh, pspec = mesh_1d(mb.grid)
    tm = jax.device_put(np.asarray(mb._mask_codes),
                        NamedSharding(mesh, pspec))
    state = [jax.device_put(np.asarray(x), NamedSharding(mesh, pspec))
             for x in (mb.sshn_t.data, mb.un.data, mb.vn.data)]
    dtype = jnp.dtype(str(mb.grid.dtype))

    def body(istep0, s_, u_, v_, tm_):
        rtimes = (istep0 + 1 + jnp.arange(K)).astype(dtype) * mb.p.rdt
        return fused(s_, u_, v_, tm_, jnl.tidal_forcing(rtimes, mb.p))

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(P(),) + (pspec,) * 4,
                               out_specs=(pspec,) * 3, check_vma=False))
    for s in range(nsweeps):
        state = list(fn(jnp.int32(s * K), *state, tm))
    for fld, out in zip((mb.sshn_t, mb.un, mb.vn), state):
        fld.data = jax.device_put(np.asarray(out), mb.grid.sharding)
    return mb.gather()


def _close(got, want, rtol=RTOL, atol=ATOL):
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("split,K", [("x", 2), ("y", 2), ("y", 4),
                                     ("x", 4)])
def test_fused_transport_matches_jax(split, K):
    """The port's flagship with transport="fused" (on the CPU: the
    exchange at the full halo depth, then the K-step sweep) over three
    sweeps: bitwise equal to the port's ppermute transport, and within
    1e-12 of the JAX fused transport and the JAX ppermute model (the
    forcing is evaluated on the host by torch in the port and inside the
    graph by XLA in the JAX package, an ulp apart at some steps)."""
    tiles = (4, 1) if split == "x" else (1, 4)
    nsweeps, ssh0 = 3, j_gaussian(GNX, GNY, amp=0.2)
    got = {}
    for transport in ("fused", "ppermute"):
        m = _port_flagship(tiles, K, transport)
        m.set_initial_ssh(ssh0)
        m.run(nsweeps * K)
        got[transport] = m.gather()
    for k in got["fused"]:
        np.testing.assert_array_equal(got["fused"][k], got["ppermute"][k])
    _close(got["fused"], _jax_fused_transport(tiles, K, nsweeps, ssh0))
    ma = _jax_flagship(tiles)
    ma.enable_pallas(interpret=True, steps_per_sweep=K)
    ma.set_initial_ssh(ssh0)
    ma.run(nsweeps * K)
    _close(got["fused"], ma.gather())


def test_model_transport_wiring_single_device():
    """As tests/test_sweep_fused.py:215-236: transport="fused" through
    the model API on one walled tile equals the ppermute transport
    exactly, K = 2 with a remainder step, and the JAX model at 1e-12."""
    ssh0 = j_gaussian(48, 32, amp=0.3)
    got = {}
    for transport in ("ppermute", "fused"):
        m = tnl.build(48, 32, ndomains=1, halo_width=8, fused=True,
                      steps_per_sweep=2, **CPU)
        m.enable_fast_path(2, transport=transport)
        m.set_initial_ssh(ssh0)
        m.run(7)
        got[transport] = m.gather()
    assert m._transport == "fused" and m._in_sweep_exchange
    for k in got["fused"]:
        np.testing.assert_array_equal(got["fused"][k], got["ppermute"][k])
    mj = jnl.build(48, 32, ndomains=1, halo_width=8, open_north=True,
                   pallas=True, steps_per_sweep=2)
    mj.enable_pallas(interpret=True, steps_per_sweep=2, transport="fused")
    mj.set_initial_ssh(ssh0)
    mj.run(7)
    _close(got["fused"], mj.gather())


def test_fused_transport_guards():
    m = _port_flagship((2, 2), 2, "ppermute", halo=4, gnx=32, gny=32)
    with pytest.raises(ValueError, match="unknown transport"):
        m.enable_fast_path(2, transport="smoke-signals")
    # a refused configuration leaves the model as it was
    with pytest.raises(ValueError, match="halo_width >= 6"):
        m.enable_fast_path(3, transport="fused")
    assert (m._transport, m._sweep_K, m.use_fused) == ("ppermute", 2, True)
    m.enable_fast_path(2, transport="plain")          # the old name
    assert m._transport == "ppermute"
    m.enable_fast_path(2, transport="fused")
    with pytest.raises(ValueError, match="redundant"):
        m.step_program(4, overlap=True)
    spec = m.grid.halo_spec
    p = tnl.Params()
    ly, lx = spec.array_shape
    with pytest.raises(ValueError, match="erosion"):
        tfs.make_fused_step(ly, lx, torch.float64, p, 1000.0, 1000.0, 1e-4,
                            100.0, steps_per_sweep=3, exchange_spec=spec)
    with pytest.raises(ValueError, match="block"):
        tfs.make_fused_step(ly, lx + 1, torch.float64, p, 1000.0, 1000.0,
                            1e-4, 100.0, exchange_spec=spec)
    fused = tfs.make_fused_step(ly, lx, torch.float64, p, 1000.0, 1000.0,
                                1e-4, 100.0, exchange_spec=spec)
    s = torch.zeros(spec.array_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="uniform state"):
        fused(s, s.float(), s, m._mask_codes, [0.0])


def test_fused_sweep_equals_exchange_then_sweep():
    """The fused sweep's plain version is the exchange at the full halo
    depth followed by the sweep: bitwise on every cell, on a doubly
    periodic 1x1 grid (the self-loopback case) and on 2x2 tiles."""
    p = tnl.Params()
    for tiles in ((1, 1), (2, 2)):
        g = _port_grid(tiles, (True, True), 8)
        spec = g.halo_spec
        rng = np.random.default_rng(tiles[0])
        state = [torch.from_numpy(a * rng.standard_normal(spec.array_shape))
                 for a in (0.2, 0.05, 0.05)]
        codes = tnl.encode_masks(g.tmask)
        for K in (1, 4):
            mk = dict(steps_per_sweep=K)
            args = (*spec.array_shape, torch.float64, p, 1000.0, 1000.0,
                    1e-4, 100.0)
            forcing = [0.01 * (k + 1) for k in range(K)]
            got = tfs.make_fused_step(*args, exchange_spec=spec, **mk)(
                *state, codes, forcing)
            ex = [thalo.exchange(a, spec, spec.halo) for a in state]
            want = tfs.make_fused_step(*args, **mk)(*ex, codes, forcing)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


# --- variable bathymetry through the fused step -------------------------------

def _depth(gnx, gny):
    yy = np.linspace(0.0, 1.0, gny)[:, None]
    xx = np.linspace(0.0, 1.0, gnx)[None, :]
    return 60.0 + 50.0 * yy + 15.0 * np.sin(3.0 * np.pi * xx)


@pytest.mark.parametrize("tiles,K,transport", [((2, 2), 2, "ppermute"),
                                               ((1, 4), 4, "fused")])
def test_variable_bathymetry_fused_step_matches_jax(tiles, K, transport):
    """JAX runs the flagship with a depth plane on its Pallas sweep
    (interpret mode); the port takes its state over through interop and
    both go on on their fused paths (the port's: the ht plane through
    the fused step's plain version, with the given transport): 1e-12."""
    n1, n2 = 5, 2 * K + 1
    depth = _depth(GNX, GNY)
    mj = _jax_flagship(tiles, depth=depth)
    mj.enable_pallas(interpret=True, steps_per_sweep=K)
    mj.set_initial_ssh(j_gaussian(GNX, GNY, amp=0.3))
    mj.run(n1)
    mt = _port_flagship(tiles, K, transport, depth=depth)
    load_reference_state(mt, dict(mj.gather(), depth=depth,
                                  tmask=tnl.default_tmask(GNX, GNY)),
                         istep0=n1)
    assert mt._ht is not None
    mj.run(n2)
    mt.run(n2)
    _close(mt.gather(), mj.gather())
