"""The port across ranks on the CPU: gangs of the port's launcher over
gloo against the JAX package's single-process run, the fence oracles on
the fence's plain version, and the simulated remote-DMA protocol against
the JAX exchange.  The 4-rank gang also runs the flagship with
``transport="fused"`` (the exchange between ranks inside the sweep, its
plain version here) on 4x1, 1x4 and 2x2 rank layouts: the 4x1 and 1x4
runs against the JAX fused-transport kernel bitwise at float64 (driven
in a child process, tests/jax_fused_reference.py, whose XLA emits no
FMA, so that it rounds where the port does), the 2x2 run against the
port's single-process 4-tile run on the ppermute transport, bitwise; and
sweeps alternating with standalone exchanges, and a skewed rank; and
the flagship's overlap mode (one tile per rank, 2x2) against the
non-overlapped step bitwise and the JAX package's 4-device overlap run.
A second 2-rank gang (2 ranks x 4 tiles, its own timeout) runs the
slice across ranks: the Helmholtz solver (CG and the fused Chebyshev
sweep's plain version), the semi-implicit model, the client models on
their sweeps' plain versions, invoke and Schedule (plain, fused,
reductions), the PSy flagship, the coupled tracer and the checkpoint,
each against the JAX package's single-process run on 8 tiles at its own
JAX twin's tolerance (the checkpoint bitwise, also loaded here).  A third
2-rank gang (2 ranks x 4 tiles, its own timeout) runs the ensemble and
the ETKF/LETKF, the adjoint (cost and gradient of three models, Adam,
L-BFGS and hybrid 4D-EnVar) and grid nesting, each against the JAX
package's single-process run at float64 (L-BFGS, whose line search is
not optax's, against the port's), and probes the transposes autograd
crosses: the strip transfer and the exchange, and the differentiable
collectives; the 4-rank gang runs the flagship's adjoint and the probes
on a 2x2 rank grid, whose corners transpose by sequencing.

Gangs run ``python -m dl_esm_inf_tpu_torch.launch -n N -m
dl_esm_inf_tpu_torch.parallel.mp_check`` (the port's counterpart of
tests/mp_worker.py) on CPU ranks at float64, one gang per rank count,
each bounded by a timeout that stops it; every comparison is with this
process's JAX run on the conftest's 8-device CPU mesh, as
tests/test_multiprocess.py compares: the hill, round trip and periodic
legs bitwise, the checksum exact, the flagship within 1e-12 / 1e-13.
The kernels (``csrc/halo_exchange_rdma.cu``, ``csrc/fence_oracle.cu``,
``csrc/nemolite2d_sweep_rdma.cu``) run on the card only (``chip_smoke.py``); here their plain versions do.
"""
import itertools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from filelock import FileLock

import jax.numpy as jnp

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.core import layout as jlayout
from dl_esm_inf_tpu.models import nemolite2d as jnl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu.parallel import halo as jhalo
from dl_esm_inf_tpu.testing import init_field_hill

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.core.grid import rank_grid
from dl_esm_inf_tpu_torch.launch import launch
from dl_esm_inf_tpu_torch.parallel import environment as tenv
from dl_esm_inf_tpu_torch.parallel import fence_oracle as tfo
from dl_esm_inf_tpu_torch.parallel import rdma as trdma
from dl_esm_inf_tpu_torch.parallel.halo import HaloSpec

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
GANG_TIMEOUT = 120.0
JAX_FUSED_TIMEOUT = 300.0
RTOL, ATOL = 1e-12, 1e-13          # tests/test_multiprocess.py:124-125

WALLED = (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL, jdl.BC_NONE)
PERIODIC = (jdl.BC_PERIODIC, jdl.BC_PERIODIC, jdl.BC_NONE)


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k not in tenv.ENV_PROTOCOL}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + sys.path)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _session_root(tmp_path_factory):
    """The test session's shared temporary root: under xdist the workers'
    base temporaries are siblings in it."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get("PYTEST_XDIST_WORKER") else root


def _once(root, name, run):
    """The arrays of ``root / name.npz``, made once per test session: the
    first caller runs ``run(tmp)`` under a lock the workers share, which
    writes ``tmp`` and returns None, or returns its failure's message;
    later callers read the file.  A failure is written beside it
    (``name.failed``), and every later caller, in any worker, fails with
    that message without running again."""
    out = root / f"{name}.npz"
    failed = root / f"{name}.failed"
    with FileLock(str(out) + ".lock"):
        if failed.exists():
            pytest.fail(failed.read_text(), pytrace=False)
        if not out.exists():
            tmp = root / f"{name}.tmp.npz"
            msg = run(tmp)
            if msg is not None:
                failed.write_text(msg)
                pytest.fail(msg, pytrace=False)
            os.replace(tmp, out)
    return dict(np.load(out))


def _gang(tmp_path_factory, nproc, ndomains, legs, *extra, name=None,
          timeout=GANG_TIMEOUT):
    """Rank 0's results of one gang (``name``: its files' stem), run once
    per test session (:func:`_once`); a gang that fails reports its exit
    code or ``TimeoutError``, its seconds against ``timeout`` and the
    end of the ranks' stderr."""
    root = _session_root(tmp_path_factory)
    name = name or f"torch_mp_np{nproc}"

    def run(tmp):
        log = root / f"{name}.stderr"
        t0 = time.monotonic()
        with open(log, "wb") as err:
            try:
                rc = launch(None, ["--out", str(tmp), "--device", "cpu",
                                   "--ndomains", str(ndomains), "--legs",
                                   legs, *extra],
                            num_processes=nproc, base_env=_env(),
                            module="dl_esm_inf_tpu_torch.parallel.mp_check",
                            timeout=timeout, stderr=err)
            except TimeoutError as e:
                rc = e
        if rc == 0:
            return None
        tail = log.read_bytes()[-3000:].decode(errors="replace")
        return (f"{nproc}-rank gang ({legs}): "
                f"{'exit code ' if isinstance(rc, int) else ''}{rc} after "
                f"{time.monotonic() - t0:.1f} s (limit {timeout} s); the "
                f"ranks' stderr ends:\n{tail}")
    return _once(root, name, run)


@pytest.fixture(scope="module")
def np2(tmp_path_factory):
    """2 ranks x 4 tiles each (8 domains)."""
    return _gang(tmp_path_factory, 2, 8, "core,periodic,guards")


#: the fused legs of the 4-rank gang: layouts, K values, extent, sweeps
FUSED_LAYOUTS, FUSED_K, FUSED_SHAPE, FUSED_SWEEPS = ("4x1,1x4,2x2", "2,4",
                                                     "48x64", 3)


#: the overlap leg: tests/test_nemolite2d.py:157-214's extent and steps
OVERLAP_SHAPE, OVERLAP_STEPS = "48x40", 30


@pytest.fixture(scope="module")
def np4(tmp_path_factory):
    """4 ranks x 2 tiles: rank seams on both axes; and the fused
    transport's legs and the overlap leg, one tile per rank."""
    return _gang(tmp_path_factory, 4, 8,
                 "core,periodic,flagship_fused,fused_alternate,fused_skew,"
                 "overlap,adjoint,autograd", *NP4_ADJOINT,
                 "--fused-layouts", FUSED_LAYOUTS, "--fused-k", FUSED_K,
                 "--fused-shape", FUSED_SHAPE, "--fused-sweeps",
                 str(FUSED_SWEEPS), "--overlap-shape", OVERLAP_SHAPE,
                 "--overlap-steps", str(OVERLAP_STEPS))


#: the adjoint leg of the 4-rank gang: the flagship alone
NP4_ADJOINT = ("--adjoint-cases", "flagship", "--adjoint-n", "32")


def _jax_fused(tmp_path_factory):
    """The JAX fused-transport kernel's runs on the 4x1 and 1x4 layouts,
    made once per test session (:func:`_once`) by one child process."""
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_max_isa=SSE4_2")

    def run(tmp):
        t0 = time.monotonic()
        try:
            res = subprocess.run(
                [sys.executable, str(REPO / "tests" / "jax_fused_reference.py"),
                 str(tmp), FUSED_SHAPE, str(FUSED_SWEEPS), "4x1,1x4", FUSED_K],
                env=env, capture_output=True, text=True,
                timeout=JAX_FUSED_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            rc, err = e, e.stderr or ""
        else:
            if res.returncode == 0:
                return None
            rc, err = f"exit code {res.returncode}", res.stderr
        if isinstance(err, bytes):
            err = err.decode(errors="replace")
        return (f"tests/jax_fused_reference.py: {rc} after "
                f"{time.monotonic() - t0:.1f} s (limit {JAX_FUSED_TIMEOUT} "
                f"s); its stderr ends:\n{err[-3000:]}")
    return _once(_session_root(tmp_path_factory), "jax_fused_reference", run)


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    """The JAX fused-transport kernel on the 4x1 and 1x4 layouts."""
    return _jax_fused(tmp_path_factory)


@pytest.fixture(scope="module")
def np6(tmp_path_factory):
    """6 ranks x 1 tile: the forced non-square 3x2 rank grid, where every
    seam is a rank seam; also the remote-DMA transport's plain version
    across ranks."""
    return _gang(tmp_path_factory, 6, 6,
                 "core,hill_rdma,exchange,skew", "--n", "48", "--reps", "1")


def _jax_grid(bcs, gnx, gny, ndom):
    g = jdl.Grid(jdl.ARAKAWA_C, bcs, jdl.OFFSET_NE)
    g.decompose(gnx, gny, ndomains=ndom)
    jdl.grid_init(g, 1.0, 1.0)
    return g


def _check_core(res, ndom):
    gnx, gny = 24, 20
    grid = _jax_grid(WALLED, gnx, gny, ndom)
    fld = jdl.Field(grid, jdl.T_POINTS)
    init_field_hill(fld, -666.0)
    fld.halo_exchange(1)
    np.testing.assert_array_equal(res["hill"], fld.get_data())
    assert float(res["gsum"]) == gnx * gny
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    np.testing.assert_array_equal(res["roundtrip"], vals + 1.0)
    m = jnl.build(32, 32, ndomains=ndom, open_north=True)
    m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
    m.run(10)
    for k, v in m.gather().items():
        np.testing.assert_allclose(res[f"nl_{k}"], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _check_periodic(res, ndom):
    g = _jax_grid(PERIODIC, 16, 16, ndom)
    pf = jdl.Field(g, jdl.T_POINTS,
                   init_global_data=np.arange(256.0).reshape(16, 16))
    pf.halo_exchange(1)
    np.testing.assert_array_equal(res["periodic"], pf.get_data())


@pytest.mark.parametrize("gang,ndom", [("np2", 8), ("np4", 8), ("np6", 6)])
def test_gang_core_legs_match_jax(gang, ndom, request):
    """Hill, checksum, round trip and the flagship across 2, 4 and 6
    ranks equal the JAX package's single-process run."""
    res = request.getfixturevalue(gang)
    assert int(res["world_size"]) == int(gang[2:])
    _check_core(res, ndom)
    np.testing.assert_array_equal(res["region_io"],
                                  np.full(res["region_io"].shape, 7.0))
    assert res["region_io"].shape[0] == 4


@pytest.mark.parametrize("gang", ["np2", "np4"])
def test_gang_periodic_matches_jax(gang, request):
    _check_periodic(request.getfixturevalue(gang), 8)


def test_gang_remote_dma_plain_across_ranks(np6):
    """transport="remote_dma" across CPU ranks (the protocol's plain
    version over the gathered blocks) equals the ppermute exchange and
    the JAX one, bitwise."""
    np.testing.assert_array_equal(np6["hill_rdma"], np6["hill"])


def test_gang_exchange_legs_bitwise(np6):
    """Field.halo_exchange across 6 ranks, both transports, walled and
    periodic, depth 1 and 8, 2D and 3 levels: each equal to the
    single-rank exchange of the whole stacked array; the counting-skew
    leg too; and the remote-DMA path's count of calls."""
    keys = [k for k in np6 if k.startswith("exch_equal_")]
    assert len(keys) == 16
    assert all(bool(np6[k]) for k in keys), [k for k in keys
                                             if not bool(np6[k])]
    assert bool(np6["skew_equal"])
    assert float(np6["rdma_max_abs_err"]) == 0.0
    # on CPU ranks the wrapper of the kernel is not reached
    assert int(np6["exch_rdma_launches"]) == 0
    assert int(np6["exch_rdma_calls"]) == 8


def test_gang_guards_raise(np2):
    """No path of the port raises NotImplementedError across 2 ranks:
    all 17 cases run, the ensemble, the adjoint paths and nesting
    included; the flagship's fused transport still refuses several tiles
    per rank with a ValueError naming the rule, and the microbench, which
    times one device, refuses ranks with a ValueError."""
    assert list(np2["guards_raised"]) == []
    assert list(np2["guards_ran"]) == sorted(np2["guards_all"])
    assert len(np2["guards_all"]) == 17
    assert bool(np2["fused_multi_tile_refused"])
    assert bool(np2["guards_kbench_refused"])


# --- the slice across ranks (2 ranks x 4 tiles) -----------------------------

#: the slice gang: legs, extent, steps and its own time limit
SLICE_LEGS = "solvers,semi_implicit,clients,schedule,psy,coupled,checkpoint"
SLICE_N, SLICE_STEPS, SLICE_TIMEOUT = 32, 10, 120.0


@pytest.fixture(scope="module")
def np2s(tmp_path_factory):
    """2 ranks x 4 tiles (8 domains): the solvers, semi-implicit, client,
    schedule, PSy, coupled-tracer and checkpoint legs."""
    return _gang(tmp_path_factory, 2, 8, SLICE_LEGS, "--n", str(SLICE_N),
                 "--steps", str(SLICE_STEPS), name="torch_mp_np2_slice",
                 timeout=SLICE_TIMEOUT)


def _mp():
    from dl_esm_inf_tpu_torch.parallel import mp_check
    return mp_check


@pytest.mark.parametrize("tag", ["cg", "cheb"])
def test_gang_helmholtz_matches_jax(np2s, tag):
    """HelmholtzSolver across 2 ranks (its dot products and residuals
    all-reduced; the fused Chebyshev sweep's plain version per rank after
    the exchange between ranks) against the JAX solver on 8 tiles in one
    process: atol 1e-12 on wet points (tests/test_torch_solvers.py's),
    Chebyshev's iteration count equal, CG's within one (its dot products
    add in another order), both converged."""
    from dl_esm_inf_tpu.ops import solvers as jso
    mp = _mp()
    n = SLICE_N
    tm = mp.island_tmask(n)
    rhs = np.random.default_rng(3).standard_normal((n, n)) * (tm == 1)
    g = jdl.Grid(jdl.ARAKAWA_C, WALLED, jdl.OFFSET_NE)
    g.decompose(n, n, ndomains=8, halo_width=4)
    jdl.grid_init(g, 1.0, 1.0, tm)
    kw = dict(mp.SOLVES[tag])
    if kw.pop("fused", False):
        kw["pallas"] = False            # JAX's plain Chebyshev at that K
    s = jso.HelmholtzSolver(g, mp.LAM, mp.LAM, tol=1e-12, **kw)
    x, info = s.solve(jdl.Field(g, jdl.T_POINTS, init_global_data=rhs))
    want = jlayout.unstack_internal(g.decomp, np.asarray(x))
    got = np2s[f"hs_{tag}_x"]
    np.testing.assert_allclose(got * (tm == 1), want * (tm == 1), rtol=0,
                               atol=1e-12)
    iters = int(np2s[f"hs_{tag}_iters"])
    assert abs(iters - info["iterations"]) <= (1 if tag == "cg" else 0)
    assert float(np2s[f"hs_{tag}_rel_res"]) <= 1e-12
    assert int(np2s[f"hs_{tag}_launches"]) == 0      # no card here


@pytest.mark.parametrize("tag", ["si", "sio"])
def test_gang_semi_implicit_matches_jax(np2s, tag):
    """The semi-implicit model across 2 ranks (CG, and the open north
    boundary) against the JAX model on 8 tiles in one process, 5 steps:
    atol 1e-9 (tests/test_multiprocess.py:252-272)."""
    from dl_esm_inf_tpu.models import semi_implicit as jsi
    n = SLICE_N
    kw = dict(open_north=True, bc_amp=0.05) if tag == "sio" else {}
    m = jsi.build(n, n, ndomains=8, dt=1.0, depth=10.0, tol=1e-11, **kw)
    if tag == "si":
        m.set_initial_eta(jsi.gaussian_eta(n, n, amp=0.5))
    m.run(5)
    for k, v in m.gather().items():
        np.testing.assert_allclose(np2s[f"{tag}_{k}"], v, rtol=0, atol=1e-9,
                                   err_msg=k)
    assert float(np2s[f"{tag}_tol"]) == 1e-11


CLIENT_NAMES = ["gravity_wave", "shallow", "twolayer", "nlayer",
                "tracer_vanleer", "tracer_upwind"]


@pytest.mark.parametrize("name", CLIENT_NAMES)
def test_gang_clients_match_jax(np2s, name):
    """Each client across 2 ranks on its fused sweep (the kernel's plain
    version per rank, after the plain exchange between ranks) at its main
    path's K, 10 steps, against the JAX model on 8 tiles in one process:
    rtol 1e-12, atol 1e-13 (tests/test_torch_clients.py's)."""
    import importlib
    mp = _mp()
    n = SLICE_N
    assert list(mp.client_cases(n)) == CLIENT_NAMES
    mod, kw, K, init = mp.client_cases(n)[name]
    jmod = importlib.import_module(f"dl_esm_inf_tpu.models.{mod}")
    m = jmod.build(n, n, ndomains=8, **kw)
    init(m)
    m.run(SLICE_STEPS)
    for k, v in m.gather().items():
        got = np2s[f"cl_{name}_{k}"]
        assert np.all(np.isfinite(got)), k
        np.testing.assert_allclose(got, np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert int(np2s[f"cl_launches_{name}"]) == 0     # no card here


def test_gang_schedule_matches_jax(np2s):
    """The fused schedule across 2 ranks (tests/test_multiprocess.py:
    226-249's two east shifts, halo 2) bitwise equal to the JAX fused
    schedule on 8 tiles in one process, and so is its plain run; invoke's
    and Schedule's reductions (sum, min, max over every rank's block)
    within 1e-12 relative of the JAX package's."""
    from dl_esm_inf_tpu.api import kernel_meta as jkm
    from dl_esm_inf_tpu.ops import stencils as jst
    n = SLICE_N

    @jkm.kernel(args=[jkm.go_arg(jkm.GO_WRITE, jkm.GO_CT),
                      jkm.go_arg(jkm.GO_READ, jkm.GO_CT,
                                 jkm.go_stencil(0, 11, 0))])
    def sp_east(out, x):
        return jst.xp(x)

    def fields():
        g = jdl.Grid(jdl.ARAKAWA_C, WALLED, jdl.OFFSET_NE)
        g.decompose(n, n, ndomains=8, halo_width=2, align_y=8)
        jdl.grid_init(g, 1.0, 1.0)
        return (jdl.Field(g, jdl.T_POINTS, init_global_data=np.arange(
            float(n * n)).reshape(n, n)), jdl.Field(g, jdl.T_POINTS))
    fa, fb = fields()
    jkm.Schedule((sp_east, fb, fa), (sp_east, fb, fb)).fused(interpret=True)
    np.testing.assert_array_equal(np2s["sc_fused"], fb.gather_inner_data())
    pa, pb = fields()
    jkm.Schedule((sp_east, pb, pa), (sp_east, pb, pb))()
    np.testing.assert_array_equal(np2s["sc_plain"], pb.gather_inner_data())
    ops = {"GO_SUM": jnp.sum, "GO_MIN": jnp.min, "GO_MAX": jnp.max}
    reds = []
    for acc, f in ops.items():
        k = jkm.kernel(args=[jkm.go_arg(getattr(jkm, acc), jkm.GO_R_SCALAR),
                             jkm.go_arg(jkm.GO_READ, jkm.GO_CT)],
                       name=f"j_{acc}")(lambda x, f=f: f(x))
        reds.append(k)
        want = float(jkm.invoke(k, fa))
        assert float(np2s[f"sc_invoke_{acc}"]) == pytest.approx(
            want, rel=1e-12, abs=0)
    want = jkm.Schedule(*((k, fa) for k in reds))()
    np.testing.assert_allclose(np2s["sc_schedule_reds"],
                               np.asarray(want, float), rtol=1e-12, atol=0)
    assert int(np2s["sc_launches"]) == 0


def test_gang_psy_matches_jax(np2s):
    """NemoLite2DPsy across 2 ranks on Schedule.fused (halo 8), 10 steps,
    against the JAX PSy model on 8 tiles in one process: 1e-10
    (tests/test_torch_nemolite2d_psy.py's)."""
    from dl_esm_inf_tpu.models.nemolite2d_psy import NemoLite2DPsy as JPsy
    n = SLICE_N
    m = JPsy(n, n, ndomains=8)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    m.run(SLICE_STEPS)
    for k, v in m.gather().items():
        np.testing.assert_allclose(np2s[f"psy_{k}"], np.asarray(v),
                                   rtol=1e-10, atol=1e-10, err_msg=k)
    assert int(np2s["psy_launches"]) == 0


def test_gang_coupled_tracer_matches_jax(np2s):
    """CoupledTracer across 2 ranks, 10 steps, against the JAX coupled
    tracer on 8 tiles in one process: atol 1e-12 of each field's largest
    value, mass within 1e-12 (tests/test_torch_coupled_tracer.py's)."""
    from dl_esm_inf_tpu.models import tracer as jtr
    n = SLICE_N
    jfs = jnl.build(n, n, ndomains=8, open_north=True, halo_width=2)
    jct = jtr.CoupledTracer(jfs, kappa=0.01, scheme="vanleer")
    rng = np.random.default_rng(0)
    jfs.set_initial_ssh(gaussian_eta(n, n, amp=0.2)
                        + 0.01 * rng.standard_normal((n, n)))
    jct.set_initial_tracer(gaussian_eta(n, n, amp=1.0, width=0.08) + 0.05)
    jct.run(SLICE_STEPS)
    for k, v in jct.gather().items():
        v = np.asarray(v)
        np.testing.assert_allclose(np2s[f"cp_{k}"], v, rtol=0,
                                   atol=1e-12 * np.abs(v).max(), err_msg=k)
    mass = float(jct.mass())
    assert abs(float(np2s["cp_mass"]) - mass) <= 1e-12 * abs(mass)


def test_gang_checkpoint_bitwise(np2s):
    """A checkpoint saved on 2 ranks x 4 tiles (rank 0 writes, every rank
    joins the gather): loaded back on those ranks into 4 tiles, in this
    process into one tile, and by the JAX package on 8 tiles, each
    bitwise equal to the saved arrays; the step comes back."""
    from dl_esm_inf_tpu.utils import checkpoint as jck
    from dl_esm_inf_tpu_torch.utils import checkpoint
    want = _mp().checkpoint_fields(SLICE_N)
    path = str(np2s["ck_path"])
    assert int(np2s["ck_step"]) == 7
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, device="cpu")
    g.decompose(SLICE_N, SLICE_N, ndomains=1)
    tdl.grid_init(g, 1.0, 1.0)
    here = {"f": tdl.Field(g, tdl.T_POINTS),
            "f3": tdl.Field(g, tdl.T_POINTS, levels=3)}
    assert checkpoint.load_fields(path, here)["step"] == 7
    jg = _jax_grid(WALLED, SLICE_N, SLICE_N, 8)
    there = {"f": jdl.Field(jg, jdl.T_POINTS),
             "f3": jdl.Field(jg, jdl.T_POINTS, levels=3)}
    jck.load_fields(path, there)
    for k, v in want.items():
        np.testing.assert_array_equal(np2s[f"ck_{k}"], v, err_msg=k)
        np.testing.assert_array_equal(here[k].gather_inner_data(), v,
                                      err_msg=k)
        np.testing.assert_array_equal(there[k].gather_inner_data(), v,
                                      err_msg=k)


# --- the ensemble, the adjoint and nesting across ranks (2 x 4 tiles) -------

#: the gang of the ensemble, the adjoint and nesting: legs and time limit
DA_LEGS, DA_TIMEOUT = "ensemble,adjoint,nest,autograd", 180.0
#: tolerances across ranks against the JAX package's one process:
#: the ensemble (tests/test_multiprocess.py:304), costs, gradients and
#: iterates (relative to the largest value), the nest's fields
#: (tests/test_torch_nesting.py's port-vs-JAX)
TOL_ENS, TOL_COST, TOL_GRAD, TOL_NEST = 1e-9, 1e-12, 1e-10, 1e-11


@pytest.fixture(scope="module")
def np2d(tmp_path_factory):
    """2 ranks x 4 tiles (8 domains): the ensemble, adjoint, nest and
    autograd legs."""
    return _gang(tmp_path_factory, 2, 8, DA_LEGS, name="torch_mp_np2_da",
                 timeout=DA_TIMEOUT)


def _jax_modules():
    from types import SimpleNamespace

    from dl_esm_inf_tpu.models import gravity_wave as jgw
    from dl_esm_inf_tpu.models import nesting as jnest
    from dl_esm_inf_tpu.models import semi_implicit as jsi
    from dl_esm_inf_tpu.models import tracer as jtr
    return SimpleNamespace(nl=jnl, si=jsi, tr=jtr, gw=jgw, nest=jnest)


@pytest.fixture(scope="module")
def jax_ensemble(tmp_path_factory):
    """tests/mp_worker.py:162-189's ensemble in the JAX package on 8
    tiles: the forecast, and each analysis and the 2 steps after it; run
    once per test session (:func:`_once`)."""
    def run(tmp):
        from dl_esm_inf_tpu.models.enkf import ETKF as JETKF
        from dl_esm_inf_tpu.models.ensemble import Ensemble as JEnsemble
        mp, n = _mp(), 24
        ens = JEnsemble(_jax_modules().gw.build(n, n, ndomains=8, dt=0.05,
                                                depth=10.0), 4)
        ens.set_member_states(0, mp.ensemble_members(n, 4))
        ens.run(4)
        out = {f"ef_{k}": np.asarray(v) for k, v in ens.gather_all().items()}
        for tag, kw, y, mask in (
                ("ek", {}, gaussian_eta(n, n, amp=0.35), None),
                ("lk", dict(localization_radius=4.0),
                 gaussian_eta(n, n, amp=0.3), mp.letkf_mask(n, "3:21:3"))):
            diag = JETKF(ens, sigma=0.02, **kw).analysis(y, obs_mask=mask)
            out[f"{tag}_diag"] = np.asarray([diag[k] for k in sorted(diag)])
            out.update({f"{tag}_an_{k}": np.asarray(v)
                        for k, v in ens.gather_all().items()})
            ens.run(2)
            out.update({f"{tag}_{k}": np.asarray(v)
                        for k, v in ens.gather_all().items()})
        np.savez(tmp, **out)
    return _once(_session_root(tmp_path_factory), "jax_ensemble", run)


@pytest.mark.parametrize("stage", ["ef", "ek_an", "ek", "lk_an", "lk"])
def test_gang_ensemble_matches_jax(np2d, jax_ensemble, stage):
    """The ensemble across 2 ranks (the member-coalesced exchange between
    ranks, the all-reduced (M, M) moments, the LETKF's observed rows
    assembled by one all-reduce, the collective gathers): the forecast,
    the global ETKF's analysis and the forecast after it, the LETKF's and
    the forecast after it, against the JAX package's run on 8 tiles at
    1e-9 (tests/test_multiprocess.py:304); the diagnostics too."""
    keys = [k for k in jax_ensemble if k.startswith(stage + "_")
            and k[len(stage) + 1:] in ("eta", "u", "v")]
    assert len(keys) == 3
    for k in keys:
        assert np2d[k].shape == (4, 24, 24)
        np.testing.assert_allclose(np2d[k], jax_ensemble[k], rtol=0,
                                   atol=TOL_ENS, err_msg=k)
    if stage in ("ek", "lk"):
        np.testing.assert_allclose(np2d[f"{stage}_diag"],
                                   jax_ensemble[f"{stage}_diag"], rtol=1e-9,
                                   atol=0)


def test_gang_ensemble_checkpoint(np2d):
    """The ensemble saved on 2 ranks (rank 0 writes the gathered members):
    the file holds the last states and the clock, and the port's
    one-process Ensemble loads it back bitwise."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as tgw
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    path = str(np2d["ens_path"])
    with np.load(path) as f:
        assert int(f["__step__"]) == 8
        for k in ("eta", "u", "v"):
            np.testing.assert_array_equal(f[k], np2d[f"lk_{k}"])
    ens = Ensemble(tgw.build(24, 24, dt=0.05, depth=10.0, device="cpu"), 4)
    ens.load(path)
    for k, v in ens.gather_all().items():
        np.testing.assert_array_equal(v, np2d[f"lk_{k}"], err_msg=k)


def _jax_cost_and_grad(name, res, n=32, steps=8, ndom=8):
    """The JAX package's cost and gradient (internal points) of an
    adjoint case on the gang's observations."""
    import jax
    from dl_esm_inf_tpu.models import assimilation as jda
    build, key, steps_, _, _, guess, index = _mp().adjoint_cases(
        n, steps)[name]
    obs = {t: res[f"adj_{name}_obs_{t}"] for t in steps_}
    jm = build(_jax_modules(), ndom, {})
    jcost, jpack, _ = jda.make_cost_fn(jm, obs, obs_state_index=index)
    xj = jpack(guess)
    g = jlayout.unstack_internal(jm.grid.decomp,
                                 np.asarray(jax.jit(jax.grad(jcost))(xj)))
    return float(jcost(xj)), g


def _check_cost_and_grad(res, name, cost, grad):
    assert cost > 0 and np.abs(grad).max() > 0
    got = float(res[f"adj_{name}_cost"])
    assert abs(got - cost) <= TOL_COST * cost, (got, cost)
    # a factor of 2 or 1/2 (an all-reduce in the cost's backward, or a
    # rank's share missing) is far outside this
    err = np.abs(res[f"adj_{name}_grad"] - grad).max()
    assert err <= TOL_GRAD * np.abs(grad).max(), err


@pytest.mark.parametrize("name", ["flagship", "semi_implicit", "coupled"])
def test_gang_cost_and_gradient_match_jax(np2d, name):
    """make_cost_fn across 2 ranks (the cost the psum of the ranks'
    misfits, autograd through the strip transfer between ranks; the
    semi-implicit model's adjoint solve with all-reduced dots; the coupled
    tracer observed at state index 3), tests/test_torch_assimilation.py's
    configurations at 32^2: the cost within 1e-12 relative and the
    gradient within 1e-10 of its largest component of the JAX package's
    on 8 tiles in one process."""
    _check_cost_and_grad(np2d, name, *_jax_cost_and_grad(name, np2d))


def test_gang_flagship_gradient_2x2_matches_jax(np4):
    """The flagship's cost and gradient on a 2x2 rank grid (2 tiles per
    rank: the corners arrive by sequencing, and their cotangents go back
    in reverse sequence) against the JAX package's."""
    assert int(np4["world_size"]) == 4
    _check_cost_and_grad(np4, "flagship",
                         *_jax_cost_and_grad("flagship", np4))


def test_gang_adam_matches_jax(np2d):
    """assimilate with Adam across 2 ranks (the largest gradient component
    a global max), 5 iterations on a 32^2 gravity wave: the cost history
    within 1e-12 and the recovered field and the gradient norm within
    1e-10 relative of the JAX package's (optax) on 8 tiles."""
    from dl_esm_inf_tpu.models import assimilation as jda
    mp, n = _mp(), 32
    r = jda.assimilate(_jax_modules().gw.build(n, n, ndomains=8, dt=0.05,
                                               depth=10.0),
                       mp.optimiser_obs(n), iters=mp.OPT_ITERS,
                       learning_rate=0.1)
    np.testing.assert_allclose(np2d["opt_adam_history"], r["cost_history"],
                               rtol=TOL_COST, atol=0)
    scale = np.abs(r["eta0"]).max()
    assert scale > 0
    np.testing.assert_allclose(np2d["opt_adam_eta0"], r["eta0"], rtol=0,
                               atol=TOL_GRAD * scale)
    assert abs(float(np2d["opt_adam_grad_norm"]) - r["grad_norm"]) <= (
        TOL_GRAD * r["grad_norm"])


@pytest.mark.parametrize("tag", ["lbfgs", "hybrid"])
def test_gang_lbfgs_matches_one_process(np2d, tag):
    """The port's L-BFGS across 2 ranks (dot products and norms
    all-reduced; the hybrid control's ensemble weights held alike by every
    rank, their gradient summed over the ranks once), 5 iterations on a
    32^2 gravity wave, against the port in one process on 8 tiles (the JAX
    package's optax line search differs): the cost history within 1e-12,
    the recovered field and the weights within 1e-10 relative; the cost
    falls."""
    mp = _mp()
    want = mp.optimiser_run(tag, 32, 8, "cpu")
    hist = want[f"opt_{tag}_history"]
    assert hist[-1] < hist[0]
    np.testing.assert_allclose(np2d[f"opt_{tag}_history"], hist,
                               rtol=TOL_COST, atol=0)
    for k in ("eta0", "weights"):
        key = f"opt_{tag}_{k}"
        if key in want:
            scale = np.abs(want[key]).max()
            assert scale > 0
            np.testing.assert_allclose(np2d[key], want[key], rtol=0,
                                       atol=TOL_GRAD * scale, err_msg=k)
    assert (f"opt_{tag}_weights" in want) == (tag == "hybrid")


def _jax_nest(case, ndom=8):
    mp = _mp()
    parent, nests, runner = mp.build_nests(_jax_modules(), case, ndom, {})
    runner.run(case["steps"])
    return [parent] + [n.child for n in nests]


@pytest.mark.parametrize("tag", ["r1", "r2", "set"])
def test_gang_nest_matches_jax(np2d, tag):
    """Nesting across 2 ranks (the ring's parent band gathered from every
    rank, the feedback's partial sums all-reduced): the ratio-1 one-way
    nest (30 steps), the two-way ratio-2 nest (15 steps) and a NestSet of
    a two-way ratio-2 nest, a one-way ratio-3 sibling and a two-way nest
    telescoped in the first child (10 steps), against the JAX package on
    8 tiles at 1e-11 (tests/test_torch_nesting.py's); the ratio-1 child's
    interior bitwise equal to its parent's window, and the ratio-1 run
    bitwise equal to the port in one process."""
    mp = _mp()
    case = mp.NEST_CASES[tag]
    models = _jax_nest(case)
    for who, m in zip(["p"] + [f"c{i}" for i in range(len(case["nests"]))],
                      models):
        for k in ("eta", "u", "v"):
            got = np2d[f"nest_{tag}_{who}_{k}"]
            assert np.all(np.isfinite(got))
            np.testing.assert_allclose(got, np.asarray(getattr(
                m, k).gather_inner_data()), rtol=0, atol=TOL_NEST,
                err_msg=f"{who} {k}")
    if tag == "r1":
        one = mp.nest_run(tag, case, 8, "cpu")
        for k, v in one.items():
            if "_ms" not in k:
                np.testing.assert_array_equal(np2d[k], v, err_msg=k)
        np.testing.assert_array_equal(np2d["nest_r1_c0_eta"][2:-2, 2:-2],
                                      np2d["nest_r1_p_eta"][14:34, 14:34])


def test_gang_nest_refuses_what_the_ranks_cannot_hold(np2d):
    """A child of 3 tiles cannot be split over 2 ranks: OneWayNest raises
    a ValueError naming the rule (and the decomposition's own reason)."""
    msg = str(np2d["nest_refused"])
    assert "split over its parent's 2 ranks" in msg, msg
    assert "cannot be split over 2 ranks" in msg, msg


def test_gang_nest_gradient_matches_jax(np2d):
    """The gradient of the child's eta energy (internal cells) after 3
    steps of a two-way ratio-2 nest with respect to the parent's eta
    (internal points), across 2 ranks (the
    band's all-gather transposing to a reduce-scatter, the feedback's
    all-reduce summing the ranks' cotangents once): the loss within 1e-12
    and the gradient within 1e-10 of its largest entry of the JAX
    package's on 8 tiles (tests/test_torch_nesting.py's configuration)."""
    import jax
    import jax.numpy as jnp
    mp = _mp()
    case = mp.NEST_CASES["grad"]
    parent, nests, runner = mp.build_nests(_jax_modules(), case, 8, {})
    prog = runner.step_program(case["steps"])
    c = nests[0].child
    tree0 = (((c.eta.data, c.u.data, c.v.data), ()),)
    inner = jnp.asarray(jlayout.internal_mask(c.grid.decomp),
                        c.eta.data.dtype)

    def loss(p_eta):
        out = prog(((p_eta, parent.u.data, parent.v.data), tree0))
        return jnp.sum(out[1][0][0][0] ** 2 * inner)
    want = float(loss(parent.eta.data))
    g = jlayout.unstack_internal(parent.grid.decomp, np.asarray(
        jax.grad(loss)(parent.eta.data)))
    assert abs(float(np2d["nest_grad_loss"]) - want) <= TOL_COST * want
    assert np.abs(g).max() > 0
    err = np.abs(np2d["nest_grad_grad"] - g).max()
    assert err <= TOL_GRAD * np.abs(g).max(), err


@pytest.mark.parametrize("gang", ["np2d", "np4"])
@pytest.mark.parametrize("grid", ["walled", "periodic"])
def test_gang_autograd_transposes(gang, grid, request):
    """The backward of the exchange between ranks is its transpose:
    <T x, y> = <x, T^T y> (the depth-2 exchange, and the raw strip
    transfer around the ring of ranks, walled and wrapped), and T^T y
    equals the single-process exchange's (1e-13 of its largest value; on
    4 ranks a 2x2 grid).  The two all-reduce cases give the single-process
    gradients (1e-12 relative): psum's cotangent passes through (2 x m,
    not 2 or 4 times it), pbroadcast sums every rank's cotangent once
    (d/da of a replicated weight, and a feedback-like use of all-reduced
    sums), and the all-gather's backward reduce-scatters."""
    res = request.getfixturevalue(gang)
    mp = _mp()
    tag, bcs, n = next(t for t in mp.PROBE_GRIDS if t[0] == grid)
    one = mp.autograd_probe(mp.probe_grid(bcs, n, 8, "cpu"))
    r = {k[len(f"ag_{tag}_"):]: v for k, v in res.items()
         if k.startswith(f"ag_{tag}_")}
    assert abs(float(r["tx_y"]) - float(r["x_tty"])) <= 1e-12 * abs(
        float(r["tx_y"]))
    for wrap in ("walled", "wrap"):
        a, b = (float(r[f"transfer_{k}_{wrap}"]) for k in ("tx_y", "x_tty"))
        assert abs(a - b) <= 1e-12 * abs(a) and a != 0.0, (wrap, a, b)
    scale = np.abs(one["tty"]).max()
    np.testing.assert_allclose(r["tty"], one["tty"], rtol=0,
                               atol=1e-13 * scale)
    for k in ("psum_grad", "pb_grad_a", "pb_grad_x", "fb_grad"):
        scale = np.abs(one[k]).max()
        assert scale > 0
        np.testing.assert_allclose(r[k], one[k], rtol=0, atol=1e-12 * scale,
                                   err_msg=k)
    assert float(r["gather_err"]) <= 1e-15


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("layout", ["4x1", "1x4"])
def test_gang_fused_transport_matches_jax(np4, jax_fused, layout, K):
    """transport="fused" across 4 ranks, one tile each (the protocol's
    plain version between the ranks' blocks, collective id 2), equals the
    JAX fused-transport kernel bitwise at float64 on internal points after
    3 sweeps; the rdma sweep's wrapper is not reached on CPU ranks."""
    tag = f"{layout}_k{K}"
    for k in ("sshn", "un", "vn"):
        got = np4[f"ff_{tag}_{k}"]
        assert np.all(np.isfinite(got)), k
        np.testing.assert_array_equal(got, jax_fused[f"{tag}_{k}"],
                                      err_msg=k)
    assert int(np4[f"ff_launches_{tag}"]) == 0


def _one_process_fused_start(px, py, K, transport, variable_depth=False):
    """The fused legs' model (parallel/mp_check.py) in this process."""
    from types import SimpleNamespace

    from dl_esm_inf_tpu_torch.parallel import mp_check
    return mp_check.fused_model(SimpleNamespace(
        fused_shape=FUSED_SHAPE, device="cpu"), px, py, K, transport,
        variable_depth)


@pytest.mark.parametrize("K,depth", [(2, "flat"), (4, "flat"),
                                     (4, "variable")])
def test_gang_fused_transport_2x2_matches_one_process(np4, K, depth):
    """transport="fused" on a 2x2 rank grid equals the port's
    single-process run of the same 4 tiles on the ppermute transport,
    bitwise, with flat depth and over a seeded depth plane (the JAX
    kernel's interpret mode drives remote DMA on 1D meshes only)."""
    variable = depth == "variable"
    m = _one_process_fused_start(2, 2, K, "ppermute", variable)
    m.run(FUSED_SWEEPS * K)
    want = m.gather()
    key = "ffht_{}" if variable else f"ff_2x2_k{K}_{{}}"
    if variable:
        assert str(np4["ffht_tag"]) == "2x2_k4"
    for k in want:
        np.testing.assert_array_equal(np4[key.format(k)], want[k],
                                      err_msg=k)


@pytest.mark.parametrize("leg", ["falt", "fskew"])
def test_gang_fused_transport_alternating_and_skewed(np4, leg):
    """Sweeps alternating with standalone remote_dma exchanges on the
    same spec (their own collective id and window), and a rank 50 ms
    late before a sweep: the fields equal the uninterrupted run bitwise,
    and every alternating exchange equals the plain exchange."""
    tag = str(np4[f"{leg}_tag"])
    assert tag == "2x2_k4"
    for k in ("sshn", "un", "vn"):
        np.testing.assert_array_equal(np4[f"{leg}_{k}"],
                                      np4[f"ff_{tag}_{k}"], err_msg=k)
    if leg == "falt":
        assert bool(np4["falt_exch_equal"])


@pytest.mark.parametrize("interior", ["plain", "fused"])
@pytest.mark.parametrize("depth", ["flat", "ht"])
def test_gang_overlap_matches_jax(np4, depth, interior):
    """The flagship's overlap mode across 4 ranks, one tile each (2x2,
    48x40, halo 2, open north, 30 steps): bitwise equal to the
    non-overlapped step at internal points, the interior on the plain
    step or on the K=1 sweep's plain version, and within RTOL / ATOL of
    the JAX package's 4-device overlap run (the ndom=4 cases of
    tests/test_nemolite2d.py:157-214)."""
    from dl_esm_inf_tpu_torch.parallel.mp_check import overlap_depth
    gnx, gny = (int(v) for v in OVERLAP_SHAPE.split("x"))
    tag = f"{interior}_{depth}"
    m = jnl.build(gnx, gny, ndomains=4, halo_width=2, open_north=True,
                  depth=(overlap_depth(gnx, gny) if depth == "ht"
                         else 100.0))
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    bathy = (m._ht,) if m._ht is not None else ()
    m.sshn_t.data, m.un.data, m.vn.data = m.step_program(
        OVERLAP_STEPS, overlap=True)(
        jnp.int32(0), (m.sshn_t.data, m.un.data, m.vn.data), m._mask_codes,
        *bathy)
    want = m.gather()
    for k, v in want.items():
        got = np4[f"ov_{tag}_overlap_{k}"]
        np.testing.assert_array_equal(got, np4[f"ov_{tag}_step_{k}"],
                                      err_msg=k)
        np.testing.assert_allclose(got, v, rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(np4[f"ov_launches_{tag}"]) == 0


# --- the launcher ---------------------------------------------------------------

def test_launcher_world_size(tmp_path):
    """Each rank sees the gang's world size and its own rank."""
    script = tmp_path / "prog.py"
    script.write_text(
        "import sys\n"
        "import dl_esm_inf_tpu_torch as dl\n"
        "dl.initialise()\n"
        "n, r = dl.get_num_ranks(), dl.get_rank()\n"
        "open(sys.argv[1] + f'/rank{r}', 'w').write(str(n))\n"
        "dl.finalise()\n")
    rc = launch(str(script), [str(tmp_path)], num_processes=3,
                base_env=_env(), timeout=GANG_TIMEOUT)
    assert rc == 0
    assert [(tmp_path / f"rank{r}").read_text() for r in range(3)] == \
        ["3"] * 3


def test_launcher_cli_module(tmp_path):
    """``python -m dl_esm_inf_tpu_torch.launch -n 2 -m module args``."""
    out = tmp_path / "r.npz"
    res = subprocess.run(
        [sys.executable, "-m", "dl_esm_inf_tpu_torch.launch", "-n", "2",
         "-m", "dl_esm_inf_tpu_torch.parallel.mp_check", "--out", str(out),
         "--device", "cpu", "--legs", "periodic", "--ndomains", "2"],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=GANG_TIMEOUT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(np.load(out)["world_size"]) == 2


def test_launch_aborts_gang_on_rank_failure(tmp_path):
    """A dying rank terminates the rest at once (mpirun-style abort)."""
    script = tmp_path / "boom.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launch(str(script), [], num_processes=2, base_env=_env())
    assert rc == 3
    assert time.monotonic() - t0 < 60


def test_launch_timeout_stops_gang(tmp_path):
    script = tmp_path / "slow.py"
    script.write_text("import time\ntime.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(str(script), [], num_processes=2, base_env=_env(),
               timeout=1.0)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("what", ["gang", "jax_fused"])
def test_failed_gang_fails_once(tmp_path, monkeypatch, what):
    """A gang (or the JAX fused-transport reference's child) that fails
    is launched once per test session: the second caller, in this worker
    or any other, fails with the first caller's message, exit code and
    stderr included, without launching again."""
    from types import SimpleNamespace
    calls = []
    if what == "gang":
        script = tmp_path / "fail.py"
        script.write_text("import sys\nsys.stderr.write('rank failed on "
                          "purpose\\n')\nsys.exit(3)\n")
        real = launch

        def stub(_script, _args, **kw):
            calls.append(kw["num_processes"])
            return real(str(script), [], num_processes=kw["num_processes"],
                        base_env=kw["base_env"], timeout=kw["timeout"],
                        stderr=kw["stderr"])
        monkeypatch.setitem(globals(), "launch", stub)
        want = "exit code 3"
    else:
        real = subprocess.run

        def stub(_cmd, **kw):
            calls.append(_cmd)
            return real([sys.executable, "-c", "import sys; sys.stderr."
                         "write('reference failed on purpose\\n'); "
                         "sys.exit(4)"], **kw)
        monkeypatch.setattr(subprocess, "run", stub)
        want = "exit code 4"
    base = tmp_path / "basetemp"
    base.mkdir()
    factory = SimpleNamespace(getbasetemp=lambda: base)
    msgs = []
    for _ in range(2):
        with pytest.raises(pytest.fail.Exception) as e:
            if what == "gang":
                _gang(factory, 2, 8, "core", name="stub")
            else:
                _jax_fused(factory)
        msgs.append(str(e.value))
    assert len(calls) == 1
    assert msgs[0] == msgs[1]
    assert want in msgs[0] and "failed on purpose" in msgs[0], msgs[0]


# --- the environment and the rank grid ---------------------------------------

def test_partial_env_protocol_raises(monkeypatch):
    for k in tenv.ENV_PROTOCOL:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tenv.initialise()


def test_one_process_environment():
    assert (tenv.get_rank(), tenv.get_num_ranks(), tenv.on_master()) == \
        (0, 1, True)
    # one rank: the differentiable collectives are the identity
    from dl_esm_inf_tpu_torch.parallel import collectives as tcol
    x = torch.arange(3.0)
    assert tcol.psum(x) is x and tcol.pbroadcast(x) is x
    assert torch.equal(tcol.all_gather(x), x[None])


def test_default_device_is_the_local_rank_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    if torch.cuda.is_available():
        want = 3 % torch.cuda.device_count()
        assert tenv.resolve_device(None) == torch.device("cuda", want)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tenv.resolve_device(None)


@pytest.mark.parametrize("px,py,nranks,want", [
    (4, 2, 2, (1, 2)), (4, 2, 4, (2, 2)), (4, 2, 8, (2, 4)),
    (3, 2, 6, (2, 3)), (2, 1, 2, (1, 2)), (1, 2, 2, (2, 1)),
    (4, 4, 1, (1, 1))])
def test_rank_grid(px, py, nranks, want):
    assert rank_grid(px, py, nranks) == want


@pytest.mark.parametrize("px,py,nranks", [(3, 1, 2), (2, 2, 3), (1, 1, 2)])
def test_rank_grid_without_tiles_raises(px, py, nranks):
    with pytest.raises(ValueError, match="ranks"):
        rank_grid(px, py, nranks)


def test_one_rank_grid_is_unchanged():
    """World size 1: one rank holds every tile, as before."""
    g = tdl.Grid(device="cpu")
    g.decompose(24, 20, ndomains=8)
    spec = g.halo_spec
    assert (spec.repx, spec.repy) == (spec.nprocx, spec.nprocy)
    assert spec.num_ranks == 1
    assert g.array_shape == g.global_array_shape == spec.global_array_shape


# --- the fence and the simulated protocol ------------------------------------

def test_fence_oracles_on_the_plain_fence():
    """The three oracles on FenceModel: positive bitwise, negative would
    block, control completes."""
    res = tfo.run_oracles("cpu")
    assert res["positive"] and res["negative_timed_out"]
    assert res["control_completed"]


def test_fence_model_counts():
    f = trdma.FenceModel()
    assert not f.try_wait(0, trdma.ready_slot(0, 0))
    f.signal(0, trdma.ready_slot(1, 0), 2)
    assert not f.try_wait(0, trdma.ready_slot(0, 0))    # other phase
    assert f.try_wait(0, trdma.ready_slot(1, 0))
    assert f.try_wait(0, trdma.ready_slot(1, 0))
    assert not f.try_wait(0, trdma.ready_slot(1, 0))    # consumed


#: one tile per rank: (ranks_x, ranks_y)
LAYOUTS = [(2, 1), (1, 2), (2, 2), (3, 2)]


def _extent(layout, wrap, halo):
    base = max(halo, 5)
    return tuple(base * t + (0 if wrap else 1) for t in layout)


def _spec_and_jax(layout, wrap, halo):
    gnx, gny = _extent(layout, wrap, halo)
    bcs = PERIODIC if wrap else WALLED
    gj = jdl.Grid(jdl.ARAKAWA_C, bcs, jdl.OFFSET_NE)
    gj.decompose(gnx, gny, ndomainx=layout[0], ndomainy=layout[1],
                 halo_width=halo)
    jdl.grid_init(gj, 1.0, 1.0)
    gt = tdl.Grid(tdl.ARAKAWA_C, bcs, tdl.OFFSET_NE, device="cpu")
    gt.decompose(gnx, gny, ndomainx=layout[0], ndomainy=layout[1],
                 halo_width=halo)
    spec = HaloSpec(**{**gt.halo_spec.__dict__, "repx": 1, "repy": 1})
    return spec, gj


def _split(a, spec):
    """Whole stacked array -> the ranks' one-tile blocks, rank order."""
    ly, lx = spec.array_shape
    return [a[..., iy * ly: (iy + 1) * ly, ix * lx: (ix + 1) * lx]
            for iy, ix in (spec.rank_coords(r)
                           for r in range(spec.num_ranks))]


def _join(blocks, spec):
    rows = [torch.cat(blocks[iy * spec.ranks_x: (iy + 1) * spec.ranks_x],
                      dim=-1) for iy in range(spec.ranks_y)]
    return torch.cat(rows, dim=-2)


def _unique(shape, dtype, seed):
    n = int(np.prod(shape))
    return np.random.default_rng(seed).permutation(n).reshape(shape).astype(
        dtype)


@pytest.mark.parametrize("wrap", [False, True], ids=["walled", "periodic"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_simulated_rdma_matches_jax_exchange(layout, wrap):
    """The remote-DMA protocol simulated over one-tile rank blocks equals
    the JAX ppermute exchange on the 8-device mesh, bitwise: every depth
    1..halo at float64, the full depth with 3 levels and at int32."""
    halo = 3
    spec, gj = _spec_and_jax(layout, wrap, halo)
    cases = [(d, np.float64, ()) for d in range(1, halo + 1)]
    cases += [(halo, np.float64, (3,)), (halo, np.int32, ())]
    for depth, dtype, lead in cases:
        a = _unique(lead + spec.global_array_shape, dtype, depth)
        want = np.asarray(jhalo.exchange(a, gj.mesh, gj.halo_spec, depth))
        blocks = _split(torch.from_numpy(a), spec)
        got = _join(trdma.exchange_reference(blocks, spec, depth), spec)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=str((depth, dtype, lead)))


def _calls(spec, blocks_per_call, fence, land, done, buffers=2):
    """Each rank's protocol over the calls, one after another, on one
    persistent fence and set of landing buffers; ``done[r]`` counts the
    calls rank r has finished."""
    def rank_calls(r):
        for c, blocks in enumerate(blocks_per_call):
            yield from trdma._rank_protocol(r, blocks[r], spec, 2, fence,
                                            land, c + 1, buffers=buffers)
            done[r] = c + 1
    return {r: rank_calls(r) for r in range(spec.num_ranks)}


def _step(live, r) -> None:
    try:
        next(live[r])
    except StopIteration:
        del live[r]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_simulated_rdma_counting_skew(layout, seed):
    """Five calls per rank over one persistent fence and set of landing
    buffers, under a seeded random turn order in which one rank runs as
    far ahead as the protocol lets it (until its wait blocks) before each
    step of another: no landing buffer is overwritten unread, the fast
    rank gets a call ahead, and every call equals the plain exchange of
    its input."""
    spec, _ = _spec_and_jax(layout, True, 2)
    rng = np.random.default_rng(seed)
    ncalls = 5
    inputs = [torch.from_numpy(_unique(spec.global_array_shape, np.float64,
                                       10 * seed + c)) for c in range(ncalls)]
    outs = [[b.clone() for b in _split(a, spec)] for a in inputs]
    fence, land = trdma.FenceModel(), trdma._Landing()
    done = [0] * spec.num_ranks
    live = _calls(spec, outs, fence, land, done)
    fast = int(rng.integers(spec.num_ranks))
    lead = 0
    while live:
        before = fence.events
        while fast in live:             # as far ahead as it may go
            was = fence.events
            _step(live, fast)
            if fence.events == was:
                break
        lead = max(lead, done[fast] - min(done))
        others = [r for r in live if r != fast]
        if others:
            _step(live, int(rng.choice(others)))
        if live and fence.events == before:     # all blocked but these?
            for r in list(live):
                _step(live, r)
            assert fence.events != before, "stuck"
    assert lead == 1
    for c in range(ncalls):
        want = _join(trdma.exchange_reference(_split(inputs[c], spec), spec,
                                              2), spec)
        assert torch.equal(_join(outs[c], spec), want), c


def test_simulated_rdma_without_fence_is_caught():
    """With one landing buffer per direction instead of two (the call
    parity dropped), a fast rank's next call overwrites a strip its
    neighbour has not read yet: the simulation raises.  The same turns
    with two buffers run through."""
    spec, _ = _spec_and_jax((2, 1), True, 2)
    blocks = [_split(torch.zeros(spec.global_array_shape), spec)
              for _ in range(3)]
    for buffers in (2, 1):
        fence, land = trdma.FenceModel(), trdma._Landing()
        live = _calls(spec, [[b.clone() for b in bl] for bl in blocks],
                      fence, land, [0, 0], buffers=buffers)

        def run():
            for r in itertools.cycle([0] * 5 + [1]):
                if r in live:
                    _step(live, r)
                if not live:
                    break
        if buffers == 2:
            run()
        else:
            with pytest.raises(RuntimeError, match="overwritten"):
                run()


@pytest.mark.parametrize("wrap", [False, True], ids=["walled", "periodic"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_simulated_rdma_one_handoff_per_call(layout, wrap):
    """Each rank makes one hand-off per call (the entry barrier and the
    two fenced phases made five): one signal to and one wait for each
    neighbour direction that exchanges, every wait after every signal."""
    spec, _ = _spec_and_jax(layout, wrap, 2)
    fence = trdma.FenceModel()
    blocks = _split(torch.zeros(spec.global_array_shape), spec)
    trdma.exchange_reference(blocks, spec, 2, fence=fence)
    dirs = trdma.active_directions(spec)
    both = wrap or min(layout) > 1
    assert len(dirs) == (8 if both else 2)
    for r in range(spec.num_ranks):
        mine = [(k, slot) for rr, k, slot in fence.trace if rr == r]
        assert fence.handoffs(r) == 1
        assert sorted(slot for k, slot in mine if k == "wait") == sorted(
            trdma.delivered_slot(d) for d in dirs)
        assert [k for k, _ in mine] == ["signal"] * len(dirs) + [
            "wait"] * len(dirs)


def test_fence_model_monotonic_slots():
    f = trdma.FenceModel()
    slot = trdma.delivered_slot(3)
    assert not f.reached(0, slot, 1)
    f.write(0, slot, 2, by=1)
    assert f.reached(0, slot, 1) and f.reached(0, slot, 2)
    assert not f.reached(0, slot, 3)
    with pytest.raises(RuntimeError, match="wrote 1 over 2"):
        f.write(0, slot, 1, by=1)
    assert f.handoffs(0) == 1 and f.handoffs(1) == 0


def test_rdma_wait_budget_raises_naming_the_slot(monkeypatch):
    """The wrapper's host-side bound on the stream waits, with a clock
    that jumps and a library whose events never complete: a call whose
    wait on the north neighbour is still pending past BUDGET_S (checked
    by the next call, by settle, or by the watchdog) releases every slot
    the enqueued calls wait on, marks the window unusable and raises
    naming the slot and the rank; calls that passed return."""
    spec, _ = _spec_and_jax((2, 2), False, 2)
    north = trdma.delivered_slot(3)

    class Lib:
        released = []
        done = True

        def rdma_event_query(self, event):
            return 0 if self.done else 600

        def rdma_read_slots(self, device, ptr, out):
            for d in trdma.active_directions(spec):
                out[trdma.delivered_slot(d)] = 3
            out[north] = 2
            return 0

        def rdma_release(self, device, ptr, slot, value):
            self.released.append((slot, value))
            return 0

    def window():
        return trdma.Window(ptr=1, land=(0,) * 8, land_bytes=(0,) * 8,
                            spec=spec, device=0, events=(5, 6), calls=4,
                            checked=2)

    kern = trdma.RdmaExchangeKernel()
    kern._lib = lib = Lib()
    clock = iter(np.arange(0.0, 1e5, 50.0))
    monkeypatch.setattr(trdma, "_clock", lambda: next(clock))
    monkeypatch.setattr(tenv, "get_rank", lambda: 0)
    win = window()
    kern.finish(win, "rdma exchange")          # call 3 passed; 4 is newest
    assert (win.checked, win.broken, lib.released) == (3, "", [])
    lib.done = False
    for check in ("finish", "settle", "watchdog"):
        win, lib.released = window(), []
        kern._windows = {"key": win}
        if check == "finish":
            with pytest.raises(RuntimeError, match=r"call 3's wait on slot "
                               r"11 \(the north neighbour, rank 2\)"):
                kern.finish(win, "rdma exchange")
        elif check == "settle":
            with pytest.raises(RuntimeError, match="slot 11"):
                kern.settle()
        else:
            win.issued_at = -1e4                 # enqueued long ago
            kern.watch_once()
            assert "slot 11" in win.broken
        # every slot call 4 waits on is released to 4, so the stream drains
        assert sorted(lib.released) == sorted(
            (trdma.delivered_slot(d), 4)
            for d in trdma.active_directions(spec))
        with pytest.raises(RuntimeError, match="unusable"):
            kern.protocol_args(win, 1, 1)


def test_simulated_rdma_stuck_raises():
    """A protocol that cannot progress (a rank missing) raises."""
    spec, _ = _spec_and_jax((2, 1), False, 2)
    blocks = _split(torch.zeros(spec.global_array_shape), spec)
    with pytest.raises(RuntimeError, match="stuck"):
        trdma.exchange_reference(blocks, spec, 1, order=[0])


def test_remote_dma_guards():
    spec, _ = _spec_and_jax((2, 2), False, 2)
    over = HaloSpec(**{**spec.__dict__, "nprocx": 4, "repx": 2})
    with pytest.raises(NotImplementedError, match="one tile per device"):
        trdma.exchange_reference([torch.zeros(over.array_shape)] * 4, over,
                                 1)
    with pytest.raises(ValueError, match="depth"):
        trdma.exchange_reference(_split(torch.zeros(
            spec.global_array_shape), spec), spec, 3)
    meta = torch.empty(spec.array_shape, device="meta")
    with pytest.raises(ValueError, match="rank grid"):
        trdma.exchange(meta, spec, 1)        # one process, 4-rank spec


@pytest.mark.gpu
def test_fence_oracles_on_card():
    """The oracle kernels on the card (csrc/fence_oracle.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the fence kernels have no CPU mode)")
    before = tfo.fence_oracle.launches
    res = tfo.run_oracles("cuda")
    assert res["negative_timed_out"] and res["control_completed"]
    assert tfo.fence_oracle.launches - before == 3
