"""One rank of the port's multi-process checks.

The port's counterpart of ``tests/mp_worker.py``: run by every rank of a
gang of :mod:`..launch`, it drives the port's paths across ranks and
rank 0 writes what they gave to an npz, for a single-process run (the
JAX package's in the CPU tests, the port's on the card in
``chip_smoke.py``) to be compared with::

    python -m dl_esm_inf_tpu_torch.launch -n 2 \\
        -m dl_esm_inf_tpu_torch.parallel.mp_check --out r.npz --device cpu \\
        --ndomains 8 --legs core,periodic

Legs (``--legs``, comma separated):

* ``core``: ``tests/mp_worker.py``'s oracle legs: the hill halo (24x20),
  the checksum of ones, the scatter/gather round trip, and the flagship
  (32x32, open north, 10 steps, from a Gaussian bump); and a sub-region
  written and read back across rank blocks;
* ``periodic``: a doubly periodic 16x16 field exchanged across ranks;
* ``hill_rdma``: the hill leg with ``transport="remote_dma"`` (one tile
  per rank);
* ``guards``: every path of the port runs across ranks; records which
  ran and which raised ``NotImplementedError`` naming ROADMAP (none
  should: the solvers, the semi-implicit model and its adjoint, the
  clients, invoke, Schedule, the PSy flagship, the coupled tracer, the
  flagship's fused transport, the ensemble, 4D-Var and nesting), that
  the fused transport refuses several tiles per rank, and that the
  kernel-variant microbench refuses ranks with a ``ValueError``;
* ``exchange``: ``Field.halo_exchange`` at ``--n``^2 (halo 8, depth 1
  and 8, 2D and 3 levels, walled and doubly periodic) under both
  transports, each held bitwise against the plain single-rank exchange
  of the whole stacked array on rank 0's device, and the ``ppermute``
  exchange at depth 8 on 4 tiles a rank (walled and periodic), with µs
  per call; on the card also one strip transfer (``halo._send_recv``)
  under the gang's seam transport: µs per call, and in one profiled
  call (torch.profiler) the copies to and from the host, the host
  synchronisations and the copies between device buffers, and the same
  of one ``all_reduce`` of two values and one ``all_gather`` of a nest's
  band (on the card the depth-8 ``remote_dma`` call also checked before it
  returns, ``settle``, and its kernel time from torch.profiler); the
  rdma kernel's entry (one exchange against its plain version, the
  protocol simulated over the gathered blocks, and that simulation's
  hand-offs and waits per call);
* ``skew``: two back-to-back ``remote_dma`` exchanges with the last rank
  delayed 50 ms before the second (a fast rank a call ahead), each held
  bitwise;
* ``flagship``: the flagship at ``--n``^2, K=4, halo 8, one tile per rank,
  ``--steps`` steps; its gathered fields and µs/step (CUDA events);
* ``fence``: the fence round trip between ranks 0 and 1 (µs), spinning
  in a kernel and with the wait off the SMs (stream memory operations),
  and the card's stream memory operations attribute;
* ``flagship_fused``: the flagship with ``transport="fused"`` (the
  exchange between ranks inside the sweep) on each rank layout of
  ``--fused-layouts`` that has one tile per rank (``PXxPY`` tiles, e.g.
  ``4x1,1x4,2x2``) at each K of ``--fused-k``, ``--fused-shape``, halo
  8, ``--fused-sweeps`` sweeps from a seeded start; its gathered fields
  and the rdma sweep's launches; on the card also µs per sweep (and its
  kernel time from torch.profiler) and per step of both transports,
  and the kernel against its plain version on one sweep; then the last
  of them over a seeded depth plane at float64;
* ``fused_alternate``: on the last layout at the largest K, sweeps
  alternating with standalone ``remote_dma`` exchanges of a 3-level
  field on the same spec; the model's fields and each exchange held
  against the runs without alternation and the plain exchange;
* ``fused_skew``: the same sweeps with the last rank 50 ms late before
  the second, held against the run without skew;
* ``overlap``: the flagship's overlap mode, one tile per rank
  (``--overlap-shape``, halo 2, open north, ``--overlap-steps`` steps
  from a Gaussian bump), on the plain path and with ``fused=True`` at
  K=1, over each of ``--overlap-depths`` (flat, and variable:
  tests/test_nemolite2d.py:187-214's plane): the gathered fields of
  ``step_program(n, overlap=True)`` and of the non-overlapped step; on
  the card also µs per step of both and the order of one overlapped
  step's device work beside the host's exchange call
  (torch.profiler).

The legs of the slice across ranks, at ``--n``^2 on ``--ndomains`` tiles,
``--steps`` steps, each gathered for a single process to compare with
(on the card also its µs per step, or ms per solve or save):

* ``solvers``: ``HelmholtzSolver`` with CG and with the fused Chebyshev
  sweep at K=4 (walled, an island, lam LAM) on a seeded rhs: the
  solutions, iterations, relative residuals, and the sweep's launches;
  on the card also one CG iteration's host copies and synchronisations
  (torch.profiler);
* ``semi_implicit``: ``tests/mp_worker.py``'s two runs (CG; and the
  open north boundary), 5 steps each;
* ``clients``: gravity wave, shallow (periodic), two-layer, N-layer and
  the tracer (van Leer and upwind) on their fused sweeps at their main
  paths' K (:func:`client_cases`), with each kernel's launches;
* ``schedule``: ``tests/mp_worker.py``'s fused schedule (two east shifts,
  halo 2), its plain run, and the ``invoke`` and ``Schedule``
  reductions (sum, min, max);
* ``psy``: ``NemoLite2DPsy`` (halo 8) on ``Schedule.fused``;
* ``coupled``: ``CoupledTracer`` on the open-north flagship (halo 2);
* ``checkpoint``: ``save_fields`` of a seeded field (and a 3-level one)
  at step 7, loaded back on these ranks into a grid of another tiling;
  the file stays for the caller (``<out>.ckpt.npz``);
* ``tiles``: gravity wave at its main K and a Helmholtz CG solve on
  :data:`TILES_PER_RANK` tiles a rank at ``--n``^2 (the layout the
  remote-DMA exchange refuses), ``--steps`` steps.

The legs of the ensemble, the adjoint and nesting across ranks, on
``--ndomains`` tiles (host ms of each analysis, cost and gradient, or
nest step beside the results):

* ``ensemble``: :func:`ensemble_run`, tests/mp_worker.py's ensemble at
  ``--ens-n``^2 with ``--members`` members: the forecast, a global ETKF
  and a localized one (``--letkf-obs``, ``--letkf-radius``), each
  followed by 2 steps;
* ``adjoint``: the cases of ``--adjoint-cases``: the cost and gradient
  of :func:`adjoint_cases` (flagship, semi_implicit, coupled) at
  ``--adjoint-n``^2 (the flagship observed at ``--adjoint-steps``/2 and
  ``--adjoint-steps``, ``--remat`` its remat_chunk), and
  ``assimilate`` with the optimisers of :data:`OPTIMISERS` (adam,
  lbfgs, hybrid);
* ``nest``: the cases of ``--nest-cases`` (:data:`NEST_CASES`, and
  ``main``: a two-way nest of ``--nest-ratio`` over a centred
  ``--nest-window``^2 at ``--n``^2, ``--nest-steps`` steps): the
  gathered parent and children, or the loss and gradient of ``grad``;
* ``autograd``: :func:`autograd_probe` on a walled and a periodic grid:
  the exchange's and the strip transfer's transposes, and the
  differentiable collectives' gradients.

``--seams peer,gloo`` runs each leg of :data:`SEAM_LEGS` once under each
seam transport (:func:`..environment.set_seam_transport`), in that order,
in the same gang; the first transport's results keep their names, a
later one's are prefixed ``<transport>__``.  Every leg also records the
transport it ran under (``seam_transport_<leg>``) and the batches the
``"peer"`` transport enqueued on rank 0 (``seam_batches_<leg>``).
Without ``--seams`` every leg runs once, under the gang's default.
"""
from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch
import torch.distributed as dist

import dl_esm_inf_tpu_torch as dl
from dl_esm_inf_tpu_torch.core import layout
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.ops import fused_step as fs
from dl_esm_inf_tpu_torch.parallel import environment as env
from dl_esm_inf_tpu_torch.parallel import halo as halo_mod
from dl_esm_inf_tpu_torch.parallel import rdma, seam
from dl_esm_inf_tpu_torch.parallel.collectives import (all_reduce,
                                                       gather_to_host)
from dl_esm_inf_tpu_torch.testing import init_field_hill

WALLED = (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE)
PERIODIC = (dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE)
HALO = 8


def _grid(bcs, gnx, gny, ndomains, device, halo=1):
    g = dl.Grid(dl.ARAKAWA_C, bcs, dl.OFFSET_NE, device=device)
    g.decompose(gnx, gny, ndomains=ndomains, halo_width=halo)
    dl.grid_init(g, 1.0, 1.0)
    return g


def leg_core(res, a):
    gnx, gny = 24, 20
    grid = _grid(WALLED, gnx, gny, a.ndomains, a.device)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, -666.0)
    fld.halo_exchange(1)
    res["hill"] = fld.get_data()
    ones = dl.Field(grid, dl.T_POINTS, init_global_data=np.ones((gny, gnx)))
    res["gsum"] = np.asarray(dl.field_checksum(ones))
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    f2 = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    f2.data = f2.data + 1.0
    res["roundtrip"] = f2.gather_inner_data()
    # sub-region IO in whole-layout coordinates, across rank blocks
    region = dl.Region(2, grid.global_array_shape[1] - 2, 1, 5)
    f2.write_to_device(region, np.full((region.ny, region.nx), 7.0))
    res["region_io"] = f2.read_from_device(region)
    m = nl.build(32, 32, ndomains=a.ndomains, open_north=True,
                 device=a.device)
    m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
    m.run(10)
    for k, v in m.gather().items():
        res[f"nl_{k}"] = v


def leg_periodic(res, a):
    pgrid = _grid(PERIODIC, 16, 16, a.ndomains, a.device)
    pf = dl.Field(pgrid, dl.T_POINTS,
                  init_global_data=np.arange(256.0).reshape(16, 16))
    pf.halo_exchange(1)
    res["periodic"] = pf.get_data()


def leg_hill_rdma(res, a):
    grid = _grid(WALLED, 24, 20, a.ndomains, a.device)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, -666.0)
    fld.halo_exchange(1, transport="remote_dma")
    res["hill_rdma"] = fld.get_data()


def leg_guards(res, a):
    """Every path runs across ranks: records which ran and which raised
    NotImplementedError naming ROADMAP."""
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.models import (gravity_wave, nlayer,
                                             semi_implicit, shallow, tracer,
                                             twolayer)
    from dl_esm_inf_tpu_torch.models.assimilation import make_cost_fn
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    from dl_esm_inf_tpu_torch.models.nesting import OneWayNest
    from dl_esm_inf_tpu_torch.ops import solvers

    dev = a.device
    n = 8 * a.ndomains
    grid = _grid(WALLED, n, n, a.ndomains, dev, halo=2)
    fld = dl.Field(grid, dl.T_POINTS)
    flag = nl.build(n, n, ndomains=a.ndomains, halo_width=8, device=dev)
    u, v = tracer.streamfunction_velocities(gaussian_eta(n, n, amp=0.1))
    cases = {
        "helmholtz": lambda: solvers.HelmholtzSolver(grid, 1.0, 1.0),
        "pcg_block": lambda: solvers.pcg_block(
            lambda x: x, fld.data, fld.data, fld.internal_mask, tol=1e-6,
            maxiter=2),
        "semi_implicit": lambda: semi_implicit.build(
            n, n, ndomains=a.ndomains, device=dev),
        "semi_implicit_differentiable": lambda: semi_implicit.build(
            n, n, ndomains=a.ndomains, differentiable=True, device=dev),
        "schedule": lambda: km.Schedule((_copy_kernel(km), fld, fld)),
        "invoke": lambda: km.invoke(_copy_kernel(km), fld, fld),
        "psy": lambda: NemoLite2DPsy(n, n, ndomains=a.ndomains,
                                     device=dev),
        "gravity_wave": lambda: gravity_wave.build(
            n, n, ndomains=a.ndomains, device=dev),
        "shallow": lambda: shallow.build(n, n, ndomains=a.ndomains,
                                         device=dev),
        "twolayer": lambda: twolayer.build(n, n, ndomains=a.ndomains,
                                           device=dev),
        "tracer": lambda: tracer.build(n, n, ndomains=a.ndomains, u=u, v=v,
                                       device=dev),
        "nlayer": lambda: nlayer.build(n, n, ndomains=a.ndomains,
                                       device=dev),
        "fused_transport": lambda: _fused_runs(n, dev),
        "coupled_tracer": lambda: tracer.CoupledTracer(
            nl.build(n, n, ndomains=a.ndomains, halo_width=2, device=dev)),
        "nesting": lambda: OneWayNest(
            gravity_wave.build(n, n, ndomains=a.ndomains, device=dev),
            origin=(n // 4, n // 4), shape=(n // 2, n // 2), ratio=2),
        "ensemble": lambda: Ensemble(flag, 2),
        "assimilation": lambda: make_cost_fn(flag, {1: np.zeros((n, n))}),
    }
    raised, ran = [], []
    for name, fn in cases.items():
        try:
            fn()
            ran.append(name)
        except NotImplementedError as e:
            if "ROADMAP" in str(e):
                raised.append(name)
    res["guards_raised"] = np.array(sorted(raised))
    res["guards_ran"] = np.array(sorted(ran))
    res["guards_all"] = np.array(sorted(cases))
    try:       # several tiles per rank: the fused transport refuses them
        flag.enable_fast_path(4, "fused")
        refused = False
    except ValueError as e:
        refused = "one tile per rank" in str(e)
    res["fused_multi_tile_refused"] = np.asarray(refused)
    try:       # the microbench times one device
        from dl_esm_inf_tpu_torch import kbench
        kbench._model(n, torch.device(dev) if dev else None)
        refused = False
    except ValueError as e:
        refused = "one device" in str(e)
    res["guards_kbench_refused"] = np.asarray(refused)


def _fused_runs(n, dev):
    """The flagship with the fused transport, one tile per rank: runs."""
    m = nl.build(n, n, ndomains=env.get_num_ranks(), halo_width=8,
                 device=dev)
    m.enable_fast_path(4, "fused")
    m.run(5)


def _copy_kernel(km):
    @km.kernel(args=[km.go_arg(km.GO_WRITE, km.GO_CT),
                     km.go_arg(km.GO_READ, km.GO_CT)])
    def mp_copy(out, x):
        return x
    return mp_copy


def _one_rank_spec(spec):
    """The same decomposition held by one rank: the single-process
    port's exchange of the whole stacked array."""
    return halo_mod.HaloSpec(**{**spec.__dict__, "repx": spec.nprocx,
                                "repy": spec.nprocy})


def _whole(spec, lead, dtype, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(
        lead + spec.global_array_shape)).to(dtype)


def _us_per_call(fn, device, reps):
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps * 1e6


def leg_exchange(res, a):
    dev = torch.device(a.device) if a.device else env.resolve_device()
    rank = env.get_rank()
    nranks = env.get_num_ranks()
    rdma.halo_exchange_rdma.launches = 0
    calls, timed = 0, []
    for bcs, wname in ((WALLED, "walled"), (PERIODIC, "periodic")):
        grid = _grid(bcs, a.n, a.n, nranks, a.device, halo=HALO)
        spec = grid.halo_spec
        whole_spec = _one_rank_spec(spec)
        for levels in (None, 3):
            lead = () if levels is None else (levels,)
            full = _whole(spec, lead, grid.dtype, seed=calls)
            for depth in (1, HALO):
                want = None
                if rank == 0:
                    want = halo_mod.exchange(full.to(dev), whole_spec,
                                             depth).cpu().numpy()
                for transport in ("ppermute", "remote_dma"):
                    f = dl.Field(grid, dl.T_POINTS, levels=levels)
                    f.set_data(full)
                    f.halo_exchange(depth, transport=transport)
                    calls += transport == "remote_dma"
                    got = f.get_data()
                    tag = (f"{wname}_{'2d' if levels is None else 'l3'}_"
                           f"d{depth}_{transport}")
                    if rank == 0:
                        res[f"exch_equal_{tag}"] = np.asarray(
                            np.array_equal(got, want))
                    if levels is None and wname == "walled":
                        timed.append((tag, f.data, spec, depth, transport))
    res["exch_rdma_calls"] = np.asarray(calls)
    res["exch_rdma_launches"] = np.asarray(
        rdma.halo_exchange_rdma.launches)
    res["exch_rank_grid"] = np.asarray(f"{spec.ranks_y}x{spec.ranks_x}")
    # the ppermute exchange on 4 tiles a rank, which remote_dma refuses
    for bcs, wname in ((WALLED, "walled"), (PERIODIC, "periodic")):
        grid = _grid(bcs, a.n, a.n, TILES_PER_RANK * nranks, a.device,
                     halo=HALO)
        spec = grid.halo_spec
        full = _whole(spec, (), grid.dtype, seed=50 + len(wname))
        f = dl.Field(grid, dl.T_POINTS)
        f.set_data(full)
        f.halo_exchange(HALO)
        got = f.get_data()
        if rank == 0:
            want = halo_mod.exchange(full.to(dev), _one_rank_spec(spec),
                                     HALO).cpu().numpy()
            res[f"exch_tiles_equal_{wname}"] = np.asarray(
                np.array_equal(got, want))
            res["exch_tiles_layout"] = np.asarray(
                f"{spec.ranks_y}x{spec.ranks_x} ranks of "
                f"{spec.repy}x{spec.repx} tiles")
    if dev.type == "cuda":
        _seam_probe(res, grid, a.reps)
        _collective_probe(res, a)
    # µs per call of each transport on the walled 2D blocks
    for tag, blk, spec, depth, transport in timed:
        fn = ((lambda: halo_mod.exchange(blk, spec, depth))
              if transport == "ppermute" else
              (lambda: rdma.exchange(blk, spec, depth)))
        res[f"exch_us_{tag}"] = np.asarray(_us_per_call(fn, dev, a.reps))
        if transport == "remote_dma" and depth == HALO and (
                dev.type == "cuda"):
            # the same calls, each checked before it returns (the wait
            # check not deferred to the next call)
            def settled(blk=blk, spec=spec):
                rdma.exchange(blk, spec, HALO)
                rdma.halo_exchange_rdma.settle()
            res[f"exch_us_settled_{tag}"] = np.asarray(
                _us_per_call(settled, dev, a.reps))
            res[f"exch_kernel_us_{tag}"] = np.asarray(
                _kernel_us_per_call(fn, a.reps))
    # the kernel entry: one 2D walled depth-8 exchange against the plain
    # version, the protocol simulated over every rank's block
    grid = _grid(WALLED, a.n, a.n, nranks, a.device, halo=HALO)
    spec = grid.halo_spec
    f = dl.Field(grid, dl.T_POINTS)
    f.set_data(_whole(spec, (), grid.dtype, seed=99))
    got = rdma.exchange(f.data, spec, HALO)
    blocks = [torch.empty_like(f.data) for _ in range(nranks)]
    dist.all_gather(blocks, f.data)
    fence = rdma.FenceModel()
    plain = rdma.exchange_reference(blocks, spec, HALO, fence=fence)
    res["rdma_handoffs_per_call"] = np.asarray(max(
        fence.handoffs(r) for r in range(nranks)))
    res["rdma_waits_per_call"] = np.asarray(
        sum(1 for r, k, _ in fence.trace if k == "wait") // nranks)
    err = torch.tensor([float((got - plain[rank]).abs().max())],
                       dtype=torch.float64)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    res["rdma_max_abs_err"] = np.asarray(float(err[0]))
    if rank == 0 and dev.type == "cuda":
        res["rdma_plain_us"] = np.asarray(_local_us(
            lambda: rdma.exchange_reference(blocks, spec, HALO), dev,
            a.reps))
    res["rdma_block_bytes"] = np.asarray(f.data.numel()
                                         * f.data.element_size())


#: the runtime calls that make the host wait for the card
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")


def _profiled(fn, dev, label: str) -> dict:
    """One call of ``fn`` under torch.profiler (every rank at once): the
    copies to and from the host (``dtoh``, ``htod``) and between device
    buffers (``dtod``) the card made, and the host synchronisations
    (``syncs``) inside the call (the profile's own after it is not the
    call's)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _sync(dev)
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
        _sync(dev)
    events = prof.events()
    call = next(e.time_range for e in events if e.name == label
                and str(e.device_type).endswith("CPU"))
    names = [e.name for e in events]
    return {"dtoh": sum("Memcpy DtoH" in n for n in names),
            "htod": sum("Memcpy HtoD" in n for n in names),
            "dtod": sum("Memcpy DtoD" in n or "Memcpy PtoP" in n
                        for n in names),
            "syncs": sum(e.name in HOST_SYNCS and call.start
                         <= e.time_range.start <= call.end for e in events)}


def _seam_probe(res, grid, reps):
    """One strip transfer of the exchange (``halo._Transfer``: the last
    HALO columns of this rank's block of ``grid`` to the next rank, the
    first HALO to the previous, none past the ends of the rank order)
    under the gang's seam transport: µs per call, and in one profiled
    call the copies to and from the host, the host synchronisations and
    the copies between device buffers (:func:`_profiled`)."""
    dev = grid.device
    r, nr = env.get_rank(), env.get_num_ranks()
    blk = grid.block_tensor(np.zeros(grid.global_array_shape))
    up, down = blk[:, -HALO:].clone(), blk[:, :HALO].clone()

    def transfer():
        return halo_mod._Transfer.apply(up, down, (r + 1) % nr,
                                        (r - 1) % nr, r < nr - 1, r > 0)
    res["seam_us_per_call"] = np.asarray(_us_per_call(transfer, dev, reps))
    for k, v in _profiled(transfer, dev, "seam_transfer").items():
        res[f"seam_profile_{k}"] = np.asarray(v)


def _collective_probe(res, a):
    """The collectives under the gang's seam transport, on the card: one
    ``all_reduce`` of two values (CG's pair of dots, in the solver's
    accumulation dtype) and one ``all_gather`` of a nest's band (the
    parent T points the ring of :func:`nest_main_case`'s nest reads, at
    ``--n``^2 with ``--nest-window`` (at most half of ``--n``) and
    ``--nest-ratio``, this rank's values of them): µs per call of each,
    the band's length, and in one
    profiled call of each the copies to and from the host, the host
    synchronisations and the copies between device buffers
    (:func:`_profiled`)."""
    from types import SimpleNamespace

    from dl_esm_inf_tpu_torch.core import kinds
    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models import nesting
    from dl_esm_inf_tpu_torch.parallel.collectives import all_gather
    case = nest_main_case(a.n, min(a.nest_window, a.n // 2), a.nest_ratio,
                          1)
    parent, nests, _ = build_nests(SimpleNamespace(gw=gwm, nest=nesting),
                                   case, env.get_num_ranks(),
                                   dict(device=a.device))
    dev, p_eta = parent.grid.device, parent.eta.data
    mine, by, bx, _, _ = nests[0]._band
    band = torch.where(mine, p_eta[by, bx], torch.zeros(
        (), dtype=p_eta.dtype, device=dev))
    dots = torch.tensor([1.0, 2.0 + env.get_rank()], device=dev,
                        dtype=kinds.sum_dtype(p_eta.dtype))
    for tag, fn in (("allreduce", lambda: all_reduce(dots)),
                    ("allgather", lambda: all_gather(band))):
        res[f"seam_{tag}_us_per_call"] = np.asarray(
            _us_per_call(fn, dev, a.reps))
        for k, v in _profiled(fn, dev, f"seam_{tag}").items():
            res[f"seam_{tag}_profile_{k}"] = np.asarray(v)
    res["seam_allgather_band"] = np.asarray(band.numel())


def _kernel_us_per_call(fn, reps):
    """µs of kernel time on the card per call of ``fn`` (torch.profiler's
    device time over ``reps`` calls): what the card is busy with, against
    the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps


def _local_us(fn, device, reps):
    """µs per call of ``fn`` on this rank alone (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def leg_skew(res, a):
    rank, nranks = env.get_rank(), env.get_num_ranks()
    grid = _grid(WALLED, a.n, a.n, nranks, a.device, halo=HALO)
    spec = grid.halo_spec
    whole_spec = _one_rank_spec(spec)
    dev = grid.device
    ok = []
    fields = []
    for call in range(2):
        full = _whole(spec, (), grid.dtype, seed=200 + call)
        f = dl.Field(grid, dl.T_POINTS)
        f.set_data(full)
        fields.append((f, full))
    dist.barrier()
    for call, (f, _) in enumerate(fields):
        if call == 1 and rank == nranks - 1:
            time.sleep(0.05)
        f.halo_exchange(HALO, transport="remote_dma")
    for f, full in fields:
        got = f.get_data()
        if rank == 0:
            want = halo_mod.exchange(full.to(dev), whole_spec, HALO)
            ok.append(bool(np.array_equal(got, want.cpu().numpy())))
    if rank == 0:
        res["skew_equal"] = np.asarray(all(ok) and len(ok) == 2)


def leg_flagship(res, a):
    nranks = env.get_num_ranks()
    m = nl.build(a.n, a.n, ndomains=nranks, fused=True, steps_per_sweep=4,
                 halo_width=HALO, device=a.device)
    m.set_initial_ssh(gaussian_eta(a.n, a.n, amp=0.2))
    dev = m.grid.device
    fs.nemolite2d_sweep.launches = 0
    m.run(a.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res["nl_launches"] = np.asarray(fs.nemolite2d_sweep.launches)
    for k, v in m.gather().items():
        res[f"big_{k}"] = v
    if dev.type == "cuda":
        dist.barrier()
        res["nl_us_per_step"] = np.asarray(
            _local_us(lambda: m.run(a.steps), dev, 3) / a.steps)


def leg_fence(res, a):
    rank = env.get_rank()
    grid = _grid(WALLED, a.n, a.n, env.get_num_ranks(), a.device, halo=HALO)
    dev = grid.device
    win = rdma.halo_exchange_rdma.window(grid.halo_spec, grid.dtype, (), dev)
    from dl_esm_inf_tpu_torch.parallel import fence_oracle as fo
    dist.barrier()
    if rank < 2:
        peer = 1 - rank
        fo.pingpong_us(win, peer, 2, dev)          # warm up
        us = fo.pingpong_us(win, peer, a.rounds, dev)
        fo.stream_pingpong_us(win, peer, 2, dev)
        stream_us = fo.stream_pingpong_us(win, peer, a.rounds, dev)
        if rank == 0:
            res["fence_round_trip_us"] = np.asarray(us)
            res["fence_stream_round_trip_us"] = np.asarray(stream_us)
            res["stream_memops_attribute"] = np.asarray(
                fo.fence_oracle.stream_memops(dev))


def _layouts(a):
    """The ``--fused-layouts`` that give every rank one tile."""
    out = []
    for item in a.fused_layouts.split(","):
        px, py = (int(v) for v in item.split("x"))
        if px * py == env.get_num_ranks():
            out.append((px, py))
    if not out:
        raise ValueError(f"no layout of {a.fused_layouts!r} has "
                         f"{env.get_num_ranks()} tiles")
    return out


def fused_model(a, px, py, K, transport="fused", variable_depth=False):
    """The flagship on ``px x py`` tiles, halo 8, from the seeded start
    (a Gaussian bump and seeded noise, made with numpy), with the fused
    sweep of K steps on ``transport``; ``variable_depth``: at float64
    over a seeded depth plane (50-150 m), else at the device's default
    dtype over the flat 100 m."""
    gnx, gny = (int(v) for v in a.fused_shape.split("x"))
    g = dl.Grid(dl.ARAKAWA_C, WALLED, dl.OFFSET_NE, device=a.device,
                dtype=torch.float64 if variable_depth else None)
    g.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=HALO)
    dl.grid_init(g, 1000.0, 1000.0, nl.default_tmask(gnx, gny))
    depth = (50.0 + 100.0 * np.random.default_rng(11).random((gny, gnx))
             if variable_depth else 100.0)
    m = nl.NemoLite2D(g, depth=depth)
    m.enable_fast_path(K, transport)
    m.set_initial_ssh(fused_initial_ssh(gnx, gny))
    return m


def fused_initial_ssh(gnx, gny, seed=9):
    """The fused legs' start: a Gaussian bump plus seeded noise."""
    rng = np.random.default_rng(seed)
    return (gaussian_eta(gnx, gny, amp=0.2)
            + 0.01 * rng.standard_normal((gny, gnx)))


def _tag(px, py, K):
    return f"{px}x{py}_k{K}"


def leg_flagship_fused(res, a):
    for px, py in _layouts(a):
        for K in (int(k) for k in a.fused_k.split(",")):
            m = fused_model(a, px, py, K)
            dev = m.grid.device
            fs.nemolite2d_sweep_rdma.launches = 0
            m.run(a.fused_sweeps * K)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tag = _tag(px, py, K)
            res[f"ff_launches_{tag}"] = np.asarray(
                fs.nemolite2d_sweep_rdma.launches)
            for k, v in m.gather().items():
                res[f"ff_{tag}_{k}"] = v
            if dev.type == "cuda":
                _fused_timing(res, a, m, px, py, K, tag)
    # the variable-depth sweep at float64, on the last layout
    m = fused_model(a, px, py, K, variable_depth=True)
    m.run(a.fused_sweeps * K)
    for k, v in m.gather().items():
        res[f"ffht_{k}"] = v
    res["ffht_tag"] = np.asarray(_tag(px, py, K))


def _fused_timing(res, a, m, px, py, K, tag):
    """On the card: µs per sweep of the kernel and of the ppermute
    transport's exchange + sweep (the library yardstick), µs per step of
    both transports' ``run``, and the kernel against its plain version
    (the protocol simulated over the gathered blocks, then the K steps)
    on one sweep's inputs."""
    dev, spec, rank = m.grid.device, m.grid.halo_spec, env.get_rank()
    steps = a.fused_sweeps * K
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    forcing = m.forcing_series(0, K)
    fused = m._make_fused(K)
    pp = fused_model(a, px, py, K, transport="ppermute")
    sweep = pp._make_fused(K)
    exch = halo_mod.exchange_multi_fn(spec, depth=2 * K)
    res[f"ff_sweep_us_{tag}"] = np.asarray(_us_per_call(
        lambda: fused(*state, m._mask_codes, forcing), dev, a.reps))
    res[f"ff_pp_sweep_us_{tag}"] = np.asarray(_us_per_call(
        lambda: sweep(*exch(state), m._mask_codes, forcing), dev, a.reps))
    res[f"ff_kernel_us_{tag}"] = np.asarray(_kernel_us_per_call(
        lambda: fused(*state, m._mask_codes, forcing), a.reps))
    res[f"ff_run_us_{tag}"] = np.asarray(_us_per_call(
        lambda: m.run(steps), dev, 2) / steps)
    res[f"ff_pp_run_us_{tag}"] = np.asarray(_us_per_call(
        lambda: pp.run(steps), dev, 2) / steps)
    got = fused(*state, m._mask_codes, forcing)
    stacked = torch.stack(state)
    blocks = [torch.empty_like(stacked) for _ in range(spec.num_ranks)]
    dist.all_gather(blocks, stacked)

    def plain():
        ex = rdma.exchange_reference(blocks, spec, spec.halo)[rank]
        return fs.fused_step_reference(
            *ex.unbind(0), m._mask_codes, forcing, p=m.p, dx=m.grid.dx,
            dy=m.grid.dy, fcor=m._fcor, depth=m.depth)
    want = plain()
    h = spec.halo
    inner = (slice(h, h + spec.tile_ny), slice(h, h + spec.tile_nx))
    err = torch.tensor([max(float((g[inner] - w[inner]).abs().max())
                            for g, w in zip(got, want))],
                       dtype=torch.float64)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    res[f"ff_max_abs_err_{tag}"] = np.asarray(float(err[0]))
    if rank == 0:
        res[f"ff_plain_us_{tag}"] = np.asarray(_local_us(plain, dev, 3))
        # each input and output plane once, and the strips sent
        ly, lx = spec.array_shape
        res[f"ff_bytes_{tag}"] = np.asarray(
            (6 * ly * lx + 3 * 2 * h * (ly + lx)) * stacked.element_size()
            + m._mask_codes.numel())


def _alternation(res, a, skew):
    """Sweeps of the last layout at the largest K, each run alone (one
    sweep and the model's own remote_dma exchange of the surface), with
    either a standalone remote_dma exchange of a 3-level field on the
    same spec between them, or the last rank 50 ms late before the
    second; the fields after all of them."""
    rank, nranks = env.get_rank(), env.get_num_ranks()
    px, py = _layouts(a)[-1]
    K = max(int(k) for k in a.fused_k.split(","))
    m = fused_model(a, px, py, K)
    spec, dev = m.grid.halo_spec, m.grid.device
    exch_ok = []
    dist.barrier()
    for i in range(a.fused_sweeps):
        if skew and i == 1 and rank == nranks - 1:
            time.sleep(0.05)
        m.run(K)
        if not skew:
            full = _whole(spec, (3,), m.grid.dtype, seed=300 + i)
            f = dl.Field(m.grid, dl.T_POINTS, levels=3)
            f.set_data(full)
            f.halo_exchange(HALO, transport="remote_dma")
            got = f.get_data()
            if rank == 0:
                want = halo_mod.exchange(full.to(dev), _one_rank_spec(spec),
                                         HALO)
                exch_ok.append(bool(np.array_equal(got,
                                                   want.cpu().numpy())))
    name = "fskew" if skew else "falt"
    for k, v in m.gather().items():
        res[f"{name}_{k}"] = v
    res[f"{name}_tag"] = np.asarray(_tag(px, py, K))
    if not skew and rank == 0:
        res["falt_exch_equal"] = np.asarray(
            all(exch_ok) and len(exch_ok) == a.fused_sweeps)


def leg_fused_alternate(res, a):
    _alternation(res, a, skew=False)


def leg_fused_skew(res, a):
    _alternation(res, a, skew=True)


def overlap_depth(gnx: int, gny: int) -> np.ndarray:
    """The sloping bottom of the JAX package's variable-depth overlap
    test (tests/test_nemolite2d.py:192-194)."""
    yy = np.linspace(0.0, 1.0, gny)[:, None]
    xx = np.linspace(0.0, 1.0, gnx)[None, :]
    return 70.0 + 40.0 * yy + 10.0 * np.sin(2 * np.pi * xx)


def overlap_model(gnx, gny, ndomains, fused, variable_depth, device):
    """The overlap leg's flagship: halo 2, open north, from the JAX
    tests' bump; ``fused=True`` is the K=1 sweep."""
    m = nl.build(gnx, gny, ndomains=ndomains, halo_width=2,
                 open_north=True, fused=fused,
                 depth=(overlap_depth(gnx, gny) if variable_depth
                        else 100.0), device=device)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


def overlap_run(m, nsteps, overlap):
    """``step_program(nsteps, overlap=...)`` from the model's state; the
    model's fields are left as they were."""
    prog = m.step_program(nsteps, overlap=overlap)
    bathy = (m._ht,) if m._ht is not None else ()
    return prog(0, (m.sshn_t.data, m.un.data, m.vn.data), m._mask_codes,
                *bathy)


def overlap_gather(m, state) -> dict:
    """The gathered internal points of a state of ``m`` (collective)."""
    d, spec = m.grid.decomp, m.grid.halo_spec
    return {k: layout.unstack_internal(d, gather_to_host(v, spec))
            for k, v in zip(("sshn", "un", "vn"), state)}


def leg_overlap(res, a):
    gnx, gny = (int(v) for v in a.overlap_shape.split("x"))
    nranks = env.get_num_ranks()
    depths = a.overlap_depths.split(",")
    for fused in (False, True):
        for var in (d == "variable" for d in depths):
            m = overlap_model(gnx, gny, nranks, fused, var, a.device)
            tag = f"{'fused' if fused else 'plain'}_{'ht' if var else 'flat'}"
            fs.nemolite2d_sweep.launches = 0
            for ov in (False, True):
                got = overlap_gather(m, overlap_run(m, a.overlap_steps, ov))
                for k, v in got.items():
                    res[f"ov_{tag}_{'overlap' if ov else 'step'}_{k}"] = v
            res[f"ov_launches_{tag}"] = np.asarray(
                fs.nemolite2d_sweep.launches)
            if m.grid.device.type == "cuda" and not var:
                _overlap_timing(res, a, m, tag)


#: steps of each timed run of the overlap leg
OVERLAP_TIMED_STEPS = 10


def _overlap_timing(res, a, m, tag):
    """On the card: µs per step with and without overlap (host clock
    around synchronised runs of OVERLAP_TIMED_STEPS, after a warm-up),
    and, with the K=1 sweep, under torch.profiler, the device work of
    one overlapped step in the order it started beside the host's
    exchange call (``nemolite2d.overlap_exchange``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev, n = m.grid.device, OVERLAP_TIMED_STEPS
    for ov in (False, True):
        res[f"ov_us_{tag}_{'overlap' if ov else 'step'}"] = np.asarray(
            _us_per_call(lambda: overlap_run(m, n, ov), dev, 2) / n)
    if not m.use_fused:
        return
    prog = m.step_program(1, overlap=True)
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    prog(0, state, m._mask_codes)
    torch.cuda.synchronize(dev)
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog(0, state, m._mask_codes)
        torch.cuda.synchronize(dev)
    evs = prof.events()
    work = sorted((e for e in evs if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    wait = [e for e in evs if e.name == "nemolite2d.overlap_exchange"
            and e.device_type == DeviceType.CPU]
    res[f"ov_order_{tag}"] = np.array([e.name[:80] for e in work])
    res[f"ov_order_start_us_{tag}"] = np.asarray(
        [e.time_range.start for e in work], dtype=np.float64)
    res[f"ov_order_end_us_{tag}"] = np.asarray(
        [e.time_range.end for e in work], dtype=np.float64)
    if wait:
        res[f"ov_wait_us_{tag}"] = np.asarray(
            [wait[0].time_range.start, wait[0].time_range.end],
            dtype=np.float64)


# --- the slice across ranks: solvers, clients, schedules, checkpoint ------

#: the Helmholtz couplings of the solvers leg (bench.py measure_solver's)
LAM = 50.0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_us(fn, dev, reps: int) -> float:
    """µs per call of ``fn`` on this rank after a barrier (CUDA events);
    every rank calls it, so the collectives inside ``fn`` pair up."""
    env.barrier()
    return _local_us(fn, dev, reps)


def warm_up(fn, dev) -> None:
    """On the card, one call of ``fn`` whose result is dropped, before a
    timed one of the same work: the first use of the seams' windows (and
    of gloo's pairs) stays out of the time.  Nothing on the CPU, where
    nothing is timed."""
    if dev.type == "cuda":
        fn()


def timed_call(fn, dev):
    """``(fn(), ms)``: one call after a barrier, timed with CUDA events on
    the card (ms None on the CPU) -- for the calls that take 0.1 s or
    more, which are timed where they are checked, not run again (a
    :func:`warm_up` may run first)."""
    env.barrier()
    if dev.type != "cuda":
        return fn(), None
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def island_tmask(n: int) -> np.ndarray:
    """A walled n x n T mask with a 3 x 3 island (the solver tests')."""
    t = np.ones((n, n), np.int32)
    t[0, :] = t[-1, :] = 0
    t[:, 0] = t[:, -1] = 0
    t[n // 3: n // 3 + 3, n // 3: n // 3 + 3] = 0
    return t


def solver_case(n: int, ndomains: int, device, seed: int = 3):
    """(grid, rhs) of the solvers leg: halo 4, the island mask, a seeded
    rhs on wet points."""
    g = dl.Grid(dl.ARAKAWA_C, WALLED, dl.OFFSET_NE, device=device)
    g.decompose(n, n, ndomains=ndomains, halo_width=4)
    tm = island_tmask(n)
    dl.grid_init(g, 1.0, 1.0, tm)
    rhs = np.random.default_rng(seed).standard_normal((n, n)) * (tm == 1)
    return g, rhs


def solver_tol(dtype):
    """The solvers leg's tolerance: tests/test_torch_solvers.py's 1e-12
    in float64, the default one in float32."""
    return 1e-12 if dtype == torch.float64 else None


#: the solvers leg's two solves: tag -> HelmholtzSolver keywords
SOLVES = {"cg": dict(method="cg"),
          "cheb": dict(method="chebyshev", fused=True, steps_per_exchange=4)}


def _cg_iteration_probe(res, g, b) -> None:
    """One CG iteration of the solvers leg's solve, profiled
    (:func:`_profiled`): a solve capped at 2 iterations less one capped
    at 1, whose set-up, residual and halo refresh cancel, in copies to
    and from the host and host synchronisations."""
    from dl_esm_inf_tpu_torch.ops import solvers
    counts = []
    for cap in (1, 2):
        s = solvers.HelmholtzSolver(g, LAM, LAM, tol=solver_tol(g.dtype),
                                    maxiter=cap, **SOLVES["cg"])
        counts.append(_profiled(lambda: s.solve(b), g.device, "seam_cg"))
    for k in counts[0]:
        res[f"seam_cg_iteration_{k}"] = np.asarray(counts[1][k]
                                                   - counts[0][k])


def leg_solvers(res, a):
    from dl_esm_inf_tpu_torch.ops import solvers
    g, rhs = solver_case(a.n, a.ndomains, a.device)
    dev, d, spec = g.device, g.decomp, g.halo_spec
    b = dl.Field(g, dl.T_POINTS, init_global_data=rhs)
    for tag, kw in SOLVES.items():
        s = solvers.HelmholtzSolver(g, LAM, LAM, tol=solver_tol(g.dtype),
                                    **kw)
        warm_up(lambda: s.solve(b), dev)
        solvers.helmholtz_cheb_sweep.launches = 0
        (x, info), ms = timed_call(lambda: s.solve(b), dev)
        res[f"hs_{tag}_x"] = layout.unstack_internal(
            d, gather_to_host(x, spec))
        res[f"hs_{tag}_iters"] = np.asarray(info["iterations"])
        res[f"hs_{tag}_rel_res"] = np.asarray(info["rel_res"])
        res[f"hs_{tag}_tol"] = np.asarray(s.tol)
        res[f"hs_{tag}_launches"] = np.asarray(
            solvers.helmholtz_cheb_sweep.launches)
        if ms is not None:
            res[f"hs_{tag}_ms"] = np.asarray(ms)
    if dev.type == "cuda":
        _cg_iteration_probe(res, g, b)


def semi_implicit_model(n: int, ndomains: int, device, open_north: bool):
    """``tests/mp_worker.py``'s semi-implicit run (dt 1, depth 10; open
    north with bc_amp 0.05), at tol 1e-11 in float64 and the default
    tolerance in float32."""
    from dl_esm_inf_tpu_torch.core import kinds
    from dl_esm_inf_tpu_torch.models import semi_implicit as si
    dev = env.resolve_device(device)
    tol = 1e-11 if kinds.wp(dev) == torch.float64 else None
    kw = dict(open_north=True, bc_amp=0.05) if open_north else {}
    m = si.build(n, n, ndomains=ndomains, dt=1.0, depth=10.0, tol=tol,
                 device=dev, **kw)
    if not open_north:
        m.set_initial_eta(si.gaussian_eta(n, n, amp=0.5))
    return m


def leg_semi_implicit(res, a):
    for tag, north in (("si", False), ("sio", True)):
        m = semi_implicit_model(a.n, a.ndomains, a.device, north)
        warm_up(lambda: semi_implicit_model(a.n, a.ndomains, a.device,
                                            north).run(1), m.grid.device)
        info, ms = timed_call(lambda: m.run(5), m.grid.device)
        for k, v in m.gather().items():
            res[f"{tag}_{k}"] = v
        res[f"{tag}_iters"] = np.asarray(info["cg_iterations"])
        res[f"{tag}_tol"] = np.asarray(m.tol)
        if ms is not None:
            res[f"{tag}_ms_per_step"] = np.asarray(ms / 5)


def _tracer_kw(n: int) -> dict:
    """The tracer's configuration (bench.py measure_client_models)."""
    from dl_esm_inf_tpu_torch.models import tracer
    u, v = tracer.streamfunction_velocities(gaussian_eta(n, n, amp=20.0,
                                                         width=0.2))
    return dict(dt=0.2, u=u, v=v, kappa=0.02)


def _nlayer_eta0(n: int, layers: int = 3) -> np.ndarray:
    return np.stack([gaussian_eta(n, n, amp=0.5 * (k + 1)) * (-1) ** k
                     for k in range(layers)])


def client_cases(n: int) -> dict:
    """name -> (model module's name, build keywords, K, initial state
    ``init(model)``): the clients at their main paths' K.  The keywords
    and the initial state suit the JAX package's models too."""
    trk = _tracer_kw(n)

    def tracer0(m):
        m.set_initial_tracer(gaussian_eta(n, n, amp=1.0) + 0.01)
    return {
        "gravity_wave": ("gravity_wave", dict(dt=0.005), 8,
                         lambda m: m.set_initial_eta(
                             gaussian_eta(n, n, amp=0.1))),
        "shallow": ("shallow", {}, 8, lambda m: m.set_initial_eta(
            gaussian_eta(n, n, amp=0.3))),
        "twolayer": ("twolayer", {}, 8, lambda m: m.set_initial(
            gaussian_eta(n, n, amp=0.5), -gaussian_eta(n, n, amp=2.0))),
        "nlayer": ("nlayer", {}, 8,
                   lambda m: m.set_initial(_nlayer_eta0(n))),
        "tracer_vanleer": ("tracer", dict(trk, scheme="vanleer"), 4,
                           tracer0),
        "tracer_upwind": ("tracer", dict(trk, scheme="upwind"), 8,
                          tracer0),
    }


def client_model(name: str, n: int, ndomains: int, device):
    """A client of :func:`client_cases` on its fused sweep at its K, at
    its initial state."""
    mod, kw, K, init = client_cases(n)[name]
    mod = importlib.import_module(f"dl_esm_inf_tpu_torch.models.{mod}")
    m = mod.build(n, n, ndomains=ndomains, fused=True, steps_per_sweep=K,
                  device=device, **kw)
    init(m)
    return m


def leg_clients(res, a):
    for name in client_cases(a.n):
        m = client_model(name, a.n, a.ndomains, a.device)
        dev, kern = m.grid.device, m.sweep_kernel
        _sync(dev)
        kern.launches = 0
        m.run(a.steps)
        _sync(dev)
        res[f"cl_launches_{name}"] = np.asarray(kern.launches)
        for k, v in m.gather().items():
            res[f"cl_{name}_{k}"] = v
        if dev.type == "cuda":
            res[f"cl_us_{name}"] = np.asarray(
                _timed_us(lambda: m.run(a.steps), dev, 3) / a.steps)


def schedule_case(n: int, ndomains: int, device):
    """``tests/mp_worker.py``'s fused schedule: (grid, fa, fb, the east
    shift kernel): fa holds 0 .. n*n - 1, halo 2, rows aligned to 8."""
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.ops import stencils as st
    g = dl.Grid(dl.ARAKAWA_C, WALLED, dl.OFFSET_NE, device=device)
    g.decompose(n, n, ndomains=ndomains, halo_width=2, align_y=8)
    dl.grid_init(g, 1.0, 1.0)
    fa = dl.Field(g, dl.T_POINTS,
                  init_global_data=np.arange(float(n * n)).reshape(n, n))
    fb = dl.Field(g, dl.T_POINTS)

    @km.kernel(args=[km.go_arg(km.GO_WRITE, km.GO_CT),
                     km.go_arg(km.GO_READ, km.GO_CT,
                               km.go_stencil(0, 11, 0))])
    def mp_east(out, x):
        return st.xp(x)
    return g, fa, fb, mp_east


#: the reductions of the schedule leg, by access
REDUCTIONS = ("GO_SUM", "GO_MIN", "GO_MAX")


def reduction_kernel(km, access: str):
    """A kernel returning one reduction of its field over the block."""
    f = {"GO_SUM": torch.sum, "GO_MIN": torch.amin,
         "GO_MAX": torch.amax}[access]

    @km.kernel(args=[km.go_arg(getattr(km, access), km.GO_R_SCALAR),
                     km.go_arg(km.GO_READ, km.GO_CT)],
               name=f"mp_{access[3:].lower()}")
    def red(x):
        return f(x)
    return red


def leg_schedule(res, a):
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    g, fa, fb, east = schedule_case(a.n, a.ndomains, a.device)
    dev = g.device
    sched = km.Schedule((east, fb, fa), (east, fb, fb))
    ss.schedule_sweep.launches = 0
    sched.fused()
    _sync(dev)
    res["sc_launches"] = np.asarray(ss.schedule_sweep.launches)
    res["sc_fused"] = fb.gather_inner_data()
    _, pa, pb, _ = schedule_case(a.n, a.ndomains, a.device)
    km.Schedule((east, pb, pa), (east, pb, pb))()
    res["sc_plain"] = pb.gather_inner_data()
    reds = [reduction_kernel(km, acc) for acc in REDUCTIONS]
    for acc, k in zip(REDUCTIONS, reds):
        res[f"sc_invoke_{acc}"] = np.asarray(km.invoke(k, fa))
    res["sc_schedule_reds"] = np.asarray(km.Schedule(
        *((k, fa) for k in reds))())
    if dev.type == "cuda":
        res["sc_fused_us"] = np.asarray(_timed_us(sched.fused, dev, 10))


def leg_psy(res, a):
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss
    m = NemoLite2DPsy(a.n, a.n, ndomains=a.ndomains, halo_width=8,
                      device=a.device)
    m.set_initial_ssh(gaussian_eta(a.n, a.n, amp=0.2))
    dev = m.grid.device
    ss.schedule_sweep.launches = 0
    m.run(a.steps, fused=True)
    _sync(dev)
    res["psy_launches"] = np.asarray(ss.schedule_sweep.launches)
    for k, v in m.gather().items():
        res[f"psy_{k}"] = v
    if dev.type == "cuda":
        res["psy_us"] = np.asarray(_timed_us(
            lambda: m.run(a.steps, fused=True), dev, 3) / a.steps)


def coupled_model(n: int, ndomains: int, device):
    """The coupled tracer on the open-north flagship (halo 2), van Leer,
    kappa 0.01, from a seeded surface and a tracer blob."""
    from dl_esm_inf_tpu_torch.models import tracer
    fs_ = nl.build(n, n, ndomains=ndomains, open_north=True, halo_width=2,
                   device=device)
    ct = tracer.CoupledTracer(fs_, kappa=0.01, scheme="vanleer")
    rng = np.random.default_rng(0)
    fs_.set_initial_ssh(gaussian_eta(n, n, amp=0.2)
                        + 0.01 * rng.standard_normal((n, n)))
    ct.set_initial_tracer(gaussian_eta(n, n, amp=1.0, width=0.08) + 0.05)
    return ct


def leg_coupled(res, a):
    ct = coupled_model(a.n, a.ndomains, a.device)
    ct.run(a.steps)
    for k, v in ct.gather().items():
        res[f"cp_{k}"] = v
    res["cp_mass"] = np.asarray(ct.mass())
    dev = ct.grid.device
    if dev.type == "cuda":
        res["cp_us"] = np.asarray(_timed_us(lambda: ct.run(a.steps), dev, 1)
                                  / a.steps)


def checkpoint_fields(n: int) -> dict:
    """The checkpoint leg's seeded global arrays: a 2D field and a
    3-level one."""
    rng = np.random.default_rng(17)
    return {"f": rng.standard_normal((n, n)),
            "f3": rng.standard_normal((3, n, n))}


def other_tiling(ndomains: int) -> int:
    """A tiling other than ``ndomains`` that the same ranks can hold."""
    return 4 if ndomains != 4 else 8


def leg_checkpoint(res, a):
    from dl_esm_inf_tpu_torch.utils import checkpoint
    path = a.out + ".ckpt.npz"
    arrays = checkpoint_fields(a.n)
    g = _grid(WALLED, a.n, a.n, a.ndomains, a.device)
    fields = {"f": dl.Field(g, dl.T_POINTS, init_global_data=arrays["f"]),
              "f3": dl.Field(g, dl.T_POINTS, init_global_data=arrays["f3"],
                             levels=3)}
    _, ms = timed_call(lambda: checkpoint.save_fields(path, fields, step=7),
                       g.device)
    g2 = _grid(WALLED, a.n, a.n, other_tiling(a.ndomains), a.device)
    back = {"f": dl.Field(g2, dl.T_POINTS),
            "f3": dl.Field(g2, dl.T_POINTS, levels=3)}
    meta = checkpoint.load_fields(path, back)
    res["ck_step"] = np.asarray(meta["step"])
    for k, f in back.items():
        res[f"ck_{k}"] = f.gather_inner_data()
    res["ck_path"] = np.asarray(path)
    if ms is not None:
        res["ck_save_ms"] = np.asarray(ms)


#: the tiles leg's tiles a rank
TILES_PER_RANK = 4


def leg_tiles(res, a):
    nd = TILES_PER_RANK * env.get_num_ranks()
    m = client_model("gravity_wave", a.n, nd, a.device)
    dev, kern, spec = m.grid.device, m.sweep_kernel, m.grid.halo_spec
    res["tl_layout"] = np.asarray(f"{spec.ranks_y}x{spec.ranks_x} ranks of "
                                  f"{spec.repy}x{spec.repx} tiles")
    _sync(dev)
    kern.launches = 0
    m.run(a.steps)
    _sync(dev)
    res["tl_gw_launches"] = np.asarray(kern.launches)
    for k, v in m.gather().items():
        res[f"tl_gw_{k}"] = v
    if dev.type == "cuda":
        res["tl_gw_us"] = np.asarray(
            _timed_us(lambda: m.run(a.steps), dev, 3) / a.steps)
    from dl_esm_inf_tpu_torch.ops import solvers
    g, rhs = solver_case(a.n, nd, a.device)
    b = dl.Field(g, dl.T_POINTS, init_global_data=rhs)
    s = solvers.HelmholtzSolver(g, LAM, LAM, tol=solver_tol(g.dtype),
                                **SOLVES["cg"])
    warm_up(lambda: s.solve(b), dev)
    (x, info), ms = timed_call(lambda: s.solve(b), dev)
    res["tl_cg_x"] = layout.unstack_internal(g.decomp,
                                             gather_to_host(x, g.halo_spec))
    res["tl_cg_iters"] = np.asarray(info["iterations"])
    res["tl_cg_rel_res"] = np.asarray(info["rel_res"])
    if ms is not None:
        res["tl_cg_ms"] = np.asarray(ms)


# --- the ensemble, the adjoint and nesting across ranks ----------------------

def _host_ms(fn, dev, warm=None):
    """``(fn(), ms)``: one call after a barrier on the host clock, the
    device synchronised before and after (a call that holds collectives
    and host work: the ETKF's eigh, the adjoint's transfers).  ``warm``,
    a call of the same work whose result is dropped, runs first: the
    first call's set-up (library handles, kernels loaded on first use)
    stays out of the time."""
    if warm is not None:
        warm()
    env.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def obs_slice(text: str) -> slice:
    """``START:STOP:STEP`` as a slice (the LETKF's observed rows and
    columns)."""
    return slice(*(int(v) for v in text.split(":")))


def letkf_mask(n: int, obs: str) -> np.ndarray:
    """The LETKF's observation mask: the rows and columns of ``obs``."""
    mask = np.zeros((n, n))
    sl = obs_slice(obs)
    mask[sl, sl] = 1.0
    return mask


def ensemble_members(n: int, members: int) -> np.ndarray:
    """tests/mp_worker.py's members: the bump plus seeded noise."""
    rng = np.random.default_rng(5)
    base = gaussian_eta(n, n, amp=0.3)
    return np.stack([base + 0.1 * rng.standard_normal((n, n))
                     for _ in range(members)])


def ensemble_run(n: int, ndomains: int, device, members: int = 4,
                 obs: str = "3:21:3", radius: float = 4.0,
                 etkf_obs: str | None = None,
                 save: str | None = None) -> dict:
    """tests/mp_worker.py:162-189's ensemble case: gravity-wave members
    (dt 0.05, depth 10), 4 steps, a global ETKF analysis of the bump
    (sigma 0.02; on every point, or the ``etkf_obs`` rows and columns),
    2 steps, a localized one (the ``obs`` rows and columns, radius
    ``radius``), 2 steps; every gathered state, each analysis's
    diagnostics and host ms; ``save``: the ensemble's checkpoint at the
    end (rank 0 writes).  Collective."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models.enkf import ETKF
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    ens = Ensemble(gwm.build(n, n, ndomains=ndomains, dt=0.05, depth=10.0,
                             device=device), members)
    dev = ens.grid.device
    ens.set_member_states(0, ensemble_members(n, members))
    res = {}
    ens.run(4)
    res.update({f"ef_{k}": v for k, v in ens.gather_all().items()})
    for tag, kw, y, mask in (
            ("ek", {}, gaussian_eta(n, n, amp=0.35),
             None if etkf_obs is None else letkf_mask(n, etkf_obs)),
            ("lk", dict(localization_radius=radius),
             gaussian_eta(n, n, amp=0.3), letkf_mask(n, obs))):
        filt = ETKF(ens, sigma=0.02, **kw)
        forecast = ens.states

        def warm():
            filt.analysis(y, obs_mask=mask)
            ens.states = forecast
        diag, ms = _host_ms(lambda: filt.analysis(y, obs_mask=mask), dev,
                            warm)
        res[f"{tag}_diag"] = np.asarray([diag[k] for k in sorted(diag)])
        res[f"{tag}_ms"] = np.asarray(ms)
        res.update({f"{tag}_an_{k}": v
                    for k, v in ens.gather_all().items()})
        ens.run(2)
        res.update({f"{tag}_{k}": v for k, v in ens.gather_all().items()})
    if save is not None:
        ens.save(save)
    return res


def leg_ensemble(res, a):
    path = a.out + ".ens.npz"
    res.update(ensemble_run(a.ens_n, a.ndomains, a.device, a.members,
                            a.letkf_obs, a.letkf_radius, a.etkf_obs,
                            save=path))
    res["ens_path"] = np.asarray(path)


def smooth_noise(rng, n: int, ncut: int = 3) -> np.ndarray:
    """A seeded smooth field of largest |value| 1 (the Fourier modes up
    to ``ncut``; tests/test_torch_assimilation.py's)."""
    z = np.fft.rfft2(rng.standard_normal((n, n)))
    ky = np.abs(np.fft.fftfreq(n) * n)[:, None]
    kx = (np.fft.rfftfreq(n) * n)[None, :]
    f = np.fft.irfft2(np.where((ky <= ncut) & (kx <= ncut), z, 0), s=(n, n))
    return f / np.abs(f).max()


def _coupled(M, n, nd, kw):
    """tests/test_torch_assimilation.py's coupled tracer: the open-north
    flagship (halo 2) from a seeded surface, kappa 0.01."""
    fs_ = M.nl.build(n, n, ndomains=nd, open_north=True, halo_width=2, **kw)
    fs_.set_initial_ssh(gaussian_eta(n, n, amp=0.2)
                        + 0.05 * smooth_noise(np.random.default_rng(21), n))
    return M.tr.CoupledTracer(fs_, kappa=0.01)


def adjoint_cases(n: int, steps: int, f64: bool = True) -> dict:
    """name -> ``(build(M, ndomains, kw), observed key, observation
    steps, the truth's setter, the truth's start, the first guess, the
    observed state index)``: tests/test_torch_assimilation.py's
    configurations of the flagship (observed at steps/2 and steps), the
    semi-implicit model (differentiable=True; tol 1e-12 at float64) and
    the coupled tracer at ``n``^2.  ``M`` holds the package's modules
    ``nl``, ``si`` and ``tr``: the port's, or the JAX package's."""
    tol = dict(tol=1e-12) if f64 else {}
    return {
        "flagship": (
            lambda M, nd, kw: M.nl.build(n, n, ndomains=nd, open_north=True,
                                         **kw),
            "sshn", [steps // 2, steps], "set_initial_ssh",
            gaussian_eta(n, n, amp=0.2)
            + 0.05 * smooth_noise(np.random.default_rng(20), n),
            0.05 * smooth_noise(np.random.default_rng(30), n), 0),
        "semi_implicit": (
            lambda M, nd, kw: M.si.build(n, n, ndomains=nd, dt=1.0,
                                         depth=10.0, differentiable=True,
                                         **tol, **kw),
            "eta", [2, 4], "set_initial_eta", gaussian_eta(n, n, amp=0.5),
            0.1 * smooth_noise(np.random.default_rng(30), n), 0),
        "coupled": (
            lambda M, nd, kw: _coupled(M, n, nd, kw),
            "c", [5, 10], "set_initial_tracer",
            0.8 * smooth_noise(np.random.default_rng(23), n) + 1.0,
            0.5 * smooth_noise(np.random.default_rng(30), n) + 1.0, 3),
    }


def port_modules():
    """The port's model modules under the names of :func:`adjoint_cases`."""
    from types import SimpleNamespace

    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models import semi_implicit as si
    from dl_esm_inf_tpu_torch.models import tracer as tr
    return SimpleNamespace(nl=nl, si=si, tr=tr, gw=gwm)


def observe(m, steps, key: str, setter: str, x0) -> dict:
    """Step -> the gathered ``key`` of a truth run of ``m`` from ``x0``."""
    getattr(m, setter)(x0)
    obs, done = {}, 0
    for t in sorted(steps):
        m.run(t - done)
        done = t
        obs[t] = m.gather()[key]
    return obs


def adjoint_run(name: str, n: int, steps: int, ndomains: int, device,
                remat=None) -> dict:
    """One case of :func:`adjoint_cases`: the truth's observations, the
    cost and its gradient (internal points) at the first guess, and the
    host ms of the cost and gradient.  Collective."""
    from dl_esm_inf_tpu_torch.core import kinds
    from dl_esm_inf_tpu_torch.models.assimilation import make_cost_fn
    f64 = kinds.wp(env.resolve_device(device)) == torch.float64
    build, key, steps_, setter, x_true, guess, index = adjoint_cases(
        n, steps, f64)[name]
    M, kw = port_modules(), dict(device=device)
    obs = observe(build(M, ndomains, kw), steps_, key, setter, x_true)
    m = build(M, ndomains, kw)
    cost, pack, _ = make_cost_fn(m, obs, obs_state_index=index,
                                 remat_chunk=remat)
    x = pack(guess).requires_grad_(True)

    def value_and_grad():
        c = cost(x)
        return c.detach(), torch.autograd.grad(c, x)[0]
    (c, g), ms = _host_ms(value_and_grad, m.grid.device, value_and_grad)
    out = {f"adj_{name}_obs_{t}": v for t, v in obs.items()}
    out[f"adj_{name}_cost"] = np.asarray(float(c))
    out[f"adj_{name}_grad"] = layout.unstack_internal(
        m.grid.decomp, gather_to_host(g, m.grid.halo_spec))
    out[f"adj_{name}_ms"] = np.asarray(ms)
    return out


def optimiser_obs(n: int) -> dict:
    """The optimiser cases' observations: a gravity-wave truth (dt 0.05,
    depth 10) from the bump, at steps 6 and 12, in one process on the
    CPU at float64, as every run that is compared with them sees them."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    return observe(gwm.build(n, n, dt=0.05, depth=10.0, device="cpu",
                             dtype=torch.float64), (6, 12), "eta",
                   "set_initial_eta", gaussian_eta(n, n, amp=0.5))


#: the optimiser cases: tag -> assimilate's keywords (5 iterations)
OPTIMISERS = {"adam": dict(optimizer="adam", learning_rate=0.1),
              "lbfgs": dict(optimizer="lbfgs"),
              "hybrid": dict(optimizer="lbfgs", smooth_scale=2.0,
                             background_weight=1e-5)}
OPT_ITERS = 5


def hybrid_ensemble(model, members: int = 4):
    """The hybrid case's ensemble: the bump plus seeded smooth
    perturbations (tests/test_torch_assimilation.py's hybrid test)."""
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    n = model.grid.decomp.global_nx
    rng = np.random.default_rng(13)
    perts = np.stack([0.2 * smooth_noise(rng, n) for _ in range(members)])
    ens = Ensemble(model, members)
    ens.set_member_states(0, gaussian_eta(n, n, amp=0.3) + perts)
    return ens


def optimiser_run(tag: str, n: int, ndomains: int, device) -> dict:
    """``assimilate`` of a gravity wave at ``n``^2 for OPT_ITERS
    iterations with the optimiser of ``tag`` (the hybrid: L-BFGS over a
    smooth control and the span of a 4-member ensemble, observations at
    1 point in 16); the cost history, the result and its host ms."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models.assimilation import assimilate
    obs = optimiser_obs(n)

    def model():
        return gwm.build(n, n, ndomains=ndomains, dt=0.05, depth=10.0,
                         device=device)
    kw = dict(OPTIMISERS[tag])
    if tag == "hybrid":
        ow = np.zeros((n, n))
        ow[2::4, 2::4] = 1.0
        kw.update(obs_weight=ow, ensemble=hybrid_ensemble(model()))
    m = model()
    r, ms = _host_ms(lambda: assimilate(m, obs, iters=OPT_ITERS, **kw),
                     m.grid.device)
    out = {f"opt_{tag}_history": np.asarray(r["cost_history"]),
           f"opt_{tag}_eta0": r["eta0"],
           f"opt_{tag}_grad_norm": np.asarray(r["grad_norm"]),
           f"opt_{tag}_ms": np.asarray(ms)}
    if "ensemble_weights" in r:
        out[f"opt_{tag}_weights"] = r["ensemble_weights"]
    return out


def leg_adjoint(res, a):
    for name in a.adjoint_cases.split(","):
        if name in OPTIMISERS:
            res.update(optimiser_run(name, a.adjoint_n, a.ndomains,
                                     a.device))
        else:
            res.update(adjoint_run(name, a.adjoint_n, a.adjoint_steps,
                                   a.ndomains, a.device, a.remat))


#: the nest cases: tests/test_torch_nesting.py's configurations (parent
#: extent, parent dt, steps, and per nest (origin, shape, ratio,
#: two-way, the index of the nest whose child is its parent or None));
#: ``grad`` also differentiates the child's eta energy with respect to
#: the parent's eta
NEST_CASES = {
    "r1": dict(n=48, dt=0.02, steps=30,
               nests=(((12, 12), (24, 24), 1, False, None),)),
    "r2": dict(n=64, dt=0.02, steps=15,
               nests=(((16, 16), (32, 32), 2, True, None),)),
    "set": dict(n=64, dt=0.02, steps=10,
                nests=(((8, 8), (20, 20), 2, True, None),
                       ((36, 32), (20, 24), 3, False, None),
                       ((4, 4), (12, 12), 2, True, 0))),
    "grad": dict(n=32, dt=0.02, steps=3,
                 nests=(((8, 8), (16, 16), 2, True, None),)),
}


def nest_main_case(n: int, window: int, ratio: int, steps: int) -> dict:
    """A two-way nest of ``ratio`` over a centred ``window``^2 at
    ``n``^2 (dt 0.05, as chip_smoke.py's nesting phase)."""
    o = (n - window) // 2
    return dict(n=n, dt=0.05, steps=steps,
                nests=(((o, o), (window, window), ratio, True, None),))


def build_nests(pkg, case: dict, ndomains, device_kw: dict):
    """``(parent, nests, runner)`` of a nest case in ``pkg`` (a namespace
    with ``gw`` and ``nest``: the port's or the JAX package's), every grid
    on ``ndomains`` tiles; ``runner`` is the NestSet of several nests or
    the one nest."""
    n = case["n"]
    parent = pkg.gw.build(n, n, ndomains=ndomains, dt=case["dt"],
                          depth=10.0, **device_kw)
    parent.set_initial_eta(gaussian_eta(n, n, width=0.08))
    nests = []
    for origin, shape, ratio, two_way, inside in case["nests"]:
        host = parent if inside is None else nests[inside].child
        nst = pkg.nest.OneWayNest(host, origin=origin, shape=shape,
                                  ratio=ratio, two_way=two_way,
                                  child_ndomains=ndomains)
        nst.sync_from_parent()
        nests.append(nst)
    runner = pkg.nest.NestSet(nests) if len(nests) > 1 else nests[0]
    return parent, nests, runner


def nest_run(tag: str, case: dict, ndomains: int, device) -> dict:
    """A nest case run ``steps`` nest steps: the gathered parent and
    children (eta, u, v), host ms per nest step; for ``grad`` instead
    the loss and the gradient of the children's eta energy on their
    internal cells (halo cells hold what the layout leaves there) with
    respect to the parent's eta (internal points).  Collective."""
    from types import SimpleNamespace

    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models import nesting
    from dl_esm_inf_tpu_torch.parallel.collectives import psum
    pkg = SimpleNamespace(gw=gwm, nest=nesting)
    parent, nests, runner = build_nests(pkg, case, ndomains,
                                        dict(device=device))
    dev, steps, p = parent.grid.device, case["steps"], parent
    prog = runner.step_program(steps)
    roots = runner.nests if len(nests) > 1 else (runner,)

    def state():
        return ((p.eta.data, p.u.data, p.v.data), nesting._read_tree(roots))
    out = {}
    if tag == "grad":
        inner = [n.child.eta.internal_mask for n in roots]

        def loss(p_eta):
            _, tree = prog(((p_eta, p.u.data, p.v.data), state()[1]))
            return psum(sum(torch.sum(t[0][0] ** 2 * w)
                            for t, w in zip(tree, inner)))

        def value_and_grad():
            x = p.eta.data.clone().requires_grad_(True)
            c = loss(x)
            return c.detach(), torch.autograd.grad(c, x)[0]
        (c, g), ms = _host_ms(value_and_grad, dev, value_and_grad)
        out[f"nest_{tag}_loss"] = np.asarray(float(c))
        out[f"nest_{tag}_grad"] = layout.unstack_internal(
            p.grid.decomp, gather_to_host(g, p.grid.halo_spec))
        out[f"nest_{tag}_ms"] = np.asarray(ms)
        return out
    _, ms = _host_ms(lambda: runner.run(steps), dev, lambda: prog(state()))
    out[f"nest_{tag}_ms_per_step"] = np.asarray(ms / steps)
    for who, model in [("p", parent)] + [(f"c{i}", nst.child)
                                         for i, nst in enumerate(nests)]:
        for k in ("eta", "u", "v"):
            out[f"nest_{tag}_{who}_{k}"] = getattr(model, k).gather_inner_data()
    return out


def nest_refusal(ndomains: int, device) -> str:
    """The ValueError of a child whose 3 tiles the ranks cannot hold
    ('' if none is raised)."""
    from dl_esm_inf_tpu_torch.models import gravity_wave as gwm
    from dl_esm_inf_tpu_torch.models.nesting import OneWayNest
    parent = gwm.build(32, 32, ndomains=ndomains, device=device)
    try:
        OneWayNest(parent, origin=(8, 8), shape=(12, 12), ratio=1,
                   child_ndomains=3)
    except ValueError as e:
        return str(e)
    return ""


def leg_nest(res, a):
    for tag in a.nest_cases.split(","):
        case = (nest_main_case(a.n, a.nest_window, a.nest_ratio,
                               a.nest_steps) if tag == "main"
                else NEST_CASES[tag])
        res.update(nest_run(tag, case, a.ndomains, a.device))
    res["nest_refused"] = np.asarray(nest_refusal(a.ndomains, a.device))


def autograd_probe(grid, seed: int = 0) -> dict:
    """The collectives that autograd crosses, on ``grid``'s blocks of
    seeded whole-layout arrays; the same call in one process gives the
    single-process answers.  Returns host arrays, gathered:

    * ``tx_y``, ``x_tty``: <T x, y> and <x, T^T y> for T the depth-2
      exchange (T^T y by autograd), summed over the ranks; ``tty``;
    * ``psum_grad``: the gradient of psum(sum(x^2 m)) (case 1: 2 x m);
    * ``pb_grad_a``, ``pb_grad_x``: the gradients of psum(sum(a_k x_k))
      with ``a`` held alike by every rank, through pbroadcast (case 2:
      d/da sums every rank's block);
    * ``fb_grad``: the gradient of a feedback-like sum: pbroadcast(psum
      of per-row sums), each rank using the rows it owns;
    * ``transfer_tx_y``, ``transfer_x_tty``: <T x, y> and <x, T^T y> of
      the raw strip transfer around the ring of ranks (random strips,
      walled and wrapped)."""
    from dl_esm_inf_tpu_torch.parallel.collectives import (all_gather,
                                                           pbroadcast, psum)
    spec, dev, dt = grid.halo_spec, grid.device, grid.dtype
    rng = np.random.default_rng(seed)

    def block(lead=()):
        return grid.block_tensor(rng.standard_normal(
            lead + grid.global_array_shape), dtype=dt)

    def dot(u, v):
        return float(psum((u * v).sum()))
    out = {}
    x, y, m = block().requires_grad_(True), block(), block()
    tx = halo_mod.exchange(x, spec, min(2, spec.halo))
    (tty,) = torch.autograd.grad(tx, x, grad_outputs=y)
    out["tx_y"], out["x_tty"] = dot(tx.detach(), y), dot(x.detach(), tty)
    out["tty"] = gather_to_host(tty, spec)
    (g,) = torch.autograd.grad(psum((x ** 2 * m).sum()), x)
    out["psum_grad"] = gather_to_host(g, spec)
    a = torch.as_tensor(rng.standard_normal(3), dtype=dt,
                        device=dev).requires_grad_(True)
    x3 = block((3,)).requires_grad_(True)
    c = psum((pbroadcast(a)[:, None, None] * x3).sum())
    ga, gx = torch.autograd.grad(c, (a, x3))
    out["pb_grad_a"], out["pb_grad_x"] = ga.cpu().numpy(), gather_to_host(
        gx, spec)
    # feedback-like: every rank's partial per-row sums, all-reduced, each
    # rank then weighting the rows of its own block
    rows = (x ** 2 * m).sum(dim=-1)                 # this rank's rows
    whole = torch.zeros(grid.global_array_shape[0], dtype=dt, device=dev)
    iy, _ = spec.rank_coords(env.get_rank())
    ny = spec.array_shape[0]
    part = whole.index_add(0, torch.arange(iy * ny, (iy + 1) * ny,
                                           device=dev), rows)
    tot = pbroadcast(psum(part))
    own = tot[iy * ny:(iy + 1) * ny] * y.sum(dim=-1)
    (g,) = torch.autograd.grad(psum(own.sum()), x)
    out["fb_grad"] = gather_to_host(g, spec)
    # the raw strip transfer around the ring of ranks (across ranks
    # only): every rank sends its up strip to the next rank and its down
    # strip to the previous
    nr, r = env.get_num_ranks(), env.get_rank()
    srng = np.random.default_rng(seed + 1 + r)
    for wrap in ((False, True) if nr > 1 else ()):
        up, down, gf, gl = (torch.as_tensor(srng.standard_normal((3, 5)),
                                            dtype=dt, device=dev)
                            for _ in range(4))
        up.requires_grad_(True)
        down.requires_grad_(True)
        first, last = halo_mod._Transfer.apply(
            up, down, (r + 1) % nr, (r - 1) % nr, wrap or r < nr - 1,
            wrap or r > 0)
        gu, gd = torch.autograd.grad((first, last), (up, down),
                                     grad_outputs=(gf, gl))
        tag = "wrap" if wrap else "walled"
        out[f"transfer_tx_y_{tag}"] = dot(first.detach(), gf) + dot(
            last.detach(), gl)
        out[f"transfer_x_tty_{tag}"] = dot(up.detach(), gu) + dot(
            down.detach(), gd)
    # all_gather: each rank's part, every rank weighting every part by
    # its own seeded weights; the gradient of a part sums those weights
    wts = torch.as_tensor(np.random.default_rng(seed + 100 + r)
                          .standard_normal((nr, 4)), dtype=dt, device=dev)
    part = x.reshape(-1)[:4]
    (g,) = torch.autograd.grad(psum((all_gather(part) * wts).sum()), x)
    want = all_gather(wts.detach()).sum(dim=0)[r]
    out["gather_err"] = float(all_reduce(
        (g.reshape(-1)[:4] - want).abs().max(), dist.ReduceOp.MAX))
    return {k: np.asarray(v) for k, v in out.items()}


#: the autograd probe's grids: (tag, boundary conditions, extent)
PROBE_GRIDS = (("walled", WALLED, 24), ("periodic", PERIODIC, 16))


def probe_grid(bcs, n: int, ndomains: int, device):
    return _grid(bcs, n, n, ndomains, device, halo=2)


def leg_autograd(res, a):
    for tag, bcs, n in PROBE_GRIDS:
        for k, v in autograd_probe(probe_grid(bcs, n, a.ndomains,
                                              a.device)).items():
            res[f"ag_{tag}_{k}"] = v


LEGS = {"core": leg_core, "periodic": leg_periodic,
        "hill_rdma": leg_hill_rdma, "guards": leg_guards,
        "exchange": leg_exchange, "skew": leg_skew,
        "flagship": leg_flagship, "fence": leg_fence,
        "flagship_fused": leg_flagship_fused,
        "fused_alternate": leg_fused_alternate,
        "fused_skew": leg_fused_skew, "overlap": leg_overlap,
        "solvers": leg_solvers, "semi_implicit": leg_semi_implicit,
        "clients": leg_clients, "schedule": leg_schedule, "psy": leg_psy,
        "coupled": leg_coupled, "checkpoint": leg_checkpoint,
        "ensemble": leg_ensemble, "adjoint": leg_adjoint, "nest": leg_nest,
        "autograd": leg_autograd, "tiles": leg_tiles}

#: the legs whose strips cross rank seams (``halo._send_recv``): each runs
#: under every transport of ``--seams``
SEAM_LEGS = ("core", "periodic", "exchange", "flagship", "flagship_fused",
             "overlap", "solvers", "semi_implicit", "clients", "schedule",
             "psy", "coupled", "checkpoint", "ensemble", "adjoint", "nest",
             "autograd", "tiles")


def seam_pairs(r: dict, other: str = "gloo") -> dict:
    """Each result of the first seam transport that ``other`` gave too ->
    whether the two are bitwise equal; times and the seam records
    (transport, batches) left out."""
    out = {}
    for k, v in r.items():
        base = k.removeprefix(f"{other}__")
        if (base == k or base.startswith("seam_")
                or any(t in base for t in ("_us", "_ms"))):
            continue
        out[base] = bool(np.array_equal(r[base], v))
    return out


def run_leg(res, a, leg: str, seams) -> None:
    """Leg ``leg`` under each transport of ``seams`` (None: the gang's
    default), the first one's results under their names, a later one's
    prefixed ``<transport>__``."""
    for i, name in enumerate(seams if leg in SEAM_LEGS else seams[:1]):
        if name is not None:
            env.set_seam_transport(name)
        part = {}
        seam.peer_seams.batches = 0
        t0 = time.perf_counter()
        LEGS[leg](part, a)
        on_card = env.resolve_device(a.device).type == "cuda"
        part[f"seam_transport_{leg}"] = np.asarray(
            (env.seam_transport() or "none") if on_card else "gloo")
        part[f"seam_batches_{leg}"] = np.asarray(seam.peer_seams.batches)
        prefix = f"{name}__" if i else ""
        res.update({prefix + k: v for k, v in part.items()})
        if env.get_rank() == 0:
            print(f"[mp_check] leg {leg} ({part[f'seam_transport_{leg}']} "
                  f"seams) done in {time.perf_counter() - t0:.1f} s",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m dl_esm_inf_tpu_torch.parallel.mp_check",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="rank 0's npz")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--ndomains", type=int, default=None,
                    help="tiles of the small legs (default: one per rank)")
    ap.add_argument("--legs", default="core,periodic")
    ap.add_argument("--n", type=int, default=1024,
                    help="N of the N x N exchange and flagship legs")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--fused-layouts", default="2x1,2x2",
                    help="tile layouts PXxPY of the fused legs")
    ap.add_argument("--fused-k", default="4",
                    help="K values of the fused legs, comma separated")
    ap.add_argument("--fused-shape", default="1024x1024",
                    help="GNXxGNY of the fused legs")
    ap.add_argument("--fused-sweeps", type=int, default=10)
    ap.add_argument("--overlap-shape", default="1024x1024",
                    help="GNXxGNY of the overlap leg")
    ap.add_argument("--overlap-steps", type=int, default=40)
    ap.add_argument("--overlap-depths", default="flat,variable",
                    help="bathymetries of the overlap leg: flat, variable")
    ap.add_argument("--ens-n", type=int, default=24,
                    help="N of the ensemble leg's N x N gravity wave")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--letkf-obs", default="3:21:3",
                    help="START:STOP:STEP of the LETKF's observed rows "
                         "and columns")
    ap.add_argument("--letkf-radius", type=float, default=4.0)
    ap.add_argument("--etkf-obs", default=None,
                    help="START:STOP:STEP of the global ETKF's observed "
                         "rows and columns (default: every point)")
    ap.add_argument("--adjoint-cases",
                    default="flagship,semi_implicit,coupled,adam,lbfgs,"
                            "hybrid")
    ap.add_argument("--adjoint-n", type=int, default=32)
    ap.add_argument("--adjoint-steps", type=int, default=8,
                    help="the flagship case's last observed step")
    ap.add_argument("--remat", type=int, default=None,
                    help="the adjoint cases' remat_chunk")
    ap.add_argument("--nest-cases", default="r1,r2,set,grad",
                    help="nest cases: r1, r2, set, grad, and main (a "
                         "two-way nest at --n)")
    ap.add_argument("--nest-window", type=int, default=256)
    ap.add_argument("--nest-ratio", type=int, default=4)
    ap.add_argument("--nest-steps", type=int, default=5)
    ap.add_argument("--seams", default="",
                    help="seam transports to run the seam legs under, in "
                         "order (peer, gloo; default: the gang's)")
    a = ap.parse_args(argv)
    dl.initialise()
    if a.ndomains is None:
        a.ndomains = env.get_num_ranks()
    rank = env.get_rank()
    res = {"world_size": np.asarray(env.get_num_ranks())}
    # a leg that raises exits this rank nonzero, and the launcher stops
    # the gang: no finalise (its barrier would wait for the dead)
    seams = a.seams.split(",") if a.seams else [None]
    for leg in a.legs.split(","):
        run_leg(res, a, leg, seams)
    if rank == 0:
        np.savez(a.out, **res)
    env.finalise()
    print(f"[{rank}] MP CHECK DONE", flush=True)


if __name__ == "__main__":
    main()
