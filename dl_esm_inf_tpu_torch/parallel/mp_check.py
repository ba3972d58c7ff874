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
* ``guards``: every path that is not ported across ranks must raise
  ``NotImplementedError``; records which did;
* ``exchange``: ``Field.halo_exchange`` at ``--n``^2 (halo 8, depth 1
  and 8, 2D and 3 levels, walled and doubly periodic) under both
  transports, each held bitwise against the plain single-rank exchange
  of the whole stacked array on rank 0's device, with µs per call; the
  rdma kernel's entry (one exchange against its plain version, the
  protocol simulated over the gathered blocks);
* ``skew``: two back-to-back ``remote_dma`` exchanges with the last rank
  delayed 50 ms before the second (counting skew), each held bitwise;
* ``flagship``: the flagship at ``--n``^2, K=4, halo 8, one tile per rank,
  ``--steps`` steps; its gathered fields and µs/step (CUDA events);
* ``fence``: the fence round trip between ranks 0 and 1 (µs).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import dl_esm_inf_tpu_torch as dl
from dl_esm_inf_tpu_torch.models import nemolite2d as nl
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu_torch.ops import fused_step as fs
from dl_esm_inf_tpu_torch.parallel import environment as env
from dl_esm_inf_tpu_torch.parallel import halo as halo_mod
from dl_esm_inf_tpu_torch.parallel import rdma
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
    """Each path not ported across ranks must raise NotImplementedError."""
    from dl_esm_inf_tpu_torch.api import kernel_meta as km
    from dl_esm_inf_tpu_torch.models import (gravity_wave, nlayer,
                                             semi_implicit, shallow, tracer,
                                             twolayer)
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    from dl_esm_inf_tpu_torch.ops import solvers
    from dl_esm_inf_tpu_torch.utils import checkpoint

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
        "kbench": lambda: __import__(
            "dl_esm_inf_tpu_torch.kbench", fromlist=["_model"])._model(
                n, torch.device(dev)),
        "fused_transport": lambda: flag.enable_fast_path(4, "fused"),
        "checkpoint_save": lambda: checkpoint.save_fields(
            "never-written.npz", {"f": fld}),
        "checkpoint_load": lambda: checkpoint.load_fields(
            "never-read.npz", {"f": fld}),
    }
    raised = []
    for name, fn in cases.items():
        try:
            fn()
        except NotImplementedError as e:
            if "ROADMAP" in str(e):
                raised.append(name)
    res["guards_raised"] = np.array(sorted(raised))
    res["guards_all"] = np.array(sorted(cases))


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
    # µs per call of each transport on the walled 2D blocks
    for tag, blk, spec, depth, transport in timed:
        fn = ((lambda: halo_mod.exchange(blk, spec, depth))
              if transport == "ppermute" else
              (lambda: rdma.exchange(blk, spec, depth)))
        res[f"exch_us_{tag}"] = np.asarray(_us_per_call(fn, dev, a.reps))
    # the kernel entry: one 2D walled depth-8 exchange against the plain
    # version, the protocol simulated over every rank's block
    grid = _grid(WALLED, a.n, a.n, nranks, a.device, halo=HALO)
    spec = grid.halo_spec
    f = dl.Field(grid, dl.T_POINTS)
    f.set_data(_whole(spec, (), grid.dtype, seed=99))
    got = rdma.exchange(f.data, spec, HALO)
    blocks = [torch.empty_like(f.data) for _ in range(nranks)]
    dist.all_gather(blocks, f.data)
    plain = rdma.exchange_reference(blocks, spec, HALO)
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
    from dl_esm_inf_tpu_torch.parallel.fence_oracle import pingpong_us
    dist.barrier()
    if rank < 2:
        peer = 1 - rank
        pingpong_us(win, peer, 2, dev)          # warm up
        us = pingpong_us(win, peer, a.rounds, dev)
        if rank == 0:
            res["fence_round_trip_us"] = np.asarray(us)


LEGS = {"core": leg_core, "periodic": leg_periodic,
        "hill_rdma": leg_hill_rdma, "guards": leg_guards,
        "exchange": leg_exchange, "skew": leg_skew,
        "flagship": leg_flagship, "fence": leg_fence}


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
    a = ap.parse_args(argv)
    dl.initialise()
    if a.ndomains is None:
        a.ndomains = env.get_num_ranks()
    rank = env.get_rank()
    res = {"world_size": np.asarray(env.get_num_ranks())}
    # a leg that raises exits this rank nonzero, and the launcher stops
    # the gang: no finalise (its barrier would wait for the dead)
    for leg in a.legs.split(","):
        t0 = time.perf_counter()
        LEGS[leg](res, a)
        if rank == 0:
            print(f"[mp_check] leg {leg} done in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rank == 0:
        np.savez(a.out, **res)
    env.finalise()
    print(f"[{rank}] MP CHECK DONE", flush=True)


if __name__ == "__main__":
    main()
