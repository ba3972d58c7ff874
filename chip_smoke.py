"""GPU smoke run of the PyTorch port's main paths: the NEMOLite2D
flagship, the four sweep-engine client models (gravity wave, shallow,
two-layer, tracer), the elliptic-solver path (Helmholtz solver with the
fused Chebyshev sweep, the semi-implicit model), the N-layer model, the
kernel-metadata layer (invoke, Schedule, the fused schedule sweep
generated as CUDA from each schedule) with the PSy-built flagship, and
the halo-exchange transports (the exchange kernel behind
Field.halo_exchange(transport="remote_dma"), the flagship's
transport="fused") with variable bathymetry on the flagship kernel,
rectangular cells on the flagship kernel, and the kernel-variant
microbench (python -m dl_esm_inf_tpu_torch.kbench) with the flagship's
history file and checkpoint, and the port across ranks: the fence's
oracles and gangs of 2 and 4 ranks on the one card (the launcher, the
exchange between processes through peer memory, the 2-rank flagship, and
the flagship's fused transport across ranks: the exchange between
processes inside the sweep), the differentiable and ensemble paths
(checkpointed adjoints, the adjoint CG, the coupled tracer, ensembles
and 4D-Var), which run plain PyTorch on the card, and the ETKF/LETKF,
grid nesting and the flagship's overlap mode.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the twelve hand-written kernel libraries and the
   seam transport's (csrc/seam_transport.cu: copies and stream memory
   operations, no kernel) from dl_esm_inf_tpu_torch/csrc/ with nvcc, one
   process per source, and
   the schedule sweeps that phase 10 generates (one source per schedule
   structure, dtype and K), all at once (build/torch_kernels/); prints
   each library's registers and spills, and requires that no
   instantiation of the skeleton's kernel (csrc/stencil_sweep.cuh)
   spills and that the Chebyshev sweep's SASS holds no WARPSYNC;
3. flagship kernel vs plain, float64: the fused model on the kernel
   against the same model on the plain PyTorch path, 256^2 and 1024^2,
   K = 1..4, 1 and 4 tiles, 101 steps from a Gaussian bump;
4. flagship kernel vs the independent numpy golden
   (tests/nemolite2d_golden.py), float64, 10 and 1024 steps;
5. the flagship's main path, float32: build(1024, 1024, fused=True,
   steps_per_sweep=4, device="cuda"), run(n) with the launch counter
   reset just before; then the kernel against its plain version on the
   same inputs, and times on the card (CUDA events, after warm-up);
6. for each client model (the tracer with both schemes, with and
   without diffusion, where stated):
   a. kernel vs plain, float64, 256^2, every K the kernel takes, 1 and
      4 tiles, 50 steps; and at spacings 0.7 x 1.3 (build()'s dx, dy
      where it takes them, else its grid initialised with them), float64
      and float32, the main path's K, 1 and 4 tiles, 50 steps, bitwise
      (the plain step on the card multiplies by the reciprocals);
   b. kernel vs the model's numpy golden, float64, at the sizes and
      tolerances of the JAX package's tests, with the launch count;
   c. its main path, float32 1024^2, configured as the reference
      benchmark configures it (bench.py measure_client_models): run(n)
      with the model's launch counter reset just before, finiteness,
      kernel vs plain after the run and for one sweep, and times on the
      card (one sweep as a CUDA graph of its launches, the card's time,
      beside one wrapper call's); the tracer's upwind sweep at K = 8
      beside its van Leer main path, against its plain version and timed
      the same way;
7. the fused Chebyshev sweep: kernel vs plain bitwise at float64 and
   float32 (K = 1..8, 1 and 4 tiles, a land ring with an island, four
   chained sweeps with scalars that change per sweep), and a fused
   solve against the plain Chebyshev solve at an equal iteration
   count; then the main path as bench.py measure_solver configures it
   (1024^2, lam 50, K = 4, float32): converged, launches = niters / K,
   solve times on the kernel and the plain path, one sweep's time on the
   card (CUDA graph) beside the wrapper call's;
8. the semi-implicit model (scripts/solverbench.py's configuration:
   1024^2, dt 0.5, depth 10, CG, float32): ms/step, CG iterations per
   step, mass drift, one Chebyshev step; and a small float64 run on
   the card against the same run on the CPU;
9. the N-layer model: kernel vs plain bitwise at float64 and float32
   (the compiled march, L = 1..8 at K = 1..8; the run-time variant at
   9, 16 and 33 layers (f32, K = 8), 48 and 64 (f32, K = 4), 9 and 16
   (f64, K = 8); spacings that are no powers of two; 1 and 4 tiles), the
   numpy golden at float64, and the main path (1024^2, 3 layers, K = 8,
   float32) with its launch count and times, and one sweep of 5 and 8
   layers (float32 and float64), 33 (float32, K = 8) and 48 (float32,
   K = 4) against its plain version, with its time (sweeps as CUDA
   graphs, beside the wrapper call's time);
10. the fused schedule sweep (a CUDA kernel generated from a kernel
   schedule, each point body hand-written or derived from the torch
   body by ops/point_trace.py): each generated source's plan (passes,
   barriers and calls in place per repeat); with the plain fused tier
   replaced by a raising function on every kernel run, the generated
   kernel against
   the plain fused tier at float64 and float32 on the PSy-built flagship
   (256^2, repeats 1-3 at halo 8, 1 and 4 tiles, 30 steps, through
   fused_program and fused), with its hand-written bodies and with all
   13 derived (bitwise against the plain tier and against the
   hand-written bodies), on seeded generic schedules (shifts E/W/N/S/EE
   plus a scalar, internal or all points, walled and periodic, 1-16
   tiles), a nine-mask schedule (two code planes), a schedule whose slot
   is written under two masks, and a scratch chain at 3 repeats (each
   hand-written and derived), and on levels=N schedules
   (dl_esm_inf_tpu_torch/level_schedules.py: the nlayer-style chain
   mom3, cont3, mom3, cont3, vsum and the broadcast pair
   set_all_levels, relax; derived and with hand-written level bodies;
   levels 3 and 8, 1 and 4 tiles;
   bitwise but for the vertical sum, within TOL_LEVEL_SUM); the PSy
   model on the kernel against the production model at float64 (34x30,
   4 tiles, 30 steps, 1e-10); the main path NemoLite2DPsy(1024,
   1024, halo_width=8) at float32, run(n, fused=True), with hand-written
   and with derived bodies: launches = n, finite, derived equal to
   hand-written, kernel vs plain, and us/step on the kernel path
   (repeats 1, 2, 3), the plain fused tier, the plain schedule, and the
   production flagship kernel at K = 4 beside them, with the copy
   bandwidth of the card measured in the same run; and the levels=N
   main path: the nlayer-style chain at 1024^2, halo 4, through
   fused_program(20) (levels 3 and 8 at float32 on 1 and 2x2 tiles,
   levels 8 at float64), each in the shared-memory form: launches = 20,
   vs the plain fused tier, one light sweep timed (CUDA graph, and the
   wrapper call) against its plain version and its bound, us/step of
   both; the same chain at the fewest levels whose window does not fit a
   CTA's shared memory even on 8-cell tiles (scratch_levels(), computed:
   29 at float64) and at NEMO's 75 levels, float64 on 2x2 tiles, in the
   skeleton's cluster form (the window's rows split over the CTAs of a
   thread-block cluster, each band in its CTA's shared memory, rows of
   another band read through distributed shared memory, a persistent
   grid of clusters): both sweeps in that form and at 29 levels one
   level fewer in the shared form, fused_program(10) launches = 10,
   bitwise against the plain fused tier but for the level sum, one light
   sweep bitwise against its plain version, its card time as a CUDA
   graph, the window's bytes, its cluster, CTAs and threads and its byte
   bound; the skeleton's scratch form (the window in a device buffer, a
   persistent grid) kept launched past the largest cluster: level_ends
   (a read-only levels field folded into a 2D one) then shift (the 2D
   field relaxed towards its east neighbour: a barrier, a staged pass,
   ring 1) at past_cluster_levels() levels (computed: 907 at float64) on
   one 128^2 tile, fused_program(10) launches = 10, bitwise against the
   plain fused tier, one sweep bitwise and timed beside its bound; then
   the skeleton's
   edge shapes: every kernel on csrc/stencil_sweep.cuh (gravity wave,
   shallow, two-layer, tracer upwind and van Leer, N-layer 3 and 9
   layers, Chebyshev, the PSy and levels=3 schedule sweeps) against its
   plain version, one sweep, bitwise on internal points, on a 1000x1030
   grid (rows no multiple of 4 points, sides no multiple of any tile)
   and a 37x45 grid (smaller than one tile) at float32 and each main
   path's K, and on the 1000x1030 grid at float64 and K = 4;
11. both forms of the exchange kernel against the plain exchange and the
   exchange_index gather, bitwise on every cell: 1, 2x1, 1x2, 2x2, 3x2
   and 4x4 tiles, walled, x-, y- and doubly periodic, halo 1, 2 and 8 at
   every depth, float32, float64 and int32, 2D and 3 levels (rows moved
   by 16-byte words and by elements both counted); the functional form on
   every case, the field's exchange on a clone, which takes the ring form
   in place wherever ring_in_place holds and the functional form where
   the depth exceeds the tile extent (the launch counters show which ran;
   the ring form refuses those); then Field.halo_exchange(transport=
   "remote_dma") in place with the plain exchange replaced by a function
   that raises;
12. the flagship kernel with variable bathymetry (a seeded positive
   depth plane) against its plain version, bitwise, float64 and float32,
   K = 1..4, 1 and 4 tiles, 101 steps;
13. the fused transport: the flagship with enable_fast_path(K,
   transport="fused") (halo 8; 1, 2x2, 4x1 and 1x4 tiles; K = 1..4;
   float64 and float32) against the same model with the ppermute
   transport on the kernel, bitwise on internal points, and at float64
   against the plain path (1e-12); one fused sweep on periodic grids
   against the plain exchange followed by the sweep, bitwise everywhere;
14. the transports' main paths at 1024^2, float32: the flagship in 2x2
   tiles at K = 4 with the fused and the ppermute transport (us/step,
   launches = n / K, the plain exchange replaced by a raising function
   throughout, and no arithmetic beside the forcing), the flagship with
   variable bathymetry, the exchange in 1, 2x2 and 4x4 tiles at halo 8,
   depth 1 and 8, 2D and 3 levels through Field.halo_exchange (the ring
   form, in place) and through make_block_exchange (the functional form),
   each with the launch counts zeroed just before it (us per call of
   both forms as a CUDA graph and as one wrapper call, the plain
   exchange, the exchange_index gather as one indexing call, and each
   form's byte bound), both forms again at 4096^2, and the example model
   on the card under both transports;
15. the kernel-variant microbench's variants (csrc/nemolite2d_variants.cu):
   dma and compute kernel vs plain bitwise on every cell (f64 and f32,
   K = 1..4, 1 and 4 tiles, compute at reps 1 and 3), compute(reps=1) vs
   the production kernel bitwise on every cell, compute_fast within
   TOL_FAST per pass on internal points; in each dma kernel's SASS
   (cuobjdump) the staging's 16-byte copies (interior CTAs) and byte loads
   of the code plane (edge CTAs);
16. rectangular cells: the flagship kernel vs the plain path bitwise on
   internal points at dx/dy = 1000/1500 and 1500/1000 (f64 and f32,
   K = 1..4, 1 and 2x2 tiles, flat, variable depth and the fused
   transport);
17. the kbench path at 1024^2 f32: prod, dma, compute and compute_fast at
   K = 1, 2, 4 (us per step by the slope method over CUDA graphs, the
   variants' launch counts reset just before), the split of a production
   step into the DMA floor, the compute floor and the remainder, the three
   variants' kernel entries; the flagship CLI on the card writing a
   history file read back by load_netcdf; save_model / load_model on the
   card, bitwise, and the resumed run equal to the uninterrupted one;
   then one flagship sweep (K = 4) and one dma launch (K = 1) at 4096^2,
   where the block does not fit the L2, each bitwise with its plain
   version and timed beside its bound (and dma beside three torch.add);
18. the fence (csrc/fence_oracle.cu on csrc/rdma_fence.cuh) through
   python -m dl_esm_inf_tpu_torch.parallel.fence_oracle's entry point:
   the positive oracle bitwise (and against its plain version,
   FenceModel), the negative timing out at its 200 ms budget, the
   control completing; the oracle kernel's launches counted (3);
19. gangs of 2 and 4 ranks on the card (dl_esm_inf_tpu_torch.launch
   running dl_esm_inf_tpu_torch.parallel.mp_check): tests/mp_worker.py's
   hill, checksum, round-trip and periodic legs (24x20, 16x16, 8 tiles)
   bitwise against this single process; Field.halo_exchange at 1024^2
   f32, halo 8, depth 1 and 8, 2D and 3 levels, walled and periodic,
   under both transports, each bitwise against the single-process plain
   exchange, with the rdma kernel's launches equal to the remote_dma
   calls; two back-to-back remote_dma calls with the last rank 50 ms
   late, bitwise; the exchange's hand-offs and waits per call (its plain
   version's count: one hand-off, one wait per neighbour), its us per
   call also with each call's wait checked before it returns, and a
   rank's kernel time per call (torch.profiler); the fence
   round trip between 2 ranks, spinning in a kernel and with the wait
   off the SMs (stream memory operations); whether the box has the MPS
   control binary (probed, never started); the flagship at
   1024^2 f32, K=4, halo 8, 2 ranks x 1 tile, 40 steps, bitwise against
   one process with 2 tiles, with us/step of both (CUDA events); the
   flagship with transport="fused" (csrc/nemolite2d_sweep_rdma.cu: the
   exchange between processes inside the sweep) at 1024^2 f32, K=4,
   halo 8, 40 steps on 2 (2x1) and 4 (2x2) ranks, one tile each, bitwise
   against one process with the same tiles, the same sweeps alternating
   with remote_dma exchanges on the same spec and with the last rank
   50 ms late, bitwise, the rdma sweep's launches (one per sweep), one
   sweep against its plain version, and us per sweep and per step beside
   the gloo ppermute transport; then the slice across ranks on a 2-rank
   gang, 2 ranks x 1 tile at 1024^2 f32 (mp_check's solvers,
   semi_implicit, clients, schedule, psy, coupled and checkpoint legs),
   each against one process with 2 tiles: every client at its main
   path's K (tracer van Leer K=4, the others K=8), 40 steps, bitwise,
   with its kernel's launches per rank; the fused schedule of two east
   shifts and its plain run bitwise, invoke's sum, min and max within
   TOL_RED; the PSy flagship on Schedule.fused and the coupled tracer,
   40 steps, bitwise; a Helmholtz solve (lam 50) with CG and with the
   fused Chebyshev sweep at K=4: iterations within 2, each relative
   residual below tol, solutions within 10 x tol of their largest value;
   5 semi-implicit steps (walled; open north) within 10 x tol of the
   state's largest value; a checkpoint saved on the 2 ranks and loaded
   back on them into 4 tiles and here into one, bitwise; gravity wave
   K=8 and the CG solve on 2 ranks x 4 tiles (the layout the remote-DMA
   exchange refuses) against one process on 8 tiles, alike; and for
   each, us per step (ms per solve or save) on 2 ranks beside one
   process.  Every gang of the phase runs each leg that crosses a rank
   seam twice, under the "peer" seam transport (the strips card to card
   through peer-memory windows, parallel/seam.py) and under "gloo"
   (through host memory): the two bitwise equal, each leg's transport
   and the peer transport's batches per leg printed, times under both;
   one strip transfer profiled under each (torch.profiler): the peer one
   with no copy to or from the host and no host synchronisation; the
   collectives move by the same transport (parallel/collectives.py: one
   gather of the ranks' parts, an all-reduce folded in rank order): one
   all_reduce of two values and one all_gather of a nest's band, us per
   call and profiled under each, the peer ones with no copy to or from
   the host and no host synchronisation, and one CG iteration profiled
   under each, whose only copy to the host under peer is the loop's
   stopping test; the times of the paths the collectives serve beside
   PR 23's (PR23_TIMES); the 4-rank gang's exchange on a 2x2 rank grid,
   also on 2x2 tiles a rank;
20. the adjoint and ensembles on the card (plain PyTorch: the kernels
   have no backward, and no TPU kernel lies on this path): (a) the
   flagship at 1024^2 f32 on the plain path, one observation at step
   64, make_cost_fn's cost and autograd gradient with remat_chunk None,
   1 and 8, each bitwise equal to the plain one, with ms per cost +
   gradient and of its forward pass (host clock) and the peak device
   memory above the memory allocated before it (max_memory_allocated
   after reset_peak_memory_stats), remat's peak required below the
   plain one, and one plain cost + gradient under torch.profiler: its
   device operations per step and the device's busy share;
   (b) float64 at 32^2, the card against the CPU within 1e-12 relative,
   cost and gradient of the flagship, the semi-implicit model
   (differentiable=True) and the coupled tracer, and the semi-implicit
   gradient against central differences (1e-6); (c) CoupledTracer at
   1024^2 f32, 100 steps: the flow bitwise equal to a plain flagship run
   on the card, the tracer's mass (summed in float64) within 1e-7
   relative, us/step beside the plain flagship's; (d) Ensemble of 8
   members at 1024^2 f32 for the gravity wave and the flagship, 20
   steps: every member bitwise equal to its own sequential run, us per
   ensemble step beside 8 x a single step, and 5 steps of each under
   torch.profiler (device operations per step, busy share); (e) a
   50-iteration Adam twin
   run of the flagship at 256^2 f32: the cost must fall.  The phase
   prints its seconds;
21. the ETKF and LETKF, nesting and overlap mode on the card (the filter
   and the nests run plain PyTorch, as the JAX package runs them; overlap
   runs the flagship kernel at K=1): (a) one global ETKF analysis of the
   surface of 8 flagship members at 1024^2 f32 (phase 20 (d)'s set-up)
   against a truth run: the innovation falls, ms per analysis; (b) the
   LETKF on 8 gravity-wave members at 1024^2 f32, observations on every
   64th point per axis (256), L = 6: points farther than 2L + 1 from every
   observation unchanged within TOL_F32 of each field's largest value,
   points within L moved, ms per analysis, the batched eigh's ms (CUDA
   events around its calls) and the peak device memory above the memory
   held before; (c) scripts/da_demo.py's configuration at f32 (48^2, M=8,
   4 LETKF cycles with adaptive inflation, then hybrid 4D-EnVar against
   the static transform) with the demo's asserts; (d) float64 at 24^2,
   the card against the CPU within 1e-11: the global ETKF's and the
   LETKF's ensembles after one analysis, a two-way ratio-2 nest after 10
   parent steps; (e) a gravity-wave parent at 1024^2 f32 with a two-way
   ratio-4 child over a 256^2 window, 20 parent steps: finite; a ratio-1
   nest's interior bitwise equal to its parent's window; us per nest step
   beside one parent step plus 4 child steps; (f) overlap mode, the
   flagship at 1024^2 f32, halo 2, one tile, 40 steps, plain and
   fused=True at K=1: bitwise equal to the non-overlapped step on
   internal points, us/step of both, the K=1 sweep's launches (one per
   step) and its kernel entry (its card time as a CUDA graph); (g) the
   same on a 2-rank gang, one tile per rank: bitwise against one process
   with 2 tiles on the non-overlapped step, us/step with and without
   overlap, and one overlapped step's device work in order beside the
   host's exchange call (torch.profiler).  The phase prints its
   seconds, and each part's;
22. the ensemble, the adjoint and nesting across ranks: a 2-rank gang
   (2 ranks x 1 tile, parallel/mp_check.py's ensemble, adjoint and nest
   legs) at 1024^2 f32 against one process on 2 tiles: an ensemble of 8
   gravity-wave members with one global ETKF and one LETKF of the same
   256 observations (L = 6), the forecast before them bitwise, the analyses
   and the forecasts after them within TOL_DA_ANALYSIS; the flagship's
   64-step cost and gradient at remat_chunk=8 within TOL_DA_COST and
   TOL_DA_GRAD; a two-way ratio-4 nest over a 256^2 window, NEST_RANKS_
   STEPS steps, within TOL_DA_NEST; max abs and relative differences
   printed beside each tolerance, host ms per analysis, per cost +
   gradient and per nest step of both runs, with the card's name and
   power limit.  The gang runs its legs under "peer" and "gloo" seams as
   phase 19's do (the analyses' all-reduces and the nest's band
   all-gathers and feedback all-reduces too): the forecast, the cost and
   the gradient bitwise between the two, the analyses and the nest
   within their tolerances (DA_SEAM_TOLERATED), times under both, beside
   PR 23's.  The phase prints its seconds.

Every kernel entry carries its bound: the larger of the bytes it must
move (inputs read once, outputs written once) over the H100's 3.35 TB/s
and the operations of its plain version on the same inputs (counted
per element) over the card's peak rate for the dtype; and library_ms,
the time of one PyTorch call computing the same function, or null where
none does (none does for these multi-plane masked sweeps; for the
exchange it is one advanced-indexing call with the row and column maps
of exchange_index made beforehand; for the dma variant, three torch.add
over its planes; for the exchange between ranks, the gloo ppermute
exchange of the same block, with the ppermute exchange under peer seams
beside it; for the sweep with the exchange between ranks, the gloo
ppermute exchange followed by the sweep kernel, the peer one beside
it).  The fence oracle's bound is its tile's
bytes; what bounds a fence is latency, reported as the round trip.  The
compute variants are bound by the plain step's
element operations per point and step (ops_per_point) times the points,
K and the passes.

The line before the last is the kernel report as JSON; the last line is
the result as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import gc
import inspect
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

import dl_esm_inf_tpu_torch as tdl  # noqa: E402
from dl_esm_inf_tpu_torch.api import kernel_meta as km  # noqa: E402
from dl_esm_inf_tpu_torch.models import example_model as exm  # noqa: E402
from dl_esm_inf_tpu_torch.models import gravity_wave as gw  # noqa: E402
from dl_esm_inf_tpu_torch.models import nemolite2d as nl  # noqa: E402
from dl_esm_inf_tpu_torch.models import nlayer as nlm  # noqa: E402
from dl_esm_inf_tpu_torch.models import semi_implicit as si  # noqa: E402
from dl_esm_inf_tpu_torch.models import shallow as sh  # noqa: E402
from dl_esm_inf_tpu_torch.models import tracer as tr  # noqa: E402
from dl_esm_inf_tpu_torch.models import twolayer as tl  # noqa: E402
from dl_esm_inf_tpu_torch.models.gravity_wave import gaussian_eta  # noqa: E402
from dl_esm_inf_tpu_torch.models.nemolite2d_psy import (  # noqa: E402
    NemoLite2DPsy)
from dl_esm_inf_tpu_torch import level_schedules as sc  # noqa: E402
from dl_esm_inf_tpu_torch.ops import fused_step as fs  # noqa: E402
from dl_esm_inf_tpu_torch.ops import point_trace as pt  # noqa: E402
from dl_esm_inf_tpu_torch.ops import schedule_sweep as ss  # noqa: E402
from dl_esm_inf_tpu_torch.ops import solvers as so  # noqa: E402
from dl_esm_inf_tpu_torch.ops import stencils as st  # noqa: E402
from dl_esm_inf_tpu_torch.launch import launch as launch_gang  # noqa: E402
from dl_esm_inf_tpu_torch.parallel import fence_oracle as fo  # noqa: E402
from dl_esm_inf_tpu_torch.parallel import halo as halo_mod  # noqa: E402
from dl_esm_inf_tpu_torch.parallel import halo_kernel as hk  # noqa: E402
from dl_esm_inf_tpu_torch.parallel import rdma  # noqa: E402
from dl_esm_inf_tpu_torch.parallel import seam  # noqa: E402
from dl_esm_inf_tpu_torch.parallel.halo import (  # noqa: E402
    exchange_multi_fn)
from dl_esm_inf_tpu_torch.ops.stencil_sweep import (  # noqa: E402
    stencil_sweep_reference)
from dl_esm_inf_tpu_torch.sweep_probe import (  # noqa: E402
    _graph_ms as _device_ms)
from dl_esm_inf_tpu_torch.testing import init_field_hill  # noqa: E402
from nemolite2d_golden import golden_run  # noqa: E402

DEV = torch.device("cuda")
#: kernel vs plain, float64: max |diff| of internal points over the
#: field's max |value|.  Both round every operation once in the same
#: order (the kernel is built without FMA contraction).
TOL_F64 = 1e-12
#: kernel vs plain, float32, after the main path's n steps, relative to
#: the field's max |value|.  Measured bitwise equal on an H100; the
#: bound leaves room for ulp-level differences between torch builds.
TOL_F32 = 1e-6
MAIN_N = 402                     # n // 4 sweeps + n % 4 single steps
PARITY_SIZES = (256, 1024)
MAIN_SIZE = 1024
#: NVIDIA's data sheet, H100 SXM:
#: HBM3 bytes/s and the peak rate of non-tensor-core arithmetic by dtype
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}


class _OpCount(TorchDispatchMode):
    """Counts the arithmetic of the PyTorch operations run under it, one
    per output element (a reduction: one per input element); data
    movement (rolls, copies, stacks, casts) counts nothing."""
    ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "where", "sqrt",
             "reciprocal", "clamp", "clamp_min", "clamp_max", "minimum",
             "maximum", "gt", "lt", "ge", "le", "eq", "ne", "abs", "sin",
             "exp", "pow", "bitwise_and", "bitwise_right_shift",
             "__and__", "__rshift__", "cumsum", "sign", "copysign"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ("sum", "amax", "amin"):
            self.ops += max((a.numel() for a in args
                             if isinstance(a, torch.Tensor)), default=0)
        elif name in self.ARITH and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def _count_ops(fn) -> int:
    with _OpCount() as c:
        fn()
    return c.ops


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: int, ops: int, dtype) -> dict:
    """bound_ms / bound_by of a kernel call from the bytes it must move
    and the operations it must do."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


#: the card's name and power limit as nvidia-smi gives them (phase 1),
#: printed beside the numbers of the phases this slice added
SMI = "not read"


def phase_device() -> str:
    global SMI
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    SMI = smi
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return smi


KERNELS = (fs.nemolite2d_sweep, gw.gravity_wave_sweep, sh.shallow_sweep,
           tl.twolayer_sweep, tr.tracer_sweep, so.helmholtz_cheb_sweep,
           nlm.nlayer_sweep, hk.halo_exchange, hk.halo_exchange_ring,
           fs.variant_dma,
           rdma.halo_exchange_rdma, fo.fence_oracle,
           fs.nemolite2d_sweep_rdma, seam.peer_seams)


#: nvcc processes at once in phase 2 (the thirteen libraries start
#: first)
BUILD_WORKERS = 24


def phase_build() -> None:
    """The thirteen libraries and every generated schedule sweep phase 10
    needs, built in parallel (one nvcc per source)."""
    from dl_esm_inf_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    tasks = [k.build for k in KERNELS] + _schedule_builds()
    with ThreadPoolExecutor(min(len(tasks), BUILD_WORKERS)) as pool:
        list(pool.map(lambda task: task(), tasks))
    wall = time.perf_counter() - t0
    built = list(cuda_build._loaded.values())
    for b in built:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", b.log)]
        spill = sum(int(a) + int(c) for a, c in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", b.log))
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", b.log)]
        reg_s = f"{min(regs)}-{max(regs)}" if regs else "?"
        print(f"build: {b.path.name} nvcc {b.seconds:.1f}s; ptxas: "
              f"{len(regs)} kernels, {reg_s} registers, {spill} bytes "
              f"spilled" + (f", {max(smem)} B static smem" if smem and
                            max(smem) else ""), flush=True)
    n_gen = sum(1 for b in built if b.source is not None)
    print(f"build: {len(built)} libraries ({n_gen} generated schedule "
          f"sweeps) in {wall:.1f}s (in parallel)", flush=True)
    # every instantiation of the skeleton's kernel (the client sweeps,
    # the tracer's march, every generated schedule sweep) and of the
    # N-layer march spills nothing but the two sweeps capped by their
    # float planes and dtype, and the Chebyshev march synchronises no
    # warp (its trip count is uniform)
    by_planes = {(4 * NEMO_LEVELS + 1, SCRATCH_DTYPE): NEMO_SPILL_BYTES,
                 (past_cluster_levels() + 1, SCRATCH_DTYPE):
                 PAST_CLUSTER_SPILL_BYTES}
    caps = {ss.schedule_sweep.build(g).path.name:
            by_planes.get((g.n_state + g.n_aux, g.dtype), 0)
            for g in ss.schedule_sweep.generated.values()}
    skel, where = {}, {"tracer": 0, "generated": 0}
    for b in built:
        for name, spill in _ptxas_spills(b.log).items():
            if "sweep_kernel" in name or "nlayer_kernel" in name:
                skel[(b.path.name, name)] = spill
                if b.source is not None:
                    where["generated"] += 1
                elif b.path.name.startswith("libtracer_sweep"):
                    where["tracer"] += 1
    spilled = {n: v for n, v in skel.items() if v > caps.get(n[0], 0)}
    if not skel or spilled or not all(where.values()):
        raise AssertionError(f"skeleton kernels spill: {spilled} "
                             f"(instantiations seen: {where}; caps "
                             f"{by_planes})")
    capped = {n: v for n, v in skel.items() if caps.get(n[0])}
    cheb = _sass_counts(so.helmholtz_cheb_sweep.build().path, "WARPSYNC")
    if not cheb or any(cheb.values()):
        raise AssertionError(f"WARPSYNC in the Chebyshev sweep: {cheb}")
    print(f"build: {len(skel)} instantiations of the skeleton's kernel and "
          f"the N-layer march ({where['tracer']} of the tracer's march, "
          f"{where['generated']} generated), 0 bytes spilled but the "
          f"capped {capped} (caps {by_planes}); {len(cheb)} Chebyshev "
          f"kernels, no WARPSYNC in their SASS", flush=True)


def _ptxas_spills(log: str) -> dict:
    """Spilled bytes (stores + loads) per kernel of a ptxas report."""
    return {name: int(a) + int(b) for name, a, b in re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads", log)}


def _sass_counts(lib: Path, pattern: str) -> dict:
    """Per kernel in the library's SASS (cuobjdump): the instructions
    matching ``pattern``."""
    from dl_esm_inf_tpu_torch.ops.cuda_build import find_nvcc
    tool = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {part.split(None, 1)[0]: len(re.findall(pattern, part))
            for part in sass.split("Function : ")[1:]}


def _rel_diff(ga: dict, gb: dict) -> float:
    return max(float(np.abs(ga[k] - gb[k]).max() / np.abs(ga[k]).max())
               for k in ga)


def _pair(n, ndom, K, dtype, steps):
    """(kernel model, plain model) after ``steps`` from the same start."""
    out = []
    for fused in (True, False):
        m = nl.build(n, n, ndomains=ndom, fused=fused, steps_per_sweep=K,
                     halo_width=2 * K, dtype=dtype, device=DEV)
        m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
        m.run(steps)
        out.append(m)
    return out


def phase_parity_f64() -> float:
    worst = 0.0
    for n in PARITY_SIZES:
        for ndom in (1, 4):
            for K in (1, 2, 3, 4):
                mk, mp = _pair(n, ndom, K, torch.float64, 101)
                d = _rel_diff(mk.gather(), mp.gather())
                if not d <= TOL_F64:
                    raise AssertionError(
                        f"kernel vs plain f64 {n}^2 ndomains={ndom} K={K}: "
                        f"{d:.3e} > {TOL_F64}")
                worst = max(worst, d)
    print(f"parity f64: kernel vs plain, sizes {PARITY_SIZES}, K=1..4, "
          f"ndomains 1 and 4, 101 steps: max rel diff {worst:.3e} "
          f"(tol {TOL_F64})", flush=True)
    return worst


def phase_golden() -> None:
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    report = []
    for steps, ndom, rtol, atol in ((10, 1, 1e-11, 1e-13),
                                    (1024, 1, 1e-8, 1e-10),
                                    (1024, 4, 1e-8, 1e-10)):
        m = nl.build(gnx, gny, ndomains=ndom, fused=True, steps_per_sweep=4,
                     dtype=torch.float64, device=DEV)
        m.set_initial_ssh(ssh0)
        before = fs.nemolite2d_sweep.launches
        m.run(steps)
        if fs.nemolite2d_sweep.launches - before != steps // 4 + steps % 4:
            raise AssertionError("golden run did not go through the kernel")
        want = golden_run(nl.default_tmask(gnx, gny), ssh0, steps, m.p,
                          m.grid.dx, m.grid.dy, 100.0)
        got = m.gather()
        err = 0.0
        for k in ("sshn", "un", "vn"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"{k} {steps} steps")
            err = max(err, float(np.abs(got[k] - want[k]).max()))
        report.append(f"{steps} steps ndomains={ndom} max abs {err:.2e} "
                      f"(rtol {rtol}, atol {atol})")
    print("golden f64 34x30 K=4: " + "; ".join(report), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _run_step_us(m, nsteps: int, reps: int) -> float:
    return 1e3 * _time_ms(lambda: m.run(nsteps), reps) / nsteps


def _run_step_watch(m, nsteps: int, reps: int) -> dict:
    """``_run_step_us`` (one warm-up run, then all ``reps`` runs in one
    CUDA-event window) with what could pause the host inside the window:
    the ms Python's garbage collector took (``run_gc_ms``), the caching
    allocator's retries, each a free of its cache and a cudaMalloc again
    (``run_alloc_retries``), and the segments it took from cudaMalloc
    (``run_cuda_mallocs``).  The allocator may still grow in that first
    window, and a cudaMalloc there can stall the host by tens of ms: the
    first window is kept as ``run_first_us`` and
    ``run_first_cuda_mallocs``, and while a window takes new segments
    the same window is timed again (at most 3 in all, ``run_windows``);
    the other keys are the last window's."""
    def counts():
        st = torch.cuda.memory_stats()
        return (st.get("num_alloc_retries", 0),
                st.get("segment.all.allocated", 0))
    gc_s, started = [0.0], [None]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        elif started[0] is not None:
            gc_s[0] += time.perf_counter() - started[0]
    m.run(nsteps)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    out = {}
    for window in range(1, 4):
        gc_s[0] = 0.0
        before = counts()
        gc.callbacks.append(on_gc)
        try:
            t0.record()
            for _ in range(reps):
                m.run(nsteps)
            t1.record()
            torch.cuda.synchronize()
        finally:
            gc.callbacks.remove(on_gc)
        after = counts()
        out.update(us_per_step=1e3 * t0.elapsed_time(t1) / reps / nsteps,
                   run_gc_ms=1e3 * gc_s[0],
                   run_alloc_retries=after[0] - before[0],
                   run_cuda_mallocs=after[1] - before[1], run_windows=window)
        if window == 1:
            out.update(run_first_us=out["us_per_step"],
                       run_first_cuda_mallocs=out["run_cuda_mallocs"])
        if out["run_cuda_mallocs"] == 0:
            break
    return out


def phase_main() -> dict:
    N, K = MAIN_SIZE, 4
    m = nl.build(N, N, fused=True, steps_per_sweep=K, device=DEV)
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    torch.cuda.synchronize()
    fs.nemolite2d_sweep.launches = 0
    m.run(MAIN_N)
    torch.cuda.synchronize()
    launches = fs.nemolite2d_sweep.launches
    if launches != MAIN_N // K + MAIN_N % K:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times, expected {MAIN_N // K + MAIN_N % K}")
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    for t in state:
        if tuple(t.shape) != m.grid.array_shape or not torch.isfinite(t).all():
            raise AssertionError("main path state is not finite")
    cs = m.checksums()
    print(f"main f32 {N}^2 K={K}: run({MAIN_N}) launches={launches} "
          f"(= {MAIN_N}//{K} + {MAIN_N}%{K}); finite; checksums "
          + " ".join(f"{k}={v:.10E}" for k, v in cs.items()), flush=True)

    # the same run on the plain path
    mp = nl.build(N, N, fused=False, steps_per_sweep=K, device=DEV)
    mp.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    mp.run(MAIN_N)
    d_run = _rel_diff(m.gather(), mp.gather())
    if not d_run <= TOL_F32:
        raise AssertionError(f"kernel vs plain f32 after {MAIN_N} steps: "
                             f"{d_run:.3e} > {TOL_F32}")

    # one sweep of the kernel's wrapper against its plain version, on the
    # main path's state and shapes
    fused = m._make_fused(K)
    forcing = m.forcing_series(m._istep0, K)
    codes = m._mask_codes
    ker = fused(*state, codes, forcing)
    ref = fs.fused_step_reference(*state, codes, forcing, p=m.p,
                                  dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                                  depth=m.depth)
    inner = m.sshn_t.internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max())
                  for a, b in zip(ker, ref))
    scale = max(float(b.abs()[inner].max()) for b in ref)
    if not max_abs <= TOL_F32 * scale:
        raise AssertionError(f"one sweep kernel vs plain f32: {max_abs:.3e}")
    ms = _time_ms(lambda: fused(*state, codes, forcing), 200)
    plain_ms = _time_ms(lambda: fs.fused_step_reference(
        *state, codes, forcing, p=m.p, dx=m.grid.dx, dy=m.grid.dy,
        fcor=m._fcor, depth=m.depth), 20)

    # end-to-end step times of the model (host loop included)
    us_k = _run_step_us(m, 400, 5)
    us_p = _run_step_us(mp, 40, 3)
    print(f"timing f32 {N}^2 K={K}: kernel {us_k:.2f} us/step "
          f"({N * N / us_k:.0f} Mpt/s), plain {us_p:.2f} us/step "
          f"({N * N / us_p:.0f} Mpt/s); one sweep: kernel {ms * 1e3:.2f} us,"
          f" plain {plain_ms * 1e3:.2f} us; kernel vs plain after "
          f"{MAIN_N} steps rel {d_run:.3e}, one sweep max abs "
          f"{max_abs:.3e} (tol {TOL_F32} x max|field|)", flush=True)

    m64, p64 = (nl.build(N, N, fused=f, steps_per_sweep=K,
                         dtype=torch.float64, device=DEV)
                for f in (True, False))
    for mm in (m64, p64):
        mm.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    us_k64 = _run_step_us(m64, 400, 3)
    us_p64 = _run_step_us(p64, 40, 3)
    print(f"timing f64 {N}^2 K={K}: kernel {us_k64:.2f} us/step "
          f"({N * N / us_k64:.0f} Mpt/s), plain {us_p64:.2f} us/step "
          f"({N * N / us_p64:.0f} Mpt/s)", flush=True)
    ops = _count_ops(lambda: fs.fused_step_reference(
        *state, codes, forcing, p=m.p, dx=m.grid.dx, dy=m.grid.dy,
        fcor=m._fcor, depth=m.depth))
    return {"name": "nemolite2d_sweep", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/nemolite2d_sweep.cu",
            "replaces": "dl_esm_inf_tpu/ops/pallas_step.py:33",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms,
            **_bound(_nbytes(*state, codes, *ker), ops, state[0].dtype)}


# --- the sweep-engine client models ---------------------------------------

PARITY_N, PARITY_STEPS = 256, 50


def _tracer_kw(n, scheme):
    """The reference benchmark's tracer configuration: velocities from a
    streamfunction Gaussian (bench.py measure_client_models)."""
    u, v = tr.streamfunction_velocities(gaussian_eta(n, n, amp=20.0,
                                                     width=0.2))
    return dict(dt=0.2, u=u, v=v, kappa=0.02, scheme=scheme)


@dataclass(frozen=True)
class Client:
    """A client model's smoke configuration."""
    name: str            # the kernel's name
    mod: object          # the model module
    main_kw: object      # n -> build kwargs of the main path
    init: object         # (model, n) -> None: the initial state
    K: int               # the main path's steps_per_sweep
    n_main: int          # the main path's steps: n // K sweeps + n % K
    parity: tuple        # ((n -> build kwargs, largest K), ...)
    replaces: str

    @property
    def kernel(self):
        return getattr(self.mod, self.name)


CLIENTS = (
    Client("gravity_wave_sweep", gw, lambda n: dict(dt=0.005),
           lambda m, n: m.set_initial_eta(gaussian_eta(n, n, amp=0.1)),
           8, 404, ((lambda n: dict(dt=0.005), 8),),
           "dl_esm_inf_tpu/models/gravity_wave.py:151"),
    Client("shallow_sweep", sh, lambda n: {},
           lambda m, n: m.set_initial_eta(gaussian_eta(n, n, amp=0.3)),
           8, 404, ((lambda n: {}, 8),),
           "dl_esm_inf_tpu/models/shallow.py:102"),
    # the benchmark leaves the two-layer state at rest; a bump on each
    # interface makes the run do work
    Client("twolayer_sweep", tl, lambda n: {},
           lambda m, n: m.set_initial(gaussian_eta(n, n, amp=0.5),
                                      -gaussian_eta(n, n, amp=2.0)),
           8, 404, ((lambda n: {}, 8),),
           "dl_esm_inf_tpu/models/twolayer.py:125"),
    Client("tracer_sweep", tr, lambda n: _tracer_kw(n, "vanleer"),
           lambda m, n: m.set_initial_tracer(gaussian_eta(n, n, amp=1.0)
                                             + 0.01),
           4, 402, ((lambda n: _tracer_kw(n, "upwind"), 8),
                    (lambda n: _tracer_kw(n, "vanleer"), 4),
                    (lambda n: dict(_tracer_kw(n, "upwind"), kappa=0.0), 8),
                    (lambda n: dict(_tracer_kw(n, "vanleer"), kappa=0.0),
                     4)),
           "dl_esm_inf_tpu/models/tracer.py:191"),
)


#: the spacings of phase 6a's bitwise case: no powers of two
SPACED = (0.7, 1.3)


def _build_spaced(c: Client, kw: dict, n: int, **build_kw):
    """A client at the spacings SPACED: through build() where it takes
    them, else on build()'s grid initialised with them."""
    dx, dy = SPACED
    if "dx" in inspect.signature(c.mod.build).parameters:
        return c.mod.build(n, n, dx=dx, dy=dy, **build_kw, **kw)
    base = c.mod.grid_init
    c.mod.grid_init = lambda g, _x, _y, *a, **k: base(g, dx, dy, *a, **k)
    try:
        return c.mod.build(n, n, **build_kw, **kw)
    finally:
        c.mod.grid_init = base


def phase_client_parity(c: Client) -> None:
    n, steps = PARITY_N, PARITY_STEPS
    worst, cases = 0.0, 0
    for kw_of, kmax in c.parity:
        for ndom in (1, 4):
            for K in range(1, kmax + 1):
                ms = [c.mod.build(n, n, ndomains=ndom, fused=f,
                                  steps_per_sweep=K, dtype=torch.float64,
                                  device=DEV, **kw_of(n))
                      for f in (True, False)]
                for m in ms:
                    c.init(m, n)
                before = c.kernel.launches
                ms[0].run(steps)
                if c.kernel.launches - before != steps // K + steps % K:
                    raise AssertionError(f"{c.name} K={K}: the fused run "
                                         "did not go through the kernel")
                ms[1].run(steps)
                d = _rel_diff(ms[0].gather(), ms[1].gather())
                if not d <= TOL_F64:
                    raise AssertionError(
                        f"{c.name} kernel vs plain f64 {n}^2 ndomains="
                        f"{ndom} K={K}: {d:.3e} > {TOL_F64}")
                worst, cases = max(worst, d), cases + 1
    print(f"{c.name} parity f64: kernel vs plain {n}^2, {cases} cases "
          f"(every K, ndomains 1 and 4), {steps} steps: max rel diff "
          f"{worst:.3e} (tol {TOL_F64})", flush=True)
    cases = 0
    for kw_of, kmax in c.parity:
        for dtype in (torch.float64, torch.float32):
            for ndom in (1, 4):
                K = min(c.K, kmax)
                ms = [_build_spaced(c, kw_of(n), n, ndomains=ndom, fused=f,
                                    steps_per_sweep=K, dtype=dtype,
                                    device=DEV) for f in (True, False)]
                if (ms[0].grid.dx, ms[0].grid.dy) != SPACED:
                    raise AssertionError(f"{c.name}: spacings not taken")
                for m in ms:
                    c.init(m, n)
                before = c.kernel.launches
                ms[0].run(steps)
                if c.kernel.launches - before != steps // K + steps % K:
                    raise AssertionError(f"{c.name} spacings: the fused "
                                         "run did not go through the kernel")
                ms[1].run(steps)
                ga, gb = ms[0].gather(), ms[1].gather()
                for k in gb:
                    d = float(np.abs(ga[k] - gb[k]).max())
                    if d != 0.0 or not np.isfinite(ga[k]).all():
                        raise AssertionError(
                            f"{c.name} kernel vs plain at dx, dy = {SPACED} "
                            f"{dtype} ndomains={ndom} K={K} {k}: max abs "
                            f"{d:.3e}, bitwise required")
                cases += 1
    print(f"{c.name} parity at dx, dy = {SPACED}: kernel vs plain {n}^2, "
          f"{cases} cases (f64 and f32, K={c.K}, ndomains 1 and 4), "
          f"{steps} steps: bitwise", flush=True)


def _rotating(n):
    """tests/test_tracer.py's rotating velocities."""
    x = (np.arange(n) - n / 2 + 0.5) / n
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


def _golden_cases(c: Client):
    """(label, model, nsteps, golden fields, rtol, atol, points) at the
    sizes and tolerances of the JAX package's tests; each model is
    built on the fused path at the kernel's largest K."""
    f64 = dict(dtype=torch.float64, device=DEV, fused=True)
    if c.mod is gw:
        for (nx, ny), ndom, steps, tol in (((48, 40), 1, 100, 1e-12),
                                           ((48, 40), 4, 100, 1e-12),
                                           ((128, 96), 4, 1024, 1e-11)):
            eta0 = gaussian_eta(nx, ny)
            m = gw.build(nx, ny, ndomains=ndom, dt=0.05, depth=10.0,
                         steps_per_sweep=8, **f64)
            m.set_initial_eta(eta0)
            yield (f"{nx}x{ny} ndomains={ndom}", m, steps,
                   lambda s=steps, e=eta0, nx=nx, ny=ny:
                   gw.golden_reference(e, gw.default_tmask(nx, ny), 1.0, 1.0,
                                       0.05, s, depth=10.0), tol, tol, None)
    elif c.mod is sh:
        for ndom in (1, 4):
            eta0 = gaussian_eta(32, 32, amp=0.3)
            m = sh.build(32, 32, ndomains=ndom, dt=0.02, steps_per_sweep=8,
                         **f64)
            m.set_initial_eta(eta0)
            yield (f"32x32 ndomains={ndom}", m, 200,
                   lambda e=eta0: sh.golden_reference(e, 0.02, 200), 1e-11,
                   1e-12, None)
    elif c.mod is tl:
        e1 = gaussian_eta(48, 40, amp=0.5)
        e2 = -gaussian_eta(48, 40, amp=2.0)
        for ndom in (1, 4):
            m = tl.build(48, 40, ndomains=ndom, dt=0.01, steps_per_sweep=8,
                         **f64)
            m.set_initial(e1, e2)
            yield (f"48x40 ndomains={ndom}", m, 100,
                   lambda: tl.golden_reference(e1, e2, tl.default_tmask(
                       48, 40), 1.0, 1.0, 0.01, 100), 1e-12, 1e-12, None)
    else:
        N = 32
        u, v = _rotating(N)
        c0 = gaussian_eta(N, N, amp=1.0, width=0.08) + 0.01
        tmask = gw.default_tmask(N, N)
        tmask[12:15, 18:21] = 0          # an island
        for scheme, K in (("upwind", 8), ("vanleer", 4)):
            for ndom in (1, 8):
                m = tr.build(N, N, ndomains=ndom, dt=0.2, u=u, v=v,
                             kappa=0.02, scheme=scheme, tmask=tmask,
                             steps_per_sweep=K, **f64)
                m.set_initial_tracer(c0)
                yield (f"{scheme} 32x32 ndomains={ndom}", m, 40,
                       lambda s=scheme: {"c": tr.golden_reference(
                           c0, tmask, u, v, dt=0.2, nsteps=40, kappa=0.02,
                           scheme=s)}, 0.0, 1e-12, tmask == 1)


def phase_client_golden(c: Client) -> None:
    report = []
    for label, m, steps, golden, rtol, atol, pts in _golden_cases(c):
        K = m._sweep_K
        before = c.kernel.launches
        m.run(steps)
        if c.kernel.launches - before != steps // K + steps % K:
            raise AssertionError(f"{c.name} golden {label}: launched "
                                 f"{c.kernel.launches - before} times, "
                                 f"expected {steps // K + steps % K}")
        want, got = golden(), m.gather()
        err = 0.0
        for k in want:
            g, w = (got[k], want[k]) if pts is None else (got[k][pts],
                                                         want[k][pts])
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{c.name} {label} {k}")
            err = max(err, float(np.abs(g - w).max()))
        report.append(f"{label} K={K} {steps} steps max abs {err:.2e}")
    print(f"{c.name} golden f64: " + "; ".join(report) + " (rtol/atol of "
          "the JAX package's tests)", flush=True)


def phase_client_main(c: Client) -> dict:
    N, K, n = MAIN_SIZE, c.K, c.n_main
    kern = c.kernel
    m = c.mod.build(N, N, fused=True, steps_per_sweep=K, device=DEV,
                    **c.main_kw(N))
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    c.init(m, N)
    mass0 = m.mass() if c.mod is tr else None
    torch.cuda.synchronize()
    kern.launches = 0
    m.run(n)
    torch.cuda.synchronize()
    launches = kern.launches
    if launches != n // K + n % K:
        raise AssertionError(f"{c.name} main path launched the kernel "
                             f"{launches} times, expected {n // K + n % K}")
    state = tuple(getattr(m, f).data for f in m._fields)
    for t in state:
        if tuple(t.shape) != m.grid.array_shape or not torch.isfinite(t).all():
            raise AssertionError(f"{c.name} main path state is not finite")

    mp = c.mod.build(N, N, fused=False, steps_per_sweep=K, device=DEV,
                     **c.main_kw(N))
    c.init(mp, N)
    mp.run(n)
    d_run = _rel_diff(m.gather(), mp.gather())
    if not d_run <= TOL_F32:
        raise AssertionError(f"{c.name} kernel vs plain f32 after {n} "
                             f"steps: {d_run:.3e} > {TOL_F32}")
    extra = ""
    if c.mod is tr:
        cg = m.gather()["c"][m.grid.global_tmask() == 1]
        drift = abs(m.mass() - mass0) / abs(mass0)
        extra = (f"; mass drift {drift:.2e} (f32), range [{cg.min():.4e}, "
                 f"{cg.max():.4e}]")

    # one sweep of the wrapper against its plain version, on the main
    # path's state and shapes
    sweep = m._make_sweep(K)
    aux = m._sweep_aux
    prep = m._prepare(aux)
    ker = sweep(state, aux)
    ref = stencil_sweep_reference(m._step_math, K, state, prep)
    inner = getattr(m, m._fields[0]).internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max()) for a, b in zip(ker, ref))
    scale = max(float(b.abs()[inner].max()) for b in ref)
    if not max_abs <= TOL_F32 * scale:
        raise AssertionError(f"{c.name} one sweep kernel vs plain f32: "
                             f"{max_abs:.3e}")
    ms = _time_ms(lambda: sweep(state, aux), 200)
    device_ms = _device_ms(lambda: sweep(state, aux), 20)
    plain_ms = _time_ms(lambda: stencil_sweep_reference(
        m._step_math, K, state, prep), 20)
    us_k = _run_step_us(m, 50 * K, 5)
    us_p = _run_step_us(mp, 5 * K, 3)
    print(f"{c.name} main f32 {N}^2 K={K}: run({n}) launches={launches} "
          f"(= {n}//{K} + {n}%{K}); finite; kernel vs plain after {n} "
          f"steps rel {d_run:.3e}, one sweep max abs {max_abs:.3e}{extra}",
          flush=True)
    print(f"{c.name} timing f32 {N}^2 K={K}: run on the kernel path "
          f"{us_k:.2f} us/step ({N * N / us_k:.0f} Mpt/s), on the plain "
          f"path {us_p:.2f} us/step ({N * N / us_p:.0f} Mpt/s); one sweep: "
          f"kernel {device_ms * 1e3:.2f} us on the card (CUDA graph; "
          f"{device_ms * 1e3 / K:.2f} us/step; wrapper call {ms * 1e3:.2f} "
          f"us), plain {plain_ms * 1e3:.2f} us", flush=True)
    ops = _count_ops(lambda: stencil_sweep_reference(m._step_math, K, state,
                                                     prep))
    entry = {"name": c.name, "route": "cuda",
             "source": f"dl_esm_inf_tpu_torch/csrc/{kern.source}",
             "replaces": c.replaces, "launches": launches,
             "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
             **_bound(_nbytes(*state, *aux, *ker), ops, state[0].dtype),
             "device_ms": device_ms}
    if c.mod is tr:
        entry.update(_tracer_upwind(N))
    return entry


def _tracer_upwind(N: int) -> dict:
    """The tracer's upwind sweep at K = 8 on the main path's velocities:
    one sweep against its plain version and its times (CUDA graph and
    wrapper call)."""
    K = 8
    m = tr.build(N, N, fused=True, steps_per_sweep=K, device=DEV,
                 **_tracer_kw(N, "upwind"))
    m.set_initial_tracer(gaussian_eta(N, N, amp=1.0) + 0.01)
    m.run(2 * K)
    state, aux = (m.c.data,), m._sweep_aux
    sweep, prep = m._make_sweep(K), m._prepare(aux)
    ker = sweep(state, aux)
    ref = stencil_sweep_reference(m._step_math, K, state, prep)
    inner = m.c.internal_mask.bool()
    max_abs = float((ker[0] - ref[0]).abs()[inner].max())
    if not max_abs <= TOL_F32 * float(ref[0].abs()[inner].max()):
        raise AssertionError(f"tracer upwind K=8 one sweep kernel vs plain "
                             f"f32: {max_abs:.3e}")
    device_ms = _device_ms(lambda: sweep(state, aux), 20)
    ms = _time_ms(lambda: sweep(state, aux), 200)
    plain_ms = _time_ms(lambda: stencil_sweep_reference(
        m._step_math, K, state, prep), 20)
    print(f"tracer_sweep upwind f32 {N}^2 K={K}: one sweep max abs "
          f"{max_abs:.3e} vs plain; kernel {device_ms * 1e3:.2f} us on the "
          f"card (CUDA graph; {device_ms * 1e3 / K:.2f} us/step; wrapper "
          f"call {ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us",
          flush=True)
    return {"upwind_K8_device_ms": device_ms, "upwind_K8_ms": ms,
            "upwind_K8_plain_ms": plain_ms, "upwind_K8_max_abs_err": max_abs}


# --- the elliptic-solver path ---------------------------------------------

def _solver_grid(n, ndom, K, dtype, island=True):
    """A walled n x n grid on the card; with ``island``, the land block
    of tests/test_solvers.py's fused-sweep test, scaled to n."""
    tmask = gw.default_tmask(n, n)
    if island:
        tmask[n * 5 // 16: n * 15 // 32, n * 25 // 64: n * 5 // 8] = 0
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                 device=DEV)
    g.decompose(n, n, ndomains=ndom, halo_width=K)
    tdl.grid_init(g, 1.0, 1.0, tmask)
    return g, tmask


def _rhs(g, tmask, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(tmask.shape) * (tmask == 1)
    return tdl.Field(g, tdl.T_POINTS, init_global_data=b).data


def _internal_max_abs(g, a, b) -> float:
    inner = g.region_mask(dtype=torch.float64).bool()
    return max(float((x - y).abs()[..., inner].max()) for x, y in zip(a, b))


def phase_cheb_parity() -> None:
    """The kernel against its plain version, four chained sweeps from a
    random (x, r, d) with the solver's recurrence scalars, which differ
    from sweep to sweep: bitwise."""
    n, lam_x, lam_y, sweeps = 128, 6.0, 4.0, 4
    worst, cases = 0.0, 0
    for dtype in (torch.float64, torch.float32):
        for ndom in (1, 4):
            for K in range(1, 9):
                g, tmask = _solver_grid(n, ndom, K, dtype)
                s = so.HelmholtzSolver(g, lam_x, lam_y, method="chebyshev",
                                       steps_per_exchange=K, fused=True)
                sweep = s._make_cheb_sweep(K)
                prep = so.cheb_prepare(s._codes, lam_x, lam_y, dtype)
                exchK = exchange_multi_fn(g.halo_spec, depth=K)
                rng = np.random.default_rng(K + 10 * ndom)
                ker = tuple(torch.from_numpy(rng.standard_normal(
                    g.array_shape)).to(DEV, dtype) for _ in range(3))
                ref = ker
                scal = so.chebyshev_scalars(*s._lam_bounds, sweeps * K)
                before = so.helmholtz_cheb_sweep.launches
                for j in range(sweeps):
                    sc = scal[j * K:(j + 1) * K]
                    ker = sweep(*exchK(ker), sc)
                    ref = stencil_sweep_reference(
                        so.cheb_step, K, exchK(ref), prep,
                        scalars=[tuple(r) for r in sc])
                torch.cuda.synchronize()
                if so.helmholtz_cheb_sweep.launches - before != sweeps:
                    raise AssertionError("cheb parity did not go through "
                                         "the kernel")
                d = _internal_max_abs(g, ker, ref)
                if d != 0.0 or not all(torch.isfinite(t).all() for t in ker):
                    raise AssertionError(
                        f"cheb kernel vs plain {dtype} ndomains={ndom} "
                        f"K={K}: max abs {d:.3e}, expected bitwise")
                worst, cases = max(worst, d), cases + 1
    print(f"helmholtz_cheb_sweep parity: kernel vs plain {n}^2 land ring "
          f"+ island, {cases} cases (f64 and f32, K=1..8, ndomains 1 and "
          f"4, {sweeps} sweeps, scalars per sweep): max abs {worst:.3e} "
          f"(bitwise required)", flush=True)
    # a fused solve against the plain Chebyshev solve, equal iterations
    for dtype in (torch.float64, torch.float32):
        g, tmask = _solver_grid(n, 4, 4, dtype)
        b = _rhs(g, tmask, 5)
        xs, infos = [], []
        for fused in (True, False):
            s = so.HelmholtzSolver(g, lam_x, lam_y, method="chebyshev",
                                   steps_per_exchange=4, fused=fused,
                                   maxiter=64, tol=1e-30)
            x, info = s.solve(b)
            xs.append(x)
            infos.append(info)
        if [i["iterations"] for i in infos] != [64, 64]:
            raise AssertionError(f"iteration counts {infos}")
        d = _internal_max_abs(g, (xs[0],), (xs[1],))
        print(f"helmholtz_cheb_sweep solve {dtype}: fused vs plain "
              f"Chebyshev, {n}^2, 4 tiles, K=4, 64 iterations each: max "
              f"abs diff {d:.3e}; rel_res {infos[0]['rel_res']:.3e} vs "
              f"{infos[1]['rel_res']:.3e}", flush=True)


def phase_cheb_main() -> dict:
    """bench.py measure_solver's configuration on the card."""
    N, K, lam = MAIN_SIZE, 4, 50.0
    g, tmask = _solver_grid(N, 1, K, None, island=False)
    if g.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{g.dtype}")
    b = _rhs(g, tmask, 0)
    s = so.HelmholtzSolver(g, lam, lam, method="chebyshev",
                           steps_per_exchange=K, fused=True)
    sp = so.HelmholtzSolver(g, lam, lam, method="chebyshev",
                            steps_per_exchange=K)
    kern = so.helmholtz_cheb_sweep
    torch.cuda.synchronize()
    kern.launches = 0
    x, info = s.solve(b)
    torch.cuda.synchronize()
    launches = kern.launches
    niters = s.niters()
    if not info["converged"]:
        raise AssertionError(f"fused Chebyshev did not converge: {info}")
    if launches != niters // K or info["iterations"] != niters:
        raise AssertionError(f"fused solve launched {launches} sweeps for "
                             f"{info['iterations']} iterations, K={K}")
    if tuple(x.shape) != g.array_shape or not torch.isfinite(x).all():
        raise AssertionError("fused solve: solution is not finite")
    xp_, infop = sp.solve(b)
    d_solve = _internal_max_abs(g, (x,), (xp_,))
    if not infop["converged"] or not d_solve <= TOL_F32 * float(
            xp_.abs().max()):
        raise AssertionError(f"fused vs plain solve {d_solve:.3e}, {infop}")

    # one sweep of the wrapper against its plain version at the main
    # path's shapes, on a mid-solve state
    sweep = s._make_cheb_sweep(K)
    prep = so.cheb_prepare(s._codes, lam, lam, g.dtype)
    sc = so.chebyshev_scalars(*s._lam_bounds, niters)[:K]
    state = (x, b - x, 0.01 * b)
    ker = sweep(*state, sc)
    ref = stencil_sweep_reference(so.cheb_step, K, state, prep,
                                  scalars=[tuple(r) for r in sc])
    max_abs = _internal_max_abs(g, ker, ref)
    if max_abs != 0.0:
        raise AssertionError(f"cheb one sweep kernel vs plain f32: "
                             f"{max_abs:.3e}, expected bitwise")
    ms = _time_ms(lambda: sweep(*state, sc), 200)
    device_ms = _device_ms(lambda: sweep(*state, sc), 20)
    plain_ms = _time_ms(lambda: stencil_sweep_reference(
        so.cheb_step, K, state, prep, scalars=[tuple(r) for r in sc]), 20)
    reps = [0]

    def solve_varied(solver):
        reps[0] += 1
        solver.solve(b * (1.0 + 1e-6 * reps[0]))
    solve_ms = _time_ms(lambda: solve_varied(s), 10)
    solve_plain_ms = _time_ms(lambda: solve_varied(sp), 3)
    print(f"helmholtz_cheb_sweep main f32 {N}^2 lam={lam} K={K}: "
          f"iterations {info['iterations']}, rel_res {info['rel_res']:.3e} "
          f"(tol {s.tol:.3e}), launches {launches} (= {niters}/{K}); fused "
          f"vs plain solve max abs {d_solve:.3e}", flush=True)
    print(f"helmholtz_cheb_sweep timing f32 {N}^2 K={K}: solve on the "
          f"kernel path {solve_ms:.3f} ms, on the plain path "
          f"{solve_plain_ms:.3f} ms (varied rhs); one sweep: kernel "
          f"{device_ms * 1e3:.2f} us on the card (CUDA graph; "
          f"{device_ms * 1e3 / K:.2f} us/iteration; wrapper call "
          f"{ms * 1e3:.2f} us), plain "
          f"{plain_ms * 1e3:.2f} us", flush=True)
    ops = _count_ops(lambda: stencil_sweep_reference(
        so.cheb_step, K, state, prep, scalars=[tuple(r) for r in sc]))
    return {"name": "helmholtz_cheb_sweep", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/helmholtz_cheb_sweep.cu",
            "replaces": "dl_esm_inf_tpu/ops/solvers.py:553",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms,
            **_bound(_nbytes(*state, s._codes, *ker), ops, g.dtype),
            "device_ms": device_ms, "solve_ms": solve_ms,
            "solve_plain_ms": solve_plain_ms,
            "solve_iterations": info["iterations"]}


def _semi_step_ms(m, nsteps: int) -> tuple[float, dict]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = m.run(nsteps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / nsteps, info


def phase_semi_implicit() -> None:
    """scripts/solverbench.py's semi-implicit configuration on the card,
    and a small float64 run on the card against the CPU."""
    N = MAIN_SIZE
    m = si.build(N, N, dt=0.5, depth=10.0, device=DEV)
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    m.set_initial_eta(gaussian_eta(N, N, amp=0.5))
    m.run(1)
    m0 = m.mass()
    ms_step, info = _semi_step_ms(m, 5)
    drift = abs(m.mass() - m0) / abs(m0)
    for f in (m.eta, m.u, m.v):
        if not torch.isfinite(f.data).all():
            raise AssertionError("semi-implicit state is not finite")
    if not drift < 1e-3:
        raise AssertionError(f"semi-implicit mass drift {drift:.3e}")
    mc = si.build(N, N, dt=0.5, depth=10.0, solver="chebyshev", device=DEV)
    mc.set_initial_eta(gaussian_eta(N, N, amp=0.5))
    mc.run(1)
    ms_cheb, info_c = _semi_step_ms(mc, 1)
    print(f"semi_implicit main f32 {N}^2 dt=0.5 depth=10: CG "
          f"{ms_step:.2f} ms/step (host clock, 5 steps), "
          f"{info['cg_iterations_per_step']:.1f} CG iterations/step, mass "
          f"drift {drift:.2e}; Chebyshev {ms_cheb:.2f} ms/step, "
          f"{info_c['cg_iterations_per_step']:.0f} iterations/step",
          flush=True)
    # the card against the CPU, float64, CG and Chebyshev, open north
    n, steps, worst = 48, 10, 0.0
    for kw in (dict(), dict(solver="chebyshev"),
               dict(open_north=True, bc_amp=0.05, bc_omega=0.2)):
        got = []
        for dev in (DEV, "cpu"):
            mm = si.build(n, n, ndomains=4, dt=1.0, depth=10.0, tol=1e-12,
                          dtype=torch.float64, device=dev, **kw)
            mm.set_initial_eta(gaussian_eta(n, n, amp=0.6))
            mm.run(steps)
            got.append(mm.gather())
        d = _rel_diff(got[0], got[1])
        if not d <= 1e-9:
            raise AssertionError(f"semi-implicit card vs CPU {kw}: {d:.3e}")
        worst = max(worst, d)
    print(f"semi_implicit f64 {n}^2, 4 tiles, {steps} steps (CG, Chebyshev,"
          f" open north): card vs CPU max rel diff {worst:.3e} (tol 1e-9)",
          flush=True)


# --- the N-layer model -----------------------------------------------------

def _nlayer_eta0(n, layers):
    return np.stack([gaussian_eta(n, n, amp=0.5 * (k + 1)) * (-1) ** k
                     for k in range(layers)])


#: the N-layer parity cases: the compiled layer counts at every K, and
#: beyond them (layers, dtype, K) on the run-time variant, up to what one
#: window holds (float32: 33 at K=8, 75 at K=4; float64: 16 at K=8)
NLAYER_LAYERS = tuple(range(1, 9))
NLAYER_EDGE = ((9, torch.float32, 8), (16, torch.float32, 8),
               (33, torch.float32, 8), (48, torch.float32, 4),
               (64, torch.float32, 4), (9, torch.float64, 8),
               (16, torch.float64, 8))
#: spacings that are no powers of two: (layers, dtype) at K=4, dx 0.7,
#: dy 1.3 (the plain path multiplies by the reciprocals, as the kernel)
NLAYER_SPACINGS = ((3, torch.float64), (3, torch.float32),
                   (9, torch.float32))


def _nlayer_cases():
    for dtype in (torch.float64, torch.float32):
        for L in NLAYER_LAYERS:
            for K in range(1, 9):
                yield dtype, L, K, {}
    for L, dtype, K in NLAYER_EDGE:
        yield dtype, L, K, {}
    for L, dtype in NLAYER_SPACINGS:
        yield dtype, L, 4, dict(dx=0.7, dy=1.3)


def phase_nlayer_parity() -> None:
    n, steps = 64, 19
    worst, cases, tiles = 0.0, 0, set()
    for (dtype, L, K, kw), ndom in itertools.product(_nlayer_cases(),
                                                     (1, 4)):
        tiles.add(nlm.kernel_tile(L, dtype, K))
        ms = [nlm.build(n, n, ndomains=ndom, dt=0.01, layers=L, fused=f,
                        steps_per_sweep=K, dtype=dtype, device=DEV, **kw)
              for f in (True, False)]
        for m in ms:
            m.set_initial(_nlayer_eta0(n, L))
        before = nlm.nlayer_sweep.launches
        ms[0].run(steps)
        if nlm.nlayer_sweep.launches - before != steps // K + steps % K:
            raise AssertionError(f"nlayer L={L} K={K}: the fused run did "
                                 "not go through the kernel")
        ms[1].run(steps)
        ga, gb = ms[0].gather(), ms[1].gather()
        d = max(float(np.abs(ga[k] - gb[k]).max()) for k in ga)
        if d != 0.0 or not all(np.isfinite(ga[k]).all() for k in ga):
            raise AssertionError(f"nlayer kernel vs plain {dtype} L={L} "
                                 f"ndomains={ndom} K={K} {kw}: {d:.3e}, "
                                 "expected bitwise")
        worst, cases = max(worst, d), cases + 1
    edge = ", ".join(f"{L} {str(d).removeprefix('torch.')} K={K}"
                     for L, d, K in NLAYER_EDGE)
    print(f"nlayer_sweep parity: kernel vs plain {n}^2, {cases} cases (f64 "
          f"and f32, L={NLAYER_LAYERS} at K=1..8, L={edge}; dx 0.7 dy 1.3 "
          f"at K=4 for L={[L for L, _ in NLAYER_SPACINGS]}; tiles "
          f"{sorted(tiles)}; ndomains 1 and 4), {steps} steps: max abs "
          f"{worst:.3e} (bitwise required)", flush=True)


def phase_nlayer_golden() -> None:
    """tests/test_nlayer.py's golden (48x40, 4 domains, dt 0.01, 60
    steps, rtol 1e-11, atol 1e-13) on the kernel at K = 8."""
    gnx, gny, steps, report = 48, 40, 60, []
    for L in (1, 3, 4):
        e0 = np.zeros((L, gny, gnx))
        e0[0] = gaussian_eta(gnx, gny, amp=0.5)
        if L > 1:
            e0[1] = -gaussian_eta(gnx, gny, amp=2.0)
        m = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=L, fused=True,
                      steps_per_sweep=8, dtype=torch.float64, device=DEV)
        m.set_initial(e0)
        before = nlm.nlayer_sweep.launches
        m.run(steps)
        if nlm.nlayer_sweep.launches - before != steps // 8 + steps % 8:
            raise AssertionError("nlayer golden did not go through the "
                                 "kernel")
        want = nlm.golden_reference(e0, nlm.default_tmask(gnx, gny), 1.0,
                                    1.0, 0.01, steps)
        got = m.gather()
        err = 0.0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-11,
                                       atol=1e-13, err_msg=f"L={L} {k}")
            err = max(err, float(np.abs(got[k] - want[k]).max()))
        report.append(f"L={L} max abs {err:.2e}")
    print(f"nlayer_sweep golden f64 {gnx}x{gny} ndomains=4 K=8 {steps} "
          f"steps: " + "; ".join(report) + " (rtol 1e-11, atol 1e-13)",
          flush=True)


def phase_nlayer_main() -> dict:
    N, K, L, n = MAIN_SIZE, 8, 3, 404
    kern = nlm.nlayer_sweep
    m = nlm.build(N, N, layers=L, fused=True, steps_per_sweep=K, device=DEV)
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    m.set_initial(_nlayer_eta0(N, L))
    torch.cuda.synchronize()
    kern.launches = 0
    m.run(n)
    torch.cuda.synchronize()
    launches = kern.launches
    if launches != n // K + n % K:
        raise AssertionError(f"nlayer main path launched the kernel "
                             f"{launches} times, expected {n // K + n % K}")
    for f in (m.eta, m.u, m.v):
        if (tuple(f.data.shape) != (L,) + m.grid.array_shape
                or not torch.isfinite(f.data).all()):
            raise AssertionError("nlayer main path state is not finite")
    mp = nlm.build(N, N, layers=L, fused=False, steps_per_sweep=K,
                   device=DEV)
    mp.set_initial(_nlayer_eta0(N, L))
    mp.run(n)
    d_run = _rel_diff(m.gather(), mp.gather())
    if not d_run <= TOL_F32:
        raise AssertionError(f"nlayer kernel vs plain f32 after {n} steps: "
                             f"{d_run:.3e} > {TOL_F32}")
    flat = (m.eta.data, m.u.data, m.v.data)
    sweep = m._make_sweep(K)
    prep = m._prepare(m._sweep_aux)
    ker = sweep(flat, m._sweep_aux)
    ref = stencil_sweep_reference(m._sweep_step, K, flat, prep)
    max_abs = _internal_max_abs(m.grid, ker, ref)
    if max_abs != 0.0:
        raise AssertionError(f"nlayer one sweep kernel vs plain f32: "
                             f"{max_abs:.3e}, expected bitwise")
    ms = _time_ms(lambda: sweep(flat, m._sweep_aux), 200)
    device_ms = _device_ms(lambda: sweep(flat, m._sweep_aux), 20)
    plain_ms = _time_ms(lambda: stencil_sweep_reference(
        m._sweep_step, K, flat, prep), 20)
    watch = _run_step_watch(m, 50 * K, 5)
    us_k = watch["us_per_step"]
    us_p = _run_step_us(mp, 5 * K, 3)
    print(f"nlayer_sweep main f32 {N}^2 L={L} K={K}: run({n}) launches="
          f"{launches} (= {n}//{K} + {n}%{K}); finite; kernel vs plain after "
          f"{n} steps rel {d_run:.3e}, one sweep max abs {max_abs:.3e}",
          flush=True)
    print(f"nlayer_sweep timing f32 {N}^2 L={L} K={K}: run on the kernel "
          f"path {us_k:.2f} us/step ({N * N / us_k:.0f} Mpt/s), on the plain "
          f"path {us_p:.2f} us/step; one sweep: kernel "
          f"{device_ms * 1e3:.2f} us on the card (CUDA graph; "
          f"{device_ms * 1e3 / K:.2f} us/step; wrapper call "
          f"{ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us; in run's "
          f"window garbage collection {watch['run_gc_ms']:.2f} ms, "
          f"allocator retries {watch['run_alloc_retries']}, cudaMalloc "
          f"{watch['run_cuda_mallocs']} in window {watch['run_windows']}; "
          f"the first window {watch['run_first_us']:.2f} us/step, cudaMalloc "
          f"{watch['run_first_cuda_mallocs']}", flush=True)
    ops = _count_ops(lambda: stencil_sweep_reference(m._sweep_step, K, flat,
                                                     prep))
    return {"name": "nlayer_sweep", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/nlayer_sweep.cu",
            "replaces": "dl_esm_inf_tpu/models/nlayer.py:178",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms,
            **_bound(_nbytes(*flat, *m._sweep_aux, *ker), ops,
                     m.grid.dtype),
            "device_ms": device_ms,
            **watch, "many_layers": _nlayer_many_main(N, K)}


def _nlayer_many_main(N: int, K: int) -> list:
    """More layers at 1024^2: the compiled march at 5 and 8 layers (f32
    and f64, K), the run-time variant at 33 (f32, K) and 48 (f32, K=4,
    where one window holds up to 75): one sweep kernel vs plain bitwise
    and timed, its bound, and run's us/step at float32."""
    out = []
    for L, dtype, KL in ((5, torch.float32, K), (8, torch.float32, K),
                         (5, torch.float64, K), (8, torch.float64, K),
                         (33, torch.float32, K), (48, torch.float32, 4)):
        m = nlm.build(N, N, layers=L, fused=True, steps_per_sweep=KL,
                      dtype=dtype, device=DEV)
        m.set_initial(_nlayer_eta0(N, L))
        flat = (m.eta.data, m.u.data, m.v.data)
        sweep = m._make_sweep(KL)
        prep = m._prepare(m._sweep_aux)
        nlm.nlayer_sweep.launches = 0
        ker = sweep(flat, m._sweep_aux)
        torch.cuda.synchronize()
        ref = stencil_sweep_reference(m._sweep_step, KL, flat, prep)
        max_abs = _internal_max_abs(m.grid, ker, ref)
        if max_abs != 0.0 or nlm.nlayer_sweep.launches != 1:
            raise AssertionError(f"nlayer L={L} {dtype} one sweep kernel vs "
                                 f"plain: {max_abs:.3e}, expected bitwise")
        ms = _time_ms(lambda: sweep(flat, m._sweep_aux), 50)
        device_ms = _device_ms(lambda: sweep(flat, m._sweep_aux), 10)
        plain_ms = _time_ms(lambda: stencil_sweep_reference(
            m._sweep_step, KL, flat, prep), 3)
        ops = _count_ops(lambda: stencil_sweep_reference(
            m._sweep_step, KL, flat, prep))
        row = {"layers": L, "dtype": str(dtype).removeprefix("torch."),
               "K": KL, "tile": nlm.kernel_tile(L, dtype, KL),
               "threads": nlm.nlayer_sweep.threads(dtype, L, KL),
               "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
               **_bound(_nbytes(*flat, *m._sweep_aux, *ker), ops, dtype),
               "device_ms": device_ms}
        row.update(_run_step_watch(m, 20 * KL, 3) if dtype == torch.float32
                   else {"us_per_step": None})
        del row["library_ms"]
        out.append(row)
        print(f"nlayer_sweep {N}^2 L={L} {row['dtype']} K={KL}: tile "
              f"{row['tile']}, {row['threads']} threads; one sweep kernel vs "
              f"plain bitwise; kernel "
              f"{device_ms * 1e3:.2f} us on the card (CUDA graph; "
              f"{device_ms * 1e3 / KL:.2f} us/step; wrapper call "
              f"{ms * 1e3:.2f} us), plain "
              f"{plain_ms * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} "
              f"us ({row['bound_by']})"
              + (f"; run {row['us_per_step']:.2f} us/step (garbage "
                 f"collection {row['run_gc_ms']:.2f} ms, allocator retries "
                 f"{row['run_alloc_retries']}, cudaMalloc "
                 f"{row['run_cuda_mallocs']} in window {row['run_windows']}; "
                 f"the first window {row['run_first_us']:.2f} us/step, "
                 f"cudaMalloc {row['run_first_cuda_mallocs']})"
                 if row["us_per_step"] is not None else ""), flush=True)
    return out

# --- the kernel-metadata layer: the generated schedule sweep ---------------

#: kernel vs plain in phase 10: max |diff| on internal points over the
#: fields' max |value|.  Both evaluate the same operations in the same
#: order (bodies written op for op, --fmad=false): 0 expected.
TOL_SCHED = {torch.float64: 1e-12, torch.float32: 1e-5}
#: the generated sweep vs the plain fused tier on a field computed through
#: a level sum (the nlayer-style chain's vsum), relative to its max
#: |value|: the kernel adds the levels in order, PyTorch's CUDA reduction
#: may group them.  Every other field of those cases must be bitwise.
TOL_LEVEL_SUM = {torch.float64: 1e-14, torch.float32: 1e-6}
PSY_N, PSY_STEPS = 256, 30
PSY_MAIN_N = 100
#: the nlayer-style chain (dl_esm_inf_tpu_torch/level_schedules.py):
#: levels, grid edge, halo, steps of the parity cases; steps of the main
#: path at 1024^2
LEVELS = (3, 8)
LEVEL_N, LEVEL_HALO, LEVEL_STEPS = 96, 4, 6
LEVEL_MAIN_N = 20
#: the chain past the shared memory of a CTA (the cluster form): dtype,
#: tiles and steps at 1024^2; its level counts: the fewest past one CTA
#: (scratch_levels, computed) and NEMO's 75 vertical levels (eORCA1 L75)
SCRATCH_DTYPE, SCRATCH_TILES, SCRATCH_STEPS = torch.float64, (2, 2), 10
NEMO_LEVELS = 75
#: the bytes two generated sweeps may spill (ptxas's spill stores and
#: loads, as this script's build lines read them on an H100); every other
#: sweep spills nothing.  Both sweeps of the chain at NEMO_LEVELS keep
#: more values a point than 255 registers hold; the scratch form's
#: level_ends and shift past the largest cluster spills at 40 registers
NEMO_SPILL_BYTES, PAST_CLUSTER_SPILL_BYTES = 14636, 120
#: the scratch form (a window past the largest cluster): level_ends (a
#: read-only levels field folded into a 2D one, hand-written) and shift
#: (that field relaxed east, ring 1) at the fewest levels whose window no
#: cluster holds (past_cluster_levels), on one tile of this edge
PAST_CLUSTER_N = 128

#: (stencil rows, torch shift, CUDA read) of the generic schedules
_SHIFTS = {
    "E": ((0, 11, 0), st.xp, "x(0, 1)"),
    "W": ((0, 110, 0), st.xm, "x(0, -1)"),
    "N": ((10, 10, 0), st.yp, "x(1, 0)"),
    "S": ((0, 10, 10), st.ym, "x(-1, 0)"),
    "EE": ((0, 12, 0), lambda a: st.xp(st.xp(a)), "x(0, 2)"),
}


def _arg(access, element, rows=None):
    return km.Arg(access, element,
                  km.Stencil(*rows) if rows else km.GO_POINTWISE)


@functools.lru_cache(maxsize=None)
def _shift_kernel(name: str, space: int):
    """out = shift(x) + a (the JAX package's fuzz kernel) with its CUDA
    body."""
    rows, fn, read = _SHIFTS[name]

    @km.kernel(args=[_arg(km.GO_WRITE, km.GO_CT),
                     _arg(km.GO_READ, km.GO_CT, rows),
                     _arg(km.GO_READ, km.GO_R_SCALAR)],
               iterates_over=space, name=f"shift_{name}_{space}",
               cuda=f"out = {read} + T(a);")
    def shift_plus(out, x, a):
        return fn(x) + a
    return shift_plus


@functools.lru_cache(maxsize=None)
def _scale_kernel(c: float):
    @km.kernel(args=[_arg(km.GO_WRITE, km.GO_CT), _arg(km.GO_READ, km.GO_CT)],
               name=f"scale_{c!r}", cuda=f"out = T({c!r}) * x();")
    def scale(out, x):
        return c * x
    return scale


@km.kernel(args=[_arg(km.GO_READWRITE, km.GO_CT)], name="incr",
           cuda="x = x() + T(1.0);")
def _incr(x):
    return x + 1.0


@km.kernel(args=[_arg(km.GO_READWRITE, km.GO_CT)], name="bc_fill_all",
           iterates_over=km.GO_ALL_PTS, cuda="b = b() * T(0.5) + T(21.0);")
def _fill_all(b):
    return b * 0.5 + 21.0


def _sched_grid(n, ndom, halo, dtype, wrap=False):
    bc = tdl.BC_PERIODIC if wrap else tdl.BC_EXTERNAL
    g = tdl.Grid(tdl.ARAKAWA_C, (bc, bc, tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=dtype, device=DEV)
    g.decompose(n, n, ndomains=ndom, halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


def _fuzz_specs():
    """Seeded generic schedules (seed 42, the JAX package's fuzz):
    (label, shift names, scalars, spaces, wrap, n, tiles, halo)."""
    rng = np.random.default_rng(42)
    out = []
    for trial in range(8):
        wrap = bool(rng.integers(0, 2))
        n = int(rng.choice([64, 96, 128]))
        ndom = int(rng.choice([1, 4, 8, 16]))
        names = [str(x) for x in rng.choice(list(_SHIFTS),
                                             size=int(rng.integers(1, 4)))]
        scal = [float(rng.uniform(-1, 1)) for _ in names]
        spaces = [km.GO_ALL_PTS if rng.integers(0, 3) == 0
                  else km.GO_INTERNAL_PTS for _ in names]
        halo = max(sum(2 if x == "EE" else 1 for x in names), 1)
        out.append((f"fuzz{trial} {'+'.join(names)} "
                    f"{'periodic' if wrap else 'walled'} {n}^2 "
                    f"ndomains={ndom}", names, scal, spaces, wrap, n, ndom,
                    halo))
    return out


def _ramp(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n))


def _generic_case(kind, dtype, plain, spec=None, derived=False):
    """(run, fields to compare, expected launches) of one generic
    schedule on fresh fields; building it builds its kernels.
    ``derived``: every kernel without its CUDA body (derived on the
    card from the torch body)."""
    kern = pt.derived if derived else (lambda k: k)
    if kind == "fuzz":
        label, names, scal, spaces, wrap, n, ndom, halo = spec
        g = _sched_grid(n, ndom, halo, dtype, wrap)
        a = tdl.Field(g, tdl.T_POINTS, init_global_data=_ramp(n, n + ndom))
        b = tdl.Field(g, tdl.T_POINTS)
        calls, cur = [], a
        for nm, sv, sp in zip(names, scal, spaces):
            calls.append((kern(_shift_kernel(nm, sp)), b, cur, sv))
            cur = b
        prog = km.Schedule(*calls).fused_program(1, plain=plain)
        return prog, (a, b), 1
    if kind == "nine_masks":
        g = _sched_grid(96, 4, 1, dtype)
        src = tdl.Field(g, tdl.T_POINTS, init_global_data=_ramp(96, 9))
        outs = [tdl.Field(g, tdl.T_POINTS) for _ in range(9)]
        sched = km.Schedule(*[(kern(_scale_kernel(k + 1.0)), o, src)
                              for k, o in enumerate(outs)])
        if len(sched._fused_masks()) != 2:
            raise AssertionError("nine masks should pack into 2 planes")
        prog = sched.fused_program(1, plain=plain)
        return prog, tuple(outs), 1
    if kind == "multi_mask":
        g = _sched_grid(96, 4, 8, dtype)
        a, b, c = (tdl.Field(g, tdl.T_POINTS, init_global_data=_ramp(96, 3)),
                   tdl.Field(g, tdl.T_POINTS), tdl.Field(g, tdl.T_POINTS))
        east = kern(_shift_kernel("E", km.GO_INTERNAL_PTS))
        sched = km.Schedule((east, b, a, 0.0), (east, c, b, 0.0),
                            (kern(_fill_all), b), (kern(_incr), a))
        prog = sched.fused_program(3, plain=plain)
        return prog, (a, b, c), 3
    assert kind == "scratch_chain"
    g = _sched_grid(96, 4, 8, dtype)
    a, b = (tdl.Field(g, tdl.T_POINTS, init_global_data=_ramp(96, 5)),
            tdl.Field(g, tdl.T_POINTS))
    sched = km.Schedule(
        (kern(_shift_kernel("E", km.GO_INTERNAL_PTS)), b, a, 1.5),
        (kern(_scale_kernel(0.5)), a, b))
    prog3 = sched.fused_program(4, repeats=3, plain=plain)
    rows = [[[0.25 * i + j] for j in range(3)] for i in range(4)]
    return (lambda: prog3(scalars=rows)), (a, b), 4


def _generic_cases():
    return ([("fuzz", s) for s in _fuzz_specs()]
            + [("nine_masks", None), ("multi_mask", None),
               ("scratch_chain", None)])


def _derive(m):
    """Rebind a PSy model's schedule to clones of its 13 kernels without
    their CUDA bodies: on the card every point body is derived."""
    m._sched = km.Schedule(*[(pt.derived(k), *rest)
                             for k, *rest in m._calls()])
    return m


def _psy_case(dtype, ndom, r, variant, plain, n=PSY_N, steps=PSY_STEPS,
              derived=False):
    """(run, fields, expected launches) of the PSy flagship at halo 8:
    ``steps`` steps through fused_program (light variant) or through
    repeated fused calls (full variant) at ``r`` repeats per sweep;
    ``derived``: with every body derived."""
    m = NemoLite2DPsy(n, n, ndomains=ndom, halo_width=8, dtype=dtype,
                      device=DEV)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    if derived:
        _derive(m)
    rows = [[m._scalars_at(i * r + j) for j in range(r)]
            for i in range(steps // r)]
    if variant == "light":
        prog = m._sched.fused_program(steps // r, repeats=r, plain=plain)
        return (lambda: prog(scalars=rows)), (m.sshn_t, m.un, m.vn), \
            steps // r
    m._sched._fused_prog(1, r, plain)

    def run():
        for row in rows:
            m._sched.fused(row, repeats=r, plain=plain)
    return run, (m.sshn_t, m.un, m.vn), steps // r


_LEVEL_KINDS = {
    # (calls, fields, mom3 / set+relax kernels): derived bodies, or the
    # hand-written level bodies (the accessor e(k, dj, di), e[k] = ...)
    "chain": (sc.ml_calls, sc.ml_fields, {}),
    "chain hand-written": (sc.ml_calls, sc.ml_fields, {"mom": sc.mom3_hw}),
    "broadcast": (sc.bc_calls, sc.bc_fields, {}),
    "broadcast hand-written": (sc.bc_calls, sc.bc_fields,
                               {"set_": sc.set_all_levels_hw,
                                "rel": sc.relax_hw}),
}


def _level_case(kind, dtype, levels, plain, n=LEVEL_N, ndom=4,
                steps=LEVEL_STEPS, halo=LEVEL_HALO):
    """(run, fields, expected launches, index of the level-sum field or
    None) of a levels=N schedule through fused_program(steps).  The
    broadcast pair writes its one slot before reading it: nothing feeds
    forward between steps, so the program launches the last step only."""
    calls, fields, kw = _LEVEL_KINDS[kind]
    g = _sched_grid(n, ndom, halo, dtype)
    fs_ = fields(g, levels)
    prog = km.Schedule(*calls(*fs_, **kw)).fused_program(steps, plain=plain)
    chain = calls is sc.ml_calls
    return prog, fs_, (steps if chain else 1), (4 if chain else None)


def scratch_levels() -> int:
    """The fewest levels at which the nlayer-style chain's window does not
    fit a CTA's shared memory even on 8-cell tiles, so that its sweeps
    take the cluster form: both of its sweeps stream 4L + 1 float planes
    (u, v, eta and the forcing at L levels, and the level sum) and one
    code plane, at the chain's erosion at halo LEVEL_HALO."""
    g = _sched_grid(64, 1, LEVEL_HALO, SCRATCH_DTYPE)
    ring = km.Schedule(*sc.ml_calls(*sc.ml_fields(g, 3))).fused_erosion(1)
    L = 1
    while ss.window_tile(4 * L + 1, 0, 1, ring, SCRATCH_DTYPE)[2] == 1:
        L += 1
    return L


def past_cluster_levels() -> int:
    """The fewest levels at which the window of level_ends and shift (L + 1
    float planes: the read-only levels field and the 2D result, and one
    code plane, at ring 1) does not fit the largest cluster, so that its
    sweep takes the scratch form."""
    g = _sched_grid(64, 1, LEVEL_HALO, SCRATCH_DTYPE)
    ring = km.Schedule(*sc.ends_calls(*sc.ends_fields(g, 3))).fused_erosion(1)
    L = 1
    while ss.window_tile(L + 1, 0, 1, ring, SCRATCH_DTYPE)[2]:
        L += 1
    return L


def _east_schedule_build():
    """Build the fused sweep of phase 19's schedule leg (two east shifts,
    float32), which its ranks then load."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    g, fa, fb, east = mpc.schedule_case(64, 1, DEV)
    km.Schedule((east, fb, fa), (east, fb, fb))._fused_prog(1, 1)


def _schedule_builds():
    """One task per generated source phase 10 needs: each builds its
    case's kernel side, which generates and compiles the sources."""
    tasks = [functools.partial(_level_case, "chain", SCRATCH_DTYPE, L,
                               False, n=64, ndom=1)
             for L in (scratch_levels(), NEMO_LEVELS)]
    tasks += [functools.partial(_past_cluster_case, 64), _east_schedule_build]
    for dtype in (torch.float64, torch.float32):
        for r in (1, 2, 3):
            for derived in (False, True):
                tasks.append(functools.partial(
                    _psy_case, dtype, 1, r, "light", False, n=64,
                    steps=2 * r, derived=derived))
        for kind, spec in _generic_cases():
            for derived in (False, True):
                tasks.append(functools.partial(
                    _generic_case, kind, dtype, False, spec, derived))
        for kind in _LEVEL_KINDS:
            for levels in LEVELS:
                tasks.append(functools.partial(
                    _level_case, kind, dtype, levels, False, n=64, ndom=1))
    return tasks


def _inner_diff(fa, fb) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / max |b|) on internal points, over
    fields."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(fa, fb):
        ga, gb = a.gather_inner_data(), b.gather_inner_data()
        d = float(np.abs(ga - gb).max())
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / max(float(np.abs(gb).max()), 1e-300))
    return worst_abs, worst_rel


def _plain_tier_refused(fn):
    """Run ``fn`` with the plain fused tier (the torch bodies through
    stencil_sweep_reference) replaced by a function that raises."""
    saved = km.stencil_sweep_reference

    def refuse(*args, **kwargs):
        raise AssertionError("the plain fused tier ran on the kernel path")
    km.stencil_sweep_reference = refuse
    try:
        return fn()
    finally:
        km.stencil_sweep_reference = saved


def _run_kernel(label, dtype, run, n_launch):
    """``run`` with the plain tier refused; checks the launches."""
    before = ss.schedule_sweep.launches
    _plain_tier_refused(run)
    torch.cuda.synchronize()
    got = ss.schedule_sweep.launches - before
    if got != n_launch:
        raise AssertionError(f"schedule sweep {label} {dtype}: {got} "
                             f"launches, expected {n_launch}")


def _check_case(label, make, dtype, exact=False, sum_field=None):
    """Kernel vs plain fused tier of one case: within TOL_SCHED, or with
    ``exact`` bitwise on internal points but for ``sum_field`` (within
    TOL_LEVEL_SUM); returns (max abs diff, max abs diff of the sum
    field)."""
    run_k, fk, n_launch = make(False)[:3]
    run_p, fp, _ = make(True)[:3]
    _run_kernel(label, dtype, run_k, n_launch)
    before = ss.schedule_sweep.launches
    run_p()
    if ss.schedule_sweep.launches != before:
        raise AssertionError(f"{label}: the plain route launched a kernel")
    for f in fk:
        if not torch.isfinite(f.data).all():
            raise AssertionError(f"schedule sweep {label}: not finite")
    rest = [i for i in range(len(fk)) if i != sum_field]
    d_abs, d = _inner_diff([fk[i] for i in rest], [fp[i] for i in rest])
    if not d <= (0.0 if exact else TOL_SCHED[dtype]):
        raise AssertionError(f"schedule sweep {label} {dtype}: kernel vs "
                             f"plain {d:.3e} > "
                             f"{0.0 if exact else TOL_SCHED[dtype]}")
    s_abs = 0.0
    if sum_field is not None:
        s_abs, s_rel = _inner_diff([fk[sum_field]], [fp[sum_field]])
        if not s_rel <= TOL_LEVEL_SUM[dtype]:
            raise AssertionError(f"schedule sweep {label} {dtype}: level "
                                 f"sum {s_rel:.3e} > {TOL_LEVEL_SUM[dtype]}")
    return d_abs, s_abs


def _check_derived_psy(label, dtype, ndom, r, variant):
    """The PSy flagship with every body derived against the hand-written
    bodies, both on the kernel: bitwise on internal points."""
    out = []
    for derived in (False, True):
        run, f, n_launch = _psy_case(dtype, ndom, r, variant, False,
                                     derived=derived)
        _run_kernel(label, dtype, run, n_launch)
        out.append(f)
    d_abs = _inner_diff(*out)[0]
    if d_abs != 0.0:
        raise AssertionError(f"{label} {dtype}: derived vs hand-written "
                             f"bodies {d_abs:.3e}, expected bitwise")


def phase_schedule_plans() -> None:
    """Each generated source's plan (ops/schedule_sweep.py::plan): its
    passes, barriers and calls in place per repeat."""
    gens = ss.schedule_sweep.generated
    for gen in gens.values():
        print(f"schedule_sweep plan {gen.name} ({gen.dtype}, K={gen.K}, "
              f"{len(gen.plan.names)} calls: {gen.plan.names[0]} .. "
              f"{gen.plan.names[-1]}): {gen.plan.summary()}", flush=True)
    print(f"schedule_sweep plans: {len(gens)} generated sources", flush=True)


def phase_schedule_parity() -> None:
    for dtype in (torch.float64, torch.float32):
        worst, worst_d, cases = 0.0, 0.0, 0
        for r in (1, 2, 3):
            for ndom in (1, 4):
                for variant in ("light", "full"):
                    label = f"PSy r={r} ndomains={ndom} {variant}"
                    d = _check_case(
                        label, lambda p, r=r, ndom=ndom, v=variant:
                        _psy_case(dtype, ndom, r, v, p), dtype)[0]
                    dd = _check_case(
                        label + " derived", lambda p, r=r, ndom=ndom,
                        v=variant: _psy_case(dtype, ndom, r, v, p,
                                             derived=True),
                        dtype, exact=True)[0]
                    _check_derived_psy(label, dtype, ndom, r, variant)
                    worst, worst_d = max(worst, d), max(worst_d, dd)
                    cases += 1
        print(f"schedule_sweep parity {dtype}: PSy flagship {PSY_N}^2, "
              f"{PSY_STEPS} steps, repeats 1-3 at halo 8, 1 and 4 tiles, "
              f"fused_program and fused: {cases} cases, max abs diff "
              f"{worst:.3e} on internal points (tol {TOL_SCHED[dtype]} x "
              f"max|field|); with all 13 bodies derived: vs plain "
              f"{worst_d:.3e} (bitwise required), vs the hand-written "
              f"bodies bitwise in all {cases}", flush=True)
        for derived in (False, True):
            report = []
            for kind, spec in _generic_cases():
                label = (spec[0] if spec else kind) + (
                    " derived" if derived else "")
                d = _check_case(label, lambda p, k=kind, s=spec:
                                _generic_case(k, dtype, p, s, derived),
                                dtype, exact=derived)[0]
                report.append(f"{label}: {d:.1e}")
            how = ", bodies derived" if derived else ""
            print(f"schedule_sweep parity {dtype} (kernel vs plain, max "
                  f"abs diff on internal points{how}): " + "; ".join(report),
                  flush=True)
        report = []
        for kind in _LEVEL_KINDS:
            for levels in LEVELS:
                for ndom in (1, 4):
                    label = f"{kind} levels={levels} ndomains={ndom}"
                    sf = 4 if _LEVEL_KINDS[kind][0] is sc.ml_calls else None
                    d, ds = _check_case(
                        label, lambda p, k=kind, lv=levels, nd=ndom:
                        _level_case(k, dtype, lv, p, ndom=nd), dtype,
                        exact=True, sum_field=sf)
                    report.append(f"{label}: {d:.1e}" + (
                        f" (level sum {ds:.1e})" if sf is not None else ""))
        print(f"schedule_sweep parity {dtype}, levels=N schedules "
              f"({LEVEL_N}^2, halo {LEVEL_HALO}, {LEVEL_STEPS} steps through "
              "fused_program; kernel vs plain, max abs diff on internal "
              "points, bitwise required but for the level sum, tol "
              f"{TOL_LEVEL_SUM[dtype]} x max|sum|): " + "; ".join(report),
              flush=True)


def phase_psy_vs_production() -> None:
    """NemoLite2DPsy fused on the card against the production model on
    the card, float64, 34x30, 4 tiles, 30 steps (1e-10, the JAX test)."""
    gnx, gny, steps = 34, 30, 30
    eta0 = gaussian_eta(gnx, gny, amp=0.2)
    m = NemoLite2DPsy(gnx, gny, ndomains=4, dtype=torch.float64, device=DEV)
    m.set_initial_ssh(eta0)
    before = ss.schedule_sweep.launches
    m.run(steps, fused=True)
    if ss.schedule_sweep.launches - before != steps:
        raise AssertionError("PSy run did not go through the kernel")
    got = m.gather()
    report = []
    for fused in (False, True):
        p = nl.build(gnx, gny, ndomains=4, dtype=torch.float64, fused=fused,
                     steps_per_sweep=4 if fused else 1, device=DEV)
        p.set_initial_ssh(eta0)
        p.run(steps)
        want = p.gather()
        err = 0.0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                       atol=1e-10, err_msg=k)
            err = max(err, float(np.abs(got[k] - want[k]).max()))
        report.append(f"vs production {'kernel K=4' if fused else 'plain'}"
                      f" max abs {err:.2e}")
    print(f"NemoLite2DPsy f64 {gnx}x{gny} 4 tiles {steps} steps on the "
          f"generated kernel: " + "; ".join(report) + " (tol 1e-10)",
          flush=True)


def _copy_gbs() -> float:
    """Device-to-device copy bandwidth (read + write bytes / time) of a
    256 MiB float32 buffer, CUDA events."""
    src = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=DEV)
    dst = torch.empty_like(src)
    ms = _time_ms(lambda: dst.copy_(src), 20)
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


def _psy_run(m, nsteps, repeats=1, plain=False):
    """``nsteps`` steps of the PSy model through the fused program at
    ``repeats`` steps per sweep: the generated kernel, or with ``plain``
    its plain version."""
    n = nsteps // repeats
    m._sched.fused_program(n, repeats=repeats, plain=plain)(
        scalars=[[m._scalars_at(m._step + i * repeats + j)
                  for j in range(repeats)] for i in range(n)])
    m._step += n * repeats


def phase_psy_main() -> dict:
    N, n = MAIN_SIZE, PSY_MAIN_N
    gbs = _copy_gbs()
    m = NemoLite2DPsy(N, N, halo_width=8, device=DEV)
    if m.grid.dtype != torch.float32:
        raise AssertionError(f"expected the float32 default on CUDA, got "
                             f"{m.grid.dtype}")
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    mp = NemoLite2DPsy(N, N, halo_width=8, device=DEV)
    mp.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    md = _derive(NemoLite2DPsy(N, N, halo_width=8, device=DEV))
    md.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    launches = {}
    for key, model in (("hand", m), ("derived", md)):
        model._sched.fused_program(n)         # build before the count
        torch.cuda.synchronize()
        ss.schedule_sweep.launches = 0
        _plain_tier_refused(lambda: model.run(n, fused=True))
        torch.cuda.synchronize()
        launches[key] = ss.schedule_sweep.launches
        if launches[key] != n:
            raise AssertionError(f"PSy main path ({key} bodies) launched "
                                 f"the schedule sweep {launches[key]} "
                                 f"times, expected {n}")
    fields = (m.sshn_t, m.un, m.vn)
    for f in fields:
        if (tuple(f.data.shape) != m.grid.array_shape
                or not torch.isfinite(f.data).all()):
            raise AssertionError("PSy main path state is not finite")
    if _inner_diff(fields, (md.sshn_t, md.un, md.vn))[0] != 0.0:
        raise AssertionError("PSy main path: derived bodies != hand-written "
                             "bodies")
    _psy_run(mp, n, plain=True)
    d_run = _inner_diff(fields, (mp.sshn_t, mp.un, mp.vn))[1]
    if not d_run <= TOL_F32:
        raise AssertionError(f"PSy kernel vs plain f32 after {n} steps: "
                             f"{d_run:.3e} > {TOL_F32}")

    # one sweep of the light variant (n - 1 of the n launches) against
    # its plain version, on the main path's state
    sched = m._sched
    sweep, st_slots, x_slots = sched._fused_prog(n, 1)[3]["light"]
    psweep = sched._fused_prog(n, 1, True)[3]["light"][0]
    ro_slots = sched._fused_prog(n, 1)[2]
    slot = lambda i: sched._slots[i].data  # noqa: E731
    state = tuple(slot(i) for i in st_slots)
    ros = tuple(slot(i) for i in ro_slots)
    extra = tuple(slot(i) for i in x_slots)
    rows = [tuple(float(v) for v in sched._user_scalar_vector(
        m._scalars_at(m._step)))]
    dsweep = md._sched._fused_prog(n, 1)[3]["light"][0]
    ker = sweep(state, ros, extra, rows)
    ker_d = dsweep(state, ros, extra, rows)
    ref = psweep(state, ros, extra, rows)
    inner = m.sshn_t.internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max()) for a, b in zip(ker, ref))
    max_abs_d = max(float((a - b).abs()[inner].max())
                    for a, b in zip(ker_d, ref))
    scale = max(float(b.abs()[inner].max()) for b in ref)
    if not max(max_abs, max_abs_d) <= TOL_F32 * scale:
        raise AssertionError(f"PSy one sweep kernel vs plain: {max_abs:.3e}"
                             f" (derived {max_abs_d:.3e})")
    ms = _time_ms(lambda: sweep(state, ros, extra, rows), 200)
    device_ms = _device_ms(lambda: sweep(state, ros, extra, rows), 20)
    ms_d = _time_ms(lambda: dsweep(state, ros, extra, rows), 200)
    device_ms_d = _device_ms(lambda: dsweep(state, ros, extra, rows), 20)
    plain_ms = _time_ms(lambda: psweep(state, ros, extra, rows), 20)
    ops = _count_ops(lambda: psweep(state, ros, extra, rows))
    code = torch.stack(sched._fused_masks())
    nbytes = _nbytes(*state, *ker, *ros, *extra, *sched._consts, code)
    bound = _bound(nbytes, ops, torch.float32)

    def us(run, steps, reps):
        return 1e3 * _time_ms(lambda: run(steps), reps) / steps
    us_k = us(lambda k: m.run(k, fused=True), n, 5)
    us_kd = us(lambda k: md.run(k, fused=True), n, 5)
    us_rep, us_rep_d = {}, {}
    for r in (2, 3):
        for derived, out in ((False, us_rep), (True, us_rep_d)):
            mr = NemoLite2DPsy(N, N, halo_width=8, device=DEV)
            mr.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
            if derived:
                _derive(mr)
            _psy_run(mr, n - n % r, r)
            out[r] = us(lambda k, mr=mr, r=r: _psy_run(mr, k, r), 60, 5)
    us_plain_fused = us(lambda k: _psy_run(mp, k, plain=True), 10, 3)
    us_sched = us(mp.run, 5, 3)
    prod = nl.build(N, N, fused=True, steps_per_sweep=4, device=DEV)
    prod.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    prod.run(400)
    us_prod = 1e3 * _time_ms(lambda: prod.run(400), 3) / 400
    print(f"PSy main f32 {N}^2 halo 8: run({n}, fused=True) launches="
          f"{launches['hand']} (hand-written bodies), {launches['derived']} "
          f"(derived) (= n); finite; derived == hand-written bitwise; "
          f"kernel vs plain after {n} steps rel {d_run:.3e}, one light "
          f"sweep max abs {max_abs:.3e} (derived {max_abs_d:.3e})",
          flush=True)
    print(f"PSy timing f32 {N}^2, derived bodies: kernel path {us_kd:.2f} "
          f"us/step (repeats 1), {us_rep_d[2]:.2f} (repeats 2), "
          f"{us_rep_d[3]:.2f} (repeats 3); one light sweep "
          f"{device_ms_d * 1e3:.2f} us on the card (wrapper call "
          f"{ms_d * 1e3:.2f} us); hand-written {us_k:.2f} / "
          f"{us_rep[2]:.2f} / {us_rep[3]:.2f} us/step, "
          f"{device_ms * 1e3:.2f} us", flush=True)
    print(f"PSy timing f32 {N}^2 (state: Gaussian bump after {n}+ steps): "
          f"kernel path {us_k:.2f} us/step (repeats 1), "
          f"{us_rep[2]:.2f} (repeats 2), {us_rep[3]:.2f} (repeats 3); plain "
          f"fused tier {us_plain_fused:.2f} us/step; plain schedule "
          f"{us_sched:.2f} us/step; production flagship kernel K=4 "
          f"{us_prod:.2f} us/step; one light sweep: kernel "
          f"{device_ms * 1e3:.2f} "
          f"us on the card (CUDA graph; wrapper call "
          f"{ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us; "
          f"{nbytes / state[0].numel():.1f} B/pt per sweep, bound "
          f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}; copy "
          f"{gbs:.0f} GB/s gives {nbytes / gbs / 1e3:.2f} us)", flush=True)
    entry = {"route": "cuda",
             "source": "dl_esm_inf_tpu_torch/ops/schedule_sweep.py",
             "replaces": "dl_esm_inf_tpu/api/kernel_meta.py:851",
             "plain_ms": plain_ms, **bound}
    return [{"name": "schedule_sweep", "launches": launches["hand"],
             "max_abs_err": max_abs, "ms": ms, **entry,
             "device_ms": device_ms},
            {"name": "schedule_sweep (PSy, derived bodies)",
             "launches": launches["derived"], "max_abs_err": max_abs_d,
             "ms": ms_d, **entry, "device_ms": device_ms_d}]


#: (levels, dtype, (ndomainx, ndomainy)) of the levels=N main paths
LEVEL_MAIN = ((3, torch.float32, (1, 1)), (3, torch.float32, (2, 2)),
              (8, torch.float32, (1, 1)), (8, torch.float32, (2, 2)),
              (8, torch.float64, (1, 1)))


def _level_main(levels, dtype, tiles):
    """(schedule, fields) of the nlayer-style chain at 1024^2, halo
    LEVEL_HALO, on ``tiles`` (ndomainx, ndomainy)."""
    bc = tdl.BC_EXTERNAL
    g = tdl.Grid(tdl.ARAKAWA_C, (bc, bc, tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=dtype, device=DEV)
    g.decompose(MAIN_SIZE, MAIN_SIZE, ndomainx=tiles[0], ndomainy=tiles[1],
                halo_width=LEVEL_HALO)
    tdl.grid_init(g, 1.0, 1.0)
    f = sc.ml_fields(g, levels)
    sched = km.Schedule(*sc.ml_calls(*f))
    return sched, f


def phase_levels_main() -> list:
    """The levels=N path at full width: the nlayer-style chain (mom3,
    cont3, mom3, cont3, vsum; every body derived) at 1024^2 on 1 and 2x2
    tiles, LEVEL_MAIN_N steps through fused_program with the launch count
    reset just before and the plain tier refused; against the plain fused
    tier after the run; one light sweep timed beside its plain version
    and its bound; us/step of the kernel path and the plain fused tier."""
    entries, n = [], LEVEL_MAIN_N
    for levels, dtype, tiles in LEVEL_MAIN:
        label = (f"levels={levels} {str(dtype)[6:]} {tiles[0]}x{tiles[1]} "
                 f"tiles")
        sched, f = _level_main(levels, dtype, tiles)
        prog = sched.fused_program(n)            # builds the kernels
        psched, pf = _level_main(levels, dtype, tiles)
        pprog = psched.fused_program(n, plain=True)
        torch.cuda.synchronize()
        ss.schedule_sweep.launches = 0
        _plain_tier_refused(prog)
        torch.cuda.synchronize()
        launches = ss.schedule_sweep.launches
        if launches != n:
            raise AssertionError(f"{label}: {launches} launches, expected "
                                 f"{n}")
        for x in f:
            if not torch.isfinite(x.data).all():
                raise AssertionError(f"{label}: not finite")
        pprog()
        d_run = _inner_diff(f[:4], pf[:4])[0]
        d_sum = _inner_diff(f[4:], pf[4:])[1]
        if d_run != 0.0 or not d_sum <= TOL_LEVEL_SUM[dtype]:
            raise AssertionError(f"{label}: kernel vs plain after {n} "
                                 f"steps {d_run:.3e}, level sum {d_sum:.3e}")
        sweep, st_slots, x_slots = sched._fused_prog(n, 1)[3]["light"]
        psweep = sched._fused_prog(n, 1, True)[3]["light"][0]
        ro_slots = sched._fused_prog(n, 1)[2]
        slot = lambda i: sched._slots[i].data  # noqa: E731
        planes = lambda idx: tuple(  # noqa: E731
            p for i in idx for p in ((slot(i),) if slot(i).dim() == 2
                                     else slot(i).unbind(0)))
        state, ros, extra = planes(st_slots), planes(ro_slots), planes(x_slots)
        rows = [tuple(float(v) for v in sched._user_scalar_vector(None))]
        ker = sweep(state, ros, extra, rows)
        ref = psweep(state, ros, extra, rows)
        inner = f[0].internal_mask.bool()
        max_abs = max(float((a - b).abs()[inner].max())
                      for a, b in zip(ker, ref))
        if max_abs != 0.0:
            raise AssertionError(f"{label}: one light sweep kernel vs plain "
                                 f"{max_abs:.3e}")
        ms = _time_ms(lambda: sweep(state, ros, extra, rows), 100)
        device_ms = _device_ms(lambda: sweep(state, ros, extra, rows), 20)
        plain_ms = _time_ms(lambda: psweep(state, ros, extra, rows), 5)
        ops = _count_ops(lambda: psweep(state, ros, extra, rows))
        nbytes = _nbytes(*state, *ker, *ros, *extra,
                         torch.stack(sched._fused_masks()))
        bound = _bound(nbytes, ops, dtype)
        us_k = 1e3 * _time_ms(prog, 5) / n
        us_p = 1e3 * _time_ms(pprog, 2) / n
        print(f"levels main {label} {MAIN_SIZE}^2 halo {LEVEL_HALO}: "
              f"fused_program({n}) launches={launches} (= n), finite, plain "
              f"tier refused; vs plain fused tier after {n} steps: bitwise "
              f"(level sum rel {d_sum:.3e}, tol {TOL_LEVEL_SUM[dtype]}); "
              f"{us_k:.2f} us/step vs plain fused {us_p:.2f}; one light "
              f"sweep {device_ms * 1e3:.2f} us on the card (CUDA graph; "
              f"wrapper call {ms * 1e3:.2f} us) vs plain "
              f"{plain_ms * 1e3:.2f} us, "
              f"{len(state)} state + {len(ros) + len(extra)} read-only "
              f"planes, {nbytes / state[0].numel():.1f} B/pt, bound "
              f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})",
              flush=True)
        form = sweep.generated.form
        if form != "shared":
            raise AssertionError(f"{label}: the {form} form; every window "
                                 "that fits shared memory keeps it")
        if tiles == (1, 1):
            entries.append({
                "name": f"schedule_sweep (levels={levels}, "
                        f"{str(dtype)[6:]})", "route": "cuda",
                "source": "dl_esm_inf_tpu_torch/ops/schedule_sweep.py",
                "replaces": "dl_esm_inf_tpu/api/kernel_meta.py:851",
                "launches": launches, "max_abs_err": max_abs, "ms": ms,
                "plain_ms": plain_ms, **bound, "device_ms": device_ms})
    for levels in (scratch_levels(), NEMO_LEVELS):
        entries.append(_levels_cluster(levels))
    entries.append(_scratch_past_cluster())
    return entries


def _light_sweep(sched, n: int, inner, label: str, dtype) -> dict:
    """One light sweep (the full one where the program has no light
    variant) of the schedule's fused_program(n) on its current slots
    against its plain version (bitwise on ``inner`` points), the wrapper
    call's and the card's time (a CUDA graph), the plain version's, and
    the bound from this call's bytes and operations; also the generated
    sweep (``gen``) and its launch (``run``)."""
    variants = sched._fused_prog(n, 1)[3]
    which = "light" if "light" in variants else "full"
    sweep, st_slots, x_slots = variants[which]
    psweep = sched._fused_prog(n, 1, True)[3][which][0]
    ro_slots = sched._fused_prog(n, 1)[2]
    slot = lambda i: sched._slots[i].data  # noqa: E731
    planes = lambda idx: tuple(  # noqa: E731
        p for i in idx for p in ((slot(i),) if slot(i).dim() == 2
                                 else slot(i).unbind(0)))
    state, ros, extra = planes(st_slots), planes(ro_slots), planes(x_slots)
    rows = [tuple(float(v) for v in sched._user_scalar_vector(None))]
    ker = sweep(state, ros, extra, rows)
    ref = psweep(state, ros, extra, rows)
    max_abs = max(float((a - b).abs()[inner].max())
                  for a, b in zip(ker, ref))
    if max_abs != 0.0:
        raise AssertionError(f"{label}: one light sweep kernel vs plain "
                             f"{max_abs:.3e}")
    run = lambda: sweep(state, ros, extra, rows)  # noqa: E731
    nbytes = _nbytes(*state, *ker, *ros, *extra,
                     torch.stack(sched._fused_masks()))
    ops = _count_ops(lambda: psweep(state, ros, extra, rows))
    return {"gen": sweep.generated, "run": run, "max_abs_err": max_abs,
            "ms": _time_ms(run, 10), "device_ms": _device_ms(run, 5),
            "plain_ms": _time_ms(lambda: psweep(state, ros, extra, rows),
                                 2),
            **_bound(nbytes, ops, dtype),
            "planes": (len(state), len(ros) + len(extra)),
            "bpt": nbytes / state[0].numel(), "block": state[0].shape}


def _levels_cluster(L: int) -> dict:
    """The chain at L levels (past a CTA's shared memory), SCRATCH_DTYPE,
    1024^2 on SCRATCH_TILES tiles: both sweeps generated in the cluster
    form (and, at scratch_levels(), one level fewer in the shared form);
    SCRATCH_STEPS steps through fused_program with the launches reset just
    before and the plain tier refused, bitwise against the plain fused
    tier on internal points but for the level sum (within TOL_LEVEL_SUM);
    one light sweep against its plain version, bitwise, timed as a CUDA
    graph beside its bound; the window's bytes, its cluster, CTAs and
    threads."""
    dtype, tiles, n = SCRATCH_DTYPE, SCRATCH_TILES, SCRATCH_STEPS
    label = (f"levels={L} {str(dtype)[6:]} {tiles[0]}x{tiles[1]} tiles "
             f"{MAIN_SIZE}^2")
    sched, f = _level_main(L, dtype, tiles)
    prog = sched.fused_program(n)
    variants = sched._fused_prog(n, 1)[3]
    forms = {k: v[0].generated.form for k, v in variants.items()}
    gen = variants["light"][0].generated
    below = ss.window_tile(gen.n_state + gen.n_aux - 4, 0, gen.n_codes,
                           gen.ring, dtype)[2]
    first = L == scratch_levels()
    if set(forms.values()) != {"cluster"} or (first and below != 1):
        raise AssertionError(f"{label}: forms {forms}; {L - 1} levels "
                             f"take {below} CTAs")
    psched, pf = _level_main(L, dtype, tiles)
    pprog = psched.fused_program(n, plain=True)
    torch.cuda.synchronize()
    ss.schedule_sweep.launches = 0
    _plain_tier_refused(prog)
    torch.cuda.synchronize()
    launches = ss.schedule_sweep.launches
    if launches != n:
        raise AssertionError(f"{label}: {launches} launches, expected {n}")
    for x in f:
        if not torch.isfinite(x.data).all():
            raise AssertionError(f"{label}: not finite")
    pprog()
    d_run = _inner_diff(f[:4], pf[:4])[0]
    d_sum = _inner_diff(f[4:], pf[4:])[1]
    if d_run != 0.0 or not d_sum <= TOL_LEVEL_SUM[dtype]:
        raise AssertionError(f"{label}: kernel vs plain after {n} steps "
                             f"{d_run:.3e}, level sum {d_sum:.3e}")
    t = _light_sweep(sched, n, f[0].internal_mask.bool(), label, dtype)
    ly, lx = t["block"]
    lib = ss.schedule_sweep.build(gen).lib
    ctas = lib.schedule_sweep_clusters(ly, lx) * gen.cluster
    print(f"levels cluster form {label}: window {gen.window_bytes} B "
          f"(tile {gen.tile.ty}x{gen.tile.tx} in a {gen.tile.wx}-column "
          f"window, ring {gen.ring}) over a cluster of {gen.cluster} CTAs "
          f"of {gen.smem_bytes} B shared memory and {ss.CLUSTER_THREADS} "
          f"threads, {ctas} CTAs"
          + (f"; {L - 1} levels keep the shared form" if first else "")
          + f"; fused_program({n}) launches={launches} (= n), finite, "
          f"plain tier refused; vs plain fused tier after {n} steps: "
          f"bitwise (level sum rel {d_sum:.3e}); one light sweep bitwise, "
          f"{t['device_ms'] * 1e3:.2f} us on the card (CUDA graph; wrapper "
          f"call {t['ms'] * 1e3:.2f} us) vs plain {t['plain_ms'] * 1e3:.2f} "
          f"us, {t['planes'][0]} state + {t['planes'][1]} read-only planes, "
          f"{t['bpt']:.1f} B/pt, bound {t['bound_ms'] * 1e3:.2f} us "
          f"({t['bound_by']}) [{SMI}]", flush=True)
    return {"name": f"schedule_sweep (levels={L}, {str(dtype)[6:]}, cluster "
                    "form)", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/ops/schedule_sweep.py",
            "replaces": "dl_esm_inf_tpu/api/kernel_meta.py:851",
            "launches": launches,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "device_ms")},
            "form": gen.form, "window_bytes": gen.window_bytes,
            "cluster": gen.cluster, "smem_bytes": gen.smem_bytes,
            "threads": ss.CLUSTER_THREADS, "ctas": ctas,
            "tiles": list(tiles)}


def _past_cluster_case(n: int):
    """(schedule, fields) of level_ends and shift at past_cluster_levels()
    levels, SCRATCH_DTYPE, on one n^2 tile; building its fused program
    builds its kernel."""
    g = _sched_grid(n, 1, LEVEL_HALO, SCRATCH_DTYPE)
    f = sc.ends_fields(g, past_cluster_levels())
    sched = km.Schedule(*sc.ends_calls(*f))
    sched.fused_program(SCRATCH_STEPS)
    return sched, f


def _scratch_past_cluster() -> dict:
    """The global-memory scratch form kept launched: level_ends (a
    read-only levels field folded into a 2D one) and shift (a barrier,
    then a staged pass that reads the 2D field one cell east: ring 1) at
    past_cluster_levels() levels, SCRATCH_DTYPE, on one PAST_CLUSTER_N^2
    tile, a window no cluster holds; SCRATCH_STEPS steps through
    fused_program (each folds into the last: one launch a step) with the
    launches reset just before and the plain tier refused, bitwise
    against the plain fused tier on internal points; one sweep against
    its plain version, bitwise, timed as a CUDA graph beside its
    bound."""
    L, dtype, n = past_cluster_levels(), SCRATCH_DTYPE, SCRATCH_STEPS
    label = (f"level_ends+shift levels={L} {str(dtype)[6:]} 1 tile "
             f"{PAST_CLUSTER_N}^2")
    sched, f = _past_cluster_case(PAST_CLUSTER_N)
    psched, pf = _past_cluster_case(PAST_CLUSTER_N)
    prog, pprog = sched.fused_program(n), psched.fused_program(n, plain=True)
    forms = {k: v[0].generated.form
             for k, v in sched._fused_prog(n, 1)[3].items()}
    if set(forms.values()) != {"scratch"}:
        raise AssertionError(f"{label}: forms {forms}")
    torch.cuda.synchronize()
    ss.schedule_sweep.launches = 0
    _plain_tier_refused(prog)
    torch.cuda.synchronize()
    launches = ss.schedule_sweep.launches
    if launches != n:
        raise AssertionError(f"{label}: {launches} launches, expected {n}")
    pprog()
    for x in f:
        if not torch.isfinite(x.data).all():
            raise AssertionError(f"{label}: not finite")
    d = _inner_diff(f, pf)[0]
    if d != 0.0:
        raise AssertionError(f"{label}: kernel vs plain {d:.3e}")
    t = _light_sweep(sched, n, f[0].internal_mask.bool(), label, dtype)
    gen = t["gen"]
    ly, lx = t["block"]
    ctas = ss.schedule_sweep.build(gen).lib.schedule_sweep_ctas(
        ly, lx, ss.SCRATCH_BYTES)
    print(f"levels scratch form {label}: window {gen.window_bytes} B per "
          f"CTA (tile {gen.tile.ty}x{gen.tile.tx} in a {gen.tile.wx}-column "
          f"window, ring {gen.ring}), past the largest cluster, {ctas} "
          f"CTAs; fused_program({n}) launches={launches} (= n), finite, "
          f"plain tier refused; vs plain fused tier after {n} steps: "
          f"bitwise; one sweep bitwise, {t['device_ms'] * 1e3:.2f} us on the card "
          f"(CUDA graph; wrapper call {t['ms'] * 1e3:.2f} us) vs plain "
          f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} "
          f"us ({t['bound_by']}) [{SMI}]", flush=True)
    return {"name": f"schedule_sweep (levels={L}, {str(dtype)[6:]}, scratch "
                    "form)", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/ops/schedule_sweep.py",
            "replaces": "dl_esm_inf_tpu/api/kernel_meta.py:851",
            "launches": launches,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "device_ms")},
            "form": gen.form, "window_bytes": gen.window_bytes,
            "ctas": ctas, "tiles": [1, 1]}


# --- the skeleton's sweeps on edge shapes -----------------------------------

#: (ny, nx, dtype, K) of the edge-shape phase (K None: each path's main
#: K): a block whose sides are no multiple of any tile and whose rows
#: (nx plus the halos) are no multiple of 4 points, so that its windows
#: are staged by clamped scalar reads; a block smaller than one tile; and
#: float64 at K=4
EDGE_SHAPES = ((1000, 1030, torch.float32, None), (37, 45, torch.float32, None),
               (1000, 1030, torch.float64, 4))


def _edge_client(name, nx, ny, K, dtype):
    """A client model on an (ny, nx) grid at K, a few steps in."""
    kw = dict(fused=True, steps_per_sweep=K, dtype=dtype, device=DEV)
    if name == "gravity_wave_sweep":
        m = gw.build(nx, ny, dt=0.005, **kw)
        m.set_initial_eta(gaussian_eta(nx, ny, amp=0.1))
    elif name == "shallow_sweep":
        m = sh.build(nx, ny, **kw)
        m.set_initial_eta(gaussian_eta(nx, ny, amp=0.3))
    elif name == "twolayer_sweep":
        m = tl.build(nx, ny, **kw)
        m.set_initial(gaussian_eta(nx, ny, amp=0.5),
                      -gaussian_eta(nx, ny, amp=2.0))
    elif name.startswith("tracer_sweep"):
        u, v = tr.streamfunction_velocities(gaussian_eta(nx, ny, amp=20.0,
                                                         width=0.2))
        m = tr.build(nx, ny, dt=0.2, u=u, v=v, kappa=0.02,
                     scheme=name.split()[1], **kw)
        m.set_initial_tracer(gaussian_eta(nx, ny, amp=1.0))
    else:
        m = nlm.build(nx, ny, layers=int(name.split("L=")[1]), **kw)
        m.set_initial(np.stack([gaussian_eta(nx, ny, amp=0.5 * (k + 1))
                                * (-1) ** k for k in range(m.layers)]))
    m.run(K + 1)
    return m


def _edge_schedule(kind, nx, ny, dtype):
    """(light sweep, its plain version, its planes, inner mask) of the
    PSy flagship (halo 8) or the levels=3 chain (halo 4) on an (ny, nx)
    grid, after the 4-step program's first run."""
    if kind == "psy":
        m = NemoLite2DPsy(nx, ny, halo_width=8, dtype=dtype, device=DEV)
        m.set_initial_ssh(gaussian_eta(nx, ny, amp=0.2))
        m.run(4, fused=True)
        sched, inner = m._sched, m.sshn_t.internal_mask.bool()
        rows = [tuple(float(v) for v in sched._user_scalar_vector(
            m._scalars_at(m._step)))]
    else:
        g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                     tdl.BC_NONE), tdl.OFFSET_NE,
                     dtype=dtype, device=DEV)
        g.decompose(nx, ny, ndomains=1, halo_width=LEVEL_HALO)
        tdl.grid_init(g, 1.0, 1.0)
        f = sc.ml_fields(g, 3)
        sched = km.Schedule(*sc.ml_calls(*f))
        sched.fused_program(4)()
        inner = f[0].internal_mask.bool()
        rows = [tuple(float(v) for v in sched._user_scalar_vector(None))]
    sweep, st_slots, x_slots = sched._fused_prog(4, 1)[3]["light"]
    psweep = sched._fused_prog(4, 1, True)[3]["light"][0]
    ro_slots = sched._fused_prog(4, 1)[2]
    slot = lambda i: sched._slots[i].data  # noqa: E731
    planes = lambda idx: tuple(  # noqa: E731
        p for i in idx for p in ((slot(i),) if slot(i).dim() == 2
                                 else slot(i).unbind(0)))
    args = (planes(st_slots), planes(ro_slots), planes(x_slots), rows)
    return sweep, psweep, args, inner


def phase_skeleton_edges() -> None:
    """Every kernel on the skeleton (csrc/stencil_sweep.cuh) against its
    plain version, one sweep, bitwise on internal points, on the blocks of
    EDGE_SHAPES: the four client models (the tracer with both schemes),
    the N-layer model (3 layers, compiled; 9, run-time), the Chebyshev
    sweep, and the generated schedule sweeps of the PSy flagship and the
    levels=3 chain."""
    clients = ("gravity_wave_sweep", "shallow_sweep", "twolayer_sweep",
               "tracer_sweep upwind", "tracer_sweep vanleer",
               "nlayer_sweep L=3", "nlayer_sweep L=9")
    main_k = {"tracer_sweep vanleer": 4}
    report = []
    for ny, nx, dtype, K_edge in EDGE_SHAPES:
        n = 0
        for name in clients:
            K = K_edge or main_k.get(name, 8)
            m = _edge_client(name, nx, ny, K, dtype)
            kern = m.sweep_kernel
            flat = tuple(getattr(m, f).data for f in m._fields)
            before = kern.launches
            ker = m._make_sweep(K)(flat, m._sweep_aux)
            ref = stencil_sweep_reference(m._sweep_step, K, flat,
                                          m._prepare(m._sweep_aux))
            d = _internal_max_abs(m.grid, ker, ref)
            if kern.launches - before != 1 or d != 0.0:
                raise AssertionError(f"{name} {ny}x{nx} {dtype} K={K}: one "
                                     f"sweep kernel vs plain {d:.3e}, "
                                     "expected bitwise")
            n += 1
        K = K_edge or 4
        g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                     tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                     device=DEV)
        tmask = gw.default_tmask(nx, ny)
        tmask[ny * 5 // 16: ny * 15 // 32, nx * 25 // 64: nx * 5 // 8] = 0
        g.decompose(nx, ny, ndomains=1, halo_width=K)
        tdl.grid_init(g, 1.0, 1.0, tmask)
        s = so.HelmholtzSolver(g, 6.0, 4.0, method="chebyshev",
                               steps_per_exchange=K, fused=True)
        sc_ = so.chebyshev_scalars(*s._lam_bounds, 4 * K)[:K]
        rng = np.random.default_rng(K)
        state = tuple(torch.from_numpy(rng.standard_normal(
            g.array_shape)).to(DEV, dtype) for _ in range(3))
        before = so.helmholtz_cheb_sweep.launches
        ker = s._make_cheb_sweep(K)(*state, sc_)
        ref = stencil_sweep_reference(
            so.cheb_step, K, state, so.cheb_prepare(s._codes, 6.0, 4.0, dtype),
            scalars=[tuple(r) for r in sc_])
        d = _internal_max_abs(g, ker, ref)
        if so.helmholtz_cheb_sweep.launches - before != 1 or d != 0.0:
            raise AssertionError(f"helmholtz_cheb_sweep {ny}x{nx} {dtype} "
                                 f"K={K}: {d:.3e}, expected bitwise")
        n += 1
        for kind in ("psy", "levels"):
            sweep, psweep, args, inner = _edge_schedule(kind, nx, ny, dtype)
            before = ss.schedule_sweep.launches
            ker, ref = sweep(*args), psweep(*args)
            d = max(float((a - b).abs()[inner].max()) for a, b in zip(ker,
                                                                      ref))
            if ss.schedule_sweep.launches - before != 1 or d != 0.0:
                raise AssertionError(f"schedule sweep ({kind}) {ny}x{nx} "
                                     f"{dtype}: {d:.3e}, expected bitwise")
            n += 1
        report.append(f"{ny}x{nx} {str(dtype)[6:]} "
                      f"{'K=' + str(K_edge) if K_edge else 'main K'}: {n}")
    print("skeleton edge shapes: one sweep kernel vs plain bitwise on "
          "internal points (gravity wave, shallow, two-layer, tracer "
          "upwind and van Leer, N-layer 3 and 9 layers, Chebyshev, PSy and "
          "levels=3 schedule sweeps), cases per grid: " + "; ".join(report),
          flush=True)


# --- the halo-exchange transports and variable bathymetry -----------------

#: (ndomainx, ndomainy) of the exchange's parity sweep
EXCH_TILES = ((1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (4, 4))
EXCH_WRAPS = ((False, False), (True, False), (False, True), (True, True))


def _exch_grid(ndx, ndy, wrap, halo, n=None, ny=None):
    """A grid on the card; without ``n``, a small one whose walled axes
    carry a remainder (padding in the last tile)."""
    bc = [tdl.BC_PERIODIC if w else tdl.BC_EXTERNAL for w in wrap]
    g = tdl.Grid(tdl.ARAKAWA_C, (bc[0], bc[1], tdl.BC_NONE), tdl.OFFSET_NE,
                 dtype=torch.float32, device=DEV)
    gnx = n if n is not None else 6 * ndx + (0 if wrap[0] else 1)
    gny = ny or n or 5 * ndy + (0 if wrap[1] else 2)
    g.decompose(gnx, gny, ndomainx=ndx, ndomainy=ndy, halo_width=halo)
    tdl.grid_init(g, 1.0, 1.0)
    return g


def _unique_block(shape, dtype, seed=0):
    """Distinct values per cell, permuted from a seed (exact in f32 and
    int32 below 2**24)."""
    n = int(np.prod(shape))
    vals = np.random.default_rng(seed).permutation(n).reshape(shape)
    return torch.from_numpy(vals).to(DEV, dtype)


def _words16(spec, dtype) -> bool:
    """Whether the exchange kernel moves this block's rows in 16-byte
    words (csrc/halo_exchange.cu: rows a whole number of them; the
    caching allocator's blocks are 16-byte aligned), else elements."""
    es = torch.empty((), dtype=dtype).element_size()
    return spec.array_shape[1] * es % 16 == 0


def phase_exchange_parity() -> None:
    """Both forms of the exchange kernel against the plain exchange and
    the gather of exchange_index on the card, bitwise on every cell: the
    functional form on every case, and the field's exchange
    (remote_dma_exchange) on a clone, which takes the ring form in place
    wherever ring_in_place holds and the functional form elsewhere (the
    launch counters show which ran; the ring form refuses the rest)."""
    fun, ring = hk.halo_exchange, hk.halo_exchange_ring
    f0, r0 = fun.launches, ring.launches
    cases, n_ring, n_fun = 0, 0, 0
    words = {"16-byte": 0, "element": 0}
    for ndx, ndy in EXCH_TILES:
        for wrap in EXCH_WRAPS:
            for halo in (1, 2, 8):
                spec = _exch_grid(ndx, ndy, wrap, halo).halo_spec
                for depth in range(1, halo + 1):
                    rows, cols = halo_mod.exchange_index(spec, depth, DEV)
                    in_place = hk.ring_in_place(spec, depth)
                    for dtype in (torch.float32, torch.float64, torch.int32):
                        for lead in ((), (3,)):
                            a = _unique_block(lead + spec.array_shape, dtype,
                                              cases)
                            want = halo_mod._exchange_blocks((a,), spec,
                                                             depth)[0]
                            gather = a.index_select(-2, rows).index_select(
                                -1, cols)
                            got = fun(a, spec, depth)
                            blk = a.clone()
                            before = (fun.launches, ring.launches)
                            res = hk.remote_dma_exchange(blk, spec, depth)
                            took = (fun.launches - before[0],
                                    ring.launches - before[1])
                            tag = (f"{ndx}x{ndy} wrap={wrap} halo={halo} "
                                   f"depth={depth} {dtype} lead={lead}")
                            if took != ((0, 1) if in_place else (1, 0)) or (
                                    (res is blk) != in_place):
                                raise AssertionError(
                                    f"exchange {tag}: launches (functional, "
                                    f"ring) {took}, in place {res is blk}; "
                                    f"ring_in_place says {in_place}")
                            if not (torch.equal(got, want)
                                    and torch.equal(got, gather)
                                    and torch.equal(res, want)):
                                raise AssertionError(
                                    f"exchange kernel {tag}: not bitwise "
                                    f"equal")
                            cases += 1
                            n_ring += in_place
                            n_fun += 1 + (not in_place)
                            words["16-byte" if _words16(spec, dtype)
                                  else "element"] += 1
                    if not in_place:
                        try:
                            ring(_unique_block(spec.array_shape,
                                               torch.float32), spec, depth)
                        except ValueError:
                            pass
                        else:
                            raise AssertionError(
                                f"the ring form took depth {depth} on "
                                f"{ndx}x{ndy} tiles of {spec.tile_ny}x"
                                f"{spec.tile_nx} at halo {halo}")
    torch.cuda.synchronize()
    if (fun.launches - f0, ring.launches - r0) != (n_fun, n_ring):
        raise AssertionError("exchange parity did not go through the kernels")
    if not (n_ring and cases - n_ring and all(words.values())):
        raise AssertionError(f"exchange parity missed a path: {n_ring} ring"
                             f" cases of {cases}, rows by {words}")

    # the kernel path never calls the plain exchange
    g = _exch_grid(2, 2, (True, True), 2, n=32)
    vals = np.random.default_rng(7).standard_normal((3, 32, 32))
    fa = tdl.Field(g, tdl.T_POINTS, init_global_data=vals, levels=3)
    fb = tdl.Field(g, tdl.T_POINTS, init_global_data=vals, levels=3)
    fb.halo_exchange(2)
    ptr = fa.data.data_ptr()
    _plain_exchange_refused(lambda: fa.halo_exchange(2, transport="remote_dma"))
    if not torch.equal(fa.data, fb.data) or fa.data.data_ptr() != ptr:
        raise AssertionError("Field.halo_exchange remote_dma != ppermute, or"
                             " not in place")
    print(f"halo_exchange parity: both forms vs plain exchange and vs the "
          f"exchange_index gather, {cases} cases ({len(EXCH_TILES)} tilings,"
          f" walled / x / y / xy periodic, halo 1, 2, 8 at every depth, "
          f"f32, f64, int32, 2D and 3 levels; rows moved in "
          f"{words['16-byte']} cases by 16-byte words, in "
          f"{words['element']} by elements): bitwise on every cell; the "
          f"field's exchange took the ring form in place in {n_ring} cases "
          f"and the functional form in {cases - n_ring} (depth > tile "
          f"extent, where the ring form refuses); functional launches "
          f"{n_fun}, ring launches {n_ring}; Field.halo_exchange(transport="
          f"'remote_dma') with the plain exchange raising: equal to "
          f"ppermute, in place", flush=True)


def _bathymetry(n, seed=11):
    """A seeded positive depth plane, 50-150 m."""
    return 50.0 + 100.0 * np.random.default_rng(seed).random((n, n))


def phase_ht_parity() -> None:
    n, steps, worst, cases = PARITY_N, 101, 0.0, 0
    depth = _bathymetry(n)
    for dtype in (torch.float64, torch.float32):
        for ndom in (1, 4):
            for K in (1, 2, 3, 4):
                ms = []
                for fused in (True, False):
                    m = nl.build(n, n, ndomains=ndom, fused=fused,
                                 steps_per_sweep=K, halo_width=2 * K,
                                 depth=depth, dtype=dtype, device=DEV)
                    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
                    ms.append(m)
                before = fs.nemolite2d_sweep.launches
                ms[0].run(steps)
                if (fs.nemolite2d_sweep.launches - before
                        != steps // K + steps % K):
                    raise AssertionError(f"ht K={K}: the fused run did not "
                                         "go through the kernel")
                ms[1].run(steps)
                ga, gb = ms[0].gather(), ms[1].gather()
                d = max(float(np.abs(ga[k] - gb[k]).max()) for k in ga)
                if d != 0.0 or not all(np.isfinite(ga[k]).all() for k in ga):
                    raise AssertionError(
                        f"ht kernel vs plain {dtype} ndomains={ndom} K={K}: "
                        f"max abs {d:.3e}, expected bitwise")
                worst, cases = max(worst, d), cases + 1
    print(f"nemolite2d_sweep ht parity: kernel vs plain {n}^2, seeded depth "
          f"50-150 m, {cases} cases (f64 and f32, K=1..4, ndomains 1 and 4),"
          f" {steps} steps: max abs {worst:.3e} (bitwise required)",
          flush=True)


def _flagship(n, ndx, ndy, K, dtype, transport=None, depth=100.0, halo=8,
              dx=1000.0, dy=1000.0):
    """The flagship on ``ndx`` x ``ndy`` tiles at halo ``halo`` with
    ``dx`` x ``dy`` cells: on the kernel with ``transport``, else on the
    plain path at K steps per exchange."""
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                 device=DEV)
    g.decompose(n, n, ndomainx=ndx, ndomainy=ndy, halo_width=halo)
    tdl.grid_init(g, dx, dy, nl.default_tmask(n, n))
    m = nl.NemoLite2D(g, depth=depth)
    if transport is None:
        m.set_steps_per_exchange(K)
    else:
        m.enable_fast_path(K, transport=transport)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    return m


def phase_fused_transport() -> None:
    n, steps = PARITY_N, 101
    worst, worst_plain, cases = 0.0, 0.0, 0
    for dtype in (torch.float64, torch.float32):
        for ndx, ndy in ((1, 1), (2, 2), (4, 1), (1, 4)):
            for K in (1, 2, 3, 4):
                mf = _flagship(n, ndx, ndy, K, dtype, "fused")
                mp = _flagship(n, ndx, ndy, K, dtype, "ppermute")
                before = fs.nemolite2d_sweep.launches
                mf.run(steps)
                if (fs.nemolite2d_sweep.launches - before
                        != steps // K + steps % K):
                    raise AssertionError("fused transport did not go "
                                         "through the kernel")
                mp.run(steps)
                ga, gb = mf.gather(), mp.gather()
                d = max(float(np.abs(ga[k] - gb[k]).max()) for k in ga)
                if d != 0.0:
                    raise AssertionError(
                        f"fused vs ppermute {dtype} {ndx}x{ndy} K={K}: max "
                        f"abs {d:.3e}, expected bitwise")
                if dtype == torch.float64:
                    ml = _flagship(n, ndx, ndy, K, dtype)
                    ml.run(steps)
                    dp = _rel_diff(ga, ml.gather())
                    if not dp <= TOL_F64:
                        raise AssertionError(
                            f"fused vs plain f64 {ndx}x{ndy} K={K}: {dp:.3e}")
                    worst_plain = max(worst_plain, dp)
                worst, cases = max(worst, d), cases + 1
    # one fused sweep on periodic grids (the 1x1 case is the JAX
    # package's self-loopback) equals the exchange followed by the sweep
    p, loop = nl.Params(), 0
    for ndx, ndy in ((1, 1), (2, 2)):
        for dtype in (torch.float64, torch.float32):
            g = _exch_grid(ndx, ndy, (True, True), 8, n=64)
            spec = g.halo_spec
            rng = np.random.default_rng(ndx)
            state = [torch.from_numpy(a * rng.standard_normal(
                g.array_shape)).to(DEV, dtype) for a in (0.2, 0.05, 0.05)]
            codes = nl.encode_masks(g.tmask).contiguous()
            fcor = float(2.0 * p.omega * np.sin(50.0 * p.d2r))
            forcing = [0.01, 0.02, 0.03, 0.04]
            for K in (1, 4):
                mk = functools.partial(fs.make_fused_step, *g.array_shape,
                                       dtype, p, 1000.0, 1000.0, fcor, 100.0,
                                       steps_per_sweep=K)
                got = mk(exchange_spec=spec)(*state, codes, forcing[:K])
                ex = [halo_mod.exchange(a, spec, spec.halo) for a in state]
                want = mk()(*ex, codes, forcing[:K])
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"fused sweep on a periodic {ndx}x"
                                         f"{ndy} grid {dtype} K={K} != "
                                         "exchange + sweep")
                loop += 1
    print(f"fused transport: flagship {n}^2 halo 8, {cases} cases (f64 and "
          f"f32; 1, 2x2, 4x1, 1x4 tiles; K=1..4; {steps} steps): fused vs "
          f"ppermute on the kernel max abs {worst:.3e} on internal points "
          f"(bitwise required); f64 fused vs plain max rel diff "
          f"{worst_plain:.3e} (tol {TOL_F64}); {loop} periodic sweeps "
          f"(1x1 and 2x2, f64 and f32, K 1 and 4) equal to exchange + sweep "
          f"on every cell", flush=True)


def _plain_exchange_refused(fn):
    """Run ``fn`` with the plain exchange replaced by a function that
    raises."""
    saved = halo_mod._exchange_blocks

    def refuse(*args, **kwargs):
        raise AssertionError("the plain exchange ran on the kernel path")
    halo_mod._exchange_blocks = hk._exchange_blocks = refuse
    try:
        return fn()
    finally:
        halo_mod._exchange_blocks = hk._exchange_blocks = saved


def _gather_ms(a, spec, depth, want, reps) -> float:
    """ms of the library call for the exchange: one ``aten::index`` of
    ``a`` by the row and column maps of ``exchange_index``, made once
    beforehand as a kernel's constants are (the port never calls it)."""
    rows, cols = halo_mod.exchange_index(spec, depth, DEV)
    rows = rows[:, None]
    if not torch.equal(a[..., rows, cols], want):
        raise AssertionError("the exchange_index gather != plain exchange")
    return _time_ms(lambda: a[..., rows, cols], reps)


def _exchange_times(a, f, spec, depth, want, plain_reps) -> dict:
    """ms of both forms of the exchange on the block ``a`` (the functional
    form) and on the field ``f`` (Field.halo_exchange, the ring form in
    place): the card's time as a CUDA graph of 20 calls (device_ms) and
    one wrapper call (ms); the plain exchange, the exchange_index gather
    (library_ms) and each form's byte bound (functional: the block read
    and written; ring: its ring, the cells the map moves)."""
    def functional():
        return hk.exchange_kernel(a, spec, depth)

    def field():
        f.halo_exchange(depth, transport="remote_dma")
    rows, cols = halo_mod.exchange_index(spec, depth, DEV)
    moved = ((rows != torch.arange(rows.numel(), device=DEV))[:, None]
             | (cols != torch.arange(cols.numel(), device=DEV)))
    ring_bytes = int(moved.sum()) * a.numel() // moved.numel() * \
        a.element_size()
    row = {"ms": _time_ms(functional, 200),
           "device_ms": _device_ms(functional, 20),
           "ring_ms": _time_ms(field, 200),
           "ring_device_ms": _device_ms(field, 20),
           "plain_ms": _time_ms(lambda: halo_mod.exchange(a, spec, depth),
                                plain_reps),
           "library_ms": _gather_ms(a, spec, depth, want, 200),
           "bound_ms": _bound(2 * _nbytes(a), 0, a.dtype)["bound_ms"],
           "ring_bound_ms": _bound(2 * ring_bytes, 0, a.dtype)["bound_ms"]}
    if not torch.equal(f.data, want):
        raise AssertionError("the timed ring exchanges changed the field")
    row["text"] = (
        f"functional {row['device_ms'] * 1e3:.2f} us on the card (CUDA "
        f"graph; wrapper call {row['ms'] * 1e3:.2f} us, bound "
        f"{row['bound_ms'] * 1e3:.2f} us), ring in place "
        f"{row['ring_device_ms'] * 1e3:.2f} us (wrapper call "
        f"{row['ring_ms'] * 1e3:.2f} us, bound "
        f"{row['ring_bound_ms'] * 1e3:.3f} us), plain "
        f"{row['plain_ms'] * 1e3:.2f} us, index gather "
        f"{row['library_ms'] * 1e3:.2f} us")
    return row


def _exchange_entries(row: dict, fun_launches: int,
                      ring_launches: int) -> list:
    """The two kernel entries of the exchange: the functional form and
    the ring form, from one row of _exchange_times."""
    base = {"route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/halo_exchange.cu",
            "replaces": "dl_esm_inf_tpu/parallel/halo_pallas.py:46",
            "max_abs_err": 0.0, "plain_ms": row["plain_ms"],
            "library_ms": row["library_ms"], "bound_by": "bytes"}
    return [{"name": "halo_exchange", **base, "launches": fun_launches,
             "ms": row["ms"], "device_ms": row["device_ms"],
             "bound_ms": row["bound_ms"]},
            {"name": "halo_exchange_ring", **base,
             "launches": ring_launches, "ms": row["ring_ms"],
             "device_ms": row["ring_device_ms"],
             "bound_ms": row["ring_bound_ms"]}]


def _program_ops(m, n) -> int:
    """Arithmetic element-operations (``_count_ops``) of the model's
    n-step program beyond its forcing series (the host-side bc_ssh
    values).  Copies and slices count nothing, so this does not show the
    plain exchange absent: ``_plain_exchange_refused`` does."""
    prog = m.step_program(n)
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    bathy = (m._ht,) if m._ht is not None else ()
    return (_count_ops(lambda: prog(m._istep0, state, m._mask_codes, *bathy))
            - _count_ops(lambda: m.forcing_series(m._istep0, n)))


def _flagship_entry(m, K, launches, name, replaces, extra_bytes=()):
    """One sweep of the model's kernel against its plain version on the
    main path's state: the kernel entry of the JSON line."""
    fused = m._make_fused(K)
    forcing = m.forcing_series(m._istep0, K)
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    codes, ht = m._mask_codes, m._ht
    spec = m.grid.halo_spec if m._in_sweep_exchange else None

    def plain():
        s = (exchange_multi_fn(spec, spec.halo)(state) if spec is not None
             else state)
        return fs.fused_step_reference(*s, codes, forcing, p=m.p,
                                       dx=m.grid.dx, dy=m.grid.dy,
                                       fcor=m._fcor, depth=m.depth or 0.0,
                                       ht=ht)
    ker = fused(*state, codes, forcing, ht=ht)
    ref = plain()
    inner = m.sshn_t.internal_mask.bool()
    max_abs = max(float((a - b).abs()[inner].max()) for a, b in zip(ker, ref))
    if max_abs != 0.0:
        raise AssertionError(f"{name} one sweep kernel vs plain: "
                             f"{max_abs:.3e}, expected bitwise")
    ms = _time_ms(lambda: fused(*state, codes, forcing, ht=ht), 200)
    plain_ms = _time_ms(plain, 20)
    ops = _count_ops(plain)
    return {"name": name, "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/nemolite2d_sweep.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **_bound(_nbytes(*state, codes, *extra_bytes, *ker), ops,
                     state[0].dtype)}


def _exchange_main(N: int) -> list:
    """The standalone exchange's main paths at N^2 float32, halo 8:
    Field.halo_exchange(transport="remote_dma") (the ring form, in place)
    and a user's own make_block_exchange (the functional form), each with
    both launch counts zeroed just before it; both forms timed there and
    at (4N)^2.  Returns the two kernel entries."""
    configs = [((1, 1), (True, True), 8), ((2, 2), (False, False), 1),
               ((2, 2), (False, False), 8), ((4, 4), (False, False), 1),
               ((4, 4), (False, False), 8)]
    fun, ring = hk.halo_exchange, hk.halo_exchange_ring
    fields, report = [], []
    for tiles, wrap, depth in configs:
        g = _exch_grid(*tiles, wrap, 8, n=N)
        for levels in (None, 3):
            lead = () if levels is None else (levels,)
            f = tdl.Field(g, tdl.T_POINTS, levels=levels)
            f.data = _unique_block(lead + g.array_shape, torch.float32)
            # the block before the exchange: f.data is exchanged in place
            fields.append((tiles, wrap, depth, levels, f, f.data.clone(),
                           f.data.data_ptr()))
    fun.launches = ring.launches = 0
    for _, _, depth, _, f, _, _ in fields:
        f.halo_exchange(depth, transport="remote_dma")
    torch.cuda.synchronize()
    ring_launches = (fun.launches, ring.launches)
    if ring_launches != (0, len(fields)):
        raise AssertionError(f"Field.halo_exchange launched (functional, "
                             f"ring) {ring_launches} for {len(fields)} calls")
    fn_outs = []
    fun.launches = ring.launches = 0
    for _, _, depth, levels, f, a, _ in fields:
        lead = () if levels is None else (levels,)
        fn_outs.append(hk.make_block_exchange(f.grid.halo_spec, depth,
                                              lead)(a))
    torch.cuda.synchronize()
    fun_launches = (fun.launches, ring.launches)
    if fun_launches != (len(fields), 0):
        raise AssertionError(f"make_block_exchange launched (functional, "
                             f"ring) {fun_launches} for {len(fields)} calls")
    for (tiles, wrap, depth, levels, f, a, ptr), fn_out in zip(fields,
                                                              fn_outs):
        spec = f.grid.halo_spec
        want = halo_mod.exchange(a, spec, depth)
        if not (torch.equal(f.data, want) and torch.equal(fn_out, want)):
            raise AssertionError(f"exchange {tiles} depth {depth} levels "
                                 f"{levels}: kernel != plain")
        if f.data.data_ptr() != ptr:
            raise AssertionError(f"exchange {tiles} depth {depth}: the field"
                                 f" was not exchanged in place")
        row = _exchange_times(a, f, spec, depth, want, plain_reps=50)
        report.append(f"{tiles[0]}x{tiles[1]}{' periodic' if wrap[0] else ''}"
                      f" depth {depth} {'2D' if levels is None else '3 levels'}"
                      f": {row['text']}")
        if (tiles, depth, levels) == ((2, 2), 8, None):
            main_row = row
    ex_entries = _exchange_entries(main_row, fun_launches[0],
                                   ring_launches[1])
    print(f"halo_exchange main f32 {N}^2 halo 8: Field.halo_exchange("
          f"transport='remote_dma') {len(fields)} calls, ring launches "
          f"{ring_launches[1]}, functional {ring_launches[0]}, each in place;"
          f" make_block_exchange {len(fields)} calls, functional launches "
          f"{fun_launches[0]}, ring {fun_launches[1]}; both bitwise equal to "
          f"the plain exchange; " + "; ".join(report), flush=True)
    # a block large enough for the kernels' own time to show past the
    # host's cost of a call, and past the L2
    big = 4 * N
    g = _exch_grid(2, 2, (False, False), 8, n=big)
    spec = g.halo_spec
    f = tdl.Field(g, tdl.T_POINTS)
    f.data = _unique_block(spec.array_shape, torch.float32)
    a = f.data.clone()
    want = halo_mod.exchange(a, spec, 8)
    f.halo_exchange(8, transport="remote_dma")
    if not (torch.equal(hk.exchange_kernel(a, spec, 8), want)
            and torch.equal(f.data, want)):
        raise AssertionError(f"exchange {big}^2: kernel != plain")
    row = _exchange_times(a, f, spec, 8, want, plain_reps=20)
    for e in ex_entries:
        key = "" if e["name"] == "halo_exchange" else "ring_"
        e.update({f"{k}_4096": row[key + k] for k in (
            "ms", "device_ms", "bound_ms")}, library_ms_4096=row["library_ms"],
            plain_ms_4096=row["plain_ms"], max_abs_err_4096=0.0)
    print(f"halo_exchange f32 {big}^2 2x2 halo 8 depth 8: {row['text']} "
          f"(functional {2 * _nbytes(a) / row['device_ms'] / 1e6:.0f} GB/s);"
          f" bitwise equal", flush=True)
    return ex_entries


def phase_transport_main() -> list:
    N, K, n = MAIN_SIZE, 4, 400
    kernels = []
    # the fused transport: the flagship in 2x2 tiles at K = 4
    mf = _flagship(N, 2, 2, K, torch.float32, "fused")
    mp = _flagship(N, 2, 2, K, torch.float32, "ppermute")
    mf.run(K)                                   # build before the count
    mp.run(K)
    torch.cuda.synchronize()
    fs.nemolite2d_sweep.launches = hk.halo_exchange.launches = 0
    hk.halo_exchange_ring.launches = 0
    _plain_exchange_refused(lambda: mf.run(n))
    torch.cuda.synchronize()
    launches, ex_launches = (fs.nemolite2d_sweep.launches,
                             (hk.halo_exchange.launches,
                              hk.halo_exchange_ring.launches))
    if launches != n // K:
        raise AssertionError(f"fused transport main path launched "
                             f"{launches} sweeps, expected {n // K}")
    for t in (mf.sshn_t.data, mf.un.data, mf.vn.data):
        if not torch.isfinite(t).all():
            raise AssertionError("fused transport state is not finite")
    mp.run(n)
    d = _rel_diff(mf.gather(), mp.gather())
    if d != 0.0:
        raise AssertionError(f"fused vs ppermute after {n} steps: {d:.3e}")
    ops_f, ops_p = _program_ops(mf, n), _program_ops(mp, n)
    if ops_f != 0:
        raise AssertionError(f"the fused program ran {ops_f} arithmetic "
                             "element-operations besides its forcing")
    us_f = _run_step_us(mf, n, 5)
    us_p = _run_step_us(mp, n, 5)
    us_f2 = _run_step_us(mf, n, 5)
    us_p2 = _run_step_us(mp, n, 5)
    print(f"fused transport main f32 {N}^2 2x2 tiles K={K}: run({n}) "
          f"launches={launches} (= {n}/{K}), exchange-kernel launches "
          f"(functional, ring) {ex_launches} (the trailing face-ssh "
          f"exchange, in place), plain exchange "
          f"raising throughout; fused vs ppermute after {n} steps rel "
          f"{d:.3e}; arithmetic element-operations of the {n}-step program "
          f"besides the forcing: fused {ops_f}, ppermute {ops_p}", flush=True)
    print(f"fused transport timing f32 {N}^2 2x2 K={K}: run on the kernel "
          f"with the fused transport {us_f:.2f} / {us_f2:.2f} us/step, with "
          f"the ppermute transport {us_p:.2f} / {us_p2:.2f} us/step (order "
          f"fused, ppermute, fused, ppermute)", flush=True)
    for ndx, ndy in ((1, 1), (4, 4)):
        pair = [_flagship(N, ndx, ndy, K, torch.float32, t)
                for t in ("fused", "ppermute")]
        us = [_run_step_us(mm, n, 5) for mm in pair + pair]
        print(f"fused transport timing f32 {N}^2 {ndx}x{ndy} K={K}: fused "
              f"{us[0]:.2f} / {us[2]:.2f} us/step, ppermute {us[1]:.2f} / "
              f"{us[3]:.2f} us/step (same order)", flush=True)
    entry = _flagship_entry(mf, K, launches, "nemolite2d_sweep_exchange",
                            "dl_esm_inf_tpu/ops/sweep.py:164")
    sweep_pp = _time_ms(lambda: mp._make_fused(K)(*exchange_multi_fn(
        mp.grid.halo_spec, 2 * K)((mp.sshn_t.data, mp.un.data, mp.vn.data)),
        mp._mask_codes, [0.0] * K), 200)
    print(f"fused transport one sweep f32 {N}^2 2x2 K={K}: kernel with the "
          f"exchange {entry['ms'] * 1e3:.2f} us, plain exchange + kernel "
          f"{sweep_pp * 1e3:.2f} us, plain version "
          f"{entry['plain_ms'] * 1e3:.2f} us; bound "
          f"{entry['bound_ms'] * 1e3:.2f} us", flush=True)
    kernels.append(entry)

    # variable bathymetry on the kernel: the flagship, 1 tile, K = 4
    mh = nl.build(N, N, fused=True, steps_per_sweep=K, depth=_bathymetry(N),
                  device=DEV)
    mh.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    mh.run(K)
    torch.cuda.synchronize()
    fs.nemolite2d_sweep.launches = 0
    mh.run(n)
    torch.cuda.synchronize()
    launches = fs.nemolite2d_sweep.launches
    if launches != n // K:
        raise AssertionError(f"ht main path launched {launches} sweeps")
    if not all(torch.isfinite(t).all()
               for t in (mh.sshn_t.data, mh.un.data, mh.vn.data)):
        raise AssertionError("ht main path state is not finite")
    mhp = nl.build(N, N, fused=False, steps_per_sweep=K,
                   depth=_bathymetry(N), device=DEV)
    mhp.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    mhp.run(n + K)
    d = _rel_diff(mh.gather(), mhp.gather())
    if d != 0.0:
        raise AssertionError(f"ht kernel vs plain after {n + K} steps "
                             f"{d:.3e}")
    us_h = _run_step_us(mh, n, 5)
    us_hp = _run_step_us(mhp, 40, 3)
    entry = _flagship_entry(mh, K, launches, "nemolite2d_sweep_ht",
                            "dl_esm_inf_tpu/ops/pallas_step.py:33",
                            (mh._ht,))
    print(f"ht main f32 {N}^2 K={K}: run({n}) launches={launches}; finite; "
          f"kernel vs plain after {n + K} steps rel {d:.3e}; run on the "
          f"kernel {us_h:.2f} us/step, plain {us_hp:.2f} us/step; one sweep "
          f"{entry['ms'] * 1e3:.2f} us, plain {entry['plain_ms'] * 1e3:.2f} "
          f"us, bound {entry['bound_ms'] * 1e3:.2f} us", flush=True)
    kernels.append(entry)

    kernels.extend(_exchange_main(N))

    # the example model on the card, both transports
    for ndom in (1, 2, 4):
        want = None
        for transport in ("ppermute", "remote_dma"):
            sums = exm.run(4, 10, ndomains=ndom, device=DEV,
                           transport=transport)
            g = tdl.Grid(device=DEV)
            g.decompose(4, 10, ndomains=ndom)
            tdl.grid_init(g, 1.0, 1.0)
            want = exm.expected_checksum(tdl.Field(g, tdl.T_POINTS))
            if not all(v == want for v in sums.values()):
                raise AssertionError(f"example model ndomains={ndom} "
                                     f"{transport}: {sums} != {want}")
    print("example model on the card: ndomains 1, 2, 4 under both "
          "transports, checksums equal to the analytic ones", flush=True)
    return kernels


# --- the kernel-variant microbench, rectangular cells, the utilities ------

#: compute_fast vs its plain version (exact reciprocal, one Newton step):
#: max |diff| on internal points over the field's max |value|, per pass
#: of the K sub-steps (the approximate reciprocal's last bits, fed back)
TOL_FAST = 1e-6
#: passes of the compute variants' kernel entries (K = 4: 32 steps)
VAR_REPS = 8


def _graph_ms(fn, n: int) -> float:
    """ms per call of ``fn`` from one CUDA graph of ``n`` calls replayed
    under CUDA events: the card's time, without the host's cost of a
    call (a ``dma`` sweep is shorter than that cost)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * n)


def _max_abs(a, b, where=None) -> float:
    return max(float((x - y).abs().max() if where is None
                     else (x - y).abs()[where].max()) for x, y in zip(a, b))


def _sass_loads(lib: Path) -> dict:
    """Per kernel in the library's SASS (cuobjdump): the byte loads from
    global memory (LDG .U8/.S8, the clamped scalar staging of the code
    plane) and the 16-byte asynchronous copies global -> shared (LDGSTS
    .128, the cp.async staging of interior CTAs)."""
    from dl_esm_inf_tpu_torch.ops.cuda_build import find_nvcc
    tool = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        out[name] = (len(re.findall(r"LDG\.E\.(?:U|S)8", part)),
                     len(re.findall(r"LDGSTS[.\w]*\.128", part)))
    return out


def phase_variants_parity() -> None:
    """The dma and compute variant kernels against their plain versions,
    compute(reps=1) against production, compute_fast within TOL_FAST; and
    the dma kernels' code loads in their SASS."""
    n, cases, worst_fast = PARITY_N, 0, 0.0
    kerns = fs.VARIANT_KERNELS.values()
    before = sum(k.launches for k in kerns)
    for dtype in (torch.float64, torch.float32):
        for ndom in (1, 4):
            m = nl.build(n, n, ndomains=ndom, fused=True, steps_per_sweep=4,
                         dtype=dtype, device=DEV)
            m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
            m.run(8)
            state = (m.sshn_t.data, m.un.data, m.vn.data)
            codes, inner = m._mask_codes, m.sshn_t.internal_mask.bool()
            args = (*m.grid.array_shape, dtype, m.p, m.grid.dx, m.grid.dy,
                    m._fcor, m.depth)
            plain = dict(p=m.p, dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                         depth=m.depth)
            for K in (1, 2, 3, 4):
                f = m.forcing_series(m._istep0, K)
                label = f"{dtype} ndomains={ndom} K={K}"
                prod = fs.make_fused_step(*args, steps_per_sweep=K)(
                    *state, codes, f)
                got = fs.make_variant(*args, K, "dma")(*state, codes, f)
                if _max_abs(got, fs.variant_dma_reference(*state, codes, f)):
                    raise AssertionError(f"dma kernel vs plain {label}: not "
                                         "bitwise")
                cases += 1
                for reps in (1, 3):
                    got = fs.make_variant(*args, K, "compute")(
                        *state, codes, f, reps=reps)
                    want = fs.variant_compute_reference(*state, codes, f,
                                                        reps, **plain)
                    if _max_abs(got, want):
                        raise AssertionError(f"compute kernel vs plain {label}"
                                             f" reps={reps}: not bitwise")
                    if reps == 1 and _max_abs(got, prod):
                        raise AssertionError(f"compute(reps=1) vs production "
                                             f"{label}: not bitwise")
                    cases += 1
                    if dtype != torch.float32:
                        continue
                    got = fs.make_variant(*args, K, "compute_fast")(
                        *state, codes, f, reps=reps)
                    want = fs.variant_compute_reference(
                        *state, codes, f, reps, fast=True, **plain)
                    rel = (_max_abs(got, want, inner)
                           / max(float(w.abs()[inner].max()) for w in want))
                    if not rel <= TOL_FAST * reps:
                        raise AssertionError(f"compute_fast {label} reps="
                                             f"{reps}: {rel:.3e}")
                    worst_fast = max(worst_fast, rel / reps)
    torch.cuda.synchronize()
    if sum(k.launches for k in kerns) - before < cases:
        raise AssertionError("variant parity did not go through the kernels")
    loads = _sass_loads(fs.variant_dma.build().path)
    dma = {k: v for k, v in loads.items() if "nemo_dma_kernel" in k}
    prod = [v for k, v in _sass_loads(fs.nemolite2d_sweep.build().path)
            .items() if "nemo_sweep_kernel" in k]
    if len(dma) != 8 or min(b for b, _ in dma.values()) < 1 or min(
            c for _, c in dma.values()) < 1:
        raise AssertionError(f"dma kernels without the staging's byte loads "
                             f"or 16-byte copies: {dma}")
    print(f"variants parity: {cases} cases (dma; compute at reps 1 and 3; "
          f"f64 and f32, K=1..4, ndomains 1 and 4, {n}^2): kernel vs plain "
          f"bitwise on every cell, compute(reps=1) = production bitwise on "
          f"every cell; compute_fast vs plain max rel {worst_fast:.3e} per "
          f"pass on internal points (tol {TOL_FAST}); SASS: each of the 8 dma"
          f" kernels has {min(c for _, c in dma.values())}-"
          f"{max(c for _, c in dma.values())} 16-byte copies (LDGSTS .128, "
          f"interior CTAs) and {min(b for b, _ in dma.values())}-"
          f"{max(b for b, _ in dma.values())} byte loads (LDG .U8/.S8, edge "
          f"CTAs) of its staging; the production kernels "
          f"{min(c for _, c in prod)}-{max(c for _, c in prod)} and "
          f"{min(b for b, _ in prod)}-{max(b for b, _ in prod)}", flush=True)


#: rectangular cells of phase 16 (dx, dy), m
RECT_CELLS = ((1000.0, 1500.0), (1500.0, 1000.0))


def phase_rect_parity() -> None:
    """The flagship kernel on rectangular cells against the plain path,
    bitwise: flat, variable depth (HT) and the fused transport (EXCH)."""
    n, steps, cases = PARITY_N, 23, 0
    depth = _bathymetry(n)
    for dx, dy in RECT_CELLS:
        for dtype in (torch.float64, torch.float32):
            for ndx, ndy in ((1, 1), (2, 2)):
                for variant in ("flat", "ht", "exch"):
                    for K in (1, 2, 3, 4):
                        kw = dict(depth=depth if variant == "ht" else 100.0,
                                  dx=dx, dy=dy)
                        mk = _flagship(n, ndx, ndy, K, dtype, "fused"
                                       if variant == "exch" else "ppermute",
                                       **kw)
                        mp = _flagship(n, ndx, ndy, K, dtype, **kw)
                        before = fs.nemolite2d_sweep.launches
                        mk.run(steps)
                        if (fs.nemolite2d_sweep.launches - before
                                != steps // K + steps % K):
                            raise AssertionError("rectangular run did not go "
                                                 "through the kernel")
                        mp.run(steps)
                        ga, gb = mk.gather(), mp.gather()
                        d = max(float(np.abs(ga[k] - gb[k]).max()) for k in ga)
                        if d != 0.0 or not all(np.isfinite(ga[k]).all()
                                               for k in ga):
                            raise AssertionError(
                                f"rectangular dx/dy={dx}/{dy} {dtype} "
                                f"{ndx}x{ndy} {variant} K={K}: max abs "
                                f"{d:.3e}, expected bitwise")
                        cases += 1
    print(f"rectangular cells: flagship kernel vs plain {n}^2, dx/dy "
          f"1000/1500 and 1500/1000, {cases} cases (f64 and f32, 1 and 2x2 "
          f"tiles, flat / ht / fused transport, K=1..4), {steps} steps: "
          f"bitwise on internal points", flush=True)


def _ring_work(K: int) -> tuple[float, float]:
    """Points updated per sweep by continuity and by momentum over the
    tile's K sub-steps of points (the regions 2k+1 and 2k+2 inside the
    float32 tile's window, ty + 4K by tx + 4K)."""
    t = fs.tile(torch.float32, K)
    wy, wx = t.ty + 4 * K, t.tx + 4 * K

    def area(r):
        return (wy - 2 * r) * (wx - 2 * r)
    cont = sum(area(2 * k + 1) for k in range(K)) / (K * t.ty * t.tx)
    mom = sum(area(2 * k + 2) for k in range(K)) / (K * t.ty * t.tx)
    return cont, mom


def _variant_entries(m) -> list:
    """The three variant kernels' entries of the JSON line, on the
    kbench model's state: dma at K = 1 (its library call is three
    ``torch.add``), compute and compute_fast at K = 4 with VAR_REPS
    passes (bound by their operations: the plain step's element
    operations per point and step, times the points, K and the passes;
    no library call)."""
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    codes, inner = m._mask_codes, m.sshn_t.internal_mask.bool()
    args = (*m.grid.array_shape, m.grid.dtype, m.p, m.grid.dx, m.grid.dy,
            m._fcor, m.depth)
    plain_kw = dict(p=m.p, dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                    depth=m.depth)
    src = "dl_esm_inf_tpu_torch/csrc/nemolite2d_variants.cu"
    entries = []
    f1 = m.forcing_series(0, 1)
    var = fs.make_variant(*args, 1, "dma")
    ker = var(*state, codes, f1)
    max_abs = _max_abs(ker, fs.variant_dma_reference(*state, codes, f1))
    if max_abs != 0.0:
        raise AssertionError(f"dma entry: kernel vs plain {max_abs:.3e}")
    lib_ms = _graph_ms(lambda: [torch.add(x, f1[0]) for x in state], 50)
    ops = _count_ops(lambda: fs.variant_dma_reference(*state, codes, f1))
    entries.append({
        "name": "nemolite2d_variant_dma", "route": "cuda", "source": src,
        "replaces": "scripts/kbench.py:53 make_variant (dma)",
        "max_abs_err": max_abs,
        "ms": _graph_ms(lambda: var(*state, codes, f1), 50),
        "plain_ms": _time_ms(lambda: fs.variant_dma_reference(
            *state, codes, f1), 20),
        **_bound(_nbytes(*state, codes, *ker), ops, torch.float32),
        "library_ms": lib_ms, "K": 1})
    f4 = m.forcing_series(0, 4)
    ops_pp = _count_ops(lambda: fs.fused_step_reference(
        *state, codes, f4, **plain_kw)) / (4 * state[0].numel())
    for mode in ("compute", "compute_fast"):
        fast = mode == "compute_fast"
        var = fs.make_variant(*args, 4, mode)
        ker = var(*state, codes, f4, reps=VAR_REPS)
        want = fs.variant_compute_reference(*state, codes, f4, VAR_REPS,
                                            fast=fast, **plain_kw)
        if not all(bool(torch.isfinite(a).all()) for a in ker):
            raise AssertionError(f"{mode} entry: output not finite")
        max_abs = _max_abs(ker, want, inner)
        scale = max(float(w.abs()[inner].max()) for w in want)
        if max_abs > (TOL_FAST * VAR_REPS * scale if fast else 0.0):
            raise AssertionError(f"{mode} entry: kernel vs plain "
                                 f"{max_abs:.3e}")
        ops = ops_pp * state[0].numel() * 4 * VAR_REPS
        entries.append({
            "name": f"nemolite2d_variant_{mode}", "route": "cuda",
            "source": src,
            "replaces": f"scripts/kbench.py:53 make_variant ({mode})",
            "max_abs_err": max_abs,
            "ms": _graph_ms(lambda: var(*state, codes, f4, reps=VAR_REPS), 10),
            "plain_ms": _time_ms(lambda: fs.variant_compute_reference(
                *state, codes, f4, VAR_REPS, fast=fast, **plain_kw), 3),
            **_bound(_nbytes(*state, codes, *ker), int(ops), torch.float32),
            "K": 4, "reps": VAR_REPS, "ops_per_point": ops_pp})
    return entries


def phase_kbench() -> list:
    """The kbench path at 1024^2 f32 (prod, dma, compute, compute_fast at
    K = 1, 2, 4 and the split), the variants' kernel entries, the
    flagship CLI writing a history file, and a checkpoint round trip on
    the card."""
    import tempfile
    from dl_esm_inf_tpu_torch import kbench
    from dl_esm_inf_tpu_torch.utils import checkpoint, io as dio
    kerns = list(fs.VARIANT_KERNELS.values())
    torch.cuda.synchronize()
    for k in kerns:
        k.launches = 0
    res = kbench.main(["--n", str(MAIN_SIZE), "--ks", "1,2,4",
                       "--device", DEV.type])
    torch.cuda.synchronize()
    launches = {k.mode: k.launches for k in kerns}
    if min(launches.values()) < 1:
        raise AssertionError(f"kbench did not launch every variant: "
                             f"{launches}")
    for K, r in res.items():
        cont, mom = _ring_work(K)
        print(f"kbench split K={K}: prod {r['prod']:.3f} us/step = dma floor "
              f"{r['dma']:.3f} + compute floor {r['compute']:.3f} + remainder "
              f"{r['prod'] - r['dma'] - r['compute']:.3f}; compute_fast "
              f"{r['compute_fast']:.3f}; ring work continuity {cont:.2f}x, "
              f"momentum {mom:.2f}x the tile", flush=True)
    m = kbench._model(MAIN_SIZE, DEV)
    entries = _variant_entries(m)
    for e in entries:
        e["launches"] = launches[e["name"].removeprefix("nemolite2d_variant_")]
        print(f"{e['name']} f32 {MAIN_SIZE}^2 K={e['K']}: one launch "
              f"{e['ms'] * 1e3:.2f} us (CUDA graph), plain "
              f"{e['plain_ms'] * 1e3:.2f} us, bound {e['bound_ms'] * 1e3:.2f} "
              f"us by {e['bound_by']}"
              + (f", library {e['library_ms'] * 1e3:.2f} us"
                 if e["library_ms"] is not None else "")
              + (f", {e['ops_per_point']:.1f} operations per point and step"
                 if "ops_per_point" in e else "")
              + f"; kbench launches {e['launches']}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # the flagship CLI with a history file, read back
        path = str(Path(tmp) / "hist.nc")
        fs.nemolite2d_sweep.launches = 0
        nl.main(["258", "20", DEV.type, path])
        if fs.nemolite2d_sweep.launches != 5:
            raise AssertionError(f"CLI launched {fs.nemolite2d_sweep.launches}"
                                 " sweeps for 5 report intervals of 4 steps")
        d = dio.load_netcdf(path)
        if (d["dimensions"] != {"time": 5, "y": 258, "x": 258}
                or d["variables"]["time"].tolist() != [80.0 * i for i in
                                                       range(1, 6)]
                or not all(np.isfinite(d["variables"][k]).all()
                           for k in ("ssh", "u", "v"))):
            raise AssertionError(f"history file: {d['dimensions']}")
        # a checkpoint on the card: save, load, resume
        ck = str(Path(tmp) / "ck.npz")
        ms = [nl.build(PARITY_N, PARITY_N, fused=True, steps_per_sweep=4,
                       device=DEV) for _ in range(2)]
        ms[0].set_initial_ssh(gaussian_eta(PARITY_N, PARITY_N, amp=0.2))
        ms[0].run(21)
        checkpoint.save_model(ck, ms[0])
        meta = checkpoint.load_model(ck, ms[1])
        ga, gb = ms[0].gather(), ms[1].gather()
        if meta["step"] != 21 or ms[1]._istep0 != 21 or any(
                not np.array_equal(ga[k], gb[k]) for k in ga):
            raise AssertionError("checkpoint load is not bitwise")
        for mm in ms:
            mm.run(21)
        ga, gb = ms[0].gather(), ms[1].gather()
        if any(not np.array_equal(ga[k], gb[k]) for k in ga):
            raise AssertionError("the resumed run != the uninterrupted run")
    print(f"flagship CLI on the card: 258^2, 20 steps, history file of 5 "
          f"ssh/u/v records read back by load_netcdf; checkpoint save_model /"
          f" load_model at step 21 ({PARITY_N}^2 f32): bitwise, and the "
          f"resumed run equals the uninterrupted one bitwise after 21 more "
          f"steps", flush=True)
    return entries


#: the large flagship block of phase 17's last step: its sweep traffic
#: (~420 MB at float32, K = 4) does not fit the card's 50 MB L2
LARGE_SIZE = 4096


def phase_large(entries: list) -> None:
    """One sweep of the flagship kernel (K = 4) and one launch of the dma
    variant (K = 1) at 4096^2 float32, where the bytes, not the L2, set
    the bound: each against its plain version, its time beside its bound
    (and for dma three torch.add), added to the 1024^2 entries as *_4096
    keys."""
    N = LARGE_SIZE
    m = nl.build(N, N, fused=True, steps_per_sweep=4, device=DEV)
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    m.run(4)
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    codes, inner = m._mask_codes, m.sshn_t.internal_mask.bool()
    args = (*m.grid.array_shape, m.grid.dtype, m.p, m.grid.dx, m.grid.dy,
            m._fcor, m.depth)
    plain = dict(p=m.p, dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
                 depth=m.depth)
    by_name = {e["name"]: e for e in entries}
    f4 = m.forcing_series(0, 4)
    fused = fs.make_fused_step(*args, steps_per_sweep=4)
    ker = fused(*state, codes, f4)
    err = _max_abs(ker, fs.fused_step_reference(*state, codes, f4, **plain),
                   inner)
    if err != 0.0:
        raise AssertionError(f"sweep {N}^2: kernel vs plain {err:.3e}")
    b = _bound(_nbytes(*state, codes, *ker), _count_ops(
        lambda: fs.fused_step_reference(*state, codes, f4, **plain)),
        torch.float32)
    sweep = by_name["nemolite2d_sweep"]
    sweep.update(ms_4096=_time_ms(lambda: fused(*state, codes, f4), 50),
                 bound_ms_4096=b["bound_ms"], bound_by_4096=b["bound_by"],
                 max_abs_err_4096=err)
    del ker
    f1 = m.forcing_series(0, 1)
    var = fs.make_variant(*args, 1, "dma")
    ker = var(*state, codes, f1)
    err = _max_abs(ker, fs.variant_dma_reference(*state, codes, f1))
    if err != 0.0:
        raise AssertionError(f"dma {N}^2: kernel vs plain {err:.3e}")
    b = _bound(_nbytes(*state, codes, *ker), _count_ops(
        lambda: fs.variant_dma_reference(*state, codes, f1)), torch.float32)
    dma = by_name["nemolite2d_variant_dma"]
    dma.update(ms_4096=_graph_ms(lambda: var(*state, codes, f1), 20),
               bound_ms_4096=b["bound_ms"], bound_by_4096=b["bound_by"],
               library_ms_4096=_graph_ms(
                   lambda: [torch.add(x, f1[0]) for x in state], 20),
               max_abs_err_4096=err)
    print(f"large f32 {N}^2 (block {m.grid.array_shape[0]}^2): flagship "
          f"sweep K=4 {sweep['ms_4096'] * 1e3:.2f} us, bound "
          f"{sweep['bound_ms_4096'] * 1e3:.2f} us by "
          f"{sweep['bound_by_4096']}; dma K=1 {dma['ms_4096'] * 1e3:.2f} us "
          f"(CUDA graph), 3 x torch.add {dma['library_ms_4096'] * 1e3:.2f} "
          f"us, bound {dma['bound_ms_4096'] * 1e3:.2f} us by "
          f"{dma['bound_by_4096']}; both bitwise with their plain versions",
          flush=True)


# --- ranks: the fence and the exchange between processes -------------------

#: seconds a gang of ranks may take before it is stopped (the rdma waits'
#: own budget, rdma.BUDGET_S, is shorter)
GANG_TIMEOUT = 420
GANG_STEPS = 40


def phase_fence() -> dict:
    """The three fence oracles on the card (csrc/fence_oracle.cu) through
    their entry point, with the oracle kernel's launches counted; the
    positive oracle against its plain version (FenceModel) and timed."""
    torch.cuda.synchronize()
    fo.fence_oracle.launches = 0
    res = fo.main(["cuda"])
    launches = fo.fence_oracle.launches
    if launches != 3:
        raise AssertionError(f"the fence oracles launched {launches} "
                             "kernels, expected 3")
    x = torch.from_numpy(fo.oracle_input()).to(DEV)
    o, status = fo.fence_oracle.positive(x)
    ref = fo.positive_reference(x)
    max_abs = float((o - ref).abs().max())
    if status != [0, 0] or max_abs != 0.0:
        raise AssertionError(f"positive oracle vs FenceModel: {max_abs}")
    if not 0.15 < res["negative_s"] < 5.0:
        raise AssertionError(f"negative oracle took {res['negative_s']} s "
                             f"for a {fo.NEGATIVE_BUDGET_S} s budget")
    ms = _time_ms(lambda: fo.fence_oracle.positive(x), 50)
    plain_ms = _time_ms(lambda: fo.positive_reference(x), 20)
    return {"name": "fence_oracle", "route": "cuda",
            "source": "dl_esm_inf_tpu_torch/csrc/fence_oracle.cu",
            "replaces": "scripts/fence_oracle.py:49",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms,
            **_bound(_nbytes(x, o), 0, torch.float32),
            "negative_ms": res["negative_s"] * 1e3,
            "control_ms": res["control_s"] * 1e3}


#: the seam transports the gangs of phases 19 and 22 run each seam leg
#: under, in one gang (parallel/mp_check.py --seams): the first one's
#: results keep their names, the second's are prefixed gloo__
SEAMS = ("--seams", "peer,gloo")


def _g(r: dict, key: str) -> float:
    """A number of the gang's legs under gloo seams."""
    return float(r[f"gloo__{key}"])


def _check_seams(r: dict, label: str, legs: str,
                 tolerated: tuple = ()) -> dict:
    """A gang's seam legs under "peer" seams (card to card) against the
    same legs under "gloo" (through host memory): every result bitwise
    but those starting with ``tolerated`` (the caller holds them), each
    leg on its transport, and the peer transport's batches per leg on
    rank 0; the one profiled peer transfer, all_reduce and all_gather
    made no copy to or from the host and no host synchronisation, and a
    profiled peer CG iteration copied only its stopping test to the
    host.  Prints the transports and the counts; returns the batches per
    leg."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    pairs = mpc.seam_pairs(r)
    bad = [k for k, same in pairs.items()
           if not same and not k.startswith(tolerated)]
    legs = [leg for leg in legs.split(",") if leg in mpc.SEAM_LEGS]
    wrong = {leg: (str(r[f"seam_transport_{leg}"]),
                   str(r[f"gloo__seam_transport_{leg}"])) for leg in legs}
    wrong = {k: v for k, v in wrong.items() if v != ("peer", "gloo")}
    batches = {leg: int(r[f"seam_batches_{leg}"]) for leg in legs}
    if bad or wrong or not pairs or any(
            int(r[f"gloo__seam_batches_{leg}"]) for leg in legs):
        raise AssertionError(f"{label}: peer seams against gloo: differ in "
                             f"{bad}; transports {wrong}")
    text = ""
    if "seam_profile_dtoh" in r:
        text += _probe_text(r, label, "seam_profile_", "seam_us_per_call",
                            "one strip transfer (depth 8, profiled)")
    if "seam_allreduce_us_per_call" in r:
        text += _probe_text(r, label, "seam_allreduce_profile_",
                            "seam_allreduce_us_per_call",
                            "one all_reduce of two values (profiled)")
        text += _probe_text(r, label, "seam_allgather_profile_",
                            "seam_allgather_us_per_call",
                            f"one all_gather of a nest's band "
                            f"({int(r['seam_allgather_band'])} values, "
                            f"profiled)")
    if "seam_cg_iteration_dtoh" in r:
        text += _cg_iteration_text(r, label)
    print(f"{label}: {len(pairs)} results of the legs under peer seams "
          f"bitwise equal to the same legs under gloo"
          + (f" (but those of {tolerated}, held below)" if tolerated else "")
          + f"; transports per leg: peer, then gloo; peer batches per leg "
          f"on rank 0: {batches}{text} [{SMI}]", flush=True)
    return batches


#: what a profiled call counts (parallel/mp_check.py::_profiled): the
#: copies to and from the host, host synchronisations, device copies
PROFILE_KEYS = ("dtoh", "htod", "syncs", "dtod")


def _profile_pair(r: dict, prefix: str) -> dict:
    """Each count of a profiled call under peer and under gloo seams."""
    return {k: (int(r[f"{prefix}{k}"]), int(r[f"gloo__{prefix}{k}"]))
            for k in PROFILE_KEYS}


def _probe_text(r: dict, label: str, prefix: str, us_key: str,
                what: str) -> str:
    """A probe of the gang's exchange leg (parallel/mp_check.py: the strip
    transfer, the all_reduce, the all_gather) under both seam
    transports, us per call and the profiled counts, as printed text; a
    peer call that copied to or from the host or made the host wait
    raises."""
    prof = _profile_pair(r, prefix)
    if any(prof[k][0] for k in ("dtoh", "htod", "syncs")):
        raise AssertionError(f"{label}: {what} under peer seams touched "
                             f"the host: {prof}")
    return (f"; {what}: peer {float(r[us_key]):.1f} us per call, gloo "
            f"{_g(r, us_key):.1f}; (peer, gloo) Memcpy DtoH {prof['dtoh']}, "
            f"HtoD {prof['htod']}, host synchronisations {prof['syncs']}, "
            f"device-to-device copies {prof['dtod']}")


def _cg_iteration_text(r: dict, label: str) -> str:
    """One profiled CG iteration (mp_check._cg_iteration_probe) under
    both seam transports: under peer its one copy to the host is the
    loop's stopping test (``float(rr)``), and nothing comes back."""
    prof = _profile_pair(r, "seam_cg_iteration_")
    if prof["dtoh"][0] != 1 or prof["htod"][0] != 0:
        raise AssertionError(f"{label}: a peer CG iteration copied to or "
                             f"from the host beyond its stopping test: "
                             f"{prof}")
    return (f"; one CG iteration (profiled, a solve capped at 2 iterations "
            f"less one capped at 1): (peer, gloo) Memcpy DtoH "
            f"{prof['dtoh']}, HtoD {prof['htod']}, host synchronisations "
            f"{prof['syncs']}")


#: PR 23's chip runs (PERF.md section 5; NVIDIA H100 80GB HBM3, 700.00 W)
#: of the paths the collectives serve, 2 ranks x 1 tile, ms per solve,
#: step, analysis or nest step under (peer, gloo) seams, when the
#: collectives went through host memory under both
PR23_TIMES = {"cg": ("507.42-653.25", "619.20-746.99"),
              "cheb": ("37.25-53.84", "82.66-111.89"),
              "si": ("116.32-131.01", "138.34-176.15"),
              "sio": ("435.84-544.62", "508.95-642.68"),
              "ek": ("35.43-60.9", "22.5-50.48"),
              "lk": ("134.4-147.6", "120.2-142.4"),
              "nest": ("11.1-35.98", "16.4-35.67")}


def _pr23(key: str) -> str:
    peer, gloo = PR23_TIMES[key]
    return f" (PR 23's runs: {peer} / {gloo})"


def _gang(nproc: int, legs: str, out: Path, *extra) -> dict:
    """Rank 0's results of ``nproc`` ranks of mp_check on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    rc = launch_gang(None, ["--out", str(out), "--legs", legs, "--n",
                            str(MAIN_SIZE), "--ndomains", "8", "--steps",
                            str(GANG_STEPS), "--reps", "20", "--rounds",
                            "200", *extra],
                     num_processes=nproc, base_env=env,
                     module="dl_esm_inf_tpu_torch.parallel.mp_check",
                     timeout=GANG_TIMEOUT)
    if rc != 0:
        raise AssertionError(f"the {nproc}-rank gang exited {rc}")
    print(f"gang of {nproc} ranks ({legs}): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(np.load(out))


def _check_small_legs(r: dict, nproc: int) -> None:
    """tests/mp_worker.py's legs across ranks against the single-process
    port on the card: hill, checksum, round trip, periodic bitwise; the
    32x32 flagship within TOL_F32 of its field's max."""
    def grid(bcs, gnx, gny):
        g = tdl.Grid(tdl.ARAKAWA_C, bcs, tdl.OFFSET_NE, device=DEV)
        g.decompose(gnx, gny, ndomains=8)
        tdl.grid_init(g, 1.0, 1.0)
        return g
    walled = (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL, tdl.BC_NONE)
    g = grid(walled, 24, 20)
    f = tdl.Field(g, tdl.T_POINTS)
    init_field_hill(f, -666.0)
    f.halo_exchange(1)
    ones = tdl.Field(g, tdl.T_POINTS, init_global_data=np.ones((20, 24)))
    vals = np.arange(480.0).reshape(20, 24)
    pg = grid((tdl.BC_PERIODIC, tdl.BC_PERIODIC, tdl.BC_NONE), 16, 16)
    pf = tdl.Field(pg, tdl.T_POINTS,
                   init_global_data=np.arange(256.0).reshape(16, 16))
    pf.halo_exchange(1)
    m = nl.build(32, 32, ndomains=8, open_north=True, device=DEV)
    m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
    m.run(10)
    checks = {"hill": np.array_equal(r["hill"], f.get_data()),
              "checksum": float(r["gsum"]) == tdl.field_checksum(ones) == 480,
              "roundtrip": np.array_equal(r["roundtrip"],
                                          (vals + 1.0).astype(np.float32)),
              "periodic": np.array_equal(r["periodic"], pf.get_data())}
    if not all(checks.values()):
        raise AssertionError(f"{nproc} ranks vs one process: {checks}")
    d = _rel_diff({k: r[f"nl_{k}"] for k in ("sshn", "un", "vn")}, m.gather())
    if not d <= TOL_F32:
        raise AssertionError(f"{nproc}-rank 32^2 flagship rel {d:.3e}")
    print(f"{nproc} ranks (8 tiles), small legs vs one process on the card: "
          f"hill, checksum 480, round trip, periodic bitwise; 32^2 flagship "
          f"10 steps rel {d:.3e}", flush=True)


def _check_exchange_legs(r: dict, nproc: int) -> None:
    keys = sorted(k for k in r if k.startswith("exch_equal_"))
    bad = [k for k in keys if not bool(r[k])]
    if len(keys) != 16 or bad:
        raise AssertionError(f"{nproc}-rank exchanges != one process: {bad}")
    if not bool(r["skew_equal"]):
        raise AssertionError(f"{nproc} ranks: the skewed remote_dma pair "
                             "!= one process")
    if float(r["rdma_max_abs_err"]) != 0.0:
        raise AssertionError(f"{nproc} ranks: rdma kernel vs plain "
                             f"{float(r['rdma_max_abs_err'])}")
    if int(r["exch_rdma_launches"]) != int(r["exch_rdma_calls"]):
        raise AssertionError(f"{nproc} ranks: {int(r['exch_rdma_launches'])} "
                             f"rdma launches for {int(r['exch_rdma_calls'])} "
                             "remote_dma calls")
    if int(r["rdma_handoffs_per_call"]) != 1:
        raise AssertionError(f"{nproc} ranks: the plain protocol made "
                             f"{int(r['rdma_handoffs_per_call'])} hand-offs "
                             "per call, expected 1")
    tiles = [bool(r[f"{p}exch_tiles_equal_{w}"]) for p in ("", "gloo__")
             for w in ("walled", "periodic")]
    if not all(tiles):
        raise AssertionError(f"{nproc} ranks: the ppermute exchange on 4 "
                             f"tiles a rank != one process: {tiles}")
    us = {k.removeprefix("exch_us_walled_2d_"): float(r[k]) for k in r
          if k.startswith("exch_us_walled_2d_")}
    for d in (1, 8):
        us[f"d{d}_ppermute_gloo"] = _g(r, f"exch_us_walled_2d_d{d}_ppermute")
    us["d8_remote_dma_settled"] = float(
        r["exch_us_settled_walled_2d_d8_remote_dma"])
    us["d8_remote_dma_kernels"] = float(
        r["exch_kernel_us_walled_2d_d8_remote_dma"])
    print(f"{nproc} ranks ({str(r['exch_rank_grid'])} rank grid), "
          f"Field.halo_exchange f32 {MAIN_SIZE}^2 halo 8: 16 "
          f"exchanges (walled/periodic, depth 1/8, 2D/3 levels, both "
          f"transports; ppermute under peer and gloo seams) bitwise equal "
          f"to one process, and the ppermute exchange at depth 8 on "
          f"{str(r['exch_tiles_layout'])} (walled, periodic, both seams); "
          f"skewed remote_dma pair "
          f"bitwise; rdma launches {int(r['exch_rdma_launches'])} = calls; "
          f"hand-offs per call {int(r['rdma_handoffs_per_call'])} (waits "
          f"{int(r['rdma_waits_per_call'])}, one per neighbour); "
          f"us per call (walled 2D; ppermute under peer seams, _gloo under"
          f" gloo): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                 sorted(us.items())), flush=True)


#: the fused transport across ranks: K, sweeps (GANG_STEPS steps) and the
#: tile layout of each gang
FUSED_K = 4
FUSED_LAYOUT = {2: (2, 1), 4: (2, 2)}


def _fused_args(nproc: int) -> tuple:
    px, py = FUSED_LAYOUT[nproc]
    return ("--fused-layouts", f"{px}x{py}", "--fused-k", str(FUSED_K),
            "--fused-shape", f"{MAIN_SIZE}x{MAIN_SIZE}", "--fused-sweeps",
            str(GANG_STEPS // FUSED_K))


def _check_fused_legs(r: dict, nproc: int) -> tuple[dict, object]:
    """The flagship with transport="fused" across ``nproc`` ranks (one
    tile each) against one process holding the same tiles (the fused
    transport's one-array kernel), bitwise; the alternating and skewed
    runs against it; the kernel's launches and its one-sweep comparison
    with its plain version.  Returns the gang's numbers and the
    one-process model."""
    from types import SimpleNamespace

    from dl_esm_inf_tpu_torch.parallel import mp_check
    px, py = FUSED_LAYOUT[nproc]
    K, sweeps = FUSED_K, GANG_STEPS // FUSED_K
    tag = f"{px}x{py}_k{K}"
    args = SimpleNamespace(fused_shape=f"{MAIN_SIZE}x{MAIN_SIZE}",
                           device=DEV)
    mh = mp_check.fused_model(args, px, py, K, variable_depth=True)
    mh.run(sweeps * K)
    gh = mh.gather()
    d_ht = max(float(np.abs(r[f"ffht_{k}"] - gh[k]).max()) for k in gh)
    m = mp_check.fused_model(args, px, py, K)
    m.run(sweeps * K)
    g = m.gather()
    d = max(float(np.abs(r[f"ff_{tag}_{k}"] - g[k]).max()) for k in g)
    d_alt = max(float(np.abs(r[f"falt_{k}"] - g[k]).max()) for k in g)
    d_skew = max(float(np.abs(r[f"fskew_{k}"] - g[k]).max()) for k in g)
    launches = int(r[f"ff_launches_{tag}"])
    err = float(r[f"ff_max_abs_err_{tag}"])
    if (d, d_alt, d_skew, d_ht, err) != (0.0,) * 5 or not bool(
            r["falt_exch_equal"]) or str(r["falt_tag"]) != tag or str(
            r["ffht_tag"]) != tag:
        raise AssertionError(
            f"{nproc}-rank fused transport vs one process: max abs {d}, "
            f"alternating {d_alt} (exchanges equal: "
            f"{bool(r['falt_exch_equal'])}), skewed {d_skew}, variable "
            f"depth f64 {d_ht}; kernel vs plain {err}")
    if launches != sweeps:
        raise AssertionError(f"{nproc}-rank fused transport launched the "
                             f"rdma sweep {launches} times for {sweeps} "
                             "sweeps")
    us = {k: float(r[f"ff_{k}_{tag}"]) for k in (
        "sweep_us", "kernel_us", "pp_sweep_us", "run_us", "pp_run_us",
        "plain_us")}
    us["pp_sweep_us_gloo"] = _g(r, f"ff_pp_sweep_us_{tag}")
    us["pp_run_us_gloo"] = _g(r, f"ff_pp_run_us_{tag}")
    print(f"fused transport f32 {MAIN_SIZE}^2 K={K} halo 8, {nproc} ranks "
          f"({px}x{py} tiles, one each), {sweeps * K} steps: bitwise equal "
          f"to one process with the same tiles, and so is the same run at "
          f"float64 over a seeded depth plane; {sweeps} sweeps alternating "
          f"with remote_dma exchanges of a 3-level field (each equal to the "
          f"plain exchange) and with the last rank 50 ms late: bitwise; rdma"
          f" sweep launches per rank {launches}; kernel vs plain one sweep "
          f"{err}; per sweep: kernel {us['sweep_us']:.1f} us (a rank's "
          f"kernels {us['kernel_us']:.1f} us of it), ppermute exchange + "
          f"sweep {us['pp_sweep_us']:.1f} us under peer seams, "
          f"{us['pp_sweep_us_gloo']:.1f} under gloo, plain "
          f"{us['plain_us']:.1f} us; run: fused {us['run_us']:.2f} us/step, "
          f"ppermute {us['pp_run_us']:.2f} us/step under peer seams, "
          f"{us['pp_run_us_gloo']:.2f} under gloo", flush=True)
    return {"launches": launches, "max_abs_err": err, "us": us,
            "bytes": int(r[f"ff_bytes_{tag}"])}, m


def phase_ranks() -> list:
    """Gangs of 2 and 4 ranks on the card (dl_esm_inf_tpu_torch.launch
    running parallel/mp_check.py): the small legs, Field.halo_exchange at
    1024^2 under both transports, the skewed pair, the fence round trip,
    the 2-rank flagship against the single-process 2-tile run, and the
    flagship's fused transport across 2 (2x1) and 4 (2x2) ranks against
    one process with the same tiles."""
    import tempfile
    fused_legs = "flagship_fused,fused_alternate,fused_skew"
    legs2 = f"core,periodic,exchange,skew,flagship,fence,{fused_legs}"
    legs4 = f"core,periodic,exchange,skew,{fused_legs}"
    with tempfile.TemporaryDirectory() as tmp:
        r2 = _gang(2, legs2, Path(tmp) / "r2.npz", *_fused_args(2), *SEAMS)
        r4 = _gang(4, legs4, Path(tmp) / "r4.npz", *_fused_args(4), *SEAMS)
    for nproc, r, legs in ((2, r2, legs2), (4, r4, legs4)):
        _check_seams(r, f"{nproc} ranks", legs)
        _check_small_legs(r, nproc)
        _check_exchange_legs(r, nproc)
    if str(r4["exch_rank_grid"]) != "2x2":
        raise AssertionError(f"the 4-rank exchange ran on a "
                             f"{str(r4['exch_rank_grid'])} rank grid")
    (f2, m2), (f4, _) = _check_fused_legs(r2, 2), _check_fused_legs(r4, 4)
    rt_us = float(r2["fence_round_trip_us"])
    stream_us = float(r2["fence_stream_round_trip_us"])
    print(f"fence round trip between 2 ranks on one card (ping-pong, 200 "
          f"rounds): {rt_us:.1f} us spinning in a kernel, {stream_us:.2f} us "
          f"with the wait off the SMs (stream memory operations; "
          f"CAN_USE_STREAM_MEM_OPS_V1 reads "
          f"{int(r2['stream_memops_attribute'])})", flush=True)
    mps = shutil.which("nvidia-cuda-mps-control")
    print(f"MPS control binary: {mps or 'absent'} (not started here: the "
          f"gangs above ran without MPS, time-sliced)", flush=True)

    # the flagship: 2 ranks x 1 tile against one process with 2 tiles
    N, K = MAIN_SIZE, 4
    if int(r2["nl_launches"]) != GANG_STEPS // K:
        raise AssertionError(f"2-rank flagship launched "
                             f"{int(r2['nl_launches'])} sweeps per rank")
    m = nl.build(N, N, ndomains=2, fused=True, steps_per_sweep=K,
                 halo_width=8, device=DEV)
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    m.run(GANG_STEPS)
    g = m.gather()
    d = max(float(np.abs(r2[f"big_{k}"] - g[k]).max()) for k in g)
    if d != 0.0:
        raise AssertionError(f"2-rank flagship vs one process: max abs {d}")
    us_1 = _time_ms(lambda: m.run(GANG_STEPS), 3) * 1e3 / GANG_STEPS
    us_2, us_2g = float(r2["nl_us_per_step"]), _g(r2, "nl_us_per_step")
    print(f"flagship f32 {N}^2 K={K} halo 8, {GANG_STEPS} steps: 2 ranks x 1 "
          f"tile bitwise equal to one process with 2 tiles; {us_2:.2f} "
          f"us/step on 2 ranks under peer seams, {us_2g:.2f} under gloo, "
          f"{us_1:.2f} us/step in one process; sweep launches per rank "
          f"{int(r2['nl_launches'])} [{SMI}]", flush=True)

    nbytes = int(r2["rdma_block_bytes"])
    entry = {"name": "halo_exchange_rdma", "route": "cuda",
             "source": "dl_esm_inf_tpu_torch/csrc/halo_exchange_rdma.cu",
             "replaces": "dl_esm_inf_tpu/parallel/halo_pallas.py:46",
             "launches": int(r2["exch_rdma_launches"]),
             "max_abs_err": float(r2["rdma_max_abs_err"]),
             "ms": float(r2["exch_us_walled_2d_d8_remote_dma"]) / 1e3,
             "plain_ms": float(r2["rdma_plain_us"]) / 1e3,
             **_bound(2 * nbytes, 0, torch.float32),
             "library_ms": _g(r2, "exch_us_walled_2d_d8_ppermute") / 1e3,
             "library_ms_peer":
                 float(r2["exch_us_walled_2d_d8_ppermute"]) / 1e3,
             "ranks": 2,
             "ms_4_ranks": float(r4["exch_us_walled_2d_d8_remote_dma"]) / 1e3,
             "library_ms_4_ranks":
                 _g(r4, "exch_us_walled_2d_d8_ppermute") / 1e3,
             "library_ms_peer_4_ranks":
                 float(r4["exch_us_walled_2d_d8_ppermute"]) / 1e3,
             "launches_4_ranks": int(r4["exch_rdma_launches"]),
             "handoffs_per_call": int(r2["rdma_handoffs_per_call"]),
             "waits_per_call": int(r2["rdma_waits_per_call"]),
             "waits_per_call_4_ranks": int(r4["rdma_waits_per_call"]),
             "ms_each_call_settled":
                 float(r2["exch_us_settled_walled_2d_d8_remote_dma"]) / 1e3,
             "ms_4_ranks_each_call_settled":
                 float(r4["exch_us_settled_walled_2d_d8_remote_dma"]) / 1e3,
             "kernel_ms": float(r2["exch_kernel_us_walled_2d_d8_remote_dma"])
                 / 1e3,
             "kernel_ms_4_ranks":
                 float(r4["exch_kernel_us_walled_2d_d8_remote_dma"]) / 1e3,
             "fence_round_trip_us": rt_us,
             "fence_stream_round_trip_us": stream_us,
             "flagship_2_ranks_us_per_step": us_2,
             "flagship_2_ranks_gloo_us_per_step": us_2g,
             "flagship_1_process_us_per_step": us_1,
             "seam_transfer_us": float(r2["seam_us_per_call"]),
             "seam_transfer_gloo_us": _g(r2, "seam_us_per_call")}
    print(f"halo_exchange_rdma f32 {N}^2 halo 8 depth 8 2D: 2 ranks "
          f"{entry['ms'] * 1e3:.1f} us per call vs ppermute "
          f"{entry['library_ms'] * 1e3:.1f} us under gloo seams, "
          f"{entry['library_ms_peer'] * 1e3:.1f} under peer; 4 ranks "
          f"{entry['ms_4_ranks'] * 1e3:.1f} vs "
          f"{entry['library_ms_4_ranks'] * 1e3:.1f} / "
          f"{entry['library_ms_peer_4_ranks'] * 1e3:.1f} us; plain version "
          f"(protocol simulated over 2 blocks) "
          f"{entry['plain_ms'] * 1e3:.1f} us; bound "
          f"{entry['bound_ms'] * 1e3:.2f} us", flush=True)
    fused = _fused_entry(f2, f4, m2)
    fused["handoffs_per_call"] = entry["handoffs_per_call"]
    return [entry, fused]


def _fused_entry(f2: dict, f4: dict, m) -> dict:
    """The rdma sweep's kernel entry: 2 ranks (4 beside it); bound from
    one rank's bytes (its planes once, the strips it sends) and the plain
    step's operations on a rank's block (the 2-rank layout of the
    one-process model ``m``); the library yardstick is the same sweep on
    the gloo ppermute transport (exchange, then the sweep kernel)."""
    spec = m.grid.halo_spec
    rank_block = (spec.local_ny, spec.local_nx)     # one tile per rank
    blk = torch.zeros(rank_block, dtype=m.grid.dtype, device=DEV)
    code = torch.zeros(rank_block, dtype=torch.int8, device=DEV)
    forcing = m.forcing_series(0, FUSED_K)
    ops = _count_ops(lambda: fs.fused_step_reference(
        blk, blk, blk, code, forcing, p=m.p, dx=m.grid.dx, dy=m.grid.dy,
        fcor=m._fcor, depth=m.depth))
    u2, u4 = f2["us"], f4["us"]
    entry = {"name": "nemolite2d_sweep_rdma", "route": "cuda",
             "source": "dl_esm_inf_tpu_torch/csrc/nemolite2d_sweep_rdma.cu",
             "replaces": "dl_esm_inf_tpu/ops/sweep.py:383",
             "launches": f2["launches"], "max_abs_err": f2["max_abs_err"],
             "ms": u2["sweep_us"] / 1e3, "plain_ms": u2["plain_us"] / 1e3,
             "kernel_ms": u2["kernel_us"] / 1e3,
             "kernel_ms_4_ranks": u4["kernel_us"] / 1e3,
             **_bound(f2["bytes"], ops, m.grid.dtype),
             "library_ms": u2["pp_sweep_us_gloo"] / 1e3,
             "library_ms_peer": u2["pp_sweep_us"] / 1e3,
             "ranks": 2, "K": FUSED_K,
             "run_us_per_step": u2["run_us"],
             "ppermute_run_us_per_step": u2["pp_run_us_gloo"],
             "ppermute_peer_run_us_per_step": u2["pp_run_us"],
             "launches_4_ranks": f4["launches"],
             "max_abs_err_4_ranks": f4["max_abs_err"],
             "ms_4_ranks": u4["sweep_us"] / 1e3,
             "plain_ms_4_ranks": u4["plain_us"] / 1e3,
             "library_ms_4_ranks": u4["pp_sweep_us_gloo"] / 1e3,
             "library_ms_peer_4_ranks": u4["pp_sweep_us"] / 1e3,
             "run_us_per_step_4_ranks": u4["run_us"],
             "ppermute_run_us_per_step_4_ranks": u4["pp_run_us_gloo"],
             "ppermute_peer_run_us_per_step_4_ranks": u4["pp_run_us"]}
    print(f"nemolite2d_sweep_rdma f32 {MAIN_SIZE}^2 K={FUSED_K}: 2 ranks "
          f"{entry['ms'] * 1e3:.1f} us per sweep vs ppermute "
          f"{entry['library_ms'] * 1e3:.1f} us under gloo seams, "
          f"{entry['library_ms_peer'] * 1e3:.1f} under peer; 4 ranks "
          f"{entry['ms_4_ranks'] * 1e3:.1f} vs "
          f"{entry['library_ms_4_ranks'] * 1e3:.1f} / "
          f"{entry['library_ms_peer_4_ranks'] * 1e3:.1f} us; bound "
          f"{entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']})",
          flush=True)
    return entry


# --- the differentiable and ensemble paths ---------------------------------

#: (a)'s flagship: the main path's width, one observation at step ADJ_STEP
ADJ_SIZE = 1024
ADJ_STEP = 64
#: remat chunks of (a); None is the plain adjoint
ADJ_CHUNKS = (None, 1, 8)
#: (b): float64, the card against the CPU
ADJ_F64_SIZE = 32
TOL_ADJ_F64 = 1e-12
#: (c) and (d): steps of the coupled tracer and of the ensembles
COUPLED_STEPS = 100
ENS_MEMBERS = 8
ENS_STEPS = 20
#: (e): the Adam twin run
TWIN_SIZE = 256
TWIN_ITERS = 50
#: (c): the float32 tracer's mass drift over COUPLED_STEPS steps,
#: relative.  Each step rounds every cell's update once in float32; over
#: ~1e6 cells those roundings cancel in the sum like a random walk,
#: ~eps32 * sqrt(steps / cells) ~ 1e-9 (the card reads 0 to 2.5e-9).  The
#: worst case, steps * eps32 ~ 1e-5, would let a leak of 1e-7 a step
#: pass; this limit catches one of 1e-9 a step.
TOL_MASS_F32 = 1e-7


def _smooth_field(seed: int, n: int, amp: float) -> np.ndarray:
    """A seeded smooth asymmetric field (low Fourier modes): off the
    upwind selections' exact ties."""
    rng = np.random.default_rng(seed)
    z = np.fft.rfft2(rng.standard_normal((n, n)))
    ky = np.abs(np.fft.fftfreq(n) * n)[:, None]
    kx = (np.fft.rfftfreq(n) * n)[None, :]
    f = np.fft.irfft2(np.where((ky <= 3) & (kx <= 3), z, 0), s=(n, n))
    return amp * f / np.abs(f).max()


def _flagship_obs(n, steps, dtype, device, seed=41) -> dict:
    truth = nl.build(n, n, open_north=True, dtype=dtype, device=device)
    truth.set_initial_ssh(gaussian_eta(n, n, amp=0.2)
                          + _smooth_field(seed, n, 0.05))
    obs, done = {}, 0
    for t in steps:
        truth.run(t - done)
        done = t
        obs[t] = truth.gather()["sshn"]
    return obs


def _cost_grad(model, obs, x0, remat_chunk=None, index=0, marks=None):
    """The cost and its autograd gradient at ``x0``; with a list
    ``marks``, the host clock after the forward pass (the card
    synchronised) is appended to it."""
    from dl_esm_inf_tpu_torch.models.assimilation import make_cost_fn
    cost, pack, _ = make_cost_fn(model, obs, remat_chunk=remat_chunk,
                                 obs_state_index=index)
    x = pack(x0).requires_grad_(True)
    c = cost(x)
    if marks is not None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    (g,) = torch.autograd.grad(c, x)
    return c.detach(), g


def _device_share(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its host ms (the card
    synchronised at the end), the device operations it ran (kernels,
    memsets and copies), their summed device ms and the busy share, that
    sum over the host ms (the operations run one at a time on one
    stream).  Null where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e.time_range.end - e.time_range.start for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"host_ms": wall, "device_ops": None, "busy_ms": None,
                "busy_share": None}
    busy = sum(dev) / 1e3
    return {"host_ms": wall, "device_ops": len(dev), "busy_ms": busy,
            "busy_share": busy / wall}


def _share_text(d: dict, per: int, unit: str, timed_ms: float) -> str:
    """``_device_share``'s reading; the profiler slows the host, so the
    busy time is also given over ``timed_ms``, the same work timed
    without it (stored as ``busy_share_untraced``)."""
    if d["device_ops"] is None:
        return "device busy share not measured (the profiler saw no device)"
    d["busy_share_untraced"] = d["busy_ms"] / timed_ms
    return (f"device busy share {d['busy_share']:.2f} ({d['busy_ms']:.1f} of "
            f"{d['host_ms']:.1f} ms traced; {d['busy_share_untraced']:.2f} "
            f"of {timed_ms:.1f} ms untraced), {d['device_ops'] / per:.0f} "
            f"device operations per {unit}")


def _adjoint_remat() -> dict:
    """(a) the flagship's plain adjoint at the main path's width against
    remat: cost and gradient bitwise, ms per cost + gradient, peak device
    memory above what was allocated before."""
    n, dtype = ADJ_SIZE, torch.float32
    obs = _flagship_obs(n, [ADJ_STEP], dtype, DEV)
    x0 = _smooth_field(42, n, 0.05)
    out, ref = {}, None
    for ck in ADJ_CHUNKS:
        m = nl.build(n, n, open_north=True, dtype=dtype, device=DEV)
        _cost_grad(m, obs, x0, ck)                     # warm-up
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]
        c, g = _cost_grad(m, obs, x0, ck, marks=marks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - marks[0]) * 1e3
        fwd_ms = (marks[1] - marks[0]) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        if not (torch.isfinite(c) and torch.isfinite(g).all()):
            raise AssertionError(f"adjoint remat={ck}: not finite")
        if ref is None:
            ref = (c, g)
            if not float(g.abs().max()) > 0:
                raise AssertionError("adjoint: zero gradient")
        elif not (torch.equal(c, ref[0]) and torch.equal(g, ref[1])):
            raise AssertionError(
                f"adjoint remat={ck} differs from the plain adjoint: cost "
                f"{float(c)} vs {float(ref[0])}, gradient max abs diff "
                f"{float((g - ref[1]).abs().max()):.3e}")
        out[str(ck)] = {"ms": ms, "forward_ms": fwd_ms,
                        "peak_bytes": int(peak)}
        if ck is None:
            out["trace"] = _device_share(lambda: _cost_grad(m, obs, x0))
        del c, g, m
    plain = out["None"]["peak_bytes"]
    for ck in ADJ_CHUNKS[1:]:
        if not out[str(ck)]["peak_bytes"] < plain:
            raise AssertionError(f"remat={ck} peak {out[str(ck)]} not below "
                                 f"the plain adjoint's {plain}")
    print(f"adjoint (a): flagship {n}^2 f32, obs at step {ADJ_STEP}: "
          + "; ".join(f"remat {ck}: {out[str(ck)]['ms']:.1f} ms per cost + "
                      f"gradient (forward {out[str(ck)]['forward_ms']:.1f}),"
                      f" peak {out[str(ck)]['peak_bytes'] / 2**20:.1f} MiB"
                      for ck in ADJ_CHUNKS)
          + " (host clock; cost and gradient bitwise equal to plain); "
          + "plain, traced: " + _share_text(out["trace"], ADJ_STEP, "step",
                                            out["None"]["ms"]),
          flush=True)
    return out


def _f64_cases():
    """(b)'s models at ADJ_F64_SIZE, float64, on ``device``: name ->
    (build, observations, first guess, observed index)."""
    n = ADJ_F64_SIZE
    f64 = torch.float64

    def flagship(dev):
        return nl.build(n, n, open_north=True, dtype=f64, device=dev)

    def semi(dev):
        return si.build(n, n, dt=1.0, depth=10.0, tol=1e-14,
                        differentiable=True, dtype=f64, device=dev)

    def coupled(dev):
        fs = nl.build(n, n, open_north=True, halo_width=2, dtype=f64,
                      device=dev)
        fs.set_initial_ssh(gaussian_eta(n, n, amp=0.2)
                           + _smooth_field(43, n, 0.05))
        return tr.CoupledTracer(fs, kappa=0.01)

    def obs_of(m, key, setter, x_true, steps):
        getattr(m, setter)(x_true)
        out, done = {}, 0
        for t in steps:
            m.run(t - done)
            done = t
            out[t] = m.gather()[key]
        return out

    cpu = torch.device("cpu")
    return {
        "flagship": (flagship, _flagship_obs(n, [4, 8], f64, cpu),
                     _smooth_field(44, n, 0.05), 0),
        "semi_implicit": (semi, obs_of(semi(cpu), "eta", "set_initial_eta",
                                       gaussian_eta(n, n, amp=0.5), [2, 4]),
                          0.1 * _smooth_field(45, n, 1.0), 0),
        "coupled_tracer": (coupled, obs_of(
            coupled(cpu), "c", "set_initial_tracer",
            _smooth_field(46, n, 0.8) + 1.0, [5, 10]),
            _smooth_field(47, n, 0.5) + 1.0, 3),
    }


def _adjoint_f64() -> dict:
    """(b) cost and gradient at float64 on the card against the CPU, and
    the semi-implicit gradient against central differences."""
    from dl_esm_inf_tpu_torch.core import layout
    from dl_esm_inf_tpu_torch.models.assimilation import make_cost_fn
    worst = {}
    cases = _f64_cases()
    for name, (build, obs, x0, index) in cases.items():
        got = []
        for dev in (DEV, torch.device("cpu")):
            m = build(dev)
            c, g = _cost_grad(m, obs, x0, index=index)
            got.append((float(c), layout.unstack_internal(
                m.grid.decomp, g).cpu().numpy()))
        (cd, gd), (cc, gc_) = got
        dc = abs(cd - cc) / abs(cc)
        dg = float(np.abs(gd - gc_).max() / np.abs(gc_).max())
        if not (dc <= TOL_ADJ_F64 and dg <= TOL_ADJ_F64):
            raise AssertionError(f"adjoint f64 {name}: card vs CPU cost "
                                 f"{dc:.3e}, gradient {dg:.3e}")
        worst[name] = {"cost": dc, "gradient": dg}
    # the semi-implicit gradient against central differences
    build, obs, _x0, _i = cases["semi_implicit"]
    n = ADJ_F64_SIZE
    cost, pack, _ = make_cost_fn(build(DEV), obs)
    x = pack(np.zeros((n, n))).requires_grad_(True)
    (g,) = torch.autograd.grad(cost(x), x)
    x = x.detach()
    h, fd_worst = 1e-6, 0.0
    with torch.no_grad():
        for idx in ((6, 8), (11, 5), (20, 17)):
            ep, em = x.clone(), x.clone()
            ep[idx] = h
            em[idx] = -h
            fd = float((cost(ep) - cost(em)) / (2 * h))
            err = abs(fd - float(g[idx])) / max(abs(fd), 1e-3)
            if not err <= 1e-6:
                raise AssertionError(f"semi-implicit gradient vs central "
                                     f"differences at {idx}: {err:.3e}")
            fd_worst = max(fd_worst, err)
    worst["semi_implicit_fd"] = fd_worst
    print(f"adjoint (b): f64 {n}^2, card vs CPU max rel diff "
          + ", ".join(f"{k} cost {v['cost']:.2e} gradient {v['gradient']:.2e}"
                      for k, v in worst.items() if isinstance(v, dict))
          + f" (tol {TOL_ADJ_F64:g}); semi-implicit gradient vs central "
          f"differences {fd_worst:.2e} (tol 1e-6)", flush=True)
    return worst


def _coupled_main() -> dict:
    """(c) CoupledTracer at the main path's width: its flow bitwise equal
    to a plain flagship run on the card, tracer mass conserved, us/step."""
    from dl_esm_inf_tpu_torch.core import layout
    n, steps = MAIN_SIZE, COUPLED_STEPS
    ssh0 = gaussian_eta(n, n, amp=0.2) + _smooth_field(48, n, 0.05)
    plain = nl.build(n, n, open_north=True, halo_width=2, device=DEV)
    plain.set_initial_ssh(ssh0)
    plain.run(steps)
    fs = nl.build(n, n, open_north=True, halo_width=2, device=DEV)
    fs.set_initial_ssh(ssh0)
    ct = tr.CoupledTracer(fs, kappa=0.01)
    ct.set_initial_tracer(gaussian_eta(n, n, amp=1.0, width=0.1) + 0.01)
    wet = ct._t_upd.double() * torch.from_numpy(
        layout.internal_mask(fs.grid.decomp)).to(DEV)

    def mass64():
        """The tracer's mass summed in float64 (the model's own
        ``mass()`` sums a float32 field in float32)."""
        return float((ct.c.data.double() * wet).sum())

    m0 = mass64()
    ct.run(steps)
    drift = abs(mass64() - m0) / abs(m0)
    for a, b in ((fs.sshn_t, plain.sshn_t), (fs.un, plain.un),
                 (fs.vn, plain.vn)):
        if not torch.equal(a.data, b.data):
            raise AssertionError("coupled flow differs from the plain "
                                 "flagship run")
    if not torch.isfinite(ct.c.data).all():
        raise AssertionError("coupled tracer not finite")
    if not drift <= TOL_MASS_F32:
        raise AssertionError(f"coupled tracer mass drift {drift:.3e}")
    us = 1e3 * _time_ms(lambda: ct.run(10), 3) / 10
    us_plain = 1e3 * _time_ms(lambda: plain.run(10), 3) / 10
    print(f"coupled tracer (c): {n}^2 f32, {steps} steps: flow bitwise "
          f"equal to the plain flagship, mass drift {drift:.2e} (tol "
          f"{TOL_MASS_F32:g}); {us:.1f} us/step (plain flagship alone "
          f"{us_plain:.1f})", flush=True)
    return {"us_per_step": us, "flagship_us_per_step": us_plain,
            "mass_drift": drift}


def _ensemble_main() -> dict:
    """(d) Ensembles of ENS_MEMBERS at the main path's width: every
    member bitwise equal to its own sequential run; us per ensemble step
    beside the members' sequential steps."""
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    n, M, steps = MAIN_SIZE, ENS_MEMBERS, ENS_STEPS
    rng = np.random.default_rng(49)
    out = {}
    for name, build, setter, amp in (
            ("gravity_wave", lambda: gw.build(n, n, dt=0.05, depth=10.0,
                                              device=DEV),
             "set_initial_eta", 0.5),
            ("flagship", lambda: nl.build(n, n, open_north=True, device=DEV),
             "set_initial_ssh", 0.2)):
        base = gaussian_eta(n, n, amp=amp)
        x0 = np.stack([base * (1 + 0.1 * k)
                       + 0.01 * amp * rng.standard_normal((n, n))
                       for k in range(M)])
        ens = Ensemble(build(), M)
        ens.set_member_states(0, x0)
        ens.run(steps)
        got = ens.gather_all()
        for k in range(M):
            m = build()
            getattr(m, setter)(x0[k])
            m.run(steps)
            want = m.gather()
            for f, w in zip(ens._field_names, want.values()):
                if not np.array_equal(got[f][k], w):
                    raise AssertionError(f"ensemble {name} member {k} field "
                                         f"{f} differs from its sequential run")
            if k == 0:
                single = m
        if not np.isfinite(got[ens._field_names[0]]).all():
            raise AssertionError(f"ensemble {name} not finite")
        us_ens = 1e3 * _time_ms(lambda: ens.run(5), 3) / 5
        us_one = 1e3 * _time_ms(lambda: single.run(5), 3) / 5
        tr_ens = _device_share(lambda: ens.run(5))
        tr_one = _device_share(lambda: single.run(5))
        out[name] = {"us_per_ensemble_step": us_ens,
                     "us_per_member_step": us_one,
                     "us_M_sequential_steps": M * us_one,
                     "trace_ensemble": tr_ens, "trace_single": tr_one}
        print(f"ensemble (d): {name} {n}^2 f32, M={M}, {steps} steps: every "
              f"member bitwise equal to its sequential run; {us_ens:.1f} us "
              f"per ensemble step vs M x single {M * us_one:.1f} "
              f"({us_one:.1f} per single step); traced 5 steps: ensemble "
              f"{_share_text(tr_ens, 5, 'step', 5e-3 * us_ens)}; single "
              f"{_share_text(tr_one, 5, 'step', 5e-3 * us_one)}", flush=True)
    return out


def _adam_twin() -> dict:
    """(e) a TWIN_ITERS-iteration Adam twin run of the flagship at
    TWIN_SIZE^2 f32 on the card: the cost must fall."""
    from dl_esm_inf_tpu_torch.models.assimilation import assimilate
    n = TWIN_SIZE
    obs = _flagship_obs(n, [8, 16], torch.float32, DEV, seed=50)
    m = nl.build(n, n, open_north=True, device=DEV)
    t0 = time.perf_counter()
    res = assimilate(m, obs, iters=TWIN_ITERS, learning_rate=0.05)
    s = time.perf_counter() - t0
    hist = res["cost_history"]
    if not (np.isfinite(hist).all() and np.isfinite(res["eta0"]).all()):
        raise AssertionError("Adam twin run not finite")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"Adam twin run: cost {hist[0]} -> {hist[-1]}")
    print(f"adam twin (e): flagship {n}^2 f32, {TWIN_ITERS} iterations: "
          f"cost {hist[0]:.4e} -> {hist[-1]:.4e} ({hist[-1] / hist[0]:.3e}),"
          f" {s:.1f} s", flush=True)
    return {"cost_first": hist[0], "cost_last": hist[-1], "seconds": s}


def phase_adjoint_ensembles() -> dict:
    """Phase 20, the adjoint and ensembles on the card: (a) remat vs the
    plain adjoint at the flagship's main width, (b) float64 card vs CPU,
    (c) the coupled tracer, (d) ensembles, (e) an Adam twin run."""
    t0 = time.perf_counter()
    out = {"remat": _adjoint_remat(), "f64": _adjoint_f64(),
           "coupled": _coupled_main(), "ensemble": _ensemble_main(),
           "adam": _adam_twin()}
    out["seconds"] = time.perf_counter() - t0
    print(f"adjoint and ensembles: phase took {out['seconds']:.1f} s",
          flush=True)
    return out


# --- the filter, nesting and overlap mode ------------------------------------

#: (b) the LETKF: observations on every LETKF_STRIDE-th point per axis,
#: localisation radius LETKF_RADIUS cells
LETKF_STRIDE = 64
LETKF_RADIUS = 6.0
#: (d) float64, the card against the CPU: the CPU tests' tolerance
DA_F64_SIZE = 24
TOL_DA_F64 = 1e-11
#: (d) the nest's gradient: nest steps, and the directional derivative
#: against central differences (relative; the CPU test's tolerance)
NEST_GRAD_STEPS = 3
TOL_NEST_FD = 1e-6
#: (e) a two-way nest of ratio NEST_RATIO over a NEST_WINDOW^2 window
NEST_WINDOW = 256
NEST_RATIO = 4
NEST_STEPS = 20
#: (f), (g) overlap mode: steps per run
OVERLAP_STEPS = 40


def _gw_members(n, M, seed, device, dtype=None, amp=0.5):
    """An Ensemble of M gravity-wave members (dt 0.05, depth 10) from a
    seeded spread of the bump, and a truth run's start: their mean plus
    a member-space offset."""
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    rng = np.random.default_rng(seed)
    base = gaussian_eta(n, n, amp=amp)
    perts = np.stack([0.2 * _smooth_field(seed + k, n, amp)
                      for k in range(M)])
    ens = Ensemble(gw.build(n, n, dt=0.05, depth=10.0, dtype=dtype,
                            device=device), M)
    ens.set_member_states(0, base + perts)
    truth0 = (base + perts.mean(0) + 0.5 * (perts[1] - perts[3])
              + 0.01 * amp * rng.standard_normal((n, n)))
    return ens, truth0


def _gw_truth(n, x0, steps, device, dtype=None):
    m = gw.build(n, n, dt=0.05, depth=10.0, dtype=dtype, device=device)
    m.set_initial_eta(x0)
    m.run(steps)
    return m.gather()["eta"]


def _analysis_ms(ens, filt, y, mask, reps=3) -> float:
    """ms per analysis (host clock around synchronised calls), each from
    the same forecast, restored outside the timed call."""
    saved = tuple(s.clone() for s in ens.states)
    total = 0.0
    for _ in range(reps):
        ens.states = tuple(s.clone() for s in saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filt.analysis(y, obs_mask=mask)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    ens.states = saved
    return total / reps * 1e3


def _etkf_global() -> dict:
    """(a) one global ETKF analysis of the surface of ENS_MEMBERS
    flagship members at the main width (phase 20 (d)'s set-up), against
    a truth run: the innovation falls; ms per analysis."""
    from dl_esm_inf_tpu_torch.models.enkf import ETKF
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble
    n, M, steps = MAIN_SIZE, ENS_MEMBERS, ENS_STEPS
    rng = np.random.default_rng(49)
    base = gaussian_eta(n, n, amp=0.2)
    x0 = np.stack([base * (1 + 0.1 * k)
                   + 0.01 * 0.2 * rng.standard_normal((n, n))
                   for k in range(M)])
    truth = nl.build(n, n, open_north=True, device=DEV)
    truth.set_initial_ssh(base * 1.3 + _smooth_field(52, n, 0.01))
    truth.run(steps)
    y = truth.gather()["sshn"]
    ens = Ensemble(nl.build(n, n, open_north=True, device=DEV), M)
    ens.set_member_states(0, x0)
    ens.run(steps)
    filt = ETKF(ens, sigma=0.01)
    saved = tuple(s.clone() for s in ens.states)
    d = filt.analysis(y)
    if not (d["rms_innovation_after"] < d["rms_innovation_before"]
            and all(torch.isfinite(s).all() for s in ens.states)):
        raise AssertionError(f"global ETKF at {n}^2: {d}")
    ens.states = saved
    ms = _analysis_ms(ens, filt, y, None)
    print(f"ETKF (a): global, flagship {n}^2 f32, M={M}, {steps} steps, "
          f"sigma 0.01 on every wet point: innovation "
          f"{d['rms_innovation_before']:.4e} -> "
          f"{d['rms_innovation_after']:.4e}, spread "
          f"{d['spread_before']:.4e} -> {d['spread_after']:.4e}; "
          f"{ms:.2f} ms per analysis (host clock)", flush=True)
    return {"ms": ms, **d}


def _letkf_main() -> dict:
    """(b) the LETKF on ENS_MEMBERS gravity-wave members at the main
    width, observations on every LETKF_STRIDE-th point per axis: points
    beyond 2L (+1 cell) of every observation unchanged to the rounding of
    the identity transform, points near them moved; ms per analysis, the
    batched eigh's share of it (CUDA events around each eigh call), and
    the peak device memory above the memory held before."""
    from dl_esm_inf_tpu_torch.core import layout
    from dl_esm_inf_tpu_torch.models.enkf import ETKF
    n, M = MAIN_SIZE, ENS_MEMBERS
    ens, truth0 = _gw_members(n, M, 53, DEV)
    y = _gw_truth(n, truth0, 10, DEV)
    ens.run(10)
    mask = np.zeros((n, n))
    off = LETKF_STRIDE // 2
    mask[off::LETKF_STRIDE, off::LETKF_STRIDE] = 1.0
    p = int(mask.sum())
    filt = ETKF(ens, sigma=0.02, localization_radius=LETKF_RADIUS)
    d_ = ens.grid.decomp
    before = [layout.unstack_internal(d_, s).clone() for s in ens.states]
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    diag = filt.analysis(y, obs_mask=mask)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    after = [layout.unstack_internal(d_, s) for s in ens.states]
    # distance of every point to its nearest observation (a lattice)
    idx = np.arange(n)
    near1 = np.abs(((idx - off + LETKF_STRIDE // 2) % LETKF_STRIDE)
                   - LETKF_STRIDE // 2).astype(np.float64)
    dist = np.sqrt(near1[:, None] ** 2 + near1[None, :] ** 2)
    far = torch.from_numpy(dist > 2 * LETKF_RADIUS + 1).to(DEV)
    near = torch.from_numpy(dist <= LETKF_RADIUS).to(DEV)
    worst = {}
    for name, b, a in zip(ens._field_names, before, after):
        scale = float(b.abs().max())
        far_d = float((a - b).abs()[:, far].max())
        near_d = float((a - b).abs()[:, near].max())
        worst[name] = {"far": far_d, "near": near_d, "scale": scale}
        if not far_d <= TOL_F32 * scale:
            raise AssertionError(f"LETKF moved {name} beyond 2L of every "
                                 f"observation: {far_d:.3e} (scale "
                                 f"{scale:.3e})")
        if not near_d > TOL_F32 * scale:
            raise AssertionError(f"LETKF left {name} near the observations "
                                 f"unchanged: {near_d:.3e}")
    if not diag["rms_innovation_after"] < diag["rms_innovation_before"]:
        raise AssertionError(f"LETKF at {n}^2: {diag}")
    # time it, with CUDA events around every batched eigh
    eigh, spans = torch.linalg.eigh, []

    def timed_eigh(a):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = eigh(a)
        t1.record()
        spans.append((t0, t1))
        return out
    reps = 3
    torch.linalg.eigh = timed_eigh
    try:
        ms = _analysis_ms(ens, filt, y, mask, reps)
    finally:
        torch.linalg.eigh = eigh
    torch.cuda.synchronize()
    eigh_ms = sum(a.elapsed_time(b) for a, b in spans) / reps
    print(f"LETKF (b): gravity wave {n}^2 f32, M={M}, {p} observations "
          f"(every {LETKF_STRIDE}th point per axis), L={LETKF_RADIUS:g}: "
          f"innovation {diag['rms_innovation_before']:.4e} -> "
          f"{diag['rms_innovation_after']:.4e}; beyond 2L+1 of every "
          f"observation max |change| "
          + ", ".join(f"{k} {v['far']:.2e} (near {v['near']:.2e})"
                      for k, v in worst.items())
          + f" (tol {TOL_F32:g} x max|field|); {ms:.2f} ms per analysis "
          f"(host clock), batched eigh of {ens.grid.array_shape[0]}x"
          f"{ens.grid.array_shape[1]} ({M}, {M}) matrices in "
          f"{len(spans) // reps} calls {eigh_ms:.2f} ms "
          f"({eigh_ms / ms:.2f} of it); peak {peak / 2**30:.2f} GiB above "
          f"the memory held before", flush=True)
    return {"ms": ms, "eigh_ms": eigh_ms, "peak_bytes": int(peak),
            "observations": p, "unchanged": worst}


def _da_demo() -> dict:
    """(c) scripts/da_demo.py's configuration on the card at float32:
    48^2, M=8, 4 cycles of LETKF with adaptive inflation, then hybrid
    4D-EnVar against the static transform, with the demo's asserts."""
    from dl_esm_inf_tpu_torch.models.assimilation import assimilate
    from dl_esm_inf_tpu_torch.models.enkf import ETKF
    from dl_esm_inf_tpu_torch.models.ensemble import Ensemble

    def smooth_noise(rng, N, ncut=3):
        z = np.fft.rfft2(rng.standard_normal((N, N)))
        ky = np.abs(np.fft.fftfreq(N) * N)[:, None]
        kx = (np.fft.rfftfreq(N) * N)[None, :]
        f = np.fft.irfft2(np.where((ky <= ncut) & (kx <= ncut), z, 0),
                          s=(N, N))
        return f / np.abs(f).max()

    t0 = time.perf_counter()
    N, M, fsteps, cycles = 48, 8, 6, 4
    rng = np.random.default_rng(0)
    base = gaussian_eta(N, N, amp=0.3)
    perts = np.stack([0.2 * smooth_noise(rng, N) for _ in range(M)])
    eta_true = (base + perts.mean(0) + 0.5 * (perts[1] - perts[3])
                + 0.05 * smooth_noise(rng, N))

    def model():
        return gw.build(N, N, dt=0.05, depth=10.0, device=DEV)
    truth = model()
    truth.set_initial_eta(eta_true)
    obs = []
    for _ in range(cycles):
        truth.run(fsteps)
        obs.append(truth.gather()["eta"])
    ens = Ensemble(model(), M)
    ens.set_member_states(0, base + perts)
    filt = ETKF(ens, sigma=1e-3, localization_radius=6.0,
                adaptive_inflation=True, inflation_max=10.0)
    cyc = []
    for y in obs:
        ens.run(fsteps)
        d = filt.analysis(y)
        cyc.append(d)
        if not d["rms_innovation_after"] < d["rms_innovation_before"]:
            raise AssertionError(f"DA demo LETKF cycle {len(cyc)}: {d}")
    ow = np.zeros((N, N))
    ow[2::4, 2::4] = 1.0
    sparse_obs = {(k + 1) * fsteps: o for k, o in enumerate(obs[:2])}
    ens0 = Ensemble(model(), M)
    ens0.set_member_states(0, base + perts)
    err = {}
    for mode in ("static", "hybrid"):
        res = assimilate(model(), sparse_obs, iters=60, optimizer="lbfgs",
                         obs_weight=ow, smooth_scale=2.0,
                         background_weight=1e-5,
                         ensemble=ens0 if mode == "hybrid" else None)
        err[mode] = float(np.sqrt(np.mean(
            (res["eta0"][1:-1, 1:-1] - eta_true[1:-1, 1:-1]) ** 2)))
    if not err["hybrid"] < err["static"]:
        raise AssertionError(f"DA demo: hybrid 4D-EnVar {err['hybrid']:.4e}"
                             f" not below the static transform "
                             f"{err['static']:.4e}")
    s = time.perf_counter() - t0
    print("DA demo (c): 48^2 f32, M=8, LETKF cycles innovation "
          + ", ".join(f"{d['rms_innovation_before']:.4f}->"
                      f"{d['rms_innovation_after']:.4f} (rho "
                      f"{d['inflation']:.2f})" for d in cyc)
          + f"; 4D-EnVar RMS error hybrid {err['hybrid']:.4f} < static "
          f"{err['static']:.4f}; {s:.1f} s", flush=True)
    return {"cycles": cyc, "error": err, "seconds": s}


def _da_f64() -> dict:
    """(d) float64 at DA_F64_SIZE^2, the card against the CPU: the
    global ETKF's and the LETKF's ensembles after one analysis, and a
    two-way ratio-2 nest after 10 parent steps."""
    from dl_esm_inf_tpu_torch.models.enkf import ETKF
    from dl_esm_inf_tpu_torch.models.nesting import OneWayNest
    n, f64 = DA_F64_SIZE, torch.float64
    cpu = torch.device("cpu")
    worst = {}
    for rad in (None, 4.0):
        got = []
        for dev in (DEV, cpu):
            ens, truth0 = _gw_members(n, 5, 54, dev, dtype=f64)
            y = _gw_truth(n, truth0, 4, cpu, dtype=f64)
            ens.run(4)
            ETKF(ens, sigma=0.02, localization_radius=rad).analysis(y)
            got.append(ens.gather_all())
        worst["letkf" if rad else "etkf"] = max(
            float(np.abs(got[0][k] - got[1][k]).max()) for k in got[0])
    got = []
    for dev in (DEV, cpu):
        parent = gw.build(n, n, dt=0.02, depth=10.0, dtype=f64, device=dev)
        parent.set_initial_eta(gaussian_eta(n, n, width=0.08))
        nest_ = OneWayNest(parent, origin=(6, 6), shape=(12, 12), ratio=2,
                           two_way=True)
        nest_.sync_from_parent()
        nest_.run(10)
        got.append([parent.eta.gather_inner_data(),
                    nest_.child.eta.gather_inner_data(),
                    nest_.child.u.gather_inner_data()])
    worst["nest"] = max(float(np.abs(a - b).max())
                        for a, b in zip(*got))
    if not all(v <= TOL_DA_F64 for v in worst.values()):
        raise AssertionError(f"filter / nest f64 card vs CPU: {worst}")
    grad = _nest_grad_f64()
    print(f"f64 (d): {n}^2, the card against the CPU, max abs: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {TOL_DA_F64:g}); nest gradient: card vs CPU "
          f"{grad['card_vs_cpu']:.2e} of its largest entry (tol "
          f"{TOL_DA_F64:g}), directional derivative vs central differences "
          f"{grad['vs_fd_rel']:.2e} relative (tol {TOL_NEST_FD:g}), two "
          f"card runs differ by {grad['card_repeat']:.2e} (atomic adds; "
          f"not required bitwise)", flush=True)
    return {**worst, **{f"nest_grad_{k}": v for k, v in grad.items()}}


def _nest_grad_f64() -> dict:
    """(d) the two-way ratio-2 nest's gradient at float64: d/d(parent
    eta) of the child's eta energy after NEST_GRAD_STEPS nest steps, on
    the card and on the CPU.  The backward of the ring's bilinear gather
    adds into repeated indices (atomic adds on the card), so the card's
    gradient is held to the CPU's within TOL_DA_F64 of its largest entry
    and its directional derivative to central differences within
    TOL_NEST_FD relative, never bitwise."""
    from dl_esm_inf_tpu_torch.models.nesting import OneWayNest
    n, f64 = DA_F64_SIZE, torch.float64
    grads, fd, vdot = {}, None, None
    for where, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        parent = gw.build(n, n, dt=0.02, depth=10.0, dtype=f64, device=dev)
        parent.set_initial_eta(gaussian_eta(n, n, width=0.08))
        nest_ = OneWayNest(parent, origin=(6, 6), shape=(12, 12), ratio=2,
                           two_way=True)
        nest_.sync_from_parent()
        prog, c = nest_.step_program(NEST_GRAD_STEPS), nest_.child
        tree0 = (((c.eta.data, c.u.data, c.v.data), ()),)
        eta0 = parent.eta.data

        def loss(p_eta):
            out = prog(((p_eta, parent.u.data, parent.v.data), tree0))
            return torch.sum(out[1][0][0][0] ** 2)

        def grad():
            x = eta0.clone().requires_grad_(True)
            return torch.autograd.grad(loss(x), x)[0]
        g = grad()
        grads[where] = g.cpu().numpy()
        if where == "card":
            repeat = float((grad() - g).abs().max())
            v = torch.from_numpy(np.random.RandomState(0).normal(
                size=tuple(eta0.shape))).to(dev)
            eps = 1e-6
            with torch.no_grad():
                fd = (float(loss(eta0 + eps * v))
                      - float(loss(eta0 - eps * v))) / (2 * eps)
            vdot = float(torch.sum(g * v))
    scale = float(np.abs(grads["cpu"]).max())
    out = {"card_vs_cpu": float(np.abs(grads["card"] - grads["cpu"]).max())
           / scale,
           "vs_fd_rel": abs(vdot - fd) / abs(fd), "card_repeat": repeat}
    if not (scale > 0.0 and out["card_vs_cpu"] <= TOL_DA_F64
            and out["vs_fd_rel"] <= TOL_NEST_FD):
        raise AssertionError(f"nest gradient on the card: {out}")
    return out


def _nest_main() -> dict:
    """(e) a gravity-wave parent at the main width with a two-way child
    of ratio NEST_RATIO over a NEST_WINDOW^2 window, NEST_STEPS parent
    steps: finite; a ratio-1 nest's interior bitwise equal to its
    parent's window; us per nest step beside one parent step plus
    NEST_RATIO child steps."""
    from dl_esm_inf_tpu_torch.models.nesting import OneWayNest
    n, w, r = MAIN_SIZE, NEST_WINDOW, NEST_RATIO
    o = (n - w) // 2

    def parent():
        p = gw.build(n, n, dt=0.05, depth=10.0, device=DEV)
        p.set_initial_eta(gaussian_eta(n, n, amp=0.5))
        return p
    p1 = parent()
    one = OneWayNest(p1, origin=(o, o), shape=(w, w), ratio=1)
    one.sync_from_parent()
    one.run(NEST_STEPS)
    pg = p1.eta.gather_inner_data()
    cg = one.child.eta.gather_inner_data()
    if not np.array_equal(cg[2:-2, 2:-2], pg[o + 2:o + w - 2,
                                             o + 2:o + w - 2]):
        raise AssertionError("ratio-1 nest: child interior differs from "
                             "the parent window")
    p = parent()
    nest_ = OneWayNest(p, origin=(o, o), shape=(w, w), ratio=r,
                       two_way=True)
    nest_.sync_from_parent()
    nest_.run(NEST_STEPS)
    for f in (p.eta, p.u, p.v, nest_.child.eta, nest_.child.u,
              nest_.child.v):
        if not torch.isfinite(f.data).all():
            raise AssertionError("two-way nest not finite")
    us = 1e3 * _time_ms(lambda: nest_.run(5), 3) / 5
    us_p = 1e3 * _time_ms(lambda: p.run(5), 3) / 5
    us_c = 1e3 * _time_ms(lambda: nest_.child.run(5 * r), 3) / 5
    cny = nest_.child.grid.decomp.global_ny
    print(f"nest (e): gravity wave {n}^2 f32, two-way ratio {r} over a "
          f"{w}^2 window (child {cny}^2), {NEST_STEPS} parent steps: "
          f"finite; ratio-1 child interior bitwise equal to the parent "
          f"window; {us:.1f} us per nest step vs parent step {us_p:.1f} + "
          f"{r} child steps {us_c:.1f} = {us_p + us_c:.1f}", flush=True)
    return {"us_per_nest_step": us, "us_parent_step": us_p,
            "us_child_steps": us_c}


def _overlap_one() -> tuple[dict, dict]:
    """(f) the flagship at the main width, halo 2, one tile, OVERLAP_STEPS
    steps, plain and fused=True at K=1: overlap bitwise equal to the
    non-overlapped step at internal points; us/step of both; the K=1
    sweep's launches on the overlapped run and its kernel entry."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    n, steps = MAIN_SIZE, OVERLAP_STEPS
    out, entry = {}, None
    for fused in (False, True):
        m = mpc.overlap_model(n, n, 1, fused, False, DEV)
        inner = m.sshn_t.internal_mask.bool()
        ref = mpc.overlap_run(m, steps, False)
        torch.cuda.synchronize()
        fs.nemolite2d_sweep.launches = 0
        got = mpc.overlap_run(m, steps, True)
        torch.cuda.synchronize()
        launches = fs.nemolite2d_sweep.launches
        for a, b in zip(got, ref):
            if not torch.equal(a[inner], b[inner]):
                raise AssertionError(
                    f"overlap (fused={fused}) differs from the "
                    f"non-overlapped step: max abs "
                    f"{float((a - b).abs()[inner].max()):.3e}")
        if launches != (steps if fused else 0):
            raise AssertionError(f"overlap fused={fused}: {launches} sweep "
                                 f"launches in {steps} steps")
        nt = mpc.OVERLAP_TIMED_STEPS
        us = {ov: 1e3 * _time_ms(lambda: mpc.overlap_run(m, nt, ov), 3)
              / nt for ov in (False, True)}
        tag = "fused" if fused else "plain"
        out[tag] = {"us_step": us[False], "us_overlap": us[True]}
        print(f"overlap (f): flagship {n}^2 f32 halo 2, one tile, {steps} "
              f"steps, {tag}: bitwise equal to the non-overlapped step on "
              f"internal points; {us[True]:.2f} us/step overlapped vs "
              f"{us[False]:.2f} not; sweep launches {launches}", flush=True)
        if fused:
            entry = _flagship_entry(m, 1, launches,
                                    "nemolite2d_sweep_k1_overlap",
                                    "dl_esm_inf_tpu/ops/pallas_step.py:33")
            fused1 = m._make_fused(1)
            state = (m.sshn_t.data, m.un.data, m.vn.data)
            forcing = m.forcing_series(m._istep0, 1)
            entry["wrapper_ms"] = entry["ms"]
            entry["ms"] = _graph_ms(
                lambda: fused1(*state, m._mask_codes, forcing), 20)
            entry["path"] = ("the overlapped step's interior (K=1 on the "
                             "un-exchanged block), 1 launch per step")
    return out, entry


def _overlap_ranks() -> dict:
    """(g) overlap on a 2-rank gang, one tile per rank: every
    configuration bitwise against one process with 2 tiles on the
    non-overlapped step; us/step with and without overlap; one
    overlapped step's device work in order beside the host's exchange
    call."""
    import tempfile
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    n, steps = MAIN_SIZE, OVERLAP_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        r2 = _gang(2, "overlap", Path(tmp) / "ov2.npz", "--overlap-shape",
                   f"{n}x{n}", "--overlap-steps", str(steps),
                   "--overlap-depths", "flat")
    out = {}
    for fused in (False, True):
        tag = f"{'fused' if fused else 'plain'}_flat"
        m = mpc.overlap_model(n, n, 2, fused, False, DEV)
        want = mpc.overlap_gather(m, mpc.overlap_run(m, steps, False))
        for k, v in want.items():
            for mode in ("overlap", "step"):
                if not np.array_equal(r2[f"ov_{tag}_{mode}_{k}"], v):
                    raise AssertionError(f"2 ranks {tag} {mode} {k} differs "
                                         f"from one process with 2 tiles")
        if fused and int(r2[f"ov_launches_{tag}"]) != 2 * steps:
            raise AssertionError(f"2 ranks {tag}: "
                                 f"{int(r2[f'ov_launches_{tag}'])} sweep "
                                 f"launches per rank in 2 x {steps} steps")
        out[tag] = {"us_step": float(r2[f"ov_us_{tag}_step"]),
                    "us_overlap": float(r2[f"ov_us_{tag}_overlap"])}
        shown = ""
        if fused:
            starts = r2[f"ov_order_start_us_{tag}"]
            t_0 = float(starts.min()) if len(starts) else 0.0
            out[tag]["order"] = order = [
                (str(nm), float(a) - t_0, float(b) - t_0)
                for nm, a, b in zip(r2[f"ov_order_{tag}"], starts,
                                    r2[f"ov_order_end_us_{tag}"])]
            wait = (None if f"ov_wait_us_{tag}" not in r2 else
                    [float(x) - t_0 for x in r2[f"ov_wait_us_{tag}"]])
            out[tag]["wait"] = wait
            shown = ("; one overlapped step on rank 0 (us from its first "
                     "device operation): "
                     + "; ".join(f"{nm[:40]} {a:.0f}-{b:.0f}"
                                 for nm, a, b in order[:12])
                     + "; the host's exchange call "
                     + ("not traced" if wait is None
                        else f"{wait[0]:.0f}-{wait[1]:.0f}"))
        print(f"overlap (g): 2 ranks x 1 tile, flagship {n}^2 f32 halo 2, "
              f"{steps} steps, {tag}: overlapped and not, bitwise equal to "
              f"one process with 2 tiles; {out[tag]['us_overlap']:.2f} "
              f"us/step overlapped vs {out[tag]['us_step']:.2f} not"
              + shown, flush=True)
    return out


def phase_filter_nest_overlap() -> tuple[dict, dict]:
    """Phase 21, the ETKF and LETKF, nesting and overlap mode on the card:
    (a) the global ETKF and (b) the LETKF at the main width, (c) the DA
    demo's configuration, (d) float64 card vs CPU, (e) nesting at the
    main width, (f) overlap in one process and (g) on 2 ranks.  Returns
    the phase's numbers and the overlap's kernel entry."""
    t0 = time.perf_counter()
    out, secs = {}, {}
    for name, part in (("etkf", _etkf_global), ("letkf", _letkf_main),
                       ("da_demo", _da_demo), ("f64", _da_f64),
                       ("nest", _nest_main), ("overlap", _overlap_one),
                       ("overlap_ranks", _overlap_ranks)):
        t1 = time.perf_counter()
        out[name] = part()
        secs[name] = time.perf_counter() - t1
    out["overlap"], entry = out["overlap"]
    out["seconds"] = time.perf_counter() - t0
    print(f"filter, nesting and overlap: phase took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")",
          flush=True)
    return out, entry


# --- phase 22, the ensemble, the adjoint and nesting across ranks -----------

#: the gang's legs, and the observed rows and columns of its global ETKF
#: and LETKF (every LETKF_STRIDE-th from LETKF_STRIDE / 2: 16 x 16 = 256
#: observations).  The global ETKF observes these 256 points, not every
#: point: observing all 2^20 points at sigma 0.02, the largest
#: eigenvalue of (m-1) I + S is ~1e6 against m-1 = 7 at the null
#: direction, and a float32 eigh of that matrix moves the anomaly
#: weights by ~4e-3 of themselves between moments that differ in their
#: last bit (the card read 2e-3 of u's largest value apart)
DA_RANKS_LEGS = "ensemble,adjoint,nest"
DA_RANKS_OBS = f"{LETKF_STRIDE // 2}:{MAIN_SIZE}:{LETKF_STRIDE}"
#: the flagship's cost and gradient: last observed step, remat chunk
DA_RANKS_STEPS = ADJ_STEP
DA_RANKS_REMAT = 8
NEST_RANKS_STEPS = 5
#: 2 ranks against one process, relative to each field's largest value
#: (the gradient: to its largest component; the nest: to its model's
#: largest state value, as phase 19 holds the semi-implicit model: a
#: rounding of eta reaches u through g dt / dx ~ 0.5 a step, and u's
#: largest value is ~30x smaller than eta's).  Where an all-reduce adds
#: the ranks' partial sums, float32 rounds them in another order: the
#: ETKF's (M, M) moments (the analysis inherits their rounding through
#: a float32 eigh of condition ~1e3: ~eps * 1e3 of the increment), the
#: cost two halves of the misfit, the feedback r x r = 16 child cells a
#: parent cell
TOL_DA_ANALYSIS = 1e-4
TOL_DA_COST = 1e-5
TOL_DA_GRAD = 1e-5
TOL_DA_NEST = 1e-5
#: phase 22's results held between the seam transports at the tolerances
#: above, not bitwise: the analyses (a float32 eigh of their moments)
#: and the forecasts after them, and the nest (its feedback adds child
#: cells in an order the card may change between runs)
DA_SEAM_TOLERATED = ("ek_", "lk_", "nest_main_")


def _rel_max(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    d = float(np.abs(a - b).max())
    return d, d / max(float(np.abs(b).max()), 1e-30)


def _held(label: str, a, b, tol: float, scale=None) -> str:
    """``a`` against ``b`` within ``tol`` of ``scale`` (default: ``b``'s
    largest value), as printed text; raises beyond it."""
    d, rel = _rel_max(a, b)
    if scale is not None:
        rel = d / scale
    if not rel <= tol:
        raise AssertionError(f"2 ranks, {label}: max abs {d:.3e}, "
                             f"{rel:.3e} of the largest value > tol {tol}")
    return f"{label} max abs {d:.3e} (rel {rel:.3e}, tol {tol:g})"


def _da_ensemble(r: dict, n: int) -> dict:
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    one = mpc.ensemble_run(n, 2, DEV, ENS_MEMBERS, DA_RANKS_OBS,
                           LETKF_RADIUS, etkf_obs=DA_RANKS_OBS)
    for k in ("eta", "u", "v"):
        if not np.array_equal(r[f"ef_{k}"], one[f"ef_{k}"]):
            raise AssertionError(f"2 ranks, ensemble forecast {k}: max abs "
                                 f"{_rel_max(r[f'ef_{k}'], one[f'ef_{k}'])}"
                                 " against one process (bitwise expected)")
    texts, out = [], {}
    for tag, name in (("ek", "global ETKF"), ("lk", "LETKF")):
        for stage, what in ((f"{tag}_an", "analysis"),
                            (tag, "2 steps after")):
            texts.append("; ".join(
                _held(f"{name} {what} {k}", r[f"{stage}_{k}"],
                      one[f"{stage}_{k}"], TOL_DA_ANALYSIS)
                for k in ("eta", "u", "v")))
            out[f"{stage}_rel"] = max(
                _rel_max(r[f"{stage}_{k}"], one[f"{stage}_{k}"])[1]
                for k in ("eta", "u", "v"))
            # under gloo seams: the same tolerance, and peer vs gloo
            for k in ("eta", "u", "v"):
                _held(f"{name} {what} {k} (gloo seams)",
                      r[f"gloo__{stage}_{k}"], one[f"{stage}_{k}"],
                      TOL_DA_ANALYSIS)
                _held(f"{name} {what} {k} (peer vs gloo seams)",
                      r[f"{stage}_{k}"], r[f"gloo__{stage}_{k}"],
                      TOL_DA_ANALYSIS)
            out[f"{stage}_seams_bitwise"] = all(np.array_equal(
                r[f"{stage}_{k}"], r[f"gloo__{stage}_{k}"])
                for k in ("eta", "u", "v"))
        out[f"{tag}_ms_ranks2"] = float(r[f"{tag}_ms"])
        out[f"{tag}_ms_ranks2_gloo"] = _g(r, f"{tag}_ms")
        out[f"{tag}_ms_one"] = float(one[f"{tag}_ms"])
    print(f"2 ranks x 1 tile, ensemble of {ENS_MEMBERS} gravity-wave members "
          f"f32 {n}^2, 256 observations: forecast bitwise equal to one "
          f"process with 2 tiles; " + "; ".join(texts)
          + f"; the same under gloo seams within the tolerance, peer vs gloo"
          f" bitwise: " + ", ".join(f"{k.removesuffix('_seams_bitwise')} "
                                   f"{v}" for k, v in out.items()
                                   if k.endswith("_seams_bitwise"))
          + f"; ms per analysis on 2 ranks under peer seams, under gloo and "
          f"in one process: global ETKF {out['ek_ms_ranks2']:.1f} / "
          f"{out['ek_ms_ranks2_gloo']:.1f} / {out['ek_ms_one']:.1f}"
          f"{_pr23('ek')}, LETKF (L={LETKF_RADIUS:g}) "
          f"{out['lk_ms_ranks2']:.1f} / {out['lk_ms_ranks2_gloo']:.1f} / "
          f"{out['lk_ms_one']:.1f}{_pr23('lk')} (host clock) [{SMI}]",
          flush=True)
    return out


def _da_adjoint(r: dict, n: int) -> dict:
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    one = mpc.adjoint_run("flagship", n, DA_RANKS_STEPS, 2, DEV,
                          DA_RANKS_REMAT)
    c2, c1 = float(r["adj_flagship_cost"]), float(one["adj_flagship_cost"])
    if not (c1 > 0 and abs(c2 - c1) <= TOL_DA_COST * c1):
        raise AssertionError(f"2 ranks, flagship cost {c2} vs {c1}")
    g_text = _held("gradient", r["adj_flagship_grad"],
                   one["adj_flagship_grad"], TOL_DA_GRAD)
    out = {"cost_rel": abs(c2 - c1) / c1,
           "grad_rel": _rel_max(r["adj_flagship_grad"],
                                one["adj_flagship_grad"])[1],
           "ms_ranks2": float(r["adj_flagship_ms"]),
           "ms_ranks2_gloo": _g(r, "adj_flagship_ms"),
           "ms_one": float(one["adj_flagship_ms"])}
    print(f"2 ranks x 1 tile, flagship f32 {n}^2, {DA_RANKS_STEPS}-step "
          f"cost and gradient at remat_chunk={DA_RANKS_REMAT}: cost {c2:.6e} "
          f"vs {c1:.6e} in one process with 2 tiles (rel "
          f"{out['cost_rel']:.3e}, tol {TOL_DA_COST:g}); {g_text}; cost and "
          f"gradient bitwise between peer and gloo seams; ms per cost + "
          f"gradient on 2 ranks under peer seams, under gloo and in one "
          f"process {out['ms_ranks2']:.1f} / {out['ms_ranks2_gloo']:.1f} / "
          f"{out['ms_one']:.1f} (host clock) [{SMI}]", flush=True)
    return out


def _da_nest(r: dict, n: int) -> dict:
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    case = mpc.nest_main_case(n, NEST_WINDOW, NEST_RATIO, NEST_RANKS_STEPS)
    one = mpc.nest_run("main", case, 2, DEV)
    fields = [(who, k) for who in ("p", "c0") for k in ("eta", "u", "v")]
    scale = {who: max(float(np.abs(one[f"nest_main_{who}_{k}"]).max())
                      for k in ("eta", "u", "v")) for who in ("p", "c0")}
    texts = [_held(f"{who} {k}", r[f"nest_main_{who}_{k}"],
                   one[f"nest_main_{who}_{k}"], TOL_DA_NEST, scale[who])
             for who, k in fields]
    for who, k in fields:
        _held(f"{who} {k} (gloo seams)", r[f"gloo__nest_main_{who}_{k}"],
              one[f"nest_main_{who}_{k}"], TOL_DA_NEST, scale[who])
        _held(f"{who} {k} (peer vs gloo seams)", r[f"nest_main_{who}_{k}"],
              r[f"gloo__nest_main_{who}_{k}"], TOL_DA_NEST, scale[who])
    bitwise = all(np.array_equal(r[f"nest_main_{w}_{k}"],
                                 r[f"gloo__nest_main_{w}_{k}"])
                  for w, k in fields)
    out = {"rel": max(float(np.abs(r[f"nest_main_{w}_{k}"]
                                   - one[f"nest_main_{w}_{k}"]).max())
                      / scale[w] for w, k in fields),
           "ms_ranks2": float(r["nest_main_ms_per_step"]),
           "ms_ranks2_gloo": _g(r, "nest_main_ms_per_step"),
           "ms_one": float(one["nest_main_ms_per_step"]),
           "seams_bitwise": bitwise}
    print(f"2 ranks x 1 tile, gravity wave f32 {n}^2 with a two-way ratio-"
          f"{NEST_RATIO} nest over a {NEST_WINDOW}^2 window, "
          f"{NEST_RANKS_STEPS} steps, against one process with 2 tiles "
          f"(parent p, child c0; rel: of the model's largest state value): "
          + "; ".join(texts)
          + f"; the same under gloo seams within the tolerance (peer vs gloo"
          f" bitwise: {bitwise}); ms per nest step on 2 ranks under peer "
          f"seams, under gloo and in one process {out['ms_ranks2']:.1f} / "
          f"{out['ms_ranks2_gloo']:.1f} / {out['ms_one']:.1f}{_pr23('nest')}"
          f" (host clock) [{SMI}]", flush=True)
    return out


def phase_da_ranks() -> dict:
    """Phase 22, the ensemble, the adjoint and nesting across ranks: a
    2-rank gang, 2 ranks x 1 tile, at the main width f32, each path held
    against one process with 2 tiles (module docstring), with host ms of
    both."""
    import tempfile
    n = MAIN_SIZE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = _gang(2, DA_RANKS_LEGS, Path(tmp) / "da2.npz", "--ndomains", "2",
                  "--ens-n", str(n), "--members", str(ENS_MEMBERS),
                  "--letkf-obs", DA_RANKS_OBS, "--etkf-obs", DA_RANKS_OBS,
                  "--letkf-radius",
                  str(LETKF_RADIUS), "--adjoint-cases", "flagship",
                  "--adjoint-n", str(n), "--adjoint-steps",
                  str(DA_RANKS_STEPS), "--remat", str(DA_RANKS_REMAT),
                  "--nest-cases", "main", "--nest-window", str(NEST_WINDOW),
                  "--nest-ratio", str(NEST_RATIO), "--nest-steps",
                  str(NEST_RANKS_STEPS), *SEAMS)
        out = {"seam_batches": _check_seams(
            r, "phase 22's 2-rank gang", DA_RANKS_LEGS,
            tolerated=DA_SEAM_TOLERATED)}
        out.update({"ensemble": _da_ensemble(r, n),
                    "adjoint": _da_adjoint(r, n), "nest": _da_nest(r, n)})
    out["seconds"] = time.perf_counter() - t0
    print(f"ensemble, adjoint and nesting across ranks: phase took "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# --- phase 19, the slice across ranks ----------------------------------------

#: the slice's legs across 2 ranks x 1 tile on the card
SLICE_LEGS = ("solvers,semi_implicit,clients,schedule,psy,coupled,"
              "checkpoint,tiles")
#: a float32 reduction over the 2^20 points of the schedule leg's field
#: on 2 ranks against one process, relative: its partial sums are added
#: in another order
TOL_RED = 1e-5


def _us_run(fn, steps: int, reps: int = 3) -> float:
    """µs per step of ``fn`` (``steps`` steps a call), CUDA events."""
    return 1e3 * _time_ms(fn, reps) / steps


def _one_process_clients(r: dict, n: int, steps: int) -> dict:
    """Each client in one process on 2 tiles against the gang: bitwise,
    launches per rank; µs per step of both.  Returns kernel name ->
    the numbers its kernel entry gains."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    out = {}
    for name, (mod, kw, K, init) in mpc.client_cases(n).items():
        m = mpc.client_model(name, n, 2, DEV)
        m.run(steps)
        d = max(float(np.abs(r[f"cl_{name}_{k}"] - v).max())
                for k, v in m.gather().items())
        want = steps // K + steps % K
        got = int(r[f"cl_launches_{name}"])
        if d != 0.0 or got != want:
            raise AssertionError(f"2 ranks, {name}: max abs {d} against one "
                                 f"process; {got} launches per rank, "
                                 f"expected {want}")
        us_1 = _us_run(lambda: m.run(steps), steps)
        us_2, us_2g = float(r[f"cl_us_{name}"]), _g(r, f"cl_us_{name}")
        print(f"2 ranks x 1 tile, {name} f32 {n}^2 K={K}, {steps} steps: "
              f"bitwise equal to one process with 2 tiles; {got} launches "
              f"per rank; {us_2:.2f} us/step on 2 ranks under peer seams, "
              f"{us_2g:.2f} under gloo, {us_1:.2f} in one process [{SMI}]",
              flush=True)
        out[(m.sweep_kernel.name, name)] = {"ranks2_launches": got,
                             "ranks2_us_per_step": us_2,
                             "ranks2_gloo_us_per_step": us_2g,
                             "one_process_2_tiles_us_per_step": us_1}
    return out


def _solver_close(label, xr, x1, tol, scale=None) -> float:
    """max |x_ranks - x_one| over ``scale`` (default: the largest |x|);
    raises above 10 tol."""
    scale = float(np.abs(x1).max()) if scale is None else scale
    d = float(np.abs(xr - x1).max()) / max(scale, 1e-30)
    if not d <= 10 * tol:
        raise AssertionError(f"2 ranks, {label}: {d:.3e} of the largest "
                             f"value > 10 x tol {tol}")
    return d


def _one_process_solvers(r: dict, n: int) -> dict:
    """The Helmholtz solves (CG, fused Chebyshev K=4) and 5 semi-implicit
    steps (CG; open north) in one process on 2 tiles against the gang:
    iterations within 2, residuals below tol, solutions within 10 tol of
    their largest value; ms per solve and per step of both."""
    from dl_esm_inf_tpu_torch.core import layout
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    g, rhs = mpc.solver_case(n, 2, DEV)
    b = tdl.Field(g, tdl.T_POINTS, init_global_data=rhs)
    out = {}
    for tag, kw in mpc.SOLVES.items():
        s = so.HelmholtzSolver(g, mpc.LAM, mpc.LAM, tol=mpc.solver_tol(
            g.dtype), **kw)
        mpc.warm_up(lambda: s.solve(b), DEV)
        so.helmholtz_cheb_sweep.launches = 0
        (x, info), ms_1 = mpc.timed_call(lambda: s.solve(b), DEV)
        launches = so.helmholtz_cheb_sweep.launches
        x1 = layout.unstack_internal(g.decomp, x.cpu().numpy())
        it_2, it_1 = int(r[f"hs_{tag}_iters"]), info["iterations"]
        rel_2 = float(r[f"hs_{tag}_rel_res"])
        if abs(it_2 - it_1) > 2 or not (rel_2 <= s.tol
                                       and info["rel_res"] <= s.tol):
            raise AssertionError(f"2 ranks, Helmholtz {tag}: iterations "
                                 f"{it_2} vs {it_1}, residuals {rel_2:.3e} "
                                 f"/ {info['rel_res']:.3e}, tol {s.tol}")
        if int(r[f"hs_{tag}_launches"]) != launches:
            raise AssertionError(f"2 ranks, Helmholtz {tag}: "
                                 f"{int(r[f'hs_{tag}_launches'])} sweep "
                                 f"launches per rank vs {launches}")
        d = _solver_close(f"Helmholtz {tag}", r[f"hs_{tag}_x"], x1, s.tol)
        ms_2, ms_2g = float(r[f"hs_{tag}_ms"]), _g(r, f"hs_{tag}_ms")
        print(f"2 ranks x 1 tile, Helmholtz {tag} f32 {n}^2 lam {mpc.LAM}: "
              f"{it_2} iterations vs {it_1} in one process with 2 tiles, "
              f"relative residual {rel_2:.3e} (tol {s.tol:.1e}), solutions "
              f"{d:.3e} of the largest value apart; sweep launches per rank "
              f"{launches}; {ms_2:.2f} ms per solve on 2 ranks under peer "
              f"seams, {ms_2g:.2f} under gloo{_pr23(tag)}, {ms_1:.2f} in one "
              f"process [{SMI}]", flush=True)
        out[tag] = {"ranks2_launches": launches, "ranks2_ms_per_solve": ms_2,
                    "ranks2_gloo_ms_per_solve": ms_2g,
                    "one_process_2_tiles_ms_per_solve": ms_1,
                    "ranks2_iterations": it_2}
    for tag, north in (("si", False), ("sio", True)):
        m = mpc.semi_implicit_model(n, 2, DEV, north)
        mpc.warm_up(lambda: mpc.semi_implicit_model(
            n, 2, DEV, north).run(1), DEV)
        info, ms_1 = mpc.timed_call(lambda: m.run(5), DEV)
        ms_1 /= 5
        g1 = m.gather()
        scale = max(float(np.abs(v).max()) for v in g1.values())
        d = max(_solver_close(f"semi-implicit {tag} {k}", r[f"{tag}_{k}"], v,
                              m.tol, scale) for k, v in g1.items())
        ms_2 = float(r[f"{tag}_ms_per_step"])
        ms_2g = _g(r, f"{tag}_ms_per_step")
        where = "open north" if north else "walled"
        print(f"2 ranks x 1 tile, semi-implicit ({where}) f32 {n}^2, 5 "
              f"steps: {int(r[f'{tag}_iters'])} CG iterations vs "
              f"{info['cg_iterations']} in one process with 2 tiles, "
              f"fields {d:.3e} of the state's largest value apart (tol 10 x "
              f"{m.tol:.1e}); {ms_2:.2f} ms/step on 2 ranks under peer "
              f"seams, {ms_2g:.2f} under gloo{_pr23(tag)}, {ms_1:.2f} in one "
              f"process [{SMI}]", flush=True)
        out[tag] = {"ranks2_ms_per_step": ms_2,
                    "ranks2_gloo_ms_per_step": ms_2g,
                    "one_process_2_tiles_ms_per_step": ms_1}
    return out


def _one_process_schedules(r: dict, n: int, steps: int) -> dict:
    """The fused schedule, its reductions, the PSy flagship and the
    coupled tracer in one process on 2 tiles against the gang."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    g, fa, fb, east = mpc.schedule_case(n, 2, DEV)
    sched = km.Schedule((east, fb, fa), (east, fb, fb))
    sched.fused()
    reds = [mpc.reduction_kernel(km, acc) for acc in mpc.REDUCTIONS]
    red_1 = [km.invoke(k, fa) for k in reds]
    red_2 = [float(r[f"sc_invoke_{acc}"]) for acc in mpc.REDUCTIONS]
    red_ok = all(abs(a - b) <= TOL_RED * abs(b) for a, b in zip(red_2, red_1))
    if (not np.array_equal(r["sc_fused"], fb.gather_inner_data())
            or not np.array_equal(r["sc_plain"], fb.gather_inner_data())
            or int(r["sc_launches"]) != 1 or not red_ok):
        raise AssertionError(f"2 ranks, fused schedule: launches "
                             f"{int(r['sc_launches'])}; reductions {red_2} "
                             f"vs {red_1}")
    us_s1 = 1e3 * _time_ms(sched.fused, 10)
    from dl_esm_inf_tpu_torch.models.nemolite2d_psy import NemoLite2DPsy
    m = NemoLite2DPsy(n, n, ndomains=2, halo_width=8, device=DEV)
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    m.run(steps, fused=True)
    d = max(float(np.abs(r[f"psy_{k}"] - v).max())
            for k, v in m.gather().items())
    if d != 0.0 or int(r["psy_launches"]) != steps:
        raise AssertionError(f"2 ranks, PSy flagship: max abs {d}, "
                             f"{int(r['psy_launches'])} launches per rank")
    us_p1 = _us_run(lambda: m.run(steps, fused=True), steps)
    ct = mpc.coupled_model(n, 2, DEV)
    ct.run(steps)
    d_c = max(float(np.abs(r[f"cp_{k}"] - v).max())
              for k, v in ct.gather().items())
    if d_c != 0.0:
        raise AssertionError(f"2 ranks, coupled tracer: max abs {d_c}")
    us_c1 = _us_run(lambda: ct.run(steps), steps, 1)
    us_s2, us_p2, us_c2 = (float(r["sc_fused_us"]), float(r["psy_us"]),
                           float(r["cp_us"]))
    us_s2g, us_p2g, us_c2g = (_g(r, "sc_fused_us"), _g(r, "psy_us"),
                              _g(r, "cp_us"))
    print(f"2 ranks x 1 tile, f32 {n}^2: fused schedule (two east shifts, "
          f"halo 2) and its plain run bitwise equal to one process with 2 "
          f"tiles, 1 launch per rank, invoke's sum/min/max within "
          f"{TOL_RED}; us per fused call on 2 ranks under peer seams, under "
          f"gloo and in one process {us_s2:.1f} / {us_s2g:.1f} / "
          f"{us_s1:.1f}; PSy flagship on Schedule.fused, {steps} steps: "
          f"bitwise, {int(r['psy_launches'])} launches per rank, us/step "
          f"{us_p2:.2f} / {us_p2g:.2f} / {us_p1:.2f}; coupled tracer "
          f"{steps} steps: bitwise, us/step {us_c2:.1f} / {us_c2g:.1f} / "
          f"{us_c1:.1f} [{SMI}]", flush=True)
    return {"schedule": {"ranks2_us_per_call": us_s2,
                         "ranks2_gloo_us_per_call": us_s2g,
                         "one_process_2_tiles_us_per_call": us_s1},
            "psy": {"ranks2_launches": int(r["psy_launches"]),
                    "ranks2_us_per_step": us_p2,
                    "ranks2_gloo_us_per_step": us_p2g,
                    "one_process_2_tiles_us_per_step": us_p1},
            "coupled": {"ranks2_us_per_step": us_c2,
                        "ranks2_gloo_us_per_step": us_c2g,
                        "one_process_2_tiles_us_per_step": us_c1}}


def _one_process_checkpoint(r: dict, n: int) -> dict:
    """The gang's checkpoint loaded in one process on one tile: bitwise
    equal to the saved arrays; ms per save of both."""
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    from dl_esm_inf_tpu_torch.utils import checkpoint
    want = mpc.checkpoint_fields(n)
    g = _sched_grid(n, 1, 1, None)        # the ranks' default dtype
    got = {"f": tdl.Field(g, tdl.T_POINTS),
           "f3": tdl.Field(g, tdl.T_POINTS, levels=3)}
    meta = checkpoint.load_fields(str(r["ck_path"]), got)
    for k, v in want.items():
        here = got[k].gather_inner_data()
        v = v.astype(here.dtype)
        if not (np.array_equal(here, v)
                and np.array_equal(r[f"ck_{k}"], v)) or meta["step"] != 7:
            raise AssertionError(f"checkpoint saved on 2 ranks: {k} differs "
                                 "loaded in one process or on the ranks")
    path = str(r["ck_path"]) + ".one.npz"
    ms_1 = mpc.timed_call(lambda: checkpoint.save_fields(path, got, step=7),
                          DEV)[1]
    ms_2, ms_2g = float(r["ck_save_ms"]), _g(r, "ck_save_ms")
    print(f"checkpoint f32 {n}^2 (a field and a 3-level one) saved on 2 "
          f"ranks x 1 tile: loaded back on the ranks into 4 tiles and in one "
          f"process into 1 tile, bitwise; {ms_2:.1f} ms per save on 2 "
          f"ranks under peer seams, {ms_2g:.1f} under gloo, {ms_1:.1f} in "
          f"one process [{SMI}]", flush=True)
    return {"ranks2_ms_per_save": ms_2, "ranks2_gloo_ms_per_save": ms_2g,
            "one_process_ms_per_save": ms_1}


def _one_process_tiles(r: dict, n: int, steps: int) -> dict:
    """The tiles leg (2 ranks x 4 tiles, the layout the remote-DMA
    exchange refuses) in one process on 8 tiles: gravity wave at K=8
    bitwise, with its launches; the CG solve's iterations within 2,
    residuals below tol, solutions within 10 tol; µs per step and ms per
    solve under both seams and in one process."""
    from dl_esm_inf_tpu_torch.core import layout
    from dl_esm_inf_tpu_torch.parallel import mp_check as mpc
    nd = mpc.TILES_PER_RANK * 2
    m = mpc.client_model("gravity_wave", n, nd, DEV)
    m.run(steps)
    d = max(float(np.abs(r[f"tl_gw_{k}"] - v).max())
            for k, v in m.gather().items())
    want = steps // 8 + steps % 8
    if d != 0.0 or int(r["tl_gw_launches"]) != want:
        raise AssertionError(f"2 ranks x 4 tiles, gravity wave: max abs {d}"
                             f" against one process, "
                             f"{int(r['tl_gw_launches'])} launches per rank")
    us_1 = _us_run(lambda: m.run(steps), steps)
    g, rhs = mpc.solver_case(n, nd, DEV)
    b = tdl.Field(g, tdl.T_POINTS, init_global_data=rhs)
    s = so.HelmholtzSolver(g, mpc.LAM, mpc.LAM, tol=mpc.solver_tol(g.dtype),
                           **mpc.SOLVES["cg"])
    mpc.warm_up(lambda: s.solve(b), DEV)
    (x, info), ms_1 = mpc.timed_call(lambda: s.solve(b), DEV)
    x1 = layout.unstack_internal(g.decomp, x.cpu().numpy())
    it_2, rel_2 = int(r["tl_cg_iters"]), float(r["tl_cg_rel_res"])
    if abs(it_2 - info["iterations"]) > 2 or not (
            rel_2 <= s.tol and info["rel_res"] <= s.tol):
        raise AssertionError(f"2 ranks x 4 tiles, CG: iterations {it_2} vs "
                             f"{info['iterations']}, residual {rel_2:.3e}")
    dx = _solver_close("CG on 4 tiles a rank", r["tl_cg_x"], x1, s.tol)
    out = {"gw_us_per_step": (float(r["tl_gw_us"]), _g(r, "tl_gw_us"), us_1),
           "cg_ms_per_solve": (float(r["tl_cg_ms"]), _g(r, "tl_cg_ms"),
                               ms_1)}
    print(f"{str(r['tl_layout'])} at {n}^2 f32 against one process on {nd} "
          f"tiles: gravity wave K=8, {steps} steps, bitwise, "
          f"{int(r['tl_gw_launches'])} launches per rank, us/step under peer"
          f" seams, under gloo and in one process "
          f"{out['gw_us_per_step'][0]:.2f} / {out['gw_us_per_step'][1]:.2f} "
          f"/ {us_1:.2f}; Helmholtz CG {it_2} iterations vs "
          f"{info['iterations']}, solutions {dx:.3e} of the largest value "
          f"apart, ms per solve {out['cg_ms_per_solve'][0]:.2f} / "
          f"{out['cg_ms_per_solve'][1]:.2f} / {ms_1:.2f} [{SMI}]", flush=True)
    return out


def phase_slice_ranks(kernels: list) -> dict:
    """Phase 19's slice across ranks: a 2-rank gang, 2 ranks x 1 tile, at
    the main width f32 (parallel/mp_check.py's slice legs), each held
    against one process with 2 tiles (bitwise; the solvers and the
    semi-implicit model within 10 x tol, their sums added in another
    order), with µs per step (ms per solve or save) of both; the kernel
    entries of the clients, the Chebyshev sweep and the schedule sweep
    gain their launches and times on 2 ranks."""
    import tempfile
    n, steps = MAIN_SIZE, GANG_STEPS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = _gang(2, SLICE_LEGS, Path(tmp) / "s2.npz", "--ndomains", "2",
                  *SEAMS)
        out = {"seam_batches": _check_seams(r, "the slice's 2-rank gang",
                                            SLICE_LEGS)}
        out["checkpoint"] = _one_process_checkpoint(r, n)
        out["clients"] = _one_process_clients(r, n, steps)
        out.update(_one_process_solvers(r, n))
        out.update(_one_process_schedules(r, n, steps))
        out["tiles"] = _one_process_tiles(r, n, steps)
    by_name = {e["name"]: e for e in kernels}
    for (kern, name), extra in out["clients"].items():
        if kern in by_name:
            by_name[kern].setdefault("ranks2", {})[name] = extra
    if "helmholtz_cheb_sweep" in by_name:
        by_name["helmholtz_cheb_sweep"]["ranks2"] = out["cheb"]
    psy = [e for e in kernels if e["name"].startswith("schedule_sweep")]
    if psy:
        psy[0]["ranks2"] = out["psy"]
    out["seconds"] = time.perf_counter() - t0
    print(f"slice across ranks: phase took {out['seconds']:.1f} s", flush=True)
    return out


def main() -> None:
    phase_device()
    phase_build()
    phase_parity_f64()
    phase_golden()
    kernels = [phase_main()]
    for c in CLIENTS:
        phase_client_parity(c)
        phase_client_golden(c)
        kernels.append(phase_client_main(c))
    phase_cheb_parity()
    kernels.append(phase_cheb_main())
    phase_semi_implicit()
    phase_nlayer_parity()
    phase_nlayer_golden()
    kernels.append(phase_nlayer_main())
    phase_schedule_plans()
    phase_schedule_parity()
    phase_psy_vs_production()
    kernels.extend(phase_psy_main())
    kernels.extend(phase_levels_main())
    phase_skeleton_edges()
    phase_exchange_parity()
    phase_ht_parity()
    phase_fused_transport()
    kernels.extend(phase_transport_main())
    phase_variants_parity()
    phase_rect_parity()
    kernels.extend(phase_kbench())
    phase_large(kernels)
    kernels.append(phase_fence())
    kernels.extend(phase_ranks())
    phase_slice_ranks(kernels)
    phase_adjoint_ensembles()
    kernels.append(phase_filter_nest_overlap()[1])
    phase_da_ranks()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
