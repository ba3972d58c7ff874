"""The JAX package's fused-transport sweep on the fused legs' start, for
tests/test_torch_multiprocess.py to hold the port's gangs against.

Run as a child process::

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_cpu_max_isa=SSE4_2" python tests/jax_fused_reference.py \\
        out.npz 48x64 3 4x1,1x4 2,4

It drives ``dl_esm_inf_tpu/ops/pallas_step.py::make_fused_step`` with
``exchange_spec`` (the remote-DMA exchange inside the sweep) in interpret
mode under a 1D mesh with logical peer ids, as
tests/test_sweep_fused.py:148-212 does, on the start of
``dl_esm_inf_tpu_torch.parallel.mp_check``'s fused legs (the same numpy
seed), with the port's forcing values, and writes the gathered fields of
every (layout, K) as ``{layout}_k{K}_{field}``.

Why a child process: XLA:CPU always lets LLVM fuse a multiply and an add
into one FMA, which rounds once where the port (and its CUDA kernels,
built with ``--fmad=false``) round twice, an ulp apart.  Limited to
SSE4.2 (``--xla_cpu_max_isa``), XLA has no FMA instruction to emit, and
the JAX kernel rounds where the port does, so the two compare bitwise.
The flag is process-wide, so it is set in this child and not in the
test process.
"""
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import dl_esm_inf_tpu as jdl  # noqa: E402
from dl_esm_inf_tpu.models import nemolite2d as jnl  # noqa: E402
from dl_esm_inf_tpu.ops.pallas_step import make_fused_step  # noqa: E402

from dl_esm_inf_tpu_torch.parallel import mp_check  # noqa: E402
from test_sweep_fused import mesh_1d  # noqa: E402

WALLED = (jdl.BC_EXTERNAL, jdl.BC_EXTERNAL, jdl.BC_NONE)


def fused_run(gnx, gny, px, py, K, nsweeps):
    """The JAX fused transport over ``nsweeps`` sweeps of K steps."""
    g = jdl.Grid(jdl.ARAKAWA_C, WALLED, jdl.OFFSET_NE)
    g.decompose(gnx, gny, ndomainx=px, ndomainy=py, halo_width=8,
                align=128, align_y=8)
    jdl.grid_init(g, 1000.0, 1000.0, jnl.default_tmask(gnx, gny))
    m = jnl.NemoLite2D(g)
    m.set_initial_ssh(mp_check.fused_initial_ssh(gnx, gny))
    # the port's forcing values (evaluated on the host by torch)
    port = mp_check.fused_model(SimpleNamespace(
        fused_shape=f"{gnx}x{gny}", device="cpu"), px, py, K)
    forcing = np.asarray(port.forcing_series(0, nsweeps * K))
    spec = g.halo_spec
    fused = make_fused_step(
        spec.local_ny, spec.local_nx, str(g.dtype), m.p, g.dx, g.dy,
        m._fcor, m.depth, interpret=True, steps_per_sweep=K,
        exchange_spec=spec, exchange_logical_ids=True)
    mesh, pspec = mesh_1d(g)
    tm = jax.device_put(np.asarray(m._mask_codes),
                        NamedSharding(mesh, pspec))
    state = [jax.device_put(np.asarray(x), NamedSharding(mesh, pspec))
             for x in (m.sshn_t.data, m.un.data, m.vn.data)]
    fn = jax.jit(jax.shard_map(
        lambda f, s_, u_, v_, tm_: fused(s_, u_, v_, tm_, f), mesh=mesh,
        in_specs=(P(),) + (pspec,) * 4, out_specs=(pspec,) * 3,
        check_vma=False))
    for s in range(nsweeps):
        state = list(fn(jnp.asarray(forcing[s * K:(s + 1) * K]), *state,
                        tm))
    for fld, out in zip((m.sshn_t, m.un, m.vn), state):
        fld.data = jax.device_put(np.asarray(out), g.sharding)
    return m.gather()


def main(argv):
    out, shape, nsweeps, layouts, ks = argv
    gnx, gny = (int(v) for v in shape.split("x"))
    res = {}
    for lay in layouts.split(","):
        px, py = (int(v) for v in lay.split("x"))
        for K in (int(k) for k in ks.split(",")):
            for k, v in fused_run(gnx, gny, px, py, K, int(nsweeps)).items():
                res[f"{lay}_k{K}_{k}"] = v
    np.savez(out + ".tmp.npz", **res)
    os.replace(out + ".tmp.npz", out)


if __name__ == "__main__":
    main(sys.argv[1:])
