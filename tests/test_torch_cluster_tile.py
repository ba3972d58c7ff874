"""The cluster form of the skeleton's sweeps: its tile rule and the Python
mirror, the forms a window takes, and the generated source.

``dl_esm_inf_tpu_torch/ops/stencil_sweep.py::cluster_tile`` mirrors
``cluster_shape`` of ``csrc/stencil_sweep.cuh``: a window past one CTA's
shared memory split by rows over the 4-16 CTAs of a thread-block cluster
(no window needs 2: where two CTAs hold it, one does on an 8-cell square).
Where a host C++ compiler is present, the header's rule is compiled and
compared with the mirror at the levels chain's window (4L + 1 float
planes and a code plane, ring 4) at the fewest levels past one CTA, at 75
levels and at the most levels the largest cluster holds, and on a sweep
of rings and bytes per point.  ``schedule_sweep.window_tile`` gives the
shared form below those levels, the cluster form up to the largest
cluster and the scratch form beyond; ``generate`` emits cluster barriers
and the cluster launch for the cluster form, leaves the shared form's
source as it was, and past the largest cluster emits the scratch form.  The kernels run on the card (tests/test_torch_gpu.py,
``chip_smoke.py``).
"""
import re
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch import level_schedules as sc
from dl_esm_inf_tpu_torch.api import kernel_meta as tkm
from dl_esm_inf_tpu_torch.ops import schedule_sweep as tss
from dl_esm_inf_tpu_torch.ops import stencil_sweep as sst

HEADER = (Path(__file__).resolve().parents[1] / "dl_esm_inf_tpu_torch"
          / "csrc" / "stencil_sweep.cuh")
#: the largest dynamic shared memory of one H100 block
BLOCK_SMEM = 232448
#: the levels chain's ring at halo 4 (its erosion)
RING = 4
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _bpp(levels, dtype):
    """Bytes per window point of the chain's sweeps: 4L + 1 float planes
    and one code plane."""
    return (4 * levels + 1) * dtype.itemsize + 1


def _first_past_one_cta(dtype):
    L = 1
    while sst.tile(RING, _bpp(L, dtype)) is not None:
        L += 1
    return L


def _last_in_a_cluster(dtype):
    L = _first_past_one_cta(dtype)
    while sst.cluster_tile(RING, _bpp(L + 1, dtype)) is not None:
        L += 1
    return L


#: the chain's level counts the rule is held at: the fewest past one CTA,
#: NEMO's 75 vertical levels, the most the largest cluster holds
LEVELS = {"first": _first_past_one_cta, "L75": lambda dtype: 75,
          "last": _last_in_a_cluster}


def test_cluster_constants_mirror_the_header():
    m = re.search(r"constexpr int kClusters\[3\] = \{([^}]*)\};",
                  HEADER.read_text())
    assert m
    assert tuple(int(x) for x in m.group(1).split(",")) == sst.CLUSTERS
    assert sst.SMEM_PER_SM - sst.SMEM_RESERVE == BLOCK_SMEM


def _rule_source():
    text = HEADER.read_text()
    a = text.index("constexpr int kSmemPerSM")
    b = text.index("// A window's geometry")
    return text[a:b]


def _compile_rule(tmp_path, body):
    """Compile the header's rule with ``body`` as main's for the host; its
    output lines, or a skip without a C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to compile the header's rule")
    src = tmp_path / "rule.cpp"
    src.write_text(
        "#include <cstdio>\n"
        "namespace sweep {\n"
        "constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }\n"
        + _rule_source() +
        "}\n"
        "int main() {\n" + body + "}\n")
    exe = tmp_path / "rule"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=120)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True, timeout=60).stdout.splitlines()


def _header_shapes(tmp_path, cases):
    """The header's cluster_shape of each (ring, bpp): (shape, cluster)."""
    out = _compile_rule(tmp_path, "".join(
        f"  {{ const sweep::ClusterShape c = sweep::cluster_shape({R}, "
        f"{bpp});\n    std::printf(\"%d %d %d %d "
        "%d %d\\n\", c.s.ty, c.s.tx, c.s.rl, c.s.wx, c.s.ctas, c.cluster); "
        "}\n" for R, bpp in cases))
    assert len(out) == len(cases)
    return [tuple(map(int, line.split())) for line in out]


def _mirror(R, bpp):
    got = sst.cluster_tile(R, bpp)
    return (*got[0], got[1]) if got else (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("which", list(LEVELS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_header_cluster_rule_equals_the_mirror(tmp_path, dt, which):
    """At the chain's window for these levels and dtype, the header's rule
    compiled for the host gives the mirror's tile and cluster; the cluster
    form's band of rows fits a CTA and the cluster's bands hold the
    window."""
    dtype = DTYPES[dt]
    L = LEVELS[which](dtype)
    bpp = _bpp(L, dtype)
    assert sst.tile(RING, bpp) is None
    [got] = _header_shapes(tmp_path, [(RING, bpp)])
    assert got == _mirror(RING, bpp), (dt, L)
    shape, cluster = sst.cluster_tile(RING, bpp)
    br = sst.band_rows(shape, RING, cluster)
    assert br * shape.wx * bpp <= BLOCK_SMEM
    assert (br - 1) * cluster < shape.ty + 2 * RING <= br * cluster
    if which == "last":
        assert cluster == sst.CLUSTERS[-1]
        assert sst.cluster_tile(RING, _bpp(L + 1, dtype)) is None


@pytest.mark.parametrize("ring", range(0, 9))
def test_header_cluster_rule_sweep(tmp_path, ring):
    """The header's rule against the mirror on a range of bytes per point,
    from the first that one CTA cannot hold on any tile to past the
    largest cluster; every tile keeps the ring and its 16-byte aligned
    window columns, its CTAs' bands fit a CTA and partition its rows, and
    the smallest cluster is taken that holds a window within the overhead
    (or the largest)."""
    bpps = list(range(60, 8200, 37))
    header = _header_shapes(tmp_path, [(ring, b) for b in bpps])
    for bpp, got in zip(bpps, header):
        assert got == _mirror(ring, bpp), (ring, bpp)
        found = sst.cluster_tile(ring, bpp)
        if found is None:
            continue
        s, c = found
        assert s.rl == -(-ring // 4) * 4 and s.wx - s.rl - s.tx >= ring
        assert s.wx in sst.WINDOW_X and s.tx % 4 == 0 and s.ty % 4 == 0
        assert sst.TILE_Y_MIN <= s.ty <= sst.TILE_Y_MAX and s.ctas == 0
        br = sst.band_rows(s, ring, c)
        assert br * s.wx * bpp <= BLOCK_SMEM
        # the bands partition the window rows, the first full
        wy = s.ty + 2 * ring
        sizes = [max(min(br, wy - r * br), 0) for r in range(c)]
        assert sum(sizes) == wy and sizes[0] == br
        assert sizes == sorted(sizes, reverse=True)
        over = (s.ty + 2 * ring) * s.wx * 1024 // (s.ty * s.tx)
        assert over <= sst.MAX_OVERHEAD or c == sst.CLUSTERS[-1]
        for smaller in sst.CLUSTERS[:sst.CLUSTERS.index(c)]:
            # a smaller cluster holds no 8-row window within the overhead
            for w in sst.WINDOW_X:
                tx = (w - s.rl - ring) // 4 * 4
                rows = smaller * (BLOCK_SMEM // (w * bpp))
                ty = min(rows - 2 * ring, sst.TILE_Y_MAX) // 4 * 4
                if tx >= 8 and ty >= sst.TILE_Y_MIN:
                    assert ((ty + 2 * ring) * w * 1024 // (ty * tx)
                            > sst.MAX_OVERHEAD), (ring, bpp, smaller, w)


@pytest.mark.parametrize("ring", range(0, 9))
def test_no_window_needs_two_ctas(ring):
    """Every window that one CTA cannot hold on any tile (pick_shape's,
    the 8-cell squares included) is past what two CTAs hold within the
    overhead on an 8-row tile: the reason kClusters starts at 4."""
    rl = -(-ring // 4) * 4
    for bpp in range(1, 8200):
        if sst.tile(ring, bpp) is not None:
            continue
        for w in sst.WINDOW_X:
            tx = (w - rl - ring) // 4 * 4
            rows = 2 * (BLOCK_SMEM // (w * bpp))
            ty = min(rows - 2 * ring, sst.TILE_Y_MAX) // 4 * 4
            if tx >= 8 and ty >= sst.TILE_Y_MIN:
                assert ((ty + 2 * ring) * w * 1024 // (ty * tx)
                        > sst.MAX_OVERHEAD), (ring, bpp, w)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_window_tile_forms_by_levels(dt):
    """The chain's window takes the shared form below the first level
    count past one CTA, the cluster form from there to the largest
    cluster (clusters that never shrink as levels grow), and the scratch
    form beyond; the window's bytes and the CTAs of the form."""
    dtype = DTYPES[dt]
    first, last = _first_past_one_cta(dtype), _last_in_a_cluster(dtype)
    assert first == (29 if dtype == torch.float64 else 57)
    assert last == (226 if dtype == torch.float64 else 453)
    before = 1
    for L in range(first - 3, last + 4):
        shape, nbytes, cluster = tss.window_tile(4 * L + 1, 0, 1, RING,
                                                 dtype)
        bpp = _bpp(L, dtype)
        assert nbytes == shape.window_bytes(RING, bpp)
        if L < first:
            assert cluster == 1 and shape == sst.tile(RING, bpp)
            assert nbytes <= BLOCK_SMEM
        elif L <= last:
            assert 4 <= cluster <= 16 and shape.ctas == 0
            assert (shape, cluster) == sst.cluster_tile(RING, bpp)
            assert cluster >= before
            before = cluster
        else:
            assert cluster == 0 and shape == sst.scratch_tile(RING)


def _grid(dtype, n=24):
    g = tdl.Grid(tdl.ARAKAWA_C, (tdl.BC_EXTERNAL, tdl.BC_EXTERNAL,
                                 tdl.BC_NONE), tdl.OFFSET_NE, dtype=dtype,
                 device="cpu")
    g.decompose(n, n, ndomains=1, halo_width=4)
    tdl.grid_init(g, 1.0, 1.0)
    return g


def _chain_sources(levels, dtype):
    """The chain's generated sweeps at ``levels`` as on a CUDA grid (the
    sources are generated, nothing is compiled)."""
    return _sources(tkm.Schedule(*sc.ml_calls(*sc.ml_fields(_grid(dtype),
                                                            levels))))


def _sources(sched):
    """A schedule's generated sweeps as on a CUDA grid."""
    captured = []
    real, build = tss.generate, tss.schedule_sweep.build

    def spy(steps, **kw):
        gen = real(steps, **kw)
        captured.append(gen)
        return gen
    grid = sched._grid
    dev = grid.device
    grid.device = types.SimpleNamespace(type="cuda")
    tss.generate = spy
    tss.schedule_sweep.build = lambda gen: None
    try:
        sched._fused_prog(2, 1)
    finally:
        tss.generate, tss.schedule_sweep.build = real, build
        grid.device = dev
    return captured


@pytest.mark.parametrize("which", ["first", "L75"])
def test_generate_cluster_form(which):
    """A chain past one CTA: both sweeps in the cluster form, a cluster
    barrier at each of the plan's barriers (and none of a CTA alone), the
    band accessors, the cluster launch and its cluster count."""
    dtype = torch.float64
    L = LEVELS[which](dtype)
    for gen in _chain_sources(L, dtype):
        assert gen.form == "cluster" and gen.cluster >= 2
        pl, text = gen.plan, gen.text
        assert text.count("sweep::cluster_sync();") == \
            sum(pl.barrier_before) + 1
        assert "__syncthreads()" not in text
        assert f"sweep::ClusterRing<K, " in text
        assert f", {gen.ring}, {tss.CLUSTER_THREADS}>," in text
        assert "int schedule_sweep_clusters(int ny, int nx)" in text
        assert "sweep::launch_cluster<Step>(" in text
        assert f"sweep::BandLevPut<T, G, {L}>" in text
        assert f"sweep::BandLev<T, G, {L}>" in text
        assert "sweep::LevPut<" not in text and "sweep::At<" not in text
        assert "scratch" not in text
        bpp = (gen.n_state + gen.n_aux) * 8 + gen.n_codes
        shape, cluster = sst.cluster_tile(gen.ring, bpp)
        assert (gen.tile, gen.cluster) == (shape, cluster)
        assert gen.smem_bytes == (sst.band_rows(shape, gen.ring, cluster)
                                  * shape.wx * bpp) <= BLOCK_SMEM
        assert gen.window_bytes == shape.window_bytes(gen.ring, bpp)
        assert f"rows split over the {cluster} CTAs" in text


def _past_the_largest_cluster(dtype):
    """The fewest levels at which level_ends and shift (L + 1 float planes
    and a code plane at ring 1) take the scratch form."""
    L = 1
    while tss.window_tile(L + 1, 0, 1, 1, dtype)[2]:
        L += 1
    return L


@pytest.mark.parametrize("dt", list(DTYPES))
def test_generate_scratch_form_past_the_largest_cluster(dt):
    """level_ends then shift (a pass, a barrier, a staged pass that reads
    one cell east): one level short of the largest cluster's limit, the
    cluster form of 16 CTAs with cluster barriers; at the limit, the
    scratch form's source: the window in a scratch buffer, CTA barriers,
    the scratch entry points and its persistent launch."""
    dtype = DTYPES[dt]
    L = _past_the_largest_cluster(dtype)
    assert L == (907 if dtype == torch.float64 else 1815)
    for levels in (L - 1, L):
        f = sc.ends_fields(_grid(dtype), levels)
        [gen] = _sources(tkm.Schedule(*sc.ends_calls(*f)))
        bpp = (gen.n_state + gen.n_aux) * dtype.itemsize + gen.n_codes
        assert (gen.n_state, gen.n_aux, gen.ring) == (1, levels, 1)
        pl, text = gen.plan, gen.text
        assert pl.barrier_before == (False, True)
        assert pl.in_place == (True, False)
        assert f"sweep::Lev<T, G::WX, G::WC, {levels}> x" in text \
            or f"sweep::BandLev<T, G, {levels}> x" in text
        if levels < L:
            assert (gen.form, gen.cluster) == ("cluster", 16)
            assert text.count("sweep::cluster_sync();") == 2
            assert "__syncthreads()" not in text
            assert "sweep::launch_cluster<Step>(" in text
            continue
        assert (gen.form, gen.cluster, gen.smem_bytes) == ("scratch", 0, 0)
        assert gen.tile == sst.scratch_tile(1)
        assert gen.window_bytes == 10 * 32 * bpp
        assert sst.cluster_tile(1, bpp) is None
        assert text.count("__syncthreads();") == 2
        assert "sweep::ScratchRing<K, 1, 1, 256>" in text
        assert "size_t schedule_sweep_scratch_stride()" in text
        assert "int schedule_sweep_ctas(int ny, int nx, long long cap)" in text
        assert "void* scratch, int ctas," in text
        assert "sweep::launch_scratch<Step>(" in text
        assert "extern __shared__" not in text and "cluster" not in text


#: the generated sources of chains that fit one CTA, by (levels, dtype):
#: library names, keyed by a hash of each source (full, light), as the
#: generator gave them before the cluster form existed
SHARED_NAMES = {
    (8, torch.float32): ("schedule_sweep_cdadaa9c2989",
                         "schedule_sweep_1a66719ee051"),
    (28, torch.float64): ("schedule_sweep_d250f4e3f93f",
                          "schedule_sweep_7996b90b222a"),
}


@pytest.mark.parametrize("levels,dtype", list(SHARED_NAMES))
def test_generate_shared_form_unchanged(levels, dtype):
    """A chain that fits one CTA keeps the shared form and the very source
    it had before the cluster form: the same hashed library names, no
    cluster construct, a CTA barrier at each of the plan's barriers."""
    gens = _chain_sources(levels, dtype)
    assert tuple(g.name for g in gens) == SHARED_NAMES[(levels, dtype)]
    for gen in gens:
        assert gen.form == "shared" and gen.cluster == 1
        assert gen.text.count("__syncthreads();") == \
            sum(gen.plan.barrier_before) + 1
        assert "cluster" not in gen.text and "Band" not in gen.text
        assert "sweep::launch<Step>(p, c, static_cast<cudaStream_t>" \
            "(stream))" in gen.text
