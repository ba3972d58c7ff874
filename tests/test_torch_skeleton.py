"""The client sweeps' skeleton: its tile rule and the Python mirror.

``dl_esm_inf_tpu_torch/ops/stencil_sweep.py::tile`` mirrors
``pick_shape`` of ``csrc/stencil_sweep.cuh``: the constants are read
from the header, every shape's window fits the share of an SM its CTAs
per SM leave and has the ring on every side, wide windows start at
16-byte aligned columns, the generated schedule sweeps
(``schedule_sweep.window_tile``) and the compiled N-layer kernels
(``nlayer.kernel_tile``) follow the rule, the Chebyshev march's window
(the rule at its width and row cap, read from its source) covers its
column strips, the CTA's warps fit its window rows, and every window the
square tiles of 32, 16 and 8 cells fitted before still fits.  Where a
host C++ compiler is present, the header's rule itself is compiled and
compared with the mirror.  The kernels run on the card
(tests/test_torch_gpu.py, ``chip_smoke.py``).
"""
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from dl_esm_inf_tpu_torch.models import nlayer as tnl
from dl_esm_inf_tpu_torch.models import tracer as ttr
from dl_esm_inf_tpu_torch.ops import schedule_sweep as tss
from dl_esm_inf_tpu_torch.ops import stencil_sweep as sst

CSRC = Path(__file__).resolve().parents[1] / "dl_esm_inf_tpu_torch" / "csrc"
HEADER = CSRC / "stencil_sweep.cuh"
CHEB = CSRC / "helmholtz_cheb_sweep.cu"
TRACER = CSRC / "tracer_sweep.cu"
#: the largest dynamic shared memory of one H100 block
BLOCK_SMEM = 232448
RINGS = range(0, 9)
BPPS = (1, 5, 9, 12, 13, 17, 25, 33, 37, 49, 53, 61, 97, 133, 200, 265,
        400)


def _const(path, name):
    m = re.search(rf"constexpr int {name}(?:\[\d+\])? = ([^;]+);",
                  path.read_text())
    assert m, name
    text = m.group(1)
    if text.startswith("{"):
        return tuple(int(x) for x in text.strip("{}").split(","))
    return int(text)


def _threads(s, ring):
    """The CTA's threads where a kernel names no count (the header's
    NT, or kThreadsTall for a window of kTallRows rows or more)."""
    tall = s.ty + 2 * ring >= _const(HEADER, "kTallRows")
    return _const(HEADER, "kThreadsTall" if tall else "NT")


def _cheb_tile(dtype, K):
    """The Chebyshev march's tile: the rule for its window of x, r, d,
    the next d and the code (ring K) at the width and row cap of its
    source."""
    return sst.tile(K, 4 * dtype.itemsize + 1, _const(CHEB, "kWindowX"),
                    _const(CHEB, "kTileYMax"))


def test_tile_rule_mirrors_the_header():
    assert _const(HEADER, "kSmemPerSM") == sst.SMEM_PER_SM
    assert _const(HEADER, "kSmemReserve") == sst.SMEM_RESERVE
    assert _const(HEADER, "kCtasPerSM") == sst.CTAS_PER_SM
    assert _const(HEADER, "kTileYMax") == sst.TILE_Y_MAX
    assert _const(HEADER, "kTileYMin") == sst.TILE_Y_MIN
    assert _const(HEADER, "kMaxOverhead") == sst.MAX_OVERHEAD
    assert _const(HEADER, "kWindowX") == sst.WINDOW_X
    assert _const(HEADER, "kSquares") == sst.SQUARES
    assert _const(HEADER, "kScratchWX") == sst.SCRATCH_WX
    assert sst.SMEM_PER_SM - sst.SMEM_RESERVE == BLOCK_SMEM


def test_cheb_march_mirrors_its_source():
    """The march's Ring takes the width, threads and row cap its
    constants give, and its warps of 30 owned lanes fit a warp."""
    text = CHEB.read_text()
    assert ("sweep::Ring<K, 1, K, kWindowX, 32 * kColStrips * kStrips, "
            "kTileYMax>") in text
    assert ("constexpr int kColStrips = (kWindowX - 2 + kOwned - 1) / "
            "kOwned;") in text
    assert 1 <= _const(CHEB, "kOwned") <= 30


@pytest.mark.parametrize("ring", RINGS)
def test_tile_fits_and_keeps_the_ring(ring):
    for bpp in BPPS:
        s = sst.tile(ring, bpp)
        assert s is not None, bpp
        budget = sst.SMEM_PER_SM // s.ctas - sst.SMEM_RESERVE
        assert s.window_bytes(ring, bpp) <= budget
        assert s.rl >= ring and s.wx - s.rl - s.tx >= ring
        if s.wx in sst.WINDOW_X:
            # wide windows start at 16-byte aligned block columns
            assert s.rl % 4 == 0 and s.tx % 4 == 0 and s.wx % 4 == 0
            assert s.rl == -(-ring // 4) * 4
            assert s.tx == (s.wx - s.rl - ring) // 4 * 4
            assert s.ty % 4 == 0 and sst.TILE_Y_MIN <= s.ty <= sst.TILE_Y_MAX
            # the tallest tile the budget allows
            if s.ty < sst.TILE_Y_MAX:
                assert (s.ty + 4 + 2 * ring) * s.wx * bpp > budget
        else:
            assert s.tx == s.ty in sst.SQUARES and s.rl == ring
        if s.ctas > 1:
            assert (s.ty + 2 * ring) * s.wx * 1024 // (s.ty * s.tx) \
                <= sst.MAX_OVERHEAD
        # a CTA's warps take at least one window row each, two when it
        # has 512 threads
        warps = _threads(s, ring) // 32
        assert warps <= s.ty + 2 * ring
        assert warps == 8 or 2 * warps <= s.ty + 2 * ring


@pytest.mark.parametrize("ring", RINGS)
def test_every_window_that_fitted_still_fits(ring):
    """The square tiles of 32, 16 and 8 cells the skeleton used before
    are the rule's last resort, at one CTA per SM."""
    for bpp in range(1, 1200):
        before = any((e + 2 * ring) ** 2 * bpp <= BLOCK_SMEM
                     for e in (32, 16, 8))
        s = sst.tile(ring, bpp)
        if before:
            assert s is not None, bpp
            assert s.window_bytes(ring, bpp) <= BLOCK_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schedule_sweeps_follow_the_rule(dtype):
    es = dtype.itemsize
    for ring in RINGS:
        for n_float, n_int, n_codes in ((1, 0, 1), (7, 1, 1), (13, 2, 2),
                                        (33, 0, 1), (61, 0, 2)):
            bpp = n_float * es + 4 * n_int + n_codes
            s, cluster = sst.tile(ring, bpp), 1
            if s is None:       # past shared memory: the cluster form
                s, cluster = sst.cluster_tile(ring, bpp) or (None, 0)
            if s is None:       # past the largest cluster: the scratch form
                s = sst.scratch_tile(ring)
                assert s.ctas == 0 and s.wx == 32 and s.ty == 8
            assert tss.window_tile(n_float, n_int, n_codes, ring, dtype) \
                == (s, s.window_bytes(ring, bpp), cluster)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nlayer_compiled_tiles_follow_the_rule(dtype):
    """The N-layer march's tiles, compiled (L <= 8) and at run time: the
    rule with the march's widths, whose velocity columns fill whole
    strips of 31 lanes (squares only at one CTA per SM)."""
    es = dtype.itemsize
    for K in range(1, 9):
        for L in range(1, 2 * tnl.COMPILED_LAYERS + 1):
            bpp = 3 * L * es + 1
            extra = tnl.weight_bytes(L, dtype)
            s = sst.tile(K, bpp, march=True, extra=extra)
            if s is None:
                continue
            assert tnl.kernel_tile(L, dtype, K) == (s.ty, s.tx)
            assert s.window_bytes(K, bpp) + extra <= BLOCK_SMEM
            assert s.rl >= K and s.wx - s.rl - s.tx >= K
            widths = [sst.march_width(K, c) for c in (3, 2, 1)]
            if s.wx in widths and s.rl == -(-K // 4) * 4:
                # a march width: n strips of 31 owned lanes
                assert s.tx + 2 * K - 1 <= 31 * (3 - widths.index(s.wx))
                assert s.wx % 4 == 0 and s.rl % 4 == 0 and s.tx % 4 == 0
            else:
                assert s.ctas == 1 and s.tx in sst.SQUARES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_layer_count_still_builds(dtype):
    """The layer counts the kernel took before (every L <= 4 at every K
    on the skeleton's rule; 5..32 where an 8-cell square window and 2 KiB
    of static shared memory fitted) still get a tile, and so does every
    L up to the first that fits no window."""
    es = dtype.itemsize
    for K in range(1, 9):
        for L in range(1, 33):
            fitted = (sst.tile(K, 3 * L * es + 1) is not None if L <= 4
                      else 3 * L * (8 + 2 * K) ** 2 * es + (8 + 2 * K) ** 2
                      <= BLOCK_SMEM - 2048)
            if fitted:
                ty, tx = tnl.kernel_tile(L, dtype, K)
                assert ty >= 8 and tx >= 8
        L = 1
        while sst.tile(K, 3 * L * es + 1, march=True,
                       extra=tnl.weight_bytes(L, dtype)) is not None:
            L += 1
        with pytest.raises(ValueError, match="shared memory budget"):
            tnl.kernel_tile(L, dtype, K)
        assert L > 16 if es == 4 else L > 8


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cheb_window_covers_its_strips(dtype, K):
    owned, strips_y = _const(CHEB, "kOwned"), _const(CHEB, "kStrips")
    s = _cheb_tile(dtype, K)
    bpp = 4 * dtype.itemsize + 1
    assert s.wx == _const(CHEB, "kWindowX")
    assert s.rl >= K and s.wx - s.rl - s.tx >= K
    assert s.window_bytes(K, bpp) <= sst.SMEM_PER_SM // s.ctas \
        - sst.SMEM_RESERVE
    # the widest region (the window less one column each side) is
    # covered by whole column strips of owned lanes, and so is the tile
    strips = -(-(s.wx - 2) // owned)
    assert strips * owned >= s.wx - 2
    assert (strips - 1) * owned < s.wx - 2
    assert 32 * strips * strips_y <= 1024
    assert s.ty <= _const(CHEB, "kTileYMax")
    assert s.tx % 4 == 0 and s.rl % 4 == 0


def _rule_source():
    text = HEADER.read_text()
    a = text.index("constexpr int kSmemPerSM")
    b = text.index("// A window's geometry")
    return text[a:b]


def test_march_constants_mirror_the_header():
    assert _const(HEADER, "kMarchLanes") == sst.MARCH_LANES
    for ring in RINGS[1:]:
        for n in (1, 2, 3):
            w = sst.march_width(ring, n)
            tx = (w - -(-ring // 4) * 4 - ring) // 4 * 4
            assert w % 4 == 0 and tx >= 8
            assert tx + 2 * ring - 1 <= 31 * n < tx + 4 + 2 * ring - 1


def _compile_rule(tmp_path, body):
    """Compile the header's rule with ``body`` as main's for the host;
    its output lines, or a skip without a C++ compiler."""
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


def test_header_march_rule_equals_the_mirror(tmp_path):
    """The header's march rule (pick_shape with the march's widths and
    bytes beside the window), compiled for the host, against the mirror
    on every ring, a range of bytes per point and three extras; and the
    header's march_threads (two warp budgets, two strip heights) against
    its own contract: whole column strips, at most the warp budget over
    the CTAs of an SM, no more row strips than window rows."""
    out = _compile_rule(tmp_path, (
        "  const int extra[3] = {0, 144, 1056};\n"
        "  for (int R = 1; R <= 8; ++R)\n"
        "    for (int bpp = 13; bpp <= 800; bpp += 12)\n"
        "      for (int e = 0; e < 3; ++e) {\n"
        "        const sweep::Shape s = sweep::pick_shape(\n"
        "            R, bpp, 0, sweep::kTileYMax, true, extra[e]);\n"
        "        const int nx = s.ty ? sweep::march_strips(s, R) : 0;\n"
        "        const int t1 = s.ty ? sweep::march_threads(s, R) : 0;\n"
        "        const int t2 = s.ty ? sweep::march_threads(s, R, 32, 1) : 0;\n"
        "        std::printf(\"%d %d %d %d %d %d %d %d %d %d %d %d %d\\n\",\n"
        "                    R, bpp, extra[e], s.ty, s.tx, s.rl, s.wx,\n"
        "                    s.ctas, nx, t1, t2, sweep::kMarchWarps,\n"
        "                    sweep::kMarchRows);\n"
        "      }\n"))
    n = 0
    for line in out:
        R, bpp, extra, *shape, nx, t1, t2, warps, rows = map(int,
                                                            line.split())
        got = sst.tile(R, bpp, march=True, extra=extra)
        assert (tuple(got) if got else (0, 0, 0, 0, 0)) == tuple(shape), \
            (R, bpp, extra)
        if got:
            cols = got.tx + 2 * R - 1
            assert (nx - 1) * sst.MARCH_LANES < cols <= nx * sst.MARCH_LANES
            assert sst.march_threads(got, R, warps, rows) == t1
            assert sst.march_threads(got, R, 32, 1) == t2
            for t, w, r in ((t1, warps, rows), (t2, 32, 1)):
                assert t % (32 * nx) == 0 and t <= 1024
                assert t // 32 * got.ctas <= max(w, nx * got.ctas)
                assert t // (32 * nx) <= -(-(got.ty + 2 * R) // r)
        n += 1
    assert n == 8 * 66 * 3


def test_header_tracer_march_equals_the_mirror(tmp_path):
    """The tracer march's tile and threads, the header's rule compiled for
    the host with the march's warps and rows read from the kernel's
    source, against ``models/tracer.py::kernel_shape`` for both schemes,
    both dtypes and every K; its warps are whole column strips of owned
    lanes over the widest region (the tile and K - 1 reaches each
    side)."""
    text = TRACER.read_text()
    warps, rows = _const(TRACER, "kWarps"), _const(TRACER, "kRows")
    assert (warps, rows) == (ttr.MARCH_WARPS, ttr.MARCH_ROWS)
    assert ("sweep::Ring<K, REACH, K * REACH, 0, 0, sweep::kTileYMax, "
            "true, kWarps,") in " ".join(text.split())
    cases = [(scheme, reach, es, K)
             for scheme, reach, kmax in (("upwind", 1, 8), ("vanleer", 2, 4))
             for es in (4, 8) for K in range(1, kmax + 1)]
    out = _compile_rule(tmp_path, "".join(
        f"  {{ const sweep::Shape s = sweep::pick_shape({K * reach}, "
        f"{4 * es + 1}, 0, sweep::kTileYMax, true);\n"
        f"    std::printf(\"%d %d %d %d %d %d\\n\", s.ty, s.tx, s.rl, s.wx, "
        f"s.ctas, sweep::march_threads(s, {K * reach}, {warps}, {rows})); }}\n"
        for _, reach, es, K in cases))
    assert len(out) == len(cases)
    for line, (scheme, reach, es, K) in zip(out, cases):
        *shape, threads = map(int, line.split())
        dtype = torch.float32 if es == 4 else torch.float64
        got, got_threads = ttr.kernel_shape(scheme, dtype, K)
        assert tuple(got) == tuple(shape), (scheme, dtype, K)
        assert got_threads == threads, (scheme, dtype, K)
        ring = K * reach
        strips = -(-(got.tx + 2 * ring - 1) // sst.MARCH_LANES)
        assert got.tx + 2 * (ring - reach) <= strips * sst.MARCH_LANES
        assert threads % (32 * strips) == 0 and threads <= 1024
        assert got.rl >= ring and got.wx - got.rl - got.tx >= ring


def test_header_rule_equals_the_mirror(tmp_path):
    """The header's pick_shape, compiled for the host, against the
    mirror on every ring, a range of bytes per point, a fixed width and
    two row caps."""
    out = _compile_rule(tmp_path, (
        "  const int wfix[2] = {0, 92}, tymax[2] = {16, 40};\n"
        "  for (int R = 0; R <= 8; ++R)\n"
        "    for (int bpp = 1; bpp <= 400; bpp += 3)\n"
        "      for (int a = 0; a < 2; ++a)\n"
        "        for (int b = 0; b < 2; ++b) {\n"
        "          const sweep::Shape s =\n"
        "              sweep::pick_shape(R, bpp, wfix[a], tymax[b]);\n"
        "          std::printf(\"%d %d %d %d %d %d %d %d %d\\n\", R, bpp,\n"
        "                      wfix[a], tymax[b], s.ty, s.tx, s.rl, s.wx,\n"
        "                      s.ctas);\n"
        "        }\n"))
    n = 0
    for line in out:
        R, bpp, wfix, tymax, *shape = map(int, line.split())
        got = sst.tile(R, bpp, wfix, tymax)
        assert (tuple(got) if got else (0, 0, 0, 0, 0)) == tuple(shape), \
            (R, bpp, wfix, tymax)
        n += 1
    assert n == 9 * 134 * 4
