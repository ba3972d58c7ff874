"""The flagship kernels' tile rule and its Python mirror.

``dl_esm_inf_tpu_torch/ops/fused_step.py::tile`` mirrors ``Tile`` of
``csrc/nemolite2d_step.cuh``: every (dtype, K, depth) tile's window fits
an H100 block's shared memory and leaves room for two CTAs per SM, its
warps cover the widest update region, and the windows the plain compute
variant cuts (``_tile_windows``) put back (``_untile``) give the block.
The kernels themselves are held against their plain versions on the card
(tests/test_torch_gpu.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_esm_inf_tpu_torch.ops import fused_step as fs

HEADER = (Path(__file__).resolve().parents[1] / "dl_esm_inf_tpu_torch"
          / "csrc" / "nemolite2d_step.cuh")
#: the largest dynamic shared memory of one H100 block
BLOCK_SMEM = 232448


@pytest.mark.parametrize("ht", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_fits_two_ctas_per_sm(dtype, K, ht):
    t = fs.tile(dtype, K, ht)
    assert t.smem_bytes <= BLOCK_SMEM
    assert t.smem_bytes <= fs.smem_budget(K)
    ctas = fs.SMEM_PER_SM // (t.smem_bytes + fs.SMEM_RESERVE)
    assert ctas >= fs.CTAS_PER_SM[K - 1] >= 2
    assert t.threads % 32 == 0 and t.threads <= 1024
    # the column strips cover the widest continuity region (window - 2)
    warps_x = t.threads // 32 // fs.ROW_STRIPS
    assert warps_x * fs.OWNED_COLUMNS >= t.tx + 4 * K - 2
    assert (warps_x - 1) * fs.OWNED_COLUMNS < t.tx + 4 * K - 2
    # the largest edge the budget allows: one more step of 4 rows would
    # not fit
    es = torch.empty((), dtype=dtype).element_size()
    assert t.tx == (64 if es == 4 else 32)
    assert t.ty % 4 == 0 and 4 <= t.ty <= fs.TILE_Y_MAX
    if t.ty < fs.TILE_Y_MAX:
        row = t.smem_bytes // (t.ty + 4 * K)
        assert (t.ty + 4 + 4 * K) * row > fs.smem_budget(K)


def _header_int(name):
    m = re.search(rf"constexpr int {name}(?:\[4\])? = ([^;]+);",
                  HEADER.read_text())
    assert m, name
    return m.group(1)


def _header_ints(name):
    return tuple(int(x) for x in _header_int(name).strip("{}").split(","))


def test_tile_mirrors_the_header():
    assert int(_header_int("kOwned")) == fs.OWNED_COLUMNS
    assert int(_header_int("kRowStrips")) == fs.ROW_STRIPS
    assert _header_ints("kCtasPerSM") == fs.CTAS_PER_SM
    assert int(_header_int("kSmemPerSM")) == fs.SMEM_PER_SM
    assert int(_header_int("kSmemReserve")) == fs.SMEM_RESERVE
    assert int(_header_int("kTileYMax")) == fs.TILE_Y_MAX
    text = HEADER.read_text()
    assert "static constexpr int TX = ES == 4 ? 64 : 32;" in text
    assert "static constexpr int PLANES = HT ? 7 : 6;" in text
    assert "ty -= 4;" in text


@pytest.mark.parametrize("shape", [(40, 36), (97, 206), (170, 272), (65, 64)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_windows_round_trip(dtype, K, shape):
    a = torch.from_numpy(np.random.default_rng(K).standard_normal(shape)).to(
        dtype)
    t = fs.tile(dtype, K)
    win, (nty, ntx) = fs._tile_windows(a, K, t)
    R = 2 * K
    assert win.shape == (nty * ntx, t.ty + 2 * R, t.tx + 2 * R)
    assert nty == -(-shape[0] // t.ty) and ntx == -(-shape[1] // t.tx)
    assert torch.equal(fs._untile(win, K, t, nty, ntx, *shape), a)
    # the window of the last tile: reads clamped to the block edge
    ly, lx = shape
    y0, x0 = (nty - 1) * t.ty - R, (ntx - 1) * t.tx - R
    ys = np.clip(np.arange(y0, y0 + t.ty + 2 * R), 0, ly - 1)
    xs = np.clip(np.arange(x0, x0 + t.tx + 2 * R), 0, lx - 1)
    assert torch.equal(win[-1], a[ys][:, xs])
