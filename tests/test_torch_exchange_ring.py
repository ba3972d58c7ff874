"""The in-place (ring) form of the port's exchange kernel, on the CPU.

``csrc/halo_exchange.cu`` has two launch forms: the functional one, a new
block as the JAX package's ``make_block_exchange`` returns, and the ring
form, which writes only the halo ring in place and which
``Field.halo_exchange(transport="remote_dma")`` takes wherever
``halo_kernel.ring_in_place`` holds.  On the CPU the ring form's plain
version writes the plain exchange into the block; these tests hold it
bitwise against the JAX package's ppermute exchange, check that the
field's tensor keeps its storage, and pin the geometry the in-place rule
rests on from ``exchange_index`` alone: the ring is exactly the cells the
map moves, no source lies in it when the depth is at most the tile
extent, and above that one does (the rule is tight) except along an axis
of two walled tiles, where it is conservative.  The kernel itself is held
against these plain versions on the card by tests/test_torch_gpu.py and
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package below runs on its CPU mesh)

import dl_esm_inf_tpu as jdl
from dl_esm_inf_tpu.parallel import halo as jhalo

import dl_esm_inf_tpu_torch as tdl
from dl_esm_inf_tpu_torch.parallel import halo as thalo
from dl_esm_inf_tpu_torch.parallel import halo_kernel as thk

torch.set_num_threads(2)

TILES = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (4, 4)]
WRAPS = {"walled": (False, False), "x-periodic": (True, False),
         "y-periodic": (False, True), "xy-periodic": (True, True)}


def _bcs(wrap):
    return tuple(tdl.BC_PERIODIC if w else tdl.BC_EXTERNAL
                 for w in wrap) + (tdl.BC_NONE,)


def _extent(tiles, wrap, halo, base=None):
    """A global extent that splits into ``tiles``, of ``base`` points a
    tile (default: at least the halo, so every depth is in place);
    walled axes carry a remainder (padding in the last tile)."""
    base = base or max(halo, 5)
    return tuple(base * t + (0 if w else 1) for t, w in zip(tiles, wrap))


def _port_grid(tiles, wrap, halo, base=None):
    gnx, gny = _extent(tiles, wrap, halo, base)
    g = tdl.Grid(tdl.ARAKAWA_C, _bcs(wrap), tdl.OFFSET_NE, device="cpu")
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


# --- the ring form against the JAX exchange ---------------------------------

@pytest.mark.parametrize("halo", [1, 2, 8])
@pytest.mark.parametrize("wrap", ["walled", "xy-periodic"])
@pytest.mark.parametrize("tiles", TILES, ids=str)
def test_ring_plain_matches_jax_exchange(tiles, wrap, halo):
    """The ring form's plain version, in place, equals the JAX ppermute
    exchange bitwise at every depth, float64 and int32, 2D and 3 levels
    (tiles of at least the halo: every depth is in place)."""
    wrap = WRAPS[wrap]
    gj = _jax_grid(tiles, wrap, halo)
    spec = _port_grid(tiles, wrap, halo).halo_spec
    assert tuple(gj.array_shape) == spec.array_shape
    for depth in range(1, halo + 1):
        assert thk.ring_in_place(spec, depth)
        for dtype in (np.float64, np.int32):
            for lead in ((), (3,)):
                a = _unique(lead + spec.array_shape, dtype, depth)
                want = np.asarray(jhalo.exchange(a, gj.mesh, gj.halo_spec,
                                                 depth))
                blk = torch.from_numpy(a.copy())
                ptr = blk.data_ptr()
                assert thk.exchange_ring(blk, spec, depth) is blk
                assert blk.data_ptr() == ptr
                assert blk.dtype == torch.from_numpy(a).dtype
                np.testing.assert_array_equal(
                    blk.numpy(), want, err_msg=str((depth, dtype, lead)))


# --- Field.halo_exchange(transport="remote_dma") -----------------------------

#: (tiles, wrap, halo, tile base, depth): in place where the depth is at
#: most the tile extent, the functional form above it (base 3: tiles of 3
#: or 4 points)
FIELD_CASES = [((1, 1), "xy-periodic", 2, None, 2),
               ((2, 2), "walled", 8, None, 8),
               ((3, 2), "walled", 2, None, 1),
               ((4, 4), "xy-periodic", 2, None, 2),
               ((2, 2), "walled", 8, 16, 5),
               ((3, 2), "walled", 8, 3, 6),
               ((1, 1), "xy-periodic", 4, 3, 4),
               ((2, 2), "x-periodic", 4, 3, 4)]


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("tiles,wrap,halo,base,depth", FIELD_CASES,
                         ids=[f"{t}-{w}-h{h}-b{b}-d{d}"
                              for t, w, h, b, d in FIELD_CASES])
def test_field_remote_dma_in_place(tiles, wrap, halo, base, depth, levels):
    """``remote_dma`` keeps the field's storage (a tensor taken from
    ``data`` before the call sees the exchange) and equals ``ppermute``
    wherever ``ring_in_place`` holds; above it the field takes the
    functional form, a new tensor, equal all the same."""
    g = _port_grid(tiles, WRAPS[wrap], halo, base)
    spec = g.halo_spec
    lead = () if levels is None else (levels,)
    vals = _unique(lead + g.global_array_shape, np.float64, depth)
    fr = tdl.Field(g, tdl.T_POINTS, levels=levels)
    fp = tdl.Field(g, tdl.T_POINTS, levels=levels)
    fr.set_data(vals)
    fp.set_data(vals)
    before = fr.data
    host = fr.get_data()
    ptr = before.data_ptr()
    launches = (thk.halo_exchange.launches, thk.halo_exchange_ring.launches)
    fr.halo_exchange(depth, transport="remote_dma")
    fp.halo_exchange(depth)
    assert torch.equal(fr.data, fp.data)
    np.testing.assert_array_equal(host, vals)       # get_data copied
    in_place = thk.ring_in_place(spec, depth)
    assert in_place == (base != 3)
    if in_place:
        assert fr.data is before and fr.data.data_ptr() == ptr
    else:
        assert fr.data.data_ptr() != ptr
        np.testing.assert_array_equal(before.numpy(), vals)
    # the CPU runs the plain versions: no launch
    assert launches == (thk.halo_exchange.launches,
                        thk.halo_exchange_ring.launches)


def test_ring_form_refuses_and_never_falls_back():
    """The ring form raises where ``ring_in_place`` does not hold, on the
    CPU as the wrapper does on the card, and a tensor that is not on the
    CPU goes to the kernel or raises."""
    small = _port_grid((2, 2), (True, True), 4, 3).halo_spec
    blk = torch.from_numpy(_unique(small.array_shape, np.float64))
    with pytest.raises(ValueError, match="tile extent"):
        thk.exchange_ring(blk, small, 4)
    with pytest.raises(ValueError, match="depth"):
        thk.exchange_ring(blk, small, 5)
    with pytest.raises(ValueError, match="depth"):
        thk.remote_dma_exchange(blk, small, 0)
    spec = _port_grid((2, 2), (True, True), 2).halo_spec
    meta = torch.empty(spec.array_shape, dtype=torch.float64, device="meta")
    before = thk.halo_exchange_ring.launches
    for fn in (thk.exchange_ring, thk.remote_dma_exchange):
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta, spec, 1)
    assert thk.halo_exchange_ring.launches == before


# --- the geometry behind the in-place rule -----------------------------------

def _conflicts(n, wrap, depth, tile):
    """Whether some strip of an axis of ``n`` tiles reads a strip of the
    same exchange: above the tile extent, wherever a tile with a
    neighbour on one side reads one with a neighbour on its far side."""
    return depth > tile and (n >= 3 or wrap)


@pytest.mark.parametrize("base", [None, 3])
@pytest.mark.parametrize("halo", [1, 2, 8])
@pytest.mark.parametrize("wrap", list(WRAPS))
@pytest.mark.parametrize("tiles", TILES, ids=str)
def test_ring_geometry(tiles, wrap, halo, base):
    """From ``exchange_index`` alone, at every depth: the cells an
    exchange of distinct values changes are exactly those the map moves
    (the ring); where ``ring_in_place`` holds no source lies in the ring;
    where it does not, one does, except along an axis of two walled
    tiles (the rule is conservative there, never loose)."""
    wrap = WRAPS[wrap]
    spec = _port_grid(tiles, wrap, halo, base).halo_spec
    ny, nx = spec.array_shape
    refused = 0
    for depth in range(1, halo + 1):
        rows, cols = thalo.exchange_index(spec, depth)
        ring = ((rows != torch.arange(ny))[:, None]
                | (cols != torch.arange(nx))[None, :])
        a = torch.from_numpy(_unique((ny, nx), np.float64, depth))
        assert torch.equal(thalo.exchange(a, spec, depth) != a, ring)
        sourced = ring.index_select(0, rows).index_select(1, cols)
        reads_ring = bool((sourced & ring).any())
        if thk.ring_in_place(spec, depth):
            assert not reads_ring, depth
        else:
            refused += 1
            assert reads_ring == (
                _conflicts(spec.nprocx, spec.wrap_x, depth, spec.tile_nx)
                or _conflicts(spec.nprocy, spec.wrap_y, depth,
                              spec.tile_ny)), depth
    # tiles of at least the halo take every depth in place; tiles of 3
    # or 4 points refuse the deepest where strips move
    moves = spec.nprocx > 1 or spec.wrap_x or spec.nprocy > 1 or spec.wrap_y
    assert (refused > 0) == (base == 3 and halo == 8 and moves)
