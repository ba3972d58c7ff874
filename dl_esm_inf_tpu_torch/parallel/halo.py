"""Halo exchange for the stacked local-shard layout, across ranks.

Counterpart of ``dl_esm_inf_tpu/parallel/halo.py``.  A field is ONE
tensor per rank of shape ``(repy*local_ny, repx*local_nx)``: the rank's
block of logical shards (tiles) side by side, each with its own halo
ring.  The ranks form a ``ranks_y x ranks_x`` grid
(:meth:`..core.grid.Grid.decompose`, the JAX package's device mesh);
one rank holding every tile is the JAX package's over-decomposition on
a 1x1 mesh, where every seam is a local strip shift.

One exchange is two phases:

1. **x phase**: ``depth`` interior edge *columns* move east and west.
2. **y phase**: ``depth`` edge *rows* of the FULL padded width (the x
   halos just received included) move north and south, so diagonal
   corners arrive by sequencing.

Every tile's strips shift one slot along the tile axis; the strip that
crosses a rank seam travels to the neighbouring rank (the JAX package's
``ppermute``) by the gang's seam transport
(:func:`.environment.seam_transport`): card to card through peer-memory
windows (:mod:`.seam`), or over gloo, with CUDA strips staged through
host memory.  Periodic axes add the wrap pair.
A tile with no neighbour in some direction keeps its existing boundary
values.  Fields are grouped by dtype and leading shape, and strips of
one group move together; fields of different dtypes are never stacked
into one message, so an int32 halo is never upcast through a float.

On one rank the two phases are separable, so an exchange is also a
gather by a row and a column index (:func:`exchange_index`): the
geometry the exchange kernels of :mod:`.halo_kernel` and the flagship
sweep evaluate on the card.  :func:`_exchange_blocks` stays their plain
version, and the plain transport between ranks.

Autograd crosses the exchange between ranks: the strip transfer is a
``torch.autograd.Function`` whose backward sends each received strip's
cotangent back to the rank it came from (:class:`_Transfer`), the
transpose of ``ppermute``; the local strip shifts are plain tensor
operations.  The y phase's cotangents flow back before the x phase's,
so a 2x2 rank grid's corners, which arrive by sequencing, transpose in
reverse sequence.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import environment as env


@dataclass(frozen=True)
class HaloSpec:
    """Static facts the exchange needs; the same on every rank.

    ``repx``/``repy`` are the over-decomposition factors: logical tiles
    per rank along each axis.  The rank grid is ``ranks_y x ranks_x``
    (``nprocy/repy x nprocx/repx``); rank ``r`` sits at row
    ``r // ranks_x`` and column ``r % ranks_x``."""

    nprocx: int
    nprocy: int
    halo: int
    tile_nx: int
    tile_ny: int
    local_nx: int
    local_ny: int
    wrap_x: bool
    wrap_y: bool
    repx: int = 1
    repy: int = 1

    @property
    def ranks_x(self) -> int:
        """Rank-grid extent along x (the JAX package's ``meshx``)."""
        return self.nprocx // self.repx

    @property
    def ranks_y(self) -> int:
        return self.nprocy // self.repy

    @property
    def num_ranks(self) -> int:
        return self.ranks_x * self.ranks_y

    @property
    def array_shape(self) -> tuple[int, int]:
        """Shape of one rank's block: ``(repy*local_ny, repx*local_nx)``."""
        return (self.repy * self.local_ny, self.repx * self.local_nx)

    @property
    def global_array_shape(self) -> tuple[int, int]:
        """Shape of the whole stacked layout, every rank's block."""
        return (self.nprocy * self.local_ny, self.nprocx * self.local_nx)

    def rank_coords(self, rank: int) -> tuple[int, int]:
        """``(iy, ix)`` of ``rank`` in the rank grid."""
        return divmod(rank, self.ranks_x)

    def rank_at(self, iy: int, ix: int) -> int:
        """The rank at ``(iy, ix)``, wrap-indexed on both axes."""
        return (iy % self.ranks_y) * self.ranks_x + ix % self.ranks_x


def _shift_tiles(up, down, dim: int, nr: int, i: int, wrap: bool,
                 plus: int, minus: int):
    """``(from_minus, from_plus)`` for one group's strips: tile t of the
    rank's row of tiles receives tile t-1's ``up`` strip and tile t+1's
    ``down`` strip along ``dim`` (the JAX package's ``shift_tiles`` /
    ``shift_tiles_up``).  The strip that crosses a rank seam comes from
    the ``minus`` / ``plus`` rank; at a walled edge nothing is sent and
    the slot holds zeros, which the caller's masks discard."""
    if nr == 1:
        return torch.roll(up, 1, dims=dim), torch.roll(down, -1, dims=dim)
    n = up.shape[dim]
    first, last = _Transfer.apply(up.narrow(dim, n - 1, 1),
                                  down.narrow(dim, 0, 1), plus, minus,
                                  i < nr - 1 or wrap, i > 0 or wrap)
    return (torch.cat([first, up.narrow(dim, 0, n - 1)], dim),
            torch.cat([down.narrow(dim, 1, n - 1), last], dim))


class _Transfer(torch.autograd.Function):
    """The strips that cross the rank seams of one axis, as autograd sees
    them (the JAX package's ``ppermute``).

    Forward: ``up`` goes to the ``plus`` rank and ``down`` to the
    ``minus`` rank; ``(first, last)`` are what the ``minus`` and ``plus``
    ranks sent (zeros where no neighbour sends: ``to_plus`` is whether
    there is a ``plus`` neighbour, ``to_minus`` a ``minus`` one).
    Backward, the transpose (``ppermute``'s reverse permutation): the
    cotangents of ``first`` and ``last`` go back to the ranks that sent
    them, and ``up``'s and ``down``'s come from the ranks they went to.
    One batch of messages each way, on every rank, so the backward pass
    is collective like the forward."""

    @staticmethod
    def forward(ctx, up, down, plus, minus, to_plus, to_minus):
        ctx.route = (plus, minus, to_plus, to_minus)
        first = torch.zeros_like(up)
        last = torch.zeros_like(down)
        _send_recv([(up, plus, to_plus, 0), (down, minus, to_minus, 1)],
                   [(first, minus, to_minus, 0), (last, plus, to_plus, 1)])
        return first, last

    @staticmethod
    def backward(ctx, g_first, g_last):
        plus, minus, to_plus, to_minus = ctx.route
        g_up = torch.zeros_like(g_first)
        g_down = torch.zeros_like(g_last)
        _send_recv([(g_first, minus, to_minus, 0),
                    (g_last, plus, to_plus, 1)],
                   [(g_up, plus, to_plus, 0), (g_down, minus, to_minus, 1)])
        return g_up, g_down, None, None, None, None


def _send_recv(sends, recvs) -> None:
    """One batch of point-to-point messages, ``(tensor, peer, active,
    tag)`` each; receives are written into their tensors.  CUDA strips
    move card to card where the gang's seam transport is ``"peer"``
    (:mod:`.seam`); otherwise gloo moves host memory, so a CUDA strip is
    staged through the host.  The collectives' parts move the same way,
    on a tag of their own (:mod:`.collectives`)."""
    sim = getattr(env.simulated, "send_recv", None)
    if sim is not None:
        return sim(sends, recvs)
    device = (sends or recvs)[0][0].device
    if env.seam_transport_for(device) == "peer":
        from .seam import peer_seams
        return peer_seams(sends, recvs)
    ops, staged = [], []
    for t, peer, active, tag in sends:
        if active:
            ops.append(dist.P2POp(dist.isend, t.contiguous().cpu(), peer,
                                  tag=tag))
    for t, peer, active, tag in recvs:
        if active:
            buf = torch.empty(t.shape, dtype=t.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
            staged.append((t, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, buf in staged:
        t.copy_(buf)


def _exchange_blocks(blks, spec: HaloSpec, depth: int):
    """Exchange several stacked-layout tensors; returns new tensors.

    Every tile's edge strips shift one slot along the tile axis (tile t
    receives tile t-1's east strip and tile t+1's west strip); the
    strips that cross a rank seam come from the neighbouring ranks, the
    wrap pair closes the ring on periodic axes, and tiles without a
    neighbour keep their own values.  Inputs are not modified.  A spec
    whose one rank holds every tile exchanges locally in any process;
    one split over ranks is collective: every rank calls it, in the same
    order."""
    h, d = spec.halo, depth
    w, hgt = spec.tile_nx, spec.tile_ny
    rx, ry = spec.repx, spec.repy
    ly, lx = spec.local_ny, spec.local_nx
    mx, my = spec.ranks_x, spec.ranks_y
    blks = list(blks)
    do_x = spec.nprocx > 1 or spec.wrap_x
    do_y = spec.nprocy > 1 or spec.wrap_y
    if not (do_x or do_y):
        return tuple(blks)
    iy, ix = 0, 0
    if spec.num_ranks > 1:
        _check_rank_layout(spec)
        iy, ix = spec.rank_coords(env.get_rank())

    groups: list[tuple[tuple, list[int]]] = []
    for k, b in enumerate(blks):
        sig = (b.dtype, tuple(b.shape[:-2]))
        for gsig, idxs in groups:
            if gsig == sig:
                idxs.append(k)
                break
        else:
            groups.append((sig, [k]))

    def batch(strips):
        """Per-field strips -> one stacked message per group."""
        return [torch.stack([strips[k] for k in idxs])
                for _, idxs in groups]

    def unbatch(msgs, k):
        for msg, (_, idxs) in zip(msgs, groups):
            if k in idxs:
                return msg[idxs.index(k)]
        raise AssertionError(k)

    # (..., ry*ly, rx*lx) -> (..., ry, ly, rx, lx): views of fresh copies,
    # so the slice assignments below write the outputs
    out = [b.clone() for b in blks]
    vs = [b.reshape(b.shape[:-2] + (ry, ly, rx, lx)) for b in out]

    if do_x:
        # strips: (..., ry, ly, rx, d); the tile-column axis is -2
        east_src = batch([v[..., h + w - d: h + w] for v in vs])
        west_src = batch([v[..., h: h + d] for v in vs])
        shifted = [_shift_tiles(e, wst, -2, mx, ix, spec.wrap_x,
                                spec.rank_at(iy, ix + 1),
                                spec.rank_at(iy, ix - 1))
                   for e, wst in zip(east_src, west_src)]
        from_west = [fw for fw, _ in shifted]
        from_east = [fe for _, fe in shifted]
        gcol = ix * rx + torch.arange(rx, device=out[0].device)
        has_w = ((gcol > 0) | spec.wrap_x)[:, None]
        has_e = ((gcol < spec.nprocx - 1) | spec.wrap_x)[:, None]
        for k, v in enumerate(vs):
            v[..., h - d: h] = torch.where(
                has_w, unbatch(from_west, k), v[..., h - d: h])
            v[..., h + w: h + w + d] = torch.where(
                has_e, unbatch(from_east, k), v[..., h + w: h + w + d])

    if do_y:
        # strips: (..., ry, d, rx, lx); the tile-row axis is -4
        north_src = batch([v[..., h + hgt - d: h + hgt, :, :] for v in vs])
        south_src = batch([v[..., h: h + d, :, :] for v in vs])
        shifted = [_shift_tiles(nth, sth, -4, my, iy, spec.wrap_y,
                                spec.rank_at(iy + 1, ix),
                                spec.rank_at(iy - 1, ix))
                   for nth, sth in zip(north_src, south_src)]
        from_south = [fs for fs, _ in shifted]
        from_north = [fn for _, fn in shifted]
        grow = iy * ry + torch.arange(ry, device=out[0].device)
        has_s = ((grow > 0) | spec.wrap_y)[:, None, None, None]
        has_n = ((grow < spec.nprocy - 1) | spec.wrap_y)[:, None, None, None]
        for k, v in enumerate(vs):
            v[..., h - d: h, :, :] = torch.where(
                has_s, unbatch(from_south, k), v[..., h - d: h, :, :])
            v[..., h + hgt: h + hgt + d, :, :] = torch.where(
                has_n, unbatch(from_north, k),
                v[..., h + hgt: h + hgt + d, :, :])

    return tuple(out)


def _check_depth(spec: HaloSpec, depth: int) -> None:
    if depth < 1 or depth > spec.halo:
        raise ValueError(
            f"halo-exchange depth {depth} outside [1, halo={spec.halo}]")


def _check_rank_layout(spec: HaloSpec) -> None:
    """The spec's rank grid is this run's: one block per rank."""
    if (spec.nprocx % spec.repx or spec.nprocy % spec.repy
            or spec.num_ranks != env.get_num_ranks()):
        raise ValueError(
            f"the decomposition's rank grid ({spec.ranks_y}x{spec.ranks_x}:"
            f" {spec.nprocy}x{spec.nprocx} tiles, {spec.repy}x{spec.repx} "
            f"per rank) does not match the run's {env.get_num_ranks()} "
            "rank(s)")


def _check_one_rank(spec: HaloSpec) -> None:
    """Every tile of the spec lives in this rank's one block."""
    if spec.repx != spec.nprocx or spec.repy != spec.nprocy:
        raise NotImplementedError(
            "single-rank exchange: every tile must live on this rank "
            f"(repx={spec.repx}, repy={spec.repy}, nprocx={spec.nprocx}, "
            f"nprocy={spec.nprocy})")


def _axis_index(i, h, d, t, l, n, wrap):
    k, r = i // l, i % l
    west = (r >= h - d) & (r < h) & ((k > 0) | wrap)
    east = (r >= h + t) & (r < h + t + d) & ((k < n - 1) | wrap)
    src = torch.where(west, ((k - 1) % n) * l + r + t, i)
    return torch.where(east, ((k + 1) % n) * l + r - t, src)


def exchange_index(spec: HaloSpec, depth: int,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, cols)``: the exchange of ``depth`` as a gather,
    ``exchange(a) == a.index_select(-2, rows).index_select(-1, cols)``.

    The x phase moves columns over every row of a tile and the y phase
    then moves full-width rows, so the two are separable: a point in a
    west (south) halo strip of depth ``depth`` reads the column (row)
    ``tile_nx`` (``tile_ny``) further on in the tile before it, one in an
    east (north) strip the one as far back in the tile after it, where
    that neighbour exists (wrap pairs on periodic axes); every other
    point reads itself.  The Python mirror of ``csrc/halo_remap.cuh``,
    the geometry both exchange kernels use."""
    _check_depth(spec, depth)
    _check_one_rank(spec)
    h = spec.halo
    ny, nx = spec.array_shape
    rows = _axis_index(torch.arange(ny, device=device), h, depth,
                       spec.tile_ny, spec.local_ny, spec.nprocy, spec.wrap_y)
    cols = _axis_index(torch.arange(nx, device=device), h, depth,
                       spec.tile_nx, spec.local_nx, spec.nprocx, spec.wrap_x)
    return rows, cols


def exchange(data: torch.Tensor, spec: HaloSpec,
             depth: int = 1) -> torch.Tensor:
    """Refresh the halo ring(s) of one stacked-layout tensor (leading
    dims are carried along).  Functional: returns a new tensor."""
    _check_depth(spec, depth)
    return _exchange_blocks((data,), spec, depth)[0]


def exchange_multi(arrays, spec: HaloSpec, depth: int = 1) -> list:
    """Exchange several same-layout fields in one call."""
    _check_depth(spec, depth)
    return list(_exchange_blocks(tuple(arrays), spec, depth))


def exchange_multi_fn(spec: HaloSpec, depth: int = 1):
    """``fn(blks) -> blks``: the exchange bound to (spec, depth), the
    shape a model's step schedule calls once per step or sweep."""
    _check_depth(spec, depth)

    def fn(blks):
        return _exchange_blocks(tuple(blks), spec, depth)
    return fn
