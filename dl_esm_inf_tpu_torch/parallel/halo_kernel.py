"""The halo exchange as one CUDA kernel launch, in two forms.

Counterpart of ``dl_esm_inf_tpu/parallel/halo_pallas.py``, the JAX
package's remote-DMA transport.  ``csrc/halo_exchange.cu`` refreshes the
halo rings of every tile of one stacked-layout block (leading level dims
carried) to a depth, in one of two launch forms:

* functional (:data:`halo_exchange`, :func:`exchange_kernel`,
  :func:`make_block_exchange`): a new block, as the JAX function
  returns;
* ring (:data:`halo_exchange_ring`, :func:`exchange_ring`): the same
  exchange in place, writing only the ring.  It is race-free only where
  :func:`ring_in_place` holds (depth <= tile extent on every axis that
  moves strips).

What runs depends only on where the block lies: a CUDA tensor launches
the kernel (built with ``nvcc`` at first use, see
:mod:`..ops.cuda_build`), or raises; a CPU tensor runs the kernel's
plain version, the port's plain exchange :func:`.halo._exchange_blocks`
(the ring form writes its result into the block with ``copy_``, so the
CPU sees the aliasing the card has).  Both evaluate the two-phase
exchange of :mod:`.halo` as the gather of ``csrc/halo_remap.cuh``
(mirrored by :func:`.halo.exchange_index`).  float32, float64 and int32
blocks move bit for bit.

:func:`remote_dma_exchange` is ``Field.halo_exchange(transport=
"remote_dma")``: the ring form in place where :func:`ring_in_place`
holds, else the functional form; across ranks (one tile per rank) the
fenced exchange through peer memory, :func:`.rdma.exchange`.
"""
from __future__ import annotations

import ctypes

import torch

from . import rdma
from .halo import HaloSpec, _check_depth, _check_one_rank, _exchange_blocks

#: element sizes the kernel copies, by the dtypes it takes
_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.float64: 8}


def remap_args(spec: HaloSpec, depth: int):
    """The fields of ``csrc/halo_remap.cuh``'s ``HaloRemap``, in order, as
    the C array the kernels take."""
    vals = (spec.halo, depth, spec.tile_nx, spec.tile_ny, spec.local_nx,
            spec.local_ny, spec.nprocx, spec.nprocy, int(spec.wrap_x),
            int(spec.wrap_y))
    return (ctypes.c_int * len(vals))(*vals)


def ring_in_place(spec: HaloSpec, depth: int) -> bool:
    """Whether the exchange of ``depth`` may run in place (the ring form):
    one rank holds every tile, and ``depth`` is at most the tile extent
    on every axis that moves strips.  Then every cell of the ring reads a
    tile's interior, which the exchange does not write
    (``csrc/halo_exchange.cu`` has the proof); above it a strip reads a
    neighbour's strip of the same exchange."""
    return (spec.num_ranks == 1
            and not ((spec.nprocx > 1 or spec.wrap_x)
                     and depth > spec.tile_nx)
            and not ((spec.nprocy > 1 or spec.wrap_y)
                     and depth > spec.tile_ny))


def _check_ring(spec: HaloSpec, depth: int) -> None:
    if not ring_in_place(spec, depth):
        raise ValueError(
            f"the in-place exchange needs depth <= the tile extent on every "
            f"axis that moves strips (depth {depth}, tiles {spec.tile_ny}x"
            f"{spec.tile_nx}): take the functional form")


class HaloExchangeKernel:
    """ctypes wrapper of one launch form of ``csrc/halo_exchange.cu``:
    the functional form (``in_place=False``: returns a new block) or the
    ring form (``in_place=True``: updates the block, returns it).

    The library is built and bound once, the remap array kept per (spec,
    depth).  ``launches`` counts the kernel launches this wrapper has
    made (and nothing else); callers may reset it."""

    source = "halo_exchange.cu"

    def __init__(self, in_place: bool):
        self.in_place = in_place
        self.launches = 0
        self._fn = None
        self._remaps: dict = {}

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from ..ops.cuda_build import load_library
        built = load_library("halo_exchange", (self.source,))
        if self._fn is None:
            if self.in_place:
                fn = built.lib.halo_exchange_ring_launch
                ptrs = [ctypes.c_void_p]
            else:
                fn = built.lib.halo_exchange_launch
                ptrs = [ctypes.c_void_p, ctypes.c_void_p]
            fn.argtypes = ([ctypes.c_int] + ptrs + [ctypes.c_int] * 3
                           + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return built

    def __call__(self, data: torch.Tensor, spec: HaloSpec,
                 depth: int) -> torch.Tensor:
        if data.device.type != "cuda":
            raise ValueError(f"the exchange kernel needs a CUDA tensor, got "
                             f"{data.device}")
        if data.dtype not in _ELEM_BYTES:
            raise TypeError(f"the exchange kernel takes float32/float64/int32 "
                            f"blocks, got {data.dtype}")
        if data.dim() < 2 or tuple(data.shape[-2:]) != spec.array_shape:
            raise ValueError(f"expected (..., {spec.array_shape[0]}, "
                             f"{spec.array_shape[1]}) blocks, got "
                             f"{tuple(data.shape)}")
        if not data.is_contiguous():
            raise ValueError("the exchanged block must be contiguous")
        if data.numel() >= 2 ** 31:
            raise ValueError(f"the exchange kernel takes blocks of fewer "
                             f"than 2**31 elements, got {data.numel()}")
        _check_depth(spec, depth)
        _check_one_rank(spec)
        if self.in_place:
            _check_ring(spec, depth)
        if self._fn is None:
            self.build()
        remap = self._remaps.get((spec, depth))
        if remap is None:
            remap = self._remaps[(spec, depth)] = remap_args(spec, depth)
        ny, nx = spec.array_shape
        stream = torch.cuda.current_stream(data.device).cuda_stream
        if self.in_place:
            out = data
            err = self._fn(_ELEM_BYTES[data.dtype], data.data_ptr(),
                           data.numel() // (ny * nx), ny, nx, remap,
                           len(remap), stream)
        else:
            out = torch.empty_like(data)
            err = self._fn(_ELEM_BYTES[data.dtype], data.data_ptr(),
                           out.data_ptr(), data.numel() // (ny * nx), ny, nx,
                           remap, len(remap), stream)
        if err != 0:
            raise RuntimeError(f"halo exchange kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out


#: the process's wrappers of the exchange kernel: the functional form and
#: the ring form
halo_exchange = HaloExchangeKernel(in_place=False)
halo_exchange_ring = HaloExchangeKernel(in_place=True)


def make_block_exchange(spec: HaloSpec, depth: int = 1,
                        lead_shape: tuple = ()):
    """``fn(blk) -> blk``: the exchange of ``depth`` for stacked blocks of
    shape ``lead_shape + spec.array_shape`` (a multi-level field's level
    axis is a leading dim, carried whole).  Functional: returns a new
    tensor.  Across ranks, one tile per rank, the fenced exchange of
    :mod:`.rdma`."""
    _check_depth(spec, depth)
    if spec.num_ranks > 1:
        rdma._check_one_tile(spec)
    else:
        _check_one_rank(spec)
    lead_shape = tuple(int(n) for n in lead_shape)
    if any(n < 1 for n in lead_shape):
        raise ValueError(f"lead_shape must be positive, got {lead_shape}")
    want = lead_shape + spec.array_shape

    def fn(blk: torch.Tensor) -> torch.Tensor:
        if tuple(blk.shape) != want:
            raise ValueError(f"expected a {want} block, got "
                             f"{tuple(blk.shape)}")
        return exchange_kernel(blk, spec, depth)
    return fn


def exchange_kernel(data: torch.Tensor, spec: HaloSpec,
                    depth: int = 1) -> torch.Tensor:
    """Refresh the halo rings of one stacked-layout tensor through the
    functional form (its plain version on the CPU); a drop-in for
    :func:`.halo.exchange`.  Across ranks: :func:`.rdma.exchange`."""
    if spec.num_ranks > 1:
        return rdma.exchange(data, spec, depth)
    if data.device.type == "cpu":
        _check_depth(spec, depth)
        return _exchange_blocks((data,), spec, depth)[0]
    return halo_exchange(data, spec, depth)


def exchange_ring(data: torch.Tensor, spec: HaloSpec,
                  depth: int = 1) -> torch.Tensor:
    """Refresh the halo rings of one stacked-layout tensor in place
    through the ring form, and return it.  On the CPU the plain exchange
    is written into ``data``.  Raises where :func:`ring_in_place` does
    not hold."""
    if data.device.type != "cpu":
        return halo_exchange_ring(data, spec, depth)
    _check_depth(spec, depth)
    _check_one_rank(spec)
    _check_ring(spec, depth)
    out = _exchange_blocks((data,), spec, depth)[0]
    if out is not data:
        data.copy_(out)
    return data


def remote_dma_exchange(data: torch.Tensor, spec: HaloSpec,
                        depth: int = 1) -> torch.Tensor:
    """The exchange of ``Field.halo_exchange(transport="remote_dma")``:
    in place by the ring form where :func:`ring_in_place` holds (returns
    ``data``), else a new tensor from the functional form, or across
    ranks from :func:`.rdma.exchange`."""
    if ring_in_place(spec, depth):
        return exchange_ring(data, spec, depth)
    return exchange_kernel(data, spec, depth)
