"""The halo exchange as one CUDA kernel launch.

Counterpart of ``dl_esm_inf_tpu/parallel/halo_pallas.py``, the JAX
package's remote-DMA transport.  :func:`make_block_exchange` returns
``fn(blk) -> blk`` refreshing the halo rings of every tile of one
stacked-layout block (leading level dims carried) to a depth; what runs
depends only on where the block lies:

* a CUDA tensor launches the hand-written kernel ``csrc/halo_exchange.cu``
  through :data:`halo_exchange` (built with ``nvcc`` at first use, see
  :mod:`..ops.cuda_build`), or raises;
* a CPU tensor runs the kernel's plain version, the port's plain exchange
  :func:`.halo._exchange_blocks`.

Both evaluate the two-phase exchange of :mod:`.halo`; the kernel as the
gather of ``csrc/halo_remap.cuh`` (mirrored by
:func:`.halo.exchange_index`), one read and one write of the block.
float32, float64 and int32 blocks move bit for bit.  That is the
exchange of one rank holding every tile; across ranks (one tile per
rank) :func:`exchange_kernel` is :func:`.rdma.exchange`, the fenced
exchange through peer memory.
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


class HaloExchangeKernel:
    """ctypes wrapper of ``csrc/halo_exchange.cu``.

    ``launches`` counts the kernel launches this wrapper has made (and
    nothing else); callers may reset it."""

    source = "halo_exchange.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def build(self):
        """Build (once) and bind the library; returns its BuiltLibrary."""
        from ..ops.cuda_build import load_library
        built = load_library("halo_exchange", (self.source,))
        if self._fn is None:
            fn = built.lib.halo_exchange_launch
            fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 3
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
        _check_depth(spec, depth)
        _check_one_rank(spec)
        self.build()
        out = torch.empty_like(data)
        ny, nx = spec.array_shape
        remap = remap_args(spec, depth)
        err = self._fn(_ELEM_BYTES[data.dtype], data.data_ptr(),
                       out.data_ptr(), data.numel() // (ny * nx), ny, nx,
                       remap, len(remap),
                       torch.cuda.current_stream(data.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"halo exchange kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out


#: the process's one wrapper of the exchange kernel
halo_exchange = HaloExchangeKernel()


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
    kernel (its plain version on the CPU); a drop-in for
    :func:`.halo.exchange`.  Across ranks: :func:`.rdma.exchange`."""
    if spec.num_ranks > 1:
        return rdma.exchange(data, spec, depth)
    if data.device.type == "cpu":
        _check_depth(spec, depth)
        return _exchange_blocks((data,), spec, depth)[0]
    return halo_exchange(data, spec, depth)
