"""Global reductions and gathers (reference ``global_sum`` / ``gather``).

Counterpart of ``dl_esm_inf_tpu/parallel/collectives.py``.  A reduction
reduces this rank's block in :func:`..core.kinds.sum_dtype` of the data
(float64 for float64 data) and, with more than one rank, all-reduces
the partial results in that dtype over the process group (gloo, through
host memory).  :func:`gather_to_host` all-gathers every rank's block
into the whole stacked layout on every rank, as the JAX package's
``process_allgather`` does.  With more than one rank each of these is
collective: every rank calls it, in the same order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import kinds
from . import environment as env


def _acc(data: torch.Tensor) -> torch.Tensor:
    return data.to(kinds.sum_dtype(data.dtype))


def all_reduce(local: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of one rank's small partial result (a few values:
    dot products, residual norms), in its dtype, on its device: ``local``
    itself with one rank.  Across ranks the values move through host
    memory in one gloo call, so two sums cost one collective (the JAX
    package's ``psum`` of a stacked pair), and the result carries no
    gradient."""
    if env.get_num_ranks() == 1:
        return local
    buf = local.detach().reshape(-1).to("cpu", copy=True)
    dist.all_reduce(buf, op=op)
    return buf.reshape(local.shape).to(local.device)


def _all_reduce(local: torch.Tensor, op) -> float:
    """The all-reduce of one rank's 0-d partial result, in its dtype."""
    return float(all_reduce(local, op))


def global_sum(data: torch.Tensor) -> float:
    """Scalar sum over every rank's stacked-layout block."""
    return _all_reduce(_acc(data).sum(), dist.ReduceOp.SUM)


def global_min(data: torch.Tensor) -> float:
    return _all_reduce(_acc(data).min(), dist.ReduceOp.MIN)


def global_max(data: torch.Tensor) -> float:
    return _all_reduce(_acc(data).max(), dist.ReduceOp.MAX)


def masked_sum(data: torch.Tensor, mask: torch.Tensor) -> float:
    """Sum of ``data`` where ``mask`` is nonzero, in the checksum dtype,
    over every rank."""
    acc = _acc(data)
    return _all_reduce((acc * mask.to(acc.dtype)).sum(), dist.ReduceOp.SUM)


def gather_to_host(data: torch.Tensor, spec=None) -> np.ndarray:
    """Host copy of a stacked-layout tensor as a numpy array.  With more
    than one rank ``data`` is this rank's block and ``spec`` (the grid's
    :class:`~.halo.HaloSpec`) places it: every rank receives the whole
    stacked layout.  Always a copy, also of a CPU tensor, so that an
    in-place exchange of the field later does not change it."""
    local = data.detach().to("cpu", copy=True)
    nranks = env.get_num_ranks()
    if nranks == 1:
        return local.numpy()
    if spec is None or spec.num_ranks != nranks:
        raise ValueError("gathering across ranks needs the grid's halo "
                         "spec, whose rank grid is this run's")
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(nranks)]
    dist.all_gather(parts, local)
    rows = [torch.cat(parts[iy * spec.ranks_x: (iy + 1) * spec.ranks_x],
                      dim=-1) for iy in range(spec.ranks_y)]
    return torch.cat(rows, dim=-2).numpy()
