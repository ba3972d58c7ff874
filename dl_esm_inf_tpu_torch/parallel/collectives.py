"""Global reductions and gathers (reference ``global_sum`` / ``gather``).

Counterpart of ``dl_esm_inf_tpu/parallel/collectives.py``.  A reduction
reduces this rank's block in :func:`..core.kinds.sum_dtype` of the data
(float64 for float64 data) and, with more than one rank, all-reduces
the partial results in that dtype.  Every collective is one gather of
the ranks' parts (:func:`_parts`): each rank sends its part to every
other rank in one batch of :func:`.halo._send_recv`, so the parts move
by the gang's seam transport (:func:`.environment.seam_transport`), as
the strips of the exchange do: card to card where it is ``"peer"``,
through host memory where it is ``"gloo"`` and for CPU tensors.  An
all-reduce then folds the parts in rank order (``parts[0] + parts[1] +
...``) on every rank, so every rank gets the same bits, and both
transports give the same bits at any rank count.  :func:`gather_to_host`
gathers every rank's block into the whole stacked layout on every rank,
as the JAX package's ``process_allgather`` does.  With more than one
rank each of these is collective: every rank calls it, in the same
order.

:func:`psum`, :func:`pbroadcast` and :func:`all_gather` are the forms
autograd can cross, the JAX package's transposition rules under
``jax.grad`` of a ``shard_map``.  Every rank computes the same
replicated cost and starts its own backward pass from it, so what a
collective's backward does depends on how its result is used:

1. **a result every rank uses alike** (the cost, summed from each
   rank's block): :func:`psum`, whose backward passes the cotangent
   through unchanged -- ``psum`` transposes to a broadcast.  An
   all-reduce there would multiply the gradient by the rank count;
2. **a replicated value that then scales or fills rank-local data**
   (the coefficients of a mix, a feedback average that only the rank
   owning its cell writes, a replicated control that multiplies each
   rank's block): :func:`pbroadcast` of it, whose backward sums the
   ranks' cotangents exactly once -- a broadcast transposes to
   ``psum``.  ``pbroadcast(psum(x))`` is an all-reduce both ways.

:func:`all_gather` stacks every rank's part and hands each rank, in the
backward pass, the sum of every rank's cotangent of its own part (a
reduce-scatter), the second case again.  Backward passes are collective
too: the ranks' graphs are the same, so they run their collectives in
the same order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import kinds
from . import environment as env
from .halo import _send_recv

#: the tag of the collectives' messages in :func:`.halo._send_recv`: the
#: exchange's strips use 0 and 1, a seam edge's hand-shake 65536 + tag
COLLECTIVE_TAG = 2

#: each reduction's fold of two parts
_FOLDS = {dist.ReduceOp.SUM: torch.add, dist.ReduceOp.MIN: torch.minimum,
          dist.ReduceOp.MAX: torch.maximum}


def _acc(data: torch.Tensor) -> torch.Tensor:
    return data.to(kinds.sum_dtype(data.dtype))


def _parts(local: torch.Tensor) -> list:
    """Every rank's ``local`` (one shape and dtype on every rank), in rank
    order, on ``local``'s device: this rank's is ``local`` itself
    (detached), every other arrives in one batch of
    :func:`.halo._send_recv` that sends ``local`` to each other rank and
    receives that rank's part, as a ``(1, numel)`` plane (the seam
    transport moves rows at one pitch).  Collective."""
    rank, nranks = env.get_rank(), env.get_num_ranks()
    mine = local.detach()
    plane = mine.reshape(1, -1)
    peers = [p for p in range(nranks) if p != rank]
    got = {p: torch.empty_like(plane) for p in peers}
    _send_recv([(plane, p, True, COLLECTIVE_TAG) for p in peers],
               [(got[p], p, True, COLLECTIVE_TAG) for p in peers])
    return [mine if p == rank else got[p].reshape(mine.shape)
            for p in range(nranks)]


def all_reduce(local: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of one rank's small partial result (a few values:
    dot products, residual norms), in its dtype, on its device: ``local``
    itself with one rank.  Across ranks the parts move in one gather
    (:func:`_parts`), so two sums cost one collective (the JAX package's
    ``psum`` of a stacked pair), and fold in rank order with ``op``'s
    ``torch.add``, ``torch.minimum`` or ``torch.maximum``: the same bits
    on every rank and under either seam transport.  The result carries
    no gradient.  An ``op`` other than SUM, MIN and MAX raises."""
    fold = _FOLDS.get(op)
    if fold is None:
        raise ValueError(f"all_reduce: {op!r} is not one of SUM, MIN, MAX")
    if env.get_num_ranks() == 1:
        return local
    parts = _parts(local)
    out = parts[0]
    for part in parts[1:]:
        out = fold(out, part)
    return out


class _PSum(torch.autograd.Function):
    """All-reduce (sum) forward; the cotangent passes through."""

    @staticmethod
    def forward(ctx, local):
        return all_reduce(local)

    @staticmethod
    def backward(ctx, g):
        return g


class _PBroadcast(torch.autograd.Function):
    """Identity forward; the cotangents are all-reduced (summed)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g)


class _AllGather(torch.autograd.Function):
    """Every rank's part stacked on a new leading axis; the backward
    pass sums the ranks' cotangents of this rank's part."""

    @staticmethod
    def forward(ctx, local):
        ctx.rank = env.get_rank()
        return torch.stack(_parts(local))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g)[ctx.rank]


def psum(local: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``local`` (case 1 of the module
    docstring): a result every rank uses alike, such as the cost; its
    backward passes the cotangent through.  ``local`` itself with one
    rank."""
    if env.get_num_ranks() == 1:
        return local
    return _PSum.apply(local)


def pbroadcast(x: torch.Tensor) -> torch.Tensor:
    """``x``, a value every rank holds alike, marked as used per rank
    (case 2 of the module docstring): its backward sums every rank's
    cotangent, once.  ``x`` itself with one rank."""
    if env.get_num_ranks() == 1:
        return x
    return _PBroadcast.apply(x)


def all_gather(local: torch.Tensor) -> torch.Tensor:
    """``(num_ranks, *local.shape)``: every rank's ``local`` (the same
    shape on every rank) in rank order, on ``local``'s device; the
    backward pass reduce-scatters the cotangents.  ``local[None]`` with
    one rank."""
    if env.get_num_ranks() == 1:
        return local[None]
    return _AllGather.apply(local)


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
    :class:`~.halo.HaloSpec`) places it: the blocks are gathered on
    ``data``'s device (:func:`_parts`), joined, and copied to the host
    once, so every rank receives the whole stacked layout.  Always a new
    array, also of a CPU tensor, so that an in-place exchange of the
    field later does not change it."""
    nranks = env.get_num_ranks()
    if nranks == 1:
        return data.detach().to("cpu", copy=True).numpy()
    if spec is None or spec.num_ranks != nranks:
        raise ValueError("gathering across ranks needs the grid's halo "
                         "spec, whose rank grid is this run's")
    parts = _parts(data)
    rows = [torch.cat(parts[iy * spec.ranks_x: (iy + 1) * spec.ranks_x],
                      dim=-1) for iy in range(spec.ranks_y)]
    return torch.cat(rows, dim=-2).cpu().numpy()
