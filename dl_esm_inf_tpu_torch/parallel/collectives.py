"""Global reductions and gathers (reference ``global_sum`` / ``gather``).

Counterpart of ``dl_esm_inf_tpu/parallel/collectives.py``.  With every
shard on one device a reduction is a plain tensor reduction, accumulated
in :func:`..core.kinds.sum_dtype` of the data (float64 for float64
data).  A multi-process version over ``torch.distributed`` adds an
all-reduce here in a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kinds


def _acc(data: torch.Tensor) -> torch.Tensor:
    return data.to(kinds.sum_dtype(data.dtype))


def global_sum(data: torch.Tensor) -> float:
    """Scalar sum over a stacked-layout tensor."""
    return float(_acc(data).sum())


def global_min(data: torch.Tensor) -> float:
    return float(_acc(data).min())


def global_max(data: torch.Tensor) -> float:
    return float(_acc(data).max())


def masked_sum(data: torch.Tensor, mask: torch.Tensor) -> float:
    """Sum of ``data`` where ``mask`` is nonzero, in the checksum dtype."""
    acc = _acc(data)
    return float((acc * mask.to(acc.dtype)).sum())


def gather_to_host(data: torch.Tensor) -> np.ndarray:
    """Full host copy of a tensor as a numpy array."""
    return data.detach().cpu().numpy()
