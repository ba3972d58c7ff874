"""Linear gravity-wave model — the initial-condition helper only.

Counterpart of ``dl_esm_inf_tpu/models/gravity_wave.py``.  The model
itself (and its sweep kernel) comes in a later slice; the flagship's
CLI, smoke run and tests use :func:`gaussian_eta` now.
"""
from __future__ import annotations

import numpy as np


def gaussian_eta(gnx: int, gny: int, amp: float = 1.0,
                 width: float = 0.1) -> np.ndarray:
    """Initial sea-surface bump in the domain centre."""
    x = (np.arange(gnx) - gnx / 2) / gnx
    y = (np.arange(gny) - gny / 2) / gny
    r2 = x[None, :] ** 2 + y[:, None] ** 2
    return amp * np.exp(-r2 / (2 * width ** 2))
