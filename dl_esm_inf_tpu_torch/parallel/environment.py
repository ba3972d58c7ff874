"""Parallel execution environment, single process.

Counterpart of ``dl_esm_inf_tpu/parallel/environment.py``.  This slice
of the port runs one process on one device: rank 0 of 1.  All shards of
a decomposition live as tiles of one stacked tensor on that device
(over-decomposition), and their seams are local strip shifts
(:mod:`.halo`).  A grid carries its ``torch.device``: the card unless
the caller names another one (``device="cpu"``), and never the CPU in
place of a missing card.  Multi-process runs over ``torch.distributed``
come in a later slice.
"""
from __future__ import annotations

import torch


class GOceanStop(RuntimeError):
    """Raised by :func:`stop` — analogue of gocean_stop."""


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card
    (``cuda``).  A CUDA device must exist.

    Never falls back to the CPU: asking for CUDA, or for the default, on
    a machine without it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                'pass device="cpu" to run on the CPU')
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False")
    return dev


def initialise() -> None:
    """Analogue of gocean_initialise(): nothing to set up in one
    process."""


def finalise() -> None:
    """Analogue of gocean_finalise()."""


def get_rank() -> int:
    return 0


def get_num_ranks() -> int:
    return 1


def on_master() -> bool:
    return True


def stop(message: str = "") -> None:
    """Analogue of gocean_stop."""
    raise GOceanStop(message)
