"""Parallel execution environment: one process per rank.

Counterpart of ``dl_esm_inf_tpu/parallel/environment.py``.  A run is
one process (rank 0 of 1), or a gang of ranks joined by
``torch.distributed`` (:func:`initialise`, started by
:mod:`..launch`).  A grid's decomposition is split over the ranks
(:meth:`..core.grid.Grid.decompose`): each rank holds a block of tiles
as one stacked tensor on its own ``torch.device``, and seams between
ranks move through the process group (:mod:`.halo`, :mod:`.rdma`).

The process group is gloo only.  NCCL refuses two ranks on one GPU, and
the machines this port is tested on have one card; NCCL comes with one
card per rank (see ROADMAP.md).  A grid carries its ``torch.device``:
the card unless the caller names another one (``device="cpu"``), and
never the CPU in place of a missing card.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

#: torch's own environment protocol of a gang (``torch.distributed``'s
#: ``env://`` names), set by :mod:`..launch` for every rank
ENV_PROTOCOL = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK")

#: how long the process group's collectives wait for a peer
PG_TIMEOUT = timedelta(seconds=300)


class GOceanStop(RuntimeError):
    """Raised by :func:`stop` — analogue of gocean_stop."""


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card: this
    rank's ``cuda:{LOCAL_RANK % device_count}`` in a gang, ``cuda``
    alone.  A CUDA device must exist.

    Never falls back to the CPU: asking for CUDA, or for the default, on
    a machine without it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                'pass device="cpu" to run on the CPU')
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            return torch.device("cuda")
        return torch.device("cuda", int(local) % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False")
    return dev


def initialise() -> None:
    """Analogue of gocean_initialise(): joins the gang's process group
    (gloo) when torch's environment protocol (:data:`ENV_PROTOCOL`) is
    set, as :mod:`..launch` sets it; without it the run is one process.
    A partial protocol raises.  Safe to call more than once."""
    present = [k for k in ENV_PROTOCOL if os.environ.get(k)]
    if not present or dist.is_initialized():
        return
    missing = [k for k in ENV_PROTOCOL if k not in present]
    if missing:
        raise RuntimeError(
            "multi-process env protocol incomplete: set all of "
            f"{', '.join(ENV_PROTOCOL)} (missing: {', '.join(missing)})")
    env = os.environ
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:"
                            f"{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
        timeout=PG_TIMEOUT)


def finalise() -> None:
    """Analogue of gocean_finalise(): closes this rank's peer-memory
    windows (:mod:`.rdma`) once every rank is done with them, then
    leaves the process group."""
    if not dist.is_initialized():
        return
    from . import rdma
    dist.barrier()
    rdma.close_windows()
    dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_num_ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def on_master() -> bool:
    return get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the gang (nothing with one rank)."""
    if get_num_ranks() > 1:
        dist.barrier()


def stop(message: str = "") -> None:
    """Analogue of gocean_stop."""
    raise GOceanStop(message)
