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
card per rank (see ROADMAP.md).  The strips that cross a rank seam, and
the parts of every collective (:mod:`.collectives`), move by the gang's
seam transport (:func:`seam_transport`): card to card through
peer-memory windows (``"peer"``, :mod:`.seam`) or through host memory
(``"gloo"``); the process group itself carries only the start-up
exchanges and hand-shakes (``all_gather_object``) and the barriers.  A
grid carries its ``torch.device``:
the card unless the caller names another one (``device="cpu"``), and
never the CPU in place of a missing card.
"""
from __future__ import annotations

import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

#: torch's own environment protocol of a gang (``torch.distributed``'s
#: ``env://`` names), set by :mod:`..launch` for every rank
ENV_PROTOCOL = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK")

#: how long the process group's collectives wait for a peer
PG_TIMEOUT = timedelta(seconds=300)

#: the gang's seam transport for CUDA strips: the name
#: :func:`set_seam_transport` gave, else the default chosen at the first
#: seam between CUDA strips; None before either
_seam = {"name": None}

#: a simulated rank of the calling thread (:func:`.seam.seam_reference`):
#: its ``rank``, ``ranks`` and the ``send_recv`` its strips move by
simulated = threading.local()


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
    from . import rdma, seam
    dist.barrier()
    try:
        rdma.close_windows()
    finally:
        seam.close_windows()
    _seam["name"] = None
    dist.destroy_process_group()


def get_rank() -> int:
    rank = getattr(simulated, "rank", None)
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def get_num_ranks() -> int:
    ranks = getattr(simulated, "ranks", None)
    if ranks is not None:
        return ranks
    return dist.get_world_size() if dist.is_initialized() else 1


def seam_transport() -> str | None:
    """The transport of the strips that cross a rank seam when they are
    CUDA tensors: ``"peer"`` (card to card, :mod:`.seam`) or ``"gloo"``
    (through host memory); the name :func:`set_seam_transport` gave, else
    the default chosen at the gang's first seam between CUDA strips
    (:func:`.seam.choose_seam_transport`), None before either.  CPU
    strips always move by gloo."""
    return _seam["name"]


def set_seam_transport(name: str) -> None:
    """Make ``name`` (``"peer"`` or ``"gloo"``) the gang's seam transport
    for CUDA strips.  Collective: every rank passes the same name, or this
    raises on every rank.  ``"peer"`` where a pair of ranks cannot open
    each other's memory (another host, or cards without peer access)
    raises, naming both cards."""
    from . import seam
    if name not in seam.TRANSPORTS:
        raise ValueError(f"seam transport {name!r}: expected one of "
                         f"{seam.TRANSPORTS}")
    if get_num_ranks() > 1:
        names = [None] * get_num_ranks()
        dist.all_gather_object(names, name)
        if len(set(names)) > 1:
            raise ValueError(f"the ranks asked for different seam "
                             f"transports: {names}")
        if name == "peer" and torch.cuda.is_available():
            seam.choose_seam_transport(
                "cuda", seam.gather_cards(resolve_device()), "peer")
    _seam["name"] = name


def seam_transport_for(device: torch.device) -> str:
    """The transport of strips on ``device``: gloo on the CPU; on a card
    the gang's (:func:`seam_transport`), chosen by the ranks' layout at
    the first call, which is then collective."""
    if device.type != "cuda":
        return "gloo"
    if _seam["name"] is None:
        from . import seam
        _seam["name"] = seam.choose_seam_transport(
            "cuda", seam.gather_cards(device))
    return _seam["name"]


def on_master() -> bool:
    return get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the gang (nothing with one rank)."""
    if get_num_ranks() > 1:
        dist.barrier()


def stop(message: str = "") -> None:
    """Analogue of gocean_stop."""
    raise GOceanStop(message)
