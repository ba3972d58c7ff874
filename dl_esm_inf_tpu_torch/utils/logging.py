"""Master-only model logging (reference ``model_write_log``)."""
from __future__ import annotations

import sys

from ..parallel import environment as env


def model_write_log(*parts, all_ranks: bool = False, file=None) -> None:
    """Print a log message on the master process (or on all processes).

    Accepts any mix of strings/ints/floats — covering the reference's
    four format-specific overloads with one function.
    """
    if not (all_ranks or env.on_master()):
        return
    out = file if file is not None else sys.stdout
    msg = " ".join(
        f"{p:.6E}" if isinstance(p, float) else str(p) for p in parts)
    if all_ranks:
        msg = f"[rank {env.get_rank()}] {msg}"
    print(msg, file=out, flush=True)
